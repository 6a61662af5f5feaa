"""Import a HuggingFace checkpoint into the PyTorch port and run it end to
end.  The counterpart of 05_import_hf.py.

Uses a tiny randomly initialized LlamaForCausalLM (offline, no downloads;
swap in ``LlamaForCausalLM.from_pretrained(...)`` for a real checkpoint),
checks logit parity against transformers, then serves it through the paged
decode engine and fine-tunes it one step.  Needs ``transformers``, which
only this example imports: the port reads HF configs by attribute.

    PYTHONPATH=. python examples/05_import_hf_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch


def main():
    from transformers import LlamaConfig, LlamaForCausalLM

    from flash_attention_dlrs_tpu_torch.models import (
        forward, import_hf_llama, make_train_state, make_train_step, params_to_numpy,
    )
    from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = parser.parse_args().device

    hf_cfg = LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rms_norm_eps=1e-5, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    hf = LlamaForCausalLM(hf_cfg).eval()

    # --- convert ---------------------------------------------------------
    model, cfg = import_hf_llama(hf, dtype=torch.float32, device=device)
    print(f"imported: {cfg.n_layers} layers, {cfg.n_q_heads}q/{cfg.n_kv_heads}kv "
          f"heads, untied head={hasattr(model, 'unembed')}")

    # --- logit parity ----------------------------------------------------
    ids = torch.tensor([[3, 17, 99, 4, 56, 120, 7, 1]])
    with torch.no_grad():
        want = hf(ids).logits
        got = forward(model, ids.to(device), cfg).cpu()
    err = float((got - want).abs().max())
    print(f"max |logit - HF| = {err:.2e}")
    assert err < 2e-4

    # --- serve it --------------------------------------------------------
    eng = DecodeEngine(model, cfg, num_pages=16, page_size=128, num_slots=1,
                       pages_per_seq=4, kv_dtype=torch.float32, device=device)
    print("generated:", eng.generate([[5, 7, 11]], max_new_tokens=6)[0])

    # --- fine-tune one step (the IMPORTED weights) ------------------------
    tuned, opt_state, optimizer = make_train_state(cfg, params=params_to_numpy(model),
                                                   device=device)
    step = make_train_step(cfg, optimizer)
    batch = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 33))).to(device)
    print(f"fine-tune step ok, loss={float(step(tuned, opt_state, batch)):.4f}")


if __name__ == "__main__":
    main()
