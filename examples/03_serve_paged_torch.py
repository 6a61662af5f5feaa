"""Serve a model with the PyTorch port's continuous-batching engine: paged
KV cache, greedy and sampled generation, int8 KV, speculative decoding,
the rolling and StreamingLLM rings.  The counterpart of 03_serve_paged.py;
the weights are random (the point is the serving machinery).

Runs on the CUDA card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions.

    PYTHONPATH=. python examples/03_serve_paged_torch.py [--device cpu]
"""

import argparse
import dataclasses

import torch

from flash_attention_dlrs_tpu_torch.models import ModelConfig, init_params_numpy, params_from_jax
from flash_attention_dlrs_tpu_torch.runtime import DecodeEngine, SamplingParams


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = parser.parse_args().device

    cfg = ModelConfig.tiny(dtype=torch.float32, remat=False)
    tree = init_params_numpy(cfg, seed=0)

    def engine(config=cfg, weights=tree, **kw):
        kw = {"num_pages": 16, "page_size": 128, "num_slots": 2, "pages_per_seq": 4,
              "kv_dtype": torch.float32, **kw}
        return DecodeEngine(params_from_jax(weights, config, device=device), config,
                            device=device, **kw)

    # 16 pages x 128 tokens of paged KV, 2 concurrent slots; more requests
    # than slots exercises continuous batching (admit as slots free up).
    eng = engine()
    prompts = [[5, 7, 11], [2, 4, 6, 8], [1, 2, 3]]
    print("greedy:", eng.generate(prompts, max_new_tokens=5))
    print("sampled:", eng.generate(
        prompts[:1], max_new_tokens=5,
        sampling=SamplingParams(temperature=0.8, top_k=20, top_p=0.95, seed=42)))

    # Streaming: tokens arrive per batched step, interleaved across requests.
    for ev in eng.generate_stream(prompts[:2], max_new_tokens=4):
        print("  stream:", ev.request_id, "done" if ev.done else f"token={ev.token}")

    # INT8 KV cache: about twice the resident context per byte.
    eng8 = engine(kv_dtype=torch.int8, quantized_kv=True)
    print("int8 KV:", eng8.generate(prompts[:2], max_new_tokens=5))

    # Speculative decoding: a draft engine proposes gamma - 1 tokens a round,
    # the target verifies them in one paged multi-token step.  The draft is
    # the same tiny model here; in production it is a smaller one.
    out = eng.generate_speculative(prompts[:1], draft=engine(), gamma=3, max_new_tokens=6)
    print("speculative:", out)

    # Bounded-memory serving: a sliding-window model gets an exact rolling
    # KV ring; a full-attention model can opt into StreamingLLM sinks + ring.
    cfg_w = dataclasses.replace(cfg, window=128)
    ring = engine(cfg_w, init_params_numpy(cfg_w, seed=0), num_pages=8)
    print("rolling-window ring:", ring.rolling, "pages/seq:", ring.pages_per_seq,
          "->", ring.generate(prompts[:1], max_new_tokens=5))
    stream_eng = engine(num_pages=8, streaming_window=128, attention_sinks=128)
    print("streaming sinks:", stream_eng.generate(prompts[:1], max_new_tokens=5),
          stream_eng.stats()["pages_free"], "pages free")


if __name__ == "__main__":
    main()
