"""Train a tiny GQA transformer end to end with the PyTorch port: loss down,
checkpoint round trip.  The counterpart of 02_train_tiny.py.

Runs on the CUDA card by default (the port's kernels, built from csrc/ on
first use); ``--device cpu`` runs the kernels' plain PyTorch versions.

    PYTHONPATH=. python examples/02_train_tiny_torch.py [--device cpu]   # from the repo root
"""

import argparse
import tempfile

import numpy as np
import torch

from flash_attention_dlrs_tpu_torch.models import (
    ModelConfig, make_train_state, make_train_step,
)
from flash_attention_dlrs_tpu_torch.utils import checkpoint


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    device = parser.parse_args().device

    cfg = ModelConfig.tiny(dtype=torch.float32, remat=False)
    model, opt_state, optimizer = make_train_state(cfg, seed=0, device=device,
                                                   learning_rate=1e-3)
    step = make_train_step(cfg, optimizer)

    # Synthetic corpus with learnable structure (tokens repeat).
    data = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size // 4, (4, 129))).to(model.embed.device)

    losses = []
    for i in range(8):
        loss = float(step(model, opt_state, data))
        losses.append(loss)
        print(f"step {i}: loss {loss:.4f}")
    assert losses[-1] < losses[0], "loss should decrease"

    with tempfile.TemporaryDirectory() as tmp:
        state = {"params": model.state_dict(), "opt": opt_state.state_dict()}
        path = checkpoint.save_checkpoint(tmp, state, step=8)
        print("saved:", path, "latest:", checkpoint.latest_step(tmp))
        restored, at_step = checkpoint.restore_checkpoint(tmp)
        model.load_state_dict(restored["params"])
        opt_state.load_state_dict(restored["opt"])
        leaf = next(iter(restored["params"].values()))
        print("restored at step", at_step, "leaf:", tuple(leaf.shape))


if __name__ == "__main__":
    main()
