"""Checkpoint / resume of a training state, PyTorch port of ``flash_attention_dlrs_tpu/utils/checkpoint.py``.

A state is a dict of state dicts, tensors and plain Python values (the
trainer saves the model's and the optimizer's state dicts, the loader cursor
and the step).  Each save goes to ``path/step_{step:08d}/state.pt`` through
``torch.save``, written to a temporary name and renamed into place; the
newest ``keep`` steps are kept.  Single process: a multi-process run saves
from one process.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Optional, Tuple

import torch

_STATE_FILE = "state.pt"


def save_checkpoint(path: str, state: Any, *, step: int, keep: int = 3) -> str:
    """Write ``state`` under path/step_{step:08d}; prunes old steps."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, f"step_{step:08d}")
    os.makedirs(target, exist_ok=True)
    tmp = os.path.join(target, _STATE_FILE + ".tmp")
    torch.save(state, tmp)
    os.replace(tmp, os.path.join(target, _STATE_FILE))
    _prune(path, keep)
    return target


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(name.split("_")[1])
        for name in os.listdir(path)
        if name.startswith("step_")
    ]
    return max(steps) if steps else None


def restore_checkpoint(
    path: str, *, step: Optional[int] = None, map_location="cpu"
) -> Tuple[Any, int]:
    """Load the state saved at ``step`` (default: the newest); returns
    (state, step).  Tensors land on ``map_location``; ``load_state_dict``
    moves them onto the model's and optimizer's devices."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    target = os.path.join(path, f"step_{step:08d}", _STATE_FILE)
    state = torch.load(target, map_location=map_location, weights_only=True)
    return state, step


def _prune(path: str, keep: int) -> None:
    steps = sorted(
        name for name in os.listdir(path) if name.startswith("step_")
    )
    for name in steps[:-keep]:
        shutil.rmtree(os.path.join(path, name))
