"""Config system, the PyTorch port's copy of ``flash_attention_dlrs_tpu/utils/config.py``.

The reference's "config system" is module-level constants edited in-file
(reference: README.md "set up parameters within the files", src/bench.py:8-21,
src/test_correctness.py:9-14; SURVEY.md §5).  Here configs are frozen
dataclasses (ModelConfig, BlockSizes, ...) loadable from JSON and
overridable through FA_TORCH_<FIELD> environment variables: reproducible
runs without editing source.  Pure Python.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Type, TypeVar

T = TypeVar("T")

_ENV_PREFIX = "FA_TORCH_"


def _coerce(value: str, typ) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def load_config(
    cls: Type[T],
    path: str | None = None,
    *,
    overrides: dict | None = None,
    use_env: bool = True,
) -> T:
    """Build ``cls`` from (defaults ← JSON file ← env ← explicit overrides)."""
    data: dict = {}
    if path:
        with open(path) as f:
            data.update(json.load(f))
    fields = {f.name: f for f in dataclasses.fields(cls)}
    if use_env:
        for name, field in fields.items():
            env_key = _ENV_PREFIX + name.upper()
            if env_key in os.environ:
                data[name] = _coerce(os.environ[env_key],
                                     field.type if isinstance(field.type, type) else str)
    if overrides:
        data.update(overrides)
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"unknown {cls.__name__} fields: {sorted(unknown)}")
    return cls(**data)


def dump_config(cfg: Any, path: str) -> None:
    """Serialize a dataclass config to JSON (dtype-ish fields stringified)."""
    def default(o):
        return str(o)

    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2, default=default)
