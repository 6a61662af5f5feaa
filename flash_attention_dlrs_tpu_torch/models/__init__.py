from .decoding import (
    KVPools,
    init_kv_pools,
    make_decode_step,
    make_prefill,
    write_prompt_kv_all,
)
from .transformer import ModelConfig, Transformer, forward, unembed_matrix
from .weights import init_params_numpy, params_from_jax

__all__ = [
    "KVPools",
    "ModelConfig",
    "Transformer",
    "forward",
    "init_kv_pools",
    "init_params_numpy",
    "make_decode_step",
    "make_prefill",
    "params_from_jax",
    "unembed_matrix",
    "write_prompt_kv_all",
]
