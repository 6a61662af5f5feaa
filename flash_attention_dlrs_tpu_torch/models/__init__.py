from .decoding import (
    KVPools,
    init_kv_pools,
    make_decode_step,
    make_prefill,
    write_prompt_kv_all,
)
from .train import AdamW, make_train_state, make_train_step
from .trainer import (
    TrainSpec,
    fit,
    lr_schedule,
    make_accum_train_step,
    make_optimizer,
)
from .transformer import ModelConfig, Transformer, forward, loss_fn, unembed_matrix
from .weights import init_params_numpy, params_from_jax, params_to_numpy

__all__ = [
    "AdamW",
    "KVPools",
    "ModelConfig",
    "TrainSpec",
    "Transformer",
    "fit",
    "forward",
    "init_kv_pools",
    "init_params_numpy",
    "loss_fn",
    "lr_schedule",
    "make_accum_train_step",
    "make_decode_step",
    "make_optimizer",
    "make_prefill",
    "make_train_state",
    "make_train_step",
    "params_from_jax",
    "params_to_numpy",
    "unembed_matrix",
    "write_prompt_kv_all",
]
