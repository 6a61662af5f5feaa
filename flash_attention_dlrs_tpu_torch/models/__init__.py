from .convert import (
    config_from_hf,
    config_from_hf_gemma,
    import_hf_gemma,
    import_hf_llama,
    import_hf_phi3,
    load_trained,
)
from .decoding import (
    KVPools,
    init_kv_pools,
    make_decode_step,
    make_prefill,
    make_verify_step,
    write_prompt_kv,
    write_prompt_kv_all,
    write_prompt_kv_batch,
)
from .encoder import encode, init_encoder_params, mlm_logits, mlm_loss
from .eval import perplexity_dense, perplexity_paged
from .optim import adamw8bit
from .train import AdamW, make_train_state, make_train_step
from .trainer import (
    TrainSpec,
    fit,
    lr_schedule,
    make_accum_train_step,
    make_optimizer,
)
from .transformer import (
    ModelConfig,
    Transformer,
    forward,
    loss_fn,
    quantize_params,
    unembed_matrix,
)
from .weights import init_params_numpy, params_from_jax, params_to_numpy

__all__ = [
    "AdamW",
    "adamw8bit",
    "KVPools",
    "ModelConfig",
    "TrainSpec",
    "Transformer",
    "config_from_hf",
    "config_from_hf_gemma",
    "encode",
    "fit",
    "forward",
    "init_encoder_params",
    "init_kv_pools",
    "import_hf_gemma",
    "import_hf_llama",
    "import_hf_phi3",
    "init_params_numpy",
    "load_trained",
    "loss_fn",
    "lr_schedule",
    "make_accum_train_step",
    "make_decode_step",
    "make_optimizer",
    "make_prefill",
    "make_train_state",
    "make_train_step",
    "make_verify_step",
    "mlm_logits",
    "mlm_loss",
    "params_from_jax",
    "params_to_numpy",
    "perplexity_dense",
    "perplexity_paged",
    "quantize_params",
    "unembed_matrix",
    "write_prompt_kv",
    "write_prompt_kv_all",
    "write_prompt_kv_batch",
]
