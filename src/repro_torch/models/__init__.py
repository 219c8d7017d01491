from repro_torch.models.transformer import (  # noqa: F401
    decode_step,
    init_cache,
    init_params,
    loss_fn,
    params_from_numpy,
    prefill,
)
