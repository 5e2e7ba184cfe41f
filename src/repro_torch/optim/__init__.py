"""Optimizer of the port (mirror of ``repro/optim``): AdamW over trees
of tensors, the warmup-cosine schedule and dynamic loss scaling."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
from repro_torch.optim.loss_scale import (  # noqa: F401
    LossScaleState,
    grads_finite,
    loss_scale_init,
    loss_scale_update,
)
