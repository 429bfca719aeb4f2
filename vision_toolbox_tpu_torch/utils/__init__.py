"""Serving export and int8 serving, the JAX-package parameter bridge,
checkpoints and the official checkpoint readers, profiling."""

from .checkpoint import (  # noqa: F401
    extract_backbone,
    load_params_pth,
    restore_train_state,
    save_params_pth,
    save_train_state,
)
