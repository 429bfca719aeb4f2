"""Serving export, the JAX-package parameter bridge, and checkpoints."""

from .checkpoint import (  # noqa: F401
    extract_backbone,
    load_params_pth,
    restore_train_state,
    save_params_pth,
    save_train_state,
)
