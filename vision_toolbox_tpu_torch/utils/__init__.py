"""Serving export and the JAX-package parameter bridge."""
