"""Layers and initializers."""
