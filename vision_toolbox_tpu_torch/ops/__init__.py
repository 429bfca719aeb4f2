"""Ops: the fused half-block kernels (K3, K4) and the attention core."""
