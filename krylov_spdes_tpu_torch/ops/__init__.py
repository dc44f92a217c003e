"""Operators and kernels of the port (mirrors krylov_spdes_tpu/ops)."""
