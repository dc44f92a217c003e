"""The example drivers of the port (mirrors the JAX package's `examples/`).

One module per driver, with the same file name, flags, defaults and
artifacts as its JAX counterpart; each runs as

    python -m krylov_spdes_tpu_torch.examples.ex01_elliptic_pde [flags]

on the CUDA card in float32, or with --cpu on the CPU in float64. Importing
a module runs nothing: the flags are parsed in `main(argv=None)`, which the
tests and chip_smoke.py call in-process.
"""
