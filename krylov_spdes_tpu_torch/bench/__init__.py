"""Measurement scripts of the port: the root `bench*.py` drivers' twins
(`bench`, `bench_amg`, `bench_banded`, `bench_chain`, `bench_dd_chain`,
`bench_vmem_eigdef`, `bench_vmem_stretch`: the same `BENCH_*` variables,
defaults and printed JSON keys, a `main(argv)` with `--cpu`) and the
port's own probes. Each runs as

    python3 krylov_spdes_tpu_torch/bench/<name>.py

on the CUDA card in float32, or with --cpu on the CPU in float64.
Importing a module runs nothing."""
