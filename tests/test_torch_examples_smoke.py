"""PyTorch port, the example drivers (krylov_spdes_tpu_torch/examples/) must
keep running end to end: the port's counterpart of every case in CASES of
tests/test_examples_smoke.py at the same arguments, float64 on the CPU,
each called in this process through its `main(argv)` with --cpu and a data
directory of its own; one driver run as `python -m`, and one that must
refuse to run without --cpu on a host with no CUDA device. The rest of the
cases, and the drivers' other flags, are in
test_torch_examples_smoke_more.py."""

import os
import subprocess
import sys

import pytest
import torch

import torch_example_cases as tc

torch.set_num_threads(1)


@pytest.mark.parametrize("case", tc.CASES,
                         ids=[tc.case_id(c) for c in tc.CASES])
def test_example_runs(case, tmp_path):
    module, args = case
    out = tc.run_port(module, args, tmp_path)
    assert "saved" in out and "device cpu float64" in out
    tc.check_archives(tmp_path)


def _cli(args, tmp_path, env=None):
    return subprocess.run(
        [sys.executable, "-m", "krylov_spdes_tpu_torch.examples."
         "ex01_elliptic_pde", "--nnode", "400", "--data-dir",
         str(tmp_path)] + args,
        cwd=tc.ROOT, capture_output=True, text=True, timeout=300, env=env)


def test_driver_runs_as_module(tmp_path):
    r = _cli(["--cpu"], tmp_path)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    assert "saved" in r.stdout and "device cpu float64" in r.stdout
    assert "it=17" in r.stdout      # the JAX driver's count on this mesh
    tc.check_archives(tmp_path)


def test_driver_without_cpu_flag_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks a host without a CUDA device")
    r = _cli([], tmp_path)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr and "'cuda'" in r.stderr
    assert "saved" not in r.stdout and not os.listdir(tmp_path)
