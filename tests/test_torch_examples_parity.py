"""PyTorch port, the example drivers (krylov_spdes_tpu_torch/examples/)
against the JAX package's (examples/), float64 on the CPU: the
deterministic drivers. Each case of tests/test_examples_smoke.py runs
through the JAX driver in a subprocess and through the port's in this
process on the same flags. The archives must have the same names, keys
and shapes; Examples 01 (three arms), 03, 10 and 11 the same iteration
counts; Examples 02 and 04 the same λ within 1e-10 relative. A KL basis
cached by the JAX driver loads in the port's. The drivers that draw
from a PRNG key are in test_torch_examples_parity_chains.py and
test_torch_examples_parity_quant.py (see torch_example_cases.py for what
each kind is held to)."""

import numpy as np
import pytest
import torch

import torch_example_cases as tc

torch.set_num_threads(1)

HERE = [c for c in tc.ALL_CASES
        if c[0] in tc.EQUAL_ITERS or c[0] in tc.EQUAL_LAMBDA]


@pytest.mark.parametrize("case", HERE, ids=[tc.case_id(c) for c in HERE])
def test_driver_matches_jax(case, tmp_path):
    J, P = tc.check_parity(case, tmp_path)
    if case[0] == "ex03_dd_schur":
        # the two cross-checks of Example 03 in float64
        (f,) = [f for f in P if f.endswith(".ex03.npz")]
        assert float(P[f]["apply_err"]) <= 1e-12
        assert float(P[f]["sol_err"]) <= 1e-8


def test_kl_cache_written_by_jax_loads_in_port(tmp_path):
    module, args = tc.EXTRA_DEFAULT_CASES[0]
    assert module == "ex02_karhunen_loeve"
    (tmp_path / "jax").mkdir()
    tc.run_jax(module, args, tmp_path / "jax")
    data = tmp_path / "jax" / "data"
    J = tc.archives(data)
    (cache,) = [f for f in J if ".seed0.kl10" in f]
    (kl,) = [f for f in J if f.endswith(".ex02.kl.npz")]
    out = tc.run_port(module, args, data)
    assert f"KL basis loaded from {data / cache}" in out
    P = tc.archives(data)
    np.testing.assert_array_equal(P[kl]["lam"], J[cache]["lam"])
    np.testing.assert_array_equal(P[kl]["psi"], J[cache]["psi"])
