"""PyTorch port, the example drivers against the JAX package's, float64 on
the CPU: the sampled-realization and quantization drivers (Examples 06,
12-16, 18-20). Their samples come from a PRNG key in the
JAX driver and from a torch generator in the port, which no flag can hand
across, so the archives are held to the same names, keys and shapes, and
every KL basis they cache to the same λ within 1e-10 relative
(torch_example_cases.check_parity)."""

import pytest
import torch

import torch_example_cases as tc

torch.set_num_threads(1)

DONE = tc.CHAIN_DRIVERS | tc.EQUAL_ITERS | set(tc.EQUAL_LAMBDA)
HERE = [c for c in tc.ALL_CASES if c[0] not in DONE]


@pytest.mark.parametrize("case", HERE, ids=[tc.case_id(c) for c in HERE])
def test_driver_archives_match_jax(case, tmp_path):
    tc.check_parity(case, tmp_path)
