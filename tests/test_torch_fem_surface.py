"""PyTorch port, the `fem` surface: every name the JAX package's
`krylov_spdes_tpu.fem` exports can be imported from the port's, and the
legacy full-system Dirichlet elimination `apply_dirichlet` agrees with the
JAX package's on the system of tests/test_dd.py's legacy test."""

import ast
import os

import numpy as np
import pytest
import torch

import oracle
from krylov_spdes_tpu.fem.bc import apply_dirichlet as j_apply_dirichlet
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh

import krylov_spdes_tpu_torch.fem as tfem

JAX_FEM_INIT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "krylov_spdes_tpu", "fem", "__init__.py")


def _jax_fem_names():
    tree = ast.parse(open(JAX_FEM_INIT).read())
    return sorted(a.name for node in tree.body
                  if isinstance(node, ast.ImportFrom) for a in node.names)


@pytest.mark.parametrize("name", _jax_fem_names())
def test_jax_fem_name_is_exported_by_port(name):
    assert hasattr(tfem, name), name


def _legacy_system():
    mesh = get_mesh(120, jitter=0.2, seed=1)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    M = oracle.mass_matrix(mesh.cells, mesh.points)
    segs = np.stack([maps.dir_l2g, maps.dir_l2g], axis=1)
    return mesh, maps, M, segs


@pytest.mark.parametrize("rhs", ["numpy", "tensor"])
def test_apply_dirichlet_matches_jax(rhs):
    mesh, maps, M, segs = _legacy_system()
    b = np.random.default_rng(3).normal(size=mesh.nnode)
    uex2 = lambda x, y: x + y  # noqa: E731
    Aj, bj = j_apply_dirichlet(segs, mesh.points, M, b, uex2)
    bt_in = torch.as_tensor(b) if rhs == "tensor" else b
    At, bt = tfem.apply_dirichlet(segs, mesh.points, M, bt_in, uex2)
    np.testing.assert_array_equal(At.toarray(), Aj.toarray())
    np.testing.assert_array_equal(bt, bj)
    # Dirichlet rows are identity with the boundary value on the RHS, and
    # the elimination left the original untouched
    for g in maps.dir_l2g:
        assert At[g, g] == 1.0 and At[g].nnz == 1
        assert bt[g] == mesh.points[g, 0] + mesh.points[g, 1]
    assert np.count_nonzero(M.toarray()[maps.dir_l2g[0]]) > 1
