"""PyTorch port, FEM host setup and assembly: mesh and Dirichlet arrays,
CSR assembly values and the dense stencil refill against the JAX package,
and the convert.py round trip (float64, CPU)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem import assembly as jasm
from krylov_spdes_tpu.fem import bc as jbc
from krylov_spdes_tpu.fem import mesh as jmesh
from krylov_spdes_tpu.fem import stencil_assembly as jsa
from krylov_spdes_tpu.ops import fused_cg as jfc
from krylov_spdes_tpu.ops import stencil as jst

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.fem import assembly as tasm
from krylov_spdes_tpu_torch.fem import bc as tbc
from krylov_spdes_tpu_torch.fem import mesh as tmesh
from krylov_spdes_tpu_torch.fem import stencil_assembly as tsa
from krylov_spdes_tpu_torch.ops import fused_cg as tfc
from krylov_spdes_tpu_torch.ops import stencil as tst

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def f_src(x, y):
    return -1.0 + 0.0 * x


def u_lift(x, y):
    # a nonzero Dirichlet datum exercises the lift terms
    return 1.0 + x * y


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("nn,jitter", [(900, 0.0), (1600, 0.25)])
def test_mesh_and_dirichlet_arrays_equal(nn, jitter):
    mj = jmesh.get_mesh(nn, jitter=jitter, seed=4)
    mt = tmesh.get_mesh(nn, jitter=jitter, seed=4)
    for f in ("cells", "points", "point_markers", "cell_neighbors"):
        np.testing.assert_array_equal(getattr(mt, f), getattr(mj, f))
    for a, b in zip(tmesh.element_geometry(mt.cells, mt.points),
                    jmesh.element_geometry(mj.cells, mj.points)):
        np.testing.assert_array_equal(a, b)
    dj = jbc.get_dirichlet_inds(mj.points, mj.point_markers)
    dt = tbc.get_dirichlet_inds(mt.points, mt.point_markers)
    for f in ("free_g2l", "dir_g2l", "free_l2g", "dir_l2g", "is_dirichlet"):
        np.testing.assert_array_equal(getattr(dt, f), getattr(dj, f))
    u = np.random.default_rng(1).normal(size=dt.n_free)
    np.testing.assert_array_equal(
        tbc.append_bc(dt, torch.as_tensor(u), mt.points, u_lift),
        jbc.append_bc(dj, u, mj.points, u_lift))


def test_csr_assembly_values_match_jax():
    mesh = jmesh.get_mesh(1600, jitter=0.2, seed=2)
    maps = jbc.get_dirichlet_inds(mesh.points, mesh.point_markers)
    coeff = np.exp(np.random.default_rng(5).normal(size=mesh.nnode))
    aj = jasm.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                        u_lift)
    at = tasm.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                        u_lift, **CPU64)
    Aj, bj = jasm.do_isotropic_elliptic_assembly(aj, coeff)
    At, bt = tasm.do_isotropic_elliptic_assembly(at, coeff)
    for f in ("indptr", "indices", "rows", "ell_idx", "ell_cols"):
        np.testing.assert_array_equal(_np(getattr(At, f)),
                                      np.asarray(getattr(Aj, f)))
    # entries that cancel to ~1e-17 get an absolute floor at the same 1e-13
    # relative to the operator's scale
    scale = np.abs(np.asarray(Aj.data)).max()
    np.testing.assert_allclose(_np(At.data), np.asarray(Aj.data), rtol=1e-13,
                               atol=1e-13 * scale)
    np.testing.assert_allclose(_np(bt), np.asarray(bj), rtol=1e-13,
                               atol=1e-15)
    x = np.random.default_rng(6).normal(size=At.n_rows)
    np.testing.assert_allclose(_np(At.matvec(torch.as_tensor(x))),
                               np.asarray(Aj.matvec(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("jitter", [0.0, 0.25])
def test_stencil_assemble_matches_jax(jitter):
    mesh = jmesh.get_mesh(1600, jitter=jitter, seed=3)
    maps = jbc.get_dirichlet_inds(mesh.points, mesh.point_markers)
    pj = jsa.prepare_stencil_assembly(mesh, maps, f_src, u_lift)
    pt = tsa.prepare_stencil_assembly(mesh, maps, f_src, u_lift, **CPU64)
    assert pt.terms == pj.terms and pt.bterms == pj.bterms
    for seed in (0, 1):
        coeff = np.exp(np.random.default_rng(seed).normal(size=mesh.nnode))
        planes_j, b_j = jsa.stencil_assemble(pj, jnp.asarray(coeff))
        Sj, _ = jsa.make_stencil_operator(pj, coeff)
        St, b_t = tsa.make_stencil_operator(pt, coeff)
        np.testing.assert_allclose(_np(St.planes), np.asarray(planes_j),
                                   rtol=1e-13, atol=1e-15)
        np.testing.assert_allclose(_np(b_t), np.asarray(b_j), rtol=1e-13,
                                   atol=1e-15)
        np.testing.assert_array_equal(_np(St.dir_diag), np.asarray(Sj.dir_diag))


def test_convert_round_trip():
    mesh = jmesh.get_mesh(900, jitter=0.2, seed=1)
    maps = jbc.get_dirichlet_inds(mesh.points, mesh.point_markers)
    aj = jasm.prepare_elliptic_assembly(mesh.cells, mesh.points, maps, f_src,
                                        u_lift)
    coeff = np.exp(np.random.default_rng(2).normal(size=mesh.nnode))
    Aj, _ = jasm.do_isotropic_elliptic_assembly(aj, coeff)
    Sj = jst.build_stencil_op(Aj, maps, (30, 30))
    plan_j = jsa.prepare_stencil_assembly(mesh, maps, f_src, u_lift)

    cases = [(Sj, convert.stencil_op), (Aj, convert.sparse_op),
             (plan_j, convert.stencil_assembly_plan)]
    for obj, make in cases:
        fields = convert.numpy_fields(obj)
        ported = make(**fields, **CPU64)
        back = convert.numpy_fields(ported)
        assert back.keys() == fields.keys()
        for k, v in fields.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(back[k], v, err_msg=k)
            else:
                assert back[k] == v, k
    mt = convert.dirichlet_maps(**convert.numpy_fields(maps))
    for f in dataclasses.fields(maps):
        np.testing.assert_array_equal(getattr(mt, f.name),
                                      getattr(maps, f.name))

    # PaddedStencil, via its 9-plane source: the same planes on both layouts
    psj = jfc.build_padded_stencil(Sj, tb=16)
    pst = convert.padded_stencil(np.asarray(Sj.planes), np.asarray(Sj.dir_diag),
                                 Sj.H, Sj.W, **CPU64)
    assert pst.K == psj.K == 5
    flat_j = np.asarray(jfc._unblock_planes(psj)).reshape(psj.K, psj.R, psj.C)
    H, W = Sj.H, Sj.W
    np.testing.assert_array_equal(
        _np(pst.planes)[:, tfc.ROW0:tfc.ROW0 + H, :W],
        flat_j[:, 8:8 + H, 1:1 + W])
    # and the port's StencilOp built from the converted CSR operator agrees
    St = tst.build_stencil_op(convert.sparse_op(**convert.numpy_fields(Aj),
                                                **CPU64), maps, (30, 30))
    np.testing.assert_array_equal(_np(St.planes), np.asarray(Sj.planes))
    np.testing.assert_array_equal(_np(St.slot), np.asarray(Sj.slot))
