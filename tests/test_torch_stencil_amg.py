"""PyTorch port, the all-stencil SA-AMG (precond/stencil_amg.py) against the
JAX package and against an explicit scipy Galerkin product: float64 on the
CPU, the same seeded stencil operators through both packages
(tests/test_stencil_amg.py's setup)."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops.stencil import build_stencil_op, to_full_vector
from krylov_spdes_tpu.precond import stencil_amg as jsamg
from krylov_spdes_tpu.solvers.cg import pcg as j_pcg

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.precond import stencil_amg as tsamg
from krylov_spdes_tpu_torch.solvers import pcg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _setup(nn=900, seed=0):
    mesh = get_mesh(nn, jitter=0.2, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(mesh.cells, mesh.points, maps,
                                    lambda x, y: -1.0 + 0.0 * x,
                                    lambda x, y: 0.0 * x)
    rng = np.random.default_rng(seed)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(0.8 * rng.normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    Sj = build_stencil_op(A, maps, (m1, m1))
    St = convert.stencil_op(**convert.numpy_fields(Sj), **CPU64)
    bf = np.asarray(to_full_vector(maps, jnp.asarray(b), mesh.nnode))
    return mesh, maps, asm, A, Sj, St, bf


def _materialize(planes, H, W):
    n = H * W
    eye = torch.eye(n, dtype=planes.dtype)
    return tsamg._plane_matvec(planes, eye.reshape(n, H, W)).reshape(n, n).T


def test_coarse_planes_match_explicit_galerkin():
    """Comb-extracted coarse planes == scipy PᵀAP with the level's own T and
    σ (tests/test_stencil_amg.py:46 on the port)."""
    _, _, _, _, _, St, _ = _setup(nn=400)
    H, W = St.H, St.W
    planes = St.planes.clone()
    planes[0] += St.dir_diag
    live = 1.0 - St.dir_diag
    hier = tsamg.stencil_amg_setup(planes, live, H, W, max_coarse=20)
    lev0 = hier["levels"][0]
    Af = sp.csr_matrix(_materialize(planes, H, W).numpy())
    Hc, Wc = -(-H // 3), -(-W // 3)
    ii = np.arange(H * W)
    agg = (ii // W // 3) * Wc + (ii % W) // 3
    T = sp.csr_matrix((lev0["wf"].numpy().ravel(), (ii, agg)),
                      shape=(H * W, Hc * Wc))
    Dinv = sp.diags((1.0 / planes[0]).numpy().ravel())
    P = (sp.identity(H * W) - float(lev0["sigma"]) * (Dinv @ Af)) @ T
    Ac_ref = (P.T @ Af @ P).toarray()
    cpad = np.zeros((Hc * 3, Wc * 3))
    cpad[:H, :W] = live.numpy()
    csum = cpad.reshape(Hc, 3, Wc, 3).sum(axis=(1, 3)).ravel()
    Ac_ref[csum == 0, csum == 0] = 1.0
    assert len(hier["levels"]) > 1
    Ac = _materialize(hier["levels"][1]["planes"], Hc, Wc).numpy()
    np.testing.assert_allclose(Ac, Ac_ref, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("nn,seed", [(900, 0), (3600, 2)])
def test_hierarchy_apply_and_pcg_match_jax(nn, seed):
    _, _, _, _, Sj, St, bf = _setup(nn=nn, seed=seed)
    Mj = jsamg.stencil_amg_precond(Sj)
    Mt = tsamg.stencil_amg_precond(St)
    hj, ht = Mj.args[0], Mt.args[3]
    assert len(ht["levels"]) == len(hj["levels"])
    for lt, lj in zip(ht["levels"], hj["levels"]):
        for k in ("planes", "dinv", "wf"):
            np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]),
                                       rtol=1e-11, atol=1e-13, err_msg=k)
        assert abs(float(lt["sigma"]) - float(lj["sigma"])) <= \
            1e-12 * float(lj["sigma"])
    r = np.random.default_rng(7).normal(size=bf.shape[0])
    zj = np.asarray(Mj(jnp.asarray(r)))
    zt = Mt(torch.as_tensor(r)).numpy()
    assert np.linalg.norm(zt - zj) <= 1e-10 * np.linalg.norm(zj)
    rj = j_pcg(Sj, jnp.asarray(bf), M=Mj)
    rt = pcg(St, torch.as_tensor(bf), M=Mt)
    assert abs(int(rt.it) - int(rj.it)) <= 1, (int(rt.it), int(rj.it))
    assert rt.history()[-1] <= 1e-7 * np.linalg.norm(bf)


def test_rebuild_is_value_only():
    """A rebuild on refilled planes reads nothing of the previous build and
    gives the hierarchy of a build afresh; the refilled preconditioner
    converges (tests/test_stencil_amg.py:105 on the port)."""
    mesh, maps, asm, _, Sj, St, _ = _setup(nn=900, seed=6)
    rng = np.random.default_rng(7)
    A2, b2 = do_isotropic_elliptic_assembly(
        asm, np.exp(0.8 * rng.normal(size=mesh.nnode)))
    St2 = St.with_csr_data(torch.as_tensor(np.asarray(A2.data)))
    S2j = Sj.with_csr_data(A2.data)
    np.testing.assert_array_equal(St2.planes.numpy(), np.asarray(S2j.planes))
    tsamg.stencil_amg_precond(St)                  # an earlier build
    M2 = tsamg.stencil_amg_precond(St2)
    M2_fresh = tsamg.stencil_amg_precond(
        convert.stencil_op(**convert.numpy_fields(S2j), **CPU64))
    r = torch.as_tensor(np.random.default_rng(8).normal(size=St.n))
    np.testing.assert_array_equal(M2(r).numpy(), M2_fresh(r).numpy())
    bf = torch.as_tensor(np.asarray(to_full_vector(
        maps, jnp.asarray(b2), mesh.nnode)))
    res = pcg(St2, bf, M=M2)
    assert res.history()[-1] <= 1e-7 * float(torch.linalg.vector_norm(bf))
