"""PyTorch port, kernel H's plain version (ops/pallas_cg.py) against the JAX
package's whole-CG Pallas kernel in interpret mode and against the port's
own solvers.cg. float64 on the CPU; on a CPU tensor the wrapper takes the
plain version, so these tests hold the arithmetic the CUDA kernel repeats
(tests/test_torch_kernels.py holds the kernel to it on a card)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from krylov_spdes_tpu.fem.assembly import (do_isotropic_elliptic_assembly,
                                           prepare_elliptic_assembly)
from krylov_spdes_tpu.fem.bc import get_dirichlet_inds
from krylov_spdes_tpu.fem.mesh import get_mesh
from krylov_spdes_tpu.ops.pallas_cg import stencil_cg_pallas
from krylov_spdes_tpu.ops.stencil import build_stencil_op, to_full_vector

from krylov_spdes_tpu_torch import convert
from krylov_spdes_tpu_torch.ops import pallas_cg as tpc
from krylov_spdes_tpu_torch.ops import persistent
from krylov_spdes_tpu_torch.ops.stencil_kernel import stencil_spmv_plain
from krylov_spdes_tpu_torch.solvers import cg

torch.set_num_threads(1)
CPU64 = dict(device="cpu", dtype=torch.float64)


def _setup(nn, jitter, seed):
    """tests/test_stencil.py's system, on both sides."""
    mesh = get_mesh(nn, jitter=jitter, seed=seed)
    maps = get_dirichlet_inds(mesh.points, mesh.point_markers)
    asm = prepare_elliptic_assembly(
        mesh.cells, mesh.points, maps,
        lambda x, y: -1.0 + 0.0 * x, lambda x, y: 0.0 * x)
    A, b = do_isotropic_elliptic_assembly(
        asm, np.exp(np.random.default_rng(seed).normal(size=mesh.nnode)))
    m1 = int(round(np.sqrt(mesh.nnode)))
    St_j = build_stencil_op(A, maps, (m1, m1))
    b_j = to_full_vector(maps, jnp.asarray(b), mesh.nnode)
    St_t = convert.stencil_op(**convert.numpy_fields(St_j), **CPU64)
    return St_j, b_j, St_t, torch.tensor(np.asarray(b_j))


@pytest.mark.parametrize("nn,jitter,seed", [(900, 0.2, 13), (400, 0.0, 5),
                                            (1225, 0.25, 2)])
def test_plain_version_matches_pallas_kernel_in_interpret_mode(nn, jitter,
                                                               seed):
    """The same solve through `stencil_cg_pallas(interpret=True)` and the
    port: `it` within ±1 (the squared-tolerance stop with two orders of the
    reductions, tests/test_stencil.py:108) and x to rtol 1e-6 (the solves
    stop at 1e-7·‖b‖ and may differ by one iteration)."""
    St_j, b_j, St_t, b_t = _setup(nn, jitter, seed)
    x_j, it_j, res_j = stencil_cg_pallas(St_j, b_j, maxit=1500, rtol=1e-7,
                                         interpret=True)
    n0 = tpc.stencil_cg.launches
    x_t, it_t, res_t = tpc.stencil_cg(St_t, b_t, 1500, 1e-7)
    assert tpc.stencil_cg.launches == n0      # a CPU tensor launches nothing
    assert it_t.dtype == torch.int32 and x_t.shape == (St_t.n,)
    assert abs(int(it_t) - int(it_j)) <= 1, (int(it_t), int(it_j))
    assert 1 < int(it_t) < 1500
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-6,
                               atol=1e-9)
    bnorm = float(torch.linalg.vector_norm(b_t))
    assert float(res_t) <= 1e-7 * bnorm and float(res_j) <= 1e-7 * bnorm


def test_plain_version_matches_the_ports_cg():
    """Semantics of solvers/cg.py: the same iteration accounting and stop
    rule, the same iterates up to the order of the sums."""
    _, _, St, b = _setup(900, 0.2, 13)
    x, it, res = tpc.stencil_cg_plain(St, b, 1500, 1e-7)
    ref = cg(St, b, maxit=1500, rtol=1e-7)
    assert abs(int(it) - int(ref.it)) <= 1, (int(it), int(ref.it))
    np.testing.assert_allclose(x.numpy(), ref.x.numpy(), rtol=1e-6, atol=1e-9)
    # the recurrence residual is the true one
    true = torch.linalg.vector_norm(
        b - stencil_spmv_plain(St.planes, St.dir_diag, x))
    np.testing.assert_allclose(float(true), float(res), rtol=1e-3)


@pytest.mark.parametrize("maxit", [1, 2, 9])
def test_maxit_caps_the_solve(maxit):
    """`it` starts at 1 with the initial residual and stops at maxit; with
    maxit = 1 nothing is applied and x = 0, ‖r‖ = ‖b‖."""
    St_j, b_j, St, b = _setup(400, 0.0, 5)
    x, it, res = tpc.stencil_cg_plain(St, b, maxit, 1e-12)
    x_j, it_j, res_j = stencil_cg_pallas(St_j, b_j, maxit=maxit, rtol=1e-12,
                                         interpret=True)
    assert int(it) == int(it_j) == maxit
    np.testing.assert_allclose(x.numpy(), np.asarray(x_j), rtol=1e-12,
                               atol=1e-15)
    np.testing.assert_allclose(float(res), float(res_j), rtol=1e-12)
    if maxit == 1:
        assert float(x.abs().max()) == 0.0
        np.testing.assert_allclose(float(res), float(
            torch.linalg.vector_norm(b)), rtol=1e-14)


def test_boundary_nodes_read_zeros_not_the_neighbouring_row():
    """On the unpadded layout a column j ± 1 that leaves the row would land
    on the next row's end: one CG step from a right-hand side concentrated
    on the first and last columns, with east/west planes that are non-zero
    there, must see zeros beyond the grid."""
    H, W = 5, 7
    rng = np.random.default_rng(0)
    planes = torch.tensor(rng.normal(size=(9, H, W)))
    planes[0] = planes[0].abs() + 20.0
    St = convert.stencil_op(planes.numpy(), np.zeros((H, W)), np.zeros(0), H,
                            W, **CPU64)
    b = torch.zeros(H, W, dtype=torch.float64)
    b[:, 0] = 1.0
    b[:, -1] = 2.0
    x, it, res = tpc.stencil_cg_plain(St, b.reshape(-1), 2, 1e-30)
    ap = stencil_spmv_plain(St.planes, St.dir_diag, b.reshape(-1))
    alpha = torch.sum(b * b) / torch.sum(b.reshape(-1) * ap)
    np.testing.assert_allclose(x.numpy(), (alpha * b.reshape(-1)).numpy(),
                               rtol=1e-14)
    dense = torch.stack([stencil_spmv_plain(St.planes, St.dir_diag, e)
                         for e in torch.eye(H * W, dtype=torch.float64)], 1)
    # node (i, W-1) has no coupling to node (i+1, 0)
    assert float(dense[W - 1, W].abs()) == 0.0 and float(
        dense[W, W - 1].abs()) == 0.0


def test_wrapper_refuses_other_devices():
    _, _, St, b = _setup(400, 0.0, 5)
    with pytest.raises((ValueError, RuntimeError, NotImplementedError)):
        tpc.stencil_cg(St, b.to("meta"), 10, 1e-7)


# H100 SXM: 132 SMs, 227 KB of opt-in shared memory a block, less a few KB
# of the kernels' static shared memory
SMS, SMEM_MAX = 132, 232448 - 9216


@pytest.mark.parametrize("rows,cols", [(30, 30), (37, 53), (131, 131),
                                       (132, 140), (133, 133), (500, 500),
                                       (1000, 1000)])
def test_band_partition_gives_every_row_once(rows, cols):
    """The persistent kernels' bands (ops/persistent.py, the formula of
    csrc/persistent.cuh::band_of): contiguous, in block order, every node
    row exactly once, no block without a row, none longer than nrmax; the
    shared memory asked for fits the device and covers the layout."""
    grid = persistent.grid_blocks(rows, SMS)
    assert grid == min(rows, SMS)
    bands = persistent.band_rows(rows, grid)
    assert len(bands) == grid
    nxt = 0
    for start, count in bands:
        assert start == nxt and count >= 1
        nxt = start + count
    assert nxt == rows
    counts = [c for _, c in bands]
    assert max(counts) - min(counts) <= 1
    for itemsize in (4, 8):
        h = persistent.stencil_cg_plan(rows, cols, itemsize, SMS, SMEM_MAX)
        assert h.grid == grid and h.nrmax == max(counts)
        assert h.smem <= SMEM_MAX
        vec = 4 * h.nrmax * cols + (h.nrmax + 2) * (cols + 2)
        assert h.scratch_elems == vec
        assert h.smem == itemsize * (vec * h.vectors
                                     + 8 * h.nrmax * cols * h.planes)
        assert h.vectors or not h.planes
        C = -(-(cols + 1) // 32) * 32
        for nvec in (4, 16, 32):
            e = persistent.stretch_plan(rows, C, nvec, itemsize, SMS, SMEM_MAX)
            assert e.grid == grid and e.nrmax == h.nrmax
            assert 0 <= e.w_rows <= nvec and e.smem <= SMEM_MAX
            vec = 5 * e.nrmax * C + (e.nrmax + 2) * C + 8
            coef = -(-3 * nvec * nvec // 4) * 4
            assert e.smem == itemsize * (coef + vec * e.vectors
                                         + e.w_rows * e.nrmax * C)


def test_residency_at_the_smoke_sizes():
    """What lives in shared memory at chip_smoke's sizes: H's band whole at
    500 x 500 float32, its planes in global memory at 1000 x 1000; E's 16
    basis vectors all resident at 250k nodes float32, not all of 32."""
    h = persistent.stencil_cg_plan(500, 500, 4, SMS, SMEM_MAX)
    assert (h.grid, h.nrmax, h.vectors, h.planes) == (132, 4, True, True)
    h = persistent.stencil_cg_plan(1000, 1000, 4, SMS, SMEM_MAX)
    assert (h.nrmax, h.vectors, h.planes) == (8, True, False)
    e = persistent.stretch_plan(500, 512, 16, 4, SMS, SMEM_MAX)
    assert (e.grid, e.nrmax, e.vectors, e.w_rows) == (132, 4, True, 16)
    e = persistent.stretch_plan(500, 512, 32, 4, SMS, SMEM_MAX)
    assert e.vectors and 0 < e.w_rows < 32
