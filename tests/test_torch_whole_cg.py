"""PyTorch port, kernels C and D (csrc/fused_cg.cu): the host's half of their
launch contract, on the CPU.

`ops/persistent.py::whole_cg_plan` sizes a block's shared memory; the C
entry point refuses a launch whose bytes differ from the layout it derives
itself. The band emulation below walks the kernel's own flat layout (the
same offsets, guard zeros, the extra plane row of K = 5 and the halo slots)
in NumPy and holds it against the plain versions `whole_cg_plain` and
`whole_pcg_plain`, so that the kernel's indexing is checked here and not
only on a card (tests/test_torch_kernels.py holds the kernel itself)."""

import numpy as np
import pytest
import torch

from krylov_spdes_tpu_torch.ops import fused_cg as tfc
from krylov_spdes_tpu_torch.ops import persistent

torch.set_num_threads(1)

# H100 SXM: 132 SMs, 227 KB of opt-in shared memory a block, less a few KB
# of the kernels' static shared memory
SMS, SMEM_MAX = 132, 232448 - 9216
GUARD = 4  # csrc/fused_cg.cu kGuard


def _pitch(W):
    return -(-(W + 1) // 32) * 32


@pytest.mark.parametrize("K", [5, 9])
@pytest.mark.parametrize("pcg", [False, True])
def test_residency_at_the_smoke_sizes(K, pcg):
    """chip_smoke's sizes in float32: at 500 x 500 one block per SM, bands
    of 3-4 rows, vectors and planes in shared memory; at 1000 x 1000 the
    vectors still fit, the planes are read from global memory."""
    p = persistent.whole_cg_plan(500, _pitch(500), K, pcg, 4, SMS, SMEM_MAX)
    assert (p.grid, p.nrmax, p.vectors, p.planes) == (132, 4, True, True)
    p = persistent.whole_cg_plan(1000, _pitch(1000), K, pcg, 4, SMS, SMEM_MAX)
    assert (p.grid, p.nrmax, p.vectors, p.planes) == (132, 8, True, False)


@pytest.mark.parametrize("rows,cols", [(30, 30), (37, 53), (131, 131),
                                       (132, 140), (133, 133), (500, 500),
                                       (1000, 1000), (2000, 2000)])
@pytest.mark.parametrize("K", [5, 9])
def test_plan_bytes_match_the_layout(rows, cols, K):
    """The bytes asked for are the layout's (csrc/fused_cg.cu
    whole_vec_elems, whole_plane_elems) and fit the device; the planes are
    resident only beside resident vectors."""
    C = _pitch(cols)
    for pcg in (False, True):
        for itemsize in (4, 8):
            p = persistent.whole_cg_plan(rows, C, K, pcg, itemsize, SMS,
                                         SMEM_MAX)
            assert p.grid == min(rows, SMS) and p.nrmax == -(-rows // p.grid)
            vec = (3 + pcg) * p.nrmax * C + (p.nrmax + 2) * C + 2 * GUARD
            planes = GUARD + K * (p.nrmax + (K == 5)) * C
            assert p.scratch_elems == vec
            assert p.smem == itemsize * (vec * p.vectors + planes * p.planes)
            assert p.smem <= SMEM_MAX and (p.vectors or not p.planes)
            assert p.w_rows == 0


@pytest.mark.parametrize("rows,cols", [(1, 7), (30, 30), (37, 53),
                                       (133, 133), (500, 500), (1000, 1000)])
def test_bands_cover_every_node_row_of_the_padded_grid_once(rows, cols):
    """Each node row of the (R, C) padded grid (rows 2 .. H + 1) lies in
    exactly one band, and everything a block reads stays inside the grid:
    its tile's halo rows and, for K = 5, the row above its planes, over
    nrmax rows even where its band is one row shorter."""
    C = _pitch(cols)
    R = rows + 4
    p = persistent.whole_cg_plan(rows, C, 5, True, 4, SMS, SMEM_MAX)
    owner = np.full(R, -1)
    for blk, (r0, nr) in enumerate(persistent.band_rows(rows, p.grid)):
        first = r0 + tfc.ROW0
        assert nr in (p.nrmax, p.nrmax - 1) and nr >= 1
        assert (owner[first:first + nr] == -1).all()
        owner[first:first + nr] = blk
        # planes: rows first − 1 .. first + nrmax − 1; halo rows first − 1
        # and first + nr
        assert first - 1 >= 1 and first + p.nrmax - 1 <= R - 2
        assert first + nr <= R - 2
    assert (owner[tfc.ROW0:tfc.ROW0 + rows] >= 0).all()
    assert (owner[:tfc.ROW0] == -1).all() and (owner[tfc.ROW0 + rows:] == -1).all()


def _operator(H, W, sym, seed=0):
    """A random symmetric diagonally dominant padded operator: the planes
    D, E, N, NE, SE (K = 5), or all nine with the mirrored bonds written out
    (K = 9)."""
    rng = np.random.default_rng(seed)
    C = _pitch(W)
    R = H + 4
    node = np.zeros((R, C), bool)
    node[2:2 + H, :W] = True
    p5 = np.zeros((5, R, C))
    p5[1:, node] = -rng.uniform(0.1, 1.0, size=(4, H * W))
    p5[0, node] = 10.0 + rng.uniform(size=H * W)
    if sym:
        planes = p5
    else:
        D, E, N, NE, SE = p5.reshape(5, -1)
        # W[q] = E[q − 1], S[q] = N[q − C], SW[q] = NE[q − C − 1],
        # NW[q] = SE[q − C + 1]
        mirror = [np.roll(a, s) for a, s in ((E, 1), (N, C), (NE, C + 1),
                                              (SE, C - 1))]
        planes = np.stack([D, E, mirror[0], N, mirror[1], NE, mirror[2], SE,
                           mirror[3]]).reshape(9, R, C) * node
    ps = tfc.PaddedStencil(planes=torch.tensor(planes), H=H, W=W, R=R, C=C,
                           K=planes.shape[0])
    b = np.zeros((R, C))
    b[2:2 + H, :W] = rng.normal(size=(H, W))
    return ps, torch.tensor(b)


def _emulate(ps, minv, bp, maxit, tol2, grid):
    """Kernel C (minv None) or D as csrc/fused_cg.cu lays it out, in NumPy:
    each block's arrays flat, at the kernel's offsets (the direction tile of
    nrmax + 2 padded rows after GUARD zeros; the planes after GUARD zeros,
    for K = 5 from the row above the band), the apply by the kernel's flat
    neighbour offsets, the halo rows from the slots the neighbours
    published (z for D). The sums over blocks are NumPy's."""
    H, W, C, K = ps.H, ps.W, ps.C, ps.K
    pcg = minv is not None
    P = ps.planes.numpy().reshape(K, -1)
    b = bp.numpy().reshape(-1)
    mg = minv.numpy().reshape(-1) if pcg else None
    nrmax = -(-H // grid)
    extra = 1 if K == 5 else 0
    pstride = (nrmax + extra) * C
    rg, pg = np.full(b.shape, np.nan), np.full(b.shape, np.nan)
    blocks = []
    for r0, nr in persistent.band_rows(H, grid):
        qb = (r0 + tfc.ROW0) * C
        pl = np.zeros(GUARD + K * pstride)
        for k in range(K):
            src = P[k, qb - extra * C:qb - extra * C + pstride]
            pl[GUARD + k * pstride:GUARD + (k + 1) * pstride] = src
        n = nr * C
        ij = np.array([i * C + j for i in range(nr) for j in range(W)])
        blk = dict(r0=r0, nr=nr, qb=qb, pl=pl, pb=GUARD + extra * C, ij=ij,
                   tile=np.zeros(GUARD + (nrmax + 2) * C + GUARD),
                   x=np.zeros(n), r=b[qb:qb + n].copy(), ap=np.zeros(n),
                   mv=mg[qb:qb + n].copy() if pcg else None)
        blocks.append(blk)
        z = blk["mv"] * blk["r"] if pcg else blk["r"]
        for i in {0, nr - 1}:
            rg[qb + i * C:qb + (i + 1) * C] = z[i * C:(i + 1) * C]
            pg[qb + i * C:qb + (i + 1) * C] = 0.0
    rTr = sum(np.sum(k["r"] * k["r"]) for k in blocks)
    rTz = sum(np.sum(k["r"] * (k["mv"] * k["r"])) for k in blocks) if pcg else 0
    beta, it = 0.0, 1
    while it < maxit and rTr > tol2:
        d = 0.0
        for k in blocks:
            t, qb, nr, ij = k["tile"], k["qb"], k["nr"], k["ij"]
            t0 = GUARD + C     # the band's first row in the tile
            z = k["mv"] * k["r"] if pcg else k["r"]
            t[t0 + ij] = z[ij] + beta * t[t0 + ij]
            js = np.arange(W)
            if k["r0"] > 0:
                t[GUARD + js] = rg[qb - C + js] + beta * pg[qb - C + js]
            if k["r0"] + nr < H:
                g = qb + nr * C + js
                t[GUARD + (nr + 1) * C + js] = rg[g] + beta * pg[g]
            tp = t0 + ij

            def pv(m, off=0):
                return k["pl"][k["pb"] + m * pstride + ij + off]
            v = {o: t[tp + o] for o in (0, 1, -1, C, -C, C + 1, -C - 1,
                                        C - 1, -C + 1)}
            if K == 9:
                y = pv(0) * v[0]
                for m, o in enumerate((1, -1, C, -C, C + 1, -C - 1, C - 1,
                                       -C + 1), start=1):
                    y = y + pv(m) * v[o]
            else:
                y = pv(0) * v[0]
                y = y + pv(1) * v[1]
                y = y + pv(1, -1) * v[-1]
                y = y + pv(2) * v[C]
                y = y + pv(2, -C) * v[-C]
                y = y + pv(3) * v[C + 1]
                y = y + pv(3, -C - 1) * v[-C - 1]
                y = y + pv(4) * v[C - 1]
                y = y + pv(4, -C + 1) * v[-C + 1]
            k["ap"][ij] = y
            d += np.sum(v[0] * y)
        alpha = (rTz if pcg else rTr) / d
        lr = lz = 0.0
        for k in blocks:
            qb, nr, n = k["qb"], k["nr"], k["nr"] * C
            pn = k["tile"][GUARD + C:GUARD + C + n]
            k["x"] = k["x"] + alpha * pn
            k["r"] = k["r"] - alpha * k["ap"]
            lr += np.sum(k["r"] * k["r"])
            z = k["mv"] * k["r"] if pcg else k["r"]
            lz += np.sum(k["r"] * z)
            for i in {0, nr - 1}:
                rg[qb + i * C:qb + (i + 1) * C] = z[i * C:(i + 1) * C]
                pg[qb + i * C:qb + (i + 1) * C] = pn[i * C:(i + 1) * C]
        if pcg:
            beta, rTz = lz / rTz, lz
        else:
            beta = lr / rTr
        rTr = lr
        it += 1
    x = np.zeros(b.shape)
    for k in blocks:
        x[k["qb"]:k["qb"] + k["nr"] * C] = k["x"]
    return x.reshape(bp.shape), it, np.sqrt(rTr)


@pytest.mark.parametrize("H,W,grid", [(13, 11, 4), (9, 40, 9), (7, 5, 1),
                                      (20, 31, 6)])
@pytest.mark.parametrize("sym", [True, False])
@pytest.mark.parametrize("pcg", [False, True])
def test_band_emulation_matches_the_plain_solve(H, W, grid, sym, pcg):
    """The kernel's band layout and halo exchange give the plain version's
    iterates (float64; the sums differ only in order): over 8 iterations and
    a whole solve to 1e-10, with the same `it`; the pad columns and rows of
    x stay zero."""
    ps, bp = _operator(H, W, sym)
    minv = tfc._jacobi_minv(ps, tfc._unblock_planes(ps), None) if pcg else None
    tol2 = 1e-20 * float(torch.sum(bp * bp))
    for maxit in (9, 500):
        x, it, res = _emulate(ps, minv, bp, maxit, tol2, grid)
        if pcg:
            x0, it0, res0 = tfc.whole_pcg_plain(ps, minv, bp, maxit, tol2)
        else:
            x0, it0, res0 = tfc.whole_cg_plain(ps, bp, maxit, tol2)
        assert it == int(it0) and (it == 9 if maxit == 9 else it < maxit)
        np.testing.assert_allclose(x, x0.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(x0.abs().max()))
        np.testing.assert_allclose(res, float(res0), rtol=1e-6)
        assert not x[:2].any() and not x[2 + H:].any() and not x[:, W:].any()
