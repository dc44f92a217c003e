"""Band partition and shared-memory plans of the persistent kernels C, D,
E and H.

The CUDA side is `csrc/persistent.cuh`: one block per SM, block b of nb
owning a contiguous band of node rows, all-gather barriers between blocks.
This module holds the host's half of that contract, in plain Python so that
the CPU tests reach it: which rows each block owns (`band_rows`, the formula
of `band_of` in the header), how many blocks a launch takes, and which of a
band's arrays live in shared memory (the rest are read from global memory by
the same kernel code). The kernels' C entry points check that the bytes
asked for match the layout they derive from the same numbers.
"""

from __future__ import annotations

import dataclasses

MAX_BLOCKS = 256  # csrc/persistent.cuh kMaxBlocks


def sync_words(nb: int) -> int:
    """32-bit words of the zeroed synchronisation buffer of nb blocks (one
    128-byte flag line a block, two sets of 128-byte packed lines)."""
    return nb * (32 + 2 * 2 * 16)


def band_rows(rows: int, nb: int) -> list[tuple[int, int]]:
    """(start, count) of the node rows of each of nb blocks: contiguous
    bands, the first rows % nb of them one row longer."""
    base, extra = divmod(rows, nb)
    return [(b * base + min(b, extra), base + (b < extra)) for b in range(nb)]


def grid_blocks(rows: int, sms: int) -> int:
    """One block per SM, and no block without a row."""
    return max(1, min(rows, sms, MAX_BLOCKS))


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch plan of a persistent kernel.

    grid: blocks (one per SM at most); nrmax: the longest band's rows;
    vectors: the band's vectors in shared memory (else in a per-block
    scratch area of `scratch_elems` values); planes: the band's planes (H's
    eight off-diagonal ones, C's and D's K) in shared memory beside the
    vectors (else read from the input); w_rows: E's basis
    vectors whose band rows are in shared memory (the rest are read from G);
    smem: dynamic shared memory bytes a block."""
    grid: int
    nrmax: int
    vectors: bool
    planes: bool
    w_rows: int
    smem: int
    scratch_elems: int


def _band_plan(grid: int, nrmax: int, vec: int, planes: int, itemsize: int,
               smem_max: int) -> Plan:
    """The vector area in shared memory if it fits, then the planes if they
    fit beside it; what does not fit is read from global memory."""
    vres = vec * itemsize <= smem_max
    pres = vres and (vec + planes) * itemsize <= smem_max
    smem = itemsize * ((vec if vres else 0) + (planes if pres else 0))
    return Plan(grid, nrmax, vres, pres, 0, smem, vec)


def stencil_cg_plan(H: int, W: int, itemsize: int, sms: int,
                    smem_max: int) -> Plan:
    """Kernel H (csrc/stencil_cg.cu): the vector area (P0 + dir_diag, x, r,
    Ap over the band and the (rows + 2) × (W + 2) ringed direction tile)
    first, then the eight other planes if they fit beside it."""
    grid = grid_blocks(H, sms)
    nrmax = _cdiv(H, grid)
    return _band_plan(grid, nrmax, 4 * nrmax * W + (nrmax + 2) * (W + 2),
                      8 * nrmax * W, itemsize, smem_max)


def whole_cg_plan(H: int, C: int, K: int, pcg: bool, itemsize: int, sms: int,
                  smem_max: int) -> Plan:
    """Kernels C and D (csrc/fused_cg.cu) on the padded layout of pitch C:
    the vector area (x, r, Ap and, for D, minv over the band's nrmax padded
    rows, then the direction tile of nrmax + 2 padded rows with 4 zeros at
    each end) first, then, if they fit beside it, 4 zeros and the K planes
    over the band's rows (for K = 5 also the row above them, which the
    mirrored W, S, SW, NW bonds read)."""
    grid = grid_blocks(H, sms)
    nrmax = _cdiv(H, grid)
    vec = (3 + int(pcg)) * nrmax * C + (nrmax + 2) * C + 8
    planes = 4 + K * (nrmax + (K == 5)) * C
    return _band_plan(grid, nrmax, vec, planes, itemsize, smem_max)


def stretch_plan(H: int, C: int, nvec: int, itemsize: int, sms: int,
                 smem_max: int) -> Plan:
    """Kernel E (csrc/eigdef_stretch.cu) on the padded layout of pitch C:
    the coefficient matrices Ac and Bc (3·nvec² values, rounded up to a
    multiple of 4), then the vector area (x, r, ap, accp, minv over the
    band and the direction tile of rows + 2 padded rows and 4 zeros at each
    end), then as many of the nvec basis vectors' band rows as fit beside
    them."""
    grid = grid_blocks(H, sms)
    nrmax = _cdiv(H, grid)
    band = nrmax * C
    coef = _cdiv(3 * nvec * nvec, 4) * 4
    vec = 5 * band + (nrmax + 2) * C + 8
    vres = (coef + vec) * itemsize <= smem_max
    left = smem_max - (coef + (vec if vres else 0)) * itemsize
    w_rows = max(0, min(nvec, left // (band * itemsize)))
    smem = itemsize * (coef + (vec if vres else 0) + w_rows * band)
    return Plan(grid, nrmax, vres, False, w_rows, smem, vec)
