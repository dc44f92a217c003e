// Kernels B, C and D of the port: stencil CG on the padded layout of
// krylov_spdes_tpu_torch/ops/fused_cg.py.
//
// Layout (shared with the Python side): a vector is an (R, C) row-major
// grid, R = H + 4, C = W + 1 rounded up to a multiple of 32. Node (i, j)
// sits at row i + 2, column j. Rows 0, 1, H + 2, H + 3 and columns W..C-1
// are zero in every vector and every plane, so the flat neighbours q ± 1,
// q ± C, q ± C ± 1 of any node are in bounds and read zero beyond the grid:
// no kernel masks a neighbour. B writes every element of its outputs; C and
// D write only nodes.
// Planes: K = 9 (P0 + dir_diag, E, W, N, S, NE, SW, SE, NW) or the symmetric
// K = 5 (D, E, N, NE, SE; the W, S, SW, NW bonds are the E, N, NE, SE bonds
// of the neighbour), each an (R, C) grid.
//
// B  cg_sweep   replaces krylov_spdes_tpu/ops/fused_cg.py::_k1_kernel.
//    One pass, one launch: pn = r + β·p, Ap = A·pn, d = pnᵀAp. The launch
//    writes every element of pn and Ap (zeros on the pad rows and columns),
//    so the caller allocates both uninitialised. Bound by bytes: (K + 4)
//    values a node (planes, r, p in; pn, Ap out), 9 × 4 B = 36 B a node at
//    K = 5 in float32, 9.3 MB at 500 × 500, about 2.8 µs at 3.35 TB/s.
//
//    Design. Block (s, b) of a (segments, strips) grid owns strip b's node
//    rows (csrc/persistent.cuh::band_of; two rows at 500 × 500) over
//    segment s of a padded row's 16-byte groups, one group a thread; a
//    segment is the whole row up to kSweepGroups groups (500 × 500 in
//    float32 is one segment, 1000 × 1000 two). The block walks down its
//    rows with a window of direction rows in shared memory. Step i loads
//    row i + 1 of r and p (step 0 also the halo row above and row 0) and
//    row i of the K planes, 16 bytes a thread and row, and it issues step
//    i + 1's loads before its one __syncthreads, so that they fly while
//    it forms pn = r + β·p once a node into the window, writes the
//    strip's own rows of pn out once, and after the barrier forms row i's
//    Ap from the window and the planes. The window has four slots so that
//    one barrier a row separates the next row's writes from the last
//    row's reads (three rows are in use). The E/W neighbours across a
//    group come from the window; a segment's edge columns (one value each
//    side) are loaded by its first and last thread. K = 5: the mirrored
//    bonds read the plane row above (E[q − 1], N[q − C], NE[q − C − 1],
//    SE[q − C + 1]; common.cuh::apply_vals): E, NE and SE rows are kept in
//    shared memory (three slots) and N's in registers, so a strip reads
//    each plane value once. The halo rows and edge columns are read
//    without masks: the ring of zero rows keeps them in bounds. pn and Ap
//    are the products and sums of apply_vals in its order, so they equal
//    cg_sweep_plain bit for bit under --fmad=false.
//
//    What bounds it at 500 × 500 (bench/sweep_phases.py): the loads, all
//    issued at entry, arrive over 2.4 µs (L2-warm; a strip re-reads its
//    halo rows, 1.5× the bytes), then the last strips' rows and the sum of
//    d across blocks take about 3 µs more.
//
//    d, in a fixed order: a thread's nodes in row order, the warp
//    butterfly, the warps in order, giving the block's partial. Each block
//    publishes its partial (index s + segments·b) as packed words, the
//    value's 32-bit chunks each with a 1 in the high half, one relaxed
//    64-bit store a chunk: the value and its flag travel together, so no
//    fence and no atomic is needed. After its own rows the last block
//    waits for the words (thread t takes partials t, t + T, ... in index
//    order, then the warp butterfly and the warps in order), writes d and
//    sets the words back to 0 for the next launch. The launch is
//    cooperative, so that block never waits for a block that is not
//    resident. No float atomics: d repeats bit for bit from run to run.
//    (bench/sweep_phases.py at 500 × 500: a ticket drawn with atomicAdd
//    after a __threadfence, the usual last-block election, took 2.2 µs of
//    a 5.6 µs launch; the words take 1.4 µs from the last partial to d; a
//    block of its own that waited for them from the start took 1.7 µs.)
//
// C  whole_cg   replaces krylov_spdes_tpu/ops/fused_cg.py::_vmem_cg_kernel.
// D  whole_pcg  replaces krylov_spdes_tpu/ops/fused_cg.py::_vmem_pcg_kernel.
//    The whole (Jacobi-P)CG solve in one launch, the Hopper counterpart of
//    the TPU solve that stayed in VMEM. Inputs: the planes, minv (D), b and
//    tol² on the device; x0 = 0, r = b, z = r (C) or minv ⊙ r (D); the loop
//    runs while it < maxit and rᵀr > tol² with it starting at 1
//    (fused_cg.py:483-485,578-580); it (int32) and √(rᵀr) are written to
//    device memory.
//
//    Design (csrc/persistent.cuh, kernel H's design on this layout): one
//    persistent block per SM, each owning a band of node rows (3-4 at
//    500 × 500). A block keeps in shared memory its band's x, r, Ap (and
//    minv for D) over the band's padded rows, the direction in a tile of
//    those rows plus one halo row above and below (pad columns zero, so the
//    apply reads its nine neighbours with no masks), and the K planes over
//    the band (for K = 5 also the padded row above it, which the mirrored
//    bonds read). An iteration:
//      1. pn = z + β·p on the band (in place in the tile) and on its two
//         halo rows (from the neighbours' published rows of z and p), then
//         Ap and the block's partial of pnᵀAp; all-gather barrier → α.
//      2. x += α·pn, r −= α·Ap, the block's partials of rᵀr (and rᵀz); the
//         band's first and last padded rows of z (r for C) and pn to the
//         halo slots rg, pg; all-gather barrier → rᵀr (rᵀz), β, the stop
//         test.
//    D's neighbours publish z = minv ⊙ r, the product the owner forms
//    itself, so no block reads another band's minv. A halo slot is written
//    only after barrier 1 and read only before the next barrier 1, so one
//    slot a row suffices. Both barriers are packed all-gathers (a block's
//    partials travel with its epoch in 64-bit release stores; D's second
//    carries rᵀr and rᵀz together), so an iteration has two barriers, the
//    floor of this recurrence, and no grid-wide sync of cooperative groups.
//    The values are the plain versions' step by step (whole_cg_plain,
//    whole_pcg_plain): the same products and sums in the same order
//    (--fmad=false); the reductions have another fixed order (a thread's
//    nodes, the warp butterfly, the warps in order, then the blocks), with
//    no float atomics, so a solve repeats bit for bit.
//
//    Residency: where the band's vectors or planes do not fit in shared
//    memory beside each other (1000 × 1000 and up), the same code reads them
//    from global memory: the planes straight from the input, the vectors
//    from a per-block scratch area. The wrapper (ops/fused_cg.py,
//    ops/persistent.py::whole_cg_plan) decides it from the device's shared
//    memory; there is no size limit and no other path.
//
//    What bounds it: latency. An iteration's work is ~2000 nodes a block
//    from shared memory; what is left is the two all-gathers (~1.6 µs each
//    at 132 blocks on an H100, krylov_spdes_tpu_torch/bench/barrier_bench.cu)
//    and the block's own synchronisation.
//
// The library is built with --fmad=false so that every product and sum
// rounds on its own, as the plain PyTorch versions' elementwise ops do.

#include <cuda_runtime.h>

#include "common.cuh"
#include "persistent.cuh"

namespace {

// ---- B: one sweep, one launch ---------------------------------------------

constexpr int kSweepGroups = 128;  // most 16-byte groups (threads) a block spans

// Values of T a shared row of a sweep block holds: a guard group for the
// left edge column, the segment's S groups, a guard group for the right.
__host__ __device__ inline int sweep_row(int S, int n) { return (S + 2) * n; }

// Shared rows of a sweep block: four slots of the direction window, and for
// K = 5 three slots each of the E, NE and SE plane rows.
__host__ __device__ inline int sweep_rows(int K) { return 4 + (K == 5 ? 9 : 0); }

__device__ __forceinline__ void st_relaxed64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

// What the step of row q loads: row q + 1 of r and p with the segment's
// edge values (left, right), and row q of the K planes (K = 5 with the edge
// values E and NE left, SE right).
template <typename T, int K>
struct SweepLoad {
  static constexpr int N = Pack<T>::n;
  T rv[N], pv[N], re[2], pe[2];
  T pl[K][N];
  T ee[3];
};

// What step 0 loads besides: rows a − 1 and a of r and p, and for K = 5 the
// N, NE and SE values of row a − 1 (with NE left and SE right edges).
template <typename T>
struct SweepFirst {
  static constexpr int N = Pack<T>::n;
  T rv[2][N], pv[2][N], re[2][2], pe[2][2];
  T up[3][N];
  T ue[2];
};

template <typename T, int K>
struct SweepStrip {
  static constexpr int N = Pack<T>::n;
  const T* __restrict__ P;
  const T* __restrict__ r;
  const T* __restrict__ p;
  T* __restrict__ pn;
  T* __restrict__ ap;
  T* sm;       // the shared rows
  long plane;  // elements of one plane
  int L;       // values of a shared row
  int W, C;
  int a, nr;   // the strip's first padded row and its rows
  int c, l;    // the thread's first column, its offset in a shared row
  int cl, cr;  // the segment's edge columns (left, right) and their offsets
  int ll, lr;
  bool mine, left, right;  // the thread has a group; loads the left / right edge
  T beta;
  T d;         // the thread's sum of pn·Ap, in row order
  T ns[N];     // K = 5: N of the row above (N[q − C])

  __device__ T* win(int row) const { return sm + (row & 3) * L; }
  // K = 5 plane rows in shared memory: k = 0 E, 1 NE, 2 SE
  __device__ T* prow(int k, int row) const { return sm + (4 + 3 * k + row % 3) * L; }

  // pn at column x of a row from its r and p: zero on the pad columns
  __device__ T dir(T rv, T pv, int x) const {
    return (x >= 0 && x < W) ? rv + beta * pv : T(0);
  }

  // pn of padded row `row` into the window, and out to pn if the strip owns
  // the row
  __device__ void form(int row, const T* rv, const T* pv, const T* re,
                       const T* pe) const {
    T* w = win(row);
    if (mine) {
      T v[N];
#pragma unroll
      for (int u = 0; u < N; ++u) v[u] = dir(rv[u], pv[u], c + u);
      st16(w + l, v);
      if (row >= a && row < a + nr) st16(pn + static_cast<long>(row) * C + c, v);
    }
    if (left) w[ll] = dir(re[0], pe[0], cl);
    if (right) w[lr] = dir(re[1], pe[1], cr);
  }

  __device__ void load_rp(int row, T* rv, T* pv, T* re, T* pe) const {
    const long q = static_cast<long>(row) * C;
    if (mine) {
      ld16(r + q + c, rv);
      ld16(p + q + c, pv);
    }
    if (left) {
      re[0] = r[q + cl];
      pe[0] = p[q + cl];
    }
    if (right) {
      re[1] = r[q + cr];
      pe[1] = p[q + cr];
    }
  }

  __device__ void load(int q, SweepLoad<T, K>& o) const {
    load_rp(q + 1, o.rv, o.pv, o.re, o.pe);
    const long qo = static_cast<long>(q) * C;
    if (mine) {
#pragma unroll
      for (int k = 0; k < K; ++k) ld16(P + k * plane + qo + c, o.pl[k]);
    }
    if constexpr (K == 5) {
      if (left) {
        o.ee[0] = P[plane + qo + cl];
        o.ee[1] = P[3 * plane + qo + cl];
      }
      if (right) o.ee[2] = P[4 * plane + qo + cr];
    }
  }

  __device__ void load_first(SweepFirst<T>& f) const {
#pragma unroll
    for (int k = 0; k < 2; ++k) load_rp(a - 1 + k, f.rv[k], f.pv[k], f.re[k], f.pe[k]);
    if constexpr (K == 5) {
      const long qu = static_cast<long>(a - 1) * C;
      if (mine) {
#pragma unroll
        for (int k = 0; k < 3; ++k) ld16(P + (2 + k) * plane + qu + c, f.up[k]);
      }
      if (left) f.ue[0] = P[3 * plane + qu + cl];
      if (right) f.ue[1] = P[4 * plane + qu + cr];
    }
  }

  __device__ void put_first(const SweepFirst<T>& f) {
#pragma unroll
    for (int k = 0; k < 2; ++k) form(a - 1 + k, f.rv[k], f.pv[k], f.re[k], f.pe[k]);
    if constexpr (K == 5) {
      if (mine) {
#pragma unroll
        for (int u = 0; u < N; ++u) ns[u] = f.up[0][u];
        st16(prow(1, a - 1) + l, f.up[1]);
        st16(prow(2, a - 1) + l, f.up[2]);
      }
      if (left) prow(1, a - 1)[ll] = f.ue[0];
      if (right) prow(2, a - 1)[lr] = f.ue[1];
    }
  }

  // Form row q + 1 of pn and keep row q's plane rows that the neighbours
  // read; one barrier; Ap of row q.
  __device__ void step(int q, const SweepLoad<T, K>& o) {
    form(q + 1, o.rv, o.pv, o.re, o.pe);
    if constexpr (K == 5) {
      if (mine) {
        st16(prow(0, q) + l, o.pl[1]);
        st16(prow(1, q) + l, o.pl[3]);
        st16(prow(2, q) + l, o.pl[4]);
      }
      if (left) {
        prow(0, q)[ll] = o.ee[0];
        prow(1, q)[ll] = o.ee[1];
      }
      if (right) prow(2, q)[lr] = o.ee[2];
    }
    __syncthreads();
    if (!mine) return;
    // e*[k]: the window's value at column c + k − 1 of rows q − 1, q, q + 1
    T eS[N + 2], e0[N + 2], eN[N + 2];
    const T* wS = win(q - 1) + l;
    const T* w0 = win(q) + l;
    const T* wN = win(q + 1) + l;
    ld16(wS, eS + 1);
    ld16(w0, e0 + 1);
    ld16(wN, eN + 1);
    eS[0] = wS[-1];
    e0[0] = w0[-1];
    eN[0] = wN[-1];
    eS[N + 1] = wS[N];
    e0[N + 1] = w0[N];
    eN[N + 1] = wN[N];
    const auto& pl = o.pl;
    T y[N];
    if constexpr (K == 9) {
#pragma unroll
      for (int u = 0; u < N; ++u) {
        T s = pl[0][u] * e0[u + 1];
        s = s + pl[1][u] * e0[u + 2];
        s = s + pl[2][u] * e0[u];
        s = s + pl[3][u] * eN[u + 1];
        s = s + pl[4][u] * eS[u + 1];
        s = s + pl[5][u] * eN[u + 2];
        s = s + pl[6][u] * eS[u];
        s = s + pl[7][u] * eN[u];
        s = s + pl[8][u] * eS[u + 2];
        y[u] = s;
      }
    } else {
      // E[q − 1] at columns c − 1 .., NE[q − C − 1] at c − 1 .., SE[q − C + 1]
      // at c ..
      T eE[N + 1], eNE[N + 1], eSE[N + 1];
      const T* pE = prow(0, q) + l;
      const T* pNE = prow(1, q - 1) + l;
      const T* pSE = prow(2, q - 1) + l;
      eE[0] = pE[-1];
#pragma unroll
      for (int u = 0; u < N; ++u) eE[u + 1] = pl[1][u];
      eNE[0] = pNE[-1];
      ld16(pNE, eNE + 1);
      ld16(pSE, eSE);
      eSE[N] = pSE[N];
#pragma unroll
      for (int u = 0; u < N; ++u) {
        T s = pl[0][u] * e0[u + 1];
        s = s + pl[1][u] * e0[u + 2];
        s = s + eE[u] * e0[u];
        s = s + pl[2][u] * eN[u + 1];
        s = s + ns[u] * eS[u + 1];
        s = s + pl[3][u] * eN[u + 2];
        s = s + eNE[u] * eS[u];
        s = s + pl[4][u] * eN[u];
        s = s + eSE[u + 1] * eS[u + 2];
        y[u] = s;
      }
#pragma unroll
      for (int u = 0; u < N; ++u) ns[u] = pl[2][u];
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      if (c + u < W) {
        d += e0[u + 1] * y[u];
      } else {
        y[u] = T(0);
      }
    }
    st16(ap + static_cast<long>(q) * C + c, y);
  }
};

// d from the nb blocks' packed words: a thread's words, kPoll partials at
// a time, are loaded together and only those not yet written are waited
// for; each is cleared once read.
template <typename T>
__device__ void sum_published(unsigned long long* slots, int nb, T* d, T* red) {
  constexpr int CW = sizeof(T) / 4;
  constexpr int kPoll = 4;
  const int t = threadIdx.x;
  T v = T(0);
  for (int j0 = t; j0 < nb; j0 += kPoll * blockDim.x) {
    unsigned long long w[kPoll][CW];
#pragma unroll
    for (int m = 0; m < kPoll; ++m) {
      const int j = j0 + m * blockDim.x;
#pragma unroll
      for (int h = 0; h < CW; ++h)
        w[m][h] = j < nb ? ld_relaxed64(slots + static_cast<long>(j) * CW + h) : 0ull;
    }
#pragma unroll
    for (int m = 0; m < kPoll; ++m) {
      const int j = j0 + m * blockDim.x;
      if (j >= nb) break;
      unsigned int cw[CW];
#pragma unroll
      for (int h = 0; h < CW; ++h) {
        unsigned long long* slot = slots + static_cast<long>(j) * CW + h;
        cw[h] = (w[m][h] >> 32) ? static_cast<unsigned int>(w[m][h]) : wait_word(slot, 1u);
        st_relaxed64(slot, 0ull);
      }
      T x;
      from_words(cw, x);
      v += x;
    }
  }
  v = warp_sum(v);
  if ((t & 31) == 0) red[t >> 5] = v;
  __syncthreads();
  if (t == 0) {
    T b = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) b += red[w];
    *d = b;
  }
}

// slots: CW packed words a block (csrc/persistent.cuh::to_words), zero
// before the launch and zero after it.
template <typename T, int K>
__global__ void __launch_bounds__(kSweepGroups)
cg_sweep_strip_kernel(const T* __restrict__ P, const T* __restrict__ r,
                      const T* __restrict__ p, const T* __restrict__ betap,
                      T* __restrict__ pn, T* __restrict__ ap,
                      unsigned long long* slots, T* __restrict__ d, int H,
                      int W, int C, int S) {
  constexpr int N = Pack<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kSweepGroups / 32];
  const int strips = gridDim.y;
  const int t = threadIdx.x;
  const int g0 = blockIdx.x * S;          // the segment's first group
  const int ng = min(S, C / N - g0);      // and its groups
  SweepStrip<T, K> s;
  s.P = P;
  s.r = r;
  s.p = p;
  s.pn = pn;
  s.ap = ap;
  s.sm = reinterpret_cast<T*>(smem_raw);
  s.plane = static_cast<long>(H + 2 * kRow0) * C;
  s.L = sweep_row(S, N);
  s.W = W;
  s.C = C;
  int r0;
  band_of(blockIdx.y, strips, H, &r0, &s.nr);
  s.a = r0 + kRow0;
  s.c = (g0 + t) * N;
  s.l = (t + 1) * N;
  s.cl = g0 * N - 1;
  s.cr = (g0 + ng) * N;
  s.ll = N - 1;
  s.lr = (ng + 1) * N;
  s.mine = t < ng;
  s.left = t == 0;
  s.right = t == ng - 1;
  s.beta = *betap;
  s.d = T(0);
  // every load of steps 0 and 1 is issued before the first barrier, and
  // step i + 1's before step i's barrier
  SweepFirst<T> f;
  SweepLoad<T, K> cur, nxt;
  s.load_first(f);
  s.load(s.a, cur);
  if (s.nr > 1) s.load(s.a + 1, nxt);
  // the pad rows of pn and Ap: the first strip writes rows 0 and 1, the
  // last rows H + 2 and H + 3
  if (s.mine) {
    T z[N];
#pragma unroll
    for (int u = 0; u < N; ++u) z[u] = T(0);
    for (int k = 0; k < 2 * kRow0; ++k) {
      const int row = k < kRow0 ? k : H + k;
      if ((k < kRow0 && blockIdx.y == 0) || (k >= kRow0 && blockIdx.y == strips - 1)) {
        st16(pn + static_cast<long>(row) * C + s.c, z);
        st16(ap + static_cast<long>(row) * C + s.c, z);
      }
    }
  }
  s.put_first(f);
  s.step(s.a, cur);
  for (int i = 1; i < s.nr; ++i) {
    cur = nxt;
    if (i + 1 < s.nr) s.load(s.a + i + 1, nxt);
    s.step(s.a + i, cur);
  }

  // d: each block publishes its partial as packed words (value and a 1 in
  // one 64-bit store, so the reader needs no fence); the last block sums
  // them (the blocks are co-resident: a cooperative launch)
  constexpr int CW = sizeof(T) / 4;
  T v = warp_sum(s.d);
  if ((t & 31) == 0) red[t >> 5] = v;
  __syncthreads();
  if (t == 0) {
    T b = red[0];
    for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) b += red[w];
    unsigned int cw[CW];
    to_words(b, cw);
    const long bid = static_cast<long>(blockIdx.y) * gridDim.x + blockIdx.x;
#pragma unroll
    for (int h = 0; h < CW; ++h)
      st_relaxed64(slots + bid * CW + h, (1ull << 32) | cw[h]);
  }
  const int nb = gridDim.x * strips;
  if (static_cast<int>(blockIdx.y * gridDim.x + blockIdx.x) != nb - 1) return;
  __syncthreads();  // red is read above by thread 0
  sum_published(slots, nb, d, red);
}

template <typename T, int K>
const void* sweep_kernel_fn() {
  return reinterpret_cast<const void*>(&cg_sweep_strip_kernel<T, K>);
}

const void* pick_sweep(int dtype, int K) {
  if (dtype == 0 && K == 5) return sweep_kernel_fn<float, 5>();
  if (dtype == 0 && K == 9) return sweep_kernel_fn<float, 9>();
  if (dtype == 1 && K == 5) return sweep_kernel_fn<double, 5>();
  if (dtype == 1 && K == 9) return sweep_kernel_fn<double, 9>();
  return nullptr;
}

// Dynamic shared memory of a sweep block of S groups, and the attribute that
// allows it above the default 48 KB.
cudaError_t sweep_smem(const void* fn, int dtype, int K, int S, int* smem) {
  const int esize = dtype == 0 ? 4 : 8;
  *smem = sweep_rows(K) * sweep_row(S, 16 / esize) * esize;
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
}

// ---- C / D: the whole solve in one persistent launch ----------------------

constexpr int kGuard = 4;  // zeros before and after the direction tile

// Elements of T a block's vector area holds: x, r, Ap (and minv for D) over
// the band of nrmax padded rows, then the direction tile of nrmax + 2 padded
// rows (the band and one halo row above and below) with kGuard zeros before
// and after it.
__host__ __device__ inline long whole_vec_elems(int nrmax, int C, int pcg) {
  return (3L + pcg) * nrmax * C + static_cast<long>(nrmax + 2) * C + 2 * kGuard;
}

// Padded rows of each plane a block keeps: the band's, and for K = 5 the
// row above them, which the mirrored W, S, SW, NW bonds read (E[q − 1],
// N[q − C], NE[q − C − 1], SE[q − C + 1]; common.cuh::apply_vals).
__host__ __device__ inline int plane_rows(int nrmax, int K) {
  return nrmax + (K == 5 ? 1 : 0);
}

// Elements of T the band's planes take: kGuard zeros (NE[q − C − 1] of the
// band's first node reads one value before the row above), then the K
// planes of plane_rows rows each.
__host__ __device__ inline long whole_plane_elems(int nrmax, int C, int K) {
  return kGuard + static_cast<long>(K) * plane_rows(nrmax, K) * C;
}

// x, rg, pg: (R, C) grids; x's pad rows zero. rg, pg: the halo slots, of
// which each block writes and its neighbours read the band's first and last
// padded rows (r, or z = minv ⊙ r for D, and the direction).
template <typename T, int K, bool PCG>
__global__ void __launch_bounds__(kPThreads, 1)
whole_cg_kernel(const T* __restrict__ P, const T* __restrict__ minv,
                const T* __restrict__ b, const T* __restrict__ tol2p, T* x,
                T* rg, T* pg, unsigned int* sync, T* scratch, int* it_out,
                T* res_out, int H, int W, int C, int maxit, int nrmax,
                int vres, int pres) {
  constexpr int N = Pack<T>::n;
  constexpr int NV = PCG ? 2 : 1;  // values of the second all-gather
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[NV * kPWarps];
  __shared__ T sums[NV];
  __shared__ unsigned int sh32[kMaxBlocks * NV * sizeof(T) / 4];
  int r0, nr;
  band_of(blockIdx.x, gridDim.x, H, &r0, &nr);
  const long plane = static_cast<long>(H + 2 * kRow0) * C;
  const long band = static_cast<long>(nrmax) * C;
  const long qb = static_cast<long>(r0 + kRow0) * C;  // band's first node row
  // the band's passes walk items of N consecutive values of a padded row
  // (pad columns included: they are zero in every operand and stay zero)
  const int cv = C / N;
  const int items = nr * cv;
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* vec = vres ? sm : scratch + blockIdx.x * whole_vec_elems(nrmax, C, PCG);
  T* xs = vec;
  T* rs = vec + band;
  T* aps = vec + 2 * band;
  T* mv = vec + 3 * band;                         // D only
  T* tile = vec + (PCG ? 4 : 3) * band + kGuard;  // row 0: the row above
  // the planes, indexed like the band's vectors (node (i, j) of the band at
  // i·C + j), plane k at pl + k·pstride: in shared memory or in the input
  const T* pl;
  long pstride;
  if (pres) {
    T* ps = sm + (vres ? whole_vec_elems(nrmax, C, PCG) : 0);
    const int extra = plane_rows(nrmax, K) - nrmax;
    pstride = static_cast<long>(plane_rows(nrmax, K)) * C;
    if (threadIdx.x < kGuard) ps[threadIdx.x] = T(0);
    for (int k = 0; k < K; ++k) {
      const T* src = P + k * plane + qb - extra * C;
      T* dst = ps + kGuard + k * pstride;
      for (long t = threadIdx.x; t < pstride / N; t += kPThreads) {
        T v[N];
        ld16(src + t * N, v);
        st16(dst + t * N, v);
      }
    }
    pl = ps + kGuard + extra * C;
  } else {
    pl = P + qb;
    pstride = plane;
  }

  for (long t = threadIdx.x; t < static_cast<long>(nrmax + 2) * C + 2 * kGuard; t += kPThreads)
    tile[t - kGuard] = T(0);
  // x = 0, r = b, Ap = 0 (the apply writes nodes only: its pads stay zero);
  // the halo slots r = b (z = minv ⊙ b), p = 0
  T lr = T(0), lz = T(0);
  for (int t = threadIdx.x; t < items; t += kPThreads) {
    const int i = t / cv;
    const long l = i * static_cast<long>(C) + (t - i * cv) * N;
    T bv[N], zv[N], zero[N];
    ld16(b + qb + l, bv);
#pragma unroll
    for (int u = 0; u < N; ++u) zero[u] = T(0);
    st16(rs + l, bv);
    st16(xs + l, zero);
    st16(aps + l, zero);
    if constexpr (PCG) {
      T mvv[N];
      ld16(minv + qb + l, mvv);
      st16(mv + l, mvv);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        zv[u] = mvv[u] * bv[u];
        lr += bv[u] * bv[u];
        lz += bv[u] * zv[u];
      }
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u) lr += bv[u] * bv[u];
    }
    if (i == 0 || i == nr - 1) {
      st16(rg + qb + l, PCG ? zv : bv);
      st16(pg + qb + l, zero);
    }
  }
  // every all-gather here is packed: one value a block, two for D's second
  Barrier<T> bar(sync, nullptr, 0);
  T v[NV];
  v[0] = lr;
  if constexpr (PCG) v[1] = lz;
  block_totals(v, red);
  bar.all_values(v, sums, sh32, true);  // and the halo slots
  T rTr = sums[0];
  T rTz = PCG ? sums[NV - 1] : T(0);
  const T tol2 = *tol2p;
  T beta = T(0);
  int it = 1;
  const bool above = r0 > 0, below = r0 + nr < H;
  while (it < maxit && rTr > tol2) {
    // 1. pn = z + β·p on the band and its halo rows (the halo loads issued
    //    first, so that the band's update hides their latency), then Ap
    //    and pnᵀAp
    for (int j = threadIdx.x; j < W; j += kPThreads) {
      T za = T(0), pa = T(0), zb = T(0), pb = T(0);
      if (above) {
        za = __ldcg(rg + qb - C + j);
        pa = __ldcg(pg + qb - C + j);
      }
      if (below) {
        const long g = qb + nr * static_cast<long>(C) + j;
        zb = __ldcg(rg + g);
        pb = __ldcg(pg + g);
      }
      for (int i = 0; i < nr; ++i) {
        const long l = i * static_cast<long>(C) + j;
        const T z = PCG ? mv[l] * rs[l] : rs[l];
        tile[C + l] = z + beta * tile[C + l];
      }
      if (above) tile[j] = za + beta * pa;
      if (below) tile[(nr + 1) * static_cast<long>(C) + j] = zb + beta * pb;
    }
    __syncthreads();
    // (a node a thread, neighbouring threads on neighbouring nodes; the
    // band's rows innermost and unrolled, so that a thread's plane loads
    // for several rows are in flight together where they come from global
    // memory)
    T ld = T(0);
    for (int j = threadIdx.x; j < W; j += kPThreads) {
#pragma unroll 4
      for (int i = 0; i < nr; ++i) {
        const long l = i * static_cast<long>(C) + j;
        const T* tp = tile + C + l;
        const T v0 = tp[0];
        const T y = apply_vals<T, K>(pl, pstride, l, C, v0, tp[1], tp[-1],
                                     tp[C], tp[-C], tp[C + 1], tp[-C - 1],
                                     tp[C - 1], tp[-C + 1]);
        aps[l] = y;
        ld += v0 * y;
      }
    }
    T v1[1] = {ld};
    block_totals(v1, red);
    bar.all_values(v1, sums, sh32, false);
    const T alpha = (PCG ? rTz : rTr) / sums[0];

    // 2. x += α·pn, r −= α·Ap, rᵀr (and rᵀz); the band's edge rows of r
    //    (z) and pn to the halo slots
    lr = T(0);
    lz = T(0);
    for (int t = threadIdx.x; t < items; t += kPThreads) {
      const int i = t / cv;
      const long l = i * static_cast<long>(C) + (t - i * cv) * N;
      T xv[N], pv[N], rv[N], av[N], zv[N];
      ld16(xs + l, xv);
      ld16(tile + C + l, pv);
      ld16(rs + l, rv);
      ld16(aps + l, av);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        xv[u] = xv[u] + alpha * pv[u];
        rv[u] = rv[u] - alpha * av[u];
        lr += rv[u] * rv[u];
      }
      if constexpr (PCG) {
        T mvv[N];
        ld16(mv + l, mvv);
#pragma unroll
        for (int u = 0; u < N; ++u) {
          zv[u] = mvv[u] * rv[u];
          lz += rv[u] * zv[u];
        }
      }
      st16(xs + l, xv);
      st16(rs + l, rv);
      if (i == 0 || i == nr - 1) {
        st16(rg + qb + l, PCG ? zv : rv);
        st16(pg + qb + l, pv);
      }
    }
    v[0] = lr;
    if constexpr (PCG) v[1] = lz;
    block_totals(v, red);
    bar.all_values(v, sums, sh32, true);  // and the halo slots just written
    const T rTr_new = sums[0];
    if constexpr (PCG) {
      beta = sums[1] / rTz;
      rTz = sums[1];
    } else {
      beta = rTr_new / rTr;
    }
    rTr = rTr_new;
    ++it;
  }
  for (int t = threadIdx.x; t < items; t += kPThreads) {
    const int i = t / cv;
    const long l = i * static_cast<long>(C) + (t - i * cv) * N;
    T xv[N];
    ld16(xs + l, xv);
    st16(x + qb + l, xv);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *it_out = it;
    *res_out = sqrt(rTr);
  }
}

template <typename T, int K, bool PCG>
const void* whole_kernel_fn() {
  return reinterpret_cast<const void*>(&whole_cg_kernel<T, K, PCG>);
}

const void* pick_whole(int dtype, int K, int pcg) {
  if (dtype == 0) {
    if (K == 5) return pcg ? whole_kernel_fn<float, 5, true>() : whole_kernel_fn<float, 5, false>();
    if (K == 9) return pcg ? whole_kernel_fn<float, 9, true>() : whole_kernel_fn<float, 9, false>();
  } else if (dtype == 1) {
    if (K == 5) return pcg ? whole_kernel_fn<double, 5, true>() : whole_kernel_fn<double, 5, false>();
    if (K == 9) return pcg ? whole_kernel_fn<double, 9, true>() : whole_kernel_fn<double, 9, false>();
  }
  return nullptr;
}

}  // namespace

extern "C" {

// B's limits: out[0] = SM count, out[1] = blocks of S groups an SM holds at
// once. Returns a cudaError_t.
int cg_sweep_limits(int dtype, int K, int S, int* out) {
  const void* fn = pick_sweep(dtype, K);
  if (fn == nullptr || S < 1 || S > kSweepGroups) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem = 0;
  cudaError_t err = sweep_smem(fn, dtype, K, S, &smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], fn, (S + 31) / 32 * 32, smem);
  return static_cast<int>(err);
}

// B. dtype: 0 = float32, 1 = float64. The launch plan (segments of S
// 16-byte groups, strips) comes from ops/fused_cg.py::sweep_plan, within
// cg_sweep_limits; the launch is cooperative, so it fails rather than run
// blocks that are not all resident. slots: segments × strips × (1 for float32, 2 for float64)
// 64-bit words, zero before the launch (the launch leaves them zero); d
// one value. Returns a cudaError_t.
int cg_sweep(int dtype, int K, const void* P, const void* r, const void* p,
             const void* beta, void* pn, void* ap, void* slots, void* d,
             int H, int W, int C, int segments, int S, int strips,
             void* stream) {
  const void* fn = pick_sweep(dtype, K);
  const int n = dtype == 0 ? 4 : 2;
  if (fn == nullptr || C % 32 != 0 || C <= W || W < 1 || H < 1 || S < 1
      || S > kSweepGroups || segments != (C / n + S - 1) / S || strips < 1
      || strips > H) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int smem = 0;
  cudaError_t err = sweep_smem(fn, dtype, K, S, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&P, &r, &p, &beta, &pn, &ap, &slots, &d, &H, &W, &C, &S};
  err = cudaLaunchCooperativeKernel(fn, dim3(segments, strips),
                                    dim3((S + 31) / 32 * 32), args,
                                    static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The device's limits for the whole solve: out[0] = SM count, out[1] = the
// most dynamic shared memory a block of the kernel can ask for (the opt-in
// maximum less the kernel's static shared memory). Returns a cudaError_t.
int whole_cg_limits(int dtype, int K, int pcg, int* out) {
  const void* fn = pick_whole(dtype, K, pcg);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(persistent_limits(fn, out));
}

// C (pcg = 0, minv unused) and D (pcg = 1). dtype: 0 = float32, 1 =
// float64. x, rg, pg: (R, C) grids the caller allocates, x zeroed; sync:
// sync_words(grid) zeroed 32-bit words; scratch: grid × whole_vec_elems
// values when vres = 0; tol2 one value, it one int32, res one value. grid,
// nrmax = ⌈H / grid⌉, vres, pres and smem come from
// ops/persistent.py::whole_cg_plan; smem must be the bytes that layout
// needs. Returns a cudaError_t: cudaErrorCooperativeLaunchTooLarge if the
// grid is not resident at once.
int whole_cg(int dtype, int K, int pcg, const void* P, const void* minv,
             const void* b, const void* tol2, void* x, void* rg, void* pg,
             void* sync, void* scratch, void* it, void* res, int H, int W,
             int C, int maxit, int grid, int nrmax, int vres, int pres,
             int smem, void* stream) {
  const void* fn = pick_whole(dtype, K, pcg);
  const long esize = dtype == 0 ? 4 : 8;
  const long need = esize * ((vres ? whole_vec_elems(nrmax, C, pcg) : 0)
                             + (pres ? whole_plane_elems(nrmax, C, K) : 0));
  if (fn == nullptr || grid < 1 || grid > H || grid > kMaxBlocks
      || nrmax != (H + grid - 1) / grid || C <= W || C % 4 != 0
      || smem != need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&P, &minv, &b, &tol2, &x, &rg, &pg, &sync, &scratch, &it,
                  &res, &H, &W, &C, &maxit, &nrmax, &vres, &pres};
  return static_cast<int>(launch_persistent(fn, grid, smem, args, stream));
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
