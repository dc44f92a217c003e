// Kernels B, C and D of the port: stencil CG on the padded layout of
// krylov_spdes_tpu_torch/ops/fused_cg.py.
//
// Layout (shared with the Python side): a vector is an (R, C) row-major
// grid, R = H + 4, C = W + 1 rounded up to a multiple of 32. Node (i, j)
// sits at row i + 2, column j. Rows 0, 1, H + 2, H + 3 and columns W..C-1
// are zero in every vector and every plane, so the flat neighbours q ± 1,
// q ± C, q ± C ± 1 of any node are in bounds and read zero beyond the grid:
// no kernel masks a neighbour. Only nodes are ever written.
// Planes: K = 9 (P0 + dir_diag, E, W, N, S, NE, SW, SE, NW) or the symmetric
// K = 5 (D, E, N, NE, SE; the W, S, SW, NW bonds are the E, N, NE, SE bonds
// of the neighbour), each an (R, C) grid.
//
// B  cg_sweep   replaces krylov_spdes_tpu/ops/fused_cg.py::_k1_kernel.
//    One pass: pn = r + β·p, Ap = A·pn, d = pnᵀAp. Bound by bytes:
//    (K + 4) values a node (planes, r, p in; pn, Ap out), 9 × 4 B = 36 B a
//    node at K = 5 in float32, 9 MB at 250k nodes, about 2.7 µs at
//    3.35 TB/s. One thread a node; the neighbours' pn is recomputed from r
//    and p (cache hits) rather than exchanged, so the pass needs no halo.
//    d is reduced in a fixed order (block tree, then one block over the
//    partials) with no float atomics, so it repeats from run to run.
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

// Direction at padded index q: r + β·p.
template <typename T>
__device__ __forceinline__ T dir_at(const T* r, const T* p, T beta, long q) {
  return r[q] + beta * p[q];
}

// (A·pn)[q] with pn = dir_at(...) recomputed at each of the 9 neighbours;
// the node's own pn is returned through pn_self.
template <typename T, int K>
__device__ __forceinline__ T apply_dir(const T* __restrict__ P, long plane,
                                       const T* r, const T* p, T beta, long q,
                                       int C, T& pn_self) {
  const T v0 = dir_at<T>(r, p, beta, q);
  const T vE = dir_at<T>(r, p, beta, q + 1);
  const T vW = dir_at<T>(r, p, beta, q - 1);
  const T vN = dir_at<T>(r, p, beta, q + C);
  const T vS = dir_at<T>(r, p, beta, q - C);
  const T vNE = dir_at<T>(r, p, beta, q + C + 1);
  const T vSW = dir_at<T>(r, p, beta, q - C - 1);
  const T vSE = dir_at<T>(r, p, beta, q + C - 1);
  const T vNW = dir_at<T>(r, p, beta, q - C + 1);
  pn_self = v0;
  return apply_vals<T, K>(P, plane, q, C, v0, vE, vW, vN, vS, vNE, vSW, vSE,
                          vNW);
}

// ---- B: one sweep ---------------------------------------------------------

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
cg_sweep_kernel(const T* __restrict__ P, const T* __restrict__ r,
                const T* __restrict__ p, const T* __restrict__ betap,
                T* __restrict__ pn_out, T* __restrict__ ap_out,
                T* __restrict__ part, int H, int W, int C) {
  __shared__ T sh[kThreads];
  const long n = static_cast<long>(H) * W;
  const long plane = static_cast<long>(H + 2 * kRow0) * C;
  const long t = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  T d = T(0);
  if (t < n) {
    const long q = node_index(t, W, C);
    T pn;
    const T y = apply_dir<T, K>(P, plane, r, p, *betap, q, C, pn);
    pn_out[q] = pn;
    ap_out[q] = y;
    d = pn * y;
  }
  const T s = block_sum(d, sh);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_kernel(const T* __restrict__ part, int G, T* __restrict__ out) {
  __shared__ T sh[kThreads];
  const T s = sum_partials(part, G, sh);
  if (threadIdx.x == 0) *out = s;
}

int sweep_blocks(int H, int W) {
  return static_cast<int>((static_cast<long>(H) * W + kThreads - 1) / kThreads);
}

template <typename T, int K>
int launch_sweep(const void* P, const void* r, const void* p, const void* beta,
                 void* pn, void* ap, void* part, void* d, int H, int W, int C,
                 cudaStream_t stream) {
  const int G = sweep_blocks(H, W);
  cg_sweep_kernel<T, K><<<G, kThreads, 0, stream>>>(
      static_cast<const T*>(P), static_cast<const T*>(r),
      static_cast<const T*>(p), static_cast<const T*>(beta),
      static_cast<T*>(pn), static_cast<T*>(ap), static_cast<T*>(part), H, W, C);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_kernel<T><<<1, kThreads, 0, stream>>>(static_cast<const T*>(part), G,
                                           static_cast<T*>(d));
  return static_cast<int>(cudaGetLastError());
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

// Number of blocks (and of partial sums) of one cg_sweep call.
int cg_sweep_blocks(int H, int W) { return sweep_blocks(H, W); }

// B. dtype: 0 = float32, 1 = float64. part holds cg_sweep_blocks(H, W)
// values; d is one value. Returns cudaGetLastError() after the launches.
int cg_sweep(int dtype, int K, const void* P, const void* r, const void* p,
             const void* beta, void* pn, void* ap, void* part, void* d, int H,
             int W, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && K == 5) return launch_sweep<float, 5>(P, r, p, beta, pn, ap, part, d, H, W, C, s);
  if (dtype == 0 && K == 9) return launch_sweep<float, 9>(P, r, p, beta, pn, ap, part, d, H, W, C, s);
  if (dtype == 1 && K == 5) return launch_sweep<double, 5>(P, r, p, beta, pn, ap, part, d, H, W, C, s);
  if (dtype == 1 && K == 9) return launch_sweep<double, 9>(P, r, p, beta, pn, ap, part, d, H, W, C, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
