// Kernel H of the port: a whole unpreconditioned CG solve in one launch on
// the UNPADDED 9-plane layout of krylov_spdes_tpu_torch/ops/stencil.py.
//
// H  stencil_cg  replaces krylov_spdes_tpu/ops/pallas_cg.py::_cg_kernel
//    (called by stencil_cg_pallas).
//    Inputs: planes (9, H, W) in the order self, E, W, N, S, NE, SW, SE, NW,
//    dir_diag (H, W), b (H, W), all row-major with no padding; maxit and
//    rtol are kernel arguments. The apply is
//      y = (P0 + dir_diag)·v + Σ_{k=1..8} P_k·shift_k(v),
//    dir_diag added here and not by the host, a neighbour beyond the grid
//    read as zero. x0 = 0, r = p = b, tol² = rtol²·bᵀb; the loop runs while
//    it < maxit and rᵀr > tol² with it starting at 1 (pallas_cg.py:59-77);
//    it (int32) and √(rᵀr) are written to device memory.
//
//    Design (csrc/persistent.cuh): one persistent block per SM, each owning
//    a band of 3-4 node rows at 500 × 500. A block keeps its band in shared
//    memory: P0 + dir_diag, x, r and Ap (band rows), the eight other planes
//    (loaded once), and the direction in a zero-ringed (rows + 2) × (W + 2)
//    tile, the TPU kernel's own ringed scratch, so the apply reads its nine
//    neighbours with no masks. An iteration:
//      1. pn = r + β·p on the band (in place in the tile) and on its two
//         halo rows (from the neighbours' published rows of r and p), then
//         Ap and the block's partial of pnᵀAp; all-gather barrier → α.
//      2. x += α·pn, r −= α·Ap, the block's partial of rᵀr; the band's
//         first and last rows of r and pn to the global halo slots;
//         all-gather barrier → rᵀr, β, the stop test.
//    Two barriers an iteration is the floor of this recurrence. A halo slot
//    is written only after barrier 1 and read only before the next barrier
//    1, so one slot a row suffices (the slots are the rows of rg and pg,
//    (H, W) buffers of which only band edges are used).
//    The values are the TPU kernel's step by step: the same products and
//    sums in the same order (--fmad=false); the reductions have another
//    fixed order (a thread's nodes, the warp butterfly, the warps in order,
//    then the blocks), so a solve repeats bit for bit.
//
//    Residency: where the band's vectors or the eight planes do not fit in
//    shared memory beside each other (1000 × 1000 and up), the same code
//    reads them from global memory: the planes straight from the input, the
//    vectors from a per-block scratch area. The wrapper
//    (ops/pallas_cg.py, ops/persistent.py::stencil_cg_plan) decides it from
//    the device's shared memory; there is no size limit and no other path.
//
//    What bounds it: latency. With the operator in shared memory an
//    iteration's work is ~2000 nodes a block from shared memory; what is
//    left is the two barriers. Both are packed all-gathers: a block's
//    partial travels with its epoch in one 64-bit release store, and every
//    block's acquire loads of all blocks' words are the wait and the data in
//    one pass through the L2 (1.56 µs a barrier at 132 blocks on an H100,
//    against 4.26 µs for flag, fence and data:
//    krylov_spdes_tpu_torch/bench/barrier_bench.cu). The halo loads of
//    step 1 are issued before the band's update, which hides their latency.
//
// The library is built with --fmad=false so that every product and sum
// rounds on its own, as the plain PyTorch version's elementwise ops do.

#include <cuda_runtime.h>

#include "persistent.cuh"

namespace {

// Elements of T a block's vector area holds: P0 + dir_diag, x, r, Ap over
// nrmax rows, and the ringed direction tile.
__host__ __device__ inline long vec_elems(int nrmax, int W) {
  return 4L * nrmax * W + static_cast<long>(nrmax + 2) * (W + 2);
}

__host__ __device__ inline long plane_elems(int nrmax, int W) {
  return 8L * nrmax * W;
}

template <typename T>
__global__ void __launch_bounds__(kPThreads, 1)
stencil_cg_kernel(const T* __restrict__ P, const T* __restrict__ dd,
                  const T* __restrict__ b, T* __restrict__ x, T* rg, T* pg,
                  unsigned int* sync, T* scratch, int* it_out,
                  T* res_out, int H, int W, int nrmax, int vres, int pres,
                  int maxit, T rtol2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kPWarps];
  __shared__ T sum[1];
  __shared__ unsigned int sh32[kMaxBlocks * sizeof(T) / 4];
  int r0, nr;
  band_of(blockIdx.x, gridDim.x, H, &r0, &nr);
  const int TW = W + 2;
  const long n = static_cast<long>(H) * W;
  const long band = static_cast<long>(nrmax) * W;
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* vec = vres ? sm : scratch + blockIdx.x * vec_elems(nrmax, W);
  T* d0 = vec;
  T* xs = vec + band;
  T* rs = vec + 2 * band;
  T* aps = vec + 3 * band;
  T* tile = vec + 4 * band;
  // planes 1..8 of the band: plane k at pl + (k − 1)·pstride, node (i, j)
  // of the band at i·W + j, in shared memory or in the input itself
  const T* pl;
  long pstride;
  if (pres) {
    T* ps = sm + (vres ? vec_elems(nrmax, W) : 0);
    for (int k = 0; k < 8; ++k)
      for (int i = 0; i < nr; ++i)
        for (int j = threadIdx.x; j < W; j += kPThreads)
          ps[k * band + i * W + j] = P[(k + 1) * n + (r0 + i) * static_cast<long>(W) + j];
    pl = ps;
    pstride = band;
  } else {
    pl = P + n + static_cast<long>(r0) * W;
    pstride = n;
  }
  const T* P1 = pl;
  const T* P2 = pl + pstride;
  const T* P3 = pl + 2 * pstride;
  const T* P4 = pl + 3 * pstride;
  const T* P5 = pl + 4 * pstride;
  const T* P6 = pl + 5 * pstride;
  const T* P7 = pl + 6 * pstride;
  const T* P8 = pl + 7 * pstride;

  for (long t = threadIdx.x; t < static_cast<long>(nrmax + 2) * TW; t += kPThreads)
    tile[t] = T(0);
  T lr = T(0);
  for (int i = 0; i < nr; ++i) {
    for (int j = threadIdx.x; j < W; j += kPThreads) {
      const long g = (r0 + i) * static_cast<long>(W) + j;
      const long l = i * static_cast<long>(W) + j;
      d0[l] = P[g] + dd[g];
      const T bv = b[g];
      rs[l] = bv;
      xs[l] = T(0);
      lr += bv * bv;
      if (i == 0 || i == nr - 1) {  // halo slots: r = b, p = 0
        rg[g] = bv;
        pg[g] = T(0);
      }
    }
  }
  // every all-gather here is packed: one value a block
  Barrier<T> bar(sync, nullptr, 0);
  T v[1] = {lr};
  block_totals(v, red);
  bar.all_values(v, sum, sh32, true);  // and the halo slots r = b, p = 0
  T rTr = sum[0];
  const T tol2 = rtol2 * rTr;
  T beta = T(0);
  int it = 1;
  const bool above = r0 > 0, below = r0 + nr < H;
  while (it < maxit && rTr > tol2) {
    // 1. pn = r + β·p on the band and its halo rows (the halo loads issued
    //    first, so that the band's update hides their latency), then Ap
    //    and pnᵀAp
    for (int j = threadIdx.x; j < W; j += kPThreads) {
      T ra = T(0), pa = T(0), rb = T(0), pb = T(0);
      if (above) {
        const long g = (r0 - 1) * static_cast<long>(W) + j;
        ra = __ldcg(rg + g);
        pa = __ldcg(pg + g);
      }
      if (below) {
        const long g = (r0 + nr) * static_cast<long>(W) + j;
        rb = __ldcg(rg + g);
        pb = __ldcg(pg + g);
      }
      for (int i = 0; i < nr; ++i) {
        const long t = (i + 1) * static_cast<long>(TW) + j + 1;
        tile[t] = rs[i * static_cast<long>(W) + j] + beta * tile[t];
      }
      if (above) tile[j + 1] = ra + beta * pa;
      if (below) tile[(nr + 1) * static_cast<long>(TW) + j + 1] = rb + beta * pb;
    }
    __syncthreads();
    T ld = T(0);
    for (int i = 0; i < nr; ++i) {
      for (int j = threadIdx.x; j < W; j += kPThreads) {
        const long l = i * static_cast<long>(W) + j;
        const long t = (i + 1) * static_cast<long>(TW) + j + 1;
        const T v0 = tile[t];
        T y = d0[l] * v0;
        y = y + P1[l] * tile[t + 1];        // E  (0, +1)
        y = y + P2[l] * tile[t - 1];        // W  (0, −1)
        y = y + P3[l] * tile[t + TW];       // N  (+1, 0)
        y = y + P4[l] * tile[t - TW];       // S  (−1, 0)
        y = y + P5[l] * tile[t + TW + 1];   // NE (+1, +1)
        y = y + P6[l] * tile[t - TW - 1];   // SW (−1, −1)
        y = y + P7[l] * tile[t + TW - 1];   // SE (+1, −1)
        y = y + P8[l] * tile[t - TW + 1];   // NW (−1, +1)
        aps[l] = y;
        ld += v0 * y;
      }
    }
    v[0] = ld;
    block_totals(v, red);
    bar.all_values(v, sum, sh32, false);
    const T alpha = rTr / sum[0];

    // 2. x += α·pn, r −= α·Ap, rᵀr; the band's edge rows to the halo slots
    lr = T(0);
    for (int i = 0; i < nr; ++i) {
      for (int j = threadIdx.x; j < W; j += kPThreads) {
        const long l = i * static_cast<long>(W) + j;
        const T pn = tile[(i + 1) * static_cast<long>(TW) + j + 1];
        xs[l] = xs[l] + alpha * pn;
        const T rn = rs[l] - alpha * aps[l];
        rs[l] = rn;
        lr += rn * rn;
        if (i == 0 || i == nr - 1) {
          const long g = (r0 + i) * static_cast<long>(W) + j;
          rg[g] = rn;
          pg[g] = pn;
        }
      }
    }
    v[0] = lr;
    block_totals(v, red);
    bar.all_values(v, sum, sh32, true);  // and the halo slots just written
    const T rTr_new = sum[0];
    beta = rTr_new / rTr;
    rTr = rTr_new;
    ++it;
  }
  for (int i = 0; i < nr; ++i)
    for (int j = threadIdx.x; j < W; j += kPThreads)
      x[(r0 + i) * static_cast<long>(W) + j] = xs[i * static_cast<long>(W) + j];
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *it_out = it;
    *res_out = sqrt(rTr);
  }
}

const void* pick(int dtype) {
  if (dtype == 0) return reinterpret_cast<const void*>(&stencil_cg_kernel<float>);
  if (dtype == 1) return reinterpret_cast<const void*>(&stencil_cg_kernel<double>);
  return nullptr;
}

}  // namespace

extern "C" {

// The device's limits for the solve: out[0] = SM count, out[1] = the most
// dynamic shared memory a block of the kernel can ask for (the opt-in
// maximum less the kernel's static shared memory). Returns a cudaError_t.
int stencil_cg_limits(int dtype, int* out) {
  const void* fn = pick(dtype);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(persistent_limits(fn, out));
}

// H. dtype: 0 = float32, 1 = float64. x, rg, pg: (H, W) buffers the caller
// allocates; sync: sync_words(grid) zeroed 32-bit words;
// scratch: grid × vec_elems values when vres = 0; it: one int32, res one
// value. grid, nrmax = ⌈H / grid⌉, vres, pres and smem come from
// ops/persistent.py::stencil_cg_plan; smem must be the bytes that layout
// needs. rtol2 = rtol², rounded to the working type. Returns a cudaError_t:
// cudaErrorCooperativeLaunchTooLarge if the grid is not resident at once.
int stencil_cg(int dtype, const void* P, const void* dd, const void* b,
               void* x, void* rg, void* pg, void* sync, void* scratch, void* it, void* res, int H, int W, int maxit,
               double rtol2, int grid, int nrmax, int vres, int pres,
               int smem, void* stream) {
  const void* fn = pick(dtype);
  const long esize = dtype == 0 ? 4 : 8;
  const long need = esize * ((vres ? vec_elems(nrmax, W) : 0)
                             + (pres ? plane_elems(nrmax, W) : 0));
  if (fn == nullptr || grid < 1 || grid > H || grid > kMaxBlocks
      || nrmax != (H + grid - 1) / grid
      || smem != need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  float rtol2f = static_cast<float>(rtol2);
  void* tol_arg = dtype == 0 ? static_cast<void*>(&rtol2f) : static_cast<void*>(&rtol2);
  void* args[] = {&P, &dd, &b, &x, &rg, &pg, &sync, &scratch, &it,
                  &res, &H, &W, &nrmax, &vres, &pres, &maxit, tol_arg};
  return static_cast<int>(launch_persistent(fn, grid, smem, args, stream));
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
