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
//    read as zero. That is what sets it apart from kernels C and D
//    (csrc/fused_cg.cu), whose host pads every grid with zero rows and
//    columns and folds dir_diag into plane 0: here a column j ± 1 that
//    leaves the row would land on the neighbouring row's end, so every
//    neighbour read is masked by its (i, j) bounds.
//    x0 = 0, r = p = b, tol² = rtol²·bᵀb; the loop runs while it < maxit and
//    rᵀr > tol² with it starting at 1 (pallas_cg.py:59-77); it (int32) and
//    √(rᵀr) are written to device memory, with no read-back inside the loop.
//
//    The direction is recomputed, not ringed. The TPU kernel keeps p in a
//    zero-ringed (H+2, W+2) scratch and writes p = r + β·p at the end of an
//    iteration; a grid of thread blocks would need a third grid-wide barrier
//    between that write and the next apply. Here, as in kernels B-D, the
//    apply forms pn = r + β·p at the node and at its eight neighbours from r
//    and the previous p (cache hits: the working set stays in the L2) and
//    writes the node's own pn to the other of two p buffers, which swap
//    roles every iteration. The values are the TPU kernel's bit for bit
//    (the same products and sums, --fmad=false); only the place where
//    r + β·p is evaluated differs. In the first iteration β = 0 and p = 0,
//    so pn = b.
//
//    One persistent cooperative launch, two grid-wide barriers an iteration:
//      1. pn, Ap = A·pn, block partial of pnᵀAp; barrier; every block sums
//         the partials → d, α = rᵀr / d.
//      2. x += α·pn, r −= α·Ap, block partial of rᵀr; barrier; every block
//         sums the partials → rᵀr, β, the stop test.
//    Every block sums the same partials in the same fixed order (block tree,
//    no float atomics), so all blocks hold the same α, β and stop decision
//    without a broadcast, and a solve repeats bit for bit.
//
//    What bounds it: latency, not bytes. The working set at 500 × 500
//    float32 (9 planes, dir_diag, b, x, r, two p, Ap: 16 grids, 16 MB) stays
//    in the 50 MB L2, and an iteration is two barriers and two re-reductions
//    of the block partials. W = 500 is not a multiple of 32, so rows start
//    at unaligned addresses and a warp's loads straddle two rows: that
//    costs coalescing, not correctness, and is left as it is.
//
// The library is built with --fmad=false so that every product and sum
// rounds on its own, as the plain PyTorch version's elementwise ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cgr = cooperative_groups;

namespace {

// r + β·p at node (i, j), zero beyond the grid.
template <typename T>
__device__ __forceinline__ T dir_at(const T* r, const T* p, T beta, int i,
                                    int j, int H, int W) {
  if (i < 0 || i >= H || j < 0 || j >= W) return T(0);
  const long q = static_cast<long>(i) * W + j;
  return r[q] + beta * p[q];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
stencil_cg_kernel(const T* __restrict__ P, const T* __restrict__ dd,
                  const T* __restrict__ b, T* x, T* r, T* pa, T* pb, T* ap,
                  T* part, int* it_out, T* res_out, int H, int W, int maxit,
                  T rtol2) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ T sh[kThreads];
  const long n = static_cast<long>(H) * W;
  const long first = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * kThreads;
  const int G = gridDim.x;
  T* part_d = part;
  T* part_r = part + G;

  T lr = T(0);
  for (long q = first; q < n; q += stride) {
    const T bv = b[q];
    r[q] = bv;
    x[q] = T(0);
    pa[q] = T(0);
    lr += bv * bv;
  }
  T s = block_sum(lr, sh);
  if (threadIdx.x == 0) part_r[blockIdx.x] = s;
  grid.sync();
  T rTr = sum_partials(part_r, G, sh);
  const T tol2 = rtol2 * rTr;
  T beta = T(0);
  int it = 1;
  T* pold = pa;
  T* pnew = pb;
  while (it < maxit && rTr > tol2) {
    T ld = T(0);
    for (long q = first; q < n; q += stride) {
      const int i = static_cast<int>(q / W);
      const int j = static_cast<int>(q - static_cast<long>(i) * W);
      const T v0 = r[q] + beta * pold[q];
      T y = (P[q] + dd[q]) * v0;
      y = y + P[1 * n + q] * dir_at(r, pold, beta, i, j + 1, H, W);
      y = y + P[2 * n + q] * dir_at(r, pold, beta, i, j - 1, H, W);
      y = y + P[3 * n + q] * dir_at(r, pold, beta, i + 1, j, H, W);
      y = y + P[4 * n + q] * dir_at(r, pold, beta, i - 1, j, H, W);
      y = y + P[5 * n + q] * dir_at(r, pold, beta, i + 1, j + 1, H, W);
      y = y + P[6 * n + q] * dir_at(r, pold, beta, i - 1, j - 1, H, W);
      y = y + P[7 * n + q] * dir_at(r, pold, beta, i + 1, j - 1, H, W);
      y = y + P[8 * n + q] * dir_at(r, pold, beta, i - 1, j + 1, H, W);
      pnew[q] = v0;
      ap[q] = y;
      ld += v0 * y;
    }
    s = block_sum(ld, sh);
    if (threadIdx.x == 0) part_d[blockIdx.x] = s;
    grid.sync();
    const T alpha = rTr / sum_partials(part_d, G, sh);

    lr = T(0);
    for (long q = first; q < n; q += stride) {
      x[q] = x[q] + alpha * pnew[q];
      const T rn = r[q] - alpha * ap[q];
      r[q] = rn;
      lr += rn * rn;
    }
    s = block_sum(lr, sh);
    if (threadIdx.x == 0) part_r[blockIdx.x] = s;
    grid.sync();
    const T rTr_new = sum_partials(part_r, G, sh);
    beta = rTr_new / rTr;
    rTr = rTr_new;
    ++it;
    T* tmp = pold;
    pold = pnew;
    pnew = tmp;
  }
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

// Grid of the solve: every block resident at once (occupancy × SM count),
// and no more blocks than it takes to give each thread a node. Returns the
// block count, or minus a cudaError_t.
int stencil_cg_grid(int dtype, int H, int W) {
  const void* fn = pick(dtype);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  const long need = (static_cast<long>(H) * W + kThreads - 1) / kThreads;
  const long resident = static_cast<long>(per_sm) * sms;
  return static_cast<int>(need < resident ? need : resident);
}

// H. dtype: 0 = float32, 1 = float64. x, r, pa, pb, ap are (H, W) buffers
// the caller allocates; part holds 2·grid values; it is one int32, res one
// value. rtol2 = rtol², rounded to the working type. Returns
// cudaGetLastError() after the launch.
int stencil_cg(int dtype, const void* P, const void* dd, const void* b,
               void* x, void* r, void* pa, void* pb, void* ap, void* part,
               void* it, void* res, int H, int W, int maxit, double rtol2,
               int grid, void* stream) {
  const void* fn = pick(dtype);
  if (fn == nullptr || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  float rtol2f = static_cast<float>(rtol2);
  void* tol_arg = dtype == 0 ? static_cast<void*>(&rtol2f) : static_cast<void*>(&rtol2);
  void* args[] = {&P, &dd, &b, &x, &r, &pa, &pb, &ap, &part, &it, &res,
                  &H, &W, &maxit, tol_arg};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
