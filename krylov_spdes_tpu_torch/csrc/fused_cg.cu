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
//    The whole (Jacobi-P)CG solve in one persistent cooperative launch, the
//    Hopper counterpart of the TPU solve that stayed in VMEM: the working
//    set (K + 5 grids, about 9.5 MB at 250k nodes, K = 5, float32) stays in
//    the 50 MB L2, and the iteration costs no launch. What bounds it is
//    latency: each iteration has two grid-wide barriers, and each block
//    re-reduces the block partials. Phases of one iteration:
//      1. pn = z + β·p (z = r, or minv ⊙ r for D), Ap = A·pn, partial pnᵀAp;
//         grid sync; every block sums the partials → d, α.
//      2. x += α·pn, r -= α·Ap, partial rᵀr (and rᵀz for D);
//         grid sync; every block sums the partials → rᵀr, β, stop test.
//    The direction lives in two buffers that swap roles each iteration, so
//    phase 1 reads the old p of its neighbours while it writes the new one.
//    Every block sums the partials in the same fixed order, so all blocks
//    hold the same α, β and stop decision without a broadcast. it (int32,
//    starting at 1 with the initial residual) and ‖r‖ are written to device
//    memory; the loop runs while it < maxit and rᵀr > tol², as in
//    fused_cg.py:483-485,578-580.
//
// The library is built with --fmad=false so that every product and sum
// rounds on its own, as the plain PyTorch versions' elementwise ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cgr = cooperative_groups;

namespace {

// Direction at padded index q: z + β·p with z = r (CG) or minv ⊙ r (PCG).
template <typename T, bool PCG>
__device__ __forceinline__ T dir_at(const T* r, const T* p, const T* minv,
                                    T beta, long q) {
  const T z = PCG ? minv[q] * r[q] : r[q];
  return z + beta * p[q];
}

// (A·pn)[q] with pn = dir_at(...) recomputed at each of the 9 neighbours;
// the node's own pn is returned through pn_self.
template <typename T, int K, bool PCG>
__device__ __forceinline__ T apply_dir(const T* __restrict__ P, long plane,
                                       const T* r, const T* p, const T* minv,
                                       T beta, long q, int C, T& pn_self) {
  const T v0 = dir_at<T, PCG>(r, p, minv, beta, q);
  const T vE = dir_at<T, PCG>(r, p, minv, beta, q + 1);
  const T vW = dir_at<T, PCG>(r, p, minv, beta, q - 1);
  const T vN = dir_at<T, PCG>(r, p, minv, beta, q + C);
  const T vS = dir_at<T, PCG>(r, p, minv, beta, q - C);
  const T vNE = dir_at<T, PCG>(r, p, minv, beta, q + C + 1);
  const T vSW = dir_at<T, PCG>(r, p, minv, beta, q - C - 1);
  const T vSE = dir_at<T, PCG>(r, p, minv, beta, q + C - 1);
  const T vNW = dir_at<T, PCG>(r, p, minv, beta, q - C + 1);
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
    const T y = apply_dir<T, K, false>(P, plane, r, p, nullptr, *betap, q, C, pn);
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

// ---- C / D: the whole solve in one cooperative launch ----------------------

// Buffers the caller allocates: x, r, pa, pb, ap are (R, C) grids whose pad
// rows and columns are zero; part holds 3·gridDim.x values.
template <typename T, int K, bool PCG>
__global__ void __launch_bounds__(kThreads)
whole_cg_kernel(const T* __restrict__ P, const T* __restrict__ minv,
                const T* __restrict__ b, const T* __restrict__ tol2p, T* x,
                T* r, T* pa, T* pb, T* ap, T* part, int* it_out, T* res_out,
                int H, int W, int C, int maxit) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ T sh[kThreads];
  const long n = static_cast<long>(H) * W;
  const long plane = static_cast<long>(H + 2 * kRow0) * C;
  const long first = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * kThreads;
  const int G = gridDim.x;
  T* part_d = part;
  T* part_r = part + G;
  T* part_z = part + 2 * G;
  const T tol2 = *tol2p;

  T lr = T(0), lz = T(0);
  for (long t = first; t < n; t += stride) {
    const long q = node_index(t, W, C);
    const T bv = b[q];
    r[q] = bv;
    x[q] = T(0);
    pa[q] = T(0);
    lr += bv * bv;
    if (PCG) lz += bv * (minv[q] * bv);
  }
  T s = block_sum(lr, sh);
  if (threadIdx.x == 0) part_r[blockIdx.x] = s;
  if (PCG) {
    s = block_sum(lz, sh);
    if (threadIdx.x == 0) part_z[blockIdx.x] = s;
  }
  grid.sync();
  T rTr = sum_partials(part_r, G, sh);
  T rTz = PCG ? sum_partials(part_z, G, sh) : T(0);
  T beta = T(0);
  int it = 1;
  T* pold = pa;
  T* pnew = pb;
  while (it < maxit && rTr > tol2) {
    T ld = T(0);
    for (long t = first; t < n; t += stride) {
      const long q = node_index(t, W, C);
      T pn;
      const T y = apply_dir<T, K, PCG>(P, plane, r, pold, minv, beta, q, C, pn);
      pnew[q] = pn;
      ap[q] = y;
      ld += pn * y;
    }
    s = block_sum(ld, sh);
    if (threadIdx.x == 0) part_d[blockIdx.x] = s;
    grid.sync();
    const T d = sum_partials(part_d, G, sh);
    const T alpha = (PCG ? rTz : rTr) / d;

    lr = T(0);
    lz = T(0);
    for (long t = first; t < n; t += stride) {
      const long q = node_index(t, W, C);
      x[q] = x[q] + alpha * pnew[q];
      const T rn = r[q] - alpha * ap[q];
      r[q] = rn;
      lr += rn * rn;
      if (PCG) lz += rn * (minv[q] * rn);
    }
    s = block_sum(lr, sh);
    if (threadIdx.x == 0) part_r[blockIdx.x] = s;
    if (PCG) {
      s = block_sum(lz, sh);
      if (threadIdx.x == 0) part_z[blockIdx.x] = s;
    }
    grid.sync();
    const T rTr_new = sum_partials(part_r, G, sh);
    if (PCG) {
      const T rTz_new = sum_partials(part_z, G, sh);
      beta = rTz_new / rTz;
      rTz = rTz_new;
    } else {
      beta = rTr_new / rTr;
    }
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

// Grid of the whole-solve kernel: every block resident at once (occupancy ×
// SM count), and no more blocks than it takes to give each thread a node.
// Returns the block count, or minus a cudaError_t.
int whole_cg_grid(int dtype, int K, int pcg, int H, int W) {
  const void* fn = pick_whole(dtype, K, pcg);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, 0);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (per_sm < 1) return -static_cast<int>(cudaErrorLaunchOutOfResources);
  const int need = sweep_blocks(H, W);
  const int resident = per_sm * sms;
  return need < resident ? need : resident;
}

// C (pcg = 0, minv unused) and D (pcg = 1). grid from whole_cg_grid; part
// holds 3·grid values. Returns cudaGetLastError() after the launch.
int whole_cg(int dtype, int K, int pcg, const void* P, const void* minv,
             const void* b, const void* tol2, void* x, void* r, void* pa,
             void* pb, void* ap, void* part, void* it, void* res, int H, int W,
             int C, int maxit, int grid, void* stream) {
  const void* fn = pick_whole(dtype, K, pcg);
  if (fn == nullptr || grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&P, &minv, &b, &tol2, &x, &r, &pa, &pb, &ap, &part, &it,
                  &res, &H, &W, &C, &maxit};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
