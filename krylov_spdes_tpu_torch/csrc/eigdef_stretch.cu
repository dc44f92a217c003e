// Kernel E of the port: one restart-free stretch of eigDef-PCG on the padded
// layout of krylov_spdes_tpu_torch/ops/fused_cg.py (see csrc/fused_cg.cu).
//
// E  eigdef_stretch  replaces
//    krylov_spdes_tpu/ops/vmem_eigdef.py::_stretch_kernel.
//    Up to nsteps iterations in one persistent cooperative launch, each:
//      ap = A·p, α = rᵀz / pᵀap, x += α·p, r −= α·ap,
//      U = G·r (2·nvec grid sums), r −= Σ_{k<nvec} U_k·A1_k   (reorth),
//      z = minv ⊙ r, β = rᵀz_new / rᵀz,
//      p = β·p + z − Σ_{k<2nvec} U_k·B_k                      (deflation),
//      V[ivec0 + i + 1] = z / √(rᵀz_new), and α, β, ‖r‖² to device memory.
//    The loop runs while i < nsteps and ‖r‖² > tol², ‖r‖² starting at
//    res2_prev. x, r, p are updated in place; of V only the appended
//    columns are written.
//
//    What bounds it: bytes. Every iteration reads G, A1 and B once
//    (5·nvec grids) beside the K planes and a dozen vector passes; at
//    250k nodes, nvec = 16, float32 that is about 107 MB an iteration, more
//    than the 50 MB L2, so the operands stream from HBM: about 32 µs an
//    iteration at 3.35 TB/s. With about two nodes a thread the loads have
//    to be in flight together to come near that rate: the rows of G are
//    taken kRows at a time with kRows accumulators a thread, and the row
//    loops over A1 and B are unrolled by kRows (the sums keep their order).
//    On top come four grid-wide barriers an iteration (after the partials
//    of pᵀap, of U, of rᵀr and rᵀz, and after p is written): the direction
//    needs 2·nvec rows of B a node and cannot be recomputed at the 9
//    neighbours as kernels B-D recompute z + β·p, so p is stored and a
//    barrier separates its write from the next apply.
//
//    Reductions have a fixed order and use no float atomics, so a stretch
//    repeats bit for bit. The three scalars are summed by every block from
//    the per-block partials, as in kernels C and D. The 2·nvec sums of U
//    are summed once: each block adds one to a counter after writing its
//    partials (with a fence), and the block that arrives last sums all
//    partials in a fixed order and writes U before it joins the barrier;
//    every block then reads the 2·nvec results.
//
// The library is built with --fmad=false so that every product and sum
// rounds on its own, as the plain PyTorch version's elementwise ops do.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace cgr = cooperative_groups;

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kMaxU = 64;  // 2·nvec at most
constexpr int kRows = 8;   // rows of G, A1, B loaded together

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
stretch_kernel(const T* __restrict__ P, const T* __restrict__ minv,
               const T* __restrict__ G, const T* __restrict__ A1,
               const T* __restrict__ B, T* x, T* r, T* p, T* V, T* ap,
               T* accp, T* part, T* U, unsigned int* counter,
               const T* __restrict__ tol2p, const T* __restrict__ rTz0p,
               const T* __restrict__ res2p, T* alphas, T* betas, T* res2s,
               int* info, T* rTz_out, int H, int W, int C, int nvec,
               int nsteps, int ivec0) {
  cgr::grid_group grid = cgr::this_grid();
  __shared__ T sh[kThreads];
  __shared__ T shw[kWarps * kMaxU];
  __shared__ T shU[kMaxU];
  __shared__ bool is_last;
  const long n = static_cast<long>(H) * W;
  const long plane = static_cast<long>(H + 2 * kRow0) * C;
  const long first = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * kThreads;
  const int NB = gridDim.x;
  const int nu = 2 * nvec;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T* part_d = part;
  T* part_r = part + NB;
  T* part_z = part + 2 * NB;
  T* part_u = part + 3 * NB;  // [k][block]
  const T tol2 = *tol2p;
  T rTz = *rTz0p;
  T res2 = *res2p;
  int i = 0;

  while (i < nsteps && res2 > tol2) {
    // 1. ap = A·p, partial pᵀap
    T ld = T(0);
    for (long t = first; t < n; t += stride) {
      const long q = node_index(t, W, C);
      const T v0 = p[q];
      const T y = apply_vals<T, K>(P, plane, q, C, v0, p[q + 1], p[q - 1],
                                   p[q + C], p[q - C], p[q + C + 1],
                                   p[q - C - 1], p[q + C - 1], p[q - C + 1]);
      ap[q] = y;
      ld += v0 * y;
    }
    T s = block_sum(ld, sh);
    if (threadIdx.x == 0) part_d[blockIdx.x] = s;
    grid.sync();
    const T alpha = rTz / sum_partials(part_d, NB, sh);

    // 2. x += α·p, r −= α·ap, then the block's partials of U = G·r
    for (long t = first; t < n; t += stride) {
      const long q = node_index(t, W, C);
      x[q] = x[q] + alpha * p[q];
      r[q] = r[q] - alpha * ap[q];
    }
    // kRows rows of G at a time, so that a node's loads are in flight
    // together; each row's sum keeps its order (this thread's nodes, then
    // the warp, then the warps in order)
    for (int k0 = 0; k0 < nu; k0 += kRows) {
      T acc[kRows];
#pragma unroll
      for (int j = 0; j < kRows; ++j) acc[j] = T(0);
      for (long t = first; t < n; t += stride) {
        const long q = node_index(t, W, C);
        const T rq = r[q];   // this thread's own r, written just above
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          if (k0 + j < nu) acc[j] += G[(k0 + j) * plane + q] * rq;
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const T v = warp_sum(acc[j]);
        if (lane == 0 && k0 + j < nu) shw[warp * kMaxU + k0 + j] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < nu) {
      T v = shw[threadIdx.x];
      for (int w = 1; w < kWarps; ++w) v += shw[w * kMaxU + threadIdx.x];
      part_u[static_cast<long>(threadIdx.x) * NB + blockIdx.x] = v;
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      is_last = atomicAdd(counter, 1u) == static_cast<unsigned int>(NB - 1);
    }
    __syncthreads();
    if (is_last) {
      // the last block to arrive sums every block's partials, once
      __threadfence();
      for (int k = warp; k < nu; k += kWarps) {
        const volatile T* pk = part_u + static_cast<long>(k) * NB;
        T v = T(0);
        for (int j = lane; j < NB; j += 32) v += pk[j];
        v = warp_sum(v);
        if (lane == 0) U[k] = v;
      }
      if (threadIdx.x == 0) *counter = 0u;
    }
    grid.sync();
    if (threadIdx.x < nu) shU[threadIdx.x] = U[threadIdx.x];
    __syncthreads();

    // 3. reorth r −= Σ U_k·A1_k, the deflation sum Σ U_k·B_k, partial rᵀr, rᵀz
    T lr = T(0), lz = T(0);
    for (long t = first; t < n; t += stride) {
      const long q = node_index(t, W, C);
      T ar = shU[0] * A1[q];
#pragma unroll kRows
      for (int k = 1; k < nvec; ++k) ar = ar + shU[k] * A1[k * plane + q];
      T apk = shU[0] * B[q];
#pragma unroll kRows
      for (int k = 1; k < nu; ++k) apk = apk + shU[k] * B[k * plane + q];
      const T rn = r[q] - ar;
      r[q] = rn;
      accp[q] = apk;
      lr += rn * rn;
      lz += rn * (minv[q] * rn);
    }
    s = block_sum(lr, sh);
    if (threadIdx.x == 0) part_r[blockIdx.x] = s;
    s = block_sum(lz, sh);
    if (threadIdx.x == 0) part_z[blockIdx.x] = s;
    grid.sync();
    const T rTr = sum_partials(part_r, NB, sh);
    const T rTz_new = sum_partials(part_z, NB, sh);
    const T beta = rTz_new / rTz;

    // 4. p = β·p + z − Σ U_k·B_k, and the new column of V
    const T vnorm = sqrt(rTz_new);
    T* Vcol = V + static_cast<long>(ivec0 + i + 1) * plane;
    for (long t = first; t < n; t += stride) {
      const long q = node_index(t, W, C);
      const T z = minv[q] * r[q];
      p[q] = (beta * p[q] + z) - accp[q];
      Vcol[q] = z / vnorm;
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      alphas[i] = alpha;
      betas[i] = beta;
      res2s[i] = rTr;
    }
    rTz = rTz_new;
    res2 = rTr;
    ++i;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    info[0] = i;
    info[1] = res2 > tol2 ? 1 : 0;
    *rTz_out = rTz;
  }
}

const void* pick_stretch(int dtype, int K) {
  if (dtype == 0 && K == 5) return reinterpret_cast<const void*>(&stretch_kernel<float, 5>);
  if (dtype == 0 && K == 9) return reinterpret_cast<const void*>(&stretch_kernel<float, 9>);
  if (dtype == 1 && K == 5) return reinterpret_cast<const void*>(&stretch_kernel<double, 5>);
  if (dtype == 1 && K == 9) return reinterpret_cast<const void*>(&stretch_kernel<double, 9>);
  return nullptr;
}

}  // namespace

extern "C" {

// Grid of the stretch kernel: every block resident at once (occupancy × SM
// count), and no more blocks than it takes to give each thread a node.
// Returns the block count, or minus a cudaError_t.
int eigdef_stretch_grid(int dtype, int K, int H, int W) {
  const void* fn = pick_stretch(dtype, K);
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

// E. dtype: 0 = float32, 1 = float64. G, B: (2·nvec, R, C); A1: (nvec, R, C);
// V: (spdim, R, C) with ivec0 + nsteps < spdim. ap, accp: (R, C) scratch;
// part: (2·nvec + 3)·grid values; U: 2·nvec values; counter: one zeroed
// unsigned int; alphas, betas, res2: preset by the caller; info: two ints
// (iterations run, ‖r‖² still above tol²). grid from eigdef_stretch_grid.
// Returns cudaGetLastError() after the launch.
int eigdef_stretch(int dtype, int K, const void* P, const void* minv,
                   const void* G, const void* A1, const void* B, void* x,
                   void* r, void* p, void* V, void* ap, void* accp, void* part,
                   void* U, void* counter, const void* tol2, const void* rTz,
                   const void* res2_prev, void* alphas, void* betas,
                   void* res2, void* info, void* rTz_out, int H, int W, int C,
                   int nvec, int nsteps, int ivec0, int grid, void* stream) {
  const void* fn = pick_stretch(dtype, K);
  if (fn == nullptr || grid < 1 || nvec < 1 || 2 * nvec > kMaxU) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&P, &minv, &G, &A1, &B, &x, &r, &p, &V, &ap, &accp, &part,
                  &U, &counter, &tol2, &rTz, &res2_prev, &alphas, &betas,
                  &res2, &info, &rTz_out, &H, &W, &C, &nvec, &nsteps, &ivec0};
  cudaError_t err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kThreads), args, 0,
                                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
