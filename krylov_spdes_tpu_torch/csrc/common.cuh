// Shared device helpers of the port's kernels on the padded layout of
// krylov_spdes_tpu_torch/ops/fused_cg.py (see csrc/fused_cg.cu for the
// layout): the 9-point apply from neighbour values and the fixed-order
// block and grid reductions.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow0 = 2;  // zero rows above the first node row

// (A·v)[q] from the node's own and its 8 neighbours' values. Sum order
// follows krylov_spdes_tpu/ops/fused_cg.py::_apply_full.
template <typename T, int K>
__device__ __forceinline__ T apply_vals(const T* __restrict__ P, long plane,
                                        long q, int C, T v0, T vE, T vW, T vN,
                                        T vS, T vNE, T vSW, T vSE, T vNW) {
  T y;
  if constexpr (K == 9) {
    y = P[q] * v0;
    y = y + P[1 * plane + q] * vE;
    y = y + P[2 * plane + q] * vW;
    y = y + P[3 * plane + q] * vN;
    y = y + P[4 * plane + q] * vS;
    y = y + P[5 * plane + q] * vNE;
    y = y + P[6 * plane + q] * vSW;
    y = y + P[7 * plane + q] * vSE;
    y = y + P[8 * plane + q] * vNW;
  } else {
    const T* D = P;
    const T* E = P + plane;
    const T* N = P + 2 * plane;
    const T* NE = P + 3 * plane;
    const T* SE = P + 4 * plane;
    y = D[q] * v0;
    y = y + E[q] * vE;
    y = y + E[q - 1] * vW;
    y = y + N[q] * vN;
    y = y + N[q - C] * vS;
    y = y + NE[q] * vNE;
    y = y + NE[q - C - 1] * vSW;
    y = y + SE[q] * vSE;
    y = y + SE[q - C + 1] * vNW;
  }
  return y;
}

// Sum over the block in a fixed tree order; every thread gets the result.
template <typename T>
__device__ T block_sum(T v, T* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const T out = sh[0];
  __syncthreads();
  return out;
}

// Sum of part[0..G) in a fixed order: the same value in every block.
template <typename T>
__device__ T sum_partials(const T* part, int G, T* sh) {
  T v = T(0);
  for (int k = threadIdx.x; k < G; k += kThreads) v += part[k];
  return block_sum(v, sh);
}

// Sum over the warp in a fixed butterfly order; every lane gets the result.
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

}  // namespace
