// Kernels F and G of the port: the deflation projections of the batched
// recycler (krylov_spdes_tpu_torch/ops/batched_proj.py).
//
// F  gemv_rows     replaces krylov_spdes_tpu/ops/batched_proj.py::_gemv_kernel.
//    U[b, k] = Σ_n G[b, k, n]·r[b, n] for G (B, K, n), r (B, n), any n.
//    Bound by bytes: one pass over G, B·K·n values (128 MB at B = 4,
//    K = 32, n = 250k in float32, about 38 µs at 3.35 TB/s). Block
//    (chunk, b) holds kChunk entries of r[b] in registers and streams the K
//    rows of G over them, neighbouring threads on neighbouring addresses;
//    each row's chunk sum is reduced in a fixed order (warp butterfly, then
//    the warps in order) into part[b, k, chunk], and a second launch sums
//    the chunks of every (b, k) in a fixed order. No float atomics: the
//    result repeats from run to run.
//
// G  fused_reorth  replaces krylov_spdes_tpu/ops/batched_proj.py::_reorth_kernel.
//    One pass over the first nvec rows of each chain's G (= Wᵀ):
//      t0 = Σ_k C[b, k]·G[b, k, :],  t1 = Σ_k C[b, nvec + k]·G[b, k, :],
//      r' = r − t0,  z = m ⊙ r',  and the sums r'ᵀr', r'ᵀz per chain.
//    Bound by bytes: B·nvec·n values of G, two vectors in, three out (about
//    84 MB at B = 4, nvec = 16, n = 250k, float32: 25 µs). One thread an
//    entry (b, j): the two combinations accumulate in registers in the order
//    k = 0, 1, ..., as the plain version does, so r', z and t1 are bit-equal
//    to it; the two sums use the same two-launch fixed-order reduction.
//
// The library is built with --fmad=false so that every product and sum
// rounds on its own, as the plain PyTorch versions' elementwise ops do.

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                    // entries of r a thread holds
constexpr int kChunk = kThreads * kPer;    // entries of n a block covers
constexpr int kTile = 64;                  // rows of G reduced per pass

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemv_rows_kernel(const T* __restrict__ G, const T* __restrict__ r,
                 T* __restrict__ part, int K, long n, int nchunk) {
  __shared__ T shw[kWarps * kTile];
  const int b = blockIdx.y;
  const int chunk = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long base = static_cast<long>(chunk) * kChunk + threadIdx.x;
  T rv[kPer];
  for (int j = 0; j < kPer; ++j) {
    const long idx = base + static_cast<long>(j) * kThreads;
    rv[j] = idx < n ? r[b * n + idx] : T(0);
  }
  for (int k0 = 0; k0 < K; k0 += kTile) {
    const int kn = K - k0 < kTile ? K - k0 : kTile;
    for (int k = 0; k < kn; ++k) {
      const T* Gk = G + (static_cast<long>(b) * K + k0 + k) * n;
      T v = T(0);
      for (int j = 0; j < kPer; ++j) {
        const long idx = base + static_cast<long>(j) * kThreads;
        if (idx < n) v += Gk[idx] * rv[j];
      }
      v = warp_sum(v);
      if (lane == 0) shw[warp * kTile + k] = v;
    }
    __syncthreads();
    if (threadIdx.x < kn) {
      T v = shw[threadIdx.x];
      for (int w = 1; w < kWarps; ++w) v += shw[w * kTile + threadIdx.x];
      part[(static_cast<long>(b) * K + k0 + threadIdx.x) * nchunk + chunk] = v;
    }
    __syncthreads();
  }
}

// out[i] = Σ_j part[i, j], one block a row, in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_sum_kernel(const T* __restrict__ part, int ncol, T* __restrict__ out) {
  __shared__ T sh[kThreads];
  const T s = sum_partials(part + static_cast<long>(blockIdx.x) * ncol, ncol, sh);
  if (threadIdx.x == 0) out[blockIdx.x] = s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_reorth_kernel(const T* __restrict__ G, const T* __restrict__ Cc,
                    const T* __restrict__ r, const T* __restrict__ m,
                    T* __restrict__ rp, T* __restrict__ z, T* __restrict__ t1,
                    T* __restrict__ part, int K, int nvec, long n, int nblk) {
  __shared__ T sh[kThreads];
  const int b = blockIdx.y;
  const long j = static_cast<long>(blockIdx.x) * kThreads + threadIdx.x;
  const T* c = Cc + static_cast<long>(b) * 2 * nvec;
  T lr = T(0), lz = T(0);
  if (j < n) {
    const T* Gb = G + static_cast<long>(b) * K * n + j;
    const T g0 = Gb[0];
    T a0 = c[0] * g0;
    T a1 = c[nvec] * g0;
    for (int k = 1; k < nvec; ++k) {
      const T g = Gb[k * n];
      a0 = a0 + c[k] * g;
      a1 = a1 + c[nvec + k] * g;
    }
    const long o = b * n + j;
    const T rn = r[o] - a0;
    const T zn = m[o] * rn;
    rp[o] = rn;
    z[o] = zn;
    t1[o] = a1;
    lr = rn * rn;
    lz = rn * zn;
  }
  T s = block_sum(lr, sh);
  if (threadIdx.x == 0) part[static_cast<long>(b) * nblk + blockIdx.x] = s;
  s = block_sum(lz, sh);
  if (threadIdx.x == 0) {
    part[(static_cast<long>(gridDim.y) + b) * nblk + blockIdx.x] = s;
  }
}

template <typename T>
int launch_gemv(const void* G, const void* r, void* part, void* U, int B, int K,
                long n, cudaStream_t stream) {
  const int nchunk = static_cast<int>((n + kChunk - 1) / kChunk);
  gemv_rows_kernel<T><<<dim3(nchunk, B), kThreads, 0, stream>>>(
      static_cast<const T*>(G), static_cast<const T*>(r), static_cast<T*>(part),
      K, n, nchunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_sum_kernel<T><<<B * K, kThreads, 0, stream>>>(
      static_cast<const T*>(part), nchunk, static_cast<T*>(U));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reorth(const void* G, const void* C, const void* r, const void* m,
                  void* rp, void* z, void* t1, void* part, void* sums, int B,
                  int K, int nvec, long n, cudaStream_t stream) {
  const int nblk = static_cast<int>((n + kThreads - 1) / kThreads);
  fused_reorth_kernel<T><<<dim3(nblk, B), kThreads, 0, stream>>>(
      static_cast<const T*>(G), static_cast<const T*>(C),
      static_cast<const T*>(r), static_cast<const T*>(m), static_cast<T*>(rp),
      static_cast<T*>(z), static_cast<T*>(t1), static_cast<T*>(part), K, nvec,
      n, nblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  row_sum_kernel<T><<<2 * B, kThreads, 0, stream>>>(
      static_cast<const T*>(part), nblk, static_cast<T*>(sums));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Partial sums one gemv_rows call needs for each (b, k).
int gemv_rows_chunks(long n) { return static_cast<int>((n + kChunk - 1) / kChunk); }

// F. dtype: 0 = float32, 1 = float64. G (B, K, n), r (B, n), part
// (B·K·gemv_rows_chunks(n)), U (B, K). Returns cudaGetLastError().
int gemv_rows(int dtype, const void* G, const void* r, void* part, void* U,
              int B, int K, long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || K < 1 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return launch_gemv<float>(G, r, part, U, B, K, n, s);
  if (dtype == 1) return launch_gemv<double>(G, r, part, U, B, K, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Partial sums one fused_reorth call needs for each chain and sum.
int fused_reorth_blocks(long n) { return static_cast<int>((n + kThreads - 1) / kThreads); }

// G. G (B, K >= nvec, n), C (B, 2·nvec), r, m (B, n) -> rp, z, t1 (B, n) and
// sums (2, B) = [r'ᵀr' ; r'ᵀz]; part holds 2·B·fused_reorth_blocks(n) values.
int fused_reorth(int dtype, const void* G, const void* C, const void* r,
                 const void* m, void* rp, void* z, void* t1, void* part,
                 void* sums, int B, int K, int nvec, long n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || B > 65535 || nvec < 1 || K < nvec || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return launch_reorth<float>(G, C, r, m, rp, z, t1, part, sums, B, K, nvec, n, s);
  if (dtype == 1) return launch_reorth<double>(G, C, r, m, rp, z, t1, part, sums, B, K, nvec, n, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
