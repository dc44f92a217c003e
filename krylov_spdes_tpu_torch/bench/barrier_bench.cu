// Cost of one grid-wide all-gather of a float (every block contributes a
// value, every block ends with the same fixed-order sum) on a persistent
// cooperative grid of 512-thread blocks, in the variants that the
// barriers of csrc/persistent.cuh were chosen from:
//   1  flag + data: partial to global memory, __syncthreads, __threadfence
//      and st.release of an epoch flag; acquire loads on every block's flag,
//      __threadfence in every thread, then the partials read from the L2
//   2  the same without the two __threadfence
//   3  packed: value and epoch in one 64-bit st.release; acquire loads of
//      every block's word are the wait and the data (stride 1: adjacent)
//   4  packed, each block's word on its own 128-byte line (stride 16)
//   5  packed with relaxed polling and one fence.acq_rel after it
//   6  cooperative_groups grid.sync() + the partials read from the L2
// Build and run on the card:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//        -o barrier_bench krylov_spdes_tpu_torch/bench/barrier_bench.cu && ./barrier_bench
#include <cooperative_groups.h>
#include <cstdio>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
constexpr int NT = 512;
__device__ __forceinline__ void st_rel32(unsigned* p, unsigned v) { asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory"); }
__device__ __forceinline__ unsigned ld_acq32(const unsigned* p) { unsigned v; asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory"); return v; }
__device__ __forceinline__ void st_rel64(unsigned long long* p, unsigned long long v) { asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory"); }
__device__ __forceinline__ unsigned long long ld_acq64(const unsigned long long* p) { unsigned long long v; asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory"); return v; }
__device__ __forceinline__ unsigned long long ld_rlx64(const unsigned long long* p) { unsigned long long v; asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory"); return v; }
__device__ __forceinline__ float wsum(float v) { for (int s = 16; s; s >>= 1) v += __shfl_xor_sync(~0u, v, s); return v; }

template <int V>
__global__ void __launch_bounds__(NT, 1) bench(unsigned* flags, float* part, unsigned long long* slots, int nit, float* out, int stride) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float sh[256];
  __shared__ float cell;
  const int nb = gridDim.x;
  float acc = 0;
  unsigned epoch = 0;
  for (int it = 0; it < nit; ++it) {
    const float v = (float)((blockIdx.x * 7 + it) % 13);
    ++epoch;
    const int par = epoch & 1;
    if (V == 1 || V == 2) {
      if (threadIdx.x == 0) part[par * nb + blockIdx.x] = v;
      __syncthreads();
      if (threadIdx.x == 0) { if (V == 1) __threadfence(); st_rel32(flags + blockIdx.x, epoch); }
      for (int j = threadIdx.x; j < nb; j += NT) while (ld_acq32(flags + j) < epoch) {}
      if (V == 1) __threadfence();
      __syncthreads();
      if (threadIdx.x < 32) { float s = 0; for (int j = threadIdx.x; j < nb; j += 32) s += __ldcg(part + par * nb + j); s = wsum(s); if (threadIdx.x == 0) cell = s; }
      __syncthreads();
    } else if (V == 3 || V == 4 || V == 5) {
      unsigned long long* sl = slots + (size_t)par * nb * stride;
      __syncthreads();
      if (threadIdx.x == 0) st_rel64(sl + (size_t)blockIdx.x * stride, ((unsigned long long)epoch << 32) | __float_as_uint(v));
      if (threadIdx.x < nb) {
        const unsigned long long* q = sl + (size_t)threadIdx.x * stride;
        unsigned long long w;
        if (V == 5) { do { w = ld_rlx64(q); } while ((unsigned)(w >> 32) < epoch); asm volatile("fence.acq_rel.gpu;" ::: "memory"); }
        else { do { w = ld_acq64(q); } while ((unsigned)(w >> 32) < epoch); }
        sh[threadIdx.x] = __uint_as_float((unsigned)w);
      }
      __syncthreads();
      if (threadIdx.x < 32) { float s = 0; for (int j = threadIdx.x; j < nb; j += 32) s += sh[j]; s = wsum(s); if (threadIdx.x == 0) cell = s; }
      __syncthreads();
    } else if (V == 6) {
      if (threadIdx.x == 0) part[par * nb + blockIdx.x] = v;
      grid.sync();
      if (threadIdx.x < 32) { float s = 0; for (int j = threadIdx.x; j < nb; j += 32) s += __ldcg(part + par * nb + j); s = wsum(s); if (threadIdx.x == 0) cell = s; }
      __syncthreads();
    }
    acc += cell;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <int V> float run(int nb, int nit, int stride) {
  unsigned* flags; float* part; unsigned long long* slots; float* out;
  cudaMalloc(&flags, 4 * nb); cudaMalloc(&part, 8 * nb); cudaMalloc(&slots, 16 * nb * stride * 8); cudaMalloc(&out, 4 * nb);
  cudaMemset(flags, 0, 4 * nb); cudaMemset(slots, 0, 16 * nb * stride * 8);
  void* args[] = {&flags, &part, &slots, &nit, &out, &stride};
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)bench<V>, nb, NT, args, 0, 0);
  cudaEventRecord(b); cudaEventSynchronize(b);
  float ms; cudaEventElapsedTime(&ms, a, b);
  float h[256]; cudaMemcpy(h, out, 4 * nb, cudaMemcpyDeviceToHost);
  bool same = true; for (int i = 1; i < nb; ++i) same &= h[i] == h[0];
  printf("variant %d nb %d stride %d: %s %s %.3f us per barrier\n", V, nb, stride, cudaGetErrorString(e), same ? "agree" : "DISAGREE", 1e3 * ms / nit);
  cudaFree(flags); cudaFree(part); cudaFree(slots); cudaFree(out);
  return ms;
}
int main() {
  int nit = 20000;
  for (int rep = 0; rep < 2; ++rep) for (int nb : {132, 32}) {
    run<1>(nb, nit, 1); run<2>(nb, nit, 1); run<3>(nb, nit, 1); run<4>(nb, nit, 16); run<5>(nb, nit, 1); run<5>(nb, nit, 16); run<6>(nb, nit, 1);
  }
  return 0;
}
