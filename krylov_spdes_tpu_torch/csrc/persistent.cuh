// The persistent-block skeleton of kernels C, D (csrc/fused_cg.cu), E
// (csrc/eigdef_stretch.cu) and H (csrc/stencil_cg.cu): band ownership, an
// all-gather barrier and a neighbour-only wait, fixed-order block
// reductions with warp shuffles, 16-byte band accesses, and on the host the
// device's limits and the checked cooperative launch.
//
// Band ownership. The grid has at most one block per SM (the caller sizes it
// from the device's SM count and from occupancy at the dynamic shared memory
// it asks for, and launches cooperatively, so every block is resident).
// Block b of nb owns the contiguous band of node rows band_of(b, nb, rows):
// the first rows % nb blocks take one row more. The Python side
// (ops/persistent.py::band_rows) uses the same formula.
//
// All-gather barrier, two forms. (1) Packed: a block's partials travel
// with the epoch in the same 64-bit words (32 bits of value, 32 of epoch),
// stored with release semantics on the block's own 128-byte line; every
// block polls the words of all blocks with acquire loads, so the wait and
// the data are one pass through the L2. (2) Flag + data, for many
// partials (E's 2·nvec sums of U): the block writes its partials, then
// raises its flag to the next epoch (__syncthreads, one __threadfence by
// thread 0, st.release.gpu); every block waits with acquire loads on all
// flags, then reads the partials. Either way every block sums the same
// partials in one fixed order (lanes over blocks, then a fixed warp
// butterfly), so all blocks hold the same value without a broadcast and a
// launch repeats bit for bit. Partials and packed words are double-buffered
// by the parity of the all-gather round: a block writes round k + 2's set
// only after every block has entered round k + 1, which each does after it
// has read round k. Flags and packed words live in one buffer the wrapper
// zeroes for each launch (sync_words), each block's on its own 128-byte
// lines so that the polling spreads over the L2.
//
// Neighbour-only wait. A block raises its flag to the next epoch and waits
// only for the blocks of the bands above and below: for data that only the
// adjacent rows read. Epochs only grow and every block passes the same
// sequence, so a later wait for "at least epoch e" is never confused.
//
// Data that another block wrote inside the launch is read with __ldcg (L2,
// never a stale L1 line) after the wait. A wait that lasts kSpinLimitNs
// traps: a launch whose blocks are not all resident fails with an error
// instead of hanging the device.

#pragma once

#include <cuda_runtime.h>

#include "common.cuh"  // warp_sum

namespace {

constexpr int kPThreads = 512;            // threads of a persistent block
constexpr int kPWarps = kPThreads / 32;
constexpr int kMaxBlocks = 256;           // grid of a persistent launch, at most
constexpr int kFlagWords = 32;            // u32 a block's flag line holds
constexpr int kSlotWords = 16;            // u64 a block's packed line holds
constexpr unsigned long long kSpinLimitNs = 10000000000ull;  // 10 s

// 32-bit words of the zeroed synchronisation buffer of a grid of nb blocks:
// nb flag lines, then two sets of nb packed lines.
__host__ __device__ inline long sync_words(int nb) {
  return static_cast<long>(nb) * (kFlagWords + 2 * 2 * kSlotWords);
}

__host__ __device__ __forceinline__ void band_of(int b, int nb, int rows,
                                                 int* start, int* count) {
  const int base = rows / nb, extra = rows % nb;
  *count = base + (b < extra ? 1 : 0);
  *start = b * base + (b < extra ? b : extra);
}

__device__ __forceinline__ void st_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release64(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long ld_acquire64(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *flag reaches epoch.
__device__ __forceinline__ void wait_flag(const unsigned int* flag,
                                          unsigned int epoch) {
  if (ld_acquire(flag) >= epoch) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(flag) < epoch) {
    if (global_ns() - t0 > kSpinLimitNs) __trap();
  }
}

// Spin until the packed word's epoch (its high half) reaches epoch; returns
// its low half.
__device__ __forceinline__ unsigned int wait_word(const unsigned long long* w,
                                                  unsigned int epoch) {
  unsigned long long v = ld_acquire64(w);
  if (static_cast<unsigned int>(v >> 32) >= epoch) return static_cast<unsigned int>(v);
  const unsigned long long t0 = global_ns();
  do {
    if (global_ns() - t0 > kSpinLimitNs) __trap();
    v = ld_acquire64(w);
  } while (static_cast<unsigned int>(v >> 32) < epoch);
  return static_cast<unsigned int>(v);
}

// N consecutive values of T as one 16-byte access, for the band passes.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  using V = float4;
  static constexpr int n = 4;
};
template <>
struct Pack<double> {
  using V = double2;
  static constexpr int n = 2;
};

template <typename T>
__device__ __forceinline__ void ld16(const T* p, T* v) {
  const typename Pack<T>::V q = *reinterpret_cast<const typename Pack<T>::V*>(p);
  if constexpr (Pack<T>::n == 4) {
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    v[0] = q.x; v[1] = q.y;
  }
}

template <typename T>
__device__ __forceinline__ typename Pack<T>::V pack(const T* v) {
  typename Pack<T>::V q;
  if constexpr (Pack<T>::n == 4) {
    q.x = v[0]; q.y = v[1]; q.z = v[2]; q.w = v[3];
  } else {
    q.x = v[0]; q.y = v[1];
  }
  return q;
}

template <typename T>
__device__ __forceinline__ void st16(T* p, const T* v) {
  *reinterpret_cast<typename Pack<T>::V*>(p) = pack(v);
}

// A value as 32-bit chunks and back, for the packed words.
__device__ __forceinline__ void to_words(float v, unsigned int* c) {
  c[0] = __float_as_uint(v);
}
__device__ __forceinline__ void to_words(double v, unsigned int* c) {
  c[0] = static_cast<unsigned int>(__double2loint(v));
  c[1] = static_cast<unsigned int>(__double2hiint(v));
}
__device__ __forceinline__ void from_words(const unsigned int* c, float& v) {
  v = __uint_as_float(c[0]);
}
__device__ __forceinline__ void from_words(const unsigned int* c, double& v) {
  v = __hiloint2double(static_cast<int>(c[1]), static_cast<int>(c[0]));
}

// NV sums over the block: each the warp butterfly, then the warps in
// order. The results are valid in thread 0. sh holds NV·kPWarps values;
// the caller passes a __syncthreads (an all-gather has two) before it
// reuses sh.
template <typename T, int NV>
__device__ void block_totals(T (&v)[NV], T* sh) {
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T w = warp_sum(v[k]);
    if ((threadIdx.x & 31) == 0) sh[k * kPWarps + (threadIdx.x >> 5)] = w;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      T s = sh[k * kPWarps];
      for (int w = 1; w < kPWarps; ++w) s += sh[k * kPWarps + w];
      v[k] = s;
    }
  }
}

template <typename T>
struct Barrier {
  unsigned int* flags;        // nb lines of kFlagWords, epoch in word 0
  unsigned long long* words;  // 2 sets × nb lines of kSlotWords
  T* part;                    // 2 sets × slots × nb partials (flag + data)
  int nb;
  int slots;
  unsigned int epoch;
  unsigned int round;

  __device__ Barrier(unsigned int* sync, T* p, int nslots)
      : flags(sync),
        words(reinterpret_cast<unsigned long long*>(sync + static_cast<long>(gridDim.x) * kFlagWords)),
        part(p), nb(gridDim.x), slots(nslots), epoch(0), round(0) {}

  // This round's flag + data partials of slot s, one value a block.
  __device__ T* slot(int s) const {
    return part + (static_cast<long>(round & 1u) * slots + s) * nb;
  }

  __device__ void raise() {
    ++epoch;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      st_release(flags + static_cast<long>(blockIdx.x) * kFlagWords, epoch);
    }
  }

  // Flag + data: raise the flag, wait for every block. Then warp_gather
  // sums this round's slots; next() ends the round.
  __device__ void all() {
    raise();
    for (int j = threadIdx.x; j < nb; j += kPThreads)
      wait_flag(flags + static_cast<long>(j) * kFlagWords, epoch);
    __syncthreads();
  }

  // Sums over the blocks of this round's slots s0, s0 + stride, ... below
  // ns, at most M of them, by the calling warp: for each slot lane l adds
  // blocks l, l + 32, ... in turn, then the butterfly (a fixed order), the
  // loads of all the slots in flight together. Lane 0 writes each sum to
  // out[s].
  template <int M>
  __device__ void warp_gather(int s0, int stride, int ns, T* out) const {
    T v[M];
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] = T(0);
    for (int j = threadIdx.x & 31; j < nb; j += 32) {
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int s = s0 + m * stride;
        if (s < ns) v[m] += __ldcg(slot(s) + j);
      }
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int s = s0 + m * stride;
      const T t = warp_sum(v[m]);
      if ((threadIdx.x & 31) == 0 && s < ns) out[s] = t;
    }
  }

  __device__ void next() { ++round; }

  // Packed all-gather of NV partials, v valid in thread 0 (block_totals
  // leaves them there). out[k] gets the sum of v[k] over the blocks, in
  // every thread's view. publish: the block wrote data other blocks read
  // after this barrier (a fence by thread 0 precedes the release).
  // sh32 holds kMaxBlocks · NV · sizeof(T) / 4 words.
  template <int NV>
  __device__ void all_values(const T (&v)[NV], T* out, unsigned int* sh32,
                             bool publish) {
    constexpr int CW = sizeof(T) / 4;  // 32-bit chunks a value
    constexpr int NW = NV * CW;        // packed words a block
    static_assert(NW <= kSlotWords, "too many packed values");
    ++epoch;
    unsigned long long* set = words + static_cast<long>(round & 1u) * nb * kSlotWords;
    if (threadIdx.x == 0) {
      if (publish) __threadfence();
      unsigned long long* mine = set + static_cast<long>(blockIdx.x) * kSlotWords;
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        unsigned int c[CW];
        to_words(v[k], c);
#pragma unroll
        for (int h = 0; h < CW; ++h)
          st_release64(mine + k * CW + h,
                       (static_cast<unsigned long long>(epoch) << 32) | c[h]);
      }
    }
    for (int w = threadIdx.x; w < nb * NW; w += kPThreads) {
      const int j = w / NW, c = w - j * NW;
      sh32[w] = wait_word(set + static_cast<long>(j) * kSlotWords + c, epoch);
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (warp < NV) {
      T s = T(0);
      for (int j = lane; j < nb; j += 32) {
        T x;
        from_words(sh32 + j * NW + warp * CW, x);
        s += x;
      }
      s = warp_sum(s);
      if (lane == 0) out[warp] = s;
    }
    __syncthreads();
    ++round;
  }

  // Raise the flag, wait for the bands above and below only.
  __device__ void neighbours() {
    raise();
    const int j = static_cast<int>(blockIdx.x) + (threadIdx.x == 0 ? -1 : 1);
    if (threadIdx.x < 2 && j >= 0 && j < nb)
      wait_flag(flags + static_cast<long>(j) * kFlagWords, epoch);
    __syncthreads();
  }
};

// The device's limits for the persistent kernel fn: out[0] = SM count,
// out[1] = the most dynamic shared memory a block of fn can ask for (the
// opt-in maximum less fn's static shared memory). Fails with
// cudaErrorNotSupported where the device has no cooperative launch.
inline cudaError_t persistent_limits(const void* fn, int* out) {
  int dev = 0, coop = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess) out[1] = optin - static_cast<int>(attr.sharedSizeBytes);
  return err;
}

// Launch fn on grid blocks of kPThreads with smem bytes of dynamic shared
// memory, cooperatively: cudaErrorCooperativeLaunchTooLarge if the blocks
// are not all resident at once. Returns cudaGetLastError() after it.
inline cudaError_t launch_persistent(const void* fn, int grid, int smem,
                                     void** args, void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kPThreads, smem);
  if (err != cudaSuccess) return err;
  if (static_cast<long>(per_sm) * sms < grid) return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(kPThreads), args,
                                    static_cast<size_t>(smem),
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
