// Kernel E of the port: one restart-free stretch of eigDef-PCG on the padded
// layout of krylov_spdes_tpu_torch/ops/fused_cg.py (see csrc/fused_cg.cu).
//
// E  eigdef_stretch  replaces
//    krylov_spdes_tpu/ops/vmem_eigdef.py::_stretch_kernel.
//    Up to nsteps iterations in one persistent cooperative launch, each:
//      ap = A·p, α = rᵀz / pᵀap, x += α·p, r −= α·ap,
//      U = G·r (2·nvec grid sums),
//      c_r = Acᵀ·U[:nvec], c_p = Bcᵀ·U              (2·nvec² flops a block)
//      r −= Σ_j c_r[j]·W_j                          (reorth, defcg.jl:407)
//      z = minv ⊙ r, β = rᵀz_new / rᵀz,
//      p = β·p + z − Σ_j c_p[j]·W_j                 (deflation)
//      V[ivec0 + i + 1] = z / √(rᵀz_new), and α, β, ‖r‖² to device memory.
//    W = G[:nvec] is the deflation basis; Ac = M1 and Bc = [−M1·Kmᵀ·M2; M2]
//    are the coefficient matrices of ops/vmem_eigdef.py::stretch_operands,
//    so Σ_j c_r[j]·W_j = Σ_k U_k·A1_k and Σ_j c_p[j]·W_j = Σ_k U_k·B_k with
//    the JAX package's A1 = Ac·W and B = Bc·W: the same values in exact
//    arithmetic, another rounding. The kernel reads neither A1 nor B.
//    The loop runs while i < nsteps and ‖r‖² > tol², ‖r‖² starting at
//    res2_prev. x, r, p are updated in place; of V only the appended
//    columns are written.
//
//    Design (csrc/persistent.cuh): one persistent block per SM, each owning
//    a band of node rows (3-4 at 500 × 500). A block keeps in shared memory
//    Ac and Bc, its band of x, r, ap, accp and minv, the direction in a tile of the
//    band's padded rows plus one halo row above and below, and as many of
//    the nvec basis vectors' band rows as fit beside them (all 16 at 250k
//    nodes, float32: 131 KB): W is then read twice an iteration from shared
//    memory, once for U and once for both fixes, each W_j load feeding
//    both sums. Rows that do not fit are read from G in the same loop. An
//    iteration reads from global memory only the planes, WᵀA·m (G's second
//    half), the rows of W that are not resident and two halo rows of p, and
//    writes one column of V and the band's edge rows of p: 3·nvec grids of
//    operands at most (G and W again), not the 5·nvec of G, A1 and B.
//    Barriers an iteration: three all-gathers (pᵀap and then rᵀr with rᵀz
//    packed with their epoch, one pass through the L2 each; the 2·nvec
//    partials of U by flag + data, every block summing them itself in a
//    fixed order), and after p is written a neighbour-only wait, since the
//    next apply needs p only one row beyond the band. Loops over a band put
//    its rows innermost and unrolled, so that a thread's global loads for
//    several rows are in flight together.
//
//    Reductions have a fixed order (a thread's nodes, the warp butterfly,
//    the warps in order, then the blocks) and use no float atomics, so a
//    stretch repeats bit for bit.
//
//    Residency: the wrapper (ops/vmem_eigdef.py, with
//    ops/persistent.py::stretch_plan) sizes the vector area and the number
//    of resident W rows from the device's shared memory; where the vectors
//    do not fit either, they live in a per-block scratch area in global
//    memory. There is no size limit and no other path.
//
// The library is built with --fmad=false so that every product and sum
// rounds on its own, as the plain PyTorch version's elementwise ops do.

#include <cuda_runtime.h>

#include "common.cuh"
#include "persistent.cuh"

namespace {

constexpr int kMaxU = 64;   // 2·nvec at most
constexpr int kRows = 8;    // rows of G summed together in the U pass
constexpr int kGuard = 4;   // zeros before and after the direction tile

// Ac and Bc in shared memory, rounded up to a 16-byte multiple.
__host__ __device__ inline long coef_elems(int nvec) {
  return (3L * nvec * nvec + 3) / 4 * 4;
}

// Elements of T a block's vector area holds: x, r, ap, accp, minv over the
// band of nrmax padded rows, and the direction tile of nrmax + 2 rows with
// kGuard zeros before and after it.
__host__ __device__ inline long vec_elems(int nrmax, int C) {
  return 5L * nrmax * C + static_cast<long>(nrmax + 2) * C + 2 * kGuard;
}

// st16 (csrc/persistent.cuh) with an evict-first (streaming) store, for
// V's columns, which nothing in the stretch reads again: they leave G and
// the planes in the L2.
template <typename T>
__device__ __forceinline__ void st16_stream(T* p, const T* v) {
  __stcs(reinterpret_cast<typename Pack<T>::V*>(p), pack(v));
}

template <typename T, int K>
__global__ void __launch_bounds__(kPThreads, 1)
stretch_kernel(const T* __restrict__ P, const T* __restrict__ minv,
               const T* __restrict__ G, const T* __restrict__ Ac,
               const T* __restrict__ Bc, T* x, T* r, T* p, T* V, T* part,
               unsigned int* sync, T* scratch, const T* __restrict__ tol2p,
               const T* __restrict__ rTz0p, const T* __restrict__ res2p,
               T* alphas, T* betas, T* res2s, int* info, T* rTz_out, int H,
               int W, int C, int nvec, int nsteps, int ivec0, int nrmax,
               int vres, int wres) {
  constexpr int N = Pack<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[2 * kPWarps];
  __shared__ T shw[kPWarps * kMaxU];
  __shared__ T shU[kMaxU];
  __shared__ T shc[kMaxU];      // c_r, then c_p
  __shared__ T sums[2];
  __shared__ unsigned int sh32[kMaxBlocks * 2 * sizeof(T) / 4];
  int r0, nr;
  band_of(blockIdx.x, gridDim.x, H, &r0, &nr);
  const long plane = static_cast<long>(H + 2 * kRow0) * C;
  const long band = static_cast<long>(nrmax) * C;
  const long qb = static_cast<long>(r0 + kRow0) * C;  // band's first node row
  const int nu = 2 * nvec;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // a band is walked in items of N consecutive values of one padded row
  // (pad columns included: they are zero in every operand and stay zero)
  const int cv = C / N;
  const int items = nr * cv;
  // dynamic shared memory: Ac and Bc, the vector area (if resident), the
  // resident rows of W
  T* coef = reinterpret_cast<T*>(smem_raw);
  T* sm = coef + coef_elems(nvec);
  T* vec = vres ? sm : scratch + blockIdx.x * vec_elems(nrmax, C);
  T* xs = vec;
  T* rs = vec + band;
  T* aps = vec + 2 * band;
  T* accp = vec + 3 * band;
  T* mv = vec + 4 * band;
  T* tile = vec + 5 * band + kGuard;  // tile row 0: the padded row above
  T* wsm = sm + (vres ? vec_elems(nrmax, C) : 0);
  const T* Gb = G + qb;
  // row k of G over the band, indexed like the band's vectors: resident
  // rows of W in shared memory, the rest in G itself
  auto row = [&](int k) -> const T* {
    return k < wres ? wsm + k * band : Gb + k * plane;
  };

  for (int t = threadIdx.x; t < nvec * nvec; t += kPThreads) coef[t] = Ac[t];
  for (int t = threadIdx.x; t < 2 * nvec * nvec; t += kPThreads)
    coef[nvec * nvec + t] = Bc[t];
  for (int t = threadIdx.x; t < items; t += kPThreads) {
    const int i = t / cv;
    const long l = i * static_cast<long>(C) + (t - i * cv) * N;
    T v[N];
    ld16(x + qb + l, v);
    st16(xs + l, v);
    ld16(r + qb + l, v);
    st16(rs + l, v);
    ld16(minv + qb + l, v);
    st16(mv + l, v);
#pragma unroll
    for (int u = 0; u < N; ++u) v[u] = T(0);
    st16(aps + l, v);  // the apply writes nodes only: ap's pads stay zero
    for (int k = 0; k < wres; ++k) {
      ld16(Gb + k * plane + l, v);
      st16(wsm + k * band + l, v);
    }
  }
  // the direction: the band's padded rows and the rows above and below,
  // pad columns included, and the zeros at either end
  for (long t = threadIdx.x; t < static_cast<long>(nr + 2) * C; t += kPThreads)
    tile[t] = p[qb - C + t];
  if (threadIdx.x < kGuard) {
    tile[-1 - static_cast<int>(threadIdx.x)] = T(0);
    tile[static_cast<long>(nrmax + 2) * C + threadIdx.x] = T(0);
  }

  // pᵀap and (rᵀr, rᵀz) go through packed all-gathers, the 2·nvec sums of
  // U through flag + data
  Barrier<T> bar(sync, part, nu);
  const T tol2 = *tol2p;
  T rTz = *rTz0p;
  T res2 = *res2p;
  int it = 0;

  while (it < nsteps && res2 > tol2) {
    // 1. ap = A·p, partial pᵀap (the halo rows as the neighbours left them)
    if (it > 0) {
      for (int j = threadIdx.x; j < W; j += kPThreads) {
        tile[j] = __ldcg(p + qb - C + j);
        tile[(nr + 1) * static_cast<long>(C) + j] = __ldcg(p + qb + nr * static_cast<long>(C) + j);
      }
    }
    __syncthreads();
    // (a node a thread, neighbouring threads on neighbouring nodes for the
    // planes' loads; the band's rows innermost and unrolled, so that a
    // thread's loads for several rows are in flight together)
    T ld = T(0);
    for (int j = threadIdx.x; j < W; j += kPThreads) {
#pragma unroll 4
      for (int i = 0; i < nr; ++i) {
        const long l = i * static_cast<long>(C) + j;
        const T* tp = tile + C + l;
        const T v0 = tp[0];
        const T y = apply_vals<T, K>(P, plane, qb + l, C, v0, tp[1], tp[-1],
                                     tp[C], tp[-C], tp[C + 1], tp[-C - 1],
                                     tp[C - 1], tp[-C + 1]);
        aps[l] = y;
        ld += v0 * y;
      }
    }
    T v1[1] = {ld};
    block_totals(v1, red);
    bar.all_values(v1, sums, sh32, false);
    const T alpha = rTz / sums[0];

    // 2. x += α·p, r −= α·ap, then the block's partials of U = G·r
    for (int t = threadIdx.x; t < items; t += kPThreads) {
      const int i = t / cv;
      const long l = i * static_cast<long>(C) + (t - i * cv) * N;
      T xv[N], pv[N], rv[N], av[N];
      ld16(xs + l, xv);
      ld16(tile + C + l, pv);
      ld16(rs + l, rv);
      ld16(aps + l, av);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        xv[u] = xv[u] + alpha * pv[u];
        rv[u] = rv[u] - alpha * av[u];
      }
      st16(xs + l, xv);
      st16(rs + l, rv);
    }
    __syncthreads();
    // kRows rows of G at a time, their loads in flight together; each row's
    // sum keeps its order (a thread's values, the warp butterfly, the warps
    // in order)
    for (int k0 = 0; k0 < nu; k0 += kRows) {
      T acc[kRows];
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) acc[kk] = T(0);
      for (int t = threadIdx.x; t < items; t += kPThreads) {
        const int i = t / cv;
        const long l = i * static_cast<long>(C) + (t - i * cv) * N;
        T rv[N];
        ld16(rs + l, rv);
#pragma unroll
        for (int kk = 0; kk < kRows; ++kk) {
          if (k0 + kk < nu) {
            T g[N];
            ld16(row(k0 + kk) + l, g);
#pragma unroll
            for (int u = 0; u < N; ++u) acc[kk] += g[u] * rv[u];
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < kRows; ++kk) {
        const T v = warp_sum(acc[kk]);
        if (lane == 0 && k0 + kk < nu) shw[warp * kMaxU + k0 + kk] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < nu) {
      T v = shw[threadIdx.x];
      for (int w = 1; w < kPWarps; ++w) v += shw[w * kMaxU + threadIdx.x];
      bar.slot(threadIdx.x)[blockIdx.x] = v;
    }
    bar.all();
    bar.template warp_gather<kMaxU / kPWarps>(warp, kPWarps, nu, shU);
    __syncthreads();
    bar.next();
    // c_r = Acᵀ·U[:nvec] and c_p = Bcᵀ·U: a warp a coefficient, its lanes
    // over k in a fixed order, then the butterfly
    for (int o = warp; o < nu; o += kPWarps) {
      const bool is_r = o < nvec;
      const int j = is_r ? o : o - nvec;
      const T* M = is_r ? coef : coef + nvec * nvec;
      const int nk = is_r ? nvec : nu;
      T c = T(0);
      for (int k = lane; k < nk; k += 32) c += M[k * nvec + j] * shU[k];
      c = warp_sum(c);
      if (lane == 0) shc[o] = c;
    }
    __syncthreads();

    // 3. one pass over W: r −= Σ c_r[j]·W_j, accp = Σ c_p[j]·W_j; rᵀr, rᵀz
    T lr = T(0), lz = T(0);
    for (int t = threadIdx.x; t < items; t += kPThreads) {
      const int i = t / cv;
      const long l = i * static_cast<long>(C) + (t - i * cv) * N;
      T w[N], ar[N], apk[N];
      ld16(row(0) + l, w);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        ar[u] = shc[0] * w[u];
        apk[u] = shc[nvec] * w[u];
      }
      for (int k = 1; k < nvec; ++k) {
        ld16(row(k) + l, w);
        const T cr = shc[k], cp = shc[nvec + k];
#pragma unroll
        for (int u = 0; u < N; ++u) {
          ar[u] = ar[u] + cr * w[u];
          apk[u] = apk[u] + cp * w[u];
        }
      }
      T rv[N], mvv[N];
      ld16(rs + l, rv);
      ld16(mv + l, mvv);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        rv[u] = rv[u] - ar[u];
        lr += rv[u] * rv[u];
        lz += rv[u] * (mvv[u] * rv[u]);
      }
      st16(rs + l, rv);
      st16(accp + l, apk);
    }
    T v2[2] = {lr, lz};
    block_totals(v2, red);
    bar.all_values(v2, sums, sh32, false);
    const T rTr = sums[0];
    const T rTz_new = sums[1];
    const T beta = rTz_new / rTz;

    // 4. p = β·p + z − accp, the new column of V; the band's edge rows of p
    //    to global memory for the neighbours' next apply
    const T vnorm = sqrt(rTz_new);
    T* Vcol = V + static_cast<long>(ivec0 + it + 1) * plane + qb;
    for (int t = threadIdx.x; t < items; t += kPThreads) {
      const int i = t / cv;
      const long l = i * static_cast<long>(C) + (t - i * cv) * N;
      T rv[N], mvv[N], pv[N], av[N], vz[N];
      ld16(rs + l, rv);
      ld16(mv + l, mvv);
      ld16(tile + C + l, pv);
      ld16(accp + l, av);
#pragma unroll
      for (int u = 0; u < N; ++u) {
        const T z = mvv[u] * rv[u];
        pv[u] = (beta * pv[u] + z) - av[u];
        vz[u] = z / vnorm;
      }
      st16(tile + C + l, pv);
      st16_stream(Vcol + l, vz);
      if (i == 0 || i == nr - 1) st16(p + qb + l, pv);
    }
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      alphas[it] = alpha;
      betas[it] = beta;
      res2s[it] = rTr;
    }
    rTz = rTz_new;
    res2 = rTr;
    ++it;
    bar.neighbours();
  }
  __syncthreads();
  for (int t = threadIdx.x; t < items; t += kPThreads) {
    const int i = t / cv;
    const long l = i * static_cast<long>(C) + (t - i * cv) * N;
    T v[N];
    ld16(xs + l, v);
    st16(x + qb + l, v);
    ld16(rs + l, v);
    st16(r + qb + l, v);
    ld16(tile + C + l, v);
    st16(p + qb + l, v);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    info[0] = it;
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

// The device's limits for the stretch: out[0] = SM count, out[1] = the most
// dynamic shared memory a block of the kernel can ask for (the opt-in
// maximum less the kernel's static shared memory). Returns a cudaError_t.
int eigdef_stretch_limits(int dtype, int K, int* out) {
  const void* fn = pick_stretch(dtype, K);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(persistent_limits(fn, out));
}

// E. dtype: 0 = float32, 1 = float64. G: (2·nvec, R, C); Ac: (nvec, nvec);
// Bc: (2·nvec, nvec); V: (spdim, R, C) with ivec0 + nsteps < spdim.
// part: 4·nvec·grid values; sync: sync_words(grid) zeroed 32-bit words;
// scratch:
// grid × vec_elems values when vres = 0; alphas, betas, res2: preset by the
// caller; info: two ints (iterations run, ‖r‖² still above tol²). grid,
// nrmax = ⌈H / grid⌉, vres, wres and smem come from
// ops/persistent.py::stretch_plan; smem must be the bytes that layout needs.
// Returns a cudaError_t: cudaErrorCooperativeLaunchTooLarge if the grid is
// not resident at once.
int eigdef_stretch(int dtype, int K, const void* P, const void* minv,
                   const void* G, const void* Ac, const void* Bc, void* x,
                   void* r, void* p, void* V, void* part, void* sync,
                   void* scratch, const void* tol2, const void* rTz,
                   const void* res2_prev, void* alphas, void* betas,
                   void* res2, void* info, void* rTz_out, int H, int W, int C,
                   int nvec, int nsteps, int ivec0, int grid, int nrmax,
                   int vres, int wres, int smem, void* stream) {
  const void* fn = pick_stretch(dtype, K);
  const long esize = dtype == 0 ? 4 : 8;
  const long need = esize * (coef_elems(nvec) + (vres ? vec_elems(nrmax, C) : 0)
                             + static_cast<long>(wres) * nrmax * C);
  if (fn == nullptr || grid < 1 || grid > H || grid > kMaxBlocks || nvec < 1
      || 2 * nvec > kMaxU
      || nrmax != (H + grid - 1) / grid || wres < 0 || wres > nvec || C % 4 != 0
      || smem != need) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&P, &minv, &G, &Ac, &Bc, &x, &r, &p, &V, &part, &sync,
                  &scratch, &tol2, &rTz, &res2_prev, &alphas, &betas, &res2,
                  &info, &rTz_out, &H, &W, &C, &nvec, &nsteps, &ivec0,
                  &nrmax, &vres, &wres};
  return static_cast<int>(launch_persistent(fn, grid, smem, args, stream));
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
