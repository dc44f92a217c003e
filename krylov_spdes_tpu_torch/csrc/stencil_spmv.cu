// Kernel A of the port: the 9-point stencil SpMV on an (H, W) node grid,
//
//     y = (P0 + dir_diag) ⊙ x + Σ_{k=1..8} P_k ⊙ shift_k(x),
//
// with the shifts in the OFFSETS order self, E, W, N, S, NE, SW, SE, NW
// ((di, dj) = row, column offsets) and zero beyond the grid edge.
//
// Replaces: krylov_spdes_tpu/ops/pallas_stencil.py::_kernel (called by
// stencil_matvec_pallas), the row-tiled Pallas kernel that fed three
// row-shifted views of the zero-padded x into VMEM.
//
// What bounds it on an H100: bytes. Each node reads 9 plane values, its
// dir_diag entry and x, and writes y: 12 values, 48 B in float32, for 17
// flops. At 250k nodes that is 12 MB, about 3.6 µs at 3.35 TB/s; the
// operations (~4.3 Mflop) would take 0.06 µs at 67 TFLOP/s.
//
// Design: one thread per output node, blocks of 32 x 8 threads laid over the
// grid so that a warp reads 32 consecutive nodes of one row (coalesced
// row-major reads of every plane, of x and of y). The halo is handled by
// bounds checks in place of the TPU kernel's padded copies of x, so no
// padded buffer is allocated or written. The eight neighbour reads of x hit
// L1/L2 (each x value is read by nine threads), so DRAM sees x about once.
// The library is built with --fmad=false: every product and sum rounds on
// its own, exactly as the plain PyTorch version's elementwise ops do, so the
// two agree bit for bit.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void __launch_bounds__(256)
stencil_spmv_kernel(const T* __restrict__ planes, const T* __restrict__ dd,
                    const T* __restrict__ x, T* __restrict__ y, int H, int W) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= H || j >= W) return;
  const long n = static_cast<long>(H) * W;
  const long q = static_cast<long>(i) * W + j;
  const bool e = j + 1 < W, w = j > 0, up = i + 1 < H, dn = i > 0;
  const T z = T(0);
  const T xE = e ? x[q + 1] : z;
  const T xW = w ? x[q - 1] : z;
  const T xN = up ? x[q + W] : z;
  const T xS = dn ? x[q - W] : z;
  const T xNE = (up && e) ? x[q + W + 1] : z;
  const T xSW = (dn && w) ? x[q - W - 1] : z;
  const T xSE = (up && w) ? x[q + W - 1] : z;
  const T xNW = (dn && e) ? x[q - W + 1] : z;
  T acc = (planes[q] + dd[q]) * x[q];
  acc = acc + planes[1 * n + q] * xE;
  acc = acc + planes[2 * n + q] * xW;
  acc = acc + planes[3 * n + q] * xN;
  acc = acc + planes[4 * n + q] * xS;
  acc = acc + planes[5 * n + q] * xNE;
  acc = acc + planes[6 * n + q] * xSW;
  acc = acc + planes[7 * n + q] * xSE;
  acc = acc + planes[8 * n + q] * xNW;
  y[q] = acc;
}

template <typename T>
int launch(const void* planes, const void* dd, const void* x, void* y, int H,
           int W, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((W + 31) / 32, (H + 7) / 8);
  stencil_spmv_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(planes), static_cast<const T*>(dd),
      static_cast<const T*>(x), static_cast<T*>(y), H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64. Returns cudaGetLastError() after launch.
int stencil_spmv(int dtype, const void* planes, const void* dd, const void* x,
                 void* y, int H, int W, void* stream) {
  if (dtype == 0) return launch<float>(planes, dd, x, y, H, W, stream);
  if (dtype == 1) return launch<double>(planes, dd, x, y, H, W, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
