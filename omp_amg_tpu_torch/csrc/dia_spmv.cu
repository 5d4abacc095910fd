// Hand-written banded (DIA) SpMV for Hopper (sm_90a).
//
// Replaces omp_amg_tpu/ops/pallas_spmv.py::_plane_kernel and
// omp_amg_tpu/ops/pallas_spmv.py::_dia_kernel: the same banded product for
// any offsets, where the TPU needed a second kernel for operators without
// its 3D plane layout (2D grids). It applies the banded fine-level A of the
// classical hierarchy and every banded level of the structured one, in the
// V-cycle and in PCG's q = A·p, with the TPU kernel's fused epilogues:
//
//   mode 0  spmv      out = A·x
//   mode 1  residual  out = b − A·x
//   mode 2  jacobi    out = x + s ⊙ (b − A·x)  (s = ω·D⁻¹ per row; the x of
//                     the update is row i's own x[x_base + i])
//
// data is diagonal-major (ndiag, n), f32 or lossless bf16; data[k, i]
// multiplies x[i + offsets[k]]. x, b, s and out are f32.
//
// What bounds it: bytes. At 7 points with bf16 values a row streams 7·2 B of
// diagonals, 4 B of x and 4 B of output: about 22 B per row (plus 8 B of b
// and s in the fused modes). One thread per row; the diagonal reads of a
// warp are contiguous. The TPU kernel rolls z-planes of x through a VMEM
// ring so that x is read from HBM once; here L2 reuse does that job: the
// ±1-plane taps of neighbouring rows touch the same few planes of x, which
// stay in the 50 MB L2 (a 128×128 plane is 64 KB).
//
// x may be a window longer than the n rows: row i's tap k reads
// x[x_base + i + offsets[k]], and the kernel guards 0 <= x_base + i + off <
// x_len, so x is never read out of range, even where the data is 0. A
// single-device product is x_base = 0, x_len = n; a z-slab shard of the
// distributed path reads its exchanged window [left halo | own rows | right
// halo] at x_base = the left halo's length (omp_amg_tpu/parallel/slab.py's
// shard-local rows()), or the whole vector at x_base = its first row.
//
// Offsets are a device int64 array staged in shared memory. Taps are summed
// in ascending k with explicit rounding (no fma contraction), exactly as the
// plain twin and the reference's spmv_dia do, so kernel and twin agree bit
// for bit.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDiag = 64;

__device__ __forceinline__ float load_val(const float* p, int64_t j) {
  return p[j];
}

__device__ __forceinline__ float load_val(const __nv_bfloat16* p, int64_t j) {
  return __bfloat162float(p[j]);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) dia_spmv_kernel(
    int64_t n, int ndiag, const int64_t* __restrict__ offsets,
    const T* __restrict__ data, const float* __restrict__ x, int64_t x_base,
    int64_t x_len, const float* __restrict__ b, const float* __restrict__ s,
    float* __restrict__ out) {
  __shared__ int64_t offs[kMaxDiag];
  for (int k = threadIdx.x; k < ndiag; k += blockDim.x) offs[k] = offsets[k];
  __syncthreads();
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = 0.0f;
  for (int k = 0; k < ndiag; ++k) {
    const int64_t j = x_base + i + offs[k];
    if (j >= 0 && j < x_len)
      acc = __fadd_rn(acc, __fmul_rn(load_val(data, k * n + i), x[j]));
  }
  float y = acc;
  if constexpr (MODE == 1) {
    y = __fsub_rn(b[i], acc);
  } else if constexpr (MODE == 2) {
    y = __fadd_rn(x[x_base + i], __fmul_rn(s[i], __fsub_rn(b[i], acc)));
  }
  out[i] = y;
}

template <typename T>
cudaError_t launch(int mode, int64_t n, int ndiag, const int64_t* offsets,
                   const T* data, const float* x, int64_t x_base,
                   int64_t x_len, const float* b, const float* s, float* out,
                   cudaStream_t stream) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (mode) {
    case 0:
      dia_spmv_kernel<T, 0><<<grid, kThreads, 0, stream>>>(
          n, ndiag, offsets, data, x, x_base, x_len, b, s, out);
      break;
    case 1:
      dia_spmv_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
          n, ndiag, offsets, data, x, x_base, x_len, b, s, out);
      break;
    case 2:
      dia_spmv_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          n, ndiag, offsets, data, x, x_base, x_len, b, s, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// Pointers the mode does not read may be null. x holds x_len values, and
// 0 <= x_base <= x_len − n.
extern "C" int dia_spmv_launch(int mode, int val_bf16, int64_t n, int ndiag,
                               const void* offsets, const void* data,
                               const void* x, int64_t x_base, int64_t x_len,
                               const void* b, const void* s, void* out,
                               void* stream) {
  if (n <= 0) return 0;
  if (ndiag < 0 || ndiag > kMaxDiag) return cudaErrorInvalidValue;
  if (x_base < 0 || x_base > x_len - n) return cudaErrorInvalidValue;
  const auto* off = static_cast<const int64_t*>(offsets);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(b);
  const auto* sf = static_cast<const float*>(s);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (val_bf16) {
    err = launch(mode, n, ndiag, off, static_cast<const __nv_bfloat16*>(data),
                 xf, x_base, x_len, bf, sf, of, st);
  } else {
    err = launch(mode, n, ndiag, off, static_cast<const float*>(data), xf,
                 x_base, x_len, bf, sf, of, st);
  }
  return static_cast<int>(err);
}
