// Hand-written CSR SpMV for Hopper (sm_90a).
//
// Replaces omp_amg_tpu/ops/pallas_routed.py::_kloop_kernel. It applies every
// coarse-level A, every prolongation P and every restriction R of the
// classical (PMIS) hierarchy, with the TPU kernel's four fused epilogues:
//
//   mode 0  spmv      out = A·x
//   mode 1  residual  out = b − A·x
//   mode 2  correct   out = v + A·x            (x + P·xc: x = xc, v = x)
//   mode 3  jacobi    out = x + s ⊙ (b − A·x)  (s = ω·D⁻¹ per row)
//
// Values are f32 or bf16 (converted with __bfloat162float); x, v, b, s and
// out are f32, and every row sums in f32.
//
// What bounds it: bytes. Each nonzero streams a 4 B column index and a 4 B
// (f32) or 2 B (bf16) value, each row 8 B of indptr, plus the gather of x:
// about 8–12 B per nonzero. The TPU kernel's routed chunk layout exists
// because gathers are slow on the TPU; on Hopper a gather is an ordinary
// load (x of a coarse level sits in the 50 MB L2), so plain CSR is the
// layout. One warp per row: lanes stride the row, so neighbouring lanes read
// neighbouring index and value words, and a shuffle reduction sums the 32
// partials. That suits the wide coarse rows (tens of nonzeros); the narrow
// P rows leave lanes idle, which is later work (width-adaptive vectors per
// row, SELL-C-σ).
//
// No atomics, so every run gives the same bits. Every row writes its output,
// empty rows included. Output is never in place: jacobi reads other rows' x.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load_val(const float* p, int64_t j) {
  return p[j];
}

__device__ __forceinline__ float load_val(const __nv_bfloat16* p, int64_t j) {
  return __bfloat162float(p[j]);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) csr_spmv_kernel(
    int64_t n_rows, const int64_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const T* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ b, const float* __restrict__ s,
    float* __restrict__ out) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the same for all 32 lanes of a warp
  const int64_t end = indptr[row + 1];
  float acc = 0.0f;
  for (int64_t j = indptr[row] + lane; j < end; j += 32)
    acc = fmaf(load_val(vals, j), x[indices[j]], acc);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane != 0) return;
  float y = acc;
  // explicit rounding: the epilogue gives the plain twin's bits for a
  // given row sum (no contraction into an fma)
  if constexpr (MODE == 1) {
    y = __fsub_rn(b[row], acc);
  } else if constexpr (MODE == 2) {
    y = __fadd_rn(v[row], acc);
  } else if constexpr (MODE == 3) {
    y = __fadd_rn(x[row], __fmul_rn(s[row], __fsub_rn(b[row], acc)));
  }
  out[row] = y;
}

template <typename T>
cudaError_t launch(int mode, int64_t n_rows, const int64_t* indptr,
                   const int32_t* indices, const T* vals, const float* x,
                   const float* v, const float* b, const float* s, float* out,
                   cudaStream_t stream) {
  const int64_t blocks = (n_rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (mode) {
    case 0:
      csr_spmv_kernel<T, 0><<<grid, kThreads, 0, stream>>>(
          n_rows, indptr, indices, vals, x, v, b, s, out);
      break;
    case 1:
      csr_spmv_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
          n_rows, indptr, indices, vals, x, v, b, s, out);
      break;
    case 2:
      csr_spmv_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          n_rows, indptr, indices, vals, x, v, b, s, out);
      break;
    case 3:
      csr_spmv_kernel<T, 3><<<grid, kThreads, 0, stream>>>(
          n_rows, indptr, indices, vals, x, v, b, s, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// Pointers the mode does not read may be null.
extern "C" int csr_spmv_launch(int mode, int val_bf16, int64_t n_rows,
                               const void* indptr, const void* indices,
                               const void* vals, const void* x, const void* v,
                               const void* b, const void* s, void* out,
                               void* stream) {
  if (n_rows <= 0) return 0;
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(indices);
  const auto* xf = static_cast<const float*>(x);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(b);
  const auto* sf = static_cast<const float*>(s);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (val_bf16) {
    err = launch(mode, n_rows, ip, ix,
                 static_cast<const __nv_bfloat16*>(vals), xf, vf, bf, sf, of,
                 st);
  } else {
    err = launch(mode, n_rows, ip, ix, static_cast<const float*>(vals), xf,
                 vf, bf, sf, of, st);
  }
  return static_cast<int>(err);
}
