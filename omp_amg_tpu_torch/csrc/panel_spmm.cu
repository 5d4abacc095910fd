// Hand-written CSR × dense-panel SpMM for Hopper (sm_90a): U = A·X.
//
// Replaces omp_amg_tpu/ops/pallas_spmm.py::_spmm_kernel, ::_spmm_roll_kernel
// and ::_spmm_v2_kernel. All three compute the same product, the numeric
// phase of the colored-probing Galerkin RAP (ops/probe_rap.py): U = A·(P·V)
// and W = Pᵀ·U for a one-hot colour panel V. They differ only in how they
// stream TPU VMEM windows of X, and they gather X through one-hot MXU
// matmuls on bf16 hi/lo/lo2 splits to stay f32-exact. On Hopper a gather is
// an ordinary load, so one kernel over plain CSR covers all three, in f32,
// with no splits.
//
// Operands: A in CSR (int64 indptr, int32 indices, f32 values); X f32
// (n_cols, C) row-major, 1 ≤ C ≤ 128; U f32 (n_rows, C), written in full
// (an empty row writes zeros).
//
// One warp per row. Lane l owns columns l, l+32, l+64, l+96 below C: at
// most four accumulators. The warp walks the row's nonzeros in CSR order;
// every lane loads the same (col, val) (a broadcast), then its columns of
// X's row `col`, so the warp reads that row as one 128-byte line per 32
// columns. Each product and sum is rounded explicitly (__fmul_rn,
// __fadd_rn: no contraction into an FMA) in CSR order, so the kernel gives
// its plain twin's bits, and the GPU and CPU runs of the port build the
// same hierarchy.
//
// What bounds it: bytes. A's nonzeros stream once (8 B each), indptr once,
// U is written once (4·C B per row), and X is read once from device memory
// and again from L1/L2 for each further nonzero in its column. Shared-memory
// staging of X rows and vector loads are later work.
//
// Index arithmetic is 64-bit: at 256³ rows × 128 columns exceeds int32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 8 rows per block
constexpr int kMaxCols = 128;     // 4 accumulators per lane

__global__ void __launch_bounds__(kThreads) panel_spmm_kernel(
    int64_t n_rows, int32_t C, const int64_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ u) {
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the same for all 32 lanes of a warp
  float acc[kMaxCols / 32] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int64_t end = indptr[row + 1];
  for (int64_t j = indptr[row]; j < end; ++j) {
    const float v = vals[j];
    const float* xr = x + static_cast<int64_t>(indices[j]) * C;
#pragma unroll
    for (int q = 0; q < kMaxCols / 32; ++q) {
      const int c = lane + 32 * q;
      if (c < C) acc[q] = __fadd_rn(acc[q], __fmul_rn(v, xr[c]));
    }
  }
  float* ur = u + row * C;
#pragma unroll
  for (int q = 0; q < kMaxCols / 32; ++q) {
    const int c = lane + 32 * q;
    if (c < C) ur[c] = acc[q];
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
extern "C" int panel_spmm_launch(int64_t n_rows, int32_t C,
                                 const void* indptr, const void* indices,
                                 const void* vals, const void* x, void* u,
                                 void* stream) {
  if (C < 1 || C > kMaxCols) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows <= 0) return 0;
  const int64_t blocks = (n_rows * 32 + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  panel_spmm_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      n_rows, C, static_cast<const int64_t*>(indptr),
      static_cast<const int32_t*>(indices), static_cast<const float*>(vals),
      static_cast<const float*>(x), static_cast<float*>(u));
  return static_cast<int>(cudaGetLastError());
}
