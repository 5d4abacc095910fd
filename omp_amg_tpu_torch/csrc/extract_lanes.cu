// Hand-written row-wise gather for Hopper (sm_90a): out[i, s] = w[i, idx[i, s]].
//
// Replaces omp_amg_tpu/ops/pallas_spmm.py::_extract_kernel. It pulls the
// Galerkin entries out of the probe products of the colored-probing RAP
// (ops/probe_rap.py): A_c[i, s] = W[i, colour(col(i, s))]. The TPU kernel's
// width-128 take-along form (w of 128 lanes, idx in 128×128 tiles) exists
// because XLA gathers are slow there; on Hopper a gather is a load, so this
// kernel takes any width of w.
//
// Operands: w f32 (R, W), idx int32 (R, S), both row-major and contiguous;
// out f32 (R, S). An index outside [0, W) traps (the launch fails, the
// stream reports the error at its next synchronisation): a colour outside
// the probe panel is a broken invariant, not an input to tolerate.
//
// One thread per output element, with a 64-bit flat index: neighbouring
// threads read neighbouring idx words and write neighbouring outputs; the
// w reads land in the row's own W-wide span. What bounds it: bytes (idx
// read and out written once, 8 B per element, plus the w entries read).
// The copy is exact.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) extract_lanes_kernel(
    int64_t total, int64_t S, int64_t W, const float* __restrict__ w,
    const int32_t* __restrict__ idx, float* __restrict__ out) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t i = e / S;
  const int32_t j = idx[e];
  if (j < 0 || j >= W) __trap();
  out[e] = w[i * W + j];
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
extern "C" int extract_lanes_launch(int64_t R, int64_t S, int64_t W,
                                    const void* w, const void* idx, void* out,
                                    void* stream) {
  const int64_t total = R * S;
  if (total <= 0) return 0;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  extract_lanes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      total, S, W, static_cast<const float*>(w),
      static_cast<const int32_t*>(idx), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
