// Hand-written vector passes of the certified loop for Hopper (sm_90a):
//
//   defect:  out = (float) (r · inv)    (inv = 1/‖r‖, formed on the host)
//   update:  x ← x + s · (double) xi    in place (s = ‖r‖)
//
// Replaces no TPU kernel. The reference's certified loop (omp_amg_tpu/
// solvers/ir.py::solve_ir_device) forms these with plain jnp, outside
// Pallas, in double-float32 pairs. The port's loop (omp_amg_tpu_torch/
// solvers/ir.py::solve_ir_device) wrote them as torch operations on float64
// vectors: the defect a division and a cast, each writing a full vector, and
// the update a widened copy of the inner solution, a product and a new x.
// The true residual r = b − A·x of the same loop is dia_spmv.cu's kernel
// instantiated on double.
//
// Arithmetic: bit for bit the torch forms they replace (the plain twins in
// omp_amg_tpu_torch/ops/ir_f64.py). PyTorch divides a CUDA tensor by a
// Python number as a product with the number's reciprocal, formed in double
// on the host, so the defect is __dmul_rn(r, inv) then __double2float_rn;
// the update is __dmul_rn then __dadd_rn; the f32 → f64 widening is exact.
//
// What bounds them: bytes. At 256³ (16.7M rows) the defect reads 134 MB and
// writes 67 MB (60 µs at 3.35 TB/s), the update reads 201 MB and writes
// 134 MB (100 µs), where the torch forms moved 0.47 and 0.87 GB.
//
// Design: a pure stream, as pcg_update.cu. Each thread takes four rows at a
// time, two 16-byte loads of f64 and one of f32, in a grid-stride loop over
// a grid sized to the card; the threads of the grid then take the scalar
// tail. Where a pointer is not 16-byte aligned (a view at an offset), the
// whole pass takes the scalar loop.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block
constexpr int kGroup = 4;       // rows a thread takes at a time

// out = (float) (r · inv)
__global__ void __launch_bounds__(kThreads)
defect_kernel(int64_t n, int vec, const double* __restrict__ r, double inv,
              float* __restrict__ out) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t groups = n / kGroup;
    const auto* rv = reinterpret_cast<const double2*>(r);
    auto* ov = reinterpret_cast<float4*>(out);
    for (int64_t g = tid; g < groups; g += stride) {
      const double2 a = __ldcs(rv + 2 * g);
      const double2 b = __ldcs(rv + 2 * g + 1);
      __stcs(ov + g, make_float4(__double2float_rn(__dmul_rn(a.x, inv)),
                                 __double2float_rn(__dmul_rn(a.y, inv)),
                                 __double2float_rn(__dmul_rn(b.x, inv)),
                                 __double2float_rn(__dmul_rn(b.y, inv))));
    }
    done = groups * kGroup;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = __double2float_rn(__dmul_rn(r[i], inv));
}

__device__ __forceinline__ double axpy(double x, double s, float xi) {
  return __dadd_rn(x, __dmul_rn(s, static_cast<double>(xi)));
}

// x ← x + s · (double) xi
__global__ void __launch_bounds__(kThreads)
update_kernel(int64_t n, int vec, double* __restrict__ x, double s,
              const float* __restrict__ xi) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    const int64_t groups = n / kGroup;
    auto* xv = reinterpret_cast<double2*>(x);
    const auto* iv = reinterpret_cast<const float4*>(xi);
    for (int64_t g = tid; g < groups; g += stride) {
      double2 a = xv[2 * g], b = xv[2 * g + 1];
      const float4 e = __ldcs(iv + g);
      a.x = axpy(a.x, s, e.x);
      a.y = axpy(a.y, s, e.y);
      b.x = axpy(b.x, s, e.z);
      b.y = axpy(b.y, s, e.w);
      xv[2 * g] = a;
      xv[2 * g + 1] = b;
    }
    done = groups * kGroup;
  }
  for (int64_t i = done + tid; i < n; i += stride) x[i] = axpy(x[i], s, xi[i]);
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

unsigned grid(int64_t n, int vec, int64_t max_blocks) {
  const int64_t per_block = static_cast<int64_t>(kThreads) *
                            (vec ? kGroup : 1);
  const int64_t need = (n + per_block - 1) / per_block;
  return static_cast<unsigned>(need < max_blocks ? (need > 0 ? need : 1)
                                                 : max_blocks);
}

}  // namespace

// kind 0 (defect): f = out (f32), v = r (f64): out = (float) (r · scalar).
// kind 1 (update): v = x (f64, written), f = xi (f32): x ← x + scalar · xi.
// n rows, at most `max_blocks` blocks of 256 threads (the wrapper sizes the
// grid to the card). Launches on `stream` and returns the cudaError_t of the
// launch (0 = ok).
extern "C" int ir_f64_launch(int kind, int64_t n, int64_t max_blocks,
                             double scalar, void* v, void* f, void* stream) {
  if (kind < 0 || kind > 1 || n < 0 || max_blocks < 1 ||
      max_blocks > 0x7fffffff || v == nullptr || f == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = aligned(v) && aligned(f);
  const auto st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    defect_kernel<<<grid(n, vec, max_blocks), kThreads, 0, st>>>(
        n, vec, static_cast<const double*>(v), scalar, static_cast<float*>(f));
  else
    update_kernel<<<grid(n, vec, max_blocks), kThreads, 0, st>>>(
        n, vec, static_cast<double*>(v), scalar, static_cast<const float*>(f));
  return static_cast<int>(cudaGetLastError());
}
