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
// x may be a window longer than the operator's rows (a shard of the
// row-sharded PMIS path reads [left halo | own rows | right halo]): the
// column indices address the window, and jacobi reads row i's own x at
// x[x_base + i]. x_base = 0 over a square operator is the single-device
// product.
//
// Values are f32 or bf16 (converted with __bfloat162float); x, v, b, s and
// out are f32, and every row sums in f32.
//
// What bounds it: bytes. Each nonzero streams a 4 B column index and a 4 B
// (f32) or 2 B (bf16) value, each row 8 B of indptr and 4 B of output, plus
// the gather of x: about 8–12 B per nonzero. The TPU kernel's routed chunk
// layout exists because gathers are slow on the TPU; on Hopper a gather is
// an ordinary load (x of a coarse level sits in the 50 MB L2), so plain CSR
// is the layout.
//
// The rows of one operator are of similar length but differ between
// operators by 25×: a P row holds 4–6 nonzeros, a coarse A row 40–150 (the
// 128³ PMIS hierarchy). So V lanes serve each row, V a power of two from 1
// to 32 chosen per operator by the caller, and a warp serves 32 / V rows. A
// fixed warp per row left 26 of 32 lanes idle on every P row. Every lane of
// a row pays the row's fixed work (bounds, shuffles, epilogue), so the
// caller's rule (Csr.vec) gives each lane about two nonzeros: V is the
// largest power of two ≤ half the mean row length. On an NVIDIA H100 80GB
// HBM3 at 700.00 W that was the fastest V on each of the 128³ hierarchy's
// seven operators above 50 k rows, and a lane per nonzero (V ≥ the mean
// row length) ran 1.2–1.9× slower wherever it chose another width (P₀:
// 53.6 µs at V = 2 against 103.9 at V = 8). The V lanes stride the
// row, so neighbouring lanes read neighbouring index and value words; each
// lane takes two nonzeros per step, both loads issued before either gather,
// to keep more loads in flight on the wide rows. Lanes 0 and 1 of a row read
// its bounds and shuffle them to the others. Column indices and values are
// read once (ld.global.cs, evict first), so they do not push x out of the
// caches; x is read through the read-only path (__ldg).
//
// The row sum is a fixed shuffle tree of width V (__shfl_down_sync), each
// lane's partial summed in ascending position: no atomics, so every run
// gives the same bits. Every row writes its output, empty rows and rows
// shorter than V included. Output is never in place: jacobi reads other
// rows' x.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load_val(const float* p, int64_t j) {
  return __ldcs(p + j);
}

__device__ __forceinline__ float load_val(const __nv_bfloat16* p, int64_t j) {
  return __bfloat162float(__ldcs(p + j));
}

template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads) csr_spmv_kernel(
    int64_t n_rows, int64_t x_base, const int64_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const T* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ b, const float* __restrict__ s,
    float* __restrict__ out) {
  constexpr int kRows = kThreads / V;  // rows per block
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRows;
  // a warp whose rows all lie past the end leaves; the others keep every
  // lane for the shuffles
  if (first + (threadIdx.x & ~31) / V >= n_rows) return;
  const int64_t row = first + threadIdx.x / V;
  const int lane = threadIdx.x % V;
  const bool valid = row < n_rows;
  long long start = 0, end = 0;
  if constexpr (V == 1) {  // no shuffles: a row past the end leaves
    if (!valid) return;
    start = __ldg(indptr + row);
    end = __ldg(indptr + row + 1);
  } else {
    long long bound = 0;
    if (valid && lane < 2) bound = __ldg(indptr + row + lane);
    start = __shfl_sync(kFull, bound, 0, V);
    end = __shfl_sync(kFull, bound, 1, V);
  }
  float acc = 0.0f;
  long long j = start + lane;
  for (; j + V < end; j += 2 * V) {
    const int c0 = __ldcs(indices + j);
    const int c1 = __ldcs(indices + j + V);
    const float a0 = load_val(vals, j);
    const float a1 = load_val(vals, j + V);
    acc = fmaf(a0, __ldg(x + c0), acc);
    acc = fmaf(a1, __ldg(x + c1), acc);
  }
  if (j < end) acc = fmaf(load_val(vals, j), __ldg(x + __ldcs(indices + j)),
                          acc);
#pragma unroll
  for (int off = V / 2; off > 0; off >>= 1)
    acc += __shfl_down_sync(kFull, acc, off, V);
  if (lane != 0 || !valid) return;
  float y = acc;
  // explicit rounding: the epilogue gives the plain twin's bits for a
  // given row sum (no contraction into an fma)
  if constexpr (MODE == 1) {
    y = __fsub_rn(b[row], acc);
  } else if constexpr (MODE == 2) {
    y = __fadd_rn(v[row], acc);
  } else if constexpr (MODE == 3) {
    y = __fadd_rn(x[x_base + row],
                  __fmul_rn(s[row], __fsub_rn(b[row], acc)));
  }
  out[row] = y;
}

template <typename T, int V>
cudaError_t launch_v(int mode, int64_t n_rows, int64_t x_base,
                     const int64_t* indptr,
                     const int32_t* indices, const T* vals, const float* x,
                     const float* v, const float* b, const float* s,
                     float* out, cudaStream_t stream) {
  constexpr int kRows = kThreads / V;
  const int64_t blocks = (n_rows + kRows - 1) / kRows;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (mode) {
    case 0:
      csr_spmv_kernel<T, 0, V><<<grid, kThreads, 0, stream>>>(
          n_rows, x_base, indptr, indices, vals, x, v, b, s, out);
      break;
    case 1:
      csr_spmv_kernel<T, 1, V><<<grid, kThreads, 0, stream>>>(
          n_rows, x_base, indptr, indices, vals, x, v, b, s, out);
      break;
    case 2:
      csr_spmv_kernel<T, 2, V><<<grid, kThreads, 0, stream>>>(
          n_rows, x_base, indptr, indices, vals, x, v, b, s, out);
      break;
    case 3:
      csr_spmv_kernel<T, 3, V><<<grid, kThreads, 0, stream>>>(
          n_rows, x_base, indptr, indices, vals, x, v, b, s, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int mode, int vec, int64_t n_rows, int64_t x_base,
                   const int64_t* indptr, const int32_t* indices,
                   const T* vals, const float* x,
                   const float* v, const float* b, const float* s, float* out,
                   cudaStream_t stream) {
  switch (vec) {
    case 1:
      return launch_v<T, 1>(mode, n_rows, x_base, indptr, indices, vals, x,
                            v, b, s, out, stream);
    case 2:
      return launch_v<T, 2>(mode, n_rows, x_base, indptr, indices, vals, x,
                            v, b, s, out, stream);
    case 4:
      return launch_v<T, 4>(mode, n_rows, x_base, indptr, indices, vals, x,
                            v, b, s, out, stream);
    case 8:
      return launch_v<T, 8>(mode, n_rows, x_base, indptr, indices, vals, x,
                            v, b, s, out, stream);
    case 16:
      return launch_v<T, 16>(mode, n_rows, x_base, indptr, indices, vals, x,
                             v, b, s, out, stream);
    case 32:
      return launch_v<T, 32>(mode, n_rows, x_base, indptr, indices, vals, x,
                             v, b, s, out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `vec` is the lanes per row, a power of two from 1 to 32; `x_base` the
// position of row 0's own x in x (jacobi only). Pointers the mode does not
// read may be null.
extern "C" int csr_spmv_launch(int mode, int val_bf16, int vec,
                               int64_t n_rows, int64_t x_base,
                               const void* indptr, const void* indices,
                               const void* vals,
                               const void* x, const void* v, const void* b,
                               const void* s, void* out, void* stream) {
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
    err = launch(mode, vec, n_rows, x_base, ip, ix,
                 static_cast<const __nv_bfloat16*>(vals), xf, vf, bf, sf, of,
                 st);
  } else {
    err = launch(mode, vec, n_rows, x_base, ip, ix,
                 static_cast<const float*>(vals), xf, vf, bf, sf, of, st);
  }
  return static_cast<int>(err);
}
