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
// and s in the fused modes). The TPU kernel rolls z-planes of x through a
// VMEM ring so that x is read from HBM once; here L2 reuse does that job:
// the ±1-plane taps of neighbouring rows touch the same few planes of x,
// which stay in the 50 MB L2 (a 128×128 plane is 64 KB).
//
// The first version of this kernel, a thread per row with a 2-byte load, an
// int64 offset loaded from device memory and a 64-bit bounds check per tap,
// was bound by instructions: 35.7 µs against a bound of 13.8 on the 2M-row
// bf16 7-point level (NVIDIA H100 80GB HBM3, 700.00 W). Two changes serve
// every operator:
// the offsets travel by value, as int32, in the parameter block, so no
// block loads them; and one predicate per block says whether every x read
// of every row of the block lies in [0, x_len), so interior blocks run
// without a per-tap guard and only the edge blocks test each tap.
//
// The vector path adds 16-byte loads: each thread computes R consecutive
// rows, R = 8 for bf16 and 4 for f32, and loads each diagonal's R values
// with one 16-byte load. x is read in aligned 16-byte chunks: R/4 + 1 of
// them from the tap's start rounded down to a multiple of 4, and a register
// select by the start's remainder, the same for the whole grid, picks the
// R values (±1 and the 27-point corners are not aligned; an x tile staged
// in shared memory for them measured no faster). It needs n % R == 0,
// x_base % R == 0 and 16-byte-aligned data, x, b, s and out. A thread then
// does R times the work in series, which pays only where the grid still
// fills the card: on an NVIDIA H100 80GB HBM3 at 700.00 W the 2M-row bf16
// 7-point level took 24.9 µs on the vector path against 29.7 on the scalar
// one, but the 262,144-row bf16 27-point level 23.8 against 14.5. So the
// caller (ops/dia_spmv.py::vector_path) takes the vector path where the
// n / R threads number at least 512 per SM, and the scalar path (R = 1, a
// thread per row, the same offsets, predicate and guards) elsewhere.
//
// x may be a window longer than the n rows: row i's tap k reads
// x[x_base + i + offsets[k]] where that index lies in [0, x_len), and skips
// the tap elsewhere, so x is never read out of range, even where the data
// is 0. A single-device product is x_base = 0, x_len = n; a z-slab shard of
// the distributed path reads its exchanged window [left halo | own rows |
// right halo] at x_base = the left halo's length (omp_amg_tpu/parallel/
// slab.py's shard-local rows()), or the whole vector at x_base = its first
// row.
//
// Taps are summed in ascending k with explicit rounding (no fma
// contraction), exactly as the plain twin and the reference's spmv_dia do,
// so kernel and twin agree bit for bit on both paths.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDiag = 64;
struct Offsets {
  int ndiag;
  int lo, hi;  // the least and the greatest offset (0 when ndiag = 0)
  int off[kMaxDiag];
};

// R consecutive values of one diagonal as f32: one 16-byte load.
__device__ __forceinline__ void load_diag(const float* p, float (&d)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
  d[0] = q.x;
  d[1] = q.y;
  d[2] = q.z;
  d[3] = q.w;
}

__device__ __forceinline__ void load_diag(const __nv_bfloat16* p,
                                          float (&d)[8]) {
  const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int h = 0; h < 4; ++h) {  // bf16 → f32 is exact: the high 16 bits
    d[2 * h] = __uint_as_float(w[h] << 16);
    d[2 * h + 1] = __uint_as_float(w[h] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load_diag(const float* p, float (&d)[1]) {
  d[0] = __ldcs(p);
}

__device__ __forceinline__ void load_diag(const __nv_bfloat16* p,
                                          float (&d)[1]) {
  d[0] = __bfloat162float(__ldcs(p));
}

// R f32 values at p (16-byte aligned when R > 1).
template <int R>
__device__ __forceinline__ void load_f32(const float* p, float (&v)[R]) {
  if constexpr (R == 1) {
    v[0] = *p;
  } else {
#pragma unroll
    for (int c = 0; c < R / 4; ++c) {
      const float4 q = reinterpret_cast<const float4*>(p)[c];
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
  }
}

template <int R>
__device__ __forceinline__ void store_f32(float* p, const float (&v)[R]) {
  if constexpr (R == 1) {
    *p = v[0];
  } else {
#pragma unroll
    for (int c = 0; c < R / 4; ++c)
      reinterpret_cast<float4*>(p)[c] =
          make_float4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
  }
}

// x[j .. j + R) for a 16-byte-aligned x: R/4 + 1 aligned chunks from j
// rounded down to a multiple of 4, then a select by m = j % 4 (the same for
// every thread of a tap, so the warp never diverges on it).
template <int R>
__device__ __forceinline__ void load_x(const float* __restrict__ x,
                                       int64_t j, float (&xv)[R]) {
  constexpr int kChunks = R / 4 + 1;
  const int m = static_cast<int>(j & 3);
  const float4* p = reinterpret_cast<const float4*>(x + (j - m));
  float w[4 * kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const float4 q = __ldg(p + c);
    w[4 * c] = q.x;
    w[4 * c + 1] = q.y;
    w[4 * c + 2] = q.z;
    w[4 * c + 3] = q.w;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lo = (m & 1) ? w[r + 1] : w[r];
    const float hi = (m & 1) ? w[r + 3] : w[r + 2];
    xv[r] = (m & 2) ? hi : lo;
  }
}

// Rows [i0, i0 + R) of thread i0 / R; R = 1 is the scalar path.
template <typename T, int MODE, int R>
__global__ void __launch_bounds__(kThreads) dia_spmv_kernel(
    int64_t n, const __grid_constant__ Offsets o, const T* __restrict__ data,
    const float* __restrict__ x, int64_t x_base, int64_t x_len,
    const float* __restrict__ b, const float* __restrict__ s,
    float* __restrict__ out) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * (kThreads * R);
  const int64_t r1 = r0 + kThreads * R < n ? r0 + kThreads * R : n;
  const int64_t i0 = r0 + static_cast<int64_t>(threadIdx.x) * R;
  if (i0 >= n) return;
  // every x read of every row of the block inside [0, x_len)? The vector
  // path reads whole 16-byte chunks: up to 3 values past a tap's last row.
  const bool interior = x_base + r0 + o.lo >= 0 &&
                        x_base + r1 + o.hi + (R > 1 ? 3 : -1) < x_len;
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  if (!interior) {
    for (int k = 0; k < o.ndiag; ++k) {
      float d[R];
      load_diag(data + k * n + i0, d);
      const int64_t j = x_base + i0 + o.off[k];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j + r >= 0 && j + r < x_len)
          acc[r] = __fadd_rn(acc[r], __fmul_rn(d[r], __ldg(x + j + r)));
    }
  } else {
    for (int k = 0; k < o.ndiag; ++k) {
      float d[R], xv[R];
      load_diag(data + k * n + i0, d);
      const int64_t j = x_base + i0 + o.off[k];
      if constexpr (R == 1) {
        xv[0] = __ldg(x + j);
      } else {
        load_x<R>(x, j, xv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = __fadd_rn(acc[r], __fmul_rn(d[r], xv[r]));
    }
  }
  if constexpr (MODE == 1) {
    float bv[R];
    load_f32<R>(b + i0, bv);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = __fsub_rn(bv[r], acc[r]);
  } else if constexpr (MODE == 2) {
    float bv[R], sv[R], xv[R];
    load_f32<R>(b + i0, bv);
    load_f32<R>(s + i0, sv);
    load_f32<R>(x + x_base + i0, xv);
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = __fadd_rn(xv[r], __fmul_rn(sv[r], __fsub_rn(bv[r], acc[r])));
  }
  store_f32<R>(out + i0, acc);
}

template <typename T, int R>
cudaError_t launch_r(int mode, int64_t n, const Offsets& o, const T* data,
                     const float* x, int64_t x_base, int64_t x_len,
                     const float* b, const float* s, float* out,
                     cudaStream_t stream) {
  const int64_t blocks = (n + kThreads * R - 1) / (kThreads * R);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (mode) {
    case 0:
      dia_spmv_kernel<T, 0, R><<<grid, kThreads, 0, stream>>>(
          n, o, data, x, x_base, x_len, b, s, out);
      break;
    case 1:
      dia_spmv_kernel<T, 1, R><<<grid, kThreads, 0, stream>>>(
          n, o, data, x, x_base, x_len, b, s, out);
      break;
    case 2:
      dia_spmv_kernel<T, 2, R><<<grid, kThreads, 0, stream>>>(
          n, o, data, x, x_base, x_len, b, s, out);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
cudaError_t launch(int mode, int vec, int64_t n, const Offsets& o,
                   const T* data, const float* x, int64_t x_base,
                   int64_t x_len, const float* b, const float* s, float* out,
                   cudaStream_t stream) {
  if (!vec)
    return launch_r<T, 1>(mode, n, o, data, x, x_base, x_len, b, s, out,
                          stream);
  constexpr int R = 16 / sizeof(T);
  if (n % R || x_base % R || !aligned16(data) || !aligned16(x) ||
      !aligned16(out) || (b && !aligned16(b)) || (s && !aligned16(s)))
    return cudaErrorMisalignedAddress;
  return launch_r<T, R>(mode, n, o, data, x, x_base, x_len, b, s, out,
                        stream);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `offsets` is a host array of ndiag int32 values, copied into the kernel's
// parameter block. `vec` asks for the vector path (R rows per thread), which
// needs n % R == 0, x_base % R == 0 and 16-byte-aligned data, x, b, s and
// out (R = 8 for bf16 values, 4 for f32); the scalar path takes any
// operands. Pointers the mode does not read may be null. x holds x_len
// values, and 0 <= x_base <= x_len − n.
extern "C" int dia_spmv_launch(int mode, int val_bf16, int vec, int64_t n,
                               int ndiag, const void* offsets,
                               const void* data, const void* x,
                               int64_t x_base, int64_t x_len, const void* b,
                               const void* s, void* out, void* stream) {
  if (n <= 0) return 0;
  if (ndiag < 0 || ndiag > kMaxDiag) return cudaErrorInvalidValue;
  if (x_base < 0 || x_base > x_len - n) return cudaErrorInvalidValue;
  Offsets o{};
  o.ndiag = ndiag;
  const auto* off = static_cast<const int32_t*>(offsets);
  for (int k = 0; k < ndiag; ++k) {
    o.off[k] = off[k];
    if (k == 0 || off[k] < o.lo) o.lo = off[k];
    if (k == 0 || off[k] > o.hi) o.hi = off[k];
  }
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(b);
  const auto* sf = static_cast<const float*>(s);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (val_bf16) {
    err = launch(mode, vec, n, o, static_cast<const __nv_bfloat16*>(data),
                 xf, x_base, x_len, bf, sf, of, st);
  } else {
    err = launch(mode, vec, n, o, static_cast<const float*>(data), xf,
                 x_base, x_len, bf, sf, of, st);
  }
  return static_cast<int>(err);
}
