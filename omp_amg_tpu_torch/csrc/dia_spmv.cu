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
// The same kernel, instantiated on double, forms the certified loop's true
// residual r = b − A·x (mode 1; mode 0 for the z-slab mesh loop's shard
// products) from the user's operator in float64: f64 planes, x, b and out,
// an f64 accumulator (omp_amg_tpu_torch/ops/ir_f64.py). It replaces the
// loop's torch form, a padded copy of x and a multiply and an add per tap,
// each a full f64 vector: at 256³ 7-point about 6.3 GB a residual against
// the 1.34 GB of planes, x, b and r that one pass moves (0.40 ms at
// 3.35 TB/s). A 256² f64 plane of x is 512 KB, so the ±plane taps of a
// block still meet in L2. f64 takes the scalar path only: a warp's 8-byte
// loads already move whole 128-byte lines, and 16-byte loads gained
// nothing. On an NVIDIA H100 80GB HBM3 at 700.00 W the f64 spmv took
// 386.8 µs at 7-point 256³ (387.4 with R = 2 rows a thread, one 16-byte
// load a diagonal; 392.0 with R = 4, two) and 157.4 µs at 27-point 128³
// (164.2; 157.2), against bounds of 360 and 145.
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
// Taps are summed in ascending k from 0 with explicit rounding (no fma
// contraction), exactly as the plain twins (ops/dia_spmv.py::
// dia_spmv_plain, ops/ir_f64.py::dia_apply_f64) and the reference's
// spmv_dia do, so kernel and twin agree bit for bit on both paths; a
// skipped tap adds a zero, which changes no sum that starts from +0.

#include <cstdint>
#include <type_traits>

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

// each product and sum rounded on its own: no fma contraction
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

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

__device__ __forceinline__ void load_diag(const double* p, double (&d)[1]) {
  d[0] = __ldcs(p);
}

// R values at p (f32 and 16-byte aligned when R > 1).
template <int R, typename V>
__device__ __forceinline__ void load_rows(const V* p, V (&v)[R]) {
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

template <int R, typename V>
__device__ __forceinline__ void store_rows(V* p, const V (&v)[R]) {
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

// Rows [i0, i0 + R) of thread i0 / R; R = 1 is the scalar path. T is the
// planes' type, V the vectors' and the accumulator's: float for f32 and
// bf16 planes (both paths), double for f64 ones (the scalar path).
template <typename T, typename V, int MODE, int R>
__global__ void __launch_bounds__(kThreads) dia_spmv_kernel(
    int64_t n, const __grid_constant__ Offsets o, const T* __restrict__ data,
    const V* __restrict__ x, int64_t x_base, int64_t x_len,
    const V* __restrict__ b, const V* __restrict__ s, V* __restrict__ out) {
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * (kThreads * R);
  const int64_t r1 = r0 + kThreads * R < n ? r0 + kThreads * R : n;
  const int64_t i0 = r0 + static_cast<int64_t>(threadIdx.x) * R;
  if (i0 >= n) return;
  // every x read of every row of the block inside [0, x_len)? The vector
  // path reads whole 16-byte chunks: up to 3 values past a tap's last row.
  const bool interior = x_base + r0 + o.lo >= 0 &&
                        x_base + r1 + o.hi + (R > 1 ? 3 : -1) < x_len;
  V acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = V(0);
  if (!interior) {
    for (int k = 0; k < o.ndiag; ++k) {
      V d[R];
      load_diag(data + k * n + i0, d);
      const int64_t j = x_base + i0 + o.off[k];
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (j + r >= 0 && j + r < x_len)
          acc[r] = add(acc[r], mul(d[r], __ldg(x + j + r)));
    }
  } else {
    for (int k = 0; k < o.ndiag; ++k) {
      V d[R], xv[R];
      load_diag(data + k * n + i0, d);
      const int64_t j = x_base + i0 + o.off[k];
      if constexpr (R == 1) {
        xv[0] = __ldg(x + j);
      } else {
        load_x<R>(x, j, xv);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = add(acc[r], mul(d[r], xv[r]));
    }
  }
  if constexpr (MODE == 1) {
    V bv[R];
    load_rows<R>(b + i0, bv);
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = sub(bv[r], acc[r]);
  } else if constexpr (MODE == 2) {
    V bv[R], sv[R], xv[R];
    load_rows<R>(b + i0, bv);
    load_rows<R>(s + i0, sv);
    load_rows<R>(x + x_base + i0, xv);
#pragma unroll
    for (int r = 0; r < R; ++r)
      acc[r] = add(xv[r], mul(sv[r], sub(bv[r], acc[r])));
  }
  store_rows<R>(out + i0, acc);
}

template <typename T, typename V, int R>
cudaError_t launch_r(int mode, int64_t n, const Offsets& o, const T* data,
                     const V* x, int64_t x_base, int64_t x_len, const V* b,
                     const V* s, V* out, cudaStream_t stream) {
  const int64_t blocks = (n + kThreads * R - 1) / (kThreads * R);
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks));
  switch (mode) {
    case 0:
      dia_spmv_kernel<T, V, 0, R><<<grid, kThreads, 0, stream>>>(
          n, o, data, x, x_base, x_len, b, s, out);
      break;
    case 1:
      dia_spmv_kernel<T, V, 1, R><<<grid, kThreads, 0, stream>>>(
          n, o, data, x, x_base, x_len, b, s, out);
      break;
    case 2:
      if constexpr (std::is_same_v<V, double>) {  // f64: modes 0 and 1 only
        return cudaErrorInvalidValue;
      } else {
        dia_spmv_kernel<T, V, 2, R><<<grid, kThreads, 0, stream>>>(
            n, o, data, x, x_base, x_len, b, s, out);
      }
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
    return launch_r<T, float, 1>(mode, n, o, data, x, x_base, x_len, b, s,
                                 out, stream);
  constexpr int R = 16 / sizeof(T);
  if (n % R || x_base % R || !aligned16(data) || !aligned16(x) ||
      !aligned16(out) || (b && !aligned16(b)) || (s && !aligned16(s)))
    return cudaErrorMisalignedAddress;
  return launch_r<T, float, R>(mode, n, o, data, x, x_base, x_len, b, s, out,
                               stream);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `dtype` is the planes' type: 0 f32, 1 bf16 (x, b, s and out f32 for
// both), 2 f64 (x, b and out f64 too; modes 0 and 1). `offsets` is a host
// array of ndiag int32 values, copied into the kernel's parameter block.
// `vec` asks for the vector path (R rows per thread), which needs
// n % R == 0, x_base % R == 0 and 16-byte-aligned data, x, b, s and out
// (R = 8 for bf16 values, 4 for f32; f64 has the scalar path only); the
// scalar path takes any operands. Pointers the mode does not read may be
// null. x holds x_len values, and 0 <= x_base <= x_len − n.
extern "C" int dia_spmv_launch(int mode, int dtype, int vec, int64_t n,
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
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 2) {  // f64: the scalar path only
    err = vec ? cudaErrorInvalidValue
              : launch_r<double, double, 1>(
                    mode, n, o, static_cast<const double*>(data),
                    static_cast<const double*>(x), x_base, x_len,
                    static_cast<const double*>(b),
                    static_cast<const double*>(s), static_cast<double*>(out),
                    st);
  } else {
    const auto* xf = static_cast<const float*>(x);
    const auto* bf = static_cast<const float*>(b);
    const auto* sf = static_cast<const float*>(s);
    auto* of = static_cast<float*>(out);
    if (dtype == 1) {
      err = launch(mode, vec, n, o, static_cast<const __nv_bfloat16*>(data),
                   xf, x_base, x_len, bf, sf, of, st);
    } else if (dtype == 0) {
      err = launch(mode, vec, n, o, static_cast<const float*>(data), xf,
                   x_base, x_len, bf, sf, of, st);
    } else {
      err = cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(err);
}
