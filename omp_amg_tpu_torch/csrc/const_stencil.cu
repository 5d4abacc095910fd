// Hand-written matrix-free constant-stencil SpMV for Hopper (sm_90a).
//
// Replaces omp_amg_tpu/ops/pallas_const.py::_const_kernel. It applies the
// finest level of a structured hierarchy, a Dirichlet-eliminated constant
// stencil on an (nz, ny, nx) grid: A[i, i + off_k] = c_k wherever tap k,
// (dz, dy, dx), stays inside the grid, and 0 elsewhere. No operator is
// stored or streamed. The modes are the TPU kernel's, with the algebra of
// its XLA fallbacks (x carries b in modes 3 and 4):
//
//   mode 0  spmv      out = A·x
//   mode 1  residual  out = b − A·x
//   mode 2  jacobi    out = x + s·(b − A·x)          (s = ω·D⁻¹, a scalar)
//   mode 3  zjr       out = x − s·(A·x)               (V(1,1) pre-smooth and
//                                                      residual from zero)
//   mode 4  cja       out = u + s·(x − A·u),  u = s·x + p
//                                                     (coarse correction and
//                                                      post-smooth)
//
// What bounds it: bytes only. spmv and zjr move 8 B per row (one vector in,
// one out); residual, jacobi and cja move 12 B per row. One thread per row;
// the neighbouring rows' taps hit x in L1/L2 (a 256×256 plane of x is
// 256 KB, so the ±1-plane taps of a block stay in the 50 MB L2). That cache
// reuse replaces the TPU kernel's VMEM plane ring; a tap's validity is
// index arithmetic on (z, y, x), which replaces its VMEM mask array.
//
// The taps with c_k != 0 arrive by value in a __grid_constant__ struct and
// are summed in ascending k with explicit rounding (__fmul_rn, __fadd_rn,
// __fsub_rn; no fma contraction), as the plain PyTorch twin does. A tap
// outside the grid is skipped, where the twin adds 0·x: the two agree bit
// for bit except for the sign of a zero. In cja, u is recomputed per tap as
// s·b[j] + p[j], which equals the twin's materialized u exactly.
//
// The launch grid carries each row's (z, y, x): blockIdx.z is the plane,
// blockIdx.y·kTileY + threadIdx.y the line in it, blockIdx.x·kTileX +
// threadIdx.x the column (a warp reads 32 consecutive floats). So no thread
// divides its row index; the extents and taps are int, and only the flat row
// index and its neighbour's are 64-bit, which serves every grid size. A grid
// with more than 65535 planes or line tiles takes one launch per chunk of
// them: the kernel stays straight-line (a grid-stride loop made 7-pt 256³
// spmv 1.6× slower on the H100), and real grids take one launch.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

// 128-thread tiles: with the 64-bit row index, 32×8 tiles of 256 threads
// ran 1.2–1.3× slower on the H100, 32×4 tiles as fast as an int32 index
constexpr int kTileX = 32;
constexpr int kTileY = 4;
constexpr int64_t kMaxGridYZ = 65535;
constexpr int kMaxTaps = 27;

struct Stencil {
  int ntaps;
  int dz[kMaxTaps];
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  long long off[kMaxTaps];  // (dz·ny + dy)·nx + dx
  float c[kMaxTaps];
};

// Rows (z0 + blockIdx.z, y0 + blockIdx.y·kTileY + threadIdx.y, x).
template <int MODE>
__global__ void __launch_bounds__(kTileX * kTileY) const_stencil_kernel(
    int nz, int ny, int nx, int z0, int y0,
    const __grid_constant__ Stencil st, float s,
    const float* __restrict__ x, const float* __restrict__ b,
    const float* __restrict__ p, float* __restrict__ out) {
  const int xi = blockIdx.x * kTileX + threadIdx.x;
  const int yi = y0 + blockIdx.y * kTileY + threadIdx.y;
  const int zi = z0 + blockIdx.z;
  if (xi >= nx || yi >= ny) return;
  const int64_t i = (static_cast<int64_t>(zi) * ny + yi) * nx + xi;
  float acc = 0.0f;
  // unrolled to the tap limit, so that the loads of all taps start before
  // the ordered sum consumes them
#pragma unroll
  for (int k = 0; k < kMaxTaps; ++k) {
    if (k >= st.ntaps) break;
    const int zz = zi + st.dz[k];
    const int yy = yi + st.dy[k];
    const int xx = xi + st.dx[k];
    if (zz < 0 || zz >= nz || yy < 0 || yy >= ny || xx < 0 || xx >= nx)
      continue;
    const int64_t j = i + st.off[k];
    float v = x[j];
    if constexpr (MODE == 4) v = __fadd_rn(__fmul_rn(s, v), p[j]);
    acc = __fadd_rn(acc, __fmul_rn(st.c[k], v));
  }
  float y = acc;
  if constexpr (MODE == 1) {
    y = __fsub_rn(b[i], acc);
  } else if constexpr (MODE == 2) {
    y = __fadd_rn(x[i], __fmul_rn(s, __fsub_rn(b[i], acc)));
  } else if constexpr (MODE == 3) {
    y = __fsub_rn(x[i], __fmul_rn(s, acc));
  } else if constexpr (MODE == 4) {
    const float u = __fadd_rn(__fmul_rn(s, x[i]), p[i]);
    y = __fadd_rn(u, __fmul_rn(s, __fsub_rn(x[i], acc)));
  }
  out[i] = y;
}

template <int MODE>
int launch_all(int nz, int ny, int nx, const Stencil& st, float s,
               const float* x, const float* b, const float* p, float* out,
               cudaStream_t stream) {
  const int64_t ytiles = (ny + kTileY - 1) / kTileY;
  const unsigned xtiles = static_cast<unsigned>((nx + kTileX - 1) / kTileX);
  for (int64_t z0 = 0; z0 < nz; z0 += kMaxGridYZ) {
    for (int64_t t0 = 0; t0 < ytiles; t0 += kMaxGridYZ) {
      const dim3 grid(xtiles,
                      static_cast<unsigned>(ytiles - t0 < kMaxGridYZ
                                                ? ytiles - t0 : kMaxGridYZ),
                      static_cast<unsigned>(nz - z0 < kMaxGridYZ
                                                ? nz - z0 : kMaxGridYZ));
      const_stencil_kernel<MODE><<<grid, dim3(kTileX, kTileY), 0, stream>>>(
          nz, ny, nx, static_cast<int>(z0), static_cast<int>(t0 * kTileY),
          st, s, x, b, p, out);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `taps` (ntaps × 3 int32, dz dy dx) and `coeffs` (ntaps float) are host
// arrays, copied into the kernel's parameter struct. Pointers the mode does
// not read may be null; `out` must not alias x, b or p.
extern "C" int const_stencil_launch(int mode, int64_t nz, int64_t ny,
                                    int64_t nx, int ntaps, const void* taps,
                                    const void* coeffs, float s,
                                    const void* x, const void* b,
                                    const void* p, void* out, void* stream) {
  if (nz < 0 || ny < 0 || nx < 0) return cudaErrorInvalidValue;
  if (nz > INT_MAX - 1 || ny > INT_MAX - kTileY || nx > INT_MAX - kTileX)
    return cudaErrorInvalidValue;
  if (nz * ny * nx == 0) return 0;
  if (ntaps < 0 || ntaps > kMaxTaps) return cudaErrorInvalidValue;
  Stencil st{};
  st.ntaps = ntaps;
  const auto* t = static_cast<const int32_t*>(taps);
  const auto* c = static_cast<const float*>(coeffs);
  for (int k = 0; k < ntaps; ++k) {
    st.dz[k] = t[3 * k];
    st.dy[k] = t[3 * k + 1];
    st.dx[k] = t[3 * k + 2];
    st.off[k] = (static_cast<long long>(st.dz[k]) * ny + st.dy[k]) * nx +
                st.dx[k];
    st.c[k] = c[k];
  }
  const int z = static_cast<int>(nz), y = static_cast<int>(ny),
            xn = static_cast<int>(nx);
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(b);
  const auto* pf = static_cast<const float*>(p);
  auto* of = static_cast<float*>(out);
  auto sm = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch_all<0>(z, y, xn, st, s, xf, bf, pf, of, sm);
    case 1: return launch_all<1>(z, y, xn, st, s, xf, bf, pf, of, sm);
    case 2: return launch_all<2>(z, y, xn, st, s, xf, bf, pf, of, sm);
    case 3: return launch_all<3>(z, y, xn, st, s, xf, bf, pf, of, sm);
    case 4: return launch_all<4>(z, y, xn, st, s, xf, bf, pf, of, sm);
    default: return cudaErrorInvalidValue;
  }
}
