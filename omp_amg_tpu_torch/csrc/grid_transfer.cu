// Hand-written structured grid transfers for Hopper (sm_90a): restriction
// xc = R·xf, and prolongation P·xc or x + P·xc, over every coarsened axis of
// a grid of up to three axes in one pass.
//
// Replaces no TPU kernel. The reference computes these transfers outside
// Pallas (omp_amg_tpu/amg/structured.py: per-axis MXU matmuls on the TPU, a
// workaround for slow stride-2 slices there). The port carried them as
// per-axis torch slices, which stay as the plain twin
// (omp_amg_tpu_torch/amg/structured.py::apply_restrict, apply_prolong). On
// the H100 that form set the pace of the structured V-cycle: per coarsened
// axis a zeros_like, a cat, a stack, strided adds and a multiply on movedim'd
// views and a final copy, about 30 launches per level, each writing a full
// intermediate tensor.
//
// The operator: tensor-product linear interpolation on an (nz, ny, nx) grid,
// C order (a grid of fewer axes is padded with leading extents of 1, not
// coarsened). Along a coarsened axis the fine extent is 2·nc − 1 or 2·nc;
// fine i even takes coarse i/2, odd i takes ½(c[(i−1)/2] + c[(i+1)/2]), a
// missing right neighbour contributing 0 (Dirichlet). R = Pᵀ: coarse j takes
// f[2j] + ½(f[2j−1] + f[2j+1]), missing neighbours 0. Along an axis that is
// not coarsened both extents agree and values pass through.
//
// Arithmetic: the twin's, bit for bit. The twin applies the axes in order,
// axis 0 first, each step `even + 0.5·(left + right)` (restrict) or
// `0.5·(left + right)` (prolong) on the previous axis's result. The kernel
// evaluates the same nesting point by point with explicit rounding
// (__fadd_rn, __fmul_rn and their f64 forms: no contraction), and reads
// out-of-grid neighbours as 0, which every later step carries exactly as the
// twin's zero padding. Add mode adds x last, as x + (P·xc). f32 and f64.
//
// What bounds it: bytes. Restriction reads the fine vector once and writes
// the coarse one; prolongation reads the coarse vector and writes the fine
// one, and in add mode reads x besides.
//
// Design: a thread writes kWidth = 4 consecutive outputs along x of one
// line. A block is `lanes` × `rows` threads (a tile of 4·lanes columns ×
// rows lines, both adapted to the output's extents, at most kThreads) and
// marches along z through `zchunk` output planes. Restriction keeps the fine
// plane 2z + 1 of its three-plane neighbourhood in registers as the next
// output plane's plane 2(z + 1) − 1, so each fine plane comes from memory
// about once; it loads each fine line span of 9 columns as two 16-byte
// vectors plus one scalar column on the left, where extents and pointers
// allow. Prolongation reads the up to 2 × 2 coarse line spans of its output
// line (L1 and L2 serve the coarse vector's eightfold reuse) and, in add
// mode, x, and stores 16-byte vectors. The coarsened axes are template
// parameters, so the inner loops carry no per-axis branches.
//
// The launch grid is 1-D: blockIdx.x = (chunk · tiles_y + tile_y) · tiles_x
// + tile_x, and thread t is (t / lanes, t % lanes) in (line, column group).
// ops/grid_transfer.py::plan decides the launch (lanes, rows, zchunk, the
// tiles and the block count); the kernel only decodes, and block_tiles
// mirrors the decoding. A plan that covers too much is harmless: a thread
// outside the output writes nothing.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block, at most
constexpr int kWidth = 4;       // outputs per thread along x

struct Geom {
  int64_t fz, fy, fx;           // fine extents
  int64_t cz, cy, cx;           // coarse extents
  int64_t oz, oy, ox;           // output extents
  int64_t zchunk;               // output planes per block
  int64_t tiles_x, tiles_y;
  int lanes, rows;              // threads per block along x and along y
  int vec;                      // 16-byte loads and stores allowed
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float half(float a) { return __fmul_rn(0.5f, a); }
__device__ __forceinline__ double half(double a) { return __dmul_rn(0.5, a); }

// four values from a 16-byte aligned address, and back
__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void ld4(const double* p, double* v) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(double* p, const double* v) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}

// v[k] = line[c0 + k] where c0 + k lies in [0, n), else 0; a null `line`
// (a line outside the grid) gives zeros. The K − LEAD values from c0 + LEAD
// on (a multiple of 4 there) move as 16-byte vectors when `vec` allows and
// the span ends inside the line.
template <int K, int LEAD, typename T>
__device__ __forceinline__ void load_span(const T* __restrict__ line,
                                          int64_t c0, int64_t n, bool vec,
                                          T (&v)[K]) {
  if (line == nullptr) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = T(0);
    return;
  }
  if constexpr ((K - LEAD) % 4 == 0) {
    if (vec && c0 + K <= n) {
#pragma unroll
      for (int k = 0; k < LEAD; ++k)
        v[k] = c0 + k >= 0 ? __ldg(line + c0 + k) : T(0);
#pragma unroll
      for (int k = LEAD; k < K; k += 4) ld4(line + c0 + k, v + k);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int64_t c = c0 + k;
    v[k] = c >= 0 && c < n ? __ldg(line + c) : T(0);
  }
}

template <typename T>
__device__ __forceinline__ void store_span(T* __restrict__ line, int64_t x0,
                                           int64_t n, bool vec,
                                           const T (&o)[kWidth]) {
  if (vec && x0 + kWidth <= n) {
    st4(line + x0, o);
    return;
  }
#pragma unroll
  for (int m = 0; m < kWidth; ++m)
    if (x0 + m < n) line[x0 + m] = o[m];
}

// The block's tile and the thread's place in it; false for a thread whose
// line or columns lie outside the output.
struct Place {
  int64_t x0, y, z0, z1;
};

__device__ __forceinline__ bool place(const Geom& g, Place& p) {
  const int64_t b = blockIdx.x;
  const int64_t tile_x = b % g.tiles_x;
  const int64_t tile_y = b / g.tiles_x % g.tiles_y;
  p.z0 = b / (g.tiles_x * g.tiles_y) * g.zchunk;
  p.z1 = p.z0 + g.zchunk < g.oz ? p.z0 + g.zchunk : g.oz;
  p.x0 = (tile_x * g.lanes + static_cast<int>(threadIdx.x) % g.lanes) * kWidth;
  p.y = tile_y * g.rows + static_cast<int>(threadIdx.x) / g.lanes;
  return p.x0 < g.ox && p.y < g.oy;
}

// Restriction: out (cz, cy, cx) = R·xf.
template <typename T, bool CZ, bool CY, bool CX>
__global__ void __launch_bounds__(kThreads) restrict_kernel(
    const Geom g, const T* __restrict__ xf, T* __restrict__ out) {
  constexpr int NY = CY ? 3 : 1;                     // fine lines per line
  constexpr int NX = CX ? 2 * kWidth + 1 : kWidth;   // fine columns
  constexpr int LEAD = CX ? 1 : 0;
  Place p;
  if (!place(g, p)) return;
  const int64_t fc0 = CX ? 2 * p.x0 - 1 : p.x0;      // first fine column
  const int64_t fl0 = CY ? 2 * p.y - 1 : p.y;        // first fine line
  const bool vec = g.vec != 0;
  auto line = [&](int64_t z, int64_t l) -> const T* {
    return z >= 0 && z < g.fz && l >= 0 && l < g.fy
               ? xf + (z * g.fy + l) * g.fx : nullptr;
  };
  T lo[NY][NX];                                      // fine plane 2z − 1
  if constexpr (CZ) {
#pragma unroll
    for (int r = 0; r < NY; ++r)
      load_span<NX, LEAD>(line(2 * p.z0 - 1, fl0 + r), fc0, g.fx, vec, lo[r]);
  }
  for (int64_t z = p.z0; z < p.z1; ++z) {
    T s[NY][NX];                 // after the z step, on the NY fine lines
#pragma unroll
    for (int r = 0; r < NY; ++r) {
      if constexpr (CZ) {
        T mid[NX], hi[NX];
        load_span<NX, LEAD>(line(2 * z, fl0 + r), fc0, g.fx, vec, mid);
        load_span<NX, LEAD>(line(2 * z + 1, fl0 + r), fc0, g.fx, vec, hi);
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          s[r][k] = add(mid[k], half(add(lo[r][k], hi[k])));
          lo[r][k] = hi[k];
        }
      } else {
        load_span<NX, LEAD>(line(z, fl0 + r), fc0, g.fx, vec, s[r]);
      }
    }
    T t[NX];                     // after the y step
#pragma unroll
    for (int k = 0; k < NX; ++k) {
      if constexpr (CY)
        t[k] = add(s[1][k], half(add(s[0][k], s[2][k])));
      else
        t[k] = s[0][k];
    }
    T o[kWidth];                 // after the x step
#pragma unroll
    for (int m = 0; m < kWidth; ++m) {
      if constexpr (CX)
        o[m] = add(t[2 * m + 1], half(add(t[2 * m], t[2 * m + 2])));
      else
        o[m] = t[m];
    }
    store_span(out + (z * g.oy + p.y) * g.ox, p.x0, g.ox, vec, o);
  }
}

// Prolongation: out (fz, fy, fx) = P·xc, or x + P·xc where x is not null.
template <typename T, bool CZ, bool CY, bool CX>
__global__ void __launch_bounds__(kThreads) prolong_kernel(
    const Geom g, const T* __restrict__ xc, const T* __restrict__ x,
    T* __restrict__ out) {
  constexpr int NX = CX ? kWidth / 2 + 1 : kWidth;   // coarse columns
  Place p;
  if (!place(g, p)) return;
  const int64_t cc0 = CX ? p.x0 / 2 : p.x0;          // first coarse column
  const int64_t cl = CY ? p.y / 2 : p.y;             // first coarse line
  const bool y_odd = CY && (p.y & 1);
  const bool vec = g.vec != 0;
  auto line = [&](int64_t z, int64_t l) -> const T* {
    return z >= 0 && z < g.cz && l >= 0 && l < g.cy
               ? xc + (z * g.cy + l) * g.cx : nullptr;
  };
  for (int64_t z = p.z0; z < p.z1; ++z) {
    const int64_t cz = CZ ? z / 2 : z;
    const bool z_odd = CZ && (z & 1);
    T s[2][NX];                  // after the z step, on lines cl and cl + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (r == 1 && !y_odd) {
#pragma unroll
        for (int k = 0; k < NX; ++k) s[1][k] = T(0);   // not read
        break;
      }
      load_span<NX, 0>(line(cz, cl + r), cc0, g.cx, vec, s[r]);
      if (z_odd) {
        T hi[NX];
        load_span<NX, 0>(line(cz + 1, cl + r), cc0, g.cx, vec, hi);
#pragma unroll
        for (int k = 0; k < NX; ++k) s[r][k] = half(add(s[r][k], hi[k]));
      }
    }
    T t[NX];                     // after the y step
#pragma unroll
    for (int k = 0; k < NX; ++k)
      t[k] = y_odd ? half(add(s[0][k], s[1][k])) : s[0][k];
    T o[kWidth];                 // after the x step
    if constexpr (CX) {
      o[0] = t[0];
      o[1] = half(add(t[0], t[1]));
      o[2] = t[1];
      o[3] = half(add(t[1], t[2]));
    } else {
#pragma unroll
      for (int m = 0; m < kWidth; ++m) o[m] = t[m];
    }
    const int64_t row = (z * g.oy + p.y) * g.ox;
    if (x != nullptr) {
      T v[kWidth];
      load_span<kWidth, 0>(x + row, p.x0, g.ox, vec, v);
#pragma unroll
      for (int m = 0; m < kWidth; ++m) o[m] = add(v[m], o[m]);
    }
    store_span(out + row, p.x0, g.ox, vec, o);
  }
}

template <typename T, bool CZ, bool CY, bool CX>
cudaError_t launch(int kind, const Geom& g, unsigned blocks,
                   const void* in, const void* x, void* out,
                   cudaStream_t stream) {
  const unsigned threads = static_cast<unsigned>(g.lanes * g.rows);
  if (kind == 0)
    restrict_kernel<T, CZ, CY, CX><<<blocks, threads, 0, stream>>>(
        g, static_cast<const T*>(in), static_cast<T*>(out));
  else
    prolong_kernel<T, CZ, CY, CX><<<blocks, threads, 0, stream>>>(
        g, static_cast<const T*>(in), static_cast<const T*>(x),
        static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_axes(int mask, int kind, const Geom& g, unsigned blocks,
                        const void* in, const void* x, void* out,
                        cudaStream_t stream) {
  switch (mask) {
#define AXES(m)                                                            \
  case m:                                                                  \
    return launch<T, (m & 1) != 0, (m & 2) != 0, (m & 4) != 0>(            \
        kind, g, blocks, in, x, out, stream);
    AXES(0) AXES(1) AXES(2) AXES(3) AXES(4) AXES(5) AXES(6) AXES(7)
#undef AXES
    default:
      return cudaErrorInvalidValue;
  }
}

bool extents_ok(int64_t f, int64_t c, bool coarsened) {
  if (f < 1 || c < 1) return false;
  return coarsened ? f == 2 * c - 1 || f == 2 * c : f == c;
}

}  // namespace

// kind 0: restriction, out (coarse) = R·in (fine). kind 1: prolongation,
// out (fine) = P·in (coarse), or x + P·in where x is not null. f64 selects
// double over float. The grid is (fz, fy, fx) fine and (cz, cy, cx) coarse;
// bit k of `mask` marks axis k (0 = z) coarsened. The launch is
// ops/grid_transfer.py::plan's: `blocks` blocks of `lanes` × `rows`
// threads over `tiles_x` × `tiles_y` tiles, `zchunk` output planes per
// block. Launches on `stream` and returns the cudaError_t of the launch
// (0 = ok).
extern "C" int grid_transfer_launch(int kind, int f64, int64_t fz, int64_t fy,
                                    int64_t fx, int64_t cz, int64_t cy,
                                    int64_t cx, int mask, int lanes, int rows,
                                    int64_t zchunk, int64_t tiles_x,
                                    int64_t tiles_y, int64_t blocks,
                                    const void* in, const void* x, void* out,
                                    void* stream) {
  if (kind < 0 || kind > 1 || mask < 0 || mask > 7 || lanes < 1 ||
      rows < 1 || lanes * rows > kThreads || zchunk < 1 || tiles_x < 1 ||
      tiles_y < 1 || blocks < 1 || blocks > 0x7fffffff ||
      !extents_ok(fz, cz, mask & 1) || !extents_ok(fy, cy, mask & 2) ||
      !extents_ok(fx, cx, mask & 4) || (kind == 0 && x != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Geom g{};
  g.fz = fz; g.fy = fy; g.fx = fx;
  g.cz = cz; g.cy = cy; g.cx = cx;
  g.oz = kind == 0 ? cz : fz;
  g.oy = kind == 0 ? cy : fy;
  g.ox = kind == 0 ? cx : fx;
  g.lanes = lanes;
  g.rows = rows;
  g.zchunk = zchunk;
  g.tiles_x = tiles_x;
  g.tiles_y = tiles_y;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(in) |
                         reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(out);
  g.vec = addr % 16 == 0 && fx % 4 == 0 && cx % 4 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned nb = static_cast<unsigned>(blocks);
  const cudaError_t err =
      f64 ? launch_axes<double>(mask, kind, g, nb, in, x, out, s)
          : launch_axes<float>(mask, kind, g, nb, in, x, out, s);
  return static_cast<int>(err);
}
