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
// What bounds it: bytes. spmv and zjr move 8 B per row (one vector in, one
// out); residual, jacobi and cja move 12 B per row.
//
// Design: a 2.5D z-march. A block owns a tile of kTileY lines × kTileX
// columns and marches along z through `zchunk` planes. It keeps a ring of
// kSlots plane tiles in shared memory, each with a halo of hy lines and 4·hxc
// columns on every side: while it computes plane z from the resident planes
// z−1, z and z+1, cp.async keeps the next kDepth planes in flight, each
// landing in the slot that an earlier plane freed, with 16-byte copies where
// nx % 4 == 0 and the vectors are 16-byte aligned (else 4-byte copies).
// Each x element then comes from device memory about once, plus the halo
// lines and the two extra planes at the ends of a chunk. Out-of-grid cells are staged as zeros (the copy's zero fill), so
// the tap loop has no guards: an out-of-grid tap adds c_k·0, a zero, where
// the twin adds 0·x. The sums agree bit for bit up to the sign of a zero. Blocks whose tile, halo and z-chunk lie
// inside the grid stage without bound tests (the EDGE = false instance of
// the march); only the x halo columns are always tested.
//
// A thread computes 4 consecutive columns of one line: one 16-byte shared
// read per tap line, plus one scalar read on each side for the ±x taps. The
// 7-point and 27-point stencils, taps in ascending offset order, are
// compile-time tap tables (the launcher matches the taps against them); any
// other tap set with |dz| ≤ 1 and |dy|, |dx| ≤ 8 runs the general instance,
// which reads its taps from the parameter struct. The taps are summed in
// ascending k with explicit rounding (__fmul_rn, __fadd_rn, __fsub_rn; no
// fma contraction), as the plain PyTorch twin does. In cja, u = s·x + p is
// staged once per element, when its plane lands (it equals the twin's
// materialized u bit for bit), and the thread keeps its own centre x, which
// carries b, in a register for the epilogue. The centre vectors (b; and the
// output) move with 16-byte loads and stores on the vector path.
//
// The launch grid is 1-D: blockIdx.x = (chunk · tiles_y + tile_y) · tiles_x
// + tile_x, decoded once per block, so every grid size takes one launch. The
// wrapper (ops/const_stencil.py::plan) chooses zchunk so that the grid holds
// several blocks per SM.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 27;
constexpr int kLanesX = 32;             // threads across x: one warp
constexpr int kTileX = 4 * kLanesX;     // columns per tile, 4 per thread
constexpr int kTileY = 4;               // lines per tile
constexpr int kThreads = kLanesX * kTileY;
// planes in flight ahead of z + 1 (three measured slower on the H100 in a
// development run), and the ring: those and z − 1, z, z + 1
constexpr int kDepth = 1;
constexpr int kSlots = kDepth + 3;

struct Stencil {
  int ntaps;
  int dz[kMaxTaps];
  int dy[kMaxTaps];
  int dx[kMaxTaps];
  float c[kMaxTaps];
};

struct Grid {
  int nz, ny, nx;
  int zchunk;             // planes per block
  int tiles_x, tiles_y;
  int vec;                // 16-byte staging, centre loads and stores
};

// Tap tables in ascending offset order, (dz, dy, dx) lexicographic: the
// 7-point star and the 27-point box. Pattern 0 is the general instance.
__host__ __device__ constexpr int tap(int pat, int k, int axis) {
  if (pat == 27)
    return (axis == 0 ? k / 9 : axis == 1 ? (k / 3) % 3 : k % 3) - 1;
  // 7-point: (-1,0,0) (0,-1,0) (0,0,-1) (0,0,0) (0,0,1) (0,1,0) (1,0,0)
  return axis == 0 ? (k == 0 ? -1 : k == 6 ? 1 : 0)
       : axis == 1 ? (k == 1 ? -1 : k == 5 ? 1 : 0)
                   : (k == 2 ? -1 : k == 4 ? 1 : 0);
}

// halo lines (hy) and halo chunks of 4 columns (hxc) on each side
template <int PAT> struct Shape {
  static constexpr int hy = PAT == 0 ? 8 : 1;
  static constexpr int hxc = PAT == 0 ? 2 : 1;
  static constexpr int rows = kTileY + 2 * hy;
  static constexpr int chunks = kLanesX + 2 * hxc;   // per line
  static constexpr int width = 4 * chunks;            // floats per line
  static constexpr int plane = rows * width;          // floats per slot
  static constexpr int halo = 2 * hy * chunks + kTileY * 2 * hxc;
};

__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The (line, chunk) of a block's h-th halo chunk, and whether it lies in
// the x halo columns (bound-tested in every block).
template <int PAT>
__device__ __forceinline__ void halo_chunk(int h, int& row, int& chunk,
                                           bool& xhalo) {
  using S = Shape<PAT>;
  if (h < 2 * S::hy * S::chunks) {
    const int r = h / S::chunks;
    row = r < S::hy ? r : r + kTileY;
    chunk = h % S::chunks;
    xhalo = chunk < S::hxc || chunk >= S::hxc + kLanesX;
  } else {
    const int h2 = h - 2 * S::hy * S::chunks;
    row = S::hy + h2 / (2 * S::hxc);
    const int k = h2 % (2 * S::hxc);
    chunk = k < S::hxc ? k : k + kLanesX;
    xhalo = true;
  }
}

template <int MODE, int PAT, bool EDGE>
__device__ __forceinline__ void march(
    const Grid& g, const Stencil& st, float s, const float* __restrict__ x,
    const float* __restrict__ b, const float* __restrict__ p,
    float* __restrict__ out, int x0, int y0, int z0, int n, float* ring,
    float* pring) {
  using S = Shape<PAT>;
  const int tx = threadIdx.x % kLanesX, ty = threadIdx.x / kLanesX;

  // issue the copies of one 4-column chunk of plane zz into `slot`
  auto stage_chunk = [&](int zz, int slot, int row, int chunk, bool xhalo) {
    const int yy = y0 - S::hy + row, xx = x0 - 4 * S::hxc + 4 * chunk;
    const bool in_zy = !EDGE || (zz >= 0 && zz < g.nz && yy >= 0 &&
                                 yy < g.ny);
    const bool test_x = EDGE || xhalo;
    const int64_t off = (static_cast<int64_t>(zz) * g.ny + yy) * g.nx + xx;
    const int at = slot * S::plane + row * S::width + 4 * chunk;
    if (g.vec) {
      const bool ok = in_zy && (!test_x || (xx >= 0 && xx < g.nx));
      cp16(ring + at, ok ? x + off : x, ok);
      if constexpr (MODE == 4) cp16(pring + at, ok ? p + off : p, ok);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = in_zy && (!test_x || (xx + j >= 0 && xx + j < g.nx));
        cp4(ring + at + j, ok ? x + off + j : x, ok);
        if constexpr (MODE == 4) cp4(pring + at + j, ok ? p + off + j : p, ok);
      }
    }
  };
  auto stage = [&](int zz, int slot) {
    stage_chunk(zz, slot, S::hy + ty, S::hxc + tx, false);
    for (int h = threadIdx.x; h < S::halo; h += kThreads) {
      int row, chunk;
      bool xhalo;
      halo_chunk<PAT>(h, row, chunk, xhalo);
      stage_chunk(zz, slot, row, chunk, xhalo);
    }
  };
  // cja: u = s·x + p in place over the chunks this thread staged (its own
  // copies, complete after cp_wait); returns its centre x
  auto to_u = [&](int slot) {
    float4 centre = make_float4(0.f, 0.f, 0.f, 0.f);
    auto one = [&](int row, int chunk, float4* keep) {
      const int at = slot * S::plane + row * S::width + 4 * chunk;
      float4* q = reinterpret_cast<float4*>(ring + at);
      const float4 xv = *q;
      const float4 pv = *reinterpret_cast<const float4*>(pring + at);
      if (keep) *keep = xv;
      *q = make_float4(__fadd_rn(__fmul_rn(s, xv.x), pv.x),
                       __fadd_rn(__fmul_rn(s, xv.y), pv.y),
                       __fadd_rn(__fmul_rn(s, xv.z), pv.z),
                       __fadd_rn(__fmul_rn(s, xv.w), pv.w));
    };
    one(S::hy + ty, S::hxc + tx, &centre);
    for (int h = threadIdx.x; h < S::halo; h += kThreads) {
      int row, chunk;
      bool xhalo;
      halo_chunk<PAT>(h, row, chunk, xhalo);
      one(row, chunk, nullptr);
    }
    return centre;
  };

  const int yy = y0 + ty, xq = x0 + 4 * tx;
  const bool row_in = !EDGE || yy < g.ny;
  // the centre vector b of plane zz for this thread's 4 columns
  auto load_b = [&](int zz) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (!row_in) return v;
    const int64_t i = (static_cast<int64_t>(zz) * g.ny + yy) * g.nx + xq;
    if (g.vec) {
      if (!EDGE || xq < g.nx)
        v = __ldcs(reinterpret_cast<const float4*>(b + i));
    } else {
      if (!EDGE || xq + 0 < g.nx) v.x = __ldcs(b + i);
      if (!EDGE || xq + 1 < g.nx) v.y = __ldcs(b + i + 1);
      if (!EDGE || xq + 2 < g.nx) v.z = __ldcs(b + i + 2);
      if (!EDGE || xq + 3 < g.nx) v.w = __ldcs(b + i + 3);
    }
    return v;
  };

  // plane z0 − 1 + i lives in slot i % kSlots and lands with copy group i
  // (one group per plane, empty past the chunk's last plane z0 + n)
#pragma unroll
  for (int i = 0; i < kDepth + 2; ++i) {
    if (i <= n + 1) stage(z0 - 1 + i, i);
    cp_commit();
  }
  float4 b_cur = make_float4(0.f, 0.f, 0.f, 0.f), b_next = b_cur;
  float4 xc_cur = b_cur, xc_next = b_cur;
  if constexpr (MODE == 1 || MODE == 2) b_cur = load_b(z0);
  if constexpr (MODE == 4) {
    cp_wait<kDepth>();                      // planes z0 − 1 and z0
    to_u(0);
    xc_cur = to_u(1);
  }

  const int r = S::hy + ty, c = 4 * S::hxc + 4 * tx;
  for (int step = 0; step < n; ++step) {
    const int z = z0 + step;
    cp_wait<kDepth - 1>();                  // plane z + 1 has landed
    if constexpr (MODE == 4) xc_next = to_u((step + 2) % kSlots);
    __syncthreads();                        // and everyone is past z − 1
    const int ahead = step + kDepth + 2;    // into the slot of plane z − 2
    if (ahead <= n + 1) stage(z0 - 1 + ahead, ahead % kSlots);
    cp_commit();
    if constexpr (MODE == 1 || MODE == 2)
      if (step + 1 < n) b_next = load_b(z + 1);

    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    auto add = [&](float ck, float t0, float t1, float t2, float t3) {
      a0 = __fadd_rn(a0, __fmul_rn(ck, t0));
      a1 = __fadd_rn(a1, __fmul_rn(ck, t1));
      a2 = __fadd_rn(a2, __fmul_rn(ck, t2));
      a3 = __fadd_rn(a3, __fmul_rn(ck, t3));
    };
    if constexpr (PAT != 0) {
#pragma unroll
      for (int k = 0; k < PAT; ++k) {
        const int dz = tap(PAT, k, 0), dy = tap(PAT, k, 1),
                  dx = tap(PAT, k, 2);
        const float* q = ring + ((step + 1 + dz) % kSlots) * S::plane +
                         (r + dy) * S::width + c;
        const float4 v = *reinterpret_cast<const float4*>(q);
        if (dx < 0)
          add(st.c[k], q[-1], v.x, v.y, v.z);
        else if (dx > 0)
          add(st.c[k], v.y, v.z, v.w, q[4]);
        else
          add(st.c[k], v.x, v.y, v.z, v.w);
      }
    } else {
      for (int k = 0; k < st.ntaps; ++k) {
        const float* q = ring + ((step + 1 + st.dz[k]) % kSlots) * S::plane +
                         (r + st.dy[k]) * S::width + c + st.dx[k];
        add(st.c[k], q[0], q[1], q[2], q[3]);
      }
    }

    const float4 ctr = *reinterpret_cast<const float4*>(
        ring + ((step + 1) % kSlots) * S::plane + r * S::width + c);
    float4 y = make_float4(a0, a1, a2, a3);
    if constexpr (MODE == 1) {
      y = make_float4(__fsub_rn(b_cur.x, a0), __fsub_rn(b_cur.y, a1),
                      __fsub_rn(b_cur.z, a2), __fsub_rn(b_cur.w, a3));
    } else if constexpr (MODE == 2) {
      y = make_float4(
          __fadd_rn(ctr.x, __fmul_rn(s, __fsub_rn(b_cur.x, a0))),
          __fadd_rn(ctr.y, __fmul_rn(s, __fsub_rn(b_cur.y, a1))),
          __fadd_rn(ctr.z, __fmul_rn(s, __fsub_rn(b_cur.z, a2))),
          __fadd_rn(ctr.w, __fmul_rn(s, __fsub_rn(b_cur.w, a3))));
    } else if constexpr (MODE == 3) {
      y = make_float4(__fsub_rn(ctr.x, __fmul_rn(s, a0)),
                      __fsub_rn(ctr.y, __fmul_rn(s, a1)),
                      __fsub_rn(ctr.z, __fmul_rn(s, a2)),
                      __fsub_rn(ctr.w, __fmul_rn(s, a3)));
    } else if constexpr (MODE == 4) {   // ctr holds u
      y = make_float4(
          __fadd_rn(ctr.x, __fmul_rn(s, __fsub_rn(xc_cur.x, a0))),
          __fadd_rn(ctr.y, __fmul_rn(s, __fsub_rn(xc_cur.y, a1))),
          __fadd_rn(ctr.z, __fmul_rn(s, __fsub_rn(xc_cur.z, a2))),
          __fadd_rn(ctr.w, __fmul_rn(s, __fsub_rn(xc_cur.w, a3))));
    }
    if (row_in) {
      const int64_t i = (static_cast<int64_t>(z) * g.ny + yy) * g.nx + xq;
      if (g.vec) {
        if (!EDGE || xq < g.nx) __stcs(reinterpret_cast<float4*>(out + i), y);
      } else {
        if (!EDGE || xq + 0 < g.nx) __stcs(out + i, y.x);
        if (!EDGE || xq + 1 < g.nx) __stcs(out + i + 1, y.y);
        if (!EDGE || xq + 2 < g.nx) __stcs(out + i + 2, y.z);
        if (!EDGE || xq + 3 < g.nx) __stcs(out + i + 3, y.w);
      }
    }
    b_cur = b_next;
    xc_cur = xc_next;
  }
}

template <int MODE, int PAT>
__global__ void __launch_bounds__(kThreads) const_stencil_kernel(
    const __grid_constant__ Grid g, const __grid_constant__ Stencil st,
    float s, const float* __restrict__ x, const float* __restrict__ b,
    const float* __restrict__ p, float* __restrict__ out) {
  using S = Shape<PAT>;
  extern __shared__ float4 smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* pring = ring + kSlots * S::plane;   // cja only
  int blk = static_cast<int>(blockIdx.x);
  const int tile_x = blk % g.tiles_x;
  blk /= g.tiles_x;
  const int tile_y = blk % g.tiles_y;
  const int chunk = blk / g.tiles_y;
  const int x0 = tile_x * kTileX, y0 = tile_y * kTileY;
  const int z0 = chunk * g.zchunk;
  const int n = min(g.zchunk, g.nz - z0);
  const bool interior = z0 >= 1 && z0 + n + 1 <= g.nz && y0 >= S::hy &&
                        y0 + kTileY + S::hy <= g.ny && x0 + kTileX <= g.nx;
  if (interior)
    march<MODE, PAT, false>(g, st, s, x, b, p, out, x0, y0, z0, n, ring,
                            pring);
  else
    march<MODE, PAT, true>(g, st, s, x, b, p, out, x0, y0, z0, n, ring,
                           pring);
}

template <int MODE, int PAT>
int launch(const Grid& g, unsigned blocks, const Stencil& st, float s,
           const float* x, const float* b, const float* p, float* out,
           cudaStream_t stream) {
  const size_t smem = (MODE == 4 ? 2 : 1) * kSlots * Shape<PAT>::plane *
                      sizeof(float);
  auto* kernel = const_stencil_kernel<MODE, PAT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<blocks, kThreads, smem, stream>>>(g, st, s, x, b, p, out);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_pattern(int pat, const Grid& g, unsigned blocks, const Stencil& st,
                   float s, const float* x, const float* b, const float* p,
                   float* out, cudaStream_t stream) {
  switch (pat) {
    case 7: return launch<MODE, 7>(g, blocks, st, s, x, b, p, out, stream);
    case 27: return launch<MODE, 27>(g, blocks, st, s, x, b, p, out, stream);
    default: return launch<MODE, 0>(g, blocks, st, s, x, b, p, out, stream);
  }
}

bool matches(const Stencil& st, int pat) {
  if (st.ntaps != pat) return false;
  for (int k = 0; k < pat; ++k)
    if (st.dz[k] != tap(pat, k, 0) || st.dy[k] != tap(pat, k, 1) ||
        st.dx[k] != tap(pat, k, 2))
      return false;
  return true;
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `zchunk` is the planes per block (ops/const_stencil.py::plan). `taps`
// (ntaps × 3 int32, dz dy dx) and `coeffs` (ntaps float) are host arrays,
// copied into the kernel's parameter struct; every tap needs |dz| ≤ 1 and
// |dy|, |dx| ≤ 8. Pointers the mode does not read may be null; `out` must
// not alias x, b or p.
extern "C" int const_stencil_launch(int mode, int64_t nz, int64_t ny,
                                    int64_t nx, int64_t zchunk, int ntaps,
                                    const void* taps, const void* coeffs,
                                    float s, const void* x, const void* b,
                                    const void* p, void* out, void* stream) {
  constexpr int64_t kMaxDim = INT_MAX - 1024;
  if (nz < 0 || ny < 0 || nx < 0 || nz > kMaxDim || ny > kMaxDim ||
      nx > kMaxDim || zchunk < 1)
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
    st.c[k] = c[k];
    if (st.dz[k] < -1 || st.dz[k] > 1 || st.dy[k] < -8 || st.dy[k] > 8 ||
        st.dx[k] < -8 || st.dx[k] > 8)
      return cudaErrorInvalidValue;
  }
  const int pat = matches(st, 7) ? 7 : matches(st, 27) ? 27 : 0;
  Grid g{};
  g.nz = static_cast<int>(nz);
  g.ny = static_cast<int>(ny);
  g.nx = static_cast<int>(nx);
  g.zchunk = static_cast<int>(zchunk < nz ? zchunk : nz);
  g.tiles_x = static_cast<int>((nx + kTileX - 1) / kTileX);
  g.tiles_y = static_cast<int>((ny + kTileY - 1) / kTileY);
  const int64_t chunks = (nz + g.zchunk - 1) / g.zchunk;
  const int64_t blocks = chunks * g.tiles_x * g.tiles_y;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  g.vec = nx % 4 == 0 && aligned(x) && aligned(out) &&
          (b == nullptr || aligned(b)) && (p == nullptr || aligned(p));
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(b);
  const auto* pf = static_cast<const float*>(p);
  auto* of = static_cast<float*>(out);
  auto sm = static_cast<cudaStream_t>(stream);
  const auto nb = static_cast<unsigned>(blocks);
  switch (mode) {
    case 0: return launch_pattern<0>(pat, g, nb, st, s, xf, bf, pf, of, sm);
    case 1: return launch_pattern<1>(pat, g, nb, st, s, xf, bf, pf, of, sm);
    case 2: return launch_pattern<2>(pat, g, nb, st, s, xf, bf, pf, of, sm);
    case 3: return launch_pattern<3>(pat, g, nb, st, s, xf, bf, pf, of, sm);
    case 4: return launch_pattern<4>(pat, g, nb, st, s, xf, bf, pf, of, sm);
    default: return cudaErrorInvalidValue;
  }
}
