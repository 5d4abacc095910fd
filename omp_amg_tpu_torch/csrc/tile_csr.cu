// Hand-written tiled-CSR SpMV for Hopper (sm_90a).
//
// Replaces no TPU kernel: it is a second form of csr_spmv.cu's product
// (itself the port of omp_amg_tpu/ops/pallas_routed.py::_kloop_kernel) for
// the operators whose rows are long and whose neighbouring rows share their
// columns: the coarse A of the classical (PMIS) hierarchy, 40–150 nonzeros
// a row. It has csr_spmv's four epilogues:
//
//   mode 0  spmv      out = A·x
//   mode 1  residual  out = b − A·x
//   mode 2  correct   out = v + A·x
//   mode 3  jacobi    out = x + s ⊙ (b − A·x)  (s = ω·D⁻¹ per row)
//
// The form (sparse/formats.py::TileCsr): rows are cut into tiles of
// consecutive rows; each tile lists the distinct global columns its rows
// touch, sorted (tile_cols[tile_ptr[t] ..]); each nonzero holds a 16-bit
// index into its tile's list; indptr and the values are the CSR's.
//
// What bounds csr_spmv on these operators: a bf16 nonzero streams a 4 B
// column index and a 2 B value, and gathers its x with its own load, an L2
// request of 32 B for 4 useful bytes, at the end of a dependent chain
// (indptr, index, x); a warp holds two rows' loads in flight. A coarse row
// reaches several coarse planes on either side, in short runs, so each x
// entry serves the rows of several grid lines around it, and a tile has to
// span many fine grid lines before its columns repeat: on the 256³ level-1
// A (PERF.md §6) tiles of 4 k nonzeros (~100 rows) hold 0.58 distinct
// columns a nonzero, of 16 k (~380 rows) 0.28, of 32 k 0.22.
//
// What this kernel does about it. One block takes one tile:
// - its x window x[tile_cols] (up to 6,144 columns, 24 KiB) lives in shared
//   memory for the whole tile: the column list arrives by 16-byte
//   asynchronous copies (cp.async), then every thread gathers its x entries
//   with independent loads, kGather at a time (the list is sorted, so
//   neighbouring threads read neighbouring addresses), in place;
// - then the warps go their own ways, with no barrier: each V-lane group
//   takes R = 2 rows at once (rows r and r + 256/V), loads their first
//   kBatch nonzeros a lane together (2 B indices and values, evict-first)
//   with their epilogue operands, and reads x from shared memory. The
//   chain of a step is index → shared x → fma, where csr_spmv's is index →
//   L2 gather → fma; the bounds of the next step's rows are in flight
//   while a step sums.
// The index costs 2 B a nonzero, the column list 4 B a distinct column.
// Measured on the way (PERF.md §6): staging the index and value stream in
// shared memory as well — through a ring of subtiles behind block
// barriers, or a ring per warp — cost more in bookkeeping and occupancy
// than it hid (1.06–10× slower than the direct stream); one row a lane
// group, or the next row's batch carried in registers, ran 5–15 % slower.
//
// The sums are csr_spmv's, bit for bit: V lanes serve a row (V from the
// same host rule), lane k sums the row's nonzeros k, k+V, k+2V, … in
// ascending order with fmaf (kBatch loaded at a time, summed in order),
// then the same shuffle tree of width V and the same explicitly rounded
// epilogue. Only where x is read from differs.
//
// Every row writes its output; output is never in place (jacobi reads
// other rows' x). The tiled form serves the single-device square
// operators, not the mesh's x windows (no x_base).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kGather = 8;      // x entries a thread gathers at once
constexpr int kBatch = 4;       // nonzeros a lane loads at once
constexpr int R = 2;            // rows a lane group serves at once
// 6 blocks an SM: 40 registers a thread, 48 warps (PERF.md §6: 8 blocks
// left 32 registers and slowed the residual and jacobi modes, 1 left 56–72)
constexpr int kMinBlocks = 6;

__device__ __forceinline__ float load_val(const float* p, int64_t j) {
  return __ldcs(p + j);
}

__device__ __forceinline__ float load_val(const __nv_bfloat16* p, int64_t j) {
  return __bfloat162float(__ldcs(p + j));
}

__host__ __device__ __forceinline__ int64_t up(int64_t v, int64_t k) {
  return (v + k - 1) / k * k;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

template <typename T, int MODE, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks) tile_csr_kernel(
    int64_t n_tiles, const int64_t* __restrict__ tile_rows,
    const int64_t* __restrict__ tile_ptr,
    const int32_t* __restrict__ tile_cols,
    const int64_t* __restrict__ indptr,
    const uint16_t* __restrict__ indices, const T* __restrict__ vals,
    const float* __restrict__ x, const float* __restrict__ v,
    const float* __restrict__ b, const float* __restrict__ s,
    float* __restrict__ out) {
  extern __shared__ __align__(16) float xs[];
  constexpr int kRows = kThreads / V;          // rows a block serves at once
  constexpr int kStep = R * kRows;

  const int64_t t = blockIdx.x;
  const int64_t r0 = tile_rows[t], r1 = tile_rows[t + 1];
  const int64_t c0 = tile_ptr[t];
  const int nu = static_cast<int>(tile_ptr[t + 1] - c0);
  const int64_t total = tile_ptr[n_tiles];

  // 1. the column list, in 16-byte pieces from an aligned start (a piece
  // past the list's end, or a list not 16-byte aligned, element by element)
  const int64_t ca = c0 / 4 * 4;
  const int off = static_cast<int>(c0 - ca);
  {
    auto* dst = reinterpret_cast<int32_t*>(xs);
    const bool aligned = (reinterpret_cast<uintptr_t>(tile_cols) & 15) == 0;
    const int64_t pieces = (up(c0 + nu, 4) - ca) / 4;
    for (int64_t c = threadIdx.x; c < pieces; c += kThreads) {
      const int64_t g = ca + 4 * c;
      if (aligned && g + 4 <= total) {
        cp_async16(dst + 4 * c, tile_cols + g);
      } else {
        for (int k = 0; k < 4 && g + k < total; ++k)
          dst[4 * c + k] = tile_cols[g + k];
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  // 2. the x window, in place of its column list: independent loads
  {
    const int32_t* cols = reinterpret_cast<const int32_t*>(xs) + off;
    for (int base = threadIdx.x; base < nu; base += kGather * kThreads) {
      int32_t c[kGather];
      float g[kGather];
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        const int i = base + k * kThreads;
        c[k] = i < nu ? cols[i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kGather; ++k) g[k] = __ldg(x + c[k]);
#pragma unroll
      for (int k = 0; k < kGather; ++k) {
        const int i = base + k * kThreads;
        if (i < nu) xs[off + i] = g[k];
      }
    }
  }
  __syncthreads();
  const float* xw = xs + off;

  // 3. the rows, each warp on its own; a lane group serves rows
  // first + sub + q·kRows (q < R) at once. Lanes 2q and 2q + 1 load row
  // q's bounds, a step ahead.
  const int sub = threadIdx.x / V;
  const int lane = threadIdx.x % V;
  auto bounds = [&](int64_t first) {
    long long bd = 0;
    if (lane < 2 * R) {
      const int64_t row = first + (lane / 2) * kRows + sub;
      if (row < r1) bd = __ldg(indptr + row + (lane & 1));
    }
    return bd;
  };
  long long bd = bounds(r0);
  for (int64_t first = r0; first < r1; first += kStep) {
    long long st[R], en[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      st[q] = __shfl_sync(kFull, bd, 2 * q, V);
      en[q] = __shfl_sync(kFull, bd, 2 * q + 1, V);
    }
    bd = bounds(first + kStep);
    float e0[R], e1[R], e2[R];   // the epilogue's operands (lane 0)
    int k[R][kBatch];
    float a[R][kBatch];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int64_t row = first + q * kRows + sub;
      e0[q] = e1[q] = e2[q] = 0.0f;
      if (lane == 0 && row < r1) {
        if constexpr (MODE == 1) {
          e0[q] = b[row];
        } else if constexpr (MODE == 2) {
          e0[q] = v[row];
        } else if constexpr (MODE == 3) {
          e0[q] = x[row];
          e1[q] = s[row];
          e2[q] = b[row];
        }
      }
#pragma unroll
      for (int m = 0; m < kBatch; ++m) {
        const long long p = st[q] + lane + m * V;
        k[q][m] = p < en[q] ? __ldcs(indices + p) : 0;
        a[q][m] = p < en[q] ? load_val(vals, p) : 0.0f;
      }
    }
    float acc[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      acc[q] = 0.0f;
#pragma unroll
      for (int m = 0; m < kBatch; ++m)
        if (st[q] + lane + m * V < en[q])
          acc[q] = fmaf(a[q][m], xw[k[q][m]], acc[q]);
      // a row longer than kBatch·V: the rest, kBatch at a time
      for (long long j = st[q] + lane + kBatch * V; j < en[q];
           j += kBatch * V) {
        int kk[kBatch];
        float aa[kBatch];
#pragma unroll
        for (int m = 0; m < kBatch; ++m) {
          const long long p = j + m * V;
          kk[m] = p < en[q] ? __ldcs(indices + p) : 0;
          aa[m] = p < en[q] ? load_val(vals, p) : 0.0f;
        }
#pragma unroll
        for (int m = 0; m < kBatch; ++m)
          if (j + m * V < en[q]) acc[q] = fmaf(aa[m], xw[kk[m]], acc[q]);
      }
    }
#pragma unroll
    for (int o = V / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int q = 0; q < R; ++q)
        acc[q] += __shfl_down_sync(kFull, acc[q], o, V);
    }
    if (lane != 0) continue;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int64_t row = first + q * kRows + sub;
      if (row >= r1) continue;
      float y = acc[q];
      // explicit rounding, as csr_spmv's epilogue
      if constexpr (MODE == 1) {
        y = __fsub_rn(e0[q], acc[q]);
      } else if constexpr (MODE == 2) {
        y = __fadd_rn(e0[q], acc[q]);
      } else if constexpr (MODE == 3) {
        y = __fadd_rn(e0[q], __fmul_rn(e1[q], __fsub_rn(e2[q], acc[q])));
      }
      out[row] = y;
    }
  }
}

template <typename T, int MODE, int V>
cudaError_t launch_kernel(int64_t n_tiles, int window,
                          const int64_t* tile_rows, const int64_t* tile_ptr,
                          const int32_t* tile_cols, const int64_t* indptr,
                          const uint16_t* indices, const T* vals,
                          const float* x, const float* v, const float* b,
                          const float* s, float* out, cudaStream_t stream) {
  auto kernel = tile_csr_kernel<T, MODE, V>;
  const int64_t smem = up(4 * (static_cast<int64_t>(window) + 8), 16);
  if (smem > 227 * 1024) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned>(n_tiles), kThreads,
           static_cast<size_t>(smem), stream>>>(
      n_tiles, tile_rows, tile_ptr, tile_cols, indptr, indices, vals, x, v,
      b, s, out);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_v(int mode, int64_t n_tiles, int window,
                     const int64_t* tile_rows, const int64_t* tile_ptr,
                     const int32_t* tile_cols, const int64_t* indptr,
                     const uint16_t* indices, const T* vals, const float* x,
                     const float* v, const float* b, const float* s,
                     float* out, cudaStream_t stream) {
#define TILE_CSR_MODE(M)                                                    \
  case M:                                                                   \
    return launch_kernel<T, M, V>(n_tiles, window, tile_rows, tile_ptr,  \
                                  tile_cols, indptr, indices, vals, x, v, b, \
                                  s, out, stream);
  switch (mode) {
    TILE_CSR_MODE(0)
    TILE_CSR_MODE(1)
    TILE_CSR_MODE(2)
    TILE_CSR_MODE(3)
    default:
      return cudaErrorInvalidValue;
  }
#undef TILE_CSR_MODE
}

template <typename T>
cudaError_t launch(int mode, int vec, int64_t n_tiles, int window,
                   const int64_t* tile_rows, const int64_t* tile_ptr,
                   const int32_t* tile_cols, const int64_t* indptr,
                   const uint16_t* indices, const T* vals, const float* x,
                   const float* v, const float* b, const float* s,
                   float* out, cudaStream_t stream) {
  switch (vec) {
    case 8:
      return launch_v<T, 8>(mode, n_tiles, window, tile_rows, tile_ptr,
                            tile_cols, indptr, indices, vals, x, v, b, s, out,
                            stream);
    case 16:
      return launch_v<T, 16>(mode, n_tiles, window, tile_rows, tile_ptr,
                             tile_cols, indptr, indices, vals, x, v, b, s,
                             out, stream);
    case 32:
      return launch_v<T, 32>(mode, n_tiles, window, tile_rows, tile_ptr,
                             tile_cols, indptr, indices, vals, x, v, b, s,
                             out, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` one block per tile and returns the cudaError_t of
// the launch (0 = ok). `vec` is the lanes per row (8, 16 or 32), `window`
// the most distinct columns of a tile (the block's shared memory holds
// that many x entries). Pointers the mode does not read may be null.
extern "C" int tile_csr_launch(int mode, int val_bf16, int vec,
                               int64_t n_tiles, int window,
                               const void* tile_rows, const void* tile_ptr,
                               const void* tile_cols, const void* indptr,
                               const void* indices, const void* vals,
                               const void* x, const void* v, const void* b,
                               const void* s, void* out, void* stream) {
  if (n_tiles <= 0) return 0;
  if (n_tiles > 0x7fffffff) return static_cast<int>(
      cudaErrorInvalidConfiguration);
  const auto* tr = static_cast<const int64_t*>(tile_rows);
  const auto* tp = static_cast<const int64_t*>(tile_ptr);
  const auto* tc = static_cast<const int32_t*>(tile_cols);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const uint16_t*>(indices);
  const auto* xf = static_cast<const float*>(x);
  const auto* vf = static_cast<const float*>(v);
  const auto* bf = static_cast<const float*>(b);
  const auto* sf = static_cast<const float*>(s);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (val_bf16) {
    err = launch(mode, vec, n_tiles, window, tr, tp, tc, ip, ix,
                 static_cast<const __nv_bfloat16*>(vals), xf, vf, bf, sf, of,
                 st);
  } else {
    err = launch(mode, vec, n_tiles, window, tr, tp, tc, ip, ix,
                 static_cast<const float*>(vals), xf, vf, bf, sf, of, st);
  }
  return static_cast<int>(err);
}
