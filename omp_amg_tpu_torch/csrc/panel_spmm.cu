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
// What bounds it: on paper bytes (A's nonzeros and indptr once, X and U
// once). On the H100 the gathers: every nonzero reads a whole X row (4·C
// bytes) through L1/L2, 27.3 M rows of 512 B for A₁·PV₁ at 128³, about 15
// times the bytes of the bound, and the rate at which the caches serve
// scattered rows sets the time (PERF.md). The design:
//
// - Vector lanes. Where 32 divides C (the probe's panels: C = 32·q), a lane
//   owns 4 consecutive columns, so one 16-byte load per nonzero fetches its
//   share of X's row and one 16-byte store writes U. A row takes 8q lanes
//   in a group of G = 8, 16, 32, 32 lanes (q = 1..4); 32 / G rows share a
//   warp. Any other C takes the general instance: a warp per row, lane l
//   owning columns l, l+32, l+64, l+96 below C with 4-byte loads.
// - Index batches. A row's group loads up to G (col, val) pairs in one
//   coalesced pass and hands them out with __shfl_sync, instead of every
//   lane loading every pair.
// - Pipelined gathers. The nonzero loop is unrolled by kUnroll = 4: four
//   X-row loads are issued before the adds consume them.
// - Cache policy. A's indices and values are streamed with evict-first
//   loads (__ldcs), U is stored with __stcs, and X goes through the
//   read-only path (__ldg), so that the 50 MB L2 is left to the X rows
//   that neighbouring rows re-read.
//
// The adds stay in CSR order with explicit rounding (__fmul_rn, __fadd_rn:
// no contraction into an FMA), so the kernel gives its plain twin's bits,
// and the GPU and CPU runs of the port build the same hierarchy. The loop
// over a group's batches runs to the longest row of the warp (a warp-uniform
// trip count, so the shuffles always name the whole warp); a shorter row's
// lanes skip the surplus steps.
//
// Index arithmetic is 64-bit: at 256³ rows × 128 columns exceeds int32.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// the vector instances ask for 6 resident blocks per SM: ptxas then gives
// them 40 registers and no spills. The register count moves the gathers'
// time by up to a fifth, and this bound was the fastest over the probe's
// operands (PERF.md; scripts/torch_panel_spmm_bounds.py times the others)
constexpr int kMinBlocks = 6;
constexpr int kMaxCols = 128;
constexpr int kUnroll = 4;        // X-row gathers in flight per lane
constexpr unsigned kWarp = 0xffffffffu;

__device__ __forceinline__ float4 fma4(float4 acc, float v, float4 x) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v, x.x)),
                     __fadd_rn(acc.y, __fmul_rn(v, x.y)),
                     __fadd_rn(acc.z, __fmul_rn(v, x.z)),
                     __fadd_rn(acc.w, __fmul_rn(v, x.w)));
}

// C = 32·Q: a row takes 8·Q lanes, 4 columns each, in a group of G lanes
template <int Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks) panel_spmm_vec_kernel(
    int64_t n_rows, const int64_t* __restrict__ indptr,
    const int32_t* __restrict__ indices, const float* __restrict__ vals,
    const float* __restrict__ x, float* __restrict__ u) {
  constexpr int C = 32 * Q, L = 8 * Q;
  constexpr int G = Q == 1 ? 8 : Q == 2 ? 16 : 32;
  constexpr int RPW = 32 / G;
  const int lane = threadIdx.x & 31, g = lane % G;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp * RPW >= n_rows) return;  // the same for all 32 lanes of a warp
  const int64_t row = warp * RPW + lane / G;
  const bool live = row < n_rows;
  int64_t j = live ? indptr[row] : 0;
  const int64_t end = live ? indptr[row + 1] : 0;
  const float4* xg = reinterpret_cast<const float4*>(x) + g;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (;; j += G) {
    const int cnt = static_cast<int>(end - j < G ? (end > j ? end - j : 0)
                                                 : G);
    const int most = static_cast<int>(
        __reduce_max_sync(kWarp, static_cast<unsigned>(cnt)));
    if (most == 0) break;
    int col = 0;
    float val = 0.0f;
    if (g < cnt) {
      col = __ldcs(indices + j + g);
      val = __ldcs(vals + j + g);
    }
    for (int t = 0; t < most; t += kUnroll) {
      float4 xs[kUnroll];
      float vs[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int c = __shfl_sync(kWarp, col, t + k, G);
        vs[k] = __shfl_sync(kWarp, val, t + k, G);
        xs[k] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t + k < cnt && g < L)
          xs[k] = __ldg(xg + static_cast<int64_t>(c) * (C / 4));
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (t + k < cnt) acc = fma4(acc, vs[k], xs[k]);
    }
  }
  if (live && g < L)
    __stcs(reinterpret_cast<float4*>(u + row * C) + g, acc);
}

// any C: a warp per row, lane l owns columns l + 32·q below C; each lane
// loads every (col, val) of the row (a broadcast) and its columns of X's
// row `col` with 4-byte loads, one nonzero at a time (with __ldcs on its
// broadcast (col, val) loads, or with the vector instances' bound, it ran
// slower: PERF.md)
__global__ void __launch_bounds__(kThreads) panel_spmm_any_kernel(
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

template <int Q>
void launch_vec(unsigned blocks, int64_t n_rows, const int64_t* indptr,
                const int32_t* indices, const float* vals, const float* x,
                float* u, cudaStream_t stream) {
  panel_spmm_vec_kernel<Q><<<blocks, kThreads, 0, stream>>>(
      n_rows, indptr, indices, vals, x, u);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `q` is the instance (ops/panel_spmm.py::lane_plan): C / 32 for the vector
// lanes, which need C == 32·q and 16-byte-aligned x and u, or 0 for the
// general instance.
extern "C" int panel_spmm_launch(int64_t n_rows, int32_t C, int32_t q,
                                 const void* indptr, const void* indices,
                                 const void* vals, const void* x, void* u,
                                 void* stream) {
  if (C < 1 || C > kMaxCols || q < 0 || q > 4 || (q > 0 && C != 32 * q))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q > 0 && (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(u) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_rows <= 0) return 0;
  const int rows_per_warp = q == 1 ? 4 : q == 2 ? 2 : 1;
  const int64_t rows_per_block = kThreads / 32 * rows_per_warp;
  const int64_t blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  if (blocks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const auto nb = static_cast<unsigned>(blocks);
  const auto* ip = static_cast<const int64_t*>(indptr);
  const auto* ix = static_cast<const int32_t*>(indices);
  const auto* v = static_cast<const float*>(vals);
  const auto* xf = static_cast<const float*>(x);
  auto* uf = static_cast<float*>(u);
  auto sm = static_cast<cudaStream_t>(stream);
  switch (q) {
    case 0:
      panel_spmm_any_kernel<<<nb, kThreads, 0, sm>>>(n_rows, C, ip, ix, v,
                                                     xf, uf);
      break;
    case 1: launch_vec<1>(nb, n_rows, ip, ix, v, xf, uf, sm); break;
    case 2: launch_vec<2>(nb, n_rows, ip, ix, v, xf, uf, sm); break;
    case 3: launch_vec<3>(nb, n_rows, ip, ix, v, xf, uf, sm); break;
    default: launch_vec<4>(nb, n_rows, ip, ix, v, xf, uf, sm);
  }
  return static_cast<int>(cudaGetLastError());
}
