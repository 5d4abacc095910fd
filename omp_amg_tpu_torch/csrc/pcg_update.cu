// Hand-written PCG vector updates for Hopper (sm_90a), in place and masked
// by the device's active flag:
//
//   xr:  x ← x + α·p and r ← r − α·q in one pass;
//   p:   p ← z + β·p.
//
// Replaces no TPU kernel. The reference's PCG updates are plain jnp inside
// its jitted while_loop, outside Pallas (omp_amg_tpu/solvers/cg.py), which
// XLA fuses. The port's captured step (omp_amg_tpu_torch/solvers/cg.py::
// standard_program) wrote them as torch operations: per update a multiply
// by a 0-dim device scalar and an add, each writing a full intermediate
// vector, and per state vector a torch.where(active, new, old) that keeps a
// frozen iteration's state, about 34 full-vector passes an iteration. On the
// H100 at 256³ (16.7M f32 rows, 67 MB a vector) the masks and the scalar
// multiplies ran on PyTorch's broadcasting elementwise path and, with the
// adds and the copies at the end of each captured block, took over a third
// of the structured solve's device time. The update needs 9 passes: x, p, r,
// q read and x, r written, then z, p read and p written.
//
// Arithmetic: bit for bit the where-form it replaces (the plain twin,
// omp_amg_tpu_torch/ops/pcg_update.py), each product and sum rounded on its
// own (__fmul_rn, __fadd_rn, __fsub_rn and their f64 forms: no FMA
// contraction). α and β are read from device memory, where the step formed
// them, so the host reads nothing.
//
// Masking: the flag is the step's entry `active` (one byte, a torch bool).
// A block whose flag is false returns before it touches a vector, so a
// frozen iteration writes nothing and the state stays as it was. A null
// flag means always (the unmasked step).
//
// What bounds it: bytes. At 256³ f32 the xr pass moves 402 MB and the p
// pass 201 MB: 120 µs and 60 µs at 3.35 TB/s.
//
// Design: a pure stream. Each thread loads 16 bytes of each operand at a
// time (float4, double2) in a grid-stride loop over a grid sized to the
// card, then the threads of the grid take the scalar tail. Where a pointer
// is not 16-byte aligned (a view at an offset), the whole pass takes the
// scalar loop. α, β and the flag are read once a thread.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // threads per block

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}

// 16 bytes of T as one load or store
template <typename T> struct Pack;
template <> struct Pack<float> {
  using V = float4;
  static constexpr int kN = 4;
  __device__ static float& at(V& v, int k) { return (&v.x)[k]; }
};
template <> struct Pack<double> {
  using V = double2;
  static constexpr int kN = 2;
  __device__ static double& at(V& v, int k) { return (&v.x)[k]; }
};

// x ← x + a·p, r ← r − a·q
template <typename T>
__global__ void __launch_bounds__(kThreads)
xr_kernel(int64_t n, int vec, const bool* __restrict__ active,
          const T* __restrict__ alpha, T* __restrict__ x, T* __restrict__ r,
          const T* __restrict__ p, const T* __restrict__ q) {
  if (active != nullptr && !*active) return;
  const T a = *alpha;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    using P = Pack<T>;
    using V = typename P::V;
    const int64_t groups = n / P::kN;
    V* xv = reinterpret_cast<V*>(x);
    V* rv = reinterpret_cast<V*>(r);
    const V* pv = reinterpret_cast<const V*>(p);
    const V* qv = reinterpret_cast<const V*>(q);
    for (int64_t g = tid; g < groups; g += stride) {
      V xs = xv[g], rs = rv[g], ps = pv[g], qs = qv[g];
#pragma unroll
      for (int k = 0; k < P::kN; ++k) {
        P::at(xs, k) = add(P::at(xs, k), mul(a, P::at(ps, k)));
        P::at(rs, k) = sub(P::at(rs, k), mul(a, P::at(qs, k)));
      }
      xv[g] = xs;
      rv[g] = rs;
    }
    done = groups * P::kN;
  }
  for (int64_t i = done + tid; i < n; i += stride) {
    x[i] = add(x[i], mul(a, p[i]));
    r[i] = sub(r[i], mul(a, q[i]));
  }
}

// p ← z + b·p
template <typename T>
__global__ void __launch_bounds__(kThreads)
p_kernel(int64_t n, int vec, const bool* __restrict__ active,
         const T* __restrict__ beta, T* __restrict__ p,
         const T* __restrict__ z) {
  if (active != nullptr && !*active) return;
  const T b = *beta;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t done = 0;
  if (vec) {
    using P = Pack<T>;
    using V = typename P::V;
    const int64_t groups = n / P::kN;
    V* pv = reinterpret_cast<V*>(p);
    const V* zv = reinterpret_cast<const V*>(z);
    for (int64_t g = tid; g < groups; g += stride) {
      V ps = pv[g], zs = zv[g];
#pragma unroll
      for (int k = 0; k < P::kN; ++k)
        P::at(ps, k) = add(P::at(zs, k), mul(b, P::at(ps, k)));
      pv[g] = ps;
    }
    done = groups * P::kN;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    p[i] = add(z[i], mul(b, p[i]));
}

bool aligned(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename T>
cudaError_t launch(int kind, int64_t n, int64_t max_blocks,
                   const bool* active, const void* scalar, void* u, void* v,
                   const void* s, const void* t, cudaStream_t stream) {
  const int vec = aligned(u) && aligned(s) &&
                  (kind == 1 || (aligned(v) && aligned(t)));
  const int64_t per_block =
      static_cast<int64_t>(kThreads) * (vec ? Pack<T>::kN : 1);
  const int64_t need = (n + per_block - 1) / per_block;
  const unsigned blocks = static_cast<unsigned>(
      need < max_blocks ? (need > 0 ? need : 1) : max_blocks);
  if (kind == 0)
    xr_kernel<T><<<blocks, kThreads, 0, stream>>>(
        n, vec, active, static_cast<const T*>(scalar), static_cast<T*>(u),
        static_cast<T*>(v), static_cast<const T*>(s),
        static_cast<const T*>(t));
  else
    p_kernel<T><<<blocks, kThreads, 0, stream>>>(
        n, vec, active, static_cast<const T*>(scalar), static_cast<T*>(u),
        static_cast<const T*>(s));
  return cudaGetLastError();
}

}  // namespace

// kind 0 (xr): x = u, r = v, p = s, q = t, α = *scalar: u ← u + α·s and
// v ← v − α·t. kind 1 (p): p = u, z = s, β = *scalar: u ← s + β·u (v and t
// unused, null). f64 selects double over float. `active` is a device bool,
// or null for always. At most `max_blocks` blocks of 256 threads (the
// wrapper sizes the grid to the card). Launches on `stream` and returns the
// cudaError_t of the launch (0 = ok).
extern "C" int pcg_update_launch(int kind, int f64, int64_t n,
                                 int64_t max_blocks, const void* active,
                                 const void* scalar, void* u, void* v,
                                 const void* s, const void* t, void* stream) {
  if (kind < 0 || kind > 1 || n < 0 || max_blocks < 1 ||
      max_blocks > 0x7fffffff || scalar == nullptr || u == nullptr ||
      s == nullptr || (kind == 0) != (v != nullptr) ||
      (kind == 0) != (t != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto flag = static_cast<const bool*>(active);
  const auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      f64 ? launch<double>(kind, n, max_blocks, flag, scalar, u, v, s, t, st)
          : launch<float>(kind, n, max_blocks, flag, scalar, u, v, s, t, st);
  return static_cast<int>(err);
}
