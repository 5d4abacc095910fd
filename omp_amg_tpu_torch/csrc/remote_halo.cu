// Hand-written fused halo-window exchange for Hopper (sm_90a).
//
// Replaces omp_amg_tpu/parallel/slab.py::_remote_halo_kernel (:138), the
// Pallas async-remote-DMA neighbour exchange of the z-slab distributed path
// (transport "remote"), together with what its caller
// _exchange_planes_remote (:172) does with the two strips it returns: the
// zero mask at the global ends and the concatenation into each shard's x
// window (:193-201). For all d shards, in ONE launch:
//
//   W[i][0 : nl]              = src[i − 1][n − nl : n]  if i > 0, else 0
//   W[i][nl : nl + n]         = src[i][0 : n]
//   W[i][nl + n : nl + n + nr] = src[i + 1][0 : nr]   if i < d − 1, else 0
//
// Row i of W (a row stride apart) is shard i's window, which dia_spmv's
// x-window mode reads at x_base = nl. The exchange is non-circular: the two
// global ends are zero-filled here and never read. Values are f32 copies,
// so the windows are bitwise those of the plain transport.
//
// Why one kernel: the earlier kernel copied only the halo strips, circular,
// in about 1.4 µs of device time, but the exchange around it then launched
// two zero fills and d concatenations, a second pass over x. The launches,
// not the copy, held it back.
//
// What bounds it: bytes. Each window reads its nl + n + nr floats (less the
// zero-filled strips) and writes nl + n + nr: 17.8 MB on the 128³ fine
// level at d = 4 (n = 524,288, nl = nr = 16,384), 5.3 µs at 3.35 TB/s. The
// grid is (window chunk, shard): blockIdx.y is the shard, so no thread
// divides a 64-bit index, and the blocks along x sweep its window with
// neighbouring threads on neighbouring addresses. The vector path moves 16
// bytes per thread (float4 loads and stores); it needs n, nl, nr and the
// row stride to be multiples of 4 and every pointer 16-byte aligned, and
// then no float4 straddles two of a window's three parts. The scalar path
// moves one float per thread and takes any operands.
//
// The shards' source pointers travel by value in the kernel's parameter
// block (at most kMaxShards of them), so the launch needs no host-to-device
// copy of the table. Every shard lives on the current device; on a host with
// peer access between cards the same table could name other cards' buffers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;

struct SrcTable {
  const float* src[kMaxShards];
};

template <int V>
struct Lanes;  // V floats moved per thread

template <>
struct Lanes<1> {
  using T = float;
  static __device__ T zero() { return 0.0f; }
};

template <>
struct Lanes<4> {
  using T = float4;
  static __device__ T zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};

template <int V>
__global__ void __launch_bounds__(kThreads) remote_halo_window_kernel(
    const SrcTable t, int d, int64_t n, int64_t nl, int64_t nr,
    float* __restrict__ dst, int64_t stride) {
  using T = typename Lanes<V>::T;
  const int i = blockIdx.y;  // the shard whose window this block writes
  const int64_t j =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (j >= nl + n + nr) return;
  const float* src;
  if (j < nl)
    src = i > 0 ? t.src[i - 1] + (n - nl + j) : nullptr;
  else if (j < nl + n)
    src = t.src[i] + (j - nl);
  else
    src = i + 1 < d ? t.src[i + 1] + (j - nl - n) : nullptr;
  *reinterpret_cast<T*>(dst + i * stride + j) =
      src ? __ldg(reinterpret_cast<const T*>(src)) : Lanes<V>::zero();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// src is a host array of d device pointers, each to n floats; dst holds d
// rows of `stride` floats, row i receiving shard i's window of nl + n + nr
// floats. `vec` asks for the vector path, which needs n, nl, nr and stride
// to be multiples of 4 and 16-byte-aligned src[i] and dst; the scalar path
// takes any operands. Launches on `stream` and returns the cudaError_t of
// the launch (0 = ok; empty windows are not a launch).
extern "C" int remote_halo_window_launch(int d, int64_t n, int64_t nl,
                                         int64_t nr, int64_t stride, int vec,
                                         const void* const* src, void* dst,
                                         void* stream) {
  if (d < 1 || d > kMaxShards || n < 0 || nl < 0 || nr < 0 || nl > n ||
      nr > n || stride < nl + n + nr)
    return cudaErrorInvalidValue;
  const int64_t width = nl + n + nr;
  if (width == 0) return 0;
  SrcTable t = {};
  for (int i = 0; i < d; ++i) t.src[i] = static_cast<const float*>(src[i]);
  auto* out = static_cast<float*>(dst);
  if (vec) {
    bool ok = n % 4 == 0 && nl % 4 == 0 && nr % 4 == 0 && stride % 4 == 0 &&
              aligned16(out);
    for (int i = 0; i < d; ++i) ok = ok && aligned16(t.src[i]);
    if (!ok) return cudaErrorMisalignedAddress;
  }
  const int V = vec ? 4 : 1;
  const int64_t blocks = (width / V + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(d));
  auto st = static_cast<cudaStream_t>(stream);
  if (vec)
    remote_halo_window_kernel<4><<<grid, kThreads, 0, st>>>(t, d, n, nl, nr,
                                                            out, stride);
  else
    remote_halo_window_kernel<1><<<grid, kThreads, 0, st>>>(t, d, n, nl, nr,
                                                            out, stride);
  return static_cast<int>(cudaGetLastError());
}
