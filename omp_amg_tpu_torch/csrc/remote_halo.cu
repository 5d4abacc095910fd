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
// copy of the table.
//
// The cross-process form (a mesh that spans processes on one card). The
// reference's kernel lands each device's boundary rows in its neighbours'
// halo buffers by remote DMA, with send and receive semaphores (slab.py
// :138-168). Here the table gets two outer entries around this process's d
// shards: lo, the left neighbour's last nl rows, and hi, the right
// neighbour's first nr rows, each read straight from that process's
// mailbox, a cudaMalloc buffer opened here by CUDA IPC
// (cudaIpcOpenMemHandle; torch's caching allocator sub-allocates, and IPC
// opens whole allocations). A null outer entry is a global end and
// zero-fills. Each process first copies its own two boundary strips into
// its mailbox (remote_halo_post); the caller orders the reads after the
// neighbours' copies (a stream sync and a barrier between processes) and
// double-buffers the mailboxes, so a copy never overwrites a strip a
// neighbour may still be reading. The window kernel itself is the
// one-process kernel: the outer entries change which pointer the two end
// shards read, nothing else. Between two cards the same table would name
// peer buffers (peer access), which needs a second card.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;

// [lo | shard 0 .. shard d − 1 | hi]: lo and hi are the outer strips of
// the cross-process form (null: a global end, or the one-process form).
struct SrcTable {
  const float* src[kMaxShards + 2];
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
  const float* const* s = t.src + 1;  // s[-1] = lo, s[d] = hi
  const float* src;
  if (j < nl)
    src = i > 0 ? s[i - 1] + (n - nl + j) : (s[-1] ? s[-1] + j : nullptr);
  else if (j < nl + n)
    src = s[i] + (j - nl);
  else
    src = i + 1 < d ? s[i + 1] + (j - nl - n)
                    : (s[d] ? s[d] + (j - nl - n) : nullptr);
  *reinterpret_cast<T*>(dst + i * stride + j) =
      src ? __ldg(reinterpret_cast<const T*>(src)) : Lanes<V>::zero();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// src is a host array of d device pointers, each to n floats; lo (nl
// floats) and hi (nr floats) are the outer strips of the cross-process
// form, or null; dst holds d rows of `stride` floats, row i receiving shard
// i's window of nl + n + nr floats. `vec` asks for the vector path, which
// needs n, nl, nr and stride to be multiples of 4 and 16-byte-aligned
// src[i], lo, hi and dst; the scalar path takes any operands. Launches on
// `stream` and returns the cudaError_t of the launch (0 = ok; empty windows
// are not a launch).
extern "C" int remote_halo_window_launch(int d, int64_t n, int64_t nl,
                                         int64_t nr, int64_t stride, int vec,
                                         const void* const* src,
                                         const void* lo, const void* hi,
                                         void* dst, void* stream) {
  if (d < 1 || d > kMaxShards || n < 0 || nl < 0 || nr < 0 || nl > n ||
      nr > n || stride < nl + n + nr)
    return cudaErrorInvalidValue;
  const int64_t width = nl + n + nr;
  if (width == 0) return 0;
  SrcTable t = {};
  t.src[0] = static_cast<const float*>(lo);
  for (int i = 0; i < d; ++i)
    t.src[i + 1] = static_cast<const float*>(src[i]);
  t.src[d + 1] = static_cast<const float*>(hi);
  auto* out = static_cast<float*>(dst);
  if (vec) {
    bool ok = n % 4 == 0 && nl % 4 == 0 && nr % 4 == 0 && stride % 4 == 0 &&
              aligned16(out);
    for (int i = 0; i < d + 2; ++i)
      ok = ok && (t.src[i] == nullptr || aligned16(t.src[i]));
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

// --- the mailboxes of the cross-process form --------------------------------
//
// One cudaMalloc buffer per process on `device`, opened by its neighbours
// through CUDA IPC. The 64-byte handles travel once between the processes
// (the caller's all-gather). Each returns a cudaError_t (0 = ok).

extern "C" int remote_halo_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

extern "C" int remote_halo_mailbox_alloc(int device, int64_t bytes,
                                         void** ptr) {
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  return cudaMalloc(ptr, static_cast<size_t>(bytes));
}

extern "C" int remote_halo_mailbox_free(int device, void* ptr) {
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  return cudaFree(ptr);
}

extern "C" int remote_halo_ipc_handle(void* ptr, void* handle) {
  cudaIpcMemHandle_t h;
  int rc = cudaIpcGetMemHandle(&h, ptr);
  if (rc == cudaSuccess) std::memcpy(handle, &h, sizeof h);
  return rc;
}

extern "C" int remote_halo_ipc_open(int device, const void* handle,
                                    void** ptr) {
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  cudaIpcMemHandle_t h;
  std::memcpy(&h, handle, sizeof h);
  return cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess);
}

extern "C" int remote_halo_ipc_close(void* ptr) {
  return cudaIpcCloseMemHandle(ptr);
}

// This process's two boundary strips into its mailbox slot `box`: the first
// nr floats of `first` (its first shard) at box, the last nl floats of
// `last` (its last shard, n floats) at box + nr. Two device-to-device copies
// on `stream`.
extern "C" int remote_halo_post(void* box, const void* first, int64_t nr,
                                const void* last, int64_t n, int64_t nl,
                                void* stream) {
  if (nr < 0 || nl < 0 || nl > n) return cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(box);
  int rc = cudaSuccess;
  if (nr)
    rc = cudaMemcpyAsync(out, first, nr * sizeof(float),
                         cudaMemcpyDeviceToDevice, st);
  if (rc == cudaSuccess && nl)
    rc = cudaMemcpyAsync(out + nr, static_cast<const float*>(last) + (n - nl),
                         nl * sizeof(float), cudaMemcpyDeviceToDevice, st);
  return rc;
}
