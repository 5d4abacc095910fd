// Hand-written plane-halo exchange for Hopper (sm_90a).
//
// Replaces omp_amg_tpu/parallel/slab.py::_remote_halo_kernel, the Pallas
// async-remote-DMA neighbour exchange of the z-slab distributed path: in
// every sharded-level SpMV of the V-cycle and of PCG (transport "remote"),
// each shard's boundary strips land in its neighbours' halo buffers. For all
// d shards in ONE launch:
//
//   left [(i + 1) % d][j] = src[i][n − nl + j]   (my last nl rows → the
//                                                 right neighbour's left halo)
//   right[(i − 1 + d) % d][j] = src[i][j]        (my first nr rows → the left
//                                                 neighbour's right halo)
//
// The exchange is circular, as the TPU kernel's is (uniform SPMD, no
// conditional copies); the caller zeroes shard 0's left halo and shard
// d − 1's right halo to restore the Dirichlet ends. Values are f32; the copy
// is exact.
//
// The shards' source, left-halo and right-halo device pointers travel by
// value in the kernel's parameter block (a table of at most kMaxShards
// entries each), so the launch needs no host-to-device copy of the table.
// Every shard lives on the current device here; on a host with peer access
// between cards the same pointer table would write across NVLink.
//
// What bounds it: bytes, 8·(nl + nr)·d (each halo element read once and
// written once): about 1 MB on the 128³ fine level at d = 4 (nl = nr =
// 16,384), 0.31 µs at 3.35 TB/s. In practice the launch latency, a few µs,
// bounds it. The grid is (strip element, shard, direction), one thread per
// f32 element with neighbouring threads on neighbouring addresses: simple
// and correct; making it fast is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxShards = 64;

struct HaloTable {
  const float* src[kMaxShards];
  float* left[kMaxShards];
  float* right[kMaxShards];
};

__global__ void __launch_bounds__(kThreads) remote_halo_kernel(
    const HaloTable t, int d, int64_t n, int64_t nl, int64_t nr) {
  const int i = blockIdx.y;  // source shard
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (blockIdx.z == 0) {
    if (j < nl) t.left[(i + 1) % d][j] = t.src[i][n - nl + j];
  } else {
    if (j < nr) t.right[(i + d - 1) % d][j] = t.src[i][j];
  }
}

}  // namespace

// src, left and right are host arrays of d device pointers (left may be
// null when nl == 0, right when nr == 0). Launches on `stream` and returns
// the cudaError_t of the launch (0 = ok; nothing to copy is not a launch).
extern "C" int remote_halo_launch(int d, int64_t n, int64_t nl, int64_t nr,
                                  const void* const* src,
                                  void* const* left, void* const* right,
                                  void* stream) {
  if (d < 1 || d > kMaxShards || nl < 0 || nr < 0 || nl > n || nr > n)
    return cudaErrorInvalidValue;
  if (nl == 0 && nr == 0) return 0;
  HaloTable t = {};
  for (int i = 0; i < d; ++i) {
    t.src[i] = static_cast<const float*>(src[i]);
    if (nl) t.left[i] = static_cast<float*>(left[i]);
    if (nr) t.right[i] = static_cast<float*>(right[i]);
  }
  const int64_t width = nl > nr ? nl : nr;
  const int64_t blocks = (width + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(d), 2);
  remote_halo_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      t, d, n, nl, nr);
  return static_cast<int>(cudaGetLastError());
}
