// One-token cached attention (flash decode) for NVIDIA Hopper, sm_90a.
//
// Replaces tpu_autoscaler/workloads/attention.py::_decode_kernel, the
// Pallas kernel behind flash_decode.  Same function: for each row, the
// new token's queries [h, d] attend over the row's cache [hkv, max_len,
// d] with per-row lengths, an optional sliding window and the serving
// ring layout; GQA query head g reads KV head g / (h / hkv).
//
// What bounds it.  Per launch the kernel reads every live K and V row
// once and does ~4*h*d flops per live key: about h/hkv flops per byte,
// far below the ~295 flops/byte at which an H100 stops being
// memory-bound.  At serving widths the bytes are few (the live K/V of a
// tick is ~0.8 MB, 0.27 us at 3.35 TB/s), so what is left is latency:
// the launch, the dependent loads (lengths, then the cache rows) and the
// rounds of copy and merge one CTA runs in series.  The design is about
// those:
//
// - split-KV over a thread-block cluster (decode_common.cuh): each (row,
//   KV head, chunk of up to 32 query heads of its GQA group) is a cluster
//   of kSplits CTAs, each over one contiguous part of the row's visible
//   positions, so the grid is rows * hkv * chunks * kSplits CTAs (64 at
//   4 slots x 2 KV heads, where one CTA per row and head gave 8) and each
//   CTA runs one or two tile rounds where one CTA ran up to 16; the ranks
//   merge the parts' carries through distributed shared memory, each
//   rank a slice of the outputs in rank order, in the same launch, with
//   no workspace in device memory;
// - the chunk's query heads share each K/V tile staged in shared memory,
//   so a tile is read from device memory once per chunk; a CTA reads only
//   positions its row can see (its part of [max(0, qpos - window + 1),
//   qpos], or of the live part of the ring), where the TPU grid streams
//   every k-block and only skips the compute;
// - tiles are double-buffered with cp.async in 16-byte vectors;
// - bf16 products run on the tensor cores (mma.sync m16n8k16: the chunk's
//   heads as the rows, a 64-key tile at a time, the output columns split
//   over the warps), so a tile's merge is a few instructions per warp
//   instead of a serial per-key loop; P stays in registers.  f32 merges
//   on CUDA cores, a lane per key;
// - probabilities never leave the chip: scores, the carries and the
//   accumulators stay in registers and shared memory.
//
// Numerics, matching the TPU kernel, and the head dims it takes: see
// decode_common.cuh, which holds the split, the merges and the staging
// this kernel shares with paged_flash_decode.cu.
//
// Ring layout: the cache holds the last `max_len` positions; position p
// lives in slot p mod max_len.  The TPU kernel recovers each slot's
// position as qpos - floormod(qpos - slot, width).  Here the loop runs
// over positions p >= 0 directly, so the slot is p % width of a
// non-negative p, and C++'s truncating % never sees a negative operand.
//
// Interface: a plain C function (see flash_decode at the bottom), built
// with nvcc into a shared library and called through ctypes.  It
// launches on the caller's stream (one cluster launch per call),
// allocates nothing and returns the launch's CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

// Cluster = kSplits CTAs of one (row, KV head, chunk of at most kMaxGroup
// query heads of the group); grid = b * hkv * chunks * kSplits.
template <typename T, int D>
__global__ void __launch_bounds__(Threads<T>::kMax)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int h, int hkv, int max_len, int d, int window,
                        int ring, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = h / hkv;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cta = blockIdx.x / kSplits;
  const int chunk = cta % chunks;
  const int kvh = cta / chunks % hkv;
  const int row = cta / chunks / hkv;

  const int length = lengths[row];  // in flight while q is staged
  const int heads = min(kMaxGroup, group - chunk * kMaxGroup);
  const size_t head = static_cast<size_t>(row) * h +
                      static_cast<size_t>(kvh) * group + chunk * kMaxGroup;
  stage_q<T, D>(smem, q + head * d, heads, d);

  // Visible positions [lo, hi] of this row's new token at qpos, and this
  // CTA's part of them.
  const int qpos = length - 1;
  const int hi = ring ? qpos : min(qpos, max_len - 1);
  int lo = 0;
  if (window > 0) lo = max(lo, qpos - window + 1);
  if (ring) lo = max(lo, qpos - max_len + 1);
  int first, last;
  split_part(lo, hi, rank, first, last);

  const T* kg = k + (static_cast<size_t>(row) * hkv + kvh) *
                        static_cast<size_t>(max_len) * d;
  split_decode<T, D>(smem, out + head * d, kg, v + (kg - k), heads, d, scale,
                     first, last, [=](int pos) -> long long {
                       return ring ? pos % max_len : pos;  // pos >= 0 here
                     });
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int b, int h, int hkv,
                   int max_len, int d, int window, int ring, float scale,
                   cudaStream_t stream) {
  const int group = h / hkv;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const int threads = Threads<T>::of(group);
  return launch_split(flash_decode_kernel<T, D>, b * hkv * chunks, threads,
                      Smem<T, D>::bytes(threads / 32), stream,
                      static_cast<const T*>(q), static_cast<const T*>(k),
                      static_cast<const T*>(v), lengths, static_cast<T*>(out),
                      h, hkv, max_len, d, window, ring, scale);
}

}  // namespace

// q [b, h, 1, d], k/v [b, hkv, max_len, d], out [b, h, 1, d], all
// contiguous and 16-byte aligned, in one dtype (0: f32, 1: bf16), any d
// from 1 to 256; lengths [b] int32 on the device.  window 0 means no
// window; scale multiplies q.k.  Returns a cudaError_t: 0 on a successful
// launch.
extern "C" int flash_decode(const void* q, const void* k, const void* v,
                            const int* lengths, void* out, int b, int h,
                            int hkv, int max_len, int d, int dtype,
                            int window, int ring, float scale, int device,
                            void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || hkv < 1 || max_len < 1 || h % hkv != 0 || window < 0 ||
      (ring && window == 0) ||
      static_cast<long long>(b) * h * kSplits > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch(dtype, built_width(d), [&](auto tag, auto dim) {
        using T = std::remove_pointer_t<decltype(tag)>;
        return launch<T, decltype(dim)::value>(q, k, v, lengths, out, b, h,
                                               hkv, max_len, d, window, ring,
                                               scale, s);
      }));
}
