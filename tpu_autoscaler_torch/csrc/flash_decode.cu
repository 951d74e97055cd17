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
// memory-bound.  So the cost is the cache bytes, and the design is about
// reading each live cache byte once, and keeping those reads in flight:
//
// - one CTA per (row, KV head, chunk of up to 32 query heads of its GQA
//   group); the chunk's query heads share each K/V tile staged in shared
//   memory (one warp per query head), so a tile is read from device
//   memory once per chunk (once for the whole group up to 32 heads);
// - the CTA loops only over the positions the row can see —
//   [max(0, qpos - window + 1), qpos], or the live part of the ring —
//   where the TPU grid streams every k-block and only skips the compute;
// - tiles are double-buffered with cp.async: the next tile's copy is in
//   flight while the warps score the current one;
// - each lane scores whole keys (lane j takes keys j, j+32, ...), so a
//   tile's scores need one warp reduction for the max and one for the
//   sum, not one per key; K rows are padded by 16 bytes in shared
//   memory so the lanes' row reads fall in distinct banks;
// - probabilities never leave the chip: scores, the online-softmax
//   carry (m, l) and the accumulator stay in registers and shared memory.
//
// Known weakness, left to a later change: at serving widths the grid is
// only b * hkv CTAs (8 at 4 slots x 2 KV heads on 132 SMs).  Split-KV
// across SMs, TMA and tensor-core dot products are the planned fixes.
//
// Numerics, matching the TPU kernel, and the head dims it takes: see
// decode_common.cuh, which holds the tile merge and the staging this
// kernel shares with paged_flash_decode.cu.
//
// Ring layout: the cache holds the last `max_len` positions; position p
// lives in slot p mod max_len.  The TPU kernel recovers each slot's
// position as qpos - floormod(qpos - slot, width).  Here the loop runs
// over positions p >= 0 directly, so the slot is p % width of a
// non-negative p, and C++'s truncating % never sees a negative operand.
//
// Interface: a plain C function (see flash_decode at the bottom), built
// with nvcc into a shared library and called through ctypes.  It
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

// Block = one warp per query head of a chunk of at most kMaxGroup heads
// of the group; grid = b * hkv * chunks.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxGroup)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int h, int hkv, int max_len, int d, int window,
                        int ring, float scale) {
  using G = Tile<T, D>;
  constexpr int BK = G::kKeys;
  constexpr int KS = G::kKStride;
  constexpr int E = D / 32;             // head_dim elements per lane in PV
  extern __shared__ uint4 smem[];
  const int group = h / hkv;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const int warps = blockDim.x / 32;
  // [stage][K tile (padded rows) | V tile], then per warp: P, then q.
  float* ps = reinterpret_cast<float*>(smem + kStages * G::kStageVecs);
  float* qs = ps + warps * BK;

  const int chunk = blockIdx.x % chunks;
  const int row = blockIdx.x / chunks / hkv;
  const int kvh = blockIdx.x / chunks % hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gh = chunk * kMaxGroup + warp;  // this warp's head in the group
  const bool active = gh < group;

  // Visible positions [lo, hi] of this row's new token at qpos.
  const int qpos = lengths[row] - 1;
  const int hi = ring ? qpos : min(qpos, max_len - 1);
  int lo = 0;
  if (window > 0) lo = max(lo, qpos - window + 1);
  if (ring) lo = max(lo, qpos - max_len + 1);
  const int ntiles = hi >= lo ? (hi - lo) / BK + 1 : 0;

  const size_t head = static_cast<size_t>(row) * h +
                      static_cast<size_t>(kvh) * group + gh;
  float* qw = qs + warp * D;
  for (int i = lane; i < D; i += 32)
    qw[i] = active && i < d ? Elem<T>::load(q[head * d + i]) : 0.f;
  float* sc = ps + warp * BK;
  if (d < D) {  // the columns past d stay zero in every stage
    zero_smem(smem, kStages * G::kStageVecs);
    __syncthreads();
  }

  const T* kg = k + (static_cast<size_t>(row) * hkv + kvh) *
                        static_cast<size_t>(max_len) * d;
  const T* vg = v + (kg - k);

  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int start = lo + t * BK;
      const int n = min(BK, hi - start + 1);
      uint4* kst = smem + (t % kStages) * G::kStageVecs;
      uint4* vst = kst + BK * KS;
      stage_kv<T, D>(
          kst, vst, kg, vg, n, d,
          [&](int r) -> long long {
            const int pos = start + r;           // pos >= 0 here
            return ring ? pos % max_len : pos;   // the key's slot
          },
          [](int, long long) {});
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float m = kNegInf;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  load_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    load_tile(t + 1);
    cp_async_wait_one();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();
    const int n = min(BK, hi - (lo + t * BK) + 1);
    if (active)
      merge_tile<T, D>(smem + (t % kStages) * G::kStageVecs, n, qw, sc,
                       scale, m, l, acc, [](int) { return true; });
    __syncthreads();  // the stage is free for the copy issued next
  }

  if (!active) return;
  const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
  for (int e = 0; e < E; ++e)
    if (lane * E + e < d)
      out[head * d + lane * E + e] = Elem<T>::store(acc[e] / l_safe);
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int b, int h, int hkv,
                   int max_len, int d, int window, int ring, float scale,
                   cudaStream_t stream) {
  const int group = h / hkv;
  const int warps = group < kMaxGroup ? group : kMaxGroup;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const size_t smem = Tile<T, D>::bytes(warps);
  const cudaError_t err = allow_smem(flash_decode_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  flash_decode_kernel<T, D><<<b * hkv * chunks, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), h, hkv,
      max_len, d, window, ring, scale);
  return cudaGetLastError();
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
      static_cast<long long>(b) * h > 0x7fffffffLL)
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
