// One-token cached attention over a paged KV cache, for NVIDIA Hopper,
// sm_90a.
//
// Replaces tpu_autoscaler/workloads/attention.py::_paged_decode_kernel,
// the Pallas kernel behind paged_flash_decode.  Same function: for each
// row (serving slot), the new token's queries [h, d] attend over the
// row's keys, which live in a global block pool [nb, hkv, bs, d] and are
// found through the row's block table tables[row, :tpr]: key position p
// sits in pool block tables[row, p / bs] at offset p % bs.  Per-row
// lengths, an optional sliding window; GQA query head g reads KV head
// g / (h / hkv).  The TPU kernel's table semantics, key for key:
//
// - a table entry < 0 is a dead block: none of its keys is visible, even
//   below the row's length;
// - an entry >= nb is clamped to nb - 1 and read (not skipped);
// - only the tpr * bs positions the table covers exist.
//
// What bounds it.  As for flash_decode.cu: ~h/hkv flops per byte read,
// far below the ~295 flops/byte at which an H100 stops being
// memory-bound, so the cost is the live cache bytes.  The pool is read in
// place, block by block through the table, with no gathered copy of each
// row (which would move every live byte three times instead of once).
// The design is K3's, with the table in front of every key:
//
// - one CTA per (row, KV head, chunk of up to 32 query heads of its GQA
//   group), one warp per query head, so the chunk's heads share each K/V
//   tile staged in shared memory;
// - the CTA loads the table entries of its visible range [lo, hi] into
//   shared memory once;
// - a tile is BK consecutive positions, which may span several pool
//   blocks (bs 8 or 16) or part of one (bs 64): each key's 16-byte
//   vectors get their own cp.async source address through the table;
//   keys of dead blocks are not copied at all, only flagged;
// - tiles are double-buffered with cp.async, as in K3.
//
// Known weakness, left to a later change: the grid is slots * hkv CTAs
// (32 at 16 slots x 2 KV heads on 132 SMs); split-KV is the fix.
//
// Block sizes: any bs >= 1.  A key's row starts at a multiple of d
// elements, so when a row is a whole number of 16-byte vectors every
// key's vectors are aligned whatever the block size; any other d is
// staged element-wise (decode_common.cuh).

// Interface: a plain C function (paged_flash_decode at the bottom), built
// with nvcc into a shared library and called through ctypes.  It launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

// Dynamic shared memory: the stages, P and q (Tile::bytes), then the
// table slice (tpr ints at most) and one live flag per staged key.
template <typename T, int D>
size_t paged_smem_bytes(int warps, int tpr) {
  return Tile<T, D>::bytes(warps) + static_cast<size_t>(tpr) * sizeof(int) +
         static_cast<size_t>(kStages) * Tile<T, D>::kKeys;
}

// Block = one warp per query head of a chunk of at most kMaxGroup heads
// of the group; grid = slots * hkv * chunks.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kMaxGroup)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int h, int hkv, int nb, int bs, int tpr, int d,
                        int window, float scale) {
  using G = Tile<T, D>;
  constexpr int BK = G::kKeys;
  constexpr int KS = G::kKStride;
  constexpr int E = D / 32;
  extern __shared__ uint4 smem[];
  const int group = h / hkv;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const int warps = blockDim.x / 32;
  // [stage][K tile | V tile], per warp P, per warp q, the table slice,
  // then [stage][BK] live flags.
  float* ps = reinterpret_cast<float*>(smem + kStages * G::kStageVecs);
  float* qs = ps + warps * BK;
  int* tab = reinterpret_cast<int*>(qs + warps * D);
  unsigned char* live_flags = reinterpret_cast<unsigned char*>(tab + tpr);

  const int chunk = blockIdx.x % chunks;
  const int row = blockIdx.x / chunks / hkv;
  const int kvh = blockIdx.x / chunks % hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gh = chunk * kMaxGroup + warp;  // this warp's head in the group
  const bool active = gh < group;

  // Visible positions [lo, hi]: causal, windowed, and inside the table.
  const int qpos = lengths[row] - 1;
  const int hi = min(qpos, tpr * bs - 1);
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  const int ntiles = hi >= lo ? (hi - lo) / BK + 1 : 0;
  const int jlo = lo / bs;
  if (ntiles > 0) {
    const int* trow = tables + static_cast<size_t>(row) * tpr;
    for (int j = threadIdx.x; j <= hi / bs - jlo; j += blockDim.x)
      tab[j] = trow[jlo + j];
  }

  const size_t head = static_cast<size_t>(row) * h +
                      static_cast<size_t>(kvh) * group + gh;
  float* qw = qs + warp * D;
  for (int i = lane; i < D; i += 32)
    qw[i] = active && i < d ? Elem<T>::load(q[head * d + i]) : 0.f;
  float* sc = ps + warp * BK;
  if (d < D) zero_smem(smem, kStages * G::kStageVecs);  // columns past d
  __syncthreads();  // the table slice is in place before the first copy

  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int start = lo + t * BK;
      const int n = min(BK, hi - start + 1);
      const int stage = t % kStages;
      uint4* kst = smem + stage * G::kStageVecs;
      uint4* vst = kst + BK * KS;
      unsigned char* flags = live_flags + stage * BK;
      // Key r's row in a pool, or -1 for a dead block (not copied).
      auto row_of = [&](int r) -> long long {
        const int pos = start + r;
        const int j = pos / bs;
        const int entry = tab[j - jlo];
        if (entry < 0) return -1;
        const long long blk = min(entry, nb - 1);
        return (blk * hkv + kvh) * bs + (pos - j * bs);
      };
      stage_kv<T, D>(kst, vst, k, v, n, d, row_of,
                     [flags](int r, long long j) { flags[r] = j >= 0; });
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
    const unsigned char* flags = live_flags + (t % kStages) * BK;
    if (active)
      merge_tile<T, D>(smem + (t % kStages) * G::kStageVecs, n, qw, sc,
                       scale, m, l, acc,
                       [flags](int j) { return flags[j] != 0; });
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
                   const int* tables, const int* lengths, void* out,
                   int slots, int h, int hkv, int nb, int bs, int tpr, int d,
                   int window, float scale, cudaStream_t stream) {
  const int group = h / hkv;
  const int warps = group < kMaxGroup ? group : kMaxGroup;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const size_t smem = paged_smem_bytes<T, D>(warps, tpr);
  const cudaError_t err = allow_smem(paged_decode_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, D>
      <<<slots * hkv * chunks, 32 * warps, smem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), tables, lengths, static_cast<T*>(out), h,
          hkv, nb, bs, tpr, d, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [slots, h, 1, d], k/v pools [nb, hkv, bs, d], out [slots, h, 1, d],
// all contiguous and 16-byte aligned, in one dtype (0: f32, 1: bf16), any
// d from 1 to 256; tables [slots, tpr] and lengths [slots], int32 on the
// device.  window 0 means no window; scale multiplies q.k.  Returns a
// cudaError_t: 0 on a successful launch.
extern "C" int paged_flash_decode(const void* q, const void* k,
                                  const void* v, const int* tables,
                                  const int* lengths, void* out, int slots,
                                  int h, int hkv, int nb, int bs, int tpr,
                                  int d, int dtype, int window, float scale,
                                  int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots < 1 || hkv < 1 || nb < 1 || bs < 1 || tpr < 1 || h % hkv != 0 ||
      window < 0 || static_cast<long long>(slots) * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch(dtype, built_width(d), [&](auto tag, auto dim) {
        using T = std::remove_pointer_t<decltype(tag)>;
        return launch<T, decltype(dim)::value>(q, k, v, tables, lengths, out,
                                               slots, h, hkv, nb, bs, tpr, d,
                                               window, scale, s);
      }));
}
