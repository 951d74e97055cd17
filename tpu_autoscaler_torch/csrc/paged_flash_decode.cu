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
// memory-bound, and at serving widths few bytes (~0.8 MB of live K/V a
// tick), so the cost is latency: the launch, the dependent loads
// (lengths, the table, then the pool rows) and the rounds one CTA runs in
// series.  The pool is read in place, block by block through the table,
// with no gathered copy of each row (which would move every live byte
// three times instead of once).  The design is K3's (decode_common.cuh),
// with the table in front of every key:
//
// - split-KV over a thread-block cluster: each (row, KV head, chunk of up
//   to 32 query heads) is a cluster of kSplits CTAs, each over one
//   contiguous part of the row's visible positions (256 CTAs at 16 slots
//   x 2 KV heads, where one CTA per row and head gave 32); the ranks
//   merge the parts through distributed shared memory, each a slice of
//   the outputs in rank order, in the same launch;
// - a CTA copies its row's table into shared memory by cp.async, in
//   flight with the row's length and q, so the pool reads wait on one
//   round trip to device memory, not two;
// - a tile of consecutive positions may span several pool blocks (bs 8
//   or 16) or part of one (bs 64): each key's 16-byte vectors get their
//   own cp.async source address through the table; keys of dead blocks
//   are not copied, only flagged (their rows zeroed, their P exactly 0);
// - tiles are double-buffered with cp.async; bf16 products run on the
//   tensor cores with mma.sync, f32 on CUDA cores, as in K3.
//
// Block sizes: any bs >= 1.  A key's row starts at a multiple of d
// elements, so when a row is a whole number of 16-byte vectors every
// key's vectors are aligned whatever the block size; any other d is
// staged element-wise (decode_common.cuh).

// Interface: a plain C function (paged_flash_decode at the bottom), built
// with nvcc into a shared library and called through ctypes.  It launches
// on the caller's stream (one cluster launch per call), allocates nothing
// and returns the launch's CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_common.cuh"

namespace {

using namespace decode;

// Cluster = kSplits CTAs of one (row, KV head, chunk of at most kMaxGroup
// query heads of the group); grid = slots * hkv * chunks * kSplits.
// Dynamic shared memory: decode_common.cuh's Smem, then the row's table
// (tpr ints).
template <typename T, int D>
__global__ void __launch_bounds__(Threads<T>::kMax)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int h, int hkv, int nb, int bs, int tpr, int d,
                        int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = h / hkv;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int cta = blockIdx.x / kSplits;
  const int chunk = cta % chunks;
  const int kvh = cta / chunks % hkv;
  const int row = cta / chunks / hkv;

  // The row's length, its table row (by cp.async, into shared memory) and
  // q, all in flight together.
  const int length = lengths[row];
  int* tab = reinterpret_cast<int*>(smem + Smem<T, D>::bytes(blockDim.x / 32));
  const int* trow = tables + static_cast<size_t>(row) * tpr;
  for (int j = threadIdx.x; j < tpr; j += blockDim.x)
    cp_async_word(tab + j, trow + j);
  const int heads = min(kMaxGroup, group - chunk * kMaxGroup);
  const size_t head = static_cast<size_t>(row) * h +
                      static_cast<size_t>(kvh) * group + chunk * kMaxGroup;
  stage_q<T, D>(smem, q + head * d, heads, d);

  // Visible positions [lo, hi]: causal, windowed, and inside the table;
  // this CTA's part of them.
  const int qpos = length - 1;
  const int hi = min(qpos, tpr * bs - 1);
  const int lo = window > 0 ? max(0, qpos - window + 1) : 0;
  int first, last;
  split_part(lo, hi, rank, first, last);

  split_decode<T, D>(smem, out + head * d, k, v, heads, d, scale, first, last,
                     [=](int pos) -> long long {
                       // Key pos's row in a pool, or -1 for a dead block.
                       const int j = pos / bs;
                       const int entry = tab[j];
                       if (entry < 0) return -1;
                       const long long blk = min(entry, nb - 1);
                       return (blk * hkv + kvh) * bs + (pos - j * bs);
                     });
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* tables, const int* lengths, void* out,
                   int slots, int h, int hkv, int nb, int bs, int tpr, int d,
                   int window, float scale, cudaStream_t stream) {
  const int group = h / hkv;
  const int chunks = (group + kMaxGroup - 1) / kMaxGroup;
  const int threads = Threads<T>::of(group);
  const size_t smem = Smem<T, D>::bytes(threads / 32) +
                      static_cast<size_t>(tpr) * sizeof(int);
  return launch_split(paged_decode_kernel<T, D>, slots * hkv * chunks,
                      threads, smem, stream, static_cast<const T*>(q),
                      static_cast<const T*>(k), static_cast<const T*>(v),
                      tables, lengths, static_cast<T*>(out), h, hkv, nb, bs,
                      tpr, d, window, scale);
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
      window < 0 ||
      static_cast<long long>(slots) * h * kSplits > 0x7fffffffLL)
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
