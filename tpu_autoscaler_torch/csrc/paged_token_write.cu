// One decode step's new keys and values written into a paged KV pool, for
// NVIDIA Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package writes each row's new token
// with a scatter whose index it sends out of range for the rows that must
// not write, and XLA drops those writes (paged.py::_scatter_token,
// mode="drop").  PyTorch has no dropping scatter, so the port's decode
// step filtered its write lists on the host, a length that changed every
// step.  This kernel takes every slot and decides on the device which
// rows write, so the step has one shape and can be captured as a CUDA
// graph (paged.make_paged_decode_step).
//
// Function: row r (a serving slot) at position p = positions[r] writes
// its new key k_new[r, g] and value v_new[r, g] of every KV head g into
// pool block tables[r, min(max(p / bs, 0), tpr - 1)] at offset p % bs
// (a position past the table lands in its last entry, as the JAX
// package's clipped index does).  A row writes nothing when it is not
// active, or when that entry is < 0 (no block) or >= nb (past the pool).
// k_new, v_new [slots, hkv, 1, d] with any row and head strides and unit
// stride along d; pools [nb, hkv, bs, d] contiguous; one element type, of
// 2 or 4 bytes, copied bit for bit.
//
// What bounds it: latency.  It moves 2 * slots * hkv * d elements each
// way (256 KB at StarCoder2-3B's 256 slots), well under a microsecond at
// 3.35 TB/s; the cost is the one launch a layer, which stands in for the
// eager step's two index_put_ launches and their index arithmetic.  One
// CTA per (row, KV head); its threads copy the head's d elements of k and
// v, neighbouring threads on neighbouring addresses.

// Interface: a plain C function (paged_token_write at the bottom), built
// with nvcc into a shared library and called through ctypes.  It launches
// on the caller's stream, allocates nothing and returns the launch's CUDA
// error.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename W>
__global__ void token_write_kernel(const W* __restrict__ k_new,
                                   const W* __restrict__ v_new,
                                   W* __restrict__ k_pool,
                                   W* __restrict__ v_pool,
                                   const int* __restrict__ tables,
                                   const int* __restrict__ positions,
                                   const unsigned char* __restrict__ active,
                                   int hkv, int nb, int bs, int tpr, int d,
                                   int k_row, int k_head, int v_row,
                                   int v_head) {
  const int row = blockIdx.x;
  const int head = blockIdx.y;
  if (!active[row]) return;
  const int p = positions[row];
  // Floor division and modulo, as the host's index arithmetic has them.
  int j = p / bs;
  if (p % bs != 0 && p < 0) --j;
  const int off = p - j * bs;
  const int entry = tables[static_cast<size_t>(row) * tpr +
                           min(max(j, 0), tpr - 1)];
  if (entry < 0 || entry >= nb) return;
  const size_t dst =
      ((static_cast<size_t>(entry) * hkv + head) * bs + off) *
      static_cast<size_t>(d);
  const W* k_src = k_new + static_cast<size_t>(row) * k_row +
                   static_cast<size_t>(head) * k_head;
  const W* v_src = v_new + static_cast<size_t>(row) * v_row +
                   static_cast<size_t>(head) * v_head;
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
    k_pool[dst + e] = k_src[e];
    v_pool[dst + e] = v_src[e];
  }
}

template <typename W>
cudaError_t launch(const void* k_new, const void* v_new, void* k_pool,
                   void* v_pool, const int* tables, const int* positions,
                   const unsigned char* active, int slots, int hkv, int nb,
                   int bs, int tpr, int d, int k_row, int k_head, int v_row,
                   int v_head, cudaStream_t stream) {
  const int threads = min(256, (d + 31) / 32 * 32);
  token_write_kernel<W><<<dim3(slots, hkv), threads, 0, stream>>>(
      static_cast<const W*>(k_new), static_cast<const W*>(v_new),
      static_cast<W*>(k_pool), static_cast<W*>(v_pool), tables, positions,
      active, hkv, nb, bs, tpr, d, k_row, k_head, v_row, v_head);
  return cudaGetLastError();
}

// Make `device` current for the launch.
cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

}  // namespace

// k_new, v_new [slots, hkv, 1, d] (element strides k_row, k_head and
// v_row, v_head, unit along d); k_pool, v_pool [nb, hkv, bs, d] contiguous;
// tables [slots, tpr] and positions [slots] int32, active [slots] bool,
// all on the device; elem_bytes 2 or 4.  The scale is unused (the
// entries share one argument layout).  Returns a cudaError_t: 0 on a
// successful launch.
extern "C" int paged_token_write(const void* k_new, const void* v_new,
                                 void* k_pool, void* v_pool,
                                 const int* tables, const int* positions,
                                 const void* active, int slots, int hkv,
                                 int nb, int bs, int tpr, int d,
                                 int elem_bytes, int k_row, int k_head,
                                 int v_row, int v_head, float scale,
                                 int device, void* stream) {
  (void)scale;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (slots < 1 || hkv < 1 || hkv > 65535 || nb < 1 || bs < 1 || tpr < 1 ||
      d < 1 || k_row < 0 || k_head < 0 || v_row < 0 || v_head < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* flags = static_cast<const unsigned char*>(active);
  switch (elem_bytes) {
    case 2:
      return static_cast<int>(launch<uint16_t>(
          k_new, v_new, k_pool, v_pool, tables, positions, flags, slots, hkv,
          nb, bs, tpr, d, k_row, k_head, v_row, v_head, s));
    case 4:
      return static_cast<int>(launch<uint32_t>(
          k_new, v_new, k_pool, v_pool, tables, positions, flags, slots, hkv,
          nb, bs, tpr, d, k_row, k_head, v_row, v_head, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
