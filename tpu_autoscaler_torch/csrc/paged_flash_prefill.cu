// Chunked prefill attention over a paged KV cache (K7), for NVIDIA
// Hopper, sm_90a.
//
// Replaces no TPU kernel: the JAX package's paged prefill
// (tpu_autoscaler/workloads/paged.py) gathers each lane's whole table and
// runs a masked einsum, with no Pallas kernel behind it, and the port did
// the same (paged._lanes_attend).  That einsum held about two thirds of a
// serving tick at long prompts: per layer it forms every lane's scores
// over all tokens_per_row keys (4 lanes x 24 heads x 512 queries x 4,096
// keys at StarCoder2-3B's code-completion cell), writes them several
// times over (bf16 scores, f32 copy, mask, softmax, bf16 cast), and two
// thirds of them are masked.  This kernel reads each lane's pages in
// place and visits only the keys some query of its tile sees.
//
// Function: for lane b, query row i at position p = offsets[b] + i,
// query head g (KV head g / (h / hkv)), key position j is visible when
// j <= p, j > p - window (window > 0) and j < tpr * bs (the positions
// the table covers).  Its page is tables[b, j / bs]: an entry >= nb is
// clamped to nb - 1, an entry < 0 (a dead page) reads block 0.  For the
// lane's real rows (i < n_valid[b]) a dead page's keys are hidden, as in
// K4 (paged_flash_decode.cu); since j <= p, they see no key at or past
// offsets[b] + n_valid[b].  The padding rows (i >= n_valid[b]; every row
// of a lane with n_valid 0) are what the gathered einsum (the JAX
// package's prefill) makes of them: every key j <= p, dead pages read as
// block 0.  They reach nothing of the real rows' attention, but an MoE
// layer routes their tokens in the lane's capacity pool, so a real token
// is the reference's only if the padding tokens are too.  A row that
// sees no key is written as zeros.  q, out [lanes, h, chunk, d] in one
// dtype; pools [nb, hkv, bs, d].
//
// What bounds it.  4 * d flops per visible (query head, key) pair, the
// padding rows' included, and the bytes of the visible K/V rows (each
// read once), q, out and the table entries read.  At the code-completion
// cell's median call (4 lanes of 512 queries, ~2,560-token prompts, 24
// query heads on 2 KV heads of 128) that is ~30 GFLOP against ~25 MB:
// bound by the tensor cores, ~30 us a layer, where the einsum moved ~4
// GB.  GQA makes the pairs outweigh the bytes (a group of 12 query heads
// reads one K/V row), so the products run on the tensor cores and
// nothing but q, the visible pages, the table and out touches device
// memory.
//
// bf16: the forward tile's consumer (flash_fwd_tc.cuh, K1's and K5's:
// wgmma S = Q.K^T, the online softmax on the fragment in registers with
// f32 scores, P rounded to bf16 as the A operand of O += P.V) behind a
// paged producer.  One CTA per (lane, query head, 128 query rows), the
// last q-tiles first (the most keys), as K1.  The producer warp reads the
// lane's table 32 entries at a time into registers (one coalesced load,
// entries handed out by shuffle), and loads each 64-key tile of K and V
// as one TMA box per (page, 64-column atom) from tensor maps over the
// pool: at bs 16 four pages a tile, each box landing at its keys' rows
// of the tile in the 128-byte swizzle, so the consumer reads the tile as
// K1 reads its own.  A dead page loads pool block 0 (as the gathered
// route does) and is flagged in the stage's dead-key words, which the
// consumer applies to the real rows; positions past the table's last
// entry reload its last page, masked as past the end.  Block sizes:
// multiples of 8 that divide the tile (8, 16, 32, 64) or that the tile
// divides (a multiple of 64; 32 at d 256), so every box starts
// 1024-byte aligned.  Head dims: any multiple of 8 up to 256, at the 64-,
// 128- or 256-column instantiation (TMA fills the columns past d with
// zeros).  Grouping a GQA group's heads into one CTA would read
// each K/V tile once a group instead of once a head, from L2: at these
// shapes the pairs, not the bytes, bound the call.
//
// f32: a CUDA-core kernel (K1's FMA design, flash_attention.cu): one CTA
// per (lane, query head, 32 query rows), 8 warps of 4 rows, 32-key tiles
// staged by cp.async through the table (a dead page's keys copied from
// block 0 and flagged), a lane per key.
//
// Numerics: scores are f32 dot products scaled after the dot by the
// caller's scale; online softmax in f32 from m = -1e30; P rounded to v's
// dtype before PV (bf16 at the running max); f32 accumulation; out in
// q's dtype.  The gathered einsum rounds the scores to bf16 before its
// f32 softmax; this kernel does not.
//
// Interface: a plain C function (paged_flash_prefill at the bottom),
// built with nvcc into a shared library and called through ctypes.  It
// launches on the caller's stream, allocates nothing and returns the
// launch's CUDA error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "decode_common.cuh"
#include "flash_fwd_tc.cuh"

namespace {

using namespace decode;

// ---- bf16: the forward tile behind a paged producer ------------------------

// Whether the bf16 kernel takes block size bs at tile width BK: every box
// of min(bs, BK) rows starts at a 1024-byte boundary of its tile, and a
// tile is whole boxes.
__host__ __device__ constexpr bool tc_block_ok(int bs, int bk) {
  return bs >= 8 && bs % 8 == 0 && (bk % bs == 0 || bs % bk == 0);
}

// Block = 2 consumer warpgroups + 1 producer warpgroup (one working
// warp); grid = n_qt * lanes * h, the last q-tiles first.
template <int D>
__global__ void __launch_bounds__(tc::kTcThreads, 1)
    paged_prefill_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const int* __restrict__ tables,
                            const int* __restrict__ offsets,
                            const int* __restrict__ n_valid,
                            __nv_bfloat16* __restrict__ out, int lanes,
                            int h, int hkv, int chunk, int nb, int bs,
                            int tpr, int d, int window, float scale) {
  using G = tc::FwdTile<D>;
  constexpr int BK = G::BK;
  constexpr int kWords = BK / 32;         // dead-key words a stage
  constexpr int kMaxBoxes = BK / 8;       // pages of a tile at bs 8
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = tc::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t stages = base + G::kQBytes;
  const uint32_t bars = stages + G::kStages * G::kStageBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 64 + 8 s, the q tile's at
  // bars + 120; the stages' dead-key words from bars + 128.
  const uint32_t q_bar = bars + 120;
  uint32_t* dead = reinterpret_cast<uint32_t*>(smem_raw + (bars + 128 - raw));

  const int bh_count = lanes * h;
  const int n_qt = (chunk + tc::kTcRows - 1) / tc::kTcRows;
  const int bh = blockIdx.x % bh_count;             // lane * h + head
  const int qt = n_qt - 1 - blockIdx.x / bh_count;  // last tiles first
  const int row = bh / h;
  const int kvh = bh % h / (h / hkv);
  const int q0 = qt * tc::kTcRows;
  const int off = offsets[row];
  const int nv = min(max(n_valid[row], 0), chunk);
  __nv_bfloat16* o = out + static_cast<size_t>(bh) * chunk * d;

  const int q_last = min(q0 + tc::kTcRows, chunk) - 1;
  const int sk = tpr * bs;  // keys past it do not exist
  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      tc::mbar_init(bars + 8 * s, 1);
      tc::mbar_init(bars + 64 + 8 * s, 128 * tc::kConsumers);
    }
    tc::mbar_init(q_bar, 1);
    tc::mbar_fence_init();
  }
  int k_lo, k_hi;
  tc::hop_keys(q0, q_last, sk, off, 1, window, k_lo, k_hi);
  __syncthreads();  // publishes the barriers
  const int t_lo = k_lo / BK;
  const int ntiles = k_hi < k_lo ? 0 : k_hi / BK - t_lo + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * tc::kConsumers) {
    // Producer: the q tile, then the K/V ring through the lane's table.
    tc::regs_dec<tc::kProducerRegs>();
    if (warp != 4 * tc::kConsumers) return;
    if (lane == 0) {
      tc::mbar_expect_tx(q_bar, G::kQBytes);
#pragma unroll
      for (int a = 0; a < G::kAtoms; ++a)
        tc::tma_load(q_tile + a * G::kQAtom, &q_map, 64 * a, q0, bh, q_bar);
    }
    const int* trow = tables + static_cast<size_t>(row) * tpr;
    const int last_page = (sk - 1) / bs;  // the last entry it may read
    const int box = min(bs, BK);          // rows of a box
    int first = -32;  // entries [first, first + 32) are held, one a lane
    int held = -1;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % G::kStages;
      if (t >= G::kStages)
        tc::mbar_wait(bars + 64 + 8 * s, ((t / G::kStages) - 1) & 1);
      const int start = (t_lo + t) * BK;
      int outer[kMaxBoxes];
      uint32_t words[kWords] = {};
#pragma unroll
      for (int i = 0; i < kMaxBoxes; ++i) {
        if (i * box >= BK) break;
        const int page = min((start + i * box) / bs, last_page);
        if (page < first || page >= first + 32) {  // the same for the warp
          first = page;
          held = page + lane <= last_page ? __ldg(trow + page + lane) : -1;
        }
        const int entry = __shfl_sync(0xffffffffu, held, page - first);
        outer[i] = (entry < 0 ? 0 : min(entry, nb - 1)) * hkv + kvh;
        if (entry < 0) {
          // Flag keys [i * box, (i + 1) * box) of the tile.
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            const int a = max(i * box - 32 * w, 0);
            const int b = min((i + 1) * box - 32 * w, 32);
            if (a < b)
              words[w] |= (b - a == 32 ? ~0u : (1u << (b - a)) - 1u) << a;
          }
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int w = 0; w < kWords; ++w) dead[s * kWords + w] = words[w];
        const uint32_t full = bars + 8 * s;
        const uint32_t kst = stages + s * G::kStageBytes;
        tc::mbar_expect_tx(full, G::kStageBytes);  // releases the words
#pragma unroll
        for (int i = 0; i < kMaxBoxes; ++i) {
          if (i * box >= BK) break;
          const int in_page = (start + i * box) % bs;
#pragma unroll
          for (int a = 0; a < G::kAtoms; ++a) {
            const uint32_t at = a * G::kKAtom + i * box * 128;
            tc::tma_load(kst + at, &k_map, 64 * a, in_page, outer[i], full);
            tc::tma_load(kst + G::kKVBytes + at, &v_map, 64 * a, in_page,
                         outer[i], full);
          }
        }
      }
      __syncwarp();
    }
  } else {
    tc::regs_inc<tc::kConsumerRegs>();
    tc::consume<D, BK>(q_tile, stages, bars, q_bar,
                       tc::PagedOut{o, dead, nv}, 0, q0, t_lo, ntiles, false,
                       chunk, sk, d, off, 1, window, scale);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const int* tables, const int* offsets,
                      const int* n_valid, void* out, int lanes, int h,
                      int hkv, int chunk, int nb, int bs, int tpr, int d,
                      int window, float scale, cudaStream_t stream) {
  constexpr int DK = D < 64 ? 64 : D;  // the instantiation d 32 runs in
  using G = tc::FwdTile<DK>;
  if (!tc_block_ok(bs, G::BK) || d % 8 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = tc::make_map(&q_map, q, d, chunk, lanes * h,
                                 tc::kTcRows);
  if (err == cudaSuccess)
    err = tc::make_map(&k_map, k, d, bs, nb * hkv, min(bs, G::BK));
  if (err == cudaSuccess)
    err = tc::make_map(&v_map, v, d, bs, nb * hkv, min(bs, G::BK));
  if (err != cudaSuccess) return err;
  const size_t smem = G::kSmem + 64;  // + the dead-key words
  err = allow_smem(paged_prefill_tc_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (chunk + tc::kTcRows - 1) / tc::kTcRows;
  paged_prefill_tc_kernel<DK><<<n_qt * lanes * h, tc::kTcThreads, smem,
                                stream>>>(
      q_map, k_map, v_map, tables, offsets, n_valid,
      static_cast<__nv_bfloat16*>(out), lanes, h, hkv, chunk, nb, bs, tpr, d,
      window, scale);
  return cudaGetLastError();
}

// ---- f32: CUDA-core FMA ----------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane

// Shared memory: kStages stages of [K tile (padded rows) | V tile], the
// CTA's q rows, then each stage's key flags (1: a live page's, 2: a dead
// page's, 0: past the table's end).  Rows hold D floats; the columns past
// the pool's d stay zero.
template <int D>
struct FmaTile {
  static constexpr int kVpr = D / 4;        // vectors per row
  static constexpr int kKStride = kVpr + 1;  // padded K row
  static constexpr int kStageVecs = kBK * (kKStride + kVpr);
  static constexpr size_t kQOffset =
      static_cast<size_t>(kStages) * kStageVecs * 16;
  static constexpr size_t kFlagOffset = kQOffset + kBQ * D * sizeof(float);
  static constexpr size_t kBytes = kFlagOffset + kStages * kBK * sizeof(int);
};

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
    paged_prefill_fma_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const int* __restrict__ tables,
                             const int* __restrict__ offsets,
                             const int* __restrict__ n_valid,
                             float* __restrict__ out, int lanes, int h,
                             int hkv, int chunk, int nb, int bs, int tpr,
                             int d, int window, float scale) {
  using G = FmaTile<D>;
  constexpr int VPR = G::kVpr;
  constexpr int KS = G::kKStride;
  constexpr int E = D / 32;  // output elements per lane
  constexpr int R = kRowsPerWarp;
  extern __shared__ uint4 smem[];
  float* qs = reinterpret_cast<float*>(
      reinterpret_cast<uint8_t*>(smem) + G::kQOffset);
  int* flags = reinterpret_cast<int*>(
      reinterpret_cast<uint8_t*>(smem) + G::kFlagOffset);

  const int bh_count = lanes * h;
  const int n_qt = (chunk + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;
  const int qt = n_qt - 1 - blockIdx.x / bh_count;
  const int row = bh / h;
  const int kvh = bh % h / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qt * kBQ;
  const int off = offsets[row];
  const int nv = min(max(n_valid[row], 0), chunk);
  float* o = out + static_cast<size_t>(bh) * chunk * d;

  // The q tile (rows past the chunk and columns past d as zeros) and
  // empty K/V stages, before any copy into them.
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D;
    const int c = i % D;
    qs[i] = q0 + r < chunk && c < d
                ? q[(static_cast<size_t>(bh) * chunk + q0 + r) * d + c]
                : 0.f;
  }
  for (int i = threadIdx.x; i < kStages * G::kStageVecs; i += blockDim.x)
    smem[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  const int q_last = min(q0 + kBQ, chunk) - 1;
  const int sk = tpr * bs;
  int k_lo, k_hi;
  tc::hop_keys(q0, q_last, sk, off, 1, window, k_lo, k_hi);
  const int t_lo = k_lo / kBK;
  const int ntiles = k_hi < k_lo ? 0 : k_hi / kBK - t_lo + 1;
  const int vpr = d / 4;  // vectors a pool row holds
  const int* trow = tables + static_cast<size_t>(row) * tpr;

  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int start = (t_lo + t) * kBK;
      const int n = min(kBK, sk - start);
      uint4* kst = smem + (t % kStages) * G::kStageVecs;
      uint4* vst = kst + kBK * KS;
      int* fl = flags + (t % kStages) * kBK;
      for (int r = threadIdx.x; r < kBK; r += blockDim.x)
        fl[r] = r < n ? (__ldg(trow + (start + r) / bs) >= 0 ? 1 : 2) : 0;
      for (int i = threadIdx.x; i < n * vpr; i += blockDim.x) {
        const int r = i / vpr;
        const int c = i % vpr;
        const int pos = start + r;
        const int entry = __ldg(trow + pos / bs);
        const size_t blk = min(max(entry, 0), nb - 1);  // dead: block 0
        const size_t src = ((blk * hkv + kvh) * bs + pos % bs) * vpr + c;
        cp_async16(kst + r * KS + c, reinterpret_cast<const uint4*>(k) + src);
        cp_async16(vst + r * VPR + c, reinterpret_cast<const uint4*>(v) + src);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float m[R];
  float l[R];
  float acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }
  const float* qw = qs + warp * R * D;  // this warp's R rows
  const int row0 = q0 + warp * R;       // chunk index of its first row

  load_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    load_tile(t + 1);
    cp_async_wait_one();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();      // ... for every thread, with its flags
    const int start = (t_lo + t) * kBK;
    const uint4* kst = smem + (t % kStages) * G::kStageVecs;
    const float* vs = reinterpret_cast<const float*>(kst + kBK * KS);
    const int flag = flags[(t % kStages) * kBK + lane];

    // Lane j scores key start + j against the warp's R rows.
    const int key = start + lane;
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    if (flag != 0) {
      const uint4* kr = kst + lane * KS;
#pragma unroll 4
      for (int c = 0; c < VPR; ++c) {
        float kf[4];
        Elem<float>::unpack(kr[c], kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qw + r * D + c * 4);
          sc[r] += qv.x * kf[0] + qv.y * kf[1] + qv.z * kf[2] + qv.w * kf[3];
        }
      }
    }

    // Merge the tile into each row's carry.
    float pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = off + row0 + r;
      // A dead page's key is hidden from the real rows only.
      const bool vis = (flag == 1 || (flag == 2 && row0 + r >= nv)) &&
                       key <= qpos && (window == 0 || qpos - key < window);
      const float sr = vis ? sc[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      const float p = vis ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
      pr[r] = p;
    }
    for (int j = 0; j < kBK; ++j) {
      float pj[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pj[r] = __shfl_sync(0xffffffffu, pr[r], j);
        any |= pj[r] != 0.f;
      }
      if (!any) continue;  // the same for every lane: j is masked for all
      const float* vr = vs + j * D + lane * E;
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vf[e] = vr[e];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int e = 0; e < E; ++e) acc[r][e] += pj[r] * vf[e];
    }
    __syncthreads();  // the stage is free for the copy issued next
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i >= chunk) continue;
    const float inv_l = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int col = lane * E + e;
      if (col < d) o[static_cast<size_t>(i) * d + col] = acc[r][e] * inv_l;
    }
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const int* tables, const int* offsets,
                       const int* n_valid, void* out, int lanes, int h,
                       int hkv, int chunk, int nb, int bs, int tpr, int d,
                       int window, float scale, cudaStream_t stream) {
  if (d % 4 != 0) return cudaErrorInvalidValue;
  const size_t smem = FmaTile<D>::kBytes;
  const cudaError_t err = allow_smem(paged_prefill_fma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (chunk + kBQ - 1) / kBQ;
  paged_prefill_fma_kernel<D><<<n_qt * lanes * h, 32 * kWarps, smem,
                                stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), tables, offsets, n_valid,
      static_cast<float*>(out), lanes, h, hkv, chunk, nb, bs, tpr, d, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

// q, out [lanes, h, chunk, d] and the k/v pools [nb, hkv, bs, d], all
// contiguous and 16-byte aligned, in one dtype (0: f32, on the CUDA
// cores; 1: bf16, on the tensor cores); a row of d elements is a whole
// number of 16-byte vectors, d <= 256; tables [lanes, tpr], offsets and
// n_valid [lanes], int32 on the device.  bf16 takes bs a multiple of 8
// that divides 64 or that 64 divides (32 at d over 128).  window 0 means
// no window; scale multiplies q.k.  Returns a cudaError_t: 0 on a
// successful launch.
extern "C" int paged_flash_prefill(const void* q, const void* k,
                                   const void* v, const int* tables,
                                   const int* offsets, const int* n_valid,
                                   void* out, int lanes, int h, int hkv,
                                   int chunk, int nb, int bs, int tpr, int d,
                                   int dtype, int window, float scale,
                                   int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes < 1 || h < 1 || hkv < 1 || chunk < 1 || nb < 1 || bs < 1 ||
      tpr < 1 || h % hkv != 0 || window < 0 ||
      static_cast<long long>(tpr) * bs + chunk > 0x7fffffffLL ||
      static_cast<long long>((chunk + kBQ - 1) / kBQ) * lanes * h >
          0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      dispatch(dtype, built_width(d), [&](auto tag, auto dim) {
        using T = std::remove_pointer_t<decltype(tag)>;
        constexpr int D = decltype(dim)::value;
        if constexpr (std::is_same_v<T, float>) {
          return launch_fma<D>(q, k, v, tables, offsets, n_valid, out, lanes,
                               h, hkv, chunk, nb, bs, tpr, d, window, scale,
                               s);
        } else {
          return launch_tc<D>(q, k, v, tables, offsets, n_valid, out, lanes,
                              h, hkv, chunk, nb, bs, tpr, d, window, scale,
                              s);
        }
      }));
}
