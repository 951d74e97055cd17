// One ring-attention hop (K5) for NVIDIA Hopper, sm_90a: the visiting
// K/V block merged into the caller's f32 online-softmax carry.
//
// Replaces tpu_autoscaler/workloads/attention.py::_ring_step_kernel, the
// Pallas kernel behind ring_flash_step.  Same function: q [b, h, sq, d]
// (this rank's queries) against the visiting k/v [b, hkv, sk, d]; query
// head g reads KV head g / (h / hkv).  Scores are q.k * scale with f32
// sums (the caller passes scale = d^-0.5 of the model's true head_dim);
// when `masked`, key k is visible to query row i iff 0 <= offset + i - k
// (and offset + i - k < window when there is a window), where offset =
// global(q block start) - global(k block start); an unmasked hop sees
// every key.  The carry m, l [b, h, sq] and acc [b, h, sq, d] (f32) is
// read from m_in/l_in/acc_in and the merged carry written to
// m_out/l_out/acc_out (the wrapper passes fresh tensors, so the carry the
// caller holds is never overwritten):
//
//   m' = max(m, max_k s),  l' = l e^(m - m') + sum_k e^(s - m'),
//   acc' = acc e^(m - m') + sum_k round(e^(s - m')) v_k
//
// with masked scores at -1e30, P rounded to v's dtype before PV.
//
// What bounds it.  A hop must move q, k, v and the f32 carry in and out
// once and do 4*d flops per visible (query head, key) pair.  At the SP
// training hop (b 2, h 8, s 2048, d 128, bf16) that is ~580 flops per
// byte for an unmasked hop, above the ~295 at which the tensor cores and
// not the memory are the limit: the products must run on the tensor
// cores, and the carry (33.6 of the hop's 59 MB) must still move once.
//
// bf16: wgmma, TMA and a warp-specialised CTA (ring_step_tc_kernel).
//
// - One CTA per (row, query head, kBQ = 128 query rows): two consumer
//   warpgroups of 64 rows and a producer warpgroup, one warp of which
//   issues the loads (setmaxnreg hands the other registers to the
//   consumers: 232 a thread); the last q-tiles (the most keys in a
//   diagonal hop) are scheduled first.
// - The producer loads the q tile once and keeps a ring of kStages K/V
//   tiles (BK keys x d) in shared memory, each by TMA in the 128-byte
//   swizzle (one box per 64 columns), completing on an mbarrier; the
//   consumers free a stage with an arrival on its "empty" barrier.
// - S = Q.K^T: wgmma m64nBKk16, both operands K-major in shared memory.
// - The online softmax on the S fragment in registers (exp2f with
//   log2(e) folded in; masked scores at -1e30 before the max; a tile
//   every row of the warpgroup sees whole skips the mask).
// - Pipelined within a warpgroup: tile t's S = Q.K^T and tile t - 1's
//   O += P.V are issued together, and tile t's softmax runs while P.V is
//   on the tensor cores; O is rescaled once P.V has landed.
// - O += P.V: P rounded to bf16 stays in registers as wgmma's A operand
//   (the accumulator's fragment is that operand's layout), V is read
//   MN-major (wgmma's transpose flag), in N = 64 or 128 column pieces.
// - The carry: m, l and acc are read once from HBM straight into the
//   accumulator's fragment layout and written once into fresh outputs.
// - The CTA loops only over the k-tiles its q-tile sees in this hop, and
//   a warpgroup skips the tiles none of its own rows sees.
// - Tiles per head_dim: d 32 and 64 take one 64-column atom (d 32 as
//   zeros past its width, filled by TMA), BK = 64 keys, 3 stages; d 128
//   two atoms, BK 64, 3 stages (129 KB of shared memory); d 256 four
//   atoms, BK = 32 keys (the O accumulator is then 128 registers a
//   thread, and a 64-key S would not fit beside it), 3 stages (161 KB).
//   Deeper rings (5 stages) ran slower on an H100.
//
// f32: the CUDA-core kernel (ring_step_fma_kernel), as before: tensor
// cores would run f32 as TF32 (about three decimal digits).  One CTA per
// (row, query head, 32 query rows), 8 warps of 4 rows; K/V tiles of 32
// keys staged by cp.async, double-buffered; lane j scores key j against
// the warp's rows; PV takes each key's P by shuffle.  Its ceiling is the
// 67 TFLOP/s f32 rate.
//
// A row that sees no key of a masked hop while its carried m is still
// -1e30 gets what the TPU kernel gives it, since the reference does not
// guard that case: every key's P is e^(-1e30 - (-1e30)) = 1, so l grows
// by sk and acc by the sum of the block's v.  A CTA holding such a row
// loops over the whole block.  The ring never makes such a row (every
// rank's first hop is its own diagonal block, which every row sees); a
// lone call can.
//
// Any sq and sk: tiles are fixed and the tails are masked (TMA reads
// zeros past sq and sk; keys past sk take P = 0).  Query rows past sq are
// never written.
//
// Interface: a plain C function (ring_flash_step at the bottom), built
// with nvcc into a shared library and called through ctypes.  It launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "decode_common.cuh"
#include "hopper_tc.cuh"

namespace {

using namespace decode;
using namespace tc;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane

// Shared memory: kStages stages of [K tile (padded rows) | V tile], then
// the CTA's q rows as f32 (K1's layout).
template <typename T, int D>
struct HopTile {
  static constexpr int kVec = 16 / sizeof(T);      // elements per vector
  static constexpr int kVpr = D / kVec;            // vectors per row
  static constexpr int kKStride = kVpr + 1;        // padded K row
  static constexpr int kStageVecs = kBK * (kKStride + kVpr);
  static constexpr size_t kBytes =
      static_cast<size_t>(kStages) * kStageVecs * 16 +
      static_cast<size_t>(kBQ) * D * sizeof(float);
};

// Block = kWarps warps; grid = n_qt * b * h, the last q-tiles first.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
    ring_step_fma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const float* __restrict__ m_in,
                           const float* __restrict__ l_in,
                           const float* __restrict__ acc_in,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out,
                           float* __restrict__ acc_out, int bh_count, int h,
                           int hkv, int sq, int sk, int offset, int masked,
                           int window, float scale) {
  using G = HopTile<T, D>;
  constexpr int VPR = G::kVpr;
  constexpr int KS = G::kKStride;
  constexpr int VEC = G::kVec;
  constexpr int E = D / 32;             // acc elements per lane per row
  constexpr int R = kRowsPerWarp;
  extern __shared__ uint4 smem[];
  float* qs = reinterpret_cast<float*>(smem + kStages * G::kStageVecs);

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;             // row * h + head
  const int qt = n_qt - 1 - blockIdx.x / bh_count;  // last tiles first
  const int head = bh % h;
  const int kvh = bh / h * hkv + head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, sq) - 1;

  // The q tile, as f32 (rows past sq as zeros, never written out).
  const size_t q_row0 = static_cast<size_t>(bh) * sq + q0;
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D;
    qs[i] = q0 + r < sq ? Elem<T>::load(q[q_row0 * D + i]) : 0.f;
  }

  // The keys this q-tile can see in the hop, [k_lo, k_hi] clamped to the
  // block; the whole block if one of its rows sees no key while its
  // carried m is still -1e30 (see the head of the file).
  int k_lo = 0;
  int k_hi = sk - 1;
  bool lone = false;
  if (masked) {
    k_hi = min(sk - 1, offset + q_last);
    if (window > 0) k_lo = max(0, offset + q0 - window + 1);
    const int i = q0 + static_cast<int>(threadIdx.x);
    if (threadIdx.x < kBQ && i < sq) {
      const int lo = window > 0 ? max(0, offset + i - window + 1) : 0;
      const int hi = min(sk - 1, offset + i);
      lone = hi < lo && m_in[static_cast<size_t>(bh) * sq + i] == kNegInf;
    }
  }
  if (__syncthreads_or(lone)) {
    k_lo = 0;
    k_hi = sk - 1;
  }
  const int t_lo = k_lo / kBK;
  const int ntiles = k_hi < k_lo ? 0 : k_hi / kBK - t_lo + 1;

  const size_t kv_row0 = static_cast<size_t>(kvh) * sk;
  const uint4* kg = reinterpret_cast<const uint4*>(k) + kv_row0 * VPR;
  const uint4* vg = reinterpret_cast<const uint4*>(v) + kv_row0 * VPR;

  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int start = (t_lo + t) * kBK;
      const int n = min(kBK, sk - start);
      uint4* kst = smem + (t % kStages) * G::kStageVecs;
      uint4* vst = kst + kBK * KS;
      for (int i = threadIdx.x; i < n * VPR; i += blockDim.x) {
        const int r = i / VPR;
        const int c = i % VPR;
        const size_t src = static_cast<size_t>(start + r) * VPR + c;
        cp_async16(kst + r * KS + c, kg + src);
        cp_async16(vst + r * VPR + c, vg + src);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  // The carried (m, l, acc) of the warp's rows (rows past sq: the fresh
  // carry, never written out).
  const int row0 = q0 + warp * R;       // position of the warp's first row
  float m[R];
  float l[R];
  float acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    const size_t o = static_cast<size_t>(bh) * sq + i;
    const bool in = i < sq;
    m[r] = in ? m_in[o] : kNegInf;
    l[r] = in ? l_in[o] : 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc[r][e] = in ? acc_in[o * D + lane * E + e] : 0.f;
  }
  const float* qw = qs + warp * R * D;  // this warp's R rows

  load_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    load_tile(t + 1);
    cp_async_wait_one();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();      // ... for every thread; the q tile too
    const int start = (t_lo + t) * kBK;
    const int n = min(kBK, sk - start);
    const uint4* kst = smem + (t % kStages) * G::kStageVecs;
    const T* vs = reinterpret_cast<const T*>(kst + kBK * KS);

    // Lane j scores key start + j against the warp's R rows.
    const int key = start + lane;
    float sc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = 0.f;
    if (lane < n) {
      const uint4* kr = kst + lane * KS;
#pragma unroll 4
      for (int c = 0; c < VPR; ++c) {
        float kf[VEC];
        Elem<T>::unpack(kr[c], kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* q4 =
              reinterpret_cast<const float4*>(qw + r * D + c * VEC);
#pragma unroll
          for (int i = 0; i < VEC / 4; ++i) {
            const float4 qv = q4[i];
            sc[r] += qv.x * kf[4 * i] + qv.y * kf[4 * i + 1] +
                     qv.z * kf[4 * i + 2] + qv.w * kf[4 * i + 3];
          }
        }
      }
    }

    // Merge the tile into each row's carry.  A masked key scores -1e30,
    // as in the reference, so its P is e^(-1e30 - m'): 0 once the row's
    // max is a real score, 1 while it is still -1e30.  Lanes past the
    // tile (and rows past sq) add nothing.  P rounded to v's dtype.
    float pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      const bool live = lane < n && i < sq;
      const bool vis = live && hop_visible(i, key, offset, masked, window);
      const float sr = vis ? sc[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      const float p = live ? expf(sr - m_new) : 0.f;
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[r][e] *= corr;
      pr[r] = Elem<T>::round(p);
    }
    for (int j = 0; j < n; ++j) {
      float pj[R];
      bool any = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pj[r] = __shfl_sync(0xffffffffu, pr[r], j);
        any |= pj[r] != 0.f;
      }
      if (!any) continue;  // the same for every lane: j adds nothing
      const T* vr = vs + j * D + lane * E;
      float vf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) vf[e] = Elem<T>::load(vr[e]);
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
    if (i >= sq) continue;
    const size_t o = static_cast<size_t>(bh) * sq + i;
#pragma unroll
    for (int e = 0; e < E; ++e) acc_out[o * D + lane * E + e] = acc[r][e];
    if (lane == 0) {
      m_out[o] = m[r];
      l_out[o] = l[r];
    }
  }
}

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int kConsumers = 2;                   // warpgroups of 64 rows
constexpr int kTcThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kTcBQ = 64 * kConsumers;          // query rows per CTA

template <int D>
struct TcTile {
  static constexpr int DA = D < 64 ? 64 : D;    // columns the tiles hold
  static constexpr int kAtoms = DA / 64;
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per tile
  static constexpr int kStages = 3;              // K/V tiles in flight
  static constexpr int kQAtom = kTcBQ * 128;     // bytes of one q atom
  static constexpr int kKAtom = BK * 128;        // ... of one K or V atom
  static constexpr int kQBytes = kAtoms * kQAtom;
  static constexpr int kKVBytes = kAtoms * kKAtom;  // K or V of a stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  // 1024 bytes of slack to align the tiles, the tiles, the barriers.
  static constexpr size_t kSmem =
      1024 + kQBytes + static_cast<size_t>(kStages) * kStageBytes + 128;
};

// One consumer warpgroup: its 64 query rows' carry in, every staged
// k-tile merged, the carry out.
template <int D>
__device__ __forceinline__ void consume(
    uint32_t q_tile, uint32_t stages, uint32_t bars, uint32_t q_bar,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    const float* __restrict__ acc_in, float* __restrict__ m_out,
    float* __restrict__ l_out, float* __restrict__ acc_out, int bh, int q0,
    int t_lo, int ntiles, bool whole, int sq, int sk, int d, int offset,
    int masked, int window, float scale) {
  using G = TcTile<D>;
  constexpr int DA = G::DA;
  constexpr int BK = G::BK;
  constexpr int NS = BK / 2;        // S registers a thread
  constexpr int NO = DA / 2;        // O registers a thread
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int g = lane / 4;
  const int c2 = 2 * (lane % 4);
  int rows[2];
  rows[0] = q0 + 64 * wg + (warp % 4) * 16 + g;
  rows[1] = rows[0] + 8;
  float m[2], l[2];
  float o[NO];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool in = rows[j] < sq;
    const size_t r = static_cast<size_t>(bh) * sq + rows[j];
    m[j] = in ? m_in[r] : kNegInf;
    l[j] = in ? l_in[r] : 0.f;
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      const int col = 8 * i + c2;
      float2 a = make_float2(0.f, 0.f);
      if (in && col < d)
        a = *reinterpret_cast<const float2*>(acc_in + r * d + col);
      o[4 * i + 2 * j] = a.x;
      o[4 * i + 2 * j + 1] = a.y;
    }
  }
  // The keys this warpgroup's rows see: it skips the tiles outside them
  // (unless the CTA runs the whole block).
  const int w_r0 = q0 + 64 * wg;
  const int w_r1 = min(w_r0 + 63, sq - 1);
  int w_lo, w_hi;
  hop_keys(w_r0, w_r1, sk, offset, masked, window, w_lo, w_hi);
  if (w_r0 > w_r1) w_hi = -1;
  if (whole) {
    w_lo = 0;
    w_hi = sk - 1;
  }

  const uint32_t q_wg = q_tile + wg * 64 * 128;
  auto stage_of = [&](int t) {
    return stages + (t % G::kStages) * G::kStageBytes;
  };
  auto wait_full = [&](int t) {
    mbar_wait(bars + 8 * (t % G::kStages), (t / G::kStages) & 1);
  };
  auto release = [&](int t) {
    mbar_arrive(bars + 64 + 8 * (t % G::kStages));
  };
  // S = Q.K^T of tile t into sc (issued, not waited for).
  float sc[NS];
  auto issue_s = [&](int t) {
    const uint32_t kst = stage_of(t);
#pragma unroll
    for (int kk = 0; kk < DA / 16; ++kk) {
      if constexpr (BK == 64)
        wgmma_ss_n64(sc, desc_k(q_wg, kk, G::kQAtom),
                     desc_k(kst, kk, G::kKAtom), kk > 0);
      else
        wgmma_ss_n32(sc, desc_k(q_wg, kk, G::kQAtom),
                     desc_k(kst, kk, G::kKAtom), kk > 0);
    }
    wgmma_commit();
  };
  // O += P.V of tile t, P as bf16 in registers (issued, not waited for).
  uint32_t pa[BK / 16][4];
  auto issue_pv = [&](int t) {
    const uint32_t vst = stage_of(t) + G::kKVBytes;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (DA == 64) {
        wgmma_rs_n64(o, pa[kk], desc_mn(vst, kk, 0, G::kKAtom), 1);
      } else {
#pragma unroll
        for (int n = 0; n < DA / 128; ++n)
          wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(o + 64 * n), pa[kk],
                        desc_mn(vst, kk, 2 * n, G::kKAtom), 1);
      }
    }
    wgmma_commit();
  };
  // The online softmax of tile t's scores in sc: m and l updated, sc
  // replaced by P, and the factor O must be scaled by returned in corr.
  // A tile that every row of the warpgroup sees whole takes no mask: its
  // row max is scale times the raw max (scale > 0), and P one FFMA and
  // one exp2 a score.  Otherwise masked scores are -1e30 before the max
  // and keys past sk take P = 0.
  auto softmax = [&](int t, float (&corr)[2]) {
    const int start = (t_lo + t) * BK;
    const bool whole_tile = tile_visible(w_r0, w_r1, start, start + BK - 1,
                                         sk, offset, masked, window);
    float mx[2] = {kNegInf, kNegInf};
    if (whole_tile) {
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int j = (x / 2) % 2;  // register x = 4 i + 2 j + c
        mx[j] = fmaxf(mx[j], sc[x]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS / 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = start + 8 * i + c2 + c;
            const float x =
                key < sk && hop_visible(rows[j], key, offset, masked, window)
                    ? sc[4 * i + 2 * j + c] * scale
                    : kNegInf;
            sc[4 * i + 2 * j + c] = x;
            mx[j] = fmaxf(mx[j], x);
          }
    }
    float m_l2[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 1));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], 2));
      if (whole_tile) mx[j] *= scale;
      const float m_new = fmaxf(m[j], mx[j]);
      corr[j] = exp2f((m[j] - m_new) * kLog2e);
      m[j] = m_new;
      m_l2[j] = m_new * kLog2e;
    }
    float sum[2] = {0.f, 0.f};
    if (whole_tile) {
      const float scale_l2 = scale * kLog2e;
#pragma unroll
      for (int x = 0; x < NS; ++x) {
        const int j = (x / 2) % 2;
        sc[x] = exp2f(fmaf(sc[x], scale_l2, -m_l2[j]));
        sum[j] += sc[x];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS / 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int key = start + 8 * i + c2 + c;
            const float p =
                key < sk ? exp2f((sc[4 * i + 2 * j + c] - m[j]) * kLog2e)
                         : 0.f;
            sc[4 * i + 2 * j + c] = p;
            sum[j] += p;
          }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 1);
      sum[j] += __shfl_xor_sync(0xffffffffu, sum[j], 2);
      l[j] = l[j] * corr[j] + sum[j];
    }
  };
  auto rescale_o = [&](const float (&corr)[2]) {
#pragma unroll
    for (int i = 0; i < NO / 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        o[4 * i + 2 * j] *= corr[j];
        o[4 * i + 2 * j + 1] *= corr[j];
      }
  };

  // The k-tiles this warpgroup computes, [t_a, t_b] (the others it only
  // waits for and frees).  Pipelined: tile t's S = Q.K^T and tile t - 1's
  // O += P.V are issued together, and tile t's softmax runs while P.V is
  // on the tensor cores.
  const int t_a = max(0, w_lo / BK - t_lo);
  const int t_b =
      w_hi < w_lo ? -1 : min(ntiles - 1, w_hi / BK - t_lo);
  mbar_wait(q_bar, 0);
  if (t_a > t_b) {
    for (int t = 0; t < ntiles; ++t) {
      wait_full(t);
      release(t);
    }
  } else {
    for (int t = 0; t < t_a; ++t) {
      wait_full(t);
      release(t);
    }
    float corr[2];
    wait_full(t_a);
    wgmma_fence();
    issue_s(t_a);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax(t_a, corr);
    rescale_o(corr);
    to_a_frags(sc, pa);
    for (int t = t_a + 1; t <= t_b; ++t) {
      wait_full(t);
      wgmma_fence();
      issue_s(t);
      issue_pv(t - 1);
      wgmma_wait<1>();  // S of tile t is in; P.V of t - 1 may still run
      fence_regs(sc);
      softmax(t, corr);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(t - 1);
      rescale_o(corr);
      to_a_frags(sc, pa);
    }
    wgmma_fence();
    issue_pv(t_b);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(t_b);
    for (int t = t_b + 1; t < ntiles; ++t) {
      wait_full(t);
      release(t);
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (rows[j] >= sq) continue;
    const size_t r = static_cast<size_t>(bh) * sq + rows[j];
    if (lane % 4 == 0) {
      m_out[r] = m[j];
      l_out[r] = l[j];
    }
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      const int col = 8 * i + c2;
      if (col < d)
        *reinterpret_cast<float2*>(acc_out + r * d + col) =
            make_float2(o[4 * i + 2 * j], o[4 * i + 2 * j + 1]);
    }
  }
}

// Block = 2 consumer warpgroups + 1 producer warpgroup (one working
// warp); grid = n_qt * b * h, the last q-tiles first.
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    ring_step_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const float* __restrict__ acc_in,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ acc_out, int bh_count, int h,
                        int hkv, int sq, int sk, int d, int offset,
                        int masked, int window, float scale) {
  using G = TcTile<D>;
  constexpr int BK = G::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t stages = base + G::kQBytes;
  const uint32_t bars = stages + G::kStages * G::kStageBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 64 + 8 s, the q tile's at
  // bars + 120.
  const uint32_t q_bar = bars + 120;

  const int n_qt = (sq + kTcBQ - 1) / kTcBQ;
  const int bh = blockIdx.x % bh_count;             // row * h + head
  const int qt = n_qt - 1 - blockIdx.x / bh_count;  // last tiles first
  const int head = bh % h;
  const int kvh = bh / h * hkv + head / (h / hkv);
  const int q0 = qt * kTcBQ;
  const int q_last = min(q0 + kTcBQ, sq) - 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 64 + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }

  // The keys the q-tile sees; the whole block if one of its rows sees no
  // key while its carried m is still -1e30 (see the head of the file).
  int k_lo, k_hi;
  hop_keys(q0, q_last, sk, offset, masked, window, k_lo, k_hi);
  bool lone = false;
  if (masked && threadIdx.x < kTcBQ && q0 + threadIdx.x < sq) {
    const int i = q0 + threadIdx.x;
    int lo, hi;
    hop_keys(i, i, sk, offset, masked, window, lo, hi);
    lone = hi < lo && m_in[static_cast<size_t>(bh) * sq + i] == kNegInf;
  }
  const bool whole = __syncthreads_or(lone);  // also publishes the barriers
  if (whole) {
    k_lo = 0;
    k_hi = sk - 1;
  }
  const int t_lo = k_lo / BK;
  const int ntiles = k_hi < k_lo ? 0 : k_hi / BK - t_lo + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * kConsumers) {
    // Producer: the q tile, then the K/V ring.
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers && lane == 0) {
      mbar_expect_tx(q_bar, G::kQBytes);
#pragma unroll
      for (int a = 0; a < G::kAtoms; ++a)
        tma_load(q_tile + a * G::kQAtom, &q_map, 64 * a, q0, bh, q_bar);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % G::kStages;
        if (t >= G::kStages)
          mbar_wait(bars + 64 + 8 * s, ((t / G::kStages) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t kst = stages + s * G::kStageBytes;
        const int start = (t_lo + t) * BK;
        mbar_expect_tx(full, G::kStageBytes);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          tma_load(kst + a * G::kKAtom, &k_map, 64 * a, start, kvh, full);
          tma_load(kst + G::kKVBytes + a * G::kKAtom, &v_map, 64 * a, start,
                   kvh, full);
        }
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    consume<D>(q_tile, stages, bars, q_bar, m_in, l_in, acc_in, m_out,
               l_out, acc_out, bh, q0, t_lo, ntiles, whole, sq, sk, d, offset,
               masked, window, scale);
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const float* m_in, const float* l_in,
                       const float* acc_in, float* m_out, float* l_out,
                       float* acc_out, int b, int h, int hkv, int sq, int sk,
                       int offset, int masked, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = HopTile<float, D>::kBytes;
  const cudaError_t err = allow_smem(ring_step_fma_kernel<float, D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  ring_step_fma_kernel<float, D>
      <<<n_qt * b * h, 32 * kWarps, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), m_in, l_in, acc_in, m_out, l_out,
          acc_out, b * h, h, hkv, sq, sk, offset, masked, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v,
                      const float* m_in, const float* l_in,
                      const float* acc_in, float* m_out, float* l_out,
                      float* acc_out, int b, int h, int hkv, int sq, int sk,
                      int offset, int masked, int window, float scale,
                      cudaStream_t stream) {
  constexpr int DK = D < 64 ? 64 : D;  // the instantiation d 32 runs in
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = tc::make_map(&q_map, q, D, sq, b * h, kTcBQ);
  if (err == cudaSuccess)
    err = tc::make_map(&k_map, k, D, sk, b * hkv, TcTile<DK>::BK);
  if (err == cudaSuccess)
    err = tc::make_map(&v_map, v, D, sk, b * hkv, TcTile<DK>::BK);
  if (err != cudaSuccess) return err;
  const size_t smem = TcTile<DK>::kSmem;
  err = allow_smem(ring_step_tc_kernel<DK>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kTcBQ - 1) / kTcBQ;
  ring_step_tc_kernel<DK><<<n_qt * b * h, kTcThreads, smem, stream>>>(
      q_map, k_map, v_map, m_in, l_in, acc_in, m_out, l_out, acc_out, b * h,
      h, hkv, sq, sk, D, offset, masked, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q [b, h, sq, d] and k, v [b, hkv, sk, d], contiguous and 16-byte aligned,
// in one dtype (0: f32, on the CUDA cores; 1: bf16, on the tensor cores);
// m_in, l_in, m_out, l_out [b, h, sq] and acc_in, acc_out [b, h, sq, d],
// f32 and contiguous (out may not alias in).  masked 0 or 1; window 0
// means no window (read only when masked); scale multiplies q.k.  Returns
// a cudaError_t: 0 on a successful launch.
extern "C" int ring_flash_step(const void* q, const void* k, const void* v,
                               const void* m_in, const void* l_in,
                               const void* acc_in, void* m_out, void* l_out,
                               void* acc_out, int b, int h, int hkv, int sq,
                               int sk, int d, int dtype, int offset,
                               int masked, int window, float scale,
                               int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || h < 1 || hkv < 1 || sq < 1 || sk < 1 || h % hkv != 0 ||
      window < 0 ||
      static_cast<long long>((sq + kBQ - 1) / kBQ) * b * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int D = decltype(dim)::value;
    auto run = std::is_same_v<T, float> ? launch_fma<D> : launch_tc<D>;
    return run(q, k, v, static_cast<const float*>(m_in),
               static_cast<const float*>(l_in),
               static_cast<const float*>(acc_in), static_cast<float*>(m_out),
               static_cast<float*>(l_out), static_cast<float*>(acc_out), b, h,
               hkv, sq, sk, offset, masked != 0, window, scale, st);
  }));
}
