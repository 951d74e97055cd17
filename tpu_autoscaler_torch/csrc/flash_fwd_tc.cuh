// The bf16 tensor-core forward tile for NVIDIA Hopper, sm_90a, shared by
// the flash-attention forward (K1, flash_attention.cu), the ring hop
// (K5, ring_flash_step.cu) and the paged prefill (K7,
// paged_flash_prefill.cu, whose CTA has a producer of its own and runs
// this consumer).
//
// Both merge the K/V tiles a q-tile sees into an f32 online-softmax carry
//
//   m' = max(m, max_k s),  l' = l e^(m - m') + sum_k e^(s - m'),
//   acc' = acc e^(m - m') + sum_k round(e^(s - m')) v_k
//
// with scores s = q.k * scale (f32 sums), masked scores at -1e30 and P
// rounded to bf16 before P.V, under the hop's mask (hopper_tc.cuh).  K1
// is K5 at offset 0 over its own block (masked = causal, sq = sk = s)
// from a fresh carry, normalised.  They differ only in where the carry
// starts and ends, the IO type of the kernel:
//
// - HopCarry (K5): read once from HBM into the accumulator's fragment
//   layout and written once, merged, into fresh f32 tensors; a row that
//   sees no key of a masked hop while its carried m is still -1e30 takes
//   P = 1 for every key, as the reference does, and a CTA holding one
//   loops over the whole block.
// - Normalised (K1): starts in registers at (-1e30, 0, 0) and is never
//   read from or written to HBM; the epilogue writes out = acc / l in
//   bf16 and lse = m + log(l) in f32.  Every causal row sees its diagonal
//   key, so there is no lone row.
// - PagedOut (K7): as Normalised, with no lse, and with keys the producer
//   flags per stage (dead pages): for the rows below io.nv a flagged key
//   is masked like a key outside the hop's mask (the rows from io.nv on
//   read it as it was loaded), a masked key takes P = 0 even while m is
//   still -1e30, and a row that sees no key is written as zeros.
//
// The CTA (fwd_tc_kernel):
//
// - one CTA per (row, query head, kTcRows = 128 query rows): two consumer
//   warpgroups of 64 rows and a producer warpgroup, one warp of which
//   issues the loads (setmaxnreg hands the other registers to the
//   consumers: 232 a thread); the last q-tiles (the most keys under a
//   causal mask) are scheduled first;
// - the producer loads the q tile once and keeps a ring of kStages K/V
//   tiles (BK keys x d) in shared memory, each by TMA in the 128-byte
//   swizzle (one box per 64 columns), completing on an mbarrier; the
//   consumers free a stage with an arrival on its "empty" barrier;
// - S = Q.K^T: wgmma m64nBKk16, both operands K-major in shared memory;
// - the online softmax on the S fragment in registers (exp2f with
//   log2(e) folded in; masked scores at -1e30 before the max; a tile
//   every row of the warpgroup sees whole skips the mask);
// - pipelined within a warpgroup: tile t's S = Q.K^T and tile t - 1's
//   O += P.V are issued together, and tile t's softmax runs while P.V is
//   on the tensor cores; O is rescaled once P.V has landed;
// - O += P.V: P rounded to bf16 stays in registers as wgmma's A operand
//   (the accumulator's fragment is that operand's layout), V is read
//   MN-major (wgmma's transpose flag), in N = 64 or 128 column pieces;
// - the CTA loops only over the k-tiles its q-tile sees, and a
//   warpgroup skips the tiles none of its own rows sees;
// - tiles per head_dim: d 32 and 64 take one 64-column atom (d 32 as
//   zeros past its width, filled by TMA); d 128 two atoms; d 256 four
//   atoms with BK = 32 keys (the O accumulator is then 128 registers a
//   thread, and a 64-key S would not fit beside it); BK = 64 otherwise
//   unless the caller picks 128; 3 stages.
//
// Any sq and sk: tiles are fixed and the tails are masked (TMA reads
// zeros past sq and sk; keys past sk take P = 0).  Query rows past sq are
// never written.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "decode_common.cuh"
#include "hopper_tc.cuh"

namespace tc {

using decode::kNegInf;

// K5's carry: f32 m, l [b, h, sq] and acc [b, h, sq, d] read from the
// *_in tensors and written, merged, to the *_out tensors.
struct HopCarry {
  static constexpr bool kFresh = false;
  static constexpr bool kPaged = false;
  const float* m_in;
  const float* l_in;
  const float* acc_in;
  float* m_out;
  float* l_out;
  float* acc_out;
};

// K1's: a fresh carry in registers; out [b, h, s, d] bf16 = acc / l and
// lse [b, h, s] f32 = m + log(l).
struct Normalised {
  static constexpr bool kFresh = true;
  static constexpr bool kPaged = false;
  __nv_bfloat16* out;
  float* lse;
};

// K7's: a fresh carry in registers; out (the rows of one lane and query
// head, d apart) bf16 = acc / l, zeros for a row that sees no key; no
// lse.  dead: the stages' flag words in shared memory, BK / 32 a stage,
// bit k of a stage's words set when key k of its tile lies in a dead
// page, which hides the key from the rows below nv only.
struct PagedOut {
  static constexpr bool kFresh = true;
  static constexpr bool kPaged = true;
  __nv_bfloat16* out;
  const uint32_t* dead;
  int nv;
};

template <int D, int BK_ = (D == 256 ? 32 : 64)>
struct FwdTile {
  static constexpr int DA = D < 64 ? 64 : D;    // columns the tiles hold
  static constexpr int kAtoms = DA / 64;
  static constexpr int BK = BK_;                 // keys per tile
  static constexpr int kStages = 3;              // K/V tiles in flight
  static constexpr int kQAtom = kTcRows * 128;   // bytes of one q atom
  static constexpr int kKAtom = BK * 128;        // ... of one K or V atom
  static constexpr int kQBytes = kAtoms * kQAtom;
  static constexpr int kKVBytes = kAtoms * kKAtom;  // K or V of a stage
  static constexpr int kStageBytes = 2 * kKVBytes;
  // 1024 bytes of slack to align the tiles, the tiles, the barriers.
  static constexpr size_t kSmem =
      1024 + kQBytes + static_cast<size_t>(kStages) * kStageBytes + 128;
};

// One consumer warpgroup: its 64 query rows' carry started, every staged
// k-tile merged, the carry ended (IO).
template <int D, int BK, typename IO>
__device__ __forceinline__ void consume(uint32_t q_tile, uint32_t stages,
                                        uint32_t bars, uint32_t q_bar,
                                        const IO io, int bh, int q0,
                                        int t_lo, int ntiles, bool whole,
                                        int sq, int sk, int d, int offset,
                                        int masked, int window, float scale) {
  using G = FwdTile<D, BK>;
  constexpr int DA = G::DA;
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
    if constexpr (IO::kFresh) {
      m[j] = kNegInf;
      l[j] = 0.f;
#pragma unroll
      for (int i = 0; i < NO / 4; ++i)
        o[4 * i + 2 * j] = o[4 * i + 2 * j + 1] = 0.f;
    } else {
      const bool in = rows[j] < sq;
      const size_t r = static_cast<size_t>(bh) * sq + rows[j];
      m[j] = in ? __ldg(io.m_in + r) : kNegInf;
      l[j] = in ? __ldg(io.l_in + r) : 0.f;
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        const int col = 8 * i + c2;
        float2 a = make_float2(0.f, 0.f);
        if (in && col < d)
          a = __ldg(reinterpret_cast<const float2*>(io.acc_in + r * d + col));
        o[4 * i + 2 * j] = a.x;
        o[4 * i + 2 * j + 1] = a.y;
      }
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
      if constexpr (BK == 128)
        wgmma_ss_n128(sc, desc_k(q_wg, kk, G::kQAtom),
                      desc_k(kst, kk, G::kKAtom), kk > 0);
      else if constexpr (BK == 64)
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
    bool whole_tile = tile_visible(w_r0, w_r1, start, start + BK - 1, sk,
                                   offset, masked, window);
    uint32_t dead[BK / 32];  // K7: the tile's flagged keys
    if constexpr (IO::kPaged) {
      uint32_t any = 0;
#pragma unroll
      for (int w = 0; w < BK / 32; ++w) {
        dead[w] = io.dead[(t % G::kStages) * (BK / 32) + w];
        any |= dead[w];
      }
      whole_tile = whole_tile && any == 0;
    }
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
            bool vis =
                key < sk && hop_visible(rows[j], key, offset, masked, window);
            if constexpr (IO::kPaged)
              vis = vis && (rows[j] >= io.nv ||
                            !((dead[i / 4] >> (8 * (i % 4) + c2 + c)) & 1u));
            const float x = vis ? sc[4 * i + 2 * j + c] * scale : kNegInf;
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
            // K5 and K1 give a masked key P = 1 while m is -1e30 (the lone
            // row); K7 gives every masked key P = 0.
            const bool live =
                key < sk && (!IO::kPaged || sc[4 * i + 2 * j + c] > kNegInf);
            const float p =
                live ? exp2f((sc[4 * i + 2 * j + c] - m[j]) * kLog2e) : 0.f;
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
    if constexpr (IO::kFresh) {
      if constexpr (IO::kPaged) {
        if (l[j] == 0.f) l[j] = 1.f;  // no key seen: o is 0, written so
      } else {
        if (lane % 4 == 0) io.lse[r] = m[j] + logf(l[j]);
      }
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        const int col = 8 * i + c2;
        if (col < d)
          store_pair(io.out + r * d + col, o[4 * i + 2 * j] / l[j],
                     o[4 * i + 2 * j + 1] / l[j]);
      }
    } else {
      if (lane % 4 == 0) {
        io.m_out[r] = m[j];
        io.l_out[r] = l[j];
      }
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        const int col = 8 * i + c2;
        if (col < d)
          store_pair(io.acc_out + r * d + col, o[4 * i + 2 * j],
                     o[4 * i + 2 * j + 1]);
      }
    }
  }
}

// Block = 2 consumer warpgroups + 1 producer warpgroup (one working
// warp); grid = n_qt * b * h, the last q-tiles first.
template <int D, int BK, typename IO>
__global__ void __launch_bounds__(kTcThreads, 1)
    fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map, const IO io,
                  int bh_count, int h, int hkv, int sq, int sk, int d,
                  int offset, int masked, int window, float scale) {
  using G = FwdTile<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t stages = base + G::kQBytes;
  const uint32_t bars = stages + G::kStages * G::kStageBytes;
  // full[s] at bars + 8 s, empty[s] at bars + 64 + 8 s, the q tile's at
  // bars + 120.
  const uint32_t q_bar = bars + 120;

  const int n_qt = (sq + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x % bh_count;             // row * h + head
  const int qt = n_qt - 1 - blockIdx.x / bh_count;  // last tiles first
  const int head = bh % h;
  const int kvh = bh / h * hkv + head / (h / hkv);
  const int q0 = qt * kTcRows;
  const int q_last = min(q0 + kTcRows, sq) - 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 64 + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }

  // The keys the q-tile sees; with a carried m, the whole block if one of
  // its rows sees no key while that m is still -1e30 (see the head of
  // the file).
  int k_lo, k_hi;
  hop_keys(q0, q_last, sk, offset, masked, window, k_lo, k_hi);
  bool whole = false;
  if constexpr (IO::kFresh) {
    __syncthreads();  // publishes the barriers
  } else {
    bool lone = false;
    if (masked && threadIdx.x < kTcRows && q0 + threadIdx.x < sq) {
      const int i = q0 + threadIdx.x;
      int lo, hi;
      hop_keys(i, i, sk, offset, masked, window, lo, hi);
      lone = hi < lo && io.m_in[static_cast<size_t>(bh) * sq + i] == kNegInf;
    }
    whole = __syncthreads_or(lone);  // also publishes the barriers
    if (whole) {
      k_lo = 0;
      k_hi = sk - 1;
    }
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
    consume<D, BK>(q_tile, stages, bars, q_bar, io, bh, q0, t_lo, ntiles,
                   whole, sq, sk, d, offset, masked, window, scale);
  }
}

// Launch the tile for a bf16 q [b, h, sq, d] against k, v [b, hkv, sk, d]
// (d one of 32, 64, 128, 256; d 32 runs in the 64-column instantiation),
// BK keys a tile (the default for d unless given), on `stream`.
template <int D, int BK = FwdTile<(D < 64 ? 64 : D)>::BK, typename IO>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          const IO& io, int b, int h, int hkv, int sq,
                          int sk, int offset, int masked, int window,
                          float scale, cudaStream_t stream) {
  constexpr int DK = D < 64 ? 64 : D;  // the instantiation d 32 runs in
  using G = FwdTile<DK, BK>;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = make_map(&q_map, q, D, sq, b * h, kTcRows);
  if (err == cudaSuccess) err = make_map(&k_map, k, D, sk, b * hkv, BK);
  if (err == cudaSuccess) err = make_map(&v_map, v, D, sk, b * hkv, BK);
  if (err != cudaSuccess) return err;
  err = decode::allow_smem(fwd_tc_kernel<DK, BK, IO>, G::kSmem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kTcRows - 1) / kTcRows;
  fwd_tc_kernel<DK, BK, IO><<<n_qt * b * h, kTcThreads, G::kSmem, stream>>>(
      q_map, k_map, v_map, io, b * h, h, hkv, sq, sk, D, offset, masked,
      window, scale);
  return cudaGetLastError();
}

}  // namespace tc
