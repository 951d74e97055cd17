// The bf16 tensor-core backward tiles for NVIDIA Hopper, sm_90a, shared
// by the flash-attention backward (K2, flash_attention_bwd.cu) and the
// ring hop's backward (K6, ring_flash_bwd.cu): a dq kernel and a dk/dv
// kernel.
//
// Both rebuild P = exp(q.k * scale - lse) of the pairs the hop's mask
// (hopper_tc.cuh) lets through, with P = dS = 0 for every other pair,
// whatever the lse, and
//
//   dP = do.v,  dS = P * (dP - delta),
//   dq = sum_k dS.k * scale                 (dq kernel)
//   dv = sum_q P.do,  dk = sum_q dS.q * scale   (dk/dv kernel)
//
// where query head g reads KV head g / (h / hkv), so dk and dv sum over
// every query head of the GQA group, in registers: no atomics, so the
// bits do not depend on scheduling, and a remat recompute or a rerun
// gives the same ones.  K2 is K6 at offset 0 over its own block (masked
// = causal, sq = sk = s).  The two differ only in the output type OutT:
// f32 for K6 (the ring adds the hop's gradients into f32 buffers), the
// inputs' bf16 for K2, each value rounded once from its f32 accumulator.
// Each kernel rebuilds P (and dP) for itself: 12*d flops per pair done
// for the 10*d needed.
//
// - dq (bwd_dq_tc_kernel): one CTA per (row, query head, 128 query
//   rows), the last q-tiles (the most keys under a causal mask) first:
//   two consumer warpgroups of 64 rows and a producer warpgroup (one
//   working warp; setmaxnreg hands the rest of its registers to the
//   consumers, 232 a thread).  The producer loads q and do once and keeps
//   a ring of 4 K/V stages (2 at d 256) by TMA; per visible k-tile a
//   warpgroup computes S = Q.K^T and dP = dO.V^T (wgmma, both operands
//   K-major in shared memory), P and dS in registers, and dQ += dS.K with
//   dS as bf16 in registers (wgmma's A operand) and K read MN-major.
//   BK = 64 keys, 32 at d 256.
// - dk/dv (bwd_dkv_tc_kernel): one CTA per (row, KV head, 128 keys), the
//   first k-tiles (seen by the most rows under a causal mask) first: two
//   consumer warpgroups of 64 keys and a producer warpgroup.  The
//   producer loads K and V once and streams (q, do, lse, delta) tiles of
//   BQ query rows, 4 stages deep (2 at d 256), for every query head of
//   the GQA group and every q-tile that sees the CTA's keys; a warpgroup
//   computes S^T = K.Q^T and dP^T = V.dO^T, P^T in registers, dV +=
//   P^T.dO (issued before dS^T is formed, so the two overlap), dS^T, dK
//   += dS^T.Q (do and q read MN-major).  BQ = 64 rows, 32 at d 256.  dK
//   and dV live in registers; at d 256 they would take 256 a thread, so
//   the CTA makes two passes over its items, each for 128 of the
//   columns.
//
// Any sq and sk: tiles are fixed and the tails are masked (TMA reads
// zeros past sq and sk).  Rows and keys past the block are never
// written.  Numerics: scores are f32 sums scaled after the dot; P is
// rounded to bf16 before P.do and dS before dS.q and dS.k; every sum is
// f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "decode_common.cuh"
#include "hopper_tc.cuh"

namespace tc {

template <int D>
struct DqTile {
  static constexpr int DA = D < 64 ? 64 : D;
  static constexpr int kAtoms = DA / 64;
  static constexpr int BK = D == 256 ? 32 : 64;   // keys per tile
  static constexpr int kStages = D == 256 ? 2 : 4;  // K/V stages
  static constexpr int kQAtom = kTcRows * 128;
  static constexpr int kKAtom = BK * 128;
  static constexpr int kQBytes = kAtoms * kQAtom;  // q or do
  static constexpr int kKVBytes = kAtoms * kKAtom;  // K or V of a stage
  static constexpr size_t kSmem =
      1024 + 2 * kQBytes + static_cast<size_t>(kStages) * 2 * kKVBytes + 128;
};

// dq.  Block = 2 consumer warpgroups + 1 producer warpgroup (one working
// warp); grid = n_qt * b * h, the last q-tiles first.
template <int D, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
    bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     const __grid_constant__ CUtensorMap do_map,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     OutT* __restrict__ dq, int bh_count, int h,
                     int hkv, int sq, int sk, int d, int offset,
                     int masked, int window, float scale) {
  using G = DqTile<D>;
  constexpr int DA = G::DA;
  constexpr int BK = G::BK;
  constexpr int NS = BK / 2;
  constexpr int NO = DA / 2;
  constexpr int S = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t do_tile = base + G::kQBytes;
  const uint32_t stages = base + 2 * G::kQBytes;
  const uint32_t bars = stages + S * 2 * G::kKVBytes;
  const uint32_t q_bar = bars + 120;   // full[s]: +8 s, empty[s]: +64 + 8 s

  const int n_qt = (sq + kTcRows - 1) / kTcRows;
  const int bh = blockIdx.x % bh_count;
  const int qt = n_qt - 1 - blockIdx.x / bh_count;
  const int head = bh % h;
  const int kvh = bh / h * hkv + head / (h / hkv);
  const int q0 = qt * kTcRows;
  const int q_last = min(q0 + kTcRows, sq) - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 64 + 8 * s, 128 * kConsumers);
    }
    mbar_init(q_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  int k_lo, k_hi;
  hop_keys(q0, q_last, sk, offset, masked, window, k_lo, k_hi);
  const int t_lo = k_lo / BK;
  const int ntiles = k_hi < k_lo ? 0 : k_hi / BK - t_lo + 1;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers) {
      if (lane == 0) {
        mbar_expect_tx(q_bar, 2 * G::kQBytes);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          tma_load(q_tile + a * G::kQAtom, &q_map, 64 * a, q0, bh, q_bar);
          tma_load(do_tile + a * G::kQAtom, &do_map, 64 * a, q0, bh, q_bar);
        }
        for (int t = 0; t < ntiles; ++t) {
          const int s = t % S;
          if (t >= S) mbar_wait(bars + 64 + 8 * s, ((t / S) - 1) & 1);
          const uint32_t full = bars + 8 * s;
          const uint32_t kst = stages + s * 2 * G::kKVBytes;
          const int start = (t_lo + t) * BK;
          mbar_expect_tx(full, 2 * G::kKVBytes);
#pragma unroll
          for (int a = 0; a < G::kAtoms; ++a) {
            tma_load(kst + a * G::kKAtom, &k_map, 64 * a, start, kvh, full);
            tma_load(kst + G::kKVBytes + a * G::kKAtom, &v_map, 64 * a, start,
                     kvh, full);
          }
        }
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int g = lane / 4;
    const int c2 = 2 * (lane % 4);
    int rows[2];
    rows[0] = q0 + 64 * wg + (warp % 4) * 16 + g;
    rows[1] = rows[0] + 8;
    float lse_r[2], delta_r[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const bool in = rows[j] < sq;
      const size_t r = static_cast<size_t>(bh) * sq + rows[j];
      lse_r[j] = in ? lse[r] * kLog2e : 0.f;
      delta_r[j] = in ? delta[r] : 0.f;
    }
    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    const int w_r0 = q0 + 64 * wg;
    const int w_r1 = min(w_r0 + 63, sq - 1);
    int w_lo, w_hi;
    hop_keys(w_r0, w_r1, sk, offset, masked, window, w_lo, w_hi);
    if (w_r0 > w_r1) w_hi = -1;
    const float scale2 = scale * kLog2e;

    mbar_wait(q_bar, 0);
    const uint32_t q_wg = q_tile + wg * 64 * 128;
    const uint32_t do_wg = do_tile + wg * 64 * 128;
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % S;
      const int start = (t_lo + t) * BK;
      mbar_wait(bars + 8 * s, (t / S) & 1);
      if (start <= w_hi && start + BK - 1 >= w_lo) {
        const uint32_t kst = stages + s * 2 * G::kKVBytes;
        const uint32_t vst = kst + G::kKVBytes;
        float sc[NS], dp[NS];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DA / 16; ++kk) {
          if constexpr (BK == 64) {
            wgmma_ss_n64(sc, desc_k(q_wg, kk, G::kQAtom),
                         desc_k(kst, kk, G::kKAtom), kk > 0);
            wgmma_ss_n64(dp, desc_k(do_wg, kk, G::kQAtom),
                         desc_k(vst, kk, G::kKAtom), kk > 0);
          } else {
            wgmma_ss_n32(sc, desc_k(q_wg, kk, G::kQAtom),
                         desc_k(kst, kk, G::kKAtom), kk > 0);
            wgmma_ss_n32(dp, desc_k(do_wg, kk, G::kQAtom),
                         desc_k(vst, kk, G::kKAtom), kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(sc);
        fence_regs(dp);
        // dS = P (dP - delta), 0 outside the hop's pairs; kept in sc.  A
        // tile every row of the warpgroup sees whole takes no mask.
        if (tile_visible(w_r0, w_r1, start, start + BK - 1, sk, offset,
                         masked, window)) {
#pragma unroll
          for (int x = 0; x < NS; ++x) {
            const int j = (x / 2) % 2;  // register x = 4 i + 2 j + c
            sc[x] = exp2f(sc[x] * scale2 - lse_r[j]) * (dp[x] - delta_r[j]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < NS / 4; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int x = 4 * i + 2 * j + c;
                const int key = start + 8 * i + c2 + c;
                const bool vis =
                    key < sk && rows[j] < sq &&
                    hop_visible(rows[j], key, offset, masked, window);
                const float p = vis ? exp2f(sc[x] * scale2 - lse_r[j]) : 0.f;
                sc[x] = p * (dp[x] - delta_r[j]);
              }
        }
        // dQ += dS.K, dS as bf16 in registers (kept until the wait), K
        // MN-major.
        uint32_t a[BK / 16][4];
        to_a_frags(sc, a);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          if constexpr (DA == 64) {
            wgmma_rs_n64(acc, a[kk], desc_mn(kst, kk, 0, G::kKAtom), 1);
          } else {
#pragma unroll
            for (int n = 0; n < DA / 128; ++n)
              wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(acc + 64 * n),
                            a[kk], desc_mn(kst, kk, 2 * n, G::kKAtom), 1);
          }
        }
        wgmma_commit();
        wgmma_wait();
        fence_regs(acc);
        fence_regs(a);
      }
      mbar_arrive(bars + 64 + 8 * s);
    }

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (rows[j] >= sq) continue;
      const size_t r = static_cast<size_t>(bh) * sq + rows[j];
#pragma unroll
      for (int i = 0; i < NO / 4; ++i) {
        const int col = 8 * i + c2;
        if (col < d)
          store_pair(dq + r * d + col, acc[4 * i + 2 * j] * scale,
                     acc[4 * i + 2 * j + 1] * scale);
      }
    }
  }
}

template <int D>
struct DkvTile {
  static constexpr int DA = D < 64 ? 64 : D;
  static constexpr int kAtoms = DA / 64;
  static constexpr int BQ = D == 256 ? 32 : 64;    // query rows per item
  static constexpr int DO = DA < 128 ? DA : 128;   // output columns a pass
  static constexpr int kPasses = DA / DO;
  static constexpr int kStages = D == 256 ? 2 : 4;  // q/do stages
  static constexpr int kKAtom = kTcRows * 128;     // bytes of a K/V atom
  static constexpr int kKVBytes = kAtoms * kKAtom;  // K or V
  static constexpr int kQAtom = BQ * 128;
  static constexpr int kQBytes = kAtoms * kQAtom;   // q or do of a stage
  // A stage: q, do (TMA, in that order), then lse and delta (BQ f32 each).
  static constexpr int kStageBytes = 2 * kQBytes + 1024;
  static constexpr size_t kSmem = 1024 + 2 * kKVBytes +
                                  static_cast<size_t>(kStages) * kStageBytes +
                                  128;
};

// dk/dv.  Block = 2 consumer warpgroups + 1 producer warpgroup (one
// working warp); grid = n_kt * b * hkv.
template <int D, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
    bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                      const __grid_constant__ CUtensorMap k_map,
                      const __grid_constant__ CUtensorMap v_map,
                      const __grid_constant__ CUtensorMap do_map,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      OutT* __restrict__ dk, OutT* __restrict__ dv,
                      int bkv_count, int h, int hkv, int sq, int sk,
                      int d, int offset, int masked, int window,
                      float scale) {
  using G = DkvTile<D>;
  constexpr int DA = G::DA;
  constexpr int BQ = G::BQ;
  constexpr int DO = G::DO;
  constexpr int NS = BQ / 2;
  constexpr int NO = DO / 2;
  constexpr int S = G::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_tile = base;
  const uint32_t v_tile = base + G::kKVBytes;
  const uint32_t stages = base + 2 * G::kKVBytes;
  const uint32_t bars = stages + S * G::kStageBytes;
  const uint32_t kv_bar = bars + 120;  // full[s]: +8 s, empty[s]: +64 + 8 s
  const float* stage_f = reinterpret_cast<const float*>(
      smem_raw + (stages - smem_addr(smem_raw)));

  const int bkv = blockIdx.x % bkv_count;   // row * hkv + kv head
  const int kt = blockIdx.x / bkv_count;
  const int batch_row = bkv / hkv;
  const int group = h / hkv;
  const int k0 = kt * kTcRows;
  const int k_last = min(k0 + kTcRows, sk) - 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bars + 8 * s, 32);
      mbar_init(bars + 64 + 8 * s, 128 * kConsumers);
    }
    mbar_init(kv_bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  int q_lo, q_hi;
  hop_rows(k0, k_last, sq, offset, masked, window, q_lo, q_hi);
  const int t_lo = q_lo / BQ;
  const int ntq = q_hi < q_lo ? 0 : q_hi / BQ - t_lo + 1;
  const int n_items = group * ntq;      // (query head, q-tile) pairs
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (warp >= 4 * kConsumers) {
    regs_dec<kProducerRegs>();
    if (warp == 4 * kConsumers) {
      if (lane == 0) {
        mbar_expect_tx(kv_bar, 2 * G::kKVBytes);
#pragma unroll
        for (int a = 0; a < G::kAtoms; ++a) {
          tma_load(k_tile + a * G::kKAtom, &k_map, 64 * a, k0, bkv, kv_bar);
          tma_load(v_tile + a * G::kKAtom, &v_map, 64 * a, k0, bkv, kv_bar);
        }
      }
      for (int t = 0; t < G::kPasses * n_items; ++t) {
        const int item = t % max(n_items, 1);
        const int s = t % S;
        if (t >= S) mbar_wait(bars + 64 + 8 * s, ((t / S) - 1) & 1);
        const int qh = batch_row * h + (bkv % hkv) * group + item / ntq;
        const int start = (t_lo + item % ntq) * BQ;
        const uint32_t full = bars + 8 * s;
        const uint32_t qst = stages + s * G::kStageBytes;
        float* rows_f = const_cast<float*>(stage_f) +
                        (s * G::kStageBytes + 2 * G::kQBytes) / 4;
        for (int r = lane; r < BQ; r += 32) {
          const int pos = start + r;
          const size_t o = static_cast<size_t>(qh) * sq + pos;
          rows_f[r] = pos < sq ? lse[o] * kLog2e : 0.f;
          rows_f[BQ + r] = pos < sq ? delta[o] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(full, 2 * G::kQBytes);
#pragma unroll
          for (int a = 0; a < G::kAtoms; ++a) {
            tma_load(qst + a * G::kQAtom, &q_map, 64 * a, start, qh, full);
            tma_load(qst + G::kQBytes + a * G::kQAtom, &do_map, 64 * a, start,
                     qh, full);
          }
        } else {
          mbar_arrive(full);
        }
      }
    }
  } else {
    regs_inc<kConsumerRegs>();
    const int wg = warp / 4;
    const int g = lane / 4;
    const int c2 = 2 * (lane % 4);
    int keys[2];
    keys[0] = k0 + 64 * wg + (warp % 4) * 16 + g;
    keys[1] = keys[0] + 8;
    const int w_k0 = k0 + 64 * wg;
    const int w_k1 = min(w_k0 + 63, sk - 1);
    int w_lo, w_hi;
    hop_rows(w_k0, w_k1, sq, offset, masked, window, w_lo, w_hi);
    if (w_k0 > w_k1) w_hi = -1;
    const float scale2 = scale * kLog2e;
    const uint32_t k_wg = k_tile + wg * 64 * 128;
    const uint32_t v_wg = v_tile + wg * 64 * 128;

    mbar_wait(kv_bar, 0);
    int t = 0;
    for (int pass = 0; pass < G::kPasses; ++pass) {
      float dka[NO], dva[NO];
#pragma unroll
      for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
      for (int item = 0; item < n_items; ++item, ++t) {
        const int s = t % S;
        const int start = (t_lo + item % ntq) * BQ;
        mbar_wait(bars + 8 * s, (t / S) & 1);
        if (start <= w_hi && start + BQ - 1 >= w_lo) {
          const uint32_t qst = stages + s * G::kStageBytes;
          const uint32_t dost = qst + G::kQBytes;
          const float* lse_s =
              stage_f + (s * G::kStageBytes + 2 * G::kQBytes) / 4;
          const float* delta_s = lse_s + BQ;
          float sc[NS], dp[NS];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < DA / 16; ++kk) {
            if constexpr (BQ == 64) {
              wgmma_ss_n64(sc, desc_k(k_wg, kk, G::kKAtom),
                           desc_k(qst, kk, G::kQAtom), kk > 0);
              wgmma_ss_n64(dp, desc_k(v_wg, kk, G::kKAtom),
                           desc_k(dost, kk, G::kQAtom), kk > 0);
            } else {
              wgmma_ss_n32(sc, desc_k(k_wg, kk, G::kKAtom),
                           desc_k(qst, kk, G::kQAtom), kk > 0);
              wgmma_ss_n32(dp, desc_k(v_wg, kk, G::kKAtom),
                           desc_k(dost, kk, G::kQAtom), kk > 0);
            }
          }
          wgmma_commit();
          wgmma_wait();
          fence_regs(sc);
          fence_regs(dp);
          // P^T into sc: 0 outside the hop's pairs.  A tile whose rows
          // all see every key of the warpgroup takes no mask.
          const bool whole_tile =
              start + BQ <= sq && tile_visible(start, start + BQ - 1, w_k0,
                                               w_k0 + 63, sk, offset, masked,
                                               window);
#pragma unroll
          for (int i = 0; i < NS / 4; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int col = 8 * i + c2 + c;
              const int qpos = start + col;
              const float lse_c = lse_s[col];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int x = 4 * i + 2 * j + c;
                const bool vis =
                    whole_tile ||
                    (keys[j] < sk && qpos < sq &&
                     hop_visible(qpos, keys[j], offset, masked, window));
                sc[x] = vis ? exp2f(sc[x] * scale2 - lse_c) : 0.f;
              }
            }
          // dV += P^T.dO (do MN-major) runs while dS^T is formed.
          uint32_t pa[BQ / 16][4], da[BQ / 16][4];
          to_a_frags(sc, pa);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            if constexpr (DO == 64)
              wgmma_rs_n64(dva, pa[kk], desc_mn(dost, kk, pass, G::kQAtom),
                           1);
            else
              wgmma_rs_n128(dva, pa[kk],
                            desc_mn(dost, kk, 2 * pass, G::kQAtom), 1);
          }
          wgmma_commit();
          // dS^T = P^T (dP^T - delta), then dK += dS^T.Q (q MN-major).
#pragma unroll
          for (int i = 0; i < NS / 4; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const float delta_c = delta_s[8 * i + c2 + c];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const int x = 4 * i + 2 * j + c;
                dp[x] = sc[x] * (dp[x] - delta_c);
              }
            }
          to_a_frags(dp, da);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BQ / 16; ++kk) {
            if constexpr (DO == 64)
              wgmma_rs_n64(dka, da[kk], desc_mn(qst, kk, pass, G::kQAtom), 1);
            else
              wgmma_rs_n128(dka, da[kk],
                            desc_mn(qst, kk, 2 * pass, G::kQAtom), 1);
          }
          wgmma_commit();
          wgmma_wait();
          fence_regs(dka);
          fence_regs(dva);
          fence_regs(pa);
          fence_regs(da);
        }
        mbar_arrive(bars + 64 + 8 * s);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (keys[j] >= sk) continue;
        const size_t r = static_cast<size_t>(bkv) * sk + keys[j];
#pragma unroll
        for (int i = 0; i < NO / 4; ++i) {
          const int col = pass * DO + 8 * i + c2;
          if (col < d) {
            store_pair(dk + r * d + col, dka[4 * i + 2 * j] * scale,
                       dka[4 * i + 2 * j + 1] * scale);
            store_pair(dv + r * d + col, dva[4 * i + 2 * j],
                       dva[4 * i + 2 * j + 1]);
          }
        }
      }
    }
  }
}

// The four tensor maps of a bf16 launch: q, do with q_rows-row boxes, k, v
// with kv_rows-row boxes.
inline cudaError_t make_bwd_maps(CUtensorMap* maps, const void* q,
                                 const void* k, const void* v,
                                 const void* dout, int b, int h, int hkv,
                                 int sq, int sk, int d, int q_rows,
                                 int kv_rows) {
  cudaError_t err = make_map(&maps[0], q, d, sq, b * h, q_rows);
  if (err == cudaSuccess)
    err = make_map(&maps[1], k, d, sk, b * hkv, kv_rows);
  if (err == cudaSuccess)
    err = make_map(&maps[2], v, d, sk, b * hkv, kv_rows);
  if (err == cudaSuccess)
    err = make_map(&maps[3], dout, d, sq, b * h, q_rows);
  return err;
}


// Launch the dq kernel for bf16 q, do [b, h, sq, d] against k, v [b, hkv,
// sk, d] (d one of 32, 64, 128, 256; d 32 runs in the 64-column
// instantiation), writing dq [b, h, sq, d] in OutT, on `stream`.
template <int D, typename OutT>
cudaError_t launch_bwd_dq_tc(const void* q, const void* k, const void* v,
                             const void* dout, const float* lse,
                             const float* delta, OutT* dq, int b, int h,
                             int hkv, int sq, int sk, int offset, int masked,
                             int window, float scale, cudaStream_t stream) {
  constexpr int DK = D < 64 ? 64 : D;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps(maps, q, k, v, dout, b, h, hkv, sq, sk, D,
                                  kTcRows, DqTile<DK>::BK);
  if (err != cudaSuccess) return err;
  const size_t smem = DqTile<DK>::kSmem;
  err = decode::allow_smem(bwd_dq_tc_kernel<DK, OutT>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kTcRows - 1) / kTcRows;
  bwd_dq_tc_kernel<DK, OutT><<<n_qt * b * h, kTcThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dq, b * h, h, hkv, sq,
      sk, D, offset, masked, window, scale);
  return cudaGetLastError();
}

// As launch_bwd_dq_tc, writing dk and dv [b, hkv, sk, d] in OutT.
template <int D, typename OutT>
cudaError_t launch_bwd_dkv_tc(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, OutT* dk, OutT* dv, int b,
                              int h, int hkv, int sq, int sk, int offset,
                              int masked, int window, float scale,
                              cudaStream_t stream) {
  constexpr int DK = D < 64 ? 64 : D;
  CUtensorMap maps[4];
  cudaError_t err = make_bwd_maps(maps, q, k, v, dout, b, h, hkv, sq, sk, D,
                                  DkvTile<DK>::BQ, kTcRows);
  if (err != cudaSuccess) return err;
  const size_t smem = DkvTile<DK>::kSmem;
  err = decode::allow_smem(bwd_dkv_tc_kernel<DK, OutT>, smem);
  if (err != cudaSuccess) return err;
  const int n_kt = (sk + kTcRows - 1) / kTcRows;
  bwd_dkv_tc_kernel<DK, OutT><<<n_kt * b * hkv, kTcThreads, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], lse, delta, dk, dv, b * hkv, h,
      hkv, sq, sk, D, offset, masked, window, scale);
  return cudaGetLastError();
}

}  // namespace tc
