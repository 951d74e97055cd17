// One backward ring-attention hop (K6) for NVIDIA Hopper, sm_90a: two
// kernels, dq and dk/dv.
//
// Replaces tpu_autoscaler/workloads/attention.py::_ring_bwd_dq_kernel and
// ::_ring_bwd_dkv_kernel, the two Pallas kernels behind
// ring_flash_bwd_step.  Same function: given this rank's q [b, h, sq, d],
// the output's gradient do [b, h, sq, d], the forward ring's f32
// log-sum-exp lse [b, h, sq] and delta = rowsum(do * out) [b, h, sq]
// (f32, computed by the caller), and the visiting k/v [b, hkv, sk, d],
// each kernel rebuilds the probabilities P = exp(q.k * scale - lse) of the
// pairs the hop sees (scale = d^-0.5 of the model's true head_dim, passed
// by the caller) and
//
//   dP = do.v,  dS = P * (dP - delta),
//   dq_add = sum_k dS.k * scale                 (dq kernel)
//   dv_add = sum_q P.do,  dk_add = sum_q dS.q * scale   (dk/dv kernel)
//
// where query head g reads KV head g / (h / hkv), so dk_add and dv_add sum
// over every query head of the GQA group.  The outputs are f32 and not
// cast: the ring adds them into its f32 dq and into the dk/dv buffers that
// travel with the block.  When `masked`, key k is visible to query row i
// iff 0 <= offset + i - k (< window when there is a window); an unmasked
// hop sees every pair.  A pair outside the band has P = dS = 0, whatever
// the lse (the reference's exp(-1e30 - lse) is 0 for every lse a forward
// ring writes).
//
// What bounds it.  The hop must move q, do, k, v, lse, delta and the three
// f32 outputs once and do 10*d flops per visible (query head, key) pair;
// at the SP training hop (b 2, h 8, s 2048, d 128) that is far above the
// flops per byte at which the arithmetic is the limit, so the products
// must run on the tensor cores.  The two-kernel split stays: no atomics,
// so the result does not depend on scheduling, and the remat recompute
// and a rerun give the same bits.  Each kernel rebuilds P (and dP) for
// itself: 12*d flops per pair done for the 10*d needed.
//
// bf16: wgmma and TMA, warp-specialised (K5's design, hopper_tc.cuh):
//
// - dq (ring_bwd_dq_tc_kernel): one CTA per (row, query head, 128 query
//   rows), two consumer warpgroups of 64 rows and a producer warpgroup
//   (one working warp; setmaxnreg hands the rest of its registers to the
//   consumers, 232 a thread, as in K5).  The producer loads q and do
//   once and keeps a ring of 4 K/V stages (BK keys; 2 at d 256) by TMA;
//   per visible k-tile a warpgroup computes S = Q.K^T and dP = dO.V^T
//   (wgmma, both operands K-major in shared memory), P and dS in
//   registers, and dQ += dS.K with dS as bf16 in registers (wgmma's A
//   operand) and K read MN-major.  BK = 64 keys, 32 at d 256.
// - dk/dv (ring_bwd_dkv_tc_kernel): one CTA per (row, KV head, 128 keys),
//   two consumer warpgroups of 64 keys and a producer warpgroup.  The
//   producer loads K and V once and streams (q, do, lse, delta) tiles of
//   BQ query rows, 4 stages deep (2 at d 256), for every query head of
//   the GQA group and every q-tile that sees the CTA's keys; a
//   warpgroup computes S^T = K.Q^T and dP^T = V.dO^T, P^T in registers,
//   dV += P^T.dO (issued before dS^T is formed, so the two overlap),
//   dS^T, dK += dS^T.Q (do and q read MN-major).  BQ = 64 rows, 32 at
//   d 256.  dK and dV live in registers; at d 256 they would take 256 a
//   thread, so the CTA makes two passes over its items, each for 128 of
//   the columns.
//
// f32: the CUDA-core kernels (ring_bwd_*_fma_kernel), as before: tensor
// cores would run f32 as TF32.  dq: one CTA per (row, query head, 32
// query rows), 8 warps of 4 rows, q and do resident as f32, K/V tiles of
// 32 keys by cp.async; dk/dv: one CTA per (row, KV head, 32 keys), 8
// warps of 4 keys, q/do tiles by cp.async.  P and dP are rebuilt in both
// (14*d flops per pair).  Their ceiling is the 67 TFLOP/s f32 rate.
//
// Any sq and sk: tiles are fixed and the tails are masked (TMA reads zeros
// past sq and sk).  Rows and keys past the block are never written.
//
// Numerics, matching the TPU kernels: scores are f32 sums scaled after the
// dot; P is rounded to do's dtype before P.do and dS to q's dtype before
// dS.q and dS.k; every sum is f32.
//
// Interface: plain C functions (ring_flash_bwd_dq and ring_flash_bwd_dkv
// at the bottom), built with nvcc into one shared library and called
// through ctypes.  Each launches on the caller's stream, allocates nothing
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "decode_common.cuh"
#include "hopper_tc.cuh"

namespace {

using namespace decode;
using namespace tc;

constexpr int kWarps = 8;
constexpr int kPerWarp = 4;                 // query rows (dq) or keys (dk/dv)
constexpr int kBQ = kWarps * kPerWarp;      // query rows per tile: 32
constexpr int kBK = 32;                     // keys per tile: 32

template <typename T, int D>
struct HopBwdTile {
  static constexpr int kVec = 16 / sizeof(T);      // elements per vector
  static constexpr int kVpr = D / kVec;            // vectors per row
  static constexpr int kStride = kVpr + 1;         // padded row
  static constexpr int kTileVecs = 32 * kStride;   // 32 padded rows
  // dq: stages of [K | V] (padded), q and do as f32, a float4 per (warp,
  // key) of dS for the warp's 4 rows.
  static constexpr size_t kDqBytes =
      static_cast<size_t>(kStages) * 2 * kTileVecs * 16 +
      static_cast<size_t>(2) * kBQ * D * sizeof(float) +
      static_cast<size_t>(kWarps) * kBK * sizeof(float4);
  // dk/dv: K and V as f32, stages of [q | do (padded) | lse | delta], a
  // float4 per (warp, query row) of P and of dS for the warp's 4 keys.
  static constexpr int kDkvStageVecs = 2 * kTileVecs + 2 * kBQ / 4;
  static constexpr size_t kDkvBytes =
      static_cast<size_t>(2) * kBK * D * sizeof(float) +
      static_cast<size_t>(kStages) * kDkvStageVecs * 16 +
      static_cast<size_t>(2) * kWarps * kBQ * sizeof(float4);
};

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ bool all_zero(const float4& a) {
  return a.x == 0.f && a.y == 0.f && a.z == 0.f && a.w == 0.f;
}

__device__ __forceinline__ float dot4(const float4& a, const float* b) {
  return a.x * b[0] + a.y * b[1] + a.z * b[2] + a.w * b[3];
}

// dq.  Block = kWarps warps; grid = n_qt * b * h, the last q-tiles first.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
    ring_bwd_dq_fma_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dq, int bh_count, int h, int hkv, int sq, int sk,
        int offset, int masked, int window, float scale) {
  using G = HopBwdTile<T, D>;
  constexpr int VPR = G::kVpr;
  constexpr int KS = G::kStride;
  constexpr int VEC = G::kVec;
  constexpr int E = D / 32;             // dq elements per lane per row
  constexpr int R = kPerWarp;
  extern __shared__ uint4 smem[];
  float* qs = reinterpret_cast<float*>(smem + kStages * 2 * G::kTileVecs);
  float* dos = qs + kBQ * D;
  float4* dss = reinterpret_cast<float4*>(dos + kBQ * D);

  const int n_qt = (sq + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;             // row * h + head
  const int qt = n_qt - 1 - blockIdx.x / bh_count;  // last tiles first
  const int head = bh % h;
  const int kvh = bh / h * hkv + head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, sq) - 1;

  // q and do of the tile as f32 (rows past sq as zeros, never written).
  const size_t q_row0 = static_cast<size_t>(bh) * sq + q0;
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const bool in = q0 + i / D < sq;
    qs[i] = in ? Elem<T>::load(q[q_row0 * D + i]) : 0.f;
    dos[i] = in ? Elem<T>::load(dout[q_row0 * D + i]) : 0.f;
  }
  const int row0 = q0 + warp * R;       // position of the warp's first row
  float lse_r[R];
  float delta_r[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool in = row0 + r < sq;
    lse_r[r] = in ? lse[static_cast<size_t>(bh) * sq + row0 + r] : 0.f;
    delta_r[r] = in ? delta[static_cast<size_t>(bh) * sq + row0 + r] : 0.f;
  }

  // The keys this q-tile sees in the hop, [k_lo, k_hi] clamped to the
  // block, in whole tiles.
  int k_lo = 0;
  int k_hi = sk - 1;
  if (masked) {
    k_hi = min(sk - 1, offset + q_last);
    if (window > 0) k_lo = max(0, offset + q0 - window + 1);
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
      uint4* kst = smem + (t % kStages) * 2 * G::kTileVecs;
      uint4* vst = kst + G::kTileVecs;
      for (int i = threadIdx.x; i < n * VPR; i += blockDim.x) {
        const int r = i / VPR;
        const int c = i % VPR;
        const size_t src = static_cast<size_t>(start + r) * VPR + c;
        cp_async16(kst + r * KS + c, kg + src);
        cp_async16(vst + r * KS + c, vg + src);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  const float* qw = qs + warp * R * D;
  const float* dw = dos + warp * R * D;
  float4* ds_w = dss + warp * kBK;      // dS of the warp's rows, per key

  load_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    load_tile(t + 1);
    cp_async_wait_one();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();      // ... for every thread; q and do too
    const int start = (t_lo + t) * kBK;
    const int n = min(kBK, sk - start);
    const uint4* kst = smem + (t % kStages) * 2 * G::kTileVecs;
    const uint4* vst = kst + G::kTileVecs;

    // Lane j: key start + j against the warp's R rows, q.k and do.v.
    const int key = start + lane;
    float sc[R];
    float dp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sc[r] = dp[r] = 0.f;
    if (lane < n) {
      const uint4* kr = kst + lane * KS;
      const uint4* vr = vst + lane * KS;
#pragma unroll 2
      for (int c = 0; c < VPR; ++c) {
        float kf[VEC];
        float vf[VEC];
        Elem<T>::unpack(kr[c], kf);
        Elem<T>::unpack(vr[c], vf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4* q4 =
              reinterpret_cast<const float4*>(qw + r * D + c * VEC);
          const float4* d4 =
              reinterpret_cast<const float4*>(dw + r * D + c * VEC);
#pragma unroll
          for (int i = 0; i < VEC / 4; ++i) {
            sc[r] += dot4(q4[i], kf + 4 * i);
            dp[r] += dot4(d4[i], vf + 4 * i);
          }
        }
      }
    }
    float ds[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = row0 + r;
      const bool vis = lane < n && i < sq &&
                       hop_visible(i, key, offset, masked, window);
      const float p = vis ? expf(sc[r] * scale - lse_r[r]) : 0.f;
      ds[r] = vis ? Elem<T>::round(p * (dp[r] - delta_r[r])) : 0.f;
    }
    ds_w[lane] = make_float4(ds[0], ds[1], ds[2], ds[3]);
    __syncwarp();

    // dq[r] += dS[r, j] * k[j] over the tile's keys; each lane its E
    // elements.  A key no row of the warp sees adds nothing.
    for (int j = 0; j < n; ++j) {
      const float4 d4 = ds_w[j];
      if (all_zero(d4)) continue;  // the same for every lane
      const T* kj = reinterpret_cast<const T*>(kst + j * KS) + lane * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float kf = Elem<T>::load(kj[e]);
        acc[0][e] += d4.x * kf;
        acc[1][e] += d4.y * kf;
        acc[2][e] += d4.z * kf;
        acc[3][e] += d4.w * kf;
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = row0 + r;
    if (i >= sq) continue;
    const size_t o = (static_cast<size_t>(bh) * sq + i) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) dq[o + e] = acc[r][e] * scale;
  }
}

// dk/dv.  Block = kWarps warps; grid = n_kt * b * hkv.
template <typename T, int D>
__global__ void __launch_bounds__(32 * kWarps)
    ring_bwd_dkv_fma_kernel(
        const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ delta,
        float* __restrict__ dk, float* __restrict__ dv, int bkv_count, int h,
        int hkv, int sq, int sk, int offset, int masked, int window,
        float scale) {
  using G = HopBwdTile<T, D>;
  constexpr int VPR = G::kVpr;
  constexpr int KS = G::kStride;
  constexpr int VEC = G::kVec;
  constexpr int E = D / 32;             // dk/dv elements per lane per key
  constexpr int KPW = kPerWarp;
  extern __shared__ uint4 smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kBK * D;
  uint4* stages = reinterpret_cast<uint4*>(vs + kBK * D);
  float4* ps = reinterpret_cast<float4*>(stages + kStages * G::kDkvStageVecs);
  float4* dss = ps + kWarps * kBQ;

  const int bkv = blockIdx.x % bkv_count;   // row * hkv + kv head
  const int kt = blockIdx.x / bkv_count;
  const int batch_row = bkv / hkv;
  const int kvh = bkv % hkv;
  const int group = h / hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int k0 = kt * kBK;
  const int k_last = min(k0 + kBK, sk) - 1;

  // The K and V tile as f32 (keys past sk as zeros, never written).
  const size_t kv_row0 = static_cast<size_t>(bkv) * sk + k0;
  for (int i = threadIdx.x; i < kBK * D; i += blockDim.x) {
    const bool in = k0 + i / D < sk;
    ks[i] = in ? Elem<T>::load(k[kv_row0 * D + i]) : 0.f;
    vs[i] = in ? Elem<T>::load(v[kv_row0 * D + i]) : 0.f;
  }

  // The query rows that see this k-tile in the hop: [q_lo, q_hi], from
  // the first row at or after the tile's first key (offset + i >= k0) to
  // the window's upper edge, clamped to the block.
  int q_lo = 0;
  int q_hi = sq - 1;
  if (masked) {
    q_lo = max(0, k0 - offset);
    if (window > 0) q_hi = min(sq - 1, k_last - offset + window - 1);
  }
  const int t_lo = q_lo / kBQ;
  const int ntq = q_hi < q_lo ? 0 : q_hi / kBQ - t_lo + 1;
  const int n_items = group * ntq;      // (query head, q-tile) pairs

  const uint4* qg = reinterpret_cast<const uint4*>(q);
  const uint4* dg = reinterpret_cast<const uint4*>(dout);
  auto load_item = [&](int i) {
    if (i < n_items) {
      const int qh = batch_row * h + kvh * group + i / ntq;
      const int start = (t_lo + i % ntq) * kBQ;
      const int n = min(kBQ, sq - start);
      uint4* qst = stages + (i % kStages) * G::kDkvStageVecs;
      uint4* dst = qst + G::kTileVecs;
      float* rst = reinterpret_cast<float*>(dst + G::kTileVecs);
      const size_t r0 = static_cast<size_t>(qh) * sq + start;
      for (int j = threadIdx.x; j < n * VPR; j += blockDim.x) {
        const int r = j / VPR;
        const int c = j % VPR;
        const size_t src = (r0 + r) * VPR + c;
        cp_async16(qst + r * KS + c, qg + src);
        cp_async16(dst + r * KS + c, dg + src);
      }
      const int t = threadIdx.x;
      if (t < n) {
        cp_async4(rst + t, lse + r0 + t);
      } else if (t >= 32 && t - 32 < n) {
        cp_async4(rst + kBQ + t - 32, delta + r0 + t - 32);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  float dka[KPW][E];
  float dva[KPW][E];
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk)
#pragma unroll
    for (int e = 0; e < E; ++e) dka[kk][e] = dva[kk][e] = 0.f;
  const int key0 = k0 + warp * KPW;     // the warp's first key
  const float* kw = ks + warp * KPW * D;
  const float* vw = vs + warp * KPW * D;
  float4* p_w = ps + warp * kBQ;        // P of the warp's keys, per row
  float4* ds_w = dss + warp * kBQ;      // dS of the warp's keys, per row

  load_item(0);
  for (int i = 0; i < n_items; ++i) {
    load_item(i + 1);
    cp_async_wait_one();  // item i has landed (i + 1 may be in flight)
    __syncthreads();      // ... for every thread; K and V too
    const int start = (t_lo + i % ntq) * kBQ;
    const int n = min(kBQ, sq - start);
    const uint4* qst = stages + (i % kStages) * G::kDkvStageVecs;
    const uint4* dst = qst + G::kTileVecs;
    const float* rst = reinterpret_cast<const float*>(dst + G::kTileVecs);

    // Lane j: query row start + j against the warp's KPW keys.
    const int qpos = start + lane;
    float sc[KPW];
    float dp[KPW];
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) sc[kk] = dp[kk] = 0.f;
    if (lane < n) {
      const uint4* qr = qst + lane * KS;
      const uint4* dr = dst + lane * KS;
#pragma unroll 2
      for (int c = 0; c < VPR; ++c) {
        float qf[VEC];
        float df[VEC];
        Elem<T>::unpack(qr[c], qf);
        Elem<T>::unpack(dr[c], df);
#pragma unroll
        for (int kk = 0; kk < KPW; ++kk) {
          const float4* k4 =
              reinterpret_cast<const float4*>(kw + kk * D + c * VEC);
          const float4* v4 =
              reinterpret_cast<const float4*>(vw + kk * D + c * VEC);
#pragma unroll
          for (int j = 0; j < VEC / 4; ++j) {
            sc[kk] += dot4(k4[j], qf + 4 * j);
            dp[kk] += dot4(v4[j], df + 4 * j);
          }
        }
      }
    }
    const float lse_j = lane < n ? rst[lane] : 0.f;
    const float delta_j = lane < n ? rst[kBQ + lane] : 0.f;
    float pl[KPW];
    float dsl[KPW];
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk) {
      const int key = key0 + kk;
      const bool vis = lane < n && key < sk &&
                       hop_visible(qpos, key, offset, masked, window);
      const float p = vis ? expf(sc[kk] * scale - lse_j) : 0.f;
      pl[kk] = vis ? Elem<T>::round(p) : 0.f;
      dsl[kk] = vis ? Elem<T>::round(p * (dp[kk] - delta_j)) : 0.f;
    }
    p_w[lane] = make_float4(pl[0], pl[1], pl[2], pl[3]);
    ds_w[lane] = make_float4(dsl[0], dsl[1], dsl[2], dsl[3]);
    __syncwarp();

    // dv[kk] += P[r, kk] * do[r], dk[kk] += dS[r, kk] * q[r] over the
    // tile's rows; each lane its E elements.  A row that sees none of the
    // warp's keys adds nothing.
    for (int r = 0; r < n; ++r) {
      const float4 p4 = p_w[r];
      const float4 d4 = ds_w[r];
      if (all_zero(p4) && all_zero(d4)) continue;  // the same for every lane
      const T* qr = reinterpret_cast<const T*>(qst + r * KS) + lane * E;
      const T* dr = reinterpret_cast<const T*>(dst + r * KS) + lane * E;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float qf = Elem<T>::load(qr[e]);
        const float df = Elem<T>::load(dr[e]);
        dva[0][e] += p4.x * df;
        dva[1][e] += p4.y * df;
        dva[2][e] += p4.z * df;
        dva[3][e] += p4.w * df;
        dka[0][e] += d4.x * qf;
        dka[1][e] += d4.y * qf;
        dka[2][e] += d4.z * qf;
        dka[3][e] += d4.w * qf;
      }
    }
    __syncthreads();  // the stage is free for the copy issued next
  }

#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    const int key = key0 + kk;
    if (key >= sk) continue;
    const size_t o = (static_cast<size_t>(bkv) * sk + key) * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      dk[o + e] = dka[kk][e] * scale;
      dv[o + e] = dva[kk][e];
    }
  }
}

// ---- bf16: wgmma + TMA ----------------------------------------------------

constexpr int kConsumers = 2;                      // warpgroups of 64
constexpr int kTcThreads = 128 * (kConsumers + 1);  // + the producer's
constexpr int kTcRows = 64 * kConsumers;           // q rows (dq) or keys
                                                   // (dk/dv) per CTA

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
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    ring_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          float* __restrict__ dq, int bh_count, int h,
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
          *reinterpret_cast<float2*>(dq + r * d + col) =
              make_float2(acc[4 * i + 2 * j] * scale,
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
template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    ring_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dk, float* __restrict__ dv,
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
            *reinterpret_cast<float2*>(dk + r * d + col) =
                make_float2(dka[4 * i + 2 * j] * scale,
                            dka[4 * i + 2 * j + 1] * scale);
            *reinterpret_cast<float2*>(dv + r * d + col) =
                make_float2(dva[4 * i + 2 * j], dva[4 * i + 2 * j + 1]);
          }
        }
      }
    }
  }
}

// The checks both C entries make: 0 when the shape can launch.
cudaError_t check_shape(int b, int h, int hkv, int sq, int sk, int window,
                        long long ctas) {
  if (b < 1 || h < 1 || hkv < 1 || sq < 1 || sk < 1 || h % hkv != 0 ||
      window < 0 || ctas > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The four tensor maps of a bf16 launch: q, do with q_rows-row boxes, k, v
// with kv_rows-row boxes.
cudaError_t make_maps(CUtensorMap* maps, const void* q, const void* k,
                      const void* v, const void* dout, int b, int h, int hkv,
                      int sq, int sk, int d, int q_rows, int kv_rows) {
  cudaError_t err = tc::make_map(&maps[0], q, d, sq, b * h, q_rows);
  if (err == cudaSuccess)
    err = tc::make_map(&maps[1], k, d, sk, b * hkv, kv_rows);
  if (err == cudaSuccess)
    err = tc::make_map(&maps[2], v, d, sk, b * hkv, kv_rows);
  if (err == cudaSuccess)
    err = tc::make_map(&maps[3], dout, d, sq, b * h, q_rows);
  return err;
}

}  // namespace

// q, do [b, h, sq, d] and k, v [b, hkv, sk, d], contiguous and 16-byte
// aligned, in one dtype (0: f32, on the CUDA cores; 1: bf16, on the
// tensor cores); lse, delta [b, h, sq] f32; dq [b, h, sq, d] f32.  masked
// 0 or 1; window 0 means no window (read only when masked); scale
// multiplies q.k.  Returns a cudaError_t: 0 on a successful launch.
extern "C" int ring_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int b, int h,
                                 int hkv, int sq, int sk, int d, int dtype,
                                 int offset, int masked, int window,
                                 float scale, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas = static_cast<long long>((sq + kBQ - 1) / kBQ) * b * h;
  err = check_shape(b, h, hkv, sq, sk, window, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int D = decltype(dim)::value;
    if constexpr (std::is_same_v<T, float>) {
      const size_t smem = HopBwdTile<T, D>::kDqBytes;
      cudaError_t e = allow_smem(ring_bwd_dq_fma_kernel<T, D>, smem);
      if (e != cudaSuccess) return e;
      ring_bwd_dq_fma_kernel<T, D>
          <<<static_cast<int>(ctas), 32 * kWarps, smem, st>>>(
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const T*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dq),
              b * h, h, hkv, sq, sk, offset, masked != 0, window, scale);
    } else {
      constexpr int DK = D < 64 ? 64 : D;
      CUtensorMap maps[4];
      cudaError_t e = make_maps(maps, q, k, v, dout, b, h, hkv, sq, sk, D,
                                kTcRows, DqTile<DK>::BK);
      if (e != cudaSuccess) return e;
      const size_t smem = DqTile<DK>::kSmem;
      e = allow_smem(ring_bwd_dq_tc_kernel<DK>, smem);
      if (e != cudaSuccess) return e;
      const int n_qt = (sq + kTcRows - 1) / kTcRows;
      ring_bwd_dq_tc_kernel<DK><<<n_qt * b * h, kTcThreads, smem, st>>>(
          maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<float*>(dq), b * h, h,
          hkv, sq, sk, D, offset, masked != 0, window, scale);
    }
    return cudaGetLastError();
  }));
}

// As ring_flash_bwd_dq, writing dk and dv [b, hkv, sk, d] f32.
extern "C" int ring_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int b, int h, int hkv, int sq, int sk,
                                  int d, int dtype, int offset, int masked,
                                  int window, float scale, int device,
                                  void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ctas =
      static_cast<long long>((sk + kBK - 1) / kBK) * b * hkv;
  err = check_shape(b, h, hkv, sq, sk, window, ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    constexpr int D = decltype(dim)::value;
    if constexpr (std::is_same_v<T, float>) {
      const size_t smem = HopBwdTile<T, D>::kDkvBytes;
      cudaError_t e = allow_smem(ring_bwd_dkv_fma_kernel<T, D>, smem);
      if (e != cudaSuccess) return e;
      ring_bwd_dkv_fma_kernel<T, D>
          <<<static_cast<int>(ctas), 32 * kWarps, smem, st>>>(
              static_cast<const T*>(q), static_cast<const T*>(k),
              static_cast<const T*>(v), static_cast<const T*>(dout),
              static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<float*>(dk),
              static_cast<float*>(dv), b * hkv, h, hkv, sq, sk, offset,
              masked != 0, window, scale);
    } else {
      constexpr int DK = D < 64 ? 64 : D;
      CUtensorMap maps[4];
      cudaError_t e = make_maps(maps, q, k, v, dout, b, h, hkv, sq, sk, D,
                                DkvTile<DK>::BQ, kTcRows);
      if (e != cudaSuccess) return e;
      const size_t smem = DkvTile<DK>::kSmem;
      e = allow_smem(ring_bwd_dkv_tc_kernel<DK>, smem);
      if (e != cudaSuccess) return e;
      const int n_kt = (sk + kTcRows - 1) / kTcRows;
      ring_bwd_dkv_tc_kernel<DK><<<n_kt * b * hkv, kTcThreads, smem, st>>>(
          maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
          static_cast<const float*>(delta), static_cast<float*>(dk),
          static_cast<float*>(dv), b * hkv, h, hkv, sq, sk, D, offset,
          masked != 0, window, scale);
    }
    return cudaGetLastError();
  }));
}
