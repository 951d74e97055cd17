// Flash-attention forward (causal, sliding-window or full, GQA) for
// NVIDIA Hopper, sm_90a.
//
// Replaces tpu_autoscaler/workloads/attention.py::_attn_fwd_kernel, the
// Pallas kernel behind _forward_pallas and flash_attention.  Same
// function: q [b, h, s, d] attends over k/v [b, hkv, s, d]; query head g
// reads KV head g / (h / hkv); key j is visible to query i iff j <= i and
// i - j < window (causal), or always (not causal).  It returns out
// [b, h, s, d] in q's dtype and the f32 log-sum-exp lse [b, h, s] of each
// row's scaled scores, which the backward (K2, a later change) needs.
//
// What bounds it.  The call must move q, k, v and out once and do 4*d
// flops per visible (query, key) pair: causal GQA-8 at d 64 is ~57 flops
// per byte at s 128 and ~450 at s 1024.  That is above the ~20 flops
// per byte at which the card's f32 arithmetic, not its memory, becomes
// the limit, and from s ~ 670 above bf16's ~295.  This first version does
// the dot products on the CUDA cores in f32 (FMA), for bf16 as for f32,
// so its ceiling is the 67 TFLOP/s f32 rate, not the tensor cores'.  The
// design keeps the work to the visible pairs and every intermediate on
// the chip:
//
// - one CTA per (row, query head, tile of kBQ = 32 query rows), 8 warps
//   of kRowsPerWarp = 4 rows each; CTAs of the last q-tiles (the most
//   keys, under causality) are scheduled first;
// - the CTA loops ONLY over the k-tiles its q-tile can see: up to the
//   diagonal under causality and, with a window, from the band's lower
//   edge.  The TPU grid streams every k-block of the band and skips the
//   compute with pl.when; here the loop bounds do the skipping;
// - K/V tiles of kBK = 32 keys are staged in shared memory by cp.async,
//   double-buffered (K3's scheme), with K rows padded by 16 bytes so the
//   lanes' row reads fall in distinct banks;
// - lane j scores key j of the tile against the warp's 4 rows, so each K
//   vector read from shared memory serves 4 rows, and a row's max and sum
//   are one warp reduction each; PV takes each key's P from its lane by
//   shuffle and each lane accumulates d/32 output elements of every row;
// - the f32 online-softmax carry (m, l, acc) stays in registers, and
//   neither scores nor P ever leave the chip.
//
// Any s: tiles are fixed and the tails are masked.  Query rows past s are
// neither computed nor written; keys past s are never copied or read.
//
// Numerics, matching the TPU kernel: scores are f32 dot products scaled
// after the dot by the caller's scale (d^-0.5 of the model's true
// head_dim; a head_dim outside 32, 64, 128 and 256 comes zero-padded to
// the next of them, which changes no score); masked keys are left out of
// the max and get P = 0; the carry starts at m = -1e30, l = 0; P is
// rounded to v's dtype before PV and PV accumulates in f32; out = acc / l
// in q's dtype and lse = m + log(l).  The diagonal key is always visible,
// so l >= 1.
//
// Known weaknesses, left to later changes: CUDA-core FMA where wgmma
// (bf16 tensor cores) would be ~15x the rate; the GQA group's query heads
// each read the same K/V tiles (sharing them, and TMA, are the next
// steps).
//
// Interface: a plain C function (flash_attention at the bottom), built
// with nvcc into a shared library and called through ctypes.  It launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "decode_common.cuh"

namespace {

using namespace decode;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane

// Shared memory: kStages stages of [K tile (padded rows) | V tile], then
// the CTA's q rows as f32.
template <typename T, int D>
struct AttnTile {
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
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           float* __restrict__ lse, int bh_count, int h,
                           int hkv, int s, int causal, int window,
                           float scale) {
  using G = AttnTile<T, D>;
  constexpr int VPR = G::kVpr;
  constexpr int KS = G::kKStride;
  constexpr int VEC = G::kVec;
  constexpr int E = D / 32;             // output elements per lane
  constexpr int R = kRowsPerWarp;
  extern __shared__ uint4 smem[];
  float* qs = reinterpret_cast<float*>(smem + kStages * G::kStageVecs);

  const int n_qt = (s + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % bh_count;             // row * h + head
  const int qt = n_qt - 1 - blockIdx.x / bh_count;  // last tiles first
  const int head = bh % h;
  const int kvh = bh / h * hkv + head / (h / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int q0 = qt * kBQ;
  const int q_last = min(q0 + kBQ, s) - 1;

  // The q tile, as f32 (rows past s as zeros, never written out).
  const size_t q_row0 = static_cast<size_t>(bh) * s + q0;
  for (int i = threadIdx.x; i < kBQ * D; i += blockDim.x) {
    const int r = i / D;
    qs[i] = q0 + r < s ? Elem<T>::load(q[q_row0 * D + i]) : 0.f;
  }

  // The keys this q-tile can see, in whole tiles: [t_lo, t_hi].
  int k_lo = 0;
  int k_hi = s - 1;
  if (causal) {
    k_hi = q_last;
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  const int t_lo = k_lo / kBK;
  const int ntiles = k_hi / kBK - t_lo + 1;

  const size_t kv_row0 = static_cast<size_t>(kvh) * s;
  const uint4* kg = reinterpret_cast<const uint4*>(k) + kv_row0 * VPR;
  const uint4* vg = reinterpret_cast<const uint4*>(v) + kv_row0 * VPR;

  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int start = (t_lo + t) * kBK;
      const int n = min(kBK, s - start);
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
  const int row0 = q0 + warp * R;       // position of its first row

  load_tile(0);
  for (int t = 0; t < ntiles; ++t) {
    load_tile(t + 1);
    cp_async_wait_one();  // tile t has landed (t + 1 may be in flight)
    __syncthreads();      // ... for every thread; the q tile too
    const int start = (t_lo + t) * kBK;
    const int n = min(kBK, s - start);
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

    // Merge the tile into each row's carry; P rounded to v's dtype.
    float pr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int qpos = row0 + r;
      bool vis = lane < n && qpos < s;
      if (causal)
        vis = vis && key <= qpos && (window == 0 || qpos - key < window);
      const float sr = vis ? sc[r] * scale : kNegInf;
      const float m_new = fmaxf(m[r], warp_max(sr));
      const float corr = expf(m[r] - m_new);
      const float p = vis ? expf(sr - m_new) : 0.f;
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
      if (!any) continue;  // the same for every lane: j is masked for all
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
    const int qpos = row0 + r;
    if (qpos >= s) continue;
    const size_t o = static_cast<size_t>(bh) * s + qpos;
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[o * D + lane * E + e] = Elem<T>::store(acc[r][e] / l[r]);
    if (lane == 0) lse[o] = m[r] + logf(l[r]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int b, int h, int hkv, int s, int causal,
                   int window, float scale, cudaStream_t stream) {
  const size_t smem = AttnTile<T, D>::kBytes;
  const cudaError_t err = allow_smem(flash_attention_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (s + kBQ - 1) / kBQ;
  flash_attention_kernel<T, D><<<n_qt * b * h, 32 * kWarps, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, b * h, h, hkv, s,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out [b, h, s, d] and k, v [b, hkv, s, d], all contiguous and 16-byte
// aligned, in one dtype (0: f32, 1: bf16); lse [b, h, s] f32.  causal 0
// or 1; window 0 means no window (a window needs causal); scale multiplies
// q.k.  Returns a cudaError_t: 0 on a successful launch.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, float* lse, int b, int h, int hkv,
                               int s, int d, int dtype, int causal,
                               int window, float scale, int device,
                               void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (b < 1 || h < 1 || hkv < 1 || s < 1 || h % hkv != 0 || window < 0 ||
      (window > 0 && !causal) ||
      static_cast<long long>((s + kBQ - 1) / kBQ) * b * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(dtype, d, [&](auto tag, auto dim) {
    using T = std::remove_pointer_t<decltype(tag)>;
    return launch<T, decltype(dim)::value>(q, k, v, out, lse, b, h, hkv, s,
                                           causal != 0, window, scale, st);
  }));
}
