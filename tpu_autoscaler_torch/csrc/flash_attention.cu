// Flash-attention forward (causal, sliding-window or full, GQA) for
// NVIDIA Hopper, sm_90a.
//
// Replaces tpu_autoscaler/workloads/attention.py::_attn_fwd_kernel, the
// Pallas kernel behind _forward_pallas and flash_attention.  Same
// function: q [b, h, s, d] attends over k/v [b, hkv, s, d]; query head g
// reads KV head g / (h / hkv); key j is visible to query i iff j <= i and
// i - j < window (causal), or always (not causal).  It returns out
// [b, h, s, d] in q's dtype and the f32 log-sum-exp lse [b, h, s] of each
// row's scaled scores, which the backward (K2, flash_attention_bwd.cu)
// reads.
//
// What bounds it.  The call must move q, k, v and out once and do 4*d
// flops per visible (query, key) pair.  At the trainer's layer (b 16,
// h 16, s 1024, d 64, causal, bf16) that is 134 MB and 34 GFLOP, about
// as much time on the memory (0.040 ms) as on the bf16 tensor cores
// (0.035 ms); at the long-sequence recipe's (b 8, h 12, s 2048, d 128)
// 201 MB and 103 GFLOP, bound by the tensor cores (0.104 ms).  Either
// way the products must run on the tensor cores, and nothing but q, k,
// v, out and lse may touch device memory.
//
// bf16: the ring hop's tensor-core tile (flash_fwd_tc.cuh, K5) at offset
// 0 over its own block (masked = causal, sq = sk = s), instantiated with
// the Normalised IO: the f32 carry starts in registers at (-1e30, 0, 0)
// and never touches device memory, and the epilogue writes out = acc / l
// in bf16 and lse = m + log(l).  One CTA per (row, query head, 128 query
// rows), the last q-tiles (the most keys) first; two consumer warpgroups
// run S = Q.K^T and O += P.V on wgmma with P in registers, a producer
// warp streams q and a ring of K/V tiles by TMA; the CTA loops only over
// the k-tiles its rows see.  Every row sees its diagonal key, so the
// ring hop's lone-row case does not arise.  At d 32 and 64 a tile holds
// 128 keys (the trainer's d 64: an S tile as wide as the O tile),
// at d 128 64 keys and at d 256 32.
//
// f32: the CUDA-core kernel (flash_attention_fma_kernel): tensor cores
// would run f32 as TF32 (about three decimal digits).  One CTA per (row,
// query head, 32 query rows), 8 warps of 4 rows; K/V tiles of 32 keys
// staged by cp.async, double-buffered, K rows padded by 16 bytes so the
// lanes' row reads fall in distinct banks; lane j scores key j against
// the warp's 4 rows, a row's max and sum are one warp reduction each, PV
// takes each key's P from its lane by shuffle; the carry stays in
// registers.  Its ceiling is the 67 TFLOP/s f32 rate.
//
// Any s: tiles are fixed and the tails are masked.  Query rows past s are
// never written.
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
// Interface: a plain C function (flash_attention at the bottom), built
// with nvcc into a shared library and called through ctypes.  It launches
// on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

#include "decode_common.cuh"
#include "flash_fwd_tc.cuh"

namespace {

using namespace decode;

// Keys a bf16 tile holds at head_dim 32 and 64: at the trainer's layer
// on an H100, 64-key tiles timed a little slower than 128.
constexpr int kNarrowKeys = 128;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane

// Shared memory: kStages stages of [K tile (padded rows) | V tile], then
// the CTA's q rows as f32.
template <int D>
struct AttnTile {
  static constexpr int kVec = 4;                   // floats per vector
  static constexpr int kVpr = D / kVec;            // vectors per row
  static constexpr int kKStride = kVpr + 1;        // padded K row
  static constexpr int kStageVecs = kBK * (kKStride + kVpr);
  static constexpr size_t kBytes =
      static_cast<size_t>(kStages) * kStageVecs * 16 +
      static_cast<size_t>(kBQ) * D * sizeof(float);
};

// Block = kWarps warps; grid = n_qt * b * h, the last q-tiles first.
template <int D>
__global__ void __launch_bounds__(32 * kWarps)
    flash_attention_fma_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               float* __restrict__ out,
                               float* __restrict__ lse, int bh_count, int h,
                               int hkv, int s, int causal, int window,
                               float scale) {
  using G = AttnTile<D>;
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
    qs[i] = q0 + r < s ? q[q_row0 * D + i] : 0.f;
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
    const float* vs = reinterpret_cast<const float*>(kst + kBK * KS);

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
        Elem<float>::unpack(kr[c], kf);
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

    // Merge the tile into each row's carry.
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
      pr[r] = p;
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
    const int qpos = row0 + r;
    if (qpos >= s) continue;
    const size_t o = static_cast<size_t>(bh) * s + qpos;
#pragma unroll
    for (int e = 0; e < E; ++e)
      out[o * D + lane * E + e] = acc[r][e] / l[r];
    if (lane == 0) lse[o] = m[r] + logf(l[r]);
  }
}

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       void* out, float* lse, int b, int h, int hkv, int s,
                       int causal, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = AttnTile<D>::kBytes;
  const cudaError_t err =
      allow_smem(flash_attention_fma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (s + kBQ - 1) / kBQ;
  flash_attention_fma_kernel<D>
      <<<n_qt * b * h, 32 * kWarps, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), lse,
          b * h, h, hkv, s, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// q, out [b, h, s, d] and k, v [b, hkv, s, d], all contiguous and 16-byte
// aligned, in one dtype (0: f32, on the CUDA cores; 1: bf16, on the
// tensor cores); lse [b, h, s] f32.  causal 0 or 1; window 0 means no
// window (a window needs causal); scale multiplies q.k.  Returns a
// cudaError_t: 0 on a successful launch.
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
    constexpr int D = decltype(dim)::value;
    if constexpr (std::is_same_v<T, float>) {
      return launch_fma<D>(q, k, v, out, lse, b, h, hkv, s, causal != 0,
                           window, scale, st);
    } else {
      constexpr int BK = D <= 64 ? kNarrowKeys : tc::FwdTile<D>::BK;
      return tc::launch_fwd_tc<D, BK>(
          q, k, v, tc::Normalised{static_cast<__nv_bfloat16*>(out), lse}, b,
          h, hkv, s, s, 0, causal != 0, window, scale, st);
    }
  }));
}
