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
// bf16: wgmma, TMA and a warp-specialised CTA, the tile K1 shares
// (flash_fwd_tc.cuh, instantiated here with the HopCarry IO): 128 query
// rows a CTA in two consumer warpgroups and a producer warp, the last
// q-tiles first; q once and a ring of 3 K/V stages by TMA; S = Q.K^T
// and O += P.V on wgmma with P in registers, tile t's S issued with tile
// t - 1's P.V and its softmax run while P.V is on the tensor cores; the
// carry read once from HBM into the accumulator's fragment layout and
// written once into fresh outputs.  BK = 64 keys (32 at d 256), 3
// stages: deeper rings (5 stages) and 128-key tiles ran slower at the SP
// hop (d 128) on an H100.
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
#include "flash_fwd_tc.cuh"

namespace {

using namespace decode;
using namespace tc;

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kBK = 32;                     // keys per tile: one per lane

// Shared memory: kStages stages of [K tile (padded rows) | V tile], then
// the CTA's q rows as f32 (K1's layout).
template <int D>
struct HopTile {
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
    ring_step_fma_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ m_in,
                           const float* __restrict__ l_in,
                           const float* __restrict__ acc_in,
                           float* __restrict__ m_out,
                           float* __restrict__ l_out,
                           float* __restrict__ acc_out, int bh_count, int h,
                           int hkv, int sq, int sk, int offset, int masked,
                           int window, float scale) {
  using G = HopTile<D>;
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
    qs[i] = q0 + r < sq ? q[q_row0 * D + i] : 0.f;
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

    // Merge the tile into each row's carry.  A masked key scores -1e30,
    // as in the reference, so its P is e^(-1e30 - m'): 0 once the row's
    // max is a real score, 1 while it is still -1e30.  Lanes past the
    // tile (and rows past sq) add nothing.
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
      if (!any) continue;  // the same for every lane: j adds nothing
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

template <int D>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       const float* m_in, const float* l_in,
                       const float* acc_in, float* m_out, float* l_out,
                       float* acc_out, int b, int h, int hkv, int sq, int sk,
                       int offset, int masked, int window, float scale,
                       cudaStream_t stream) {
  const size_t smem = HopTile<D>::kBytes;
  const cudaError_t err = allow_smem(ring_step_fma_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (sq + kBQ - 1) / kBQ;
  ring_step_fma_kernel<D>
      <<<n_qt * b * h, 32 * kWarps, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), m_in, l_in, acc_in, m_out, l_out,
          acc_out, b * h, h, hkv, sq, sk, offset, masked, window, scale);
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
    if constexpr (std::is_same_v<T, float>)
      return launch_fma<D>(q, k, v, static_cast<const float*>(m_in),
                           static_cast<const float*>(l_in),
                           static_cast<const float*>(acc_in),
                           static_cast<float*>(m_out),
                           static_cast<float*>(l_out),
                           static_cast<float*>(acc_out), b, h, hkv, sq, sk,
                           offset, masked != 0, window, scale, st);
    else
      return launch_fwd_tc<D>(
          q, k, v,
          HopCarry{static_cast<const float*>(m_in),
                   static_cast<const float*>(l_in),
                   static_cast<const float*>(acc_in),
                   static_cast<float*>(m_out), static_cast<float*>(l_out),
                   static_cast<float*>(acc_out)},
          b, h, hkv, sq, sk, offset, masked != 0, window, scale, st);
  }));
}
