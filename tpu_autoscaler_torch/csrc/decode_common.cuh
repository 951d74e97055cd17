// Pieces shared by the one-token decode kernels (flash_decode.cu and
// paged_flash_decode.cu) for NVIDIA Hopper, sm_90a.  The prompt kernel
// (flash_attention.cu) takes the element types, the cp.async and warp
// helpers and the dispatch over dtype and head_dim from here too.
//
// Both kernels run one CTA per (row, KV head, up to kMaxGroup query heads
// of its GQA group) and one warp per query head.  K and V tiles are
// staged in shared memory with cp.async, double-buffered; each warp
// merges a staged tile into its own online-softmax carry (m, l, acc) with
// merge_tile below.  Only how a tile's keys are found in device memory
// differs between the kernels.
//
// Head dims: each kernel is built for D = 32, 64, 128 and 256 and takes
// any d <= D at run time (the true width of the cache rows, which a
// padded copy would have to rewrite on every step).  Columns past d are
// zeros in shared memory and in q, so they change no score, and are
// never written out.  A row of d * sizeof(T) bytes that is a multiple of
// 16 is staged by cp.async in 16-byte vectors; any other width by
// element-wide loads (the copy is then not in flight across the merge).
//
// Numerics, matching the TPU kernels: scores are f32 dot products scaled
// after the dot by the caller's scale (d^-0.5 of the true d); online
// softmax in f32 starting from m = -1e30;
// P is rounded to v's dtype before PV; PV accumulates in f32; l is
// clamped to 1e-30 by the caller so a row with no visible key yields
// zeros; the output is written in q's dtype.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace decode {

constexpr float kNegInf = -1e30f;
constexpr int kMaxGroup = 32;
constexpr int kStages = 2;
constexpr int kTileBytes = 8192;   // K (or V) bytes per tile, unpadded

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
  // The 4 floats of a 16-byte vector.
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // P cast to v's dtype (round to nearest even), as the TPU kernel does.
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
  }
  // The 8 bf16 of a 16-byte vector, as floats (bf16 is the top half of
  // an f32, so each conversion is a shift or a mask).
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Tile geometry for element type T and head_dim D.  A stage holds a K
// tile (rows padded by 16 bytes, so the lanes' row reads fall in
// distinct banks) and a V tile.  kTileBytes fixes the keys per tile:
// from 128 (bf16, D 32) down to 8 (f32, D 256).  The largest CTA, a
// group of 32 at bf16 D 256, takes 68 KB of shared memory.
template <typename T, int D>
struct Tile {
  static constexpr int kVec = 16 / sizeof(T);         // elements per vector
  static constexpr int kVpr = D / kVec;               // vectors per row
  static constexpr int kKStride = kVpr + 1;           // padded K row
  static constexpr int kKeys = kTileBytes / (D * sizeof(T));
  static constexpr int kStageVecs = kKeys * (kKStride + kVpr);
  // Dynamic shared memory for the stages and, for g warps (query heads),
  // each warp's P and q.
  static size_t bytes(int g) {
    return static_cast<size_t>(kStages) * kStageVecs * 16 +
           static_cast<size_t>(g) * (kKeys + D) * sizeof(float);
  }
};

// Merge the n keys of one staged tile into the calling warp's carry:
// qw is the warp's query (f32, D), sc its BK-float score scratch, acc its
// D/32 output elements per lane.  live(j) says whether key j of the tile
// is visible; a key that is not was never copied in, so its shared
// memory is neither scored nor read (its P is exactly 0).  Each lane
// scores whole keys (lane j takes keys j, j + 32, ...), so a tile costs
// one warp reduction for the max and one for the sum.
template <typename T, int D, typename Live>
__device__ __forceinline__ void merge_tile(const uint4* kst, int n,
                                           const float* qw, float* sc,
                                           float scale, float& m, float& l,
                                           float* acc, Live live) {
  using G = Tile<T, D>;
  constexpr int BK = G::kKeys;
  constexpr int VPR = G::kVpr;
  constexpr int KS = G::kKStride;
  constexpr int VEC = G::kVec;
  constexpr int E = D / 32;
  const int lane = threadIdx.x % 32;
  const T* vs = reinterpret_cast<const T*>(kst + BK * KS);

  float mx = kNegInf;
  for (int j = lane; j < n; j += 32) {
    if (!live(j)) continue;
    const uint4* kr = kst + j * KS;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int c = 0; c < VPR; ++c) {
      float kf[VEC];
      Elem<T>::unpack(kr[c], kf);
      const float* qc = qw + c * VEC;
#pragma unroll
      for (int i = 0; i < VEC; i += 2) {
        s0 += qc[i] * kf[i];
        s1 += qc[i + 1] * kf[i + 1];
      }
    }
    const float s = (s0 + s1) * scale;
    sc[j] = s;
    mx = fmaxf(mx, s);
  }
  const float m_new = fmaxf(m, warp_max(mx));
  const float corr = expf(m - m_new);
  float psum = 0.f;
  for (int j = lane; j < n; j += 32) {
    const float p = live(j) ? expf(sc[j] - m_new) : 0.f;
    sc[j] = p;
    psum += p;
  }
  psum = warp_sum(psum);
  __syncwarp();  // every lane's P is visible to the whole warp
  l = l * corr + psum;
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float p = Elem<T>::round(sc[j]);
    if (p == 0.f) continue;  // a key not copied in, or one that adds 0
    const T* vr = vs + j * D + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += p * Elem<T>::load(vr[e]);
  }
  m = m_new;
}

// Zero `vecs` 16-byte vectors of shared memory with the whole CTA.
__device__ __forceinline__ void zero_smem(uint4* p, int vecs) {
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Stage the K and V rows of one tile into shared memory: n keys, key r
// in row row(r) of k and of v, rows d elements apart (row(r) < 0: not
// copied), into K rows every kKStride vectors from kst and V rows every
// kVpr vectors from vst; seen(r, row(r)) is called once for each key.
// Rows of the built width D go by cp.async in 16-byte vectors, their
// count and stride known at compile time; a narrower row by cp.async
// vectors when it is a whole number of them, else element by element.
// The columns past d are left as they are (zeros).
template <typename T, int D, typename Row, typename Seen>
__device__ __forceinline__ void stage_kv(uint4* kst, uint4* vst,
                                         const T* k, const T* v, int n,
                                         int d, Row row, Seen seen) {
  constexpr int VPR = Tile<T, D>::kVpr;
  constexpr int KS = Tile<T, D>::kKStride;
  if (d == D) {
    const uint4* kg = reinterpret_cast<const uint4*>(k);
    const uint4* vg = reinterpret_cast<const uint4*>(v);
    for (int i = threadIdx.x; i < n * VPR; i += blockDim.x) {
      const int r = i / VPR;
      const int c = i % VPR;
      const long long j = row(r);
      if (c == 0) seen(r, j);
      if (j < 0) continue;
      const size_t src = static_cast<size_t>(j) * VPR + c;
      cp_async16(kst + r * KS + c, kg + src);
      cp_async16(vst + r * VPR + c, vg + src);
    }
  } else if ((d * sizeof(T)) % 16 == 0) {
    const int vpr = d * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < n * vpr; i += blockDim.x) {
      const int r = i / vpr;
      const int c = i % vpr;
      const long long j = row(r);
      if (c == 0) seen(r, j);
      if (j < 0) continue;
      cp_async16(kst + r * KS + c,
                 reinterpret_cast<const uint4*>(k + j * d) + c);
      cp_async16(vst + r * VPR + c,
                 reinterpret_cast<const uint4*>(v + j * d) + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i % d;
      const long long j = row(r);
      if (c == 0) seen(r, j);
      if (j < 0) continue;
      reinterpret_cast<T*>(kst + r * KS)[c] = k[j * d + c];
      reinterpret_cast<T*>(vst + r * VPR)[c] = v[j * d + c];
    }
  }
}

// The built width a d-wide call runs at: the least of 32, 64, 128 and 256
// that holds d; 0 for none.
inline int built_width(int d) {
  if (d < 1) return 0;
  for (int w = 32; w <= 256; w *= 2)
    if (d <= w) return w;
  return 0;
}

// Raise a kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Make `device` current for the launch.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return err;
}

// The head_dims every kernel is built for: 32, 64, 128 and 256.
template <int D>
using HeadDim = std::integral_constant<int, D>;

template <typename T, typename F>
cudaError_t dispatch_head_dim(int d, F& f) {
  T* tag = nullptr;
  switch (d) {
    case 32: return f(tag, HeadDim<32>{});
    case 64: return f(tag, HeadDim<64>{});
    case 128: return f(tag, HeadDim<128>{});
    case 256: return f(tag, HeadDim<256>{});
    default: return cudaErrorInvalidValue;
  }
}

// Call f(T* tag, std::integral_constant<int, D>) for the element type
// (dtype 0: f32, 1: bf16) and head_dim d of a launch, so each C entry
// names its launch once for every instantiation; any other dtype or d
// is cudaErrorInvalidValue.
template <typename F>
cudaError_t dispatch(int dtype, int d, F f) {
  if (dtype == 0) return dispatch_head_dim<float>(d, f);
  if (dtype == 1) return dispatch_head_dim<__nv_bfloat16>(d, f);
  return cudaErrorInvalidValue;
}

}  // namespace decode
