// Pieces shared by the one-token decode kernels (flash_decode.cu, K3, and
// paged_flash_decode.cu, K4) for NVIDIA Hopper, sm_90a.  The other
// kernels take the element types, the cp.async and warp helpers and the
// dispatch over dtype and head_dim from here too.
//
// Split-KV over a thread-block cluster.  A call's grid is one cluster of
// kSplits CTAs for each (row, KV head, chunk of up to kMaxGroup query
// heads of its GQA group).  Every CTA works out the row's visible
// positions [lo, hi] from the lengths on the device, takes the rank-th of
// kSplits contiguous parts of that range, cut at whole kGranule-key
// blocks (split_part), and folds the part's keys into an online-softmax
// carry of its own (f32 m, l and acc for each query head of the chunk) in
// its shared memory (split_decode).  After a cluster barrier, each rank
// merges one slice of the outputs, reading the kSplits carries through
// distributed shared memory and folding them in rank order
// (cluster_merge); a second barrier keeps every CTA's shared memory alive
// until all have read it.  One launch, no global workspace and no
// atomics, so the bits do not depend on the schedule.  A CTA whose part
// is empty merges as m = -1e30, l = 0, acc = 0; a row with no visible key
// yields zeros.
//
// Inside a CTA the part is staged in tiles of K and V rows by cp.async in
// 16-byte vectors, double-buffered (stage_tile).  A key that is not
// visible (past the part, or in a dead block of K4's table) is not
// copied: its rows are zeroed and its live flag cleared, so its P is
// exactly 0 and 0 * V stays finite.
//
// - bf16: four warps over 64-key tiles.  Up to 16 heads make one m-tile
//   (rows past the chunk are zeros) whose output columns are split over
//   the four warps; more make two m-tiles of two warps each.  Every warp
//   of an m-tile computes the same S = Q.K^T for the whole tile on the
//   tensor cores (mma.sync m16n8k16, f32 accumulate), so the warps share
//   m and l bit for bit and write their columns of the carry with no
//   merge between them; the softmax runs on S's accumulator fragments,
//   and P, rounded to bf16 once, is packed in registers as the A operand
//   of its O += P.V columns (mma_tile).  Fragments come from ldmatrix
//   over rows padded by 16 bytes (no bank conflicts).
// - f32: one warp per query head merges whole tiles on CUDA cores, a lane
//   per key (merge_tile), straight into the CTA's carry.
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
// softmax in f32 starting from m = -1e30; P is rounded to v's dtype
// before PV, at the running max of the part's tiles merged so far (bf16
// takes P from the fast exponential, whose error is far under that
// rounding); PV accumulates in f32; l is clamped to 1e-30 so
// a row with no visible key yields zeros; the output is written in q's
// dtype.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper_tc.cuh"

namespace decode {

namespace cg = cooperative_groups;

constexpr float kNegInf = -1e30f;
constexpr int kMaxGroup = 32;
constexpr int kStages = 2;
constexpr int kTileBytes = 8192;   // f32 K (or V) bytes per tile, unpadded
// CTAs of a cluster, the parts of a row: the portable maximum.  On an
// H100 at the serving ticks, 4 / 8 / 16 gave K3 0.0129 / 0.0109 / 0.0107
// ms and K4 0.0159 / 0.0131 / 0.0179 (at 16, K4's CTAs overflow a wave).
constexpr int kSplits = 8;
constexpr int kGranule = 16;   // keys of a block: parts are whole blocks
constexpr int kMmaKeys = 64;   // bf16 keys per tile
constexpr int kMmaWarps = 4;   // bf16 warps per CTA

template <typename T>
struct Elem;

template <>
struct Elem<float> {
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
  // Round to nearest even.
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16(x);
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

// One 4-byte word, e.g. a block-table entry.
__device__ __forceinline__ void cp_async_word(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The rank-th of kSplits contiguous parts of the visible positions [lo,
// hi], cut at whole kGranule-key blocks: each part holds ceil(blocks /
// kSplits) blocks, the last ones fewer or none (first > last: empty).
__device__ __forceinline__ void split_part(int lo, int hi, int rank,
                                           int& first, int& last) {
  const int blocks = hi >= lo ? (hi - lo) / kGranule + 1 : 0;
  const int per = (blocks + kSplits - 1) / kSplits * kGranule;
  first = lo + rank * per;
  last = min(hi, first + per - 1);
}

// Tile geometry for element type T and head_dim D.  A stage holds K rows
// then V rows, each padded by 16 bytes (so the rows that lanes or
// ldmatrix read together fall in distinct banks).  bf16 tiles are 64
// keys; f32 tiles kTileBytes of K, from 64 keys (D 32) down to 8 (D 256).
template <typename T, int D>
struct Tile {
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kVec = 16 / sizeof(T);         // elements per vector
  static constexpr int kVpr = D / kVec;               // vectors per row
  static constexpr int kStride = kVpr + 1;            // padded row, vectors
  static constexpr int kRowBytes = kStride * 16;
  static constexpr int kKeys =
      kMma ? kMmaKeys : kTileBytes / (D * static_cast<int>(sizeof(T)));
  static constexpr int kStageVecs = 2 * kKeys * kStride;
};

// Dynamic shared memory of a CTA, in bytes from the start: the stages;
// the carry (f32 m and l for each of kMaxGroup heads, then acc [kMaxGroup,
// D]); a live flag per staged key; then bf16's Q tile (kMaxGroup padded
// rows) or each f32 warp's q and P (D + kKeys floats).  bytes() is where
// a kernel's own extra (K4's table row) starts.
template <typename T, int D>
struct Smem {
  using G = Tile<T, D>;
  static constexpr int kCarry = kStages * G::kStageVecs * 16;
  static constexpr int kFlags = kCarry + kMaxGroup * (2 + D) * 4;
  static constexpr int kQ = kFlags + (kStages * G::kKeys + 15) / 16 * 16;
  static __host__ __device__ int bytes(int warps) {
    return kQ + (G::kMma ? kMaxGroup * G::kRowBytes
                         : warps * (D + G::kKeys) * 4);
  }
};

// Threads of a CTA: four warps in bf16, a warp per query head of the
// chunk in f32.
template <typename T>
struct Threads {
  static constexpr int kMax =
      std::is_same<T, __nv_bfloat16>::value ? 32 * kMmaWarps : 32 * kMaxGroup;
  static int of(int group) {
    return std::is_same<T, __nv_bfloat16>::value
               ? kMax
               : 32 * (group < kMaxGroup ? group : kMaxGroup);
  }
};

// Zero `vecs` 16-byte vectors of shared memory with the whole CTA.
__device__ __forceinline__ void zero_smem(uint4* p, int vecs) {
  for (int i = threadIdx.x; i < vecs; i += blockDim.x)
    p[i] = make_uint4(0u, 0u, 0u, 0u);
}

// Stage keys 0 .. n - 1 of a tile into one stage at kst: key r is row
// row(r) of k and of v, rows d elements apart (row(r) < 0: a dead block,
// not copied).  live[r] tells, for every key of the tile, whether it was
// copied; a key that was not (past n, or dead) gets zero K and V rows.
// Rows of whole 16-byte vectors go by cp.async; any other width element
// by element.  Columns past d are left as they are (zeros).
template <typename T, int D, typename Row>
__device__ __forceinline__ void stage_tile(uint4* kst, unsigned char* live,
                                           const T* k, const T* v, int n,
                                           int d, Row row) {
  using G = Tile<T, D>;
  constexpr int BK = G::kKeys;
  constexpr int VPR = G::kVpr;
  constexpr int RS = G::kStride;
  uint4* vst = kst + BK * RS;
  const int bytes = d * static_cast<int>(sizeof(T));
  if (bytes % 16 == 0) {
    // tpk threads to a key, each finding the key's row once and copying
    // every tpk-th of its vectors.
    const int vpr = bytes / 16;
    const int tpk = blockDim.x >= BK ? blockDim.x / BK : 1;
    for (int r = threadIdx.x / tpk; r < BK; r += blockDim.x / tpk) {
      const long long j = r < n ? row(r) : -1;
      const int c0 = threadIdx.x % tpk;
      if (c0 == 0) live[r] = j >= 0;
      for (int c = c0; c < VPR; c += tpk) {
        if (j < 0) {
          kst[r * RS + c] = make_uint4(0u, 0u, 0u, 0u);
          vst[r * RS + c] = make_uint4(0u, 0u, 0u, 0u);
        } else if (c < vpr) {
          cp_async16(kst + r * RS + c,
                     reinterpret_cast<const uint4*>(k + j * d) + c);
          cp_async16(vst + r * RS + c,
                     reinterpret_cast<const uint4*>(v + j * d) + c);
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < BK * d; i += blockDim.x) {
      const int r = i / d;
      const int c = i % d;
      const long long j = r < n ? row(r) : -1;
      if (c == 0) live[r] = j >= 0;
      T* kr = reinterpret_cast<T*>(kst + r * RS);
      T* vr = reinterpret_cast<T*>(vst + r * RS);
      kr[c] = j < 0 ? Elem<T>::store(0.f) : k[j * d + c];
      vr[c] = j < 0 ? Elem<T>::store(0.f) : v[j * d + c];
    }
  }
}

// f32: merge the n keys of one staged tile into the calling warp's carry:
// qw is the warp's query (D floats), sc its kKeys-float score scratch,
// acc its D/32 output elements per lane.  A key that is not live was
// never copied in, so it is not scored and its P is exactly 0.  Each lane
// scores whole keys (lane j takes keys j, j + 32, ...), so a tile costs
// one warp reduction for the max and one for the sum.  Kept out of line:
// inlined into the paged kernel (CUDA 12.9, sm_90a) the f32 build faults
// with an illegal address on its first tile, but only when both cicc and
// ptxas optimise: the same PTX assembled by ptxas -O0, a cicc -O0 build,
// this out-of-line build and the inlined K3 match the plain version in
// every case.  The fault stays with K4's block table neither copied nor
// read, with "memory" clobbers on every cp.async, without the live-flag
// and zero-P skips, without the unrolled P.V loop and with no register
// cap, so it is not tied to the paged staging.
template <int D>
__device__ __noinline__ void merge_tile(const uint4* kst,
                                        const unsigned char* live, int n,
                                        const float* qw, float* sc,
                                        float scale, float& m, float& l,
                                        float* acc) {
  using G = Tile<float, D>;
  constexpr int BK = G::kKeys;
  constexpr int VPR = G::kVpr;
  constexpr int RS = G::kStride;
  constexpr int E = D / 32;
  const int lane = threadIdx.x % 32;
  const float* vs = reinterpret_cast<const float*>(kst + BK * RS);

  float mx = kNegInf;
  for (int j = lane; j < n; j += 32) {
    if (!live[j]) continue;
    const uint4* kr = kst + j * RS;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int c = 0; c < VPR; ++c) {
      float kf[4];
      Elem<float>::unpack(kr[c], kf);
      const float* qc = qw + c * 4;
#pragma unroll
      for (int i = 0; i < 4; i += 2) {
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
    const float p = live[j] ? expf(sc[j] - m_new) : 0.f;
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
    const float p = sc[j];
    if (p == 0.f) continue;  // a key not copied in, or one that adds 0
    const float* vr = vs + j * RS * 4 + lane * E;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += p * vr[e];
  }
  m = m_new;
}

// bf16: one warp's carry in registers: acc for its NT n8-tiles of columns
// of an m-tile (16 query heads) as mma.sync accumulator fragments, and m
// and the lane's share of l for its rows r = lane / 4 and r + 8.
template <int NT>
struct MmaCarry {
  float acc[NT][4];
  float m[2];
  float l[2];
};

// bf16: merge one staged tile of kMmaKeys keys into a warp's carry on the
// tensor cores.  q, k and v are the shared-memory addresses of the
// m-tile's first query row and of the tile's first K and V rows, rows RB
// bytes apart; live[j] says whether key j was copied.  Every warp of an
// m-tile computes the same S = Q.K^T over all the tile's keys (so they
// hold the same m and l bit for bit) and its own NT n8-tiles of
// O += P.V, from column col0.
template <int D, int NT, int RB>
__device__ __forceinline__ void mma_tile(uint32_t q, uint32_t k, uint32_t v,
                                         int col0, const unsigned char* live,
                                         float scale, MmaCarry<NT>& c) {
  constexpr int BK = kMmaKeys;
  const int lane = threadIdx.x % 32;
  const int c0 = 2 * (lane % 4);
  // ldmatrix row addresses: Q (A) and V (transposed B) row (lane % 8) +
  // 8 * (lane / 8 % 2), column 8 * (lane / 16); K (B) row (lane % 8) +
  // 8 * (lane / 16), column 8 * (lane / 8 % 2).
  const uint32_t a_off = (lane % 8 + lane / 8 % 2 * 8) * RB + lane / 16 * 16;
  const uint32_t b_off = (lane % 8 + lane / 16 * 8) * RB + lane / 8 % 2 * 16;
  // S[16 heads x BK keys] as BK / 8 n8-tiles: s[j][e] is key 8j + c0 +
  // (e & 1) of row r + 8 (e >> 1).
  float s[BK / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, q + a_off + kk * 32);
#pragma unroll
    for (int kb = 0; kb < BK / 16; ++kb) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, k + kb * 16 * RB + b_off + kk * 32);
      tc::mma_16816(s[2 * kb], a, b[0], b[1]);
      tc::mma_16816(s[2 * kb + 1], a, b[2], b[3]);
    }
  }
  // Bit 2j + i of ok: key 8j + c0 + i was copied (the tile's flags as
  // two warp ballots, bit k of word h for key 32h + k).
  static_assert(BK == 64, "two ballots hold a tile's flags");
  const unsigned word[2] = {__ballot_sync(0xffffffffu, live[lane] != 0),
                            __ballot_sync(0xffffffffu, live[lane + 32] != 0)};
  unsigned ok = 0;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
    ok |= (word[j / 4] >> (8 * j % 32 + c0) & 3u) << (2 * j);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      if (ok >> (2 * j + (e & 1)) & 1u) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(c.m[i], mx[i]);
    corr[i] = expf(c.m[i] - m_new);
    c.m[i] = m_new;
    c.l[i] *= corr[i];
  }
  // P = exp(s - m) by the fast exponential (2 ulp + 1.16 |s - m| ulp of
  // error, far under the bf16 rounding P takes next).
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ok >> (2 * j + (e & 1)) & 1u
                          ? __expf(s[j][e] - c.m[e >> 1]) : 0.f;
      s[j][e] = p;
      c.l[e >> 1] += p;
    }
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    c.acc[t][0] *= corr[0];
    c.acc[t][1] *= corr[0];
    c.acc[t][2] *= corr[1];
    c.acc[t][3] *= corr[1];
  }
#pragma unroll
  for (int kb = 0; kb < BK / 16; ++kb) {
    // P's 16 keys of this step as the A operand, in the accumulator's
    // own order: rounded to bf16 once.
    const uint32_t pa[4] = {tc::pack_bf16(s[2 * kb][0], s[2 * kb][1]),
                            tc::pack_bf16(s[2 * kb][2], s[2 * kb][3]),
                            tc::pack_bf16(s[2 * kb + 1][0], s[2 * kb + 1][1]),
                            tc::pack_bf16(s[2 * kb + 1][2], s[2 * kb + 1][3])};
    const uint32_t vk = v + kb * 16 * RB + col0 * 2;
    if constexpr (NT % 2 == 0) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, vk + a_off + np * 32);
        tc::mma_16816(c.acc[2 * np], pa, b[0], b[1]);
        tc::mma_16816(c.acc[2 * np + 1], pa, b[2], b[3]);
      }
    } else {
      uint32_t b[2];
      tc::ldmatrix_x2_trans(b, vk + (lane % 8 + lane / 8 % 2 * 8) * RB);
      tc::mma_16816(c.acc[0], pa, b[0], b[1]);
    }
  }
}

// bf16: a warp's carry into the CTA's (m and l by the warp with col0 = 0,
// the quad's shares of l summed): rows row0 .. row0 + 15, its columns.
template <int D, int NT>
__device__ __forceinline__ void store_mma_carry(MmaCarry<NT>& c,
                                                float* carry, int row0,
                                                int col0) {
  const int lane = threadIdx.x % 32;
  const int r = row0 + lane / 4;
  const int c0 = col0 + 2 * (lane % 4);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    c.l[i] += __shfl_xor_sync(0xffffffffu, c.l[i], 1);
    c.l[i] += __shfl_xor_sync(0xffffffffu, c.l[i], 2);
  }
  if (col0 == 0 && lane % 4 == 0) {
    carry[r] = c.m[0];
    carry[r + 8] = c.m[1];
    carry[kMaxGroup + r] = c.l[0];
    carry[kMaxGroup + r + 8] = c.l[1];
  }
  float* acc = carry + 2 * kMaxGroup;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    *reinterpret_cast<float2*>(acc + r * D + c0 + 8 * t) =
        make_float2(c.acc[t][0], c.acc[t][1]);
    *reinterpret_cast<float2*>(acc + (r + 8) * D + c0 + 8 * t) =
        make_float2(c.acc[t][2], c.acc[t][3]);
  }
}

// The cluster's merge: after a cluster barrier, rank r merges the r-th of
// kSplits contiguous slices of the heads x d outputs, reading the kSplits
// CTAs' carries (at `carry` in each one's shared memory) and folding them
// in rank order: out = sum of w_i acc_i / max(sum of w_i l_i, 1e-30), w_i
// = exp(m_i - max m), in T.  A second barrier keeps every CTA's shared
// memory alive until all have read it.
template <typename T, int D>
__device__ __forceinline__ void cluster_merge(const float* carry, T* out,
                                              int heads, int d) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's carry is in place
  const int rank = static_cast<int>(cluster.block_rank());
  const float* part[kSplits];
#pragma unroll
  for (int r = 0; r < kSplits; ++r)
    part[r] = cluster.map_shared_rank(carry, r);
  const int total = heads * d;
  const int per = (total + kSplits - 1) / kSplits;
  const int end = min(total, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < end; e += blockDim.x) {
    const int row = e / d;
    const int col = e % d;
    float m[kSplits], l[kSplits], a[kSplits];
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      m[r] = part[r][row];
      l[r] = part[r][kMaxGroup + row];
      a[r] = part[r][2 * kMaxGroup + row * D + col];
    }
    float mx = kNegInf;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) mx = fmaxf(mx, m[r]);
    float ls = 0.f, as = 0.f;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      const float w = expf(m[r] - mx);
      ls += w * l[r];
      as += w * a[r];
    }
    out[e] = Elem<T>::store(as / fmaxf(ls, 1e-30f));
  }
  cluster.sync();  // every rank has read every carry: the CTAs may exit
}

// Stage the chunk's `heads` queries (q at the first, [heads, d]) in
// shared memory as T: bf16 as the Q tile (kMaxGroup padded rows), f32 as
// each warp's query row; zeros past the chunk and past d.  Rows of whole
// 16-byte vectors go by cp.async, so a kernel that calls this before it
// waits on its row's length has the two in flight together; everything
// the CTA issued by cp.async so far is committed as one group, which
// split_decode waits for.
template <typename T, int D>
__device__ __forceinline__ void stage_q(unsigned char* smem, const T* q,
                                        int heads, int d) {
  using G = Tile<T, D>;
  constexpr int VPR = G::kVpr;
  const int rows = G::kMma ? kMaxGroup : blockDim.x / 32;
  const int stride = G::kMma ? G::kRowBytes : (D + G::kKeys) * 4;  // bytes
  unsigned char* base = smem + Smem<T, D>::kQ;
  const int bytes = d * static_cast<int>(sizeof(T));
  if (bytes % 16 == 0) {
    const int vpr = bytes / 16;
    for (int i = threadIdx.x; i < rows * VPR; i += blockDim.x) {
      const int r = i / VPR;
      const int c = i % VPR;
      uint4* dst = reinterpret_cast<uint4*>(base + r * stride) + c;
      if (r < heads && c < vpr)
        cp_async16(dst, reinterpret_cast<const uint4*>(q + r * d) + c);
      else
        *dst = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
      const int r = i / D;
      const int c = i % D;
      reinterpret_cast<T*>(base + r * stride)[c] =
          r < heads && c < d ? q[r * d + c] : Elem<T>::store(0.f);
    }
  }
  cp_async_commit();
}

// One CTA of a split decode, after stage_q: fold keys [first, last] of
// one row and KV head into the carry of the chunk's `heads` query heads,
// then the cluster merge into out (the chunk's first head, [heads, d]).
// row_of(pos) is key pos's row in k and v ([*, d]), or -1 for a dead
// block.  A kernel's own shared memory (K4's table row, copied with q)
// sits past Smem::bytes.
template <typename T, int D, typename RowOf>
__device__ __forceinline__ void split_decode(unsigned char* smem, T* out,
                                             const T* k, const T* v,
                                             int heads, int d, float scale,
                                             int first, int last,
                                             RowOf row_of) {
  using G = Tile<T, D>;
  using S = Smem<T, D>;
  constexpr int BK = G::kKeys;
  uint4* stages = reinterpret_cast<uint4*>(smem);
  float* carry = reinterpret_cast<float*>(smem + S::kCarry);
  unsigned char* flags = smem + S::kFlags;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (d < D) zero_smem(stages, kStages * G::kStageVecs);  // columns past d
  cp_async_wait_all();  // q and the kernel's own copies (K4's table row)
  __syncthreads();  // ... and the zeros are in place

  const int ntiles = last >= first ? (last - first) / BK + 1 : 0;
  auto load_tile = [&](int t) {
    if (t < ntiles) {
      const int start = first + t * BK;
      stage_tile<T, D>(stages + (t % kStages) * G::kStageVecs,
                       flags + (t % kStages) * BK, k, v,
                       min(BK, last - start + 1), d,
                       [&](int r) { return row_of(start + r); });
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  if constexpr (G::kMma) {
    // Up to 16 heads: one m-tile, its columns over the four warps; more:
    // two m-tiles, each with half the columns on two warps.
    auto run = [&](auto nt) {
      constexpr int NT = decltype(nt)::value;  // n8-tiles of a warp
      constexpr int CG = D / 8 / NT;           // warps of an m-tile
      const int col0 = warp % CG * NT * 8;
      const uint32_t q_s =
          tc::smem_addr(smem + S::kQ) + warp / CG * 16 * G::kRowBytes;
      MmaCarry<NT> c;
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) c.acc[t][e] = 0.f;
      c.m[0] = c.m[1] = kNegInf;
      c.l[0] = c.l[1] = 0.f;
      load_tile(0);
      for (int t = 0; t < ntiles; ++t) {
        load_tile(t + 1);
        cp_async_wait_one();  // tile t has landed (t + 1 may be in flight)
        __syncthreads();
        const uint32_t ks =
            tc::smem_addr(stages + (t % kStages) * G::kStageVecs);
        mma_tile<D, NT, G::kRowBytes>(q_s, ks, ks + BK * G::kRowBytes, col0,
                                      flags + (t % kStages) * BK, scale, c);
        __syncthreads();  // the stage is free for the copy issued next
      }
      store_mma_carry<D, NT>(c, carry, warp / CG * 16, col0);
    };
    if (heads > 16)
      run(std::integral_constant<int, D / 16>{});
    else
      run(std::integral_constant<int, D / 32>{});
  } else {
    constexpr int E = D / 32;
    float* qw = reinterpret_cast<float*>(smem + S::kQ) + warp * (D + BK);
    float* sc = qw + D;
    float m = kNegInf;
    float l = 0.f;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;

    load_tile(0);
    for (int t = 0; t < ntiles; ++t) {
      load_tile(t + 1);
      cp_async_wait_one();  // tile t has landed (t + 1 may be in flight)
      __syncthreads();
      const int n = min(BK, last - (first + t * BK) + 1);
      if (warp < heads)
        merge_tile<D>(stages + (t % kStages) * G::kStageVecs,
                         flags + (t % kStages) * BK, n, qw, sc, scale, m, l,
                         acc);
      __syncthreads();  // the stage is free for the copy issued next
    }
    if (lane == 0) {
      carry[warp] = m;
      carry[kMaxGroup + warp] = l;
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      carry[2 * kMaxGroup + warp * D + lane * E + e] = acc[e];
  }
  cluster_merge<T, D>(carry, out, heads, d);
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

// Launch `kernel` over `ctas` clusters of kSplits CTAs each, with
// `threads` threads and `smem` bytes of dynamic shared memory a CTA.  A
// refused launch (shared memory, cluster size) returns its error.
template <typename... Params, typename... Args>
cudaError_t launch_split(void (*kernel)(Params...), int ctas, int threads,
                         size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas) * kSplits);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
