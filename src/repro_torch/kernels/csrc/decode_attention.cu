// K5: flash-decode — one query token per sequence against a KV cache
// (sm_90a).
//
// Replaces: repro/kernels/decode_attention.py::decode_attention_pallas (the
// TPU kernel walks a (B, Hkv, S/bk) grid with the cache-block axis minor,
// keeps the group's [group, d] accumulator and its running max m and sum l
// in VMEM scratch across it, and handles the `group` q heads that share a
// KV head together, so each cache block is read once per KV head).
//
// What it computes, for batch b and q head h (kv head h / group):
//   s_j = (q_h . k_j) / sqrt(d) for cache positions j < kv_len[b];
//   o_h = sum_j softmax(s)_j v_j (f32 math, stored in q's dtype),
//   m_h = max_j s_j and l_h = sum_j exp(s_j - m_h) (f32), the statistics the
//   sequence-sharded decode combines (repro/parallel/collectives.py:29-39).
// A sequence with kv_len = 0 gives o = 0, m = -1e30, l = 0.
//
// Bound on the card: bytes. Every valid cache row is read once (2 d values
// of the input dtype per row and KV head) and q and o are tiny: at the
// serving decode shape (B 8, Hkv 4, kv_len 1088, d 64, bf16) that is
// ~8.9 MB, ~2.7 us at 3.35 TB/s; the arithmetic (4 d flops per row and q
// head) is far below the roof. At that size the kernel is bound by how many
// bytes are in flight at once and by launch latency, so the design keeps
// the whole cache slice of a CTA in flight from its start and is one launch.
// zamba2-7b's shared-attention decode ([8, 32, 1024, 224], MHA) reads
// ~235 MB (~70 us), h2o-danube-3-4b's ring ([4, 8, 4096, 120], group 4)
// ~63 MB (~19 us).
//
// Design: one launch. The cache is split along S into n_split <= 8 parts;
// the CTAs of one (b, KV head) form a thread-block cluster of n_split CTAs,
// one a split. Each CTA copies its split's K and V rows as they are (bf16
// or f32) into shared memory with cp.async, 16 bytes a thread, issuing a
// whole ring of tiles at CTA start (at the serving shape the rings hold the
// whole 160-row split, 40 KB) and each later tile as soon as its slot is
// consumed, so no load waits for arithmetic. Rows at or past kv_len[b] are
// never read (the copy zero-fills them) and the loop stops at kv_len[b].
// Each K tile is read from shared memory once for all the group's q heads,
// with its 16-byte chunks XOR-swizzled so 8 consecutive rows fall on 8
// distinct bank groups. Two bodies compute the partial softmax:
//   * bf16 with group <= 16 (every served config): tensor cores. The
//     group's q heads are the rows of mma.m16n8k16's A (padded to 16 with
//     zero rows, held in registers); each of the 4 warps owns every 4th
//     16-key chunk of the split with its own cp.async ring, takes
//     S = Q K^T (K through ldmatrix), the online softmax on the fragment
//     (row max and sum across the quad by shuffles), rounds P to bf16 and
//     adds P V (V through ldmatrix.trans), so warps meet only at the end,
//     where the 4 warp partials are combined in warp order. Head widths
//     that are no whole number of 64-value rows are padded in shared
//     memory only: 120 to 128 (its 8 k16 steps' last 8 columns are
//     zero-filled by the copy, q's there are zero) and 224 to 256 (14 k16
//     steps; the pad is never read), so the XOR swizzle stays in the row;
//     at 224 each warp's 2-slot ring takes 32 KB, 133 KB a CTA. P's rounding
//     to bf16 is at most 2^-9 relative a term, the order of the output's
//     own bf16 rounding; m and l are taken from the f32 scores and
//     probabilities.
//   * f32, and bf16 with a larger group: SIMT. One thread a key scores it
//     for every q head (8 heads per read of the K row), then each q head
//     owns LPH lanes of one warp, d/4 rounded up to a power of two and at
//     most 32 (32 at d 120 and 224), 4 output dims a lane (8 at d 224:
//     dims 4 l and 4 (l + 32)) in registers: the
//     head's tile max and sum by warp shuffles, the probabilities in shared
//     memory, V swept for the thread's dims; products and sums in f32.
// Then each CTA leaves its partial (acc, m, l) in its shared memory; after a
// cluster barrier, the split-0 CTA reads its peers' partials over
// distributed shared memory and combines them in split order,
//   M = max_i m_i, L = sum_i l_i e^(m_i - M), o = sum_i acc_i e^(m_i - M) / L,
// so m and l are the whole-cache values; a second cluster barrier keeps
// every CTA alive until split 0 has read it. Every CTA reaches both
// barriers, also a split that lies wholly past kv_len (it reports m = -1e30,
// l = 0). No global scratch, no atomics, no counter: deterministic, and a
// CUDA-graph replay equals an eager call.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kHeadBatch = 8;      // q heads a score thread takes per K row read
constexpr int kRingBytes = 48 * 1024;

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// 16 bytes of the input dtype as f32 values
__device__ __forceinline__ void to_f32(const uint4& raw, float (&x)[4]) {
  x[0] = __uint_as_float(raw.x);
  x[1] = __uint_as_float(raw.y);
  x[2] = __uint_as_float(raw.z);
  x[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void to_f32(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// 4 consecutive values of the input dtype as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the smallest power of two >= x (x >= 1)
constexpr int pow2_ceil(int x) { return x <= 1 ? 1 : 2 * pow2_ceil((x + 1) / 2); }

template <typename T, int D>
struct Tile {
  static_assert(D % 8 == 0, "a head row is whole 16-byte chunks and float4 slices");
  // lanes of one warp a q head takes for P V (a power of two, so its
  // softmax reduces by xor shuffles), each owning NCH 4-dim slices: lane l
  // owns dims 4 (l + i LPH) for i < NCH, those below D
  static constexpr int LPH = D / 4 >= 32 ? 32 : pow2_ceil(D / 4);
  static constexpr int NCH = (D / 4 + LPH - 1) / LPH;
  static constexpr int BK = D <= 64 ? 64 : (D <= 128 ? 32 : 16);  // cache rows per tile
  static constexpr int VE = 16 / sizeof(T);             // values per 16-byte chunk
  static constexpr int CPR = D / VE;                    // chunks per row
  static constexpr int TILE_BYTES = BK * D * sizeof(T);  // one K (or V) tile
  static constexpr int NS0 = kRingBytes / (2 * TILE_BYTES);
  static constexpr int NS = NS0 < 2 ? 2 : (NS0 > 8 ? 8 : NS0);  // ring depth
  static constexpr int PS = BK + 1;                     // score row stride
  static_assert(CPR >= 8 || (CPR & (CPR - 1)) == 0, "a short row is a power of two of chunks");
  // XOR pattern of a K row's 16-byte chunks: 8 consecutive rows put a given
  // chunk on 8 distinct 16-byte bank groups (a row of 15, 28, 30 or 56
  // chunks leaves its last CPR % 8 in place)
  static __device__ __forceinline__ int swz(int r, int c) {
    return CPR >= 8 ? (c < (CPR & ~7) ? c ^ (r & 7) : c)
                    : c ^ ((r / (8 / CPR)) & (CPR - 1));
  }
  static size_t smem_bytes(int group) {
    return (size_t)2 * NS * TILE_BYTES +
           sizeof(float) * ((size_t)group * D * 2 + (size_t)group * PS + 2 * (size_t)group);
  }
};

// SIMT body. grid (n_split, hkv, b), cluster (n_split, 1, 1); blockDim.x a
// multiple of 32 holding at least group * LPH threads
template <typename T, int D>
__global__ void decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                                        const T* __restrict__ vc,
                                        const int* __restrict__ kv_len, T* __restrict__ o,
                                        float* __restrict__ m_out, float* __restrict__ l_out,
                                        int hq, int hkv, int s_max, int chunk, float scale) {
  using C = Tile<T, D>;
  extern __shared__ __align__(16) uint8_t smem[];
  T* sk = reinterpret_cast<T*>(smem);                        // [NS][BK][D], swizzled
  T* sv = sk + C::NS * C::BK * D;                            // [NS][BK][D]
  float* qf = reinterpret_cast<float*>(sv + C::NS * C::BK * D);  // [group][D]
  const int group = hq / hkv;
  float* pacc = qf + group * D;                              // [group][D]
  float* ss = pacc + group * D;                              // [group][PS]
  float* pm = ss + group * C::PS;                            // [group]
  float* pl = pm + group;                                    // [group]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int g = tid / C::LPH;
  const int lane = tid % C::LPH;

  const int len = max(0, min(kv_len[b], s_max));
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const int n_t = s1 > s0 ? (s1 - s0 + C::BK - 1) / C::BK : 0;
  const T* kb = kc + ((long long)b * hkv + hk) * s_max * D;
  const T* vb = vc + ((long long)b * hkv + hk) * s_max * D;

  auto issue = [&](int j) {
    const int t0 = s0 + j * C::BK;
    T* dk = sk + (j % C::NS) * C::BK * D;
    T* dv = sv + (j % C::NS) * C::BK * D;
    for (int idx = tid; idx < C::BK * C::CPR; idx += blockDim.x) {
      const int r = idx / C::CPR;
      const int c = idx % C::CPR;
      const bool valid = t0 + r < s1;
      const long long src = valid ? (long long)(t0 + r) * D + c * C::VE : 0;
      cp_async16(dk + (r * C::CPR + C::swz(r, c)) * C::VE, kb + src, valid);
      cp_async16(dv + (r * C::CPR + c) * C::VE, vb + src, valid);
    }
  };
#pragma unroll 1
  for (int j = 0; j < C::NS; ++j) {
    if (j < n_t) issue(j);
    cp_async_commit();   // one group per ring slot, empty past the split
  }
  for (int idx = tid; idx < group * D / 4; idx += blockDim.x) {
    const int gg = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    *reinterpret_cast<float4*>(&qf[gg * D + c]) =
        load4(q + ((long long)b * hq + hk * group + gg) * D + c);
  }

  float acc[C::NCH][4] = {};
  float m = kNeg;
  float l = 0.f;
  for (int j = 0; j < n_t; ++j) {
    cp_async_wait<C::NS - 1>();   // tile j has landed (this thread's copies)
    __syncthreads();              // ... and everyone's; qf is written
    const int t0 = s0 + j * C::BK;
    const int nk = min(C::BK, s1 - t0);
    const T* tk = sk + (j % C::NS) * C::BK * D;
    const T* tv = sv + (j % C::NS) * C::BK * D;

    // scores: one thread a key, every q head per read of its K row
    for (int key = tid; key < C::BK; key += blockDim.x) {
      for (int g0 = 0; g0 < group; g0 += kHeadBatch) {
        float dot[kHeadBatch];
#pragma unroll
        for (int hh = 0; hh < kHeadBatch; ++hh) dot[hh] = 0.f;
#pragma unroll
        for (int c = 0; c < C::CPR; ++c) {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(tk + (key * C::CPR + C::swz(key, c)) * C::VE);
          float x[C::VE];
          to_f32(raw, x);
#pragma unroll
          for (int hh = 0; hh < kHeadBatch; ++hh) {
            if (g0 + hh < group) {
              const float* qq = qf + (g0 + hh) * D + c * C::VE;
#pragma unroll
              for (int e = 0; e < C::VE; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qq + e);
                dot[hh] = fmaf(q4.x, x[e], dot[hh]);
                dot[hh] = fmaf(q4.y, x[e + 1], dot[hh]);
                dot[hh] = fmaf(q4.z, x[e + 2], dot[hh]);
                dot[hh] = fmaf(q4.w, x[e + 3], dot[hh]);
              }
            }
          }
        }
#pragma unroll
        for (int hh = 0; hh < kHeadBatch; ++hh)
          if (g0 + hh < group) ss[(g0 + hh) * C::PS + key] = key < nk ? dot[hh] * scale : kNeg;
      }
    }
    __syncthreads();

    // softmax of the head's row of scores, then P V for the thread's dims
    // (a thread past the group's heads takes the last head's row and drops
    // its result, so every lane of a warp runs the shuffles)
    const int gr = min(g, group - 1);
    float tmax = kNeg;
    for (int key = lane; key < nk; key += C::LPH) tmax = fmaxf(tmax, ss[gr * C::PS + key]);
#pragma unroll
    for (int x = C::LPH / 2; x > 0; x >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, x));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    for (int key = lane; key < nk; key += C::LPH) {
      const float p = expf(ss[gr * C::PS + key] - m_new);
      psum += p;
      if (g < group) ss[gr * C::PS + key] = p;
    }
#pragma unroll
    for (int x = C::LPH / 2; x > 0; x >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, x);
    __syncwarp();   // the head's probabilities are visible to its lanes
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[c][i] *= corr;
    }
    for (int key = 0; key < nk; ++key) {
      const float p = ss[gr * C::PS + key];
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        const int d0 = (lane + c * C::LPH) * 4;
        if (d0 < D) {
          const float4 vv = load4(tv + key * D + d0);
          acc[c][0] = fmaf(p, vv.x, acc[c][0]);
          acc[c][1] = fmaf(p, vv.y, acc[c][1]);
          acc[c][2] = fmaf(p, vv.z, acc[c][2]);
          acc[c][3] = fmaf(p, vv.w, acc[c][3]);
        }
      }
    }
    __syncthreads();   // slot j % NS and the scores are free again
    if (j + C::NS < n_t) issue(j + C::NS);
    cp_async_commit();
  }
  cp_async_wait<0>();

  if (g < group) {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      const int d0 = (lane + c * C::LPH) * 4;
      if (d0 < D)
        *reinterpret_cast<float4*>(&pacc[g * D + d0]) =
            make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
    }
    if (lane == 0) {
      pm[g] = m;
      pl[g] = l;
    }
  }
  cluster.sync();   // every split's partial is in its shared memory

  if (split == 0 && g < group) {
    float big = kNeg;
    for (int i = 0; i < n_split; ++i) big = fmaxf(big, cluster.map_shared_rank(pm, i)[g]);
    float total = 0.f;
    float num[C::NCH][4] = {};
    for (int i = 0; i < n_split; ++i) {
      const float w = expf(cluster.map_shared_rank(pm, i)[g] - big);
      total += cluster.map_shared_rank(pl, i)[g] * w;
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        const int d0 = (lane + c * C::LPH) * 4;
        if (d0 < D) {
          const float4 a =
              *reinterpret_cast<const float4*>(cluster.map_shared_rank(pacc, i) + g * D + d0);
          num[c][0] += a.x * w;
          num[c][1] += a.y * w;
          num[c][2] += a.z * w;
          num[c][3] += a.w * w;
        }
      }
    }
    const float denom = total > 0.f ? total : 1.f;
    const long long row = (long long)b * hq + hk * group + g;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      const int d0 = (lane + c * C::LPH) * 4;
      if (d0 < D) {
#pragma unroll
        for (int i = 0; i < 4; ++i) store1(o + row * D + d0 + i, num[c][i] / denom);
      }
    }
    if (lane == 0) {
      m_out[row] = big;
      l_out[row] = total;
    }
  }
  cluster.sync();   // no CTA leaves while split 0 may still read its partial
}


// ---------------------------------------------------------------------------
// tensor-core body (bf16, group <= 16)
// ---------------------------------------------------------------------------
constexpr int kMmaWarps = 4;
constexpr int kWarpRingBytes = 12 * 1024;  // each warp's own K/V ring

template <int D>
struct MmaTile {
  // a cache row in shared memory: D padded to whole 64-value rows from 64
  // on (120 -> 128, 224 -> 256), so the XOR swizzle stays inside the row;
  // the k16 steps of Q K^T and the n16 steps of P V cover DK = D padded to
  // 16 (120 -> 128: the chunk past D is zero-filled by the copy and q's
  // columns there are zero; 224 -> 224)
  static constexpr int DS = D < 64 ? D : (D + 63) / 64 * 64;
  static constexpr int DK = (D + 15) / 16 * 16;
  static constexpr int CPR = DS / 8;         // 16-byte chunks of a row in shared memory
  static constexpr int LC = DK / 8;          // of them copied (or zero-filled) a row
  static constexpr int STAGE = 16 * DS;      // bf16 values of one 16-row K (or V) chunk
  static constexpr int NS0 = kWarpRingBytes / (2 * STAGE * 2);
  static constexpr int NS = NS0 < 2 ? 2 : (NS0 > 8 ? 8 : NS0);  // ring depth per warp
  static __device__ __forceinline__ int swz(int r, int c) {
    return CPR >= 8 ? c ^ (r & 7) : c ^ ((r / (8 / CPR)) & (CPR - 1));
  }
  static size_t smem_bytes(int group) {
    return (size_t)kMmaWarps * NS * 2 * STAGE * 2 +
           sizeof(float) * ((size_t)(kMmaWarps + 1) * group * D + (size_t)(kMmaWarps + 1) * 2 * group);
  }
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a) : "memory");
}
// d[4] += A[16 x 16] . B[16 x 8], bf16 operands, f32 accumulators
__device__ __forceinline__ void mma16816(float* d, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// grid (n_split, hkv, b), cluster (n_split, 1, 1), 128 threads. The group's
// q heads are the 16 rows of mma.m16n8k16's A (rows past the group are 0);
// each warp owns every 4th 16-key chunk of the split, with its own cp.async
// ring, online softmax and accumulator fragment, so no barrier is needed
// between warps until the end.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ kc,
                            const __nv_bfloat16* __restrict__ vc,
                            const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ o,
                            float* __restrict__ m_out, float* __restrict__ l_out, int hq,
                            int hkv, int s_max, int chunk, float scale) {
  using C = MmaTile<D>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int group = hq / hkv;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [warp][NS][K|V][16][D]
  float* wacc = reinterpret_cast<float*>(ring + kMmaWarps * C::NS * 2 * C::STAGE);  // [warp][group][D]
  float* cacc = wacc + kMmaWarps * group * D;   // [group][D], this split's partial
  float* wm = cacc + group * D;                 // [warp][group]
  float* wl = wm + kMmaWarps * group;           // [warp][group]
  float* cm = wl + kMmaWarps * group;           // [group]
  float* cl = cm + group;                       // [group]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane >> 2;   // fragment row (q head) gq and gq + 8
  const int tq = lane & 3;

  const int len = max(0, min(kv_len[b], s_max));
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);
  const int nc = s1 > s0 ? (s1 - s0 + 15) / 16 : 0;         // 16-key chunks in the split
  const int n_w = nc > warp ? (nc - warp + kMmaWarps - 1) / kMmaWarps : 0;
  const __nv_bfloat16* kb = kc + ((long long)b * hkv + hk) * s_max * D;
  const __nv_bfloat16* vb = vc + ((long long)b * hkv + hk) * s_max * D;
  __nv_bfloat16* wring = ring + warp * C::NS * 2 * C::STAGE;

  auto issue = [&](int j) {
    const int t0 = s0 + 16 * (warp + kMmaWarps * j);
    __nv_bfloat16* dk = wring + (j % C::NS) * 2 * C::STAGE;
    __nv_bfloat16* dv = dk + C::STAGE;
#pragma unroll
    for (int idx = lane; idx < 16 * C::LC; idx += 32) {
      const int r = idx / C::LC;
      const int c = idx % C::LC;
      const bool valid = t0 + r < s1 && c < D / 8;
      const long long src = valid ? (long long)(t0 + r) * D + c * 8 : 0;
      const int off = (r * C::CPR + C::swz(r, c)) * 8;
      cp_async16(dk + off, kb + src, valid);
      cp_async16(dv + off, vb + src, valid);
    }
  };
#pragma unroll 1
  for (int j = 0; j < C::NS; ++j) {
    if (j < n_w) issue(j);
    cp_async_commit();
  }

  // q as mma A fragments, rows past the group and columns past D zero
  uint32_t qa[C::DK / 16][4];
  const __nv_bfloat16* qb = q + ((long long)b * hq + hk * group) * D;
#pragma unroll
  for (int kk = 0; kk < C::DK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = gq + (i & 1) * 8;
      const int col = 16 * kk + (i >> 1) * 8 + 2 * tq;
      qa[kk][i] = row < group && col < D
                      ? *reinterpret_cast<const uint32_t*>(qb + row * D + col) : 0u;
    }
  }

  float acc[C::DK / 2];
#pragma unroll
  for (int i = 0; i < C::DK / 2; ++i) acc[i] = 0.f;
  float m0 = kNeg, m1 = kNeg, l0 = 0.f, l1 = 0.f;
  for (int j = 0; j < n_w; ++j) {
    cp_async_wait<C::NS - 1>();
    __syncwarp();
    const int t0 = s0 + 16 * (warp + kMmaWarps * j);
    const __nv_bfloat16* tk = wring + (j % C::NS) * 2 * C::STAGE;
    const __nv_bfloat16* tv = tk + C::STAGE;

    // S = Q K^T over 16 keys; s[4 nb + e] is head gq + 8 (e >> 1), key
    // t0 + 8 nb + 2 tq + (e & 1)
    float s[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < C::DK / 16; ++kk) {
      const int key = (lane & 7) + ((lane >> 4) << 3);
      const int c = 2 * kk + ((lane >> 3) & 1);
      uint32_t kf[4];
      ldmatrix_x4(kf, tk + (key * C::CPR + C::swz(key, c)) * 8);
      mma16816(s, qa[kk], kf[0], kf[1]);
      mma16816(s + 4, qa[kk], kf[2], kf[3]);
    }
    float mx0 = kNeg, mx1 = kNeg;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int key = t0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      s[i] = key < s1 ? s[i] * scale : kNeg;
      if (i & 2) mx1 = fmaxf(mx1, s[i]); else mx0 = fmaxf(mx0, s[i]);
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = expf(m0 - mn0);
    const float corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = s[i] == kNeg ? 0.f : expf(s[i] - ((i & 2) ? mn1 : mn0));
      s[i] = p;
      if (i & 2) ps1 += p; else ps0 += p;
    }
    l0 = l0 * corr0 + ps0;   // this lane's share; the quad sums at the end
    l1 = l1 * corr1 + ps1;
#pragma unroll
    for (int nb = 0; nb < C::DK / 8; ++nb) {
      acc[4 * nb] *= corr0;
      acc[4 * nb + 1] *= corr0;
      acc[4 * nb + 2] *= corr1;
      acc[4 * nb + 3] *= corr1;
    }

    // O += P V: P (bf16) as A, V through ldmatrix.trans as B
    const uint32_t pa[4] = {pack_bf16(s[0], s[1]), pack_bf16(s[2], s[3]),
                            pack_bf16(s[4], s[5]), pack_bf16(s[6], s[7])};
#pragma unroll
    for (int np = 0; np < C::DK / 16; ++np) {
      const int mat = lane >> 3;
      const int key = (lane & 7) + 8 * (mat & 1);
      const int c = 2 * np + (mat >> 1);
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, tv + (key * C::CPR + C::swz(key, c)) * 8);
      mma16816(acc + 8 * np, pa, vf[0], vf[1]);
      mma16816(acc + 8 * np + 4, pa, vf[2], vf[3]);
    }
    __syncwarp();   // the slot is consumed
    if (j + C::NS < n_w) issue(j + C::NS);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, x);
    l1 += __shfl_xor_sync(0xffffffffu, l1, x);
  }
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {     // the D real columns
    const int col = 8 * nb + 2 * tq;
    if (gq < group) {
      wacc[(warp * group + gq) * D + col] = acc[4 * nb];
      wacc[(warp * group + gq) * D + col + 1] = acc[4 * nb + 1];
    }
    if (gq + 8 < group) {
      wacc[(warp * group + gq + 8) * D + col] = acc[4 * nb + 2];
      wacc[(warp * group + gq + 8) * D + col + 1] = acc[4 * nb + 3];
    }
  }
  if (tq == 0) {
    if (gq < group) {
      wm[warp * group + gq] = m0;
      wl[warp * group + gq] = l0;
    }
    if (gq + 8 < group) {
      wm[warp * group + gq + 8] = m1;
      wl[warp * group + gq + 8] = l1;
    }
  }
  __syncthreads();

  // this split's partial: the warps' partials combined in warp order
  for (int idx = threadIdx.x; idx < group * D / 4; idx += blockDim.x) {
    const int g = idx / (D / 4);
    const int d0 = (idx % (D / 4)) * 4;
    float big = kNeg;
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) big = fmaxf(big, wm[w * group + g]);
    float total = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kMmaWarps; ++w) {
      const float e = expf(wm[w * group + g] - big);
      total += wl[w * group + g] * e;
      const float4 a = *reinterpret_cast<const float4*>(&wacc[(w * group + g) * D + d0]);
      num.x += a.x * e;
      num.y += a.y * e;
      num.z += a.z * e;
      num.w += a.w * e;
    }
    *reinterpret_cast<float4*>(&cacc[g * D + d0]) = num;
    if (d0 == 0) {
      cm[g] = big;
      cl[g] = total;
    }
  }
  cluster.sync();   // every split's partial is in its shared memory

  if (split == 0) {
    for (int idx = threadIdx.x; idx < group * D / 4; idx += blockDim.x) {
      const int g = idx / (D / 4);
      const int d0 = (idx % (D / 4)) * 4;
      float big = kNeg;
      for (int i = 0; i < n_split; ++i) big = fmaxf(big, cluster.map_shared_rank(cm, i)[g]);
      float total = 0.f;
      float num[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < n_split; ++i) {
        const float e = expf(cluster.map_shared_rank(cm, i)[g] - big);
        total += cluster.map_shared_rank(cl, i)[g] * e;
        const float4 a =
            *reinterpret_cast<const float4*>(cluster.map_shared_rank(cacc, i) + g * D + d0);
        num[0] += a.x * e;
        num[1] += a.y * e;
        num[2] += a.z * e;
        num[3] += a.w * e;
      }
      const float denom = total > 0.f ? total : 1.f;
      const long long row = (long long)b * hq + hk * group + g;
      *reinterpret_cast<__nv_bfloat162*>(o + row * D + d0) =
          __floats2bfloat162_rn(num[0] / denom, num[1] / denom);
      *reinterpret_cast<__nv_bfloat162*>(o + row * D + d0 + 2) =
          __floats2bfloat162_rn(num[2] / denom, num[3] / denom);
      if (d0 == 0) {
        m_out[row] = big;
        l_out[row] = total;
      }
    }
  }
  cluster.sync();   // no CTA leaves while split 0 may still read its partial
}

// one clustered launch of ``kernel``: grid (n_split, hkv, b), cluster (n_split, 1, 1)
template <typename K, typename... Args>
cudaError_t launch_cluster(K kernel, int n_split, int hkv, int b, int threads, size_t smem,
                           cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_split, (unsigned)hkv, (unsigned)b);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc, const int* kv_len, void* o,
                   float* m, float* l, int b, int hq, int hkv, int s_max, int n_split,
                   int chunk, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  if (n_split < 1 || n_split > kMaxSplits) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    if (group <= 16)
      return launch_cluster(decode_attention_mma_kernel<D>, n_split, hkv, b, kMmaWarps * 32,
                            MmaTile<D>::smem_bytes(group), stream, (const T*)q, (const T*)kc,
                            (const T*)vc, kv_len, (T*)o, m, l, hq, hkv, s_max, chunk, scale);
  }
  using C = Tile<T, D>;
  const int threads = ((group * C::LPH + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  return launch_cluster(decode_attention_kernel<T, D>, n_split, hkv, b, threads,
                        C::smem_bytes(group), stream, (const T*)q, (const T*)kc,
                        (const T*)vc, kv_len, (T*)o, m, l, hq, hkv, s_max, chunk, scale);
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* kc, const void* vc, const int* kv_len,
                         void* o, float* m, float* l, int b, int hq, int hkv, int s_max,
                         int d, int n_split, int chunk, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, kc, vc, kv_len, o, m, l, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 32: return launch<T, 32>(q, kc, vc, kv_len, o, m, l, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, kv_len, o, m, l, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 120: return launch<T, 120>(q, kc, vc, kv_len, o, m, l, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, kv_len, o, m, l, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 224: return launch<T, 224>(q, kc, vc, kv_len, o, m, l, b, hq, hkv, s_max, n_split, chunk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and o alike). o is [B, Hq, d],
// m and l are [B, Hq] f32. The caller guarantees b, hq, s_max >= 1,
// hq % hkv == 0, 1 <= n_split <= 8, n_split * chunk >= s_max, contiguous
// tensors and 16-byte-aligned base pointers.
extern "C" int decode_attention_launch(const void* q, const void* kc, const void* vc,
                                       const void* kv_len, void* o, void* m, void* l, int b,
                                       int hq, int hkv, int s_max, int d, int n_split,
                                       int chunk, float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* lens = (const int*)kv_len;
  cudaError_t err;
  if (dtype == 0)
    err = launch_dtype<float>(q, kc, vc, lens, o, (float*)m, (float*)l, b, hq, hkv, s_max, d,
                              n_split, chunk, scale, s);
  else if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(q, kc, vc, lens, o, (float*)m, (float*)l, b, hq, hkv,
                                      s_max, d, n_split, chunk, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
