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
// head) is far below the roof.
//
// Design: one CTA per (cache split, KV head, batch) computes the partial
// softmax of all `group` q heads over its split; a second, deterministic
// pass combines the splits. The split lifts the CTA count above the SM
// count: at the serving shape one CTA per (b, KV head) would be 32 CTAs on
// 132 SMs; the wrapper picks the split count from the SM count (9 splits of
// 128 positions there, 288 CTAs). In a CTA, each q head owns d/4 threads,
// each owning 4 output dims in registers. A tile of cache rows is staged in
// shared memory as f32 (bf16 converted on load, rows past the valid end
// zero-filled, so garbage past kv_len never meets a 0 probability); the
// head's threads each take whole rows for the scores (K rows padded by 4
// floats, so neighbouring rows fall on other banks), reduce the tile max and
// sum with warp shuffles, publish the probabilities in shared memory, and
// then sweep the tile for their 4 dims of p.v. The loop stops at kv_len[b]:
// a split past it does no work and reports m = -1e30, l = 0. The combine
// pass takes M = max_i m_i, L = sum_i l_i e^(m_i - M) and
// o = sum_i acc_i e^(m_i - M) / L over the splits in order, so m and l are
// the whole-cache values. Deterministic: no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kLoadSlots = 8;  // 4-element chunks of K and V a thread loads at once

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Tile {
  static constexpr int TPH = D / 4;             // threads per q head
  static constexpr int BK = D <= 64 ? 64 : 32;  // cache rows per tile
  static constexpr int KPT = BK / TPH;          // rows per thread (scores)
  static constexpr int KS = D + 4;              // padded K row stride
  static constexpr int PS = BK + 1;             // padded probability row stride
  static size_t smem_bytes(int heads) {
    return sizeof(float) * ((size_t)BK * KS + (size_t)BK * D + (size_t)heads * D +
                            (size_t)heads * PS);
  }
};

// Partial softmax of the group's q heads over positions
// [split * chunk, min((split + 1) * chunk, kv_len[b])). blockDim.x is a
// multiple of 32 holding at least group * TPH threads; the extra threads
// form zero q heads whose results are dropped.
template <typename T, int D>
__global__ void decode_partial_kernel(const T* __restrict__ q,
                                      const T* __restrict__ kc,
                                      const T* __restrict__ vc,
                                      const int* __restrict__ kv_len,
                                      float* __restrict__ acc_out,
                                      float* __restrict__ m_out,
                                      float* __restrict__ l_out, int hq,
                                      int hkv, int s_max, int n_split,
                                      int chunk, float scale) {
  using C = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  const int heads = blockDim.x / C::TPH;
  float* sk = smem;                     // [BK][KS]
  float* sv = sk + C::BK * C::KS;       // [BK][D]
  float* sq = sv + C::BK * D;           // [heads][D]
  float* sp = sq + heads * D;           // [heads][PS]

  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = hq / hkv;
  const int tid = threadIdx.x;
  const int g = tid / C::TPH;
  const int lane = tid % C::TPH;
  const int d0 = lane * 4;

  const int len = max(0, min(kv_len[b], s_max));
  const int s0 = split * chunk;
  const int s1 = min(s0 + chunk, len);

  for (int idx = tid; idx < heads * D / 4; idx += blockDim.x) {
    const int gg = idx / (D / 4);
    const int c = (idx % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gg < group) x = load4(q + ((long long)b * hq + hk * group + gg) * D + c);
    *reinterpret_cast<float4*>(&sq[gg * D + c]) = x;
  }
  const T* kb = kc + ((long long)b * hkv + hk) * s_max * D;
  const T* vb = vc + ((long long)b * hkv + hk) * s_max * D;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float m = kNeg;
  float l = 0.f;
  for (int t0 = s0; t0 < s1; t0 += C::BK) {
    __syncthreads();  // the previous tile is consumed (and sq is written)
    // all of a thread's loads are issued before any is stored, so they are
    // in flight together (the kernel is latency-bound at serving sizes)
    for (int base = 0; base < C::BK * D / 4; base += kLoadSlots * blockDim.x) {
      float4 kk[kLoadSlots];
      float4 vv[kLoadSlots];
#pragma unroll
      for (int u = 0; u < kLoadSlots; ++u) {
        const int idx = base + u * blockDim.x + tid;
        const int r = idx / (D / 4);
        const int c = (idx % (D / 4)) * 4;
        kk[u] = vv[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (idx < C::BK * D / 4 && t0 + r < s1) {
          kk[u] = load4(kb + (long long)(t0 + r) * D + c);
          vv[u] = load4(vb + (long long)(t0 + r) * D + c);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadSlots; ++u) {
        const int idx = base + u * blockDim.x + tid;
        if (idx < C::BK * D / 4) {
          const int r = idx / (D / 4);
          const int c = (idx % (D / 4)) * 4;
          *reinterpret_cast<float4*>(&sk[r * C::KS + c]) = kk[u];
          *reinterpret_cast<float4*>(&sv[r * D + c]) = vv[u];
        }
      }
    }
    __syncthreads();

    float s[C::KPT];
    float tmax = kNeg;
#pragma unroll
    for (int j = 0; j < C::KPT; ++j) {
      const int key = lane + j * C::TPH;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(&sq[g * D + d]);
        const float4 kk = *reinterpret_cast<const float4*>(&sk[key * C::KS + d]);
        dot = fmaf(qq.x, kk.x, dot);
        dot = fmaf(qq.y, kk.y, dot);
        dot = fmaf(qq.z, kk.z, dot);
        dot = fmaf(qq.w, kk.w, dot);
      }
      s[j] = t0 + key < s1 ? dot * scale : kNeg;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int o = C::TPH / 2; o > 0; o >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < C::KPT; ++j) {
      const int key = lane + j * C::TPH;
      const float p = t0 + key < s1 ? expf(s[j] - m_new) : 0.f;
      sp[g * C::PS + key] = p;
      psum += p;
    }
#pragma unroll
    for (int o = C::TPH / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l = l * corr + psum;
    __syncwarp();  // the head's probabilities are visible to its lanes

#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] *= corr;
    const int nk = min(C::BK, s1 - t0);
    for (int key = 0; key < nk; ++key) {
      const float p = sp[g * C::PS + key];
      const float4 vv = *reinterpret_cast<const float4*>(&sv[key * D + d0]);
      acc[0] = fmaf(p, vv.x, acc[0]);
      acc[1] = fmaf(p, vv.y, acc[1]);
      acc[2] = fmaf(p, vv.z, acc[2]);
      acc[3] = fmaf(p, vv.w, acc[3]);
    }
    m = m_new;
  }

  if (g < group) {
    const long long slot = ((long long)b * hq + hk * group + g) * n_split + split;
    *reinterpret_cast<float4*>(&acc_out[slot * D + d0]) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    if (lane == 0) {
      m_out[slot] = m;
      l_out[slot] = l;
    }
  }
}

// One CTA per (b, q head): combine the splits in order.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ acc,
                                      const float* __restrict__ mp,
                                      const float* __restrict__ lp,
                                      T* __restrict__ o, float* __restrict__ m_out,
                                      float* __restrict__ l_out, int d,
                                      int n_split) {
  const long long row = blockIdx.x;
  const float* ms = mp + row * n_split;
  const float* ls = lp + row * n_split;
  float big = kNeg;
  for (int i = 0; i < n_split; ++i) big = fmaxf(big, ms[i]);
  float total = 0.f;
  for (int i = 0; i < n_split; ++i) total += ls[i] * expf(ms[i] - big);
  const float denom = total > 0.f ? total : 1.f;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float num = 0.f;
    for (int i = 0; i < n_split; ++i)
      num += acc[(row * n_split + i) * d + c] * expf(ms[i] - big);
    store1(o + row * d + c, num / denom);
  }
  if (threadIdx.x == 0) {
    m_out[row] = big;
    l_out[row] = total;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* kv_len, void* o, float* m, float* l, float* acc,
                   float* mp, float* lp, int b, int hq, int hkv, int s_max,
                   int n_split, int chunk, float scale, cudaStream_t stream) {
  using C = Tile<D>;
  const int group = hq / hkv;
  const int threads = ((group * C::TPH + 31) / 32) * 32;
  if (threads > 1024) return cudaErrorInvalidValue;
  const size_t smem = C::smem_bytes(threads / C::TPH);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_partial_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((unsigned)n_split, (unsigned)hkv, (unsigned)b);
  decode_partial_kernel<T, D><<<grid, threads, smem, stream>>>(
      (const T*)q, (const T*)kc, (const T*)vc, kv_len, acc, mp, lp, hq, hkv,
      s_max, n_split, chunk, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<(unsigned)(b * hq), D < 32 ? 32 : D, 0, stream>>>(
      acc, mp, lp, (T*)o, m, l, D, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* kc, const void* vc,
                         const int* kv_len, void* o, float* m, float* l,
                         float* acc, float* mp, float* lp, int b, int hq,
                         int hkv, int s_max, int d, int n_split, int chunk,
                         float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, kc, vc, kv_len, o, m, l, acc, mp, lp, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 32: return launch<T, 32>(q, kc, vc, kv_len, o, m, l, acc, mp, lp, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 64: return launch<T, 64>(q, kc, vc, kv_len, o, m, l, acc, mp, lp, b, hq, hkv, s_max, n_split, chunk, scale, s);
    case 128: return launch<T, 128>(q, kc, vc, kv_len, o, m, l, acc, mp, lp, b, hq, hkv, s_max, n_split, chunk, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, caches and o alike). acc, mp, lp are
// the caller's f32 scratch of [B, Hq, n_split, d], [B, Hq, n_split] and
// [B, Hq, n_split]; o is [B, Hq, d], m and l are [B, Hq] f32. The caller
// guarantees b, hq, s_max >= 1, hq % hkv == 0, n_split * chunk >= s_max,
// contiguous tensors and 16-byte-aligned base pointers.
extern "C" int decode_attention_launch(const void* q, const void* kc,
                                       const void* vc, const void* kv_len,
                                       void* o, void* m, void* l, void* acc,
                                       void* mp, void* lp, int b, int hq,
                                       int hkv, int s_max, int d, int n_split,
                                       int chunk, float scale, int dtype,
                                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int* lens = (const int*)kv_len;
  cudaError_t err;
  if (dtype == 0)
    err = launch_dtype<float>(q, kc, vc, lens, o, (float*)m, (float*)l, (float*)acc,
                              (float*)mp, (float*)lp, b, hq, hkv, s_max, d,
                              n_split, chunk, scale, s);
  else if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(q, kc, vc, lens, o, (float*)m, (float*)l,
                                      (float*)acc, (float*)mp, (float*)lp, b, hq,
                                      hkv, s_max, d, n_split, chunk, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
