// K6: the RWKV6 wkv recurrence (sm_90a).
//
// Replaces: repro/kernels/wkv6.py::wkv6_pallas (the TPU kernel keeps one
// (batch, head) [N, N] f32 state tile in VMEM across a sequential grid axis
// over blocks of tokens, and walks the tokens of a block in a fori_loop).
//
// What it computes, per (b, h) and token t, with the state S [N, N]
// (key dim n, value dim m):
//   y_t[m]   = sum_n r_t[n] (S[n, m] + u[n] k_t[n] v_t[m])
//   S[n, m] <- S[n, m] exp(logw_t[n]) + k_t[n] v_t[m]
// r, k, v, logw, y are [B, S, H, N] f32, u is [H, N] f32, the state [B, H, N, N]
// f32 with m fastest. The final state is written over the starting one.
//
// Bound on the card: the function needs ~5 N^2 flops per token and head
// (k v, S w + k v, r S; the u term factors as v[m] sum_n r[n] u[n] k[n],
// O(N)). At the rwkv6-3b prefill shape [8, 1024, 32, 80] that is 8.4 GFLOP,
// 0.125 ms at 67 TFLOP/s f32, under the 0.43 GB of streams and states
// (0.129 ms at 3.35 TB/s), so bytes bound it; at decode (S = 1) the 13.5 MB
// of state read and written bound it (4 us).
//
// Why a token-serial kernel is slow here: one CTA per (b, h) is 256 CTAs of
// 80 threads on 132 SMs, each thread running S dependent token steps whose
// next inputs come from device memory; the chain, not the bytes, sets the
// time (1.17 ms at prefill on an H100). So prefill (S >= L, L = kChunk,
// CHUNK in wkv6.py) runs the chunk-parallel form of the recurrence
// (repro/models/rwkv6.py::_wkv_chunked) in two launches:
//
//   1. local: one CTA per (chunk of L tokens, h, b) runs the recurrence from
//      a zero state over its chunk, kBlock tokens a step. With the block's
//      prefix and suffix decay products P_j and Q_i (no division, every
//      factor <= 1), the state S entering the step gives
//        y_j = (r_j P_j) . S + sum_{i<=j} A[j,i] v_i,
//        S  <- P_B S + sum_i (k_i Q_i) v_i^T,
//      A[j,i] = sum_n r_j k_i prod_{i<l<j} w_l (i < j), A[j,j] = r_j . (u k_j),
//      so a state element takes 2B + 1 multiply-adds a step, not 3B. A
//      thread holds 4 value columns (a float4) of N/4 state rows, so each
//      shared-memory float4 of r P_j or k Q_i feeds 16 state elements; its
//      partial y is summed over the 4 row parts by shuffles. Per index n,
//      one thread forms r_eff, the decays, P_j, Q_i and the terms of A
//      (summed over n by 40 threads in a fixed order). The chunk's r, k,
//      logw and v are staged kSub tokens at a time in a two-stage
//      shared-memory ring of 16-byte cp.async copies (the next stage in
//      flight while this one is used), so shared memory does not grow with
//      L and no token waits on device memory. It writes y_loc into y, the
//      chunk's final state s_loc, its decay exp(sum logw) and r_eff = r
//      exp(exclusive cumulative logw in the chunk). The serial chain is L/B
//      steps, with S/L times as many CTAs as (b, h) pairs.
//   2. stitch: one CTA per (h, b) (all N value columns) walks the chunks in
//      order, the entering state in registers (4 columns of N/4 rows a
//      thread, 2 token groups each holding a copy): y[t] += r_eff[t] .
//      state_in, summed over the row groups by shuffles, then at each
//      chunk's end state_in <- state_in exp(sum logw) + s_loc; the final
//      state is written over state0. Every exponent is <= 0. r_eff and y_loc
//      are staged in a cp.async ring like the local pass's.
//
// The chunked form moves more bytes than the bound counts (r_eff and y
// written and read again, s_loc: ~0.5 GB at the prefill shape, L 256); the
// variants and their times are in PERF.md (tools/port_kernel_variants.py).
//
// With fewer tokens than one chunk, one launch. From kSpreadFrom tokens
// (short prompts) it spreads a (b, h) over 4x as many threads as the
// token-serial kernel (320 at N = 80), a thread holding 4 value columns of
// N/16 state rows as float4 (16-byte loads), y reduced over the 16 row
// groups by warp shuffles in a fixed butterfly order; each token's per-row
// terms staged once a CTA in shared memory, kSub tokens a barrier, the next
// kSub tokens' inputs in flight. Below kSpreadFrom (decode, S = 1) the
// token-serial kernel runs: at S = 1 its device time on an H100 (2.9-4.1 us
// with the state in L2) is at or under the 4.04 us bytes bound and every
// spread variant tried was slower; the spread kernel is 1.6-1.75x faster
// at S = 64 and 200 (PERF.md, tools/port_kernel_variants.py).
//
// All arithmetic is f32 on the CUDA cores (fused multiply-adds); every sum is
// taken in a fixed order, so two calls give the same bits. expf (not
// __expf) keeps the decays within f32 tolerance of the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 256;      // prefill chunk length L (tokens); CHUNK in wkv6.py
constexpr int kSub = 16;         // tokens a stage of the shared-memory rings holds
constexpr int kBlock = 4;        // local pass: tokens a block step (divides kSub)
constexpr int kPairs = kBlock * (kBlock + 1) / 2;   // (j, i <= j) terms of A
constexpr int kRowParts = 4;     // local pass: parts a column quad's state rows split over
constexpr int kStitchGroups = 4; // stitch: row groups a column quad's state splits over
constexpr int kStitchTokens = 2; // stitch: token groups of a CTA (each a copy of the state)
constexpr int kStitchCols = 80;  // stitch: value columns of a CTA (where N allows)
constexpr int kSpreadFrom = 8;   // S from which tokens below a chunk spread over 4 N threads
constexpr int kSpreadCtas = 1;   // spread: CTAs a (b, h)'s value columns split over
static_assert(kChunk % kSub == 0, "a chunk is whole staging sub-blocks");

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(K) : "memory");
}

// A thread of either pass holds 4 value columns (a float4) of a run of
// state rows, so each shared-memory load of r, k or the decay (a float4 of
// 4 rows) feeds 16 state elements: at one column a thread the loads, not
// the arithmetic, set the pace.

// ---- prefill, pass 1: the zero-init recurrence of every chunk ------------
// row parts a column quad's state splits over (their partial y summed by
// shuffles); fewer where a part's rows would not be whole float4s
template <int N>
__host__ __device__ constexpr int row_parts() {
  return (N / kRowParts) % 4 == 0 ? kRowParts : ((N / 2) % 4 == 0 ? 2 : 1);
}
template <int N>
__host__ __device__ constexpr int local_threads() { return (N / 4) * row_parts<N>(); }

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& x) {
  acc.x = fmaf(a, x.x, acc.x);
  acc.y = fmaf(a, x.y, acc.y);
  acc.z = fmaf(a, x.z, acc.z);
  acc.w = fmaf(a, x.w, acc.w);
}
// s <- s w + k v, element-wise over the quad
__device__ __forceinline__ void decay_add(float4& s, float w, float k, const float4& v) {
  s.x = fmaf(k, v.x, s.x * w);
  s.y = fmaf(k, v.y, s.y * w);
  s.z = fmaf(k, v.z, s.z * w);
  s.w = fmaf(k, v.w, s.w * w);
}
// the lanes of this thread's warp that exist in a CTA of ``threads``
__device__ __forceinline__ unsigned lane_mask(int threads) {
  const int lanes = min(32, threads - (int)(threadIdx.x & ~31u));
  return lanes == 32 ? 0xffffffffu : (1u << lanes) - 1u;
}
__device__ __forceinline__ float comp(const float4& x, int e) {
  return e == 0 ? x.x : (e == 1 ? x.y : (e == 2 ? x.z : x.w));
}
__device__ __forceinline__ void shfl_add4(float4& a, unsigned mask, int x) {
  a.x += __shfl_xor_sync(mask, a.x, x);
  a.y += __shfl_xor_sync(mask, a.y, x);
  a.z += __shfl_xor_sync(mask, a.z, x);
  a.w += __shfl_xor_sync(mask, a.w, x);
}

// shared memory of the local pass: the two-stage staging ring, each block
// step's total decay, and the per-index terms of A and their sums (rows of
// N + 1 floats, so the summing threads hit distinct banks)
template <int N>
__host__ __device__ constexpr int local_smem_floats() {
  return 2 * 4 * kSub * N + (kSub / kBlock) * N + (kSub / kBlock) * kPairs * (N + 1)
         + (kSub / kBlock) * kPairs;
}

template <int N>
__global__ void __launch_bounds__(local_threads<N>())
wkv6_local_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ logw,
                  const float* __restrict__ u, float* __restrict__ y,
                  float* __restrict__ s_loc, float* __restrict__ r_eff,
                  float* __restrict__ w_tot, int seq, int heads) {
  constexpr int RP = row_parts<N>();
  constexpr int NH = N / RP;                      // state rows a thread holds
  constexpr int Q = N / 4;
  constexpr int T = local_threads<N>();
  constexpr int B = kBlock;
  constexpr int NB = kSub / kBlock;               // block steps a sub-block
  constexpr int STAGE = 4 * kSub * N;             // r, k, w, v of kSub tokens
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [2][STAGE]
  float* w_blk = ring + 2 * STAGE;                // [NB][N] prod of the block's w
  float* a_n = w_blk + NB * N;                    // [NB][kPairs][N + 1] terms of A
  float* a_sum = a_n + NB * kPairs * (N + 1);     // [NB][kPairs] A
  const int tid = threadIdx.x;
  const int part = tid % RP;                      // rows [part NH, (part + 1) NH)
  const int m4 = 4 * (tid / RP);                  // value columns m4 .. m4 + 3
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x;
  const int t0 = c * kChunk;
  const int lc = min(kChunk, seq - t0);
  const int nsub = (lc + kSub - 1) / kSub;
  const long long tok = (long long)heads * N;     // token stride
  const long long row0 = ((long long)b * seq + t0) * tok + (long long)h * N;
  const unsigned mask = lane_mask(T);

  // sub-block sb's rows of r, k, logw and v: 16-byte async copies
  auto issue = [&](int sb) {
    float* st = ring + (sb & 1) * STAGE;
    const int ts = sb * kSub;
    const int ls = min(kSub, lc - ts);
    for (int i = tid; i < ls * Q; i += T) {
      const int t = i / Q, q = i - t * Q;
      const long long src = row0 + (ts + t) * tok + 4 * q;
      const int dst = t * N + 4 * q;
      cp_async16(st + dst, r + src);
      cp_async16(st + kSub * N + dst, k + src);
      cp_async16(st + 2 * kSub * N + dst, logw + src);
      cp_async16(st + 3 * kSub * N + dst, v + src);
    }
  };

  float cum[(N + T - 1) / T];   // the cumulative log-decay of indices tid, tid + T, ...
#pragma unroll
  for (int i = 0; i < (N + T - 1) / T; ++i) cum[i] = 0.f;
  float4 s[NH];
#pragma unroll
  for (int n = 0; n < NH; ++n) s[n] = make_float4(0.f, 0.f, 0.f, 0.f);
  issue(0);
  cp_async_commit();
  for (int sb = 0; sb < nsub; ++sb) {
    if (sb + 1 < nsub) issue(sb + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    float* r_s = ring + (sb & 1) * STAGE;         // r, then r P_j
    float* k_s = r_s + kSub * N;                  // k, then k Q_i
    float* w_s = k_s + kSub * N;                  // logw, then exp(logw)
    float* v_s = w_s + kSub * N;
    const int ts = sb * kSub;
    const int ls = min(kSub, lc - ts);
    // per index n: r_eff and the decays; tokens past the chunk become
    // identity tokens (r = k = v = 0, w = 1); then each block step's
    // terms of A, r P_j, k Q_i and prod w, in place
#pragma unroll
    for (int i = 0; i < (N + T - 1) / T; ++i) {
      const int n = tid + i * T;
      if (n < N) {
        for (int t = 0; t < kSub; ++t) {
          if (t < ls) {
            const float lw = w_s[t * N + n];
            r_eff[row0 + (ts + t) * tok + n] = r_s[t * N + n] * expf(cum[i]);
            w_s[t * N + n] = expf(lw);
            cum[i] += lw;
          } else {
            r_s[t * N + n] = 0.f;
            k_s[t * N + n] = 0.f;
            w_s[t * N + n] = 1.f;
            v_s[t * N + n] = 0.f;
          }
        }
        const float un = __ldg(u + h * N + n);
#pragma unroll
        for (int blk = 0; blk < NB; ++blk) {
          float rr[B], kk[B], ww[B];
#pragma unroll
          for (int j = 0; j < B; ++j) {
            const int at = (blk * B + j) * N + n;
            rr[j] = r_s[at];
            kk[j] = k_s[at];
            ww[j] = w_s[at];
          }
          float* an = a_n + blk * kPairs * (N + 1) + n;
#pragma unroll
          for (int j = 0; j < B; ++j) {
            float between = 1.f;   // prod_{i<l<j} w_l, i from j - 1 down
#pragma unroll
            for (int i2 = j - 1; i2 >= 0; --i2) {
              an[(j * (j + 1) / 2 + i2) * (N + 1)] = rr[j] * kk[i2] * between;
              between *= ww[i2];
            }
            an[(j * (j + 1) / 2 + j) * (N + 1)] = rr[j] * un * kk[j];
          }
          float pre = 1.f, suf = 1.f;
#pragma unroll
          for (int j = 0; j < B; ++j) {
            r_s[(blk * B + j) * N + n] = rr[j] * pre;
            pre *= ww[j];
            k_s[(blk * B + B - 1 - j) * N + n] = kk[B - 1 - j] * suf;
            suf *= ww[B - 1 - j];
          }
          w_blk[blk * N + n] = pre;
        }
      }
    }
    __syncthreads();
    for (int x = tid; x < NB * kPairs; x += T) {   // A, summed over n in a fixed order
      const float* an = a_n + x * (N + 1);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; n += 4) {
        a0 += an[n];
        a1 += an[n + 1];
        a2 += an[n + 2];
        a3 += an[n + 3];
      }
      a_sum[x] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
    const int nblk = (ls + B - 1) / B;
    for (int blk = 0; blk < nblk; ++blk) {
      float4 vv[B], acc[B];
#pragma unroll
      for (int j = 0; j < B; ++j) {
        vv[j] = *reinterpret_cast<const float4*>(v_s + (blk * B + j) * N + m4);
        acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      const float4* wq = reinterpret_cast<const float4*>(w_blk + blk * N + part * NH);
#pragma unroll
      for (int q = 0; q < NH / 4; ++q) {
        float4 rt[B], kt[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
          const int at = (blk * B + j) * N + part * NH + 4 * q;
          rt[j] = *reinterpret_cast<const float4*>(r_s + at);
          kt[j] = *reinterpret_cast<const float4*>(k_s + at);
        }
        const float4 wb = wq[q];
        const float wrow[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float4& se = s[4 * q + e];
#pragma unroll
          for (int j = 0; j < B; ++j) fma4(acc[j], comp(rt[j], e), se);
          se = make_float4(se.x * wrow[e], se.y * wrow[e], se.z * wrow[e], se.w * wrow[e]);
#pragma unroll
          for (int j = 0; j < B; ++j) fma4(se, comp(kt[j], e), vv[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < B; ++j) {
#pragma unroll
        for (int x = 1; x < RP; x <<= 1) shfl_add4(acc[j], mask, x);
        const int t = blk * B + j;
        if (part == 0 && t < ls) {
          float4 o = acc[j];
#pragma unroll
          for (int i = 0; i <= j; ++i) fma4(o, a_sum[blk * kPairs + j * (j + 1) / 2 + i], vv[i]);
          *reinterpret_cast<float4*>(y + row0 + (ts + t) * tok + m4) = o;
        }
      }
    }
    __syncthreads();   // this stage is refilled two sub-blocks on
  }
  const long long bhc = ((long long)b * heads + h) * nc + c;
#pragma unroll
  for (int i = 0; i < (N + T - 1) / T; ++i)
    if (tid + i * T < N) w_tot[bhc * N + tid + i * T] = expf(cum[i]);
  float* sl = s_loc + bhc * N * N + (long long)part * NH * N + m4;
#pragma unroll
  for (int n = 0; n < NH; ++n) *reinterpret_cast<float4*>(sl + (long long)n * N) = s[n];
}

// ---- prefill, pass 2: the chunks stitched in order -----------------------
// row groups a column quad's entering state splits over (their partial y
// summed by shuffles); fewer where a group's rows would not be whole float4s
template <int N>
__host__ __device__ constexpr int stitch_groups() {
  return (N / kStitchGroups) % 4 == 0 ? kStitchGroups : ((N / 2) % 4 == 0 ? 2 : 1);
}
template <int N, int MT>
__host__ __device__ constexpr int stitch_threads() {
  return (MT / 4) * stitch_groups<N>() * kStitchTokens;
}

template <int N, int MT>
__global__ void __launch_bounds__(stitch_threads<N, MT>())
wkv6_stitch_kernel(const float* __restrict__ r_eff, const float* __restrict__ s_loc,
                   const float* __restrict__ w_tot, float* __restrict__ y,
                   float* __restrict__ state, int seq, int heads) {
  constexpr int G = stitch_groups<N>();
  constexpr int NG = N / G;                      // state rows a thread holds
  constexpr int Q = N / 4, QM = MT / 4;
  constexpr int T = stitch_threads<N, MT>();
  constexpr int STAGE = kSub * N + kSub * MT;    // r_eff rows, y_loc columns
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4); // [2][STAGE]
  // thread (j, quad, g): token group j, columns 4 quad .. + 3, rows of group g
  const int g = threadIdx.x % G;
  const int quad = (threadIdx.x / G) % QM;
  const int j = threadIdx.x / (G * QM);
  const int m0 = blockIdx.x * MT;
  const int m4 = m0 + 4 * quad;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nc = (seq + kChunk - 1) / kChunk;
  constexpr int per_chunk = kChunk / kSub;
  const int nsub = (seq + kSub - 1) / kSub;
  const long long bh = (long long)b * heads + h;
  const long long tok = (long long)heads * N;
  const unsigned mask = lane_mask(T);

  // sub-block sb's r_eff rows and y_loc columns: 16-byte async copies
  auto issue = [&](int sb) {
    float* re = ring + (sb & 1) * STAGE;
    float* yl = re + kSub * N;
    const int ts = sb * kSub;
    const int ls = min(kSub, seq - ts);
    const long long row0 = ((long long)b * seq + ts) * tok + (long long)h * N;
    for (int i = threadIdx.x; i < ls * Q; i += T) {
      const int t = i / Q, q = i - t * Q;
      cp_async16(re + t * N + 4 * q, r_eff + row0 + t * tok + 4 * q);
    }
    for (int i = threadIdx.x; i < ls * QM; i += T) {
      const int t = i / QM, q = i - t * QM;
      cp_async16(yl + t * MT + 4 * q, y + row0 + t * tok + m0 + 4 * q);
    }
  };

  float* st = state + bh * N * N + (long long)g * NG * N + m4;
  float4 s[NG];
#pragma unroll
  for (int n = 0; n < NG; ++n) s[n] = *reinterpret_cast<const float4*>(st + (long long)n * N);
  issue(0);
  cp_async_commit();
  for (int sb = 0; sb < nsub; ++sb) {
    if (sb + 1 < nsub) issue(sb + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* re = ring + (sb & 1) * STAGE;
    const float* yl = re + kSub * N;
    const int ts = sb * kSub;
    const int ls = min(kSub, seq - ts);
    const long long row0 = ((long long)b * seq + ts) * tok + (long long)h * N;
    // every lane runs every step (the shuffles); a step past the sub-block's
    // end reads stale rows and stores nothing
#pragma unroll 1
    for (int it = 0; it < kSub / kStitchTokens; ++it) {
      const int t = j + it * kStitchTokens;
      const float4* q = reinterpret_cast<const float4*>(re + t * N + g * NG);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < NG / 4; ++i) {
        const float4 x = q[i];
        fma4(a, x.x, s[4 * i]);
        fma4(a, x.y, s[4 * i + 1]);
        fma4(a, x.z, s[4 * i + 2]);
        fma4(a, x.w, s[4 * i + 3]);
      }
#pragma unroll
      for (int x = 1; x < G; x <<= 1) shfl_add4(a, mask, x);
      if (g == 0 && t < ls) {
        const float4 yv = *reinterpret_cast<const float4*>(yl + t * MT + 4 * quad);
        *reinterpret_cast<float4*>(y + row0 + t * tok + m4) =
            make_float4(yv.x + a.x, yv.y + a.y, yv.z + a.z, yv.w + a.w);
      }
    }
    if ((sb + 1) % per_chunk == 0 || sb + 1 == nsub) {   // the chunk's end
      const long long bhc = bh * nc + sb / per_chunk;
      const float* wt = w_tot + bhc * N + g * NG;
      const float* sl = s_loc + (bhc * N + (long long)g * NG) * N + m4;
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        const float w = __ldg(wt + n);
        const float4 add = *reinterpret_cast<const float4*>(sl + (long long)n * N);
        s[n] = make_float4(fmaf(s[n].x, w, add.x), fmaf(s[n].y, w, add.y),
                           fmaf(s[n].z, w, add.z), fmaf(s[n].w, w, add.w));
      }
    }
    __syncthreads();   // this stage is refilled two sub-blocks on
  }
  if (j == 0) {
#pragma unroll
    for (int n = 0; n < NG; ++n) *reinterpret_cast<float4*>(st + (long long)n * N) = s[n];
  }
}

// ---- a few tokens (S < kSpreadFrom): the token-serial recurrence ----------
// One CTA per (b, h), one thread per value column m holding S[:, m] in
// registers; per token, thread n stages (r, k, u k, exp(logw)) at n as one
// float4 in a double-buffered shared stage that every thread reads as a
// broadcast (one barrier a token), the next token's inputs loaded while this
// one is computed; y summed in four partial sums over n.
template <int N>
__global__ void __launch_bounds__(N)
wkv6_serial_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, float* __restrict__ state,
                   float* __restrict__ y, int seq, int heads) {
  __shared__ float4 stage[2][N];  // (r, k, u k, w) of one token, by n
  const int m = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / heads;
  const int h = bh - b * heads;
  const long long tok = (long long)heads * N;                // token stride
  const long long base = ((long long)b * seq * heads + h) * N + m;
  const long long col = (long long)bh * N * N + m;           // S[b, h, 0, m]
  const float um = u[h * N + m];

  float s[N];
#pragma unroll
  for (int n = 0; n < N; ++n) s[n] = state[col + (long long)n * N];

  float rn = 0.f, kn = 0.f, vn = 0.f, lwn = 0.f;
  if (seq > 0) {
    rn = r[base];
    kn = k[base];
    vn = v[base];
    lwn = logw[base];
  }
  for (int t = 0; t < seq; ++t) {
    float4* st = stage[t & 1];
    st[m] = make_float4(rn, kn, um * kn, expf(lwn));
    const float vt = vn;
    __syncthreads();
    if (t + 1 < seq) {
      const long long off = base + (long long)(t + 1) * tok;
      rn = r[off];
      kn = k[off];
      vn = v[off];
      lwn = logw[off];
    }
    float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
#pragma unroll
    for (int n = 0; n < N; n += 4) {
      const float4 q0 = st[n], q1 = st[n + 1], q2 = st[n + 2], q3 = st[n + 3];
      acc0 = fmaf(q0.x, fmaf(q0.z, vt, s[n]), acc0);
      acc1 = fmaf(q1.x, fmaf(q1.z, vt, s[n + 1]), acc1);
      acc2 = fmaf(q2.x, fmaf(q2.z, vt, s[n + 2]), acc2);
      acc3 = fmaf(q3.x, fmaf(q3.z, vt, s[n + 3]), acc3);
      s[n] = fmaf(s[n], q0.w, q0.y * vt);
      s[n + 1] = fmaf(s[n + 1], q1.w, q1.y * vt);
      s[n + 2] = fmaf(s[n + 2], q2.w, q2.y * vt);
      s[n + 3] = fmaf(s[n + 3], q3.w, q3.y * vt);
    }
    y[base + (long long)t * tok] = (acc0 + acc1) + (acc2 + acc3);
  }

#pragma unroll
  for (int n = 0; n < N; ++n) state[col + (long long)n * N] = s[n];
}

// ---- kSpreadFrom <= S < kChunk: the recurrence over 4 N threads ----------
// A thread holds 4 value columns (a float4) of N / NG state rows (rows g,
// g + NG, ...), the NG row groups the low lane bits (their partial y summed
// by a butterfly of shuffles): 4 N threads a (b, h). Value columns are
// independent (y[m] and S[:, m] read column m only), so they may split over
// spread_ctas CTAs. Tokens come kSub at a time: the CTA stages each token's
// (r, k, u k, exp(logw)) by row, and v, once in shared memory (not once per
// column quad), and loads the next kSub tokens' inputs into registers while
// it computes these.
template <int N>
__host__ __device__ constexpr int spread_ctas() {
  return (N / 4) % kSpreadCtas == 0 ? kSpreadCtas : 1;
}
template <int N>
__host__ __device__ constexpr int spread_groups() { return N >= 16 ? 16 : N; }
template <int N>
__host__ __device__ constexpr int spread_threads() {
  return (N / 4 / spread_ctas<N>()) * spread_groups<N>();
}

template <int N>
__global__ void __launch_bounds__(spread_threads<N>())
wkv6_spread_kernel(const float* __restrict__ r, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ logw,
                   const float* __restrict__ u, float* __restrict__ state,
                   float* __restrict__ y, int seq, int heads) {
  constexpr int NG = spread_groups<N>();
  constexpr int NPG = N / NG;                    // state rows a thread holds
  constexpr int QC = N / 4 / spread_ctas<N>();   // value quads a CTA holds
  constexpr int T = spread_threads<N>();
  constexpr int TS = T / N;                      // tokens a staging round covers
  static_assert(T % N == 0 && kSub % TS == 0, "a thread stages one row of kSub / TS tokens");
  constexpr int PT = kSub / TS;                  // tokens a thread stages
  __shared__ float4 rkuw[kSub * N];              // (r, k, u k, exp(logw)) by token and row
  __shared__ __align__(16) float v_s[kSub * N];
  const int g = threadIdx.x % NG;
  const int m0 = 4 * (blockIdx.y * QC + threadIdx.x / NG);
  const int bh = blockIdx.x;
  const int h = bh % heads;
  const int b = bh / heads;
  const unsigned mask = lane_mask(T);
  const long long tok = (long long)heads * N;
  const long long base = (long long)b * seq * tok + (long long)h * N;
  float4* st = reinterpret_cast<float4*>(state + (long long)bh * N * N) + m0 / 4;
  auto row = [&](int i) { return g + NG * i; };

  float4 s[NPG];
#pragma unroll
  for (int i = 0; i < NPG; ++i) s[i] = st[row(i) * (N / 4)];
  // this thread stages row sn of tokens st0, st0 + TS, ...
  const int sn = threadIdx.x % N, st0 = threadIdx.x / N;
  const float un = u[h * N + sn];
  float rr[PT], kr[PT], lr[PT], vr[PT];
  auto load = [&](int ts) {
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int t = ts + st0 + j * TS;
      const long long off = base + t * tok + sn;
      const bool in = t < seq;
      rr[j] = in ? r[off] : 0.f;
      kr[j] = in ? k[off] : 0.f;
      lr[j] = in ? logw[off] : 0.f;
      vr[j] = in ? v[off] : 0.f;
    }
  };
  load(0);
  for (int ts = 0; ts < seq; ts += kSub) {
    if (ts > 0) __syncthreads();   // the previous tokens' reads are done
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int at = (st0 + j * TS) * N + sn;
      rkuw[at] = make_float4(rr[j], kr[j], un * kr[j], expf(lr[j]));
      v_s[at] = vr[j];
    }
    __syncthreads();
    if (ts + kSub < seq) load(ts + kSub);
    const int ls = min(kSub, seq - ts);
    for (int t = 0; t < ls; ++t) {
      const float4* q = rkuw + t * N;
      const float4 vc = *reinterpret_cast<const float4*>(v_s + t * N + m0);
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < NPG; ++i) {
        const float4 x = q[row(i)];
        acc.x = fmaf(x.x, fmaf(x.z, vc.x, s[i].x), acc.x);
        acc.y = fmaf(x.x, fmaf(x.z, vc.y, s[i].y), acc.y);
        acc.z = fmaf(x.x, fmaf(x.z, vc.z, s[i].z), acc.z);
        acc.w = fmaf(x.x, fmaf(x.z, vc.w, s[i].w), acc.w);
        s[i].x = fmaf(s[i].x, x.w, x.y * vc.x);
        s[i].y = fmaf(s[i].y, x.w, x.y * vc.y);
        s[i].z = fmaf(s[i].z, x.w, x.y * vc.z);
        s[i].w = fmaf(s[i].w, x.w, x.y * vc.w);
      }
      // the NG row groups' partials, one butterfly: every lane gets one sum
#pragma unroll
      for (int x = 1; x < NG; x <<= 1) shfl_add4(acc, mask, x);
      if (g == 0) *reinterpret_cast<float4*>(y + base + (ts + t) * tok + m0) = acc;
    }
  }
#pragma unroll
  for (int i = 0; i < NPG; ++i) st[row(i) * (N / 4)] = s[i];
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v, const float* logw,
                   const float* u, float* state, float* y, float* s_loc, float* r_eff,
                   float* w_tot, int b, int s, int h, cudaStream_t stream) {
  if (s < kSpreadFrom) {
    wkv6_serial_kernel<N><<<b * h, N, 0, stream>>>(r, k, v, logw, u, state, y, s, h);
    return cudaGetLastError();
  }
  if (s < kChunk) {
    wkv6_spread_kernel<N><<<dim3(b * h, spread_ctas<N>()), spread_threads<N>(), 0, stream>>>(
        r, k, v, logw, u, state, y, s, h);
    return cudaGetLastError();
  }
  const int nc = (s + kChunk - 1) / kChunk;
  const int local_smem = local_smem_floats<N>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_local_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, local_smem);
  if (err != cudaSuccess) return err;
  wkv6_local_kernel<N><<<dim3(nc, h, b), local_threads<N>(), local_smem, stream>>>(
      r, k, v, logw, u, y, s_loc, r_eff, w_tot, s, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int MT = N % kStitchCols == 0 ? kStitchCols : (N % 16 == 0 ? 16 : 8);
  const int stitch_smem = 2 * (kSub * N + kSub * MT) * (int)sizeof(float);
  wkv6_stitch_kernel<N, MT><<<dim3(N / MT, h, b), stitch_threads<N, MT>(), stitch_smem,
                              stream>>>(r_eff, s_loc, w_tot, y, state, s, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_launch(const void* r, const void* k, const void* v, const void* logw,
                           const void* u, void* state, void* y, void* s_loc, void* r_eff,
                           void* w_tot, int b, int s, int h, int n, void* stream) {
  if (b <= 0 || h <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const float *rf = (const float*)r, *kf = (const float*)k, *vf = (const float*)v;
  const float *lf = (const float*)logw, *uf = (const float*)u;
  float *sf = (float*)state, *yf = (float*)y, *lo = (float*)s_loc, *re = (float*)r_eff;
  float* wt = (float*)w_tot;
  switch (n) {
    case 8: return (int)launch<8>(rf, kf, vf, lf, uf, sf, yf, lo, re, wt, b, s, h, st);
    case 16: return (int)launch<16>(rf, kf, vf, lf, uf, sf, yf, lo, re, wt, b, s, h, st);
    case 32: return (int)launch<32>(rf, kf, vf, lf, uf, sf, yf, lo, re, wt, b, s, h, st);
    case 80: return (int)launch<80>(rf, kf, vf, lf, uf, sf, yf, lo, re, wt, b, s, h, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
