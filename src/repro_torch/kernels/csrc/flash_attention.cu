// K4: causal / sliding-window GQA flash attention, forward (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas (the
// TPU kernel walks a (B, Hq, Sq/bq, Skv/bk) grid with the kv-block axis
// minor and sequential, keeping the [bq, d] f32 accumulator and the running
// max m and sum l in VMEM scratch across it).
//
// What it computes, for batch b, query head h (kv head h / group) and query
// row i at position qpos = i + (Skv - Sq) (queries right-aligned to keys):
//   s_j = (q_i . k_j) / sqrt(d)  over keys j with  j < Skv,
//         and qpos >= j (causal), and qpos - j < window (sliding window);
//   o_i = sum_j softmax(s)_j v_j, in f32, stored in q's dtype.
// Masked scores are -1e30, not -inf, and masked probabilities are 0, so a
// row with no valid key gives o = 0 (l = 0), as the TPU kernel does.
//
// Bound on the card: operations. At the serving prefill shape (B 8, Hq 32,
// Hkv 4, S 1024, d 64, bf16, causal) the kernel must move ~75 MB (q, k, v,
// o once: ~23 us at 3.35 TB/s) and do ~2 B Hq S^2 d = 34 GFLOP of products
// (~35 us at the 989 TFLOP/s bf16 tensor-core peak). This kernel does its
// products in f32 on the CUDA cores (67 TFLOP/s peak, so >= 0.5 ms there):
// the tensor-core (wgmma) version is later work.
//
// Design: one CTA per (64-row q tile, q head, batch); the loop over kv
// tiles inside the CTA takes the place of the TPU's sequential minor grid
// axis. Each thread owns one query row (two threads a row at d = 128, each
// half the dims): its q slice and its f32 accumulator stay in registers,
// with the running m and l. K and V tiles are staged in shared memory as
// f32 (bf16 converted on load, rows past Skv zero-filled) and read back as
// warp-wide broadcasts. Scores are taken 16 keys at a time, so the running
// max and the accumulator are rescaled once per 16 keys. Tiles that the
// causal or window mask kills for every row of the CTA are never loaded:
// the loop runs from the window's first tile to the diagonal. Ragged Sq and
// Skv are masked in-kernel (rows past Sq compute and store nothing).
// Deterministic: no atomics, one write per output element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;  // query rows per CTA
constexpr int kChunk = 16;  // keys per online-softmax step

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

template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kRows * TPR)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int sq, int skv, int causal, int window,
                       float scale) {
  constexpr int DS = D / TPR;               // dims a thread owns
  constexpr int BK = D <= 64 ? 64 : 32;     // keys per shared-memory tile
  constexpr int NT = kRows * TPR;
  __shared__ __align__(16) float sk[BK][D];
  __shared__ __align__(16) float sv[BK][D];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + tid / TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = skv - sq;
  const int qpos = row + off;

  const T* qrow = q + (((long long)b * hq + h) * sq + min(row, sq - 1)) * D + part * DS;
  const T* kb = k + ((long long)b * hkv + hk) * skv * D;
  const T* vb = v + ((long long)b * hkv + hk) * skv * D;

  float qr[DS];
  float acc[DS];
#pragma unroll
  for (int d = 0; d < DS; d += 4) {
    const float4 x = load4(qrow + d);
    qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = kNeg;
  float l = 0.f;

  // keys any row of this tile may see: [kv_lo, kv_hi)
  const int last_qpos = min(r0 + kRows, sq) - 1 + off;
  const int kv_hi = causal ? min(skv, last_qpos + 1) : skv;
  const int kv_lo = window > 0 ? max(0, r0 + off - window + 1) : 0;

  for (int t0 = (kv_lo / BK) * BK; t0 < kv_hi; t0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * D / 4; idx += NT) {
      const int r = idx / (D / 4);
      const int c = (idx % (D / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (t0 + r < skv) {
        kk = load4(kb + (long long)(t0 + r) * D + c);
        vv = load4(vb + (long long)(t0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&sk[r][c]) = kk;
      *reinterpret_cast<float4*>(&sv[r][c]) = vv;
    }
    __syncthreads();

    const int nk = min(BK, kv_hi - t0);
    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = 0.f;
#pragma unroll
      for (int d = 0; d < DS; d += 4) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(&sk[c0 + j][part * DS + d]);
          s[j] = fmaf(qr[d], kk.x, s[j]);
          s[j] = fmaf(qr[d + 1], kk.y, s[j]);
          s[j] = fmaf(qr[d + 2], kk.z, s[j]);
          s[j] = fmaf(qr[d + 3], kk.w, s[j]);
        }
      }
      if (TPR == 2) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      }
      float mc = kNeg;
      bool ok[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kpos = t0 + c0 + j;
        ok[j] = kpos < skv && (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
        s[j] = ok[j] ? s[j] * scale : kNeg;
        mc = fmaxf(mc, s[j]);
      }
      const float m_new = fmaxf(m, mc);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = ok[j] ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < DS; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int d = 0; d < DS; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&sv[c0 + j][part * DS + d]);
          acc[d] = fmaf(s[j], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row < sq) {
    const float denom = l > 0.f ? l : 1.f;
    T* orow = o + (((long long)b * hq + h) * sq + row) * D + part * DS;
#pragma unroll
    for (int d = 0; d < DS; ++d) store1(orow + d, acc[d] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int hq, int hkv, int sq, int skv, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr int TPR = D > 64 ? 2 : 1;
  const dim3 grid((unsigned)((sq + kRows - 1) / kRows), (unsigned)hq, (unsigned)b);
  flash_attention_kernel<T, D, TPR><<<grid, kRows * TPR, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hkv, sq, skv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, void* o,
                         int b, int hq, int hkv, int sq, int skv, int d,
                         int causal, int window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); window <= 0 means
// no sliding window. The caller guarantees b, hq, sq, skv >= 1, hq % hkv == 0,
// contiguous [B, H, S, d] tensors and 16-byte-aligned base pointers.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = launch_dtype<float>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
  else if (dtype == 1)
    err = launch_dtype<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
