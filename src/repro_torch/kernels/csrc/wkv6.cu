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
// f32 with m fastest.
//
// Bound on the card: the function needs ~5 N^2 flops per token and head
// (k v, S w + k v, r S; the u term factors as v[m] sum_n r[n] u[n] k[n],
// O(N)). At the rwkv6-3b prefill shape [8, 1024, 32, 80] that is 8.4 GFLOP,
// 0.125 ms at 67 TFLOP/s f32, under the 0.43 GB of streams and states
// (0.129 ms at 3.35 TB/s), so bytes bound it; at decode (S = 1) the 13 MB of
// state read and written bound it (4 us).
//
// Design: one CTA per (b, h), one thread per value column m. The thread keeps
// its column S[:, m] (N floats) in registers for the whole sequence, so each
// thread reduces over n by itself: there is no inter-thread reduction, no
// atomic, and the result is deterministic. Per token, thread n stages
// (r[n], k[n], u[n] k[n], exp(logw[n])) as one float4 in shared memory,
// which every thread then reads as a broadcast; the stage is double-buffered,
// so one __syncthreads a token suffices, and the next token's four values
// are loaded into registers while this token is computed. The sequence loop
// runs to any S >= 1 (no tiling constraint). The final column is written
// over the starting one: each thread reads its own column at the start and
// writes it at the end, so the serving cache is updated without a copy. expf (not
// __expf) keeps the decay within f32 tolerance of the plain version; fused
// multiply-adds and the four partial sums of y change rounding only.

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
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

template <int N>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* logw, const void* u, void* state, void* y,
                   int b, int s, int h, cudaStream_t stream) {
  wkv6_kernel<N><<<b * h, N, 0, stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)logw,
      (const float*)u, (float*)state, (float*)y, s, h);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* logw, const void* u, void* state,
                           void* y, int b, int s, int h, int n, void* stream) {
  if (b <= 0 || h <= 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n) {
    case 8:
      return (int)launch<8>(r, k, v, logw, u, state, y, b, s, h, st);
    case 16:
      return (int)launch<16>(r, k, v, logw, u, state, y, b, s, h, st);
    case 32:
      return (int)launch<32>(r, k, v, logw, u, state, y, b, s, h, st);
    case 80:
      return (int)launch<80>(r, k, v, logw, u, state, y, b, s, h, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
