// F1: SiLU(gate) * up in bf16 with `repro`'s bf16_silu roundings (sm_90a).
//
// Replaces: no TPU kernel. It is the counterpart of the loop fusion XLA
// makes of repro/models/common.py::swiglu under bf16_silu
// (jax.nn.silu(gate) * up in the activation dtype), which rounds to bf16
// after each of neg, exp, add 1, divide, multiply by gate and multiply by
// up. The port's plain version (kernels/swiglu.py::swiglu_bf16_plain) is
// that chain as eager bf16 ops, each a pass over device memory.
//
// What it computes, per element: g, u from bf16; e = bf16(exp(-g));
// d = bf16(1 + e); s = bf16(1 / d); out = bf16(bf16(g * s) * u).
//
// Bound on the card: bytes. It reads gate and up once and writes out once,
// 6 bytes an element: 1.107 GB at tinyllama-1.1b's prefill_32k FFN
// ([32768, 5632]), 0.33 ms at 3.35 TB/s. Its six operations an element are
// far below the card's f32 rate, but the instructions behind them (the
// exp's range reduction, the reciprocal's refinement, five conversions to
// bf16 and back) come close to the SMs' issue rate at that byte rate.
//
// Design: one pass; each thread takes 8 elements of each input as one
// 16-byte streaming load (__ldcs: nothing is read again) and writes 8 as one
// 16-byte streaming store, one such vector a thread, as many CTAs as that
// takes (a grid-stride loop past 2^31 - 1 CTAs); a scalar kernel takes a
// ragged tail or unaligned pointers. Each step is f32 with an explicit
// round-to-nearest intrinsic and a rounding to bf16 and back, IEEE expf
// and a correctly rounded reciprocal (1 / d exactly rounded, as the chain's
// bf16 divide), so the kernel rounds where the plain chain's separate bf16
// ops do (no --use_fast_math, no __expf). A correctly rounded reciprocal
// issues fewer instructions than a divide of 1 and gives the same value;
// one vector a thread keeps more loads in flight than a short grid that
// loops over the vectors.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 0x7fffffffLL;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// SiLU(g) * u before the final rounding to bf16, which the store does
__device__ __forceinline__ float silu_mul(float g, float u) {
  const float e = round_bf16(expf(-g));
  const float d = round_bf16(__fadd_rn(1.0f, e));
  const float s = round_bf16(__frcp_rn(d));
  const float gs = round_bf16(__fmul_rn(g, s));
  return __fmul_rn(gs, u);
}

__global__ void __launch_bounds__(kThreads)
swiglu_vec_kernel(const uint4* __restrict__ gate, const uint4* __restrict__ up,
                  uint4* __restrict__ out, long long n_vec) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n_vec; i += stride) {
    const uint4 gv = __ldcs(gate + i);
    const uint4 uv = __ldcs(up + i);
    const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
    const __nv_bfloat162* u2 = reinterpret_cast<const __nv_bfloat162*>(&uv);
    uint4 ov;
    __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 g = __bfloat1622float2(g2[j]);
      const float2 u = __bfloat1622float2(u2[j]);
      o2[j] = __floats2bfloat162_rn(silu_mul(g.x, u.x), silu_mul(g.y, u.y));
    }
    __stcs(out + i, ov);
  }
}

__global__ void __launch_bounds__(kThreads)
swiglu_scalar_kernel(const __nv_bfloat16* __restrict__ gate, const __nv_bfloat16* __restrict__ up,
                     __nv_bfloat16* __restrict__ out, long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    out[i] = __float2bfloat16_rn(silu_mul(__bfloat162float(gate[i]), __bfloat162float(up[i])));
}

unsigned blocks_for(long long items) {
  const long long b = (items + kThreads - 1) / kThreads;
  return (unsigned)(b < kMaxBlocks ? b : kMaxBlocks);
}

}  // namespace

extern "C" int swiglu_launch(const void* gate, const void* up, void* out, long long n,
                             void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const auto* g = (const __nv_bfloat16*)gate;
  const auto* u = (const __nv_bfloat16*)up;
  auto* o = (__nv_bfloat16*)out;
  long long done = 0;
  if ((((uintptr_t)gate | (uintptr_t)up | (uintptr_t)out) & 15) == 0) {
    const long long n_vec = n / 8;
    if (n_vec > 0)
      swiglu_vec_kernel<<<blocks_for(n_vec), kThreads, 0, s>>>(
          (const uint4*)gate, (const uint4*)up, (uint4*)out, n_vec);
    done = n_vec * 8;
  }
  if (done < n)
    swiglu_scalar_kernel<<<blocks_for(n - done), kThreads, 0, s>>>(g + done, u + done,
                                                                   o + done, n - done);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
