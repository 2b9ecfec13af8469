// K2: weighted learning-automaton update, eqs. (8)/(9) (sm_90a).
//
// Replaces: repro/kernels/la_update.py::la_update_pallas (the TPU kernel
// keeps a [Bv, k] probability tile in VMEM across the k passes and streams
// a precomputed argsort pass schedule in from the wrapper).
//
// What it computes, per row of [V, k]: k passes in penalty-first order. Pass
// i is skipped when w_i = 0; otherwise it applies
//   eq. (9), r_i = 1:  p_i *= 1 - beta w_i;  p_j = p_j (1 - beta w_j) + beta w_j / (k-1)
//   eq. (8), r_i = 0:  p_i += alpha w_i (1 - p_i);  p_j *= 1 - alpha w_j
// to the whole row, then clips to [1e-12, 1] and renormalizes.
//
// Bound on the card: bytes. Each row reads p, w, r once and writes p once:
// 16 k bytes a row, ~28.7 MB for a full-WIKI block (224K rows, k=8), ~8.6 us
// at 3.35 TB/s. The arithmetic (~6 k^2 flops a row) is ~7x below the f32
// roof at k=8.
//
// Design: one thread per row; the row's p, w and r stay in registers across
// all k passes (every index is a compile-time constant after unrolling over
// KMAX), so each element is read and written exactly once. The penalty-first
// schedule needs no argsort: r is in {0, 1}, so the stable order is "the r=1
// indices ascending, then the r=0 indices ascending", which two unrolled
// sweeps give directly. Every operation is an explicit round-to-nearest
// intrinsic and the file is built with -fmad=false, so no multiply-add is
// fused and each step rounds like the plain version's separate tensor ops;
// only the final row sum may differ from the plain version's reduction
// order (compared at atol 5e-6, rtol 5e-5).

#include <cuda_runtime.h>

namespace {

template <int KMAX>
__global__ void __launch_bounds__(128)
la_update_kernel(const float* __restrict__ p_in, const float* __restrict__ w_in,
                 const float* __restrict__ r_in, float* __restrict__ out,
                 long long v, int k, float alpha, float beta, int renorm) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= v) return;
  const long long base = row * k;
  float p[KMAX];
  float w[KMAX];
  bool pen[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      p[j] = p_in[base + j];
      w[j] = w_in[base + j];
      pen[j] = r_in[base + j] > 0.f;
    } else {
      p[j] = 0.f;
      w[j] = 0.f;
      pen[j] = false;
    }
  }
  const float km1 = (float)(k - 1);

#pragma unroll
  for (int sweep = 0; sweep < 2; ++sweep) {
    const bool want_pen = sweep == 0;  // penalty passes first
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      if (i >= k || pen[i] != want_pen || !(w[i] > 0.f)) continue;
      if (want_pen) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const float bw = __fmul_rn(beta, w[j]);
          const float kept = __fmul_rn(p[j], __fsub_rn(1.f, bw));
          p[j] = (j == i) ? kept : __fadd_rn(kept, __fdiv_rn(bw, km1));
        }
      } else {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const float aw = __fmul_rn(alpha, w[j]);
          p[j] = (j == i) ? __fadd_rn(p[j], __fmul_rn(aw, __fsub_rn(1.f, p[j])))
                          : __fmul_rn(p[j], __fsub_rn(1.f, aw));
        }
      }
    }
  }

  if (renorm) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        p[j] = fminf(fmaxf(p[j], 1e-12f), 1.f);
        total = __fadd_rn(total, p[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) p[j] = __fdiv_rn(p[j], total);
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j)
    if (j < k) out[base + j] = p[j];
}

template <int KMAX>
cudaError_t launch(const void* p, const void* w, const void* r, void* out,
                   long long v, int k, float alpha, float beta, int renorm,
                   cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((v + threads - 1) / threads);
  la_update_kernel<KMAX><<<blocks, threads, 0, stream>>>(
      (const float*)p, (const float*)w, (const float*)r, (float*)out, v, k,
      alpha, beta, renorm);
  return cudaGetLastError();
}

}  // namespace

extern "C" int la_update_launch(const void* p, const void* w, const void* r,
                                void* out, long long v, int k, float alpha,
                                float beta, int renorm, void* stream) {
  if (v <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (k <= 8)
    err = launch<8>(p, w, r, out, v, k, alpha, beta, renorm, s);
  else if (k <= 16)
    err = launch<16>(p, w, r, out, v, k, alpha, beta, renorm, s);
  else if (k <= 32)
    err = launch<32>(p, w, r, out, v, k, alpha, beta, renorm, s);
  else if (k <= 64)
    err = launch<64>(p, w, r, out, v, k, alpha, beta, renorm, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
