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
// at 3.35 TB/s. The arithmetic (~6 k^2 flops a row at most) is ~7x below
// the f32 roof at k=8.
//
// Design: one thread per row; the row's p and its per-slot factors stay in
// registers across all k passes (every index is a compile-time constant
// after unrolling over KMAX), so each element is read and written exactly
// once.
//   * Loads and stores: two float4 of each of p, w, r and out a row at k =
//     8 (k % 4 == 0 and 16-byte aligned rows), else scalar.
//   * The factors a pass applies to slot j, 1 - beta w_j, beta w_j / (k-1),
//     alpha w_j and 1 - alpha w_j, depend on the slot only: they are
//     computed once a row, from the same operands and with the same
//     roundings as the plain version's. The floor's k divisions (instead of
//     up to k^2) are taken only where a lane of the warp runs a penalty
//     pass: a self_lambda superstep gives each row one reward slot, and
//     there they cost more than the rest of the row's arithmetic.
//   * The penalty-first schedule needs no argsort: r is in {0, 1}, so the
//     stable order is "the r=1 indices ascending, then the r=0 indices
//     ascending", which two unrolled sweeps give directly.
//   * Pass control is warp-uniform: a warp skips pass i when none of its
//     lanes runs it (a vote), and otherwise every lane computes the pass and
//     keeps the result where its own row runs it (a select), so lanes no
//     longer diverge over the pass bodies. At the main path's input (a
//     self_lambda superstep gives each row one weighted slot) most passes are
//     skipped by whole warps.
// Every operation is an explicit round-to-nearest intrinsic and the file is
// built with -fmad=false, so no multiply-add is fused and each pass rounds
// like the plain version's separate tensor ops; only the final row sum (in
// slot order) may differ from the plain version's reduction order (compared
// at atol 5e-6, rtol 5e-5).

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// x[0..k) from src (0 beyond k, and everywhere when the row is not live)
template <int KMAX, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&x)[KMAX],
                                         int k, bool live) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && 4 * q < k) t = *reinterpret_cast<const float4*>(src + 4 * q);
      x[4 * q] = t.x; x[4 * q + 1] = t.y; x[4 * q + 2] = t.z; x[4 * q + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) x[j] = (live && j < k) ? src[j] : 0.f;
  }
}

template <int KMAX, bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&x)[KMAX],
                                          int k) {
  if constexpr (VEC) {
#pragma unroll
    for (int q = 0; q < KMAX / 4; ++q)
      if (4 * q < k)
        *reinterpret_cast<float4*>(dst + 4 * q) =
            make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) dst[j] = x[j];
  }
}

template <int KMAX, bool VEC>
__global__ void __launch_bounds__(kThreads)
la_update_kernel(const float* __restrict__ p_in, const float* __restrict__ w_in,
                 const float* __restrict__ r_in, float* __restrict__ out,
                 long long v, int k, float alpha, float beta, int renorm) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  // lanes past the last row run on zeros (no pass) and store nothing, so
  // every lane of a warp reaches the votes
  const bool live = row < v;
  const long long base = live ? row * k : 0;
  float p[KMAX], w[KMAX], r[KMAX];
  load_row<KMAX, VEC>(p_in + base, p, k, live);
  load_row<KMAX, VEC>(w_in + base, w, k, live);
  load_row<KMAX, VEC>(r_in + base, r, k, live);

  const float km1 = (float)(k - 1);
  float pen_keep[KMAX], pen_floor[KMAX], rew_gain[KMAX], rew_keep[KMAX];
  bool pen[KMAX], runs[KMAX];
  bool runs_pen = false;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    pen_keep[j] = __fsub_rn(1.f, __fmul_rn(beta, w[j]));
    rew_gain[j] = __fmul_rn(alpha, w[j]);
    rew_keep[j] = __fsub_rn(1.f, rew_gain[j]);
    pen[j] = r[j] > 0.f;
    runs[j] = j < k && w[j] > 0.f;
    runs_pen |= runs[j] && pen[j];
  }
  // the floor's k divisions only where a lane of the warp runs a penalty
  // pass (at a self_lambda superstep's input no row does)
  if (__any_sync(0xffffffffu, runs_pen)) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) pen_floor[j] = __fdiv_rn(__fmul_rn(beta, w[j]), km1);
  } else {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) pen_floor[j] = 0.f;
  }

#pragma unroll
  for (int sweep = 0; sweep < 2; ++sweep) {
    const bool want_pen = sweep == 0;  // penalty passes first
#pragma unroll
    for (int i = 0; i < KMAX; ++i) {
      const bool run = runs[i] && pen[i] == want_pen;
      if (!__any_sync(0xffffffffu, run)) continue;  // no lane of the warp runs pass i
      if (want_pen) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const float kept = __fmul_rn(p[j], pen_keep[j]);
          const float next = (j == i) ? kept : __fadd_rn(kept, pen_floor[j]);
          p[j] = run ? next : p[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          const float next = (j == i) ? __fadd_rn(p[j], __fmul_rn(rew_gain[j], __fsub_rn(1.f, p[j])))
                                      : __fmul_rn(p[j], rew_keep[j]);
          p[j] = run ? next : p[j];
        }
      }
    }
  }

  if (renorm) {
    float total = 0.f;
#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
      if (j < k) {
        // clamp to [1e-12, 1] as torch.clamp does: a NaN stays NaN (an
        // fmaxf would make it 1e-12 and hide a corrupt row from the guard)
        p[j] = p[j] < 1e-12f ? 1e-12f : (p[j] > 1.f ? 1.f : p[j]);
        total = __fadd_rn(total, p[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < KMAX; ++j)
      if (j < k) p[j] = __fdiv_rn(p[j], total);
  }
  if (live) store_row<KMAX, VEC>(out + base, p, k);
}

template <int KMAX>
cudaError_t launch(const void* p, const void* w, const void* r, void* out,
                   long long v, int k, float alpha, float beta, int renorm,
                   cudaStream_t stream) {
  const unsigned blocks = (unsigned)((v + kThreads - 1) / kThreads);
  // 16-byte row loads where every row starts 16-byte aligned
  const bool vec = k % 4 == 0 &&
                   (((uintptr_t)p | (uintptr_t)w | (uintptr_t)r | (uintptr_t)out) & 15) == 0;
  if (vec)
    la_update_kernel<KMAX, true><<<blocks, kThreads, 0, stream>>>(
        (const float*)p, (const float*)w, (const float*)r, (float*)out, v, k, alpha, beta,
        renorm);
  else
    la_update_kernel<KMAX, false><<<blocks, kThreads, 0, stream>>>(
        (const float*)p, (const float*)w, (const float*)r, (float*)out, v, k, alpha, beta,
        renorm);
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
