// K3: edge label histogram of the Spinner and restream rules (sm_90a).
//
// Replaces: repro/kernels/edge_histogram.py::edge_histogram_pallas (the TPU
// kernel builds a one-hot row indicator R and a one-hot slot matrix L per
// edge chunk and reduces hist += R^T @ L on the MXU).
//
// What it computes, for block b, local row r and slot l:
//   hist[b,r,l] = sum of vals[b,e] over the slab entries e of row r whose
//                 slot is slots[b,e] == l.
// For Spinner (one launch over all blocks) and restream (one launch per
// block) the slot is the neighbor's current label and the value the
// eq.-(4) weight: the tau numerator of eqs. (3) and (11).
//
// Preconditions (the Python wrapper checks shapes, dtypes and k):
//   * the slabs are row-sorted with the padding at the tail, so row r of
//     block b owns the contiguous run [row_ptr[b,r], row_ptr[b,r+1]) of
//     its slab, and padding lies outside every run (`slab_row_ptr` checks
//     this when the layout is built; the TPU kernel accepts any order);
//   * 1 <= k <= 64 (MAX_K);
//   * slots lie in [0, k): by the rules' invariant, not checked here, which
//     would cost a host sync (an out-of-range slot matches no sum and adds
//     nothing).
//
// Bound on the card: bytes. The kernel reads each live entry's slot and
// value once (8 B), the row pointer, and writes nb * block_v * k floats.
// At full WIKI (k = 8, ~61.5M live entries over 8 blocks) that is ~0.56 GB,
// ~0.17 ms at 3.35 TB/s; the arithmetic is k predicated adds per entry.
//
// Design: K1's row walk (csrc/edge_phase.cu) without its second histogram.
// One thread owns one row, walks its run in slab order and keeps the k sums
// in registers (a predicated add over the compile-time width KMAX, so no
// dynamically indexed local array spills). No atomics, no shared memory,
// one write per output element: the result is deterministic (each row is
// summed in slab order). The eq.-(4) weights are integers in {1, 2}, so there every sum is an
// integer-valued f32 below 2^24 and exact in any order.
// Known cost: a thread walking a hub row is slower than its warp's
// neighbours (power-law imbalance); a warp-per-hub split is later work.

#include <cuda_runtime.h>

namespace {

template <int KMAX>
__global__ void __launch_bounds__(128)
edge_histogram_kernel(const int* __restrict__ slots,
                      const float* __restrict__ vals,
                      const int* __restrict__ row_ptr,
                      float* __restrict__ hist, int nb, long long e_max,
                      int block_v, int k) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= (long long)nb * block_v) return;
  const int b = (int)(gid / block_v);
  const int r = (int)(gid - (long long)b * block_v);
  const int* rp = row_ptr + (long long)b * (block_v + 1);
  const int beg = rp[r];
  const int end = rp[r + 1];
  const int* s_b = slots + (long long)b * e_max;
  const float* v_b = vals + (long long)b * e_max;

  float h[KMAX];
#pragma unroll
  for (int l = 0; l < KMAX; ++l) h[l] = 0.f;

  for (int e = beg; e < end; ++e) {
    const int s = s_b[e];
    const float v = v_b[e];
#pragma unroll
    for (int l = 0; l < KMAX; ++l) h[l] += (s == l) ? v : 0.f;
  }

  float* out = hist + gid * k;
#pragma unroll
  for (int l = 0; l < KMAX; ++l) {
    if (l < k) out[l] = h[l];
  }
}

template <int KMAX>
cudaError_t launch(const void* slots, const void* vals, const void* row_ptr,
                   void* hist, int nb, long long e_max, int block_v, int k,
                   cudaStream_t stream) {
  const int threads = 128;
  const long long rows = (long long)nb * block_v;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  edge_histogram_kernel<KMAX><<<blocks, threads, 0, stream>>>(
      (const int*)slots, (const float*)vals, (const int*)row_ptr,
      (float*)hist, nb, e_max, block_v, k);
  return cudaGetLastError();
}

}  // namespace

extern "C" int edge_histogram_launch(const void* slots, const void* vals,
                                     const void* row_ptr, void* hist, int nb,
                                     long long e_max, int block_v, int k,
                                     void* stream) {
  if (nb <= 0 || block_v <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (k < 1)
    err = cudaErrorInvalidValue;
  else if (k <= 8)
    err = launch<8>(slots, vals, row_ptr, hist, nb, e_max, block_v, k, s);
  else if (k <= 16)
    err = launch<16>(slots, vals, row_ptr, hist, nb, e_max, block_v, k, s);
  else if (k <= 32)
    err = launch<32>(slots, vals, row_ptr, hist, nb, e_max, block_v, k, s);
  else if (k <= 64)
    err = launch<64>(slots, vals, row_ptr, hist, nb, e_max, block_v, k, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
