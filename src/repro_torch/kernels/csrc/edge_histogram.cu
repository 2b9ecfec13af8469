// K3: edge label histogram of the Spinner and restream rules (sm_90a).
//
// Replaces: repro/kernels/edge_histogram.py::edge_histogram_pallas (the TPU
// kernel builds a one-hot row indicator R and a one-hot slot matrix L per
// edge chunk and reduces hist += R^T @ L on the MXU).
//
// What it computes, for block b, local row r and slot l:
//   hist[b,r,l] = sum of vals[b,e] over the slab entries e of row r whose
//                 slot is l,
// the slot being slots[b,e] (the TPU kernel's signature) or, in the gather
// form, labels[dst[b,e]]. For Spinner (one launch over all blocks) and
// restream (one launch per block) the slot is the neighbor's current label
// and the value the eq.-(4) weight: the tau numerator of eqs. (3) and (11).
//
// Preconditions (the Python wrapper checks shapes, dtypes and k):
//   * the slabs are row-sorted with the padding at the tail, so row r of
//     block b owns the contiguous run [row_ptr[b,r], row_ptr[b,r+1]) of
//     its slab, and padding lies outside every run (`slab_row_ptr` checks
//     this when the layout is built; the TPU kernel accepts any order);
//   * 1 <= k <= 64 (MAX_K);
//   * slots (and labels) lie in [0, k): by the rules' invariant, not
//     checked on the host, which would cost a sync; an out-of-range slot
//     matches no sum and adds nothing;
//   * the span routes: the values are integers whose (row, slot) sums stay
//     below 2^31 (the eq.-(4) weights or a contracted V-cycle level's sums
//     of them; the layout checks this when it is built) and the span plan
//     was built from row_ptr.
//
// Bound on the card: bytes. The kernel reads each live entry's slot (or
// neighbor id) and value once (8 B), the row pointer, in the gather form
// the label vector (served by the 50 MB L2), and writes nb * block_v * k
// floats. At full WIKI (k = 8, ~61.5M live entries over 8 blocks) that is
// ~0.56 GB, ~0.17 ms at 3.35 TB/s; the arithmetic is an add an entry.
//
// Two designs, routed by the caller's statement about the values:
//
// Span routes (integer values; the rules' route). K1's design
// (edge_phase.cu), on the span code the two share (span_plan.cuh): the work
// is split by edges over the layout's span plan, one CTA a span, its warps
// reading consecutive entries 16 bytes a lane, so a warp's loads are whole
// sectors (one thread a row made each warp load touch ~32 scattered sectors
// for 128 useful bytes). Each entry finds its row in the span's row
// pointer, staged in shared memory (a binary search for a lane's first
// entry, a step forward for its next ones), and adds its value to an int32
// sum per (row, slot) in shared memory, one shared atomicAdd an entry.
// Integer sums do not depend on the order of the adds, so the result is
// deterministic and equals the plain scatter-add version bit for bit; no
// float atomics. A row span writes its rows once as f32,
// coalesced; a hub row's pieces leave int32 partial sums that a second
// kernel adds in piece order. The gather form reads labels[dst[e]] itself,
// as K1 does, instead of a slot slab a separate gather wrote first.
//
// Row walk (any f32 values; the float route). One thread owns one row,
// walks its run in slab order and keeps the k sums in registers (a
// predicated add over the compile-time width KMAX, so no dynamically
// indexed local array spills). No atomics, one write per output element,
// each row summed in slab order: deterministic. Uncoalesced (neighbouring
// lanes walk different rows) and bounded by the longest row of a warp.

#include <cuda_runtime.h>

#include "span_plan.cuh"

namespace {

constexpr int kThreads = 256;   // threads of a span CTA

// how a launch reads its slot and values
enum Route { kRowWalk = 0, kSpanSlots = 1, kSpanGather = 2 };

template <bool GATHER, bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_histogram_span_kernel(const int* __restrict__ idx, const float* __restrict__ vals,
                           const int* __restrict__ row_ptr, const int* __restrict__ spans,
                           const int* __restrict__ labels, float* __restrict__ hist,
                           int* __restrict__ partial, long long e_max, int block_v, int k,
                           int n_span, int row_cap) {
  using namespace span_plan;
  extern __shared__ int smem[];
  const int b = blockIdx.y;
  const Span sp = load_span(spans, b, n_span);
  const int rows = sp.rows;
  if (rows <= 0) return;  // a padding span (uniform over the CTA)
  // shared layout; `shared_bytes` in edge_histogram.py sizes it the same way
  int* hs = smem;                  // [row_cap][k] sums
  int* ptr_s = hs + row_cap * k;   // [row_cap + 1] row starts
  zero_shared<kThreads>(hs, rows * k);
  stage_row_ptr<kThreads>(ptr_s, row_ptr + (long long)b * (block_v + 1) + sp.r0, rows);
  __syncthreads();

  constexpr int V = group_entries(VEC);
  for_each_group<kThreads, VEC>(
      idx + (long long)b * e_max, vals + (long long)b * e_max, sp.e0, sp.e1, ptr_s, rows,
      [&](int ef, const int* id, const float* val, const int* row) {
        bool ok[V];
        int slot[V], wi[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {  // all gathers in flight before the adds
          const int e = ef + j;
          wi[j] = __float2int_rn(val[j]);
          ok[j] = e >= sp.e0 && e < sp.e1 && wi[j] != 0;
          slot[j] = ok[j] ? (GATHER ? __ldg(labels + id[j]) : id[j]) : 0;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (ok[j] && (unsigned)slot[j] < (unsigned)k)
            atomicAdd(hs + row[j] * k + slot[j], wi[j]);
        }
      });
  __syncthreads();

  if (sp.part < 0) {  // whole rows: each output element written once, as f32
    float* ho = hist + ((long long)b * block_v + sp.r0) * k;
    for (int i = threadIdx.x; i < rows * k; i += kThreads) ho[i] = (float)hs[i];
  } else {  // a hub row's piece: its int32 partial sums, added by hub_add_kernel
    int* po = partial + ((long long)b * n_span + sp.part) * k;
    for (int i = threadIdx.x; i < k; i += kThreads) po[i] = hs[i];
  }
}

template <int KMAX>
__global__ void __launch_bounds__(128)
edge_histogram_row_kernel(const int* __restrict__ slots,
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
cudaError_t launch_rows(const void* slots, const void* vals, const void* row_ptr,
                        void* hist, int nb, long long e_max, int block_v, int k,
                        cudaStream_t stream) {
  const int threads = 128;
  const long long rows = (long long)nb * block_v;
  const unsigned blocks = (unsigned)((rows + threads - 1) / threads);
  edge_histogram_row_kernel<KMAX><<<blocks, threads, 0, stream>>>(
      (const int*)slots, (const float*)vals, (const int*)row_ptr,
      (float*)hist, nb, e_max, block_v, k);
  return cudaGetLastError();
}

template <bool GATHER, bool VEC>
cudaError_t launch_spans(const void* idx, const void* vals, const void* row_ptr,
                         const void* spans, const void* labels, void* hist, void* partial,
                         int nb, long long e_max, int block_v, int k, int n_span,
                         int row_cap, int smem, cudaStream_t stream) {
  auto kernel = edge_histogram_span_kernel<GATHER, VEC>;
  const cudaError_t err = span_plan::allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)n_span, (unsigned)nb), kThreads, smem, stream>>>(
      (const int*)idx, (const float*)vals, (const int*)row_ptr, (const int*)spans,
      (const int*)labels, (float*)hist, (int*)partial, e_max, block_v, k, n_span, row_cap);
  return cudaGetLastError();
}

}  // namespace

// route kRowWalk reads slots from idx and ignores spans, hubs, labels,
// partial, n_span, n_hub, row_cap, vec and smem; kSpanSlots reads slots
// from idx; kSpanGather reads neighbor ids from idx and their labels.
extern "C" int edge_histogram_launch(const void* idx, const void* vals, const void* row_ptr,
                                     const void* spans, const void* hubs, const void* labels,
                                     void* hist, void* partial, int nb, long long e_max,
                                     int block_v, int k, int route, int n_span, int n_hub,
                                     int row_cap, int vec, int smem, void* stream) {
  if (nb <= 0 || block_v <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (route == kRowWalk) {
    if (k <= 8)
      err = launch_rows<8>(idx, vals, row_ptr, hist, nb, e_max, block_v, k, s);
    else if (k <= 16)
      err = launch_rows<16>(idx, vals, row_ptr, hist, nb, e_max, block_v, k, s);
    else if (k <= 32)
      err = launch_rows<32>(idx, vals, row_ptr, hist, nb, e_max, block_v, k, s);
    else
      err = launch_rows<64>(idx, vals, row_ptr, hist, nb, e_max, block_v, k, s);
    return (int)err;
  }
  if (route != kSpanSlots && route != kSpanGather) return (int)cudaErrorInvalidValue;
  if (n_span <= 0) return (int)cudaSuccess;
  const bool gather = route == kSpanGather;
  if (gather)
    err = vec ? launch_spans<true, true>(idx, vals, row_ptr, spans, labels, hist, partial, nb,
                                         e_max, block_v, k, n_span, row_cap, smem, s)
              : launch_spans<true, false>(idx, vals, row_ptr, spans, labels, hist, partial,
                                          nb, e_max, block_v, k, n_span, row_cap, smem, s);
  else
    err = vec ? launch_spans<false, true>(idx, vals, row_ptr, spans, labels, hist, partial,
                                          nb, e_max, block_v, k, n_span, row_cap, smem, s)
              : launch_spans<false, false>(idx, vals, row_ptr, spans, labels, hist, partial,
                                           nb, e_max, block_v, k, n_span, row_cap, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)span_plan::launch_hub_add<1>(hubs, partial, hist, nullptr, nb, block_v, k,
                                           n_span, n_hub, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
