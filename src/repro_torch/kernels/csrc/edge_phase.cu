// K1: fused dual-histogram edge phase of the Revolver superstep (sm_90a).
//
// Replaces: repro/kernels/edge_phase.py::fused_edge_phase_pallas (the TPU
// kernel builds a one-hot row indicator R per edge chunk and reduces both
// histograms as R^T @ L on the MXU).
//
// What it computes, for block b and local row r:
//   hist[b,r,l] = sum of w(e) over the row's live edges whose neighbor u has
//                 labels[u] == l                          (eqs. 10-12)
//   wacc[b,r,:] = neighbor_lambda: the finished eq.-13 histogram,
//                   wacc[lam[u]] += (actions[r] == lam[u]) ? w(e) : feas[lam[u]]
//                 self_lambda: col 0 = A = sum agree * w(e),
//                              col 1 = N = count of live disagreeing edges
//   (live = w(e) > 0; zero-weight slots are padding).
//
// Bound on the card: bytes. Per block the kernel reads each live edge's
// dst id and weight once (8 B), the label and lambda vectors (n_pad * 8 B,
// 14 MB at full WIKI: they fit the 50 MB L2) and the row pointer, and
// writes 2 * block_v * k floats. At full WIKI (7.69M live slab entries in
// block 0) that is ~92 MB, ~27.5 us at 3.35 TB/s; the arithmetic is a few
// integer compares and adds per edge, far below the compute roof. The
// per-edge label and lambda gathers are random reads served by the L2.
//
// Design: the work is split by edges, not by rows. The slabs are
// row-sorted with the padding at the tail; a span plan built once per
// layout (`slab_span_plan`, cached on the DeviceGraph) cuts each slab into
// spans of fewer than 2 * SPAN_EDGES entries and at most SPAN_ROWS rows,
// and cuts a hub row (more than SPAN_EDGES entries) into pieces of its own.
// One CTA takes one span (the span code K1 and K3 share is in
// span_plan.cuh):
//   * its warps read consecutive slab entries, 16 bytes of dst ids and 16
//     of weights at a time where the slab is 16-byte aligned (4 entries a
//     lane), so a warp's loads are whole sectors, and every lane has 4
//     independent label/lambda gathers in flight;
//   * each entry finds its row in the span's row pointer, staged in shared
//     memory with the rows' actions (a binary search for a lane's first
//     entry, a step forward for its next ones);
//   * the sums are integers (integer weights, counts and feasibility
//     flags in {0, 1}), so they are accumulated per (row, label) in int32
//     in shared memory, one shared atomicAdd an entry. Integer sums do not
//     depend on the order of the adds: the result is deterministic and
//     equals the plain scatter-add version bit for bit. No float atomics.
//     (Adding a warp's lanes that share a key first, __match_any_sync +
//     __reduce_add_sync, was 2.6-3x slower at full WIKI, whose rows are
//     short: PERF.md, tools/port_kernel_variants.py);
//   * a row span writes its rows' sums once, as f32, coalesced; a hub
//     piece writes its int32 partial sums to scratch, and a second small
//     kernel adds each hub row's pieces in piece order and writes the row.
// Every output element is written exactly once.
//
// Preconditions: 1 <= k <= 64; row_ptr describes the slab's row runs and
// the span plan was built from it (`slab_span_plan`, row_cap rows at most a
// span); weights are integers whose (row, label) sums stay below 2^31
// (eq.-(4)'s {1, 2}, or a contracted V-cycle level's sums of them; the
// layout checks this when it is built), flags are in {0, 1}; labels and lam
// are in [0, k) by the rule's invariant. The Python wrapper checks shapes,
// dtypes and k; the values are not checked here, which would cost a host
// sync.

#include <cuda_runtime.h>

#include "span_plan.cuh"

namespace {

constexpr int kThreads = 256;   // threads of a CTA (one span)

__device__ __forceinline__ void add_shared(int* s, int key, int v, bool valid) {
  if (valid) atomicAdd(s + key, v);
}

template <bool NEIGHBOR, bool VEC>
__global__ void __launch_bounds__(kThreads)
edge_phase_span_kernel(const int* __restrict__ dst, const float* __restrict__ w,
                       const int* __restrict__ row_ptr, const int* __restrict__ spans,
                       const int* __restrict__ labels, const int* __restrict__ lam,
                       const int* __restrict__ actions, const float* __restrict__ feasible,
                       float* __restrict__ hist, float* __restrict__ wacc,
                       int* __restrict__ partial, long long e_max, int block_v, int k,
                       int n_span, int row_cap) {
  using namespace span_plan;
  extern __shared__ int smem[];
  const int b = blockIdx.y;
  const Span sp = load_span(spans, b, n_span);
  const int rows = sp.rows, r0 = sp.r0;
  if (rows <= 0) return;  // a padding span (uniform over the CTA)
  const int acols = NEIGHBOR ? k : 2;
  // shared layout; `shared_bytes` in edge_phase.py sizes it the same way
  int* hs = smem;                        // [row_cap][k] hist sums
  int* as = hs + row_cap * k;            // [row_cap][acols] w_acc sums
  int* ptr_s = as + row_cap * acols;     // [row_cap + 1] row starts
  int* act_s = ptr_s + row_cap + 1;      // [row_cap] the rows' actions
  int* feas_s = act_s + row_cap;         // [k] feasibility flags

  zero_shared<kThreads>(hs, rows * k);
  zero_shared<kThreads>(as, rows * acols);
  stage_row_ptr<kThreads>(ptr_s, row_ptr + (long long)b * (block_v + 1) + r0, rows);
  for (int i = threadIdx.x; i < rows; i += kThreads)
    act_s[i] = actions[(long long)b * block_v + r0 + i];
  if (NEIGHBOR)
    for (int i = threadIdx.x; i < k; i += kThreads)
      feas_s[i] = __float2int_rn(feasible[(long long)b * k + i]);
  __syncthreads();

  constexpr int V = group_entries(VEC);
  for_each_group<kThreads, VEC>(
      dst + (long long)b * e_max, w + (long long)b * e_max, sp.e0, sp.e1, ptr_s, rows,
      [&](int ef, const int* u, const float* we, const int* row_of) {
        bool ok[V];
        int lb[V], lm[V];
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int e = ef + j;
          ok[j] = e >= sp.e0 && e < sp.e1 && we[j] > 0.f;
          lb[j] = ok[j] ? __ldg(labels + u[j]) : 0;
          lm[j] = ok[j] ? __ldg(lam + u[j]) : 0;
        }
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int row = ok[j] ? row_of[j] : 0;
          const int wi = __float2int_rn(we[j]);
          add_shared(hs, row * k + lb[j], wi, ok[j]);
          const bool agree = act_s[row] == lm[j];
          if (NEIGHBOR) {
            const int val = agree ? wi : feas_s[lm[j]];
            add_shared(as, row * k + lm[j], val, ok[j] && val != 0);
          } else {
            add_shared(as, row * 2 + (agree ? 0 : 1), agree ? wi : 1, ok[j]);
          }
        }
      });
  __syncthreads();

  if (sp.part < 0) {  // whole rows: each output element written once, as f32
    float* ho = hist + ((long long)b * block_v + r0) * k;
    float* wo = wacc + ((long long)b * block_v + r0) * k;
    for (int i = threadIdx.x; i < rows * k; i += kThreads) {
      ho[i] = (float)hs[i];
      if (NEIGHBOR) {
        wo[i] = (float)as[i];
      } else {
        const int r = i / k, l = i - r * k;
        wo[i] = l < 2 ? (float)as[r * 2 + l] : 0.f;
      }
    }
  } else {  // a hub row's piece: its int32 partial sums, added by hub_add_kernel
    int* po = partial + ((long long)b * n_span + sp.part) * 2 * k;
    for (int i = threadIdx.x; i < k; i += kThreads) {
      po[i] = hs[i];
      po[k + i] = (NEIGHBOR || i < 2) ? as[i] : 0;
    }
  }
}

template <bool NEIGHBOR, bool VEC>
cudaError_t launch_spans(const void* dst, const void* w, const void* row_ptr,
                         const void* spans, const void* labels, const void* lam,
                         const void* actions, const void* feasible, void* hist, void* wacc,
                         void* partial, int nb, long long e_max, int block_v, int k,
                         int n_span, int row_cap, int smem, cudaStream_t stream) {
  auto kernel = edge_phase_span_kernel<NEIGHBOR, VEC>;
  const cudaError_t err = span_plan::allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((unsigned)n_span, (unsigned)nb), kThreads, smem, stream>>>(
      (const int*)dst, (const float*)w, (const int*)row_ptr, (const int*)spans,
      (const int*)labels, (const int*)lam, (const int*)actions, (const float*)feasible,
      (float*)hist, (float*)wacc, (int*)partial, e_max, block_v, k, n_span, row_cap);
  return cudaGetLastError();
}

}  // namespace

extern "C" int edge_phase_launch(const void* dst, const void* w, const void* row_ptr,
                                 const void* spans, const void* hubs, const void* labels,
                                 const void* lam, const void* actions, const void* feasible,
                                 void* hist, void* wacc, void* partial, int nb,
                                 long long e_max, int block_v, int k, int neighbor,
                                 int n_span, int n_hub, int row_cap, int vec, int smem,
                                 void* stream) {
  if (nb <= 0 || block_v <= 0 || n_span <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (neighbor)
    err = vec ? launch_spans<true, true>(dst, w, row_ptr, spans, labels, lam, actions,
                                         feasible, hist, wacc, partial, nb, e_max, block_v,
                                         k, n_span, row_cap, smem, s)
              : launch_spans<true, false>(dst, w, row_ptr, spans, labels, lam, actions,
                                          feasible, hist, wacc, partial, nb, e_max, block_v,
                                          k, n_span, row_cap, smem, s);
  else
    err = vec ? launch_spans<false, true>(dst, w, row_ptr, spans, labels, lam, actions,
                                          feasible, hist, wacc, partial, nb, e_max, block_v,
                                          k, n_span, row_cap, smem, s)
              : launch_spans<false, false>(dst, w, row_ptr, spans, labels, lam, actions,
                                           feasible, hist, wacc, partial, nb, e_max,
                                           block_v, k, n_span, row_cap, smem, s);
  if (err != cudaSuccess) return (int)err;
  return (int)span_plan::launch_hub_add<2>(hubs, partial, hist, wacc, nb, block_v, k, n_span,
                                           n_hub, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
