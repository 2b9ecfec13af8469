// Device code shared by the kernels that split row-sorted slabs by a span
// plan: K1 (edge_phase.cu) and K3 (edge_histogram.cu).
//
// The plan (`slab_span_plan`, cached on the DeviceGraph as a `SpanPlan`)
// cuts each block's slab into spans of fewer than 2 * SPAN_EDGES entries
// and at most row_cap rows, and cuts a hub row (more than SPAN_EDGES
// entries) into pieces of its own. One CTA takes one span (grid
// (n_span, nb)):
//   * `load_span` reads the CTA's span; `stage_row_ptr` copies its rows'
//     starts into shared memory;
//   * `for_each_group` walks the span's entries a warp at a time, lanes on
//     consecutive entries, 4 entries (16 bytes of each slab) a lane where
//     the slabs are 16-byte aligned, and finds each entry's row: a binary
//     search in the staged row starts for a lane's first entry, a step
//     forward for each next one (consecutive entries mostly share a row;
//     a search for every entry took ~1.4x as long at full WIKI, PERF.md);
//   * a row span writes its rows once; a hub piece leaves int32 partial
//     sums in scratch at its span index, and `hub_add_kernel` adds each hub
//     row's pieces in piece order, so every output element is written once
//     and the result does not depend on the order the CTAs ran in.

#pragma once

#include <cuda_runtime.h>

namespace span_plan {

// entries a lane takes at a time where the slabs allow 16-byte loads (a
// multiple of 4)
constexpr int kVecEntries = 4;

__host__ __device__ constexpr int group_entries(bool vec) { return vec ? kVecEntries : 1; }

// entries [e0, e1) of the slab, rows [r0, r0 + rows); part >= 0 for a hub
// piece (where it leaves its partial sums), -1 for whole rows
struct Span {
  int e0, e1, r0, rows, part;
};

__device__ __forceinline__ Span load_span(const int* spans, int b, int n_span) {
  const int* sp = spans + ((long long)b * n_span + blockIdx.x) * 5;
  return {sp[0], sp[1], sp[2], sp[3] - sp[2], sp[4]};
}

// the row (index into the span's staged row pointer) whose run holds
// entry e: ptr[lo] <= e < ptr[lo + 1]
__device__ __forceinline__ int find_row(const int* ptr, int rows, int e) {
  int lo = 0, hi = rows;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (ptr[mid] <= e) lo = mid; else hi = mid;
  }
  return lo;
}

template <int THREADS>
__device__ __forceinline__ void zero_shared(int* s, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) s[i] = 0;
}

// rows + 1 row starts of the span (rp points at its first row's)
template <int THREADS>
__device__ __forceinline__ void stage_row_ptr(int* ptr_s, const int* rp, int rows) {
  for (int i = threadIdx.x; i <= rows; i += THREADS) ptr_s[i] = rp[i];
}

// Calls f(ef, idx, val, row) for each group of V = group_entries(VEC)
// consecutive entries ef .. ef + V - 1 of [e0, e1) rounded out to V, idx
// and val the int32 and f32 slabs' values there (0 past e1) and row each
// entry's row in the span's staged row starts ptr_s (rows + 1 of them).
// The entries before e0 in the first group are the caller's to mask. VEC
// needs both slabs 16-byte aligned at entry 0 and a slab length divisible
// by 4, so a 4-entry load never crosses the slab's end.
template <int THREADS, bool VEC, class F>
__device__ __forceinline__ void for_each_group(const int* __restrict__ idx_b,
                                               const float* __restrict__ val_b, int e0,
                                               int e1, const int* ptr_s, int rows, F&& f) {
  constexpr int V = group_entries(VEC);
  constexpr int kWarps = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int first = VEC ? (e0 & ~(V - 1)) : e0;
  for (int base = first + (threadIdx.x >> 5) * 32 * V; base < e1; base += kWarps * 32 * V) {
    const int ef = base + lane * V;
    int idx[V], row[V];
    float val[V];
    if constexpr (VEC) {
#pragma unroll
      for (int q = 0; q < V; q += 4) {
        int4 i4 = make_int4(0, 0, 0, 0);
        float4 v4 = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ef + q < e1) {
          i4 = *reinterpret_cast<const int4*>(idx_b + ef + q);
          v4 = *reinterpret_cast<const float4*>(val_b + ef + q);
        }
        idx[q] = i4.x; idx[q + 1] = i4.y; idx[q + 2] = i4.z; idx[q + 3] = i4.w;
        val[q] = v4.x; val[q + 1] = v4.y; val[q + 2] = v4.z; val[q + 3] = v4.w;
      }
    } else {
      idx[0] = ef < e1 ? idx_b[ef] : 0;
      val[0] = ef < e1 ? val_b[ef] : 0.f;
    }
    row[0] = find_row(ptr_s, rows, ef);
#pragma unroll
    for (int j = 1; j < V; ++j) {
      row[j] = row[j - 1];
      while (row[j] + 1 < rows && ptr_s[row[j] + 1] <= ef + j) ++row[j];
    }
    f(ef, idx, val, row);
  }
}

// one CTA per hub row: its pieces' int32 partial sums ([NOUT][k] a piece,
// at the piece's span index) added in piece order and written as f32, the
// first k columns to out0, the next k to out1
template <int NOUT>
__global__ void __launch_bounds__(128)
hub_add_kernel(const int* __restrict__ hubs, const int* __restrict__ partial,
               float* __restrict__ out0, float* __restrict__ out1, int block_v, int k,
               int n_span, int n_hub) {
  const int b = blockIdx.y;
  const int* hp = hubs + ((long long)b * n_hub + blockIdx.x) * 3;
  const int row = hp[0], p0 = hp[1], np = hp[2];
  if (np <= 0) return;
  const int* pb = partial + ((long long)b * n_span + p0) * NOUT * k;
  for (int i = threadIdx.x; i < NOUT * k; i += blockDim.x) {
    int s = 0;
    for (int p = 0; p < np; ++p) s += pb[(long long)p * NOUT * k + i];
    float* out = i < k ? out0 : out1;
    out[((long long)b * block_v + row) * k + i % k] = (float)s;
  }
}

template <int NOUT>
cudaError_t launch_hub_add(const void* hubs, const void* partial, void* out0, void* out1,
                           int nb, int block_v, int k, int n_span, int n_hub,
                           cudaStream_t stream) {
  if (n_hub <= 0) return cudaSuccess;
  hub_add_kernel<NOUT><<<dim3((unsigned)n_hub, (unsigned)nb), 128, 0, stream>>>(
      (const int*)hubs, (const int*)partial, (float*)out0, (float*)out1, block_v, k, n_span,
      n_hub);
  return cudaGetLastError();
}

// lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB
// only after this attribute is set)
template <class Kernel>
cudaError_t allow_shared(Kernel kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace span_plan
