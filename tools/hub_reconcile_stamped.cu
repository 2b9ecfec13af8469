// A copy of H1 as it was built before its redesign (the one-CTA kernel of
// src/repro_torch/kernels/csrc/hub_reconcile.cu at the port's slice 18),
// with clock64() and %globaltimer stamps taken by thread 0 at the start,
// after pass 1 and after pass 2, written to stamps[0..5] with the
// flagged count in stamps[6]. Built and timed by tools/torch_h1_passes.py;
// nothing in the program uses it.
//
// H1: the hub vote reconcile of hub replication (sm_90a).
//
// Replaces no TPU kernel: `repro`'s reconcile (repro/core/engine.py::
// _hub_reconcile) is a lax.scan over the hub slots, which XLA runs as a
// sequential loop on the TPU. The port needs a kernel for it because the
// walk is sequential: as plain PyTorch on the card it is a Python loop of
// several launches a slot, ~90k slots a superstep on full WIKI.
//
// What it computes, over hub_pad slots in slot order, from the merged vote
// table votes [hub_pad, k] (int32), the current hub labels cur, the hubs'
// degrees deg (f32), their owner shards (-1 pad) and the k f32 loads:
//   cand[j] = argmax_l votes[j, l]   (ties to the lowest label)
//   ok[j]   = owner[j] >= 0 && sum_l votes[j, l] > 0 && cand[j] != cur[j]
//             && loads[cand[j]] + deg[j] <= cap      (the loads as carried)
//   where ok: loads[cur[j]] -= deg[j]; loads[cand[j]] += deg[j]  (f32)
//   winners[j] = ok ? cand[j] : cur[j]
// The loads are updated in place.
//
// Bound on the card: the table read once (4 k bytes a slot) plus 16 bytes
// a slot for cur, deg, owner and winners: ~4.3 MB at 90k slots and k = 8,
// ~1.3 us at 3.35 TB/s; and the serial chain through the loads, one
// dependent shared-memory round trip per slot that may move.
//
// Design: one CTA. Pass 1 is parallel: each thread takes one slot of a
// 1024-slot tile, computes its total, argmax and the "may move" flag (every
// term of ok but the capacity), and writes winners[j] = cur[j]; a warp
// ballot and a scan of the 32 warp counts give each flagged slot its place
// in a compacted list (j, cand, cur, deg), kept in slot order. Pass 2 is
// serial: the list is staged into shared memory in chunks by the whole CTA,
// and one thread walks it against the k loads held in shared memory,
// writing the winner of each move it takes. Only flagged slots reach the
// serial walk, so its length is the number of hubs whose vote disagrees
// with their label. Adds and subtracts are explicit round-to-nearest
// intrinsics and the file is built with -fmad=false, so the loads round
// like the plain version's f32 updates, bit for bit.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ long long globaltimer() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 2048;   // list entries staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
hub_reconcile_kernel(const int* __restrict__ votes, const int* __restrict__ cur,
                     const float* __restrict__ deg, const int* __restrict__ owner,
                     float* __restrict__ loads, const float* __restrict__ cap_ptr,
                     int* __restrict__ winners, int4* __restrict__ list, int hub_pad,
                     int k, long long* __restrict__ stamps) {
  extern __shared__ float s_loads[];          // [k]
  __shared__ int s_warp[kWarps];
  __shared__ int s_tile;
  __shared__ int s_count;
  __shared__ int4 s_list[kChunk];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int l = tid; l < k; l += kThreads) s_loads[l] = loads[l];
  if (tid == 0) s_count = 0;
  __syncthreads();
  if (tid == 0) {
    stamps[0] = clock64();
    stamps[3] = globaltimer();
  }

  // pass 1: argmax, total and flag of every slot; ordered compaction
  for (int t0 = 0; t0 < hub_pad; t0 += kThreads) {
    const int j = t0 + tid;
    int flag = 0, cand = 0, p = 0;
    float d = 0.f;
    if (j < hub_pad) {
      const int* row = votes + (long long)j * k;
      int best = row[0];
      long long total = best;
      for (int l = 1; l < k; ++l) {
        const int v = row[l];
        total += v;
        if (v > best) {
          best = v;
          cand = l;
        }
      }
      p = cur[j];
      d = deg[j];
      flag = owner[j] >= 0 && total > 0 && cand != p;
      winners[j] = p;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    if (warp == 0) {
      const int v = s_warp[lane];
      int incl = v;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int n = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += n;
      }
      s_warp[lane] = incl - v;               // exclusive: the warp's offset
      if (lane == 31) s_tile = incl;
    }
    __syncthreads();
    if (flag) {
      const int pos = s_count + s_warp[warp] + __popc(ballot & ((1u << lane) - 1u));
      list[pos] = make_int4(j, cand, p, __float_as_int(d));
    }
    __syncthreads();
    if (tid == 0) s_count += s_tile;
    __syncthreads();
  }

  // pass 2: the capacity-gated walk over the flagged slots, in slot order
  const int n = s_count;
  if (tid == 0) {
    stamps[1] = clock64();
    stamps[4] = globaltimer();
  }
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    for (int i = tid; i < m; i += kThreads) s_list[i] = list[c0 + i];
    __syncthreads();
    if (tid == 0) {
      const float cap = *cap_ptr;
      for (int i = 0; i < m; ++i) {
        const int4 e = s_list[i];
        const float dd = __int_as_float(e.w);
        const float moved = __fadd_rn(s_loads[e.y], dd);
        if (moved <= cap) {
          s_loads[e.z] = __fsub_rn(s_loads[e.z], dd);
          s_loads[e.y] = moved;
          winners[e.x] = e.y;
        }
      }
    }
    __syncthreads();
  }
  if (tid == 0) {
    stamps[2] = clock64();
    stamps[5] = globaltimer();
  }
  if (tid == 0) stamps[6] = n;
  for (int l = tid; l < k; l += kThreads) loads[l] = s_loads[l];
}

}  // namespace

extern "C" int hub_reconcile_stamped_launch(const void* votes, const void* cur,
                                            const void* deg, const void* owner, void* loads,
                                            const void* cap, void* winners, void* list,
                                            int hub_pad, int k, void* stamps, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  hub_reconcile_kernel<<<1, kThreads, (size_t)k * sizeof(float), s>>>(
      (const int*)votes, (const int*)cur, (const float*)deg, (const int*)owner,
      (float*)loads, (const float*)cap, (int*)winners, (int4*)list, hub_pad, k,
      (long long*)stamps);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
