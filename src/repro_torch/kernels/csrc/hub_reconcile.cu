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
// ~1.3 us at 3.35 TB/s. The function is serial only where the capacity
// refuses: a move changes the loads of its own two labels, and a slot's
// gate reads one load.
//
// Design: two launches.
//  Pass 1 (h1_flags), over the grid, one slot a thread, CTAs of 256 slots
//  (at most 512 CTAs; past 131,072 slots a CTA takes several tiles): each
//  slot's total, argmax (a row of k % 4 == 0 as 16-byte loads) and "may
//  move" flag (every term of ok but the capacity); winners[j] = cur[j]; the
//  CTA's flagged slots compacted in slot order into its own segment of the
//  list (j, cand, cur, deg); and one record: its flagged count, the largest
//  and the sum of their degrees, and whether each is an integer in
//  [0, 2^24].
//  Pass 2 (h1_walk), one CTA of 512 threads: an exclusive scan of the
//  records' counts puts the segments in slot order; the guard below picks
//  the body; the flagged slots are staged 4,096 at a time in shared memory
//  (a binary search of the scan finds each one's segment), warps 8-15
//  staging the next chunk while warps 0-7 walk this one. The walk records
//  each slot's outcome in shared memory; the staging warps write the
//  winners of a chunk while the next one is walked (no global store in the
//  walk's chain), the last chunk's all threads at the end.
//  The parallel body (k <= 32 and the guard holds) walks in integers and
//  speculates, verifies and commits, on 8 walk warps: each keeps the k
//  loads (lane l label l's) and takes the same decisions, so the copies stay
//  equal. A window holds 256 slots, one a walk thread, each with a guessed
//  outcome o_i. Each warp scans all labels' deltas at once over its 32
//  slots (+d into a target, -d out of a label, for the slots guessed
//  taken), publishes its totals, and after a named barrier each slot adds
//  the earlier warps' totals into its target: its gate g_i = load[c_i] +
//  those deltas + d_i <= floor(cap). The first slot with g_i != o_i (a
//  ballot a warp, then the warps' masks) ends the round: every guess
//  before it was right, so those gates and g_i are the serial walk's. The
//  slots up to it commit: their outcomes recorded, and each label's deltas
//  through it (the earlier warps' totals and that warp's prefix, published
//  with its gate in place of its guess) added to the loads. The next round
//  starts after it, guessing for each slot this round saw the gate it gave
//  it, and for the others their gate against the loads alone. A round
//  commits one slot at least, and the whole window where the guesses hold:
//  where a label's room outlasts the window or is already spent, as at a
//  hub superstep, they do. Where they fail densely (a round commits fewer
//  than 32 slots) warp 0 takes the next 256 slots one at a time, two at
//  once (each target's load shuffled from the pair's start, the second
//  adjusted by the first's move in registers), hands the loads to the other
//  walk warps and guesses afresh.
//  The serial body (the guard fails, or k > 32): thread 0 walks the slots in
//  f32 against the loads in shared memory, with explicit round-to-nearest
//  adds and subtracts (the file is built with -fmad=false), so the loads
//  round like the plain version's f32 updates, bit for bit.
//
// The guard, decided on the device from pass 1's records and the loads:
// integer adds are exact in any order, and f32 holds every integer of
// magnitude <= 2^24, so the integer walk is the f32 walk bit for bit when
// every flagged degree is an integer in [0, 2^24], every load an integer of
// magnitude <= 2^24 and not -0.0, top + the largest degree <= 2^24 (top =
// max(max loads, floor(cap)): a load rises only through a move the gate
// takes), and a floor under every load the walk reaches is >= -2^24: the
// larger of min loads - the flagged degrees' sum and the loads' sum -
// (k - 1) top (the sum does not change, and no other label holds more than
// top). `parallel_walk_exact` in hub_reconcile.py states the same.
//
// No float atomics and no host sync; two calls are bit-equal (every sum is
// of integers, or the serial walk's in its one order). The walk's counts
// (body, rounds, serial steps, flagged) are left in the scratch's last int4.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kFlagThreads = 256;            // pass 1: a tile of slots, one a thread
constexpr int kFlagWarps = kFlagThreads / 32;
constexpr int kMaxFlagCtas = 512;            // pass 1's CTAs at most: a record a walk thread
constexpr int kWalkThreads = 512;
constexpr int kWalkWarps = kWalkThreads / 32;
constexpr int kSpecWarps = 8;                // warps that walk; the others stage
constexpr int kWindow = 32 * kSpecWarps;     // a window: a slot a walk thread
constexpr int kSerialBelow = 32;             // a round committing fewer slots than this ...
constexpr int kSerialSteps = 256;            // ... is followed by this many serial steps
constexpr int kGroup = 2;                    // serial steps resolved a group at a time
constexpr int kChunk = 4096;                 // list entries staged at a time (two buffers)
constexpr int kAhead = 4;                    // entries a staging thread has in flight
constexpr int kMaxK = 1024;
constexpr int kExact = 1 << 24;              // f32 holds every integer of magnitude <= 2^24
constexpr int kCapClamp = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void vote(int v, int l, int& best, int& cand, long long& total) {
  total += v;
  if (v > best) {
    best = v;
    cand = l;
  }
}

__global__ void __launch_bounds__(kFlagThreads)
h1_flags(const int* __restrict__ votes, const int* __restrict__ cur,
         const float* __restrict__ deg, const int* __restrict__ owner,
         int* __restrict__ winners, int4* __restrict__ list, int4* __restrict__ records,
         int hub_pad, int k, int span, int vec) {
  __shared__ int s_warp[kFlagWarps];
  __shared__ int s_max[kFlagWarps];
  __shared__ int s_exact[kFlagWarps];
  __shared__ long long s_sum[kFlagWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int seg = blockIdx.x * span;
  const int end = min(seg + span, hub_pad);
  int count = 0;                     // the CTA's flagged slots so far (the same in every thread)
  int max_d = 0, exact = 1;
  long long sum_d = 0;
  for (int t0 = seg; t0 < end; t0 += kFlagThreads) {
    const int j = t0 + tid;
    int flag = 0, cand = 0, p = 0;
    float d = 0.f;
    if (j < end) {
      const int* row = votes + (long long)j * k;
      int best;
      long long total;
      if (vec) {
        const int4* row4 = reinterpret_cast<const int4*>(row);
        int4 v = row4[0];
        best = v.x;
        total = v.x;
        vote(v.y, 1, best, cand, total);
        vote(v.z, 2, best, cand, total);
        vote(v.w, 3, best, cand, total);
        for (int q = 1; q < (k >> 2); ++q) {
          v = row4[q];
          vote(v.x, 4 * q, best, cand, total);
          vote(v.y, 4 * q + 1, best, cand, total);
          vote(v.z, 4 * q + 2, best, cand, total);
          vote(v.w, 4 * q + 3, best, cand, total);
        }
      } else {
        best = row[0];
        total = best;
        for (int l = 1; l < k; ++l) vote(row[l], l, best, cand, total);
      }
      p = cur[j];
      d = deg[j];
      flag = owner[j] >= 0 && total > 0 && cand != p;
      winners[j] = p;
    }
    if (flag) {
      if (d >= 0.f && d <= (float)kExact && d == truncf(d)) {
        max_d = max(max_d, (int)d);
        sum_d += (int)d;
      } else {
        exact = 0;
      }
    }
    const unsigned ballot = __ballot_sync(kFull, flag);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int w = 0; w < kFlagWarps; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      tile += c;
    }
    if (flag) {
      const int pos = seg + count + before + __popc(ballot & ((1u << lane) - 1u));
      list[pos] = make_int4(j, cand, p, __float_as_int(d));
    }
    count += tile;
    __syncthreads();                 // s_warp is written again by the next tile
  }
  max_d = __reduce_max_sync(kFull, max_d);
  exact = (int)__reduce_and_sync(kFull, (unsigned)exact);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum_d += __shfl_down_sync(kFull, sum_d, off);
  if (lane == 0) {
    s_max[warp] = max_d;
    s_exact[warp] = exact;
    s_sum[warp] = sum_d;
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0, e = 1;
    long long s = 0;
    for (int w = 0; w < kFlagWarps; ++w) {
      m = max(m, s_max[w]);
      e &= s_exact[w];
      s += s_sum[w];
    }
    records[2 * blockIdx.x] = make_int4(count, m, e, 0);
    records[2 * blockIdx.x + 1] = make_int4((int)(unsigned)(s & 0xffffffffll),
                                            (int)(s >> 32), 0, 0);
  }
}

// Copies list entries q0 .. q0 + m - 1 (in slot order) into dst: entry q
// lies in the segment of the last CTA b with off[b] <= q. In the parallel
// body the degree is stored as an integer.
__device__ __forceinline__ void stage(int4* dst, const int4* __restrict__ list,
                                      const int* off, int n_ctas, int span, int q0, int m,
                                      int t, int nt, bool as_int) {
  for (int i0 = t; i0 < m; i0 += kAhead * nt) {
    int4 e[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int q = q0 + i0 + u * nt;
      if (i0 + u * nt < m) {
        int lo = 0, hi = n_ctas - 1;
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (off[mid] <= q) lo = mid;
          else hi = mid - 1;
        }
        e[u] = list[(long long)lo * span + (q - off[lo])];
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      if (i0 + u * nt < m) {
        if (as_int) e[u].w = (int)__int_as_float(e[u].w);
        dst[i0 + u * nt] = e[u];
      }
    }
  }
}

// The serial body: one thread, f32, the loads in shared memory.
__device__ void walk_serial(const int4* buf, int m, float* s_loads, float cap,
                            unsigned char* taken) {
  for (int i = 0; i < m; ++i) {
    const int4 e = buf[i];
    const float d = __int_as_float(e.w);
    const float moved = __fadd_rn(s_loads[e.y], d);
    taken[i] = moved <= cap;
    if (moved <= cap) {
      s_loads[e.z] = __fsub_rn(s_loads[e.z], d);
      s_loads[e.y] = moved;
    }
  }
}

// Writes the winners of a walked chunk: cand where the walk took the move.
__device__ __forceinline__ void flush(const int4* buf, const unsigned char* taken, int m,
                                      int* __restrict__ winners, int t, int nt) {
  for (int i = t; i < m; i += nt)
    if (taken[i]) winners[buf[i].x] = buf[i].y;
}

// The walk warps' shared state for the parallel body (KB labels).
template <int KB>
struct WalkShared {
  int tot[2][kSpecWarps][KB];   // each warp's deltas a label, guessed (by round parity)
  int upto[kSpecWarps][KB];     // a warp's deltas through its first wrong guess, corrected
  unsigned took[kSpecWarps];    // each warp's gates
  unsigned wrong[kSpecWarps];   // each warp's wrong guesses
  int serial[KB];               // the loads after serial steps (warp 0's)
};

__device__ __forceinline__ void walk_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kSpecWarps * 32) : "memory");
}

// The parallel body over one staged chunk of m slots, by the walk warps
// (warp w takes slot 32 w + lane of a window). Every walk warp keeps the
// loads, lane l label l's (KB >= k labels), and takes the same decisions
// from shared memory, so the copies stay equal. Sums wrap as unsigned: a
// gate on the committed path is exact (the guard), any other is thrown
// away. Each slot's outcome goes to ``taken``; warp 0 writes the serial
// steps'.
template <int KB>
__device__ void walk_parallel(const int4* buf, int m, int& load, int capi, unsigned char* taken,
                              WalkShared<KB>& sh, int warp, int lane, int& rounds,
                              int& steps) {
  const int i = warp * 32 + lane;    // this thread's slot in a window
  int carried = 0;                   // the window's leading slots whose guess is carried
  bool carried_guess = false;        // this slot's carried guess
  int par = 0;
  int base = 0;
  while (base < m) {
    __syncwarp();                    // the shuffles and ballots below take the whole warp
    const bool valid = base + i < m;
    const int4 e = valid ? buf[base + i] : make_int4(0, 0, 0, 0);
    const int c = e.y, p = e.z, d = e.w;
    const unsigned at = (unsigned)__shfl_sync(kFull, load, c);
    // a slot no round has seen guesses its gate against the loads alone
    const bool fresh = (int)(at + (unsigned)d) <= capi;
    const bool o = valid && (i < carried ? carried_guess : fresh);
    const unsigned dv = o ? (unsigned)d : 0u;
    // each label's deltas up to this lane, all labels scanned at once
    unsigned incl[KB];
#pragma unroll
    for (int l = 0; l < KB; ++l) incl[l] = (c == l ? dv : 0u) - (p == l ? dv : 0u);
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      unsigned below[KB];
#pragma unroll
      for (int l = 0; l < KB; ++l) below[l] = __shfl_up_sync(kFull, incl[l], off);
      if (lane >= off) {
#pragma unroll
        for (int l = 0; l < KB; ++l) incl[l] += below[l];
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int l = 0; l < KB; ++l) sh.tot[par][warp][l] = (int)incl[l];
    }
    walk_barrier();
    // into c: the earlier warps' deltas, then this warp's before this lane
    unsigned before = 0u;
    for (int v = 0; v < warp; ++v) before += (unsigned)sh.tot[par][v][c];
#pragma unroll
    for (int l = 0; l < KB; ++l)
      if (c == l) before += incl[l] - dv;
    const bool g = valid && (int)(at + before + (unsigned)d) <= capi;
    const unsigned took = __ballot_sync(kFull, g);
    const unsigned wrong = __ballot_sync(kFull, valid && g != o);
    if (wrong && lane == __ffs(wrong) - 1) {
      // this warp's deltas through this slot, with its gate in place of its guess
      const unsigned fix = g ? (unsigned)d : 0u - (unsigned)d;
#pragma unroll
      for (int l = 0; l < KB; ++l)
        sh.upto[warp][l] = (int)(incl[l] + (c == l ? fix : 0u) - (p == l ? fix : 0u));
    }
    if (lane == 0) {
      sh.took[warp] = took;
      sh.wrong[warp] = wrong;
    }
    walk_barrier();
    // the first wrong guess of the window ends what commits
    int first = kSpecWarps, done = min(kWindow, m - base);
    for (int v = kSpecWarps - 1; v >= 0; --v)
      if (sh.wrong[v]) first = v;
    if (first < kSpecWarps) done = first * 32 + __ffs(sh.wrong[first]);
    const int label = min(lane, KB - 1);      // the same loop in every lane: no branch
    int sum = first < kSpecWarps ? sh.upto[first][label] : 0;
    for (int v = 0; v < first; ++v) sum += sh.tot[par][v][label];
    load += lane < KB ? sum : 0;
    if (valid && i < done) taken[base + i] = g;
    // the next window's slot i carries the gate this one gave slot done + i
    const int q = done + i;
    carried_guess = q < kWindow && ((sh.took[q >> 5] >> (q & 31)) & 1u);
    carried = kWindow - done;
    par ^= 1;
    base += done;
    ++rounds;
    if (done < kSerialBelow) {
      // guesses fail densely: take the next slots one at a time, a group
      // of kGroup at once. Each slot's target load is shuffled from the
      // loads at the group's start and adjusted by the group's earlier
      // moves in registers, so the chain runs through one shuffle a group
      // and a few adds a slot, with no branch
      const int stop = min(m, base + kSerialSteps);
      steps += stop - base;
      if (warp == 0) {               // the others wait, then take warp 0's loads
        __syncwarp();
        for (int q = base; q < stop; q += kGroup) {
          int4 f[kGroup];
          int held[kGroup], moved[kGroup];
          bool ok[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) f[u] = buf[min(q + u, stop - 1)];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) held[u] = __shfl_sync(kFull, load, f[u].y);
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            int at = held[u];
#pragma unroll
            for (int v = 0; v < u; ++v)
              at += (f[u].y == f[v].y ? moved[v] : 0) - (f[u].y == f[v].z ? moved[v] : 0);
            ok[u] = q + u < stop && at + f[u].w <= capi;
            moved[u] = ok[u] ? f[u].w : 0;
          }
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            load += (lane == f[u].y ? moved[u] : 0) - (lane == f[u].z ? moved[u] : 0);
            if (lane == 0 && q + u < stop) taken[q + u] = ok[u];
          }
        }
        if (lane < KB) sh.serial[lane] = load;
      }
      walk_barrier();
      if (warp != 0 && lane < KB) load = sh.serial[lane];
      base = stop;
      carried = 0;
    }
  }
}

template <int KB>
__global__ void __launch_bounds__(kWalkThreads)
h1_walk(const int4* __restrict__ list, const int4* __restrict__ records,
        int4* __restrict__ counts, float* __restrict__ loads, const float* __restrict__ cap_ptr,
        int* __restrict__ winners, int n_ctas, int span, int k) {
  extern __shared__ int4 s_buf[];              // [2][kChunk] staged list entries
  __shared__ int s_off[kMaxFlagCtas + 1];
  __shared__ float s_loads[kMaxK];
  __shared__ int s_scan[kWalkWarps];
  __shared__ int s_imax[kWalkWarps][2];        // largest degree, largest load
  __shared__ int s_imin[kWalkWarps][2];        // all exact, smallest load
  __shared__ long long s_sum[kWalkWarps][2];   // degrees' sum, loads' sum
  __shared__ int s_parallel, s_capi;
  __shared__ WalkShared<KB> s_walk;
  __shared__ unsigned char s_taken[2][kChunk];   // each staged slot's outcome
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // the records: counts scanned into segment offsets; the guard's terms
  int cnt = 0, max_d = 0, exact = 1;
  long long sum_d = 0;
  if (tid < n_ctas) {
    const int4 a = records[2 * tid];
    const int4 b = records[2 * tid + 1];
    cnt = a.x;
    max_d = a.y;
    exact = a.z;
    sum_d = (long long)(((unsigned long long)(unsigned)b.y << 32) | (unsigned)b.x);
  }
  int max_l = -kCapClamp, min_l = kCapClamp;
  long long sum_l = 0;
  for (int l = tid; l < k; l += kWalkThreads) {
    const float x = loads[l];
    s_loads[l] = x;
    if (fabsf(x) <= (float)kExact && x == truncf(x) && !(x == 0.f && signbit(x))) {
      max_l = max(max_l, (int)x);
      min_l = min(min_l, (int)x);
      sum_l += (int)x;
    } else {
      exact = 0;
    }
  }
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int below = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += below;
  }
  max_d = __reduce_max_sync(kFull, max_d);
  max_l = __reduce_max_sync(kFull, max_l);
  min_l = __reduce_min_sync(kFull, min_l);
  exact = (int)__reduce_and_sync(kFull, (unsigned)exact);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum_d += __shfl_down_sync(kFull, sum_d, off);
    sum_l += __shfl_down_sync(kFull, sum_l, off);
  }
  if (lane == 31) s_scan[warp] = incl;
  if (lane == 0) {
    s_imax[warp][0] = max_d;
    s_imax[warp][1] = max_l;
    s_imin[warp][0] = exact;
    s_imin[warp][1] = min_l;
    s_sum[warp][0] = sum_d;
    s_sum[warp][1] = sum_l;
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0, md = 0, ml = -kCapClamp, mn = kCapClamp, ex = 1;
    long long sd = 0, sl = 0;
    for (int w = 0; w < kWalkWarps; ++w) {
      const int t = s_scan[w];
      s_scan[w] = run;
      run += t;
      md = max(md, s_imax[w][0]);
      ml = max(ml, s_imax[w][1]);
      ex &= s_imin[w][0];
      mn = min(mn, s_imin[w][1]);
      sd += s_sum[w][0];
      sl += s_sum[w][1];
    }
    s_off[n_ctas] = run;
    const float cap = *cap_ptr;
    const int capi = isnan(cap) ? -kCapClamp
                                : (int)fminf(fmaxf(floorf(cap), -(float)kCapClamp),
                                             (float)kCapClamp);
    const long long top = max((long long)ml, (long long)capi);
    const long long low = max((long long)mn - sd, sl - (long long)(k - 1) * top);
    s_parallel = k <= KB && ex && top + md <= kExact && low >= -(long long)kExact;
    s_capi = capi;
  }
  __syncthreads();
  if (tid < n_ctas) s_off[tid] = s_scan[warp] + incl - cnt;
  __syncthreads();

  const int n = s_off[n_ctas];
  const bool parallel = s_parallel;
  const int capi = s_capi;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  if (n_chunks > 0)
    stage(s_buf, list, s_off, n_ctas, span, 0, min(kChunk, n), tid, kWalkThreads, parallel);
  __syncthreads();
  constexpr int kWalkers = kSpecWarps * 32;
  int load = 0;                 // the parallel body: lane l of each walk warp holds label l's
  if (parallel && warp < kSpecWarps && lane < k) load = (int)s_loads[lane];
  int rounds = 0, steps = 0;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int m = min(kChunk, n - ch * kChunk);
    const int4* buf = s_buf + (ch & 1) * kChunk;
    if (warp < kSpecWarps) {
      if (parallel) {
        walk_parallel<KB>(buf, m, load, capi, s_taken[ch & 1], s_walk, warp, lane, rounds,
                          steps);
      } else if (tid == 0) {
        walk_serial(buf, m, s_loads, *cap_ptr, s_taken[ch & 1]);
      }
    } else {
      // the staging warps write the last chunk's winners, then stage the
      // next chunk into its buffer
      if (ch > 0)
        flush(s_buf + ((ch - 1) & 1) * kChunk, s_taken[(ch - 1) & 1], kChunk, winners,
              tid - kWalkers, kWalkThreads - kWalkers);
      if (ch + 1 < n_chunks) {
        asm volatile("bar.sync 2, %0;" ::"n"(kWalkThreads - kWalkers) : "memory");
        const int q0 = (ch + 1) * kChunk;
        stage(s_buf + ((ch + 1) & 1) * kChunk, list, s_off, n_ctas, span, q0,
              min(kChunk, n - q0), tid - kWalkers, kWalkThreads - kWalkers, parallel);
      }
    }
    __syncthreads();
  }
  if (n_chunks > 0) {
    const int last = n_chunks - 1;
    flush(s_buf + (last & 1) * kChunk, s_taken[last & 1], n - last * kChunk, winners, tid,
          kWalkThreads);
  }
  if (n > 0) {
    if (parallel) {
      if (warp == 0 && lane < k) loads[lane] = (float)load;
    } else {
      for (int l = tid; l < k; l += kWalkThreads) loads[l] = s_loads[l];
    }
  }
  if (tid == 0) counts[0] = make_int4(parallel ? 1 : 0, rounds, steps, n);
}

template <int KB>
cudaError_t launch_walk(const int4* list, const int4* records, int4* counts, float* loads,
                        const float* cap, int* winners, int n_ctas, int span, int k,
                        cudaStream_t s) {
  const int smem = 2 * kChunk * (int)sizeof(int4);
  const cudaError_t err = cudaFuncSetAttribute(
      h1_walk<KB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  h1_walk<KB><<<1, kWalkThreads, smem, s>>>(list, records, counts, loads, cap, winners,
                                            n_ctas, span, k);
  return cudaGetLastError();
}

}  // namespace

// scratch (`list`): max(hub_pad, 1) int4 of compacted segments, then two
// int4 a pass-1 CTA (kMaxFlagCtas of them), then the walk's counts
extern "C" int hub_reconcile_launch(const void* votes, const void* cur, const void* deg,
                                    const void* owner, void* loads, const void* cap,
                                    void* winners, void* list, int hub_pad, int k,
                                    void* stream) {
  if (k < 1 || k > kMaxK || hub_pad < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (hub_pad + kFlagThreads - 1) / kFlagThreads;
  const int per_cta = (tiles + kMaxFlagCtas - 1) / kMaxFlagCtas;
  const int n_ctas = per_cta > 0 ? (tiles + per_cta - 1) / per_cta : 0;
  const int span = per_cta * kFlagThreads;
  int4* list4 = (int4*)list;
  int4* records = list4 + (hub_pad > 1 ? hub_pad : 1);
  int4* counts = records + 2 * kMaxFlagCtas;
  const int vec = (k % 4 == 0) && ((uintptr_t)votes % 16 == 0);
  if (n_ctas > 0) {
    h1_flags<<<n_ctas, kFlagThreads, 0, s>>>(
        (const int*)votes, (const int*)cur, (const float*)deg, (const int*)owner,
        (int*)winners, list4, records, hub_pad, k, span, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // the labels the parallel body scans: k rounded up to a power of two
  // (k > 32 takes the serial body)
  cudaError_t (*walk)(const int4*, const int4*, int4*, float*, const float*, int*, int, int,
                      int, cudaStream_t) = launch_walk<32>;
  if (k <= 2) walk = launch_walk<2>;
  else if (k <= 4) walk = launch_walk<4>;
  else if (k <= 8) walk = launch_walk<8>;
  else if (k <= 16) walk = launch_walk<16>;
  return (int)walk(list4, records, counts, (float*)loads, (const float*)cap, (int*)winners,
                   n_ctas, span, k, s);
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
