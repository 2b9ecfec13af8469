// K4: causal / sliding-window GQA flash attention, forward (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py::flash_attention_pallas (the
// TPU kernel walks a (B, Hq, Sq/bq, Skv/bk) grid with the kv-block axis
// minor and sequential, keeping the [bq, d] f32 accumulator and the running
// max m and sum l in VMEM scratch across it).
//
// What it computes, for batch b, query head h (kv head h / group) and query
// row i at position qpos = i + (Skv - Sq) (queries right-aligned to keys):
//   s_j = (q_i . k_j) / sqrt(d)  over keys j with  j < Skv,
//         and qpos >= j (causal), and qpos - j < window (sliding window);
//   o_i = sum_j softmax(s)_j v_j, in f32, stored in q's dtype.
// Masked scores are -1e30, not -inf, and masked probabilities are 0, so a
// row with no valid key gives o = 0 (l = 0), as the TPU kernel does.
//
// Bound on the card: operations. At the serving prefill shape (B 8, Hq 32,
// Hkv 4, S 1024, d 64, bf16, causal) the kernel must move ~75 MB (q, k, v,
// o once: ~23 us at 3.35 TB/s) and do ~2 B Hq S^2 d = 34 GFLOP of products
// (~35 us at the 989 TFLOP/s bf16 tensor-core peak). At MLA's prefill
// shape (B 8, H 16, S 1024, d 192) ~51.5 GFLOP: ~52 us. At zamba2-7b's
// shared-attention prefill (B 8, H 32, S 1024, d 224, MHA) the bytes bound
// it, ~470 MB: ~140 us; at h2o-danube-3-4b's windowed prefill (B 4, Hq 32,
// Hkv 8, S 4608, d 120, window 4096) the operations, ~644 GFLOP: ~652 us.
//
// Two bodies, chosen by the C entry point on dtype and d:
//
// * bf16 at d in {64, 120, 128, 192, 224}, the serving dtype: the tensor-core body
//   (`flash_attention_tc_kernel`), after FlashAttention-3's forward. A CTA
//   takes one 128-row q tile of one (b, q head): two warpgroups, each
//   owning 64 rows (wgmma's M); at d <= 128 two CTAs share an SM (at most
//   128 registers a thread), so one CTA's softmax overlaps the other's
//   products. d 192 is DeepSeek-V2's MLA prefill (128 no-RoPE + 64 RoPE
//   dims, v padded to 192 by the caller): one CTA an SM, its 64 x 192 O
//   fragment 96 registers a thread beside S's 32, Q 48 KB and each K or V
//   stage 24 KB of shared memory (145 KB at 2 stages), a row three
//   64-element swizzle boxes, P.V one m64n192k16 wgmma a 16-key step.
//   d 120 (h2o-danube-3-4b) and 224 (zamba2-7b's shared block) are padded
//   inside the kernel to DP = 128 and 256, the next whole box: the tensor
//   maps keep the true d as their inner extent, so TMA's out-of-bounds fill
//   writes zeros into the columns past d (no padded copy in device memory),
//   Q K^T runs over DP columns, P.V is an m64n{DP}k16 wgmma whose columns
//   past d are never stored, and the scale is 1/sqrt(d) of the true d. At
//   DP 256 (d 224) one CTA holds an SM: 128 O accumulators a thread, Q 64 KB
//   and each K or V stage 32 KB (193 KB at 2 stages).
//   Thread 0 issues TMA copies (cp.async.bulk.tensor, 128-byte swizzle, 3-d tensor
//   maps over [B*H, S, d] so rows past S come back as zeros) of Q once and
//   of 64-key K and V tiles into a ring (4 slots at d 64, 2 at the wider)
//   guarded by full/empty mbarriers: tile j + slots goes into tile j's slot
//   as soon as all 8 warps have released it, so the copies of the next
//   tiles overlap the products on this one. Each warpgroup computes
//   S = Q K^T with wgmma (both operands in shared memory, K-major, f32
//   accumulators in registers), takes the online softmax on the
//   accumulator fragment (each row's max and sum across the 4 lanes of a
//   quad, by shuffles; the accumulator rescaled by exp2(m_old - m_new)),
//   rounds all of P to bf16 in registers and then adds P V with wgmma's
//   register-A form, the products issued back to back (V is [Bk, d] with d
//   contiguous, so B is MN-major: the transpose bit). Masks are applied
//   only on tiles that touch the diagonal, the window's edge or the ragged
//   Skv end; tiles the causal mask or the window kills for the whole CTA
//   are never loaded, and a warpgroup skips the products on a tile that
//   is dead for all its rows. The heaviest q tiles (the last ones) are
//   launched first (the q-tile index is the grid's slowest axis, reversed),
//   so the causal load does not leave SMs idle at the end. O is written
//   once per element as bf16: no atomics, deterministic.
//   Numerics: S is exact products of bf16 values summed in f32; P is
//   rounded to bf16 before P V, at most 2^-9 relative error per term, the
//   order of the output's own bf16 rounding and inside the card check's
//   bf16 tolerance (atol 2e-2, rtol 1e-2); l sums the unrounded f32 P.
//
// * f32 (d in {16, 24, 32, 64, 120, 128, 192, 224}) and bf16 at d in
//   {16, 24, 32}:
//   the SIMT body (`flash_attention_simt_kernel`). The f32 instantiation
//   serves the f32 parity checks (the reduced-model checks at 1e-4, MLA's
//   at d 24, and the kernel against f64 at 5e-5), which TF32 products
//   could not meet; bf16 at d <= 32 is served by no config in the repo.
//   One CTA per (64-row q tile, q head, batch); each thread owns one query
//   row (two threads a row at d 120 and 128, four at d 192 and 224, each a
//   share of the dims, a multiple of 4): its q slice and its f32
//   accumulator stay in registers, with
//   the running m and l. K and
//   V tiles are staged in shared memory as f32 and read back as warp-wide
//   broadcasts; scores are taken 16 keys at a time. Its products run in f32
//   on the CUDA cores (67 TFLOP/s peak).

#include <cuda.h>  // CUtensorMap and the tensor-map encoder's types only
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kRows = 64;  // query rows per CTA (SIMT body)
constexpr int kChunk = 16;  // keys per online-softmax step (SIMT body)

// ---------------------------------------------------------------------------
// tensor-core body (bf16, d in {64, 120, 128, 192, 224})
// ---------------------------------------------------------------------------
constexpr int kTcRows = 128;           // q rows per CTA: two warpgroups of 64
constexpr int kTcWarps = 8;
constexpr int kTcThreads = kTcWarps * 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct TcShape {
  static_assert(D == 64 || D == 120 || D == 128 || D == 192 || D == 224,
                "a head width the tensor-core body takes");
  // the head padded to whole 64-column swizzle boxes in shared memory: TMA
  // fills the columns past D with zeros (the tensor map's inner extent is
  // D), so Q K^T over DP columns equals it over D, and P V's columns past D
  // are dropped at the store
  static constexpr int DP = (D + 63) / 64 * 64;
  static constexpr int BK = 64;                   // keys per K/V tile
  // CTAs an SM holds: 2 at DP <= 128 (register cap 128); 1 at DP 192 or
  // 256, whose 96 or 128 O accumulators a thread beside S's 32 need the
  // 255-register cap and whose 145 or 193 KB of tiles fill the SM's shared
  // memory alone
  static constexpr int MIN_CTAS = DP > 128 ? 1 : 2;
  static constexpr int STAGES = DP == 64 ? 4 : 2; // K/V ring depth
  static constexpr int NH = DP / 64;              // 64-column (128-byte) boxes
  static constexpr int Q_BYTES = NH * kTcRows * 128;
  static constexpr int KV_BYTES = NH * BK * 128;  // one K (or V) tile
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 128;
  static_assert(SMEM <= 232448, "shared memory a block can use");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// spin until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// 3-d TMA copy of one box into shared memory, completion on ``bar``
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; byte offsets
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator reads and writes across the
// asynchronous wgmma boundaries
template <int N>
__device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] . B[16 x 128], A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 192] += A[64 x 16] . B[16 x 192], A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] . B[16 x 256], A in registers, B in shared memory (MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, TcShape<D>::MIN_CTAS)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ o, int hq, int hkv, int sq,
                          int skv, int causal, int window, float scale_log2) {
  using C = TcShape<D>;
  constexpr int BK = C::BK;
  constexpr int DP = C::DP;
  static_assert(BK == 64, "S = Q K^T is one m64n64 wgmma per 16 dims");
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and the wgmma descriptors want 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + C::Q_BYTES;                    // [stage] K tiles
  const uint32_t v_s = k_s + C::STAGES * C::KV_BYTES;       // [stage] V tiles
  const uint32_t bars = v_s + C::STAGES * C::KV_BYTES;      // q, full[], empty[]
  const uint32_t q_bar = bars;
  auto full_bar = [&](int s) { return bars + 8u * (1 + s); };
  auto empty_bar = [&](int s) { return bars + 8u * (1 + C::STAGES + s); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kTcRows;  // heaviest q tiles first
  const int hk = h / (hq / hkv);
  const int off = skv - sq;

  // keys any row of this CTA may see: [kv_lo, kv_hi)
  const int q_lo = r0 + off;
  const int q_hi = min(r0 + kTcRows, sq) - 1 + off;
  const int kv_hi = causal ? min(skv, q_hi + 1) : skv;
  const int kv_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_first = kv_lo / BK;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi + BK - 1) / BK - t_first : 0;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_bar(s), 1);
      mbar_init(empty_bar(s), kTcWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues the copies: Q once, the first STAGES K/V tiles now,
  // and tile j + STAGES into tile j's slot once every warp has released it
  auto issue_kv = [&](int j) {
    const int s = j % C::STAGES;
    const int t0 = (t_first + j) * BK;
    mbar_expect_tx(full_bar(s), 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::NH; ++c) {
      tma_load_3d(k_s + s * C::KV_BYTES + c * BK * 128, &kmap, full_bar(s), c * 64, t0,
                  b * hkv + hk);
      tma_load_3d(v_s + s * C::KV_BYTES + c * BK * 128, &vmap, full_bar(s), c * 64, t0,
                  b * hkv + hk);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < C::NH; ++c)
      tma_load_3d(q_s + c * kTcRows * 128, &qmap, q_bar, c * 64, r0, b * hq + h);
    for (int j = 0; j < min(C::STAGES, n_tiles); ++j) issue_kv(j);
  }

  // ---- warpgroup wg owns q rows [r0 + 64 wg, r0 + 64 wg + 64) ----
  const int wg = warp / 4;
  const int quad = lane % 4;
  const int row_a = r0 + wg * 64 + (warp % 4) * 16 + lane / 4;  // and row_a + 8
  const int qpos_a = row_a + off;
  const int qpos_b = qpos_a + 8;
  const int w_lo = r0 + wg * 64 + off;                 // this warpgroup's qpos range
  const int w_hi = min(r0 + wg * 64 + 64, sq) - 1 + off;
  const bool w_rows = r0 + wg * 64 < sq;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_a = kNeg, m_b = kNeg, l_a = 0.f, l_b = 0.f;

  mbar_wait(q_bar, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % C::STAGES;
    const int t0 = (t_first + j) * BK;
    mbar_wait(full_bar(s), (j / C::STAGES) & 1);
    const bool dead = !w_rows || (causal && t0 > w_hi) ||
                      (window > 0 && w_lo - (t0 + BK - 1) >= window);
    // S = Q K^T: K-major operands, one k-step = 16 dims = 32 bytes of a row
    if (!dead) {
      float sc[BK / 2];
      reg_fence(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const uint32_t qa = q_s + (kk / 4) * kTcRows * 128 + wg * 64 * 128 + (kk % 4) * 32;
        const uint32_t ka = k_s + s * C::KV_BYTES + (kk / 4) * BK * 128 + (kk % 4) * 32;
        wgmma_ss_n64(sc, desc128(qa, 16, 1024), desc128(ka, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // online softmax on the fragment: sc[4i + e] is row (e < 2 ? a : b),
      // key t0 + 8 i + 2 quad + (e & 1)
      const bool need_mask = !(t0 + BK <= skv && (!causal || t0 + BK - 1 <= w_lo) &&
                               (window <= 0 || w_hi - t0 < window));
      float mx_a = kNeg, mx_b = kNeg;
      if (need_mask) {
#pragma unroll
        for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = t0 + 8 * i + 2 * quad + (e & 1);
            const int qp = e < 2 ? qpos_a : qpos_b;
            const bool ok = kpos < skv && (!causal || qp >= kpos) &&
                            (window <= 0 || qp - kpos < window);
            sc[4 * i + e] = ok ? sc[4 * i + e] * scale_log2 : kNeg;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] *= scale_log2;
      }
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, x));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, x));
      }
      const float mn_a = fmaxf(m_a, mx_a);
      const float mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f(m_a - mn_a);
      const float corr_b = exp2f(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = e < 2 ? mn_a : mn_b;
          // a masked score is kNeg exactly; its probability is 0, also in a
          // row whose every score so far is masked (mn == kNeg)
          const float p = sc[4 * i + e] == kNeg ? 0.f : exp2f(sc[4 * i + e] - mn);
          sc[4 * i + e] = p;
          if (e < 2) ps_a += p; else ps_b += p;
        }
      }
      l_a = l_a * corr_a + ps_a;   // this thread's share; the quad sums at the end
      l_b = l_b * corr_b + ps_b;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        acc[4 * i] *= corr_a;
        acc[4 * i + 1] *= corr_a;
        acc[4 * i + 2] *= corr_b;
        acc[4 * i + 3] *= corr_b;
      }

      // O += P V: P as wgmma's A from registers (bf16), V MN-major (one
      // k-step = 16 keys = two 8-row groups of 1024 bytes). All of P is
      // converted before the fence, so the products issue back to back.
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      }
      reg_fence(pa);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t va = v_s + s * C::KV_BYTES + kk * 16 * 128;
        wgmma_rs<DP>(acc, pa[kk], desc128(va, BK * 128, 1024));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty_bar(s));   // this warp is done with slot s
    if (threadIdx.x == 0 && j + C::STAGES < n_tiles) {
      mbar_wait(empty_bar(s), (j / C::STAGES) & 1);
      issue_kv(j + C::STAGES);
    }
  }

#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, x);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, x);
  }
  const float inv_a = 1.f / (l_a > 0.f ? l_a : 1.f);
  const float inv_b = 1.f / (l_b > 0.f ? l_b : 1.f);
  __nv_bfloat16* ob = o + ((long long)b * hq + h) * sq * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {   // the D real columns (D is a multiple of 8)
    const int col = 8 * i + 2 * quad;
    if (row_a < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)row_a * D + col) =
          __floats2bfloat162_rn(acc[4 * i] * inv_a, acc[4 * i + 1] * inv_a);
    if (row_a + 8 < sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (long long)(row_a + 8) * D + col) =
          __floats2bfloat162_rn(acc[4 * i + 2] * inv_b, acc[4 * i + 3] * inv_b);
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
  }
  return fn;
}

// tensor map over a contiguous bf16 [outer, rows, d] tensor, boxes of
// [1, box_rows, 64] with the 128-byte swizzle; rows past ``rows`` read as 0
bool make_map(CUtensorMap* map, const void* ptr, int outer, int rows, int d, int box_rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estrides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int b, int hq,
                      int hkv, int sq, int skv, int causal, int window, float scale,
                      cudaStream_t stream) {
  using C = TcShape<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map(&qmap, q, b * hq, sq, D, kTcRows) ||
      !make_map(&kmap, k, b * hkv, skv, D, C::BK) ||
      !make_map(&vmap, v, b * hkv, skv, D, C::BK))
    return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)hq, (unsigned)b, (unsigned)((sq + kTcRows - 1) / kTcRows));
  flash_attention_tc_kernel<D><<<grid, kTcThreads, C::SMEM, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, hq, hkv, sq, skv, causal, window,
      scale * kLog2e);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// SIMT body (f32 at any d, bf16 at d <= 32)
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int TPR>
__global__ void __launch_bounds__(kRows * TPR)
flash_attention_simt_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int hq,
                       int hkv, int sq, int skv, int causal, int window,
                       float scale) {
  constexpr int DS = D / TPR;               // dims a thread owns
  static_assert(DS % 4 == 0, "a thread's dims load as float4");
  // keys per shared-memory tile: K and V in f32 stay within 48 KB of static
  // shared memory (24 KB at d 192, 28 KB at d 224)
  constexpr int BK = D <= 64 ? 64 : (D <= 128 ? 32 : 16);
  constexpr int NT = kRows * TPR;
  __shared__ __align__(16) float sk[BK][D];
  __shared__ __align__(16) float sv[BK][D];

  const int tid = threadIdx.x;
  const int part = tid % TPR;
  const int r0 = blockIdx.x * kRows;
  const int row = r0 + tid / TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int off = skv - sq;
  const int qpos = row + off;

  const T* qrow = q + (((long long)b * hq + h) * sq + min(row, sq - 1)) * D + part * DS;
  const T* kb = k + ((long long)b * hkv + hk) * skv * D;
  const T* vb = v + ((long long)b * hkv + hk) * skv * D;

  float qr[DS];
  float acc[DS];
#pragma unroll
  for (int d = 0; d < DS; d += 4) {
    const float4 x = load4(qrow + d);
    qr[d] = x.x; qr[d + 1] = x.y; qr[d + 2] = x.z; qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m = kNeg;
  float l = 0.f;

  // keys any row of this tile may see: [kv_lo, kv_hi)
  const int last_qpos = min(r0 + kRows, sq) - 1 + off;
  const int kv_hi = causal ? min(skv, last_qpos + 1) : skv;
  const int kv_lo = window > 0 ? max(0, r0 + off - window + 1) : 0;

  for (int t0 = (kv_lo / BK) * BK; t0 < kv_hi; t0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < BK * D / 4; idx += NT) {
      const int r = idx / (D / 4);
      const int c = (idx % (D / 4)) * 4;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kk;
      if (t0 + r < skv) {
        kk = load4(kb + (long long)(t0 + r) * D + c);
        vv = load4(vb + (long long)(t0 + r) * D + c);
      }
      *reinterpret_cast<float4*>(&sk[r][c]) = kk;
      *reinterpret_cast<float4*>(&sv[r][c]) = vv;
    }
    __syncthreads();

    const int nk = min(BK, kv_hi - t0);
    for (int c0 = 0; c0 < nk; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) s[j] = 0.f;
#pragma unroll
      for (int d = 0; d < DS; d += 4) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          const float4 kk = *reinterpret_cast<const float4*>(&sk[c0 + j][part * DS + d]);
          s[j] = fmaf(qr[d], kk.x, s[j]);
          s[j] = fmaf(qr[d + 1], kk.y, s[j]);
          s[j] = fmaf(qr[d + 2], kk.z, s[j]);
          s[j] = fmaf(qr[d + 3], kk.w, s[j]);
        }
      }
      // the row's TPR threads are neighbouring lanes: sum their partial dots
#pragma unroll
      for (int x = 1; x < TPR; x <<= 1) {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], x);
      }
      float mc = kNeg;
      bool ok[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int kpos = t0 + c0 + j;
        ok[j] = kpos < skv && (!causal || qpos >= kpos) &&
                (window <= 0 || qpos - kpos < window);
        s[j] = ok[j] ? s[j] * scale : kNeg;
        mc = fmaxf(mc, s[j]);
      }
      const float m_new = fmaxf(m, mc);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = ok[j] ? expf(s[j] - m_new) : 0.f;
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < DS; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
#pragma unroll
        for (int d = 0; d < DS; d += 4) {
          const float4 vv = *reinterpret_cast<const float4*>(&sv[c0 + j][part * DS + d]);
          acc[d] = fmaf(s[j], vv.x, acc[d]);
          acc[d + 1] = fmaf(s[j], vv.y, acc[d + 1]);
          acc[d + 2] = fmaf(s[j], vv.z, acc[d + 2]);
          acc[d + 3] = fmaf(s[j], vv.w, acc[d + 3]);
        }
      }
      m = m_new;
    }
  }

  if (row < sq) {
    const float denom = l > 0.f ? l : 1.f;
    T* orow = o + (((long long)b * hq + h) * sq + row) * D + part * DS;
#pragma unroll
    for (int d = 0; d < DS; ++d) store1(orow + d, acc[d] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b,
                   int hq, int hkv, int sq, int skv, int causal, int window,
                   float scale, cudaStream_t stream) {
  // threads a query row (neighbouring lanes, so a power of two): a
  // thread's q slice and accumulator take 2 D / TPR registers, at most 128
  constexpr int TPR = D > 128 ? 4 : (D > 64 ? 2 : 1);
  const dim3 grid((unsigned)((sq + kRows - 1) / kRows), (unsigned)hq, (unsigned)b);
  flash_attention_simt_kernel<T, D, TPR><<<grid, kRows * TPR, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, hq, hkv, sq, skv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* k, const void* v, void* o,
                         int b, int hq, int hkv, int sq, int skv, int d,
                         int causal, int window, float scale, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 24: return launch<T, 24>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 120: return launch<T, 120>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 192: return launch<T, 192>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    case 224: return launch<T, 224>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike); window <= 0 means
// no sliding window. The caller guarantees b, hq, sq, skv >= 1, hq % hkv == 0,
// contiguous [B, H, S, d] tensors and 16-byte-aligned base pointers.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int b, int hq,
                                      int hkv, int sq, int skv, int d,
                                      int causal, int window, float scale,
                                      int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = launch_simt<float>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
  else if (dtype == 1 && d == 64)
    err = launch_tc<64>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
  else if (dtype == 1 && d == 120)
    err = launch_tc<120>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
  else if (dtype == 1 && d == 128)
    err = launch_tc<128>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
  else if (dtype == 1 && d == 192)
    err = launch_tc<192>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
  else if (dtype == 1 && d == 224)
    err = launch_tc<224>(q, k, v, o, b, hq, hkv, sq, skv, causal, window, scale, s);
  else if (dtype == 1)
    err = launch_simt<__nv_bfloat16>(q, k, v, o, b, hq, hkv, sq, skv, d, causal, window, scale, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

extern "C" const char* repro_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
