// The backward pass of banded (sliding-window) causal attention for Hopper
// (sm_90a) on bf16 tensor cores: dq, dk and dv of swa_attention_wgmma_fwd
// for bf16 inputs with D = 64 or 128, every band product on wgmma, the
// streamed tiles fed by TMA into a ring of shared-memory stages by a
// producer warp, two consumer warpgroups. float32 inputs, and bf16 at
// D = 256, stay on csrc/swa_attention_bwd.cu (float32 FMA).
//
// The TPU kernel src/repro/kernels/swa.py:swa_attention_pallas has no
// backward: the reference trains through XLA's autodiff of the model zoo's
// src/repro/models/attention.py:swa_attention, whose gradient is the flash
// backward under the band mask. It computes what csrc/swa_attention_bwd.cu
// computes, for query row r and key c of one (batch, head), query head h
// reading KV head h / G:
//
//     valid(r, c) = 0 <= r - c < window
//     s   = (q[r] * scale) . k[c]                  (valid pairs only)
//     lse = m + log(max(sum_c exp(s - m), 1e-30))  m the band max
//     p   = exp(s - lse), 0 where not valid
//     delta[r] = sum_d do[r] o[r]
//     dv[c] += p do[r];   dp = do[r] . v[c];   ds = p (dp - delta) scale
//     dq[r] += ds k[c];   dk[c] += ds q[r]
//
// Layout as the forward: q, o, do, dq (B, H, S, D); k, v, dk, dv (B, KV,
// S, D); any strides with a contiguous last dimension and 16-byte
// multiples elsewhere (the model's (B, S, H, D) activations are read in
// place through the TMA maps). lse and delta are float32 workspaces
// (B, H, S), contiguous.
//
// Numerics (what the one-ulp gate against the float32 plain backward
// rounded once needs; tests/test_torch_swa.py emulates this arithmetic):
//   * s = q.k and dp = do.v run on the raw bf16 operands (exact products,
//     float32 sums); the scale is applied to s afterwards in float32,
//     folded with log2(e): p = exp2(s c - lse log2(e)), c = scale log2(e);
//   * masked p are set to 0 after the exp; the row statistics use the
//     forward's finite NEG_INF = -1e30 and max(l, 1e-30);
//   * ds = p (dp - delta) in float32, without the scale;
//   * where p or ds is the A operand of a product it goes to the tensor
//     cores split in bf16 parts, each the rounding of what the ones before
//     leave (hi = bf16(x), lo = bf16(x - hi), ...), and every part is
//     issued: three for dv += p^T do and dk += ds^T q, two for dq += ds k.
//     One part (x rounded once) fails the gate on about a tenth of the
//     gradient it feeds; two carry ~16 bits, and dv or dk of a key that
//     the first rows see (p up to 1) summing to near 0 then misses the
//     gate's 1e-5 floor on some draws (the emulation finds them); dq, a
//     sum over a row's own keys, met the gate in two parts on every draw
//     tried, on the CPU and on the card;
//   * the tensor cores' float32 sums truncate: a dk or dv sum over ~16,900
//     rows (G 4 x the 4,096-row band, 3,168 wgmma steps) left 97 of dk's
//     and 135 of dv's 33.5 M elements outside the gate at the training
//     path's shape on an H100. dkdv therefore adds its sums into a
//     float32 workspace (round-to-nearest, on the CUDA cores) after each
//     head's diagonal tile (a key's first rows) and every FLUSH = 16
//     tiles, and restarts them from 0: no element outside the gate there
//     at 16 or 32, 6 at 66 (dkdv 15.9, 14.9 and 14.1 ms);
//   * dk and dq take the scale once, at the end, in float32; every output
//     is rounded once to bf16.
//
// Design. Three launches, no atomics, so two calls give the same bits. In
// each, warpgroups 0 and 1 consume and warpgroup 2 produces: one of its
// threads issues every TMA load (setmaxnreg gives the consumers 240
// registers and the producer 24). Tiles are 64-column boxes with the
// 128-byte swizzle, as the wgmma descriptors read them; a D = 128 row is
// two boxes. A tile that holds no in-band pair of a warpgroup's rows is
// skipped by that warpgroup; one that holds some gives the others p = 0.
//   1. stats: one CTA per (b, h, 128 query rows), the forward's skeleton
//      without V: the Q tile once, then the 128-key K tiles of the band
//      (three stages); S = Q K^T as D/16 wgmma m64n128k16 and the
//      forward's online max and sum; writes lse, and delta from the rows
//      of o and do read by the consumer threads.
//   2. dkdv: one CTA per (b, KV head, 128 keys), each consumer warpgroup
//      64 keys, K and V resident in shared memory. It walks the G query
//      heads of its group in order and, for each, the 64-row query tiles
//      whose band covers its keys in order (the FMA kernel's order): the
//      producer streams Q, dO and the rows' lse and delta (a bulk copy)
//      into three stages. Per tile: S^T = K Q^T and dP^T = V dO^T as wgmma
//      m64n64k16 (K and Q, V and dO K-major from shared memory); P^T and
//      dS^T on the accumulator layout with keys as rows; then dv += P^T dO
//      and dk += dS^T Q as register-A wgmma m64nDk16, dO and Q read
//      MN-major through the descriptor's transpose bit. dk and dv stay in
//      registers, D/2 + D/2 floats a thread, and go to the thread's own
//      float32 workspace (D floats) at each flush.
//   3. dq: one CTA per (b, h, 128 query rows), Q and dO resident, the
//      producer streaming 64-key K and V tiles into three stages. Per
//      tile: S = Q K^T and dP = dO V^T (m64n64k16), dS, then dq += dS K as
//      register-A wgmma with K MN-major.
// Registers a consumer thread at D = 128: dkdv holds dk and dv (128), S^T
// and dP^T (64), then P's parts (48) as P dies, and dS's parts (48) once
// dv's product is done (waiting for it there spilled less and ran faster
// on an H100, 13.6-14.1 against 15.3-15.7 ms at the training path's
// shape, than splitting dS while it runs); dq holds dq (64), S and dP
// (64), dS's parts (32).
// Shared memory at D = 128: stats 32 KB of Q + 3 x 32 KB of K; dkdv 64 KB
// of K and V + 3 x (32 KB of Q and dO + 512 bytes of lse and delta); dq
// 64 KB of Q and dO + 3 x 32 KB of K and V.
//
// What bounds it on this card. At the training path's shape (B 2, H 32,
// KV 8, S 16384, window 4096, D 128) the band holds 0.962 TFLOP a
// product; the backward's five band products (s, dp, dv, dq, dk) are 4.81
// TFLOP, 4.864 ms at the dense bf16 rate: operations, not the 1.35 GB of
// q, k, v, o, do, the gradients and the workspaces. This design issues
// thirteen band products (stats: s; dkdv: s, dp, dv and dk three times
// each; dq: s, dp, dq twice), 12.6 ms at the dense rate; the exp, the
// splits, the masks and the flushes run on the CUDA cores while the other
// warpgroup's products run.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NCONSUMER_WARPS = 8;
constexpr int NTH = 384;            // 2 consumer warpgroups + 1 producer
constexpr int STAGES = 3;
// bf16 parts of each A operand that is not an input (see Numerics)
constexpr int DKDV_PARTS = 3;       // P for dv, dS for dk
constexpr int DQ_PARTS = 2;         // dS for dq
// dkdv adds its wgmma sums into a float32 workspace after each diagonal
// tile and every FLUSH tiles (see Numerics)
constexpr int FLUSH = 16;
constexpr float NEG_INF = -1e30f;
constexpr double LOG2E_D = 1.4426950408889634;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* o;           // stats: delta's inputs
  const __nv_bfloat16* dout;
  int64_t ob, oh, os, db, dh, ds;
  float* lse;                       // (B, H, S) float32, contiguous
  float* delta;
  float4* work;                     // dkdv: D / 4 float4 a consumer thread
  __nv_bfloat16* g0;                // dq (dq) or dk (dkdv)
  __nv_bfloat16* g1;                // dv (dkdv)
  int64_t g0b, g0h, g0s, g1b, g1h, g1s;
  int KV, G, S, window;
  float c;                          // scale * log2(e)
  float scale;
};

// Shared memory of the three launches: tiles of `rows` x 64 bf16 columns
// (128-byte rows, 128-byte swizzle, one TMA box each), D / 64 of them a
// row block, then the barriers.
template <int D>
struct Layout {
  static constexpr int HALVES = D / 64;
  static constexpr int H128 = 128 * 128;   // one 64-column half of 128 rows
  static constexpr int H64 = 64 * 128;     // of 64 rows
  static constexpr int T128 = HALVES * H128;
  static constexpr int T64 = HALVES * H64;
  // stats: Q (128 rows), STAGES x K (128 keys); full_q, full, empty
  static constexpr int STATS_BAR = T128 + STAGES * T128;
  static constexpr int STATS = STATS_BAR + 8 * (1 + 2 * STAGES);
  // dkdv: K, V (128 keys), STAGES x (Q, dO) (64 rows), STAGES x (lse,
  // delta) (64 floats each); full_kv, full, empty
  static constexpr int DKDV_STAGE = 2 * T128;
  static constexpr int DKDV_ROWS = DKDV_STAGE + STAGES * 2 * T64;
  static constexpr int DKDV_BAR = DKDV_ROWS + STAGES * 2 * 64 * 4;
  static constexpr int DKDV = DKDV_BAR + 8 * (1 + 2 * STAGES);
  // dq: Q, dO (128 rows), STAGES x (K, V) (64 keys); full_q, full, empty
  static constexpr int DQ_STAGE = 2 * T128;
  static constexpr int DQ_BAR = DQ_STAGE + STAGES * 2 * T64;
  static constexpr int DQ = DQ_BAR + 8 * (1 + 2 * STAGES);
  static constexpr int alloc(int which) {      // + room to align to 1 KB
    return (which == 0 ? STATS : which == 1 ? DKDV : DQ) + 1024;
  }
  static_assert(DKDV + 1024 <= 232448 && DQ + 1024 <= 232448 &&
                    STATS + 1024 <= 232448,
                "over a CTA's 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void init_barriers(uint32_t bars) {
  if (threadIdx.x == 0) {
    mbar_init(bars, 1);                               // the resident tiles
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * (1 + s), 1);               // full
      mbar_init(bars + 8 * (1 + STAGES + s), NCONSUMER_WARPS);   // empty
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---- TMA ------------------------------------------------------------------
// One box of the 4-d map (D, S, heads, B) at element coordinates
// (c0, c1, c2, c3) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The D / 64 boxes of `rows` rows that make one row block of a tile.
template <int D>
__device__ __forceinline__ void tma_rows(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row, int head,
                                         int b, int half_bytes) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
    tma_load(dst + hf * half_bytes, map, bar, hf * 64, row, head, b);
}

// `bytes` contiguous bytes of global memory (16-byte aligned, a multiple
// of 16) into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle. Byte offsets: `lbo`
// between 64-element atoms along the contiguous dimension (MN-major
// operands; unused for K-major), `sbo` between groups of 8 rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
       | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are pending.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

template <int P, int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[P][M][N]) {
#pragma unroll
  for (int h = 0; h < P; ++h)
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        asm volatile("" : "+r"(a[h][i][j]) :: "memory");
}

// d (64 x N, float32) (+)= A (64 x 16) B (16 x N); A and B K-major in
// shared memory; scale_d = 0 overwrites d.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db,
                         int scale_d);

// d (64 x N) += A (64 x 16, bf16 in registers) B (16 x N); B MN-major in
// shared memory (the transpose bit).
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x N) = A B^T over D: A's 64 rows at a_addr and B's N rows at
// b_addr, both K-major, their 64-column halves a_half and b_half bytes
// apart. Not committed.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&d)[N / 2], uint32_t a_addr,
                                         uint32_t a_half, uint32_t b_addr,
                                         uint32_t b_half) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;   // 16 columns into the half
    wgmma_ss<N>(d, desc(a_addr + (kk >> 2) * a_half + off, 16, 1024),
                desc(b_addr + (kk >> 2) * b_half + off, 16, 1024), kk > 0);
  }
}

// d (64 x D) += (sum of the parts) B: A (64 x K) in registers as PARTS
// bf16 parts, B's K rows at b_addr MN-major (16 rows, two 8-row groups 1
// KB apart, a step), its 64-column halves b_half bytes apart. Not
// committed.
template <int D, int K, int PARTS>
__device__ __forceinline__ void issue_rs(
    float (&d)[D / 2], const uint32_t (&a)[PARTS][K / 16][4],
    uint32_t b_addr, uint32_t b_half) {
#pragma unroll
  for (int part = 0; part < PARTS; ++part)
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      wgmma_rs<D>(d, a[part][kk], desc(b_addr + kk * 2048, b_half, 1024));
}

// ---- the accumulator layout -------------------------------------------
// Thread (warp w of its warpgroup, lane) holds rows 16 w + lane / 4 (half
// 0) and that + 8 (half 1) of the warpgroup's 64; register j of a 64 x N
// accumulator is at row half (j / 2) % 2, column 8 (j / 4) + 2 (lane % 4)
// + j % 2. A row lives in the 4 threads of a quad. The accumulator layout
// of a 64 x N product is the register-A layout of a 64 x N operand: k-step
// kk's four registers pack registers 8 kk + 2 i and 8 kk + 2 i + 1.

__device__ __forceinline__ int col_of(int j) {
  return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
}

__device__ __forceinline__ bool in_band(int rel, int window) {
  return rel >= 0 && rel < window;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (64 x N, float32 accumulator) as register A operands split in PARTS
// bf16 parts, each the rounding of what the ones before leave: hi =
// bf16(x), lo = bf16(x - hi) (two parts), then bf16(x - hi - lo) (three);
// each difference is exact in float32.
template <int N, int PARTS>
__device__ __forceinline__ void split(const float (&x)[N / 2],
                                      uint32_t (&a)[PARTS][N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x0 = x[8 * kk + 2 * i], x1 = x[8 * kk + 2 * i + 1];
#pragma unroll
      for (int part = 0; part < PARTS; ++part) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        a[part][kk][i] = bf16x2_bits(h);
        x0 -= hf.x;
        x1 -= hf.y;
      }
    }
}

// acc (64 x D) times `mul`, rounded once to bf16, to rows `row` and
// row + 8 of `base` (row stride rs).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* base, int64_t rs,
                                           int row, float mul) {
  __nv_bfloat16* out = base + 2 * (threadIdx.x & 3);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    __nv_bfloat16* orow = out + static_cast<int64_t>(row + 8 * hf) * rs;
#pragma unroll
    for (int c8 = 0; c8 < D / 8; ++c8)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c8) =
          __floats2bfloat162_rn(acc[4 * c8 + 2 * hf] * mul,
                                acc[4 * c8 + 2 * hf + 1] * mul);
  }
}

// The producer's ring position.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next() {
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// ---------------------------------------------------------------------------
// 1. row statistics: lse over the band, delta = sum do * o
// ---------------------------------------------------------------------------
// One key tile of the online max and sum (no p is kept): s -> m, l.
template <bool MASK>
__device__ __forceinline__ void stats_tile(float (&s)[64], float (&m)[2],
                                           float (&l)[2], float c, int rel0,
                                           int window) {
  // rel0 = row of half 0 - column of register 0
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int hf = (j >> 1) & 1;
    if (MASK && !in_band(rel0 + 8 * hf - 8 * (j >> 2) - (j & 1), window))
      s[j] = NEG_INF;
    mx[hf] = fmaxf(mx[hf], s[j]);
  }
  float mc[2], alpha[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    const float m_new = fmaxf(m[hf], mx[hf]);
    alpha[hf] = exp2f((m[hf] - m_new) * c);
    mc[hf] = m_new * c;
    m[hf] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const int hf = (j >> 1) & 1;
    float p = exp2f(fmaf(s[j], c, -mc[hf]));
    if (MASK && !in_band(rel0 + 8 * hf - 8 * (j >> 2) - (j & 1), window))
      p = 0.f;
    sum[hf] += p;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + sum[hf];
}

template <int D>
__global__ void __launch_bounds__(NTH, 1)
swa_bwd_stats_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const Params p) {
  using L = Layout<D>;
  constexpr int BQ = 128, BK = 128;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  auto sk = [&](int s) { return base + L::T128 + s * L::T128; };
  const uint32_t bars = base + L::STATS_BAR;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  // CTA -> (b, KV head, query tile, query head), as the forward
  const int nq = p.S / BQ;
  const int g = blockIdx.x % p.G;
  const int t = blockIdx.x / p.G;
  const int qt = nq - 1 - t % nq;
  const int bkv = t / nq;
  const int b = bkv / p.KV, kh = bkv % p.KV, h = kh * p.G + g;
  const int64_t bh = static_cast<int64_t>(b) * p.KV * p.G + h;
  const int q0 = qt * BQ;
  const int kt_first = max(0, q0 - p.window + 1) / BK;
  const int kt_last = (q0 + BQ - 1) / BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  init_barriers(bars);

  if (warp >= NCONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NCONSUMER_WARPS * 32) {
      mbar_expect_tx(bars, L::T128);
      tma_rows<D>(sq, &tq, bars, q0, h, b, L::H128);
      Ring r;
      for (int kt = kt_first; kt <= kt_last; ++kt, r.next()) {
        mbar_wait(empty(r.stage), r.phase ^ 1);
        mbar_expect_tx(full(r.stage), L::T128);
        tma_rows<D>(sk(r.stage), &tk, full(r.stage), kt * BK, kh, b, L::H128);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp >> 2;
  const int r0 = q0 + 64 * wg;                    // first row of the group
  const int row = r0 + 16 * (warp & 3) + (lane >> 2);   // half 0's row

  // delta of the group's 64 rows: two threads a row, D / 2 columns each
  {
    const int tw = tid & 127, rr = r0 + (tw >> 1), c0 = (tw & 1) * (D / 2);
    const __nv_bfloat16* orow = p.o + b * p.ob + h * p.oh + rr * p.os + c0;
    const __nv_bfloat16* drow =
        p.dout + b * p.db + h * p.dh + rr * p.ds + c0;
    float part = 0.f;
#pragma unroll
    for (int c8 = 0; c8 < D / 16; ++c8) {
      const uint4 a = *reinterpret_cast<const uint4*>(orow + 8 * c8);
      const uint4 d = *reinterpret_cast<const uint4*>(drow + 8 * c8);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(a2[i]), y = __bfloat1622float2(d2[i]);
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if ((tw & 1) == 0) p.delta[bh * p.S + rr] = part;
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  mbar_wait(bars, 0);
  Ring r;
  for (int kt = kt_first; kt <= kt_last; ++kt, r.next()) {
    const int k0 = kt * BK;
    mbar_wait(full(r.stage), r.phase);
    // any in-band pair between rows [r0, r0 + 63] and keys [k0, k0 + BK)?
    const int hi_rel = r0 + 63 - k0, lo_rel = r0 - (k0 + BK - 1);
    if (hi_rel < 0 || lo_rel >= p.window) {
      if (lane == 0) mbar_arrive(empty(r.stage));
      continue;
    }
    float s[BK / 2];
    wg_fence();
    issue_ss<D, BK>(s, sq + 64 * 128 * wg, L::H128, sk(r.stage), L::H128);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(empty(r.stage));
    const int rel0 = row - (k0 + 2 * (lane & 3));
    if (lo_rel < 0 || hi_rel >= p.window)
      stats_tile<true>(s, m, l, p.c, rel0, p.window);
    else
      stats_tile<false>(s, m, l, p.c, rel0, p.window);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
    l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    if ((lane & 3) == 0)
      p.lse[bh * p.S + row + 8 * hf] =
          m[hf] * p.scale + logf(fmaxf(l[hf], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv: one CTA per (b, KV head, 128 keys)
// ---------------------------------------------------------------------------
// P^T and dS^T of one (64 keys, 64 query rows) tile in place: s holds S^T
// (raw q.k) and becomes P^T, dp holds dP^T and becomes dS^T. Keys are
// rows, query rows columns; rel0 = query row of column 0 - this thread's
// half-0 key; lse and delta are the tile's 64 rows in shared memory.
template <bool MASK>
__device__ __forceinline__ void probs_t(float (&s)[32], float (&dp)[32],
                                        const float* lse, const float* delta,
                                        float c, int rel0, int window) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = col_of(j), hf = (j >> 1) & 1;
    float pv = exp2f(fmaf(s[j], c, -lse[col] * LOG2E));
    if (MASK && !in_band(rel0 + col - 8 * hf, window)) pv = 0.f;
    s[j] = pv;
    dp[j] = pv * (dp[j] - delta[col]);
  }
}

// dk and dv of a consumer thread added into its float32 workspace (`w`:
// the thread's first float4, the next D / 4 a stride of 256 float4 apart,
// so a warp's accesses are contiguous), round-to-nearest, and set to 0; the
// workspace's first use stores.
template <int D>
__device__ __forceinline__ void flush(float (&dk)[D / 2], float (&dv)[D / 2],
                                      float4* w, bool first) {
#pragma unroll
  for (int j4 = 0; j4 < D / 4; ++j4) {
    float* acc = j4 < D / 8 ? dk + 4 * j4 : dv + 4 * (j4 - D / 8);
    float4 a = first ? make_float4(0.f, 0.f, 0.f, 0.f) : w[256 * j4];
    a.x += acc[0];
    a.y += acc[1];
    a.z += acc[2];
    a.w += acc[3];
    w[256 * j4] = a;
    acc[0] = acc[1] = acc[2] = acc[3] = 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(NTH, 1)
swa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tdo,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const Params p) {
  using L = Layout<D>;
  constexpr int BK = 128, BQ = 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t sk = base, sv = base + L::T128;
  // stage s: Q tile at sq(s), dO tile at sq(s) + T64; lse, delta at
  // rows(s) (byte offsets from base)
  auto sq = [&](int s) { return base + L::DKDV_STAGE + s * 2 * L::T64; };
  auto rows = [&](int s) { return L::DKDV_ROWS + s * 2 * BQ * 4; };
  const uint32_t bars = base + L::DKDV_BAR;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  // CTA -> (b, KV head, key tile), the key tiles of one KV head in order:
  // the tail's short tiles (rows end at S) run last
  const int nk = p.S / BK;
  const int kt = blockIdx.x % nk, bkv = blockIdx.x / nk;
  const int b = bkv / p.KV, kh = bkv % p.KV;
  const int k0 = kt * BK;
  // query rows that see a key of the tile: k0 .. k0 + BK - 2 + window
  const int ntiles = (min(p.S, k0 + BK - 1 + p.window) - k0 + BQ - 1) / BQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  init_barriers(bars);

  if (warp >= NCONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NCONSUMER_WARPS * 32) {
      mbar_expect_tx(bars, 2 * L::T128);
      tma_rows<D>(sk, &tk, bars, k0, kh, b, L::H128);
      tma_rows<D>(sv, &tv, bars, k0, kh, b, L::H128);
      Ring r;
      for (int g = 0; g < p.G; ++g) {
        const int h = kh * p.G + g;
        const int64_t bh = static_cast<int64_t>(b) * p.KV * p.G + h;
        for (int t = 0; t < ntiles; ++t, r.next()) {
          const int q0 = k0 + t * BQ;
          mbar_wait(empty(r.stage), r.phase ^ 1);
          const uint32_t f = full(r.stage), dst = sq(r.stage);
          mbar_expect_tx(f, 2 * L::T64 + 2 * BQ * 4);
          tma_rows<D>(dst, &tq, f, q0, h, b, L::H64);
          tma_rows<D>(dst + L::T64, &tdo, f, q0, h, b, L::H64);
          bulk_load(base + rows(r.stage), p.lse + bh * p.S + q0, BQ * 4, f);
          bulk_load(base + rows(r.stage) + BQ * 4, p.delta + bh * p.S + q0,
                    BQ * 4, f);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp >> 2;
  const int c0 = k0 + 64 * wg;                    // first key of the group
  const int key = c0 + 16 * (warp & 3) + (lane >> 2);   // half 0's key
  const uint32_t sk_wg = sk + 64 * 128 * wg, sv_wg = sv + 64 * 128 * wg;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) {
    dk[j] = 0.f;
    dv[j] = 0.f;
  }
  float4* work = p.work + static_cast<int64_t>(blockIdx.x) * (D / 4) * 256 +
                 tid;
  int chain = 0, flushes = 0;      // tiles summed in dk, dv since a flush
  mbar_wait(bars, 0);
  Ring r;
  for (int g = 0; g < p.G; ++g) {
    for (int t = 0; t < ntiles; ++t, r.next()) {
      const int q0 = k0 + t * BQ;
      mbar_wait(full(r.stage), r.phase);
      // any in-band pair between keys [c0, c0 + 63] and rows [q0, q0 + 63]?
      const int hi_rel = q0 + BQ - 1 - c0, lo_rel = q0 - (c0 + 63);
      if (hi_rel >= 0 && lo_rel < p.window) {
        const uint32_t sq_t = sq(r.stage), sdo_t = sq_t + L::T64;
        float s[BQ / 2], dp[BQ / 2];
        fence_regs(dk);
        fence_regs(dv);
        wg_fence();
        issue_ss<D, BQ>(s, sk_wg, L::H128, sq_t, L::H64);      // S^T
        issue_ss<D, BQ>(dp, sv_wg, L::H128, sdo_t, L::H64);    // dP^T
        wg_commit();
        wg_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        const float* lse = reinterpret_cast<const float*>(gbase + rows(r.stage));
        if (lo_rel < 0 || hi_rel >= p.window)
          probs_t<true>(s, dp, lse, lse + BQ, p.c, q0 - key, p.window);
        else
          probs_t<false>(s, dp, lse, lse + BQ, p.c, q0 - key, p.window);
        uint32_t pp[DKDV_PARTS][BQ / 16][4];
        split<BQ, DKDV_PARTS>(s, pp);
        fence_regs(pp);
        wg_fence();
        issue_rs<D, BQ, DKDV_PARTS>(dv, pp, sdo_t, L::H64);    // dv += P^T dO
        wg_commit();
        // P's parts free their registers before dS is split
        wg_wait<0>();
        fence_regs(dv);
        uint32_t dsp[DKDV_PARTS][BQ / 16][4];
        split<BQ, DKDV_PARTS>(dp, dsp);
        fence_regs(dsp);
        wg_fence();
        issue_rs<D, BQ, DKDV_PARTS>(dk, dsp, sq_t, L::H64);    // dk += dS^T Q
        wg_commit();
        wg_wait<0>();
        fence_regs(dk);
        fence_regs(dv);
        // after the diagonal tile (a key's first rows, often its largest
        // p) and every FLUSH tiles
        if (++chain == FLUSH || lo_rel < 0) {
          flush<D>(dk, dv, work, flushes++ == 0);
          chain = 0;
        }
      }
      if (lane == 0) mbar_arrive(empty(r.stage));
    }
  }
  if (flushes > 0) {               // the last partial sums + the flushed
#pragma unroll
    for (int j4 = 0; j4 < D / 4; ++j4) {
      const float4 a = work[256 * j4];
      float* acc = j4 < D / 8 ? dk + 4 * j4 : dv + 4 * (j4 - D / 8);
      acc[0] += a.x;
      acc[1] += a.y;
      acc[2] += a.z;
      acc[3] += a.w;
    }
  }
  store_rows<D>(dk, p.g0 + b * p.g0b + kh * p.g0h, p.g0s, key, p.scale);
  store_rows<D>(dv, p.g1 + b * p.g1b + kh * p.g1h, p.g1s, key, 1.f);
}

// ---------------------------------------------------------------------------
// 3. dq: one CTA per (b, h, 128 query rows)
// ---------------------------------------------------------------------------
// dS of one (64 rows, 64 keys) tile in place: s holds S (raw q.k), dp
// holds dP and becomes dS; rel0 = this thread's half-0 row - key of
// column 0.
template <bool MASK>
__device__ __forceinline__ void probs(const float (&s)[32], float (&dp)[32],
                                      const float (&lse2)[2],
                                      const float (&delta)[2], float c,
                                      int rel0, int window) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int hf = (j >> 1) & 1;
    float pv = exp2f(fmaf(s[j], c, -lse2[hf]));
    if (MASK && !in_band(rel0 + 8 * hf - col_of(j), window)) pv = 0.f;
    dp[j] = pv * (dp[j] - delta[hf]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTH, 1)
swa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const Params p) {
  using L = Layout<D>;
  constexpr int BQ = 128, BK = 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base, sdo = base + L::T128;
  // stage s: K tile at sk(s), V tile at sk(s) + T64
  auto sk = [&](int s) { return base + L::DQ_STAGE + s * 2 * L::T64; };
  const uint32_t bars = base + L::DQ_BAR;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + STAGES + s); };

  const int nq = p.S / BQ;
  const int g = blockIdx.x % p.G;
  const int t = blockIdx.x / p.G;
  const int qt = nq - 1 - t % nq;
  const int bkv = t / nq;
  const int b = bkv / p.KV, kh = bkv % p.KV, h = kh * p.G + g;
  const int64_t bh = static_cast<int64_t>(b) * p.KV * p.G + h;
  const int q0 = qt * BQ;
  const int kt_first = max(0, q0 - p.window + 1) / BK;
  const int kt_last = (q0 + BQ - 1) / BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  init_barriers(bars);

  if (warp >= NCONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NCONSUMER_WARPS * 32) {
      mbar_expect_tx(bars, 2 * L::T128);
      tma_rows<D>(sq, &tq, bars, q0, h, b, L::H128);
      tma_rows<D>(sdo, &tdo, bars, q0, h, b, L::H128);
      Ring r;
      for (int kt = kt_first; kt <= kt_last; ++kt, r.next()) {
        mbar_wait(empty(r.stage), r.phase ^ 1);
        const uint32_t f = full(r.stage), dst = sk(r.stage);
        mbar_expect_tx(f, 2 * L::T64);
        tma_rows<D>(dst, &tk, f, kt * BK, kh, b, L::H64);
        tma_rows<D>(dst + L::T64, &tv, f, kt * BK, kh, b, L::H64);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = warp >> 2;
  const int r0 = q0 + 64 * wg;
  const int row = r0 + 16 * (warp & 3) + (lane >> 2);
  const uint32_t sq_wg = sq + 64 * 128 * wg, sdo_wg = sdo + 64 * 128 * wg;
  float lse2[2], delta[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    lse2[hf] = p.lse[bh * p.S + row + 8 * hf] * LOG2E;
    delta[hf] = p.delta[bh * p.S + row + 8 * hf];
  }

  float dq[D / 2];
#pragma unroll
  for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
  mbar_wait(bars, 0);
  Ring r;
  for (int kt = kt_first; kt <= kt_last; ++kt, r.next()) {
    const int k0 = kt * BK;
    mbar_wait(full(r.stage), r.phase);
    const int hi_rel = r0 + 63 - k0, lo_rel = r0 - (k0 + BK - 1);
    if (hi_rel >= 0 && lo_rel < p.window) {
      const uint32_t sk_t = sk(r.stage), sv_t = sk_t + L::T64;
      float s[BK / 2], dp[BK / 2];
      fence_regs(dq);
      wg_fence();
      issue_ss<D, BK>(s, sq_wg, L::H128, sk_t, L::H64);      // S
      issue_ss<D, BK>(dp, sdo_wg, L::H128, sv_t, L::H64);    // dP
      wg_commit();
      wg_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (lo_rel < 0 || hi_rel >= p.window)
        probs<true>(s, dp, lse2, delta, p.c, row - k0, p.window);
      else
        probs<false>(s, dp, lse2, delta, p.c, row - k0, p.window);
      uint32_t dsp[DQ_PARTS][BK / 16][4];
      split<BK, DQ_PARTS>(dp, dsp);
      fence_regs(dsp);
      wg_fence();
      issue_rs<D, BK, DQ_PARTS>(dq, dsp, sk_t, L::H64);      // dq += dS K
      wg_commit();
      wg_wait<0>();
      fence_regs(dq);
    }
    if (lane == 0) mbar_arrive(empty(r.stage));
  }
  store_rows<D>(dq, p.g0 + b * p.g0b + h * p.g0h, p.g0s, row, p.scale);
}

// ---- host side --------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime, so the library
// needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-d map (D, S, heads, B) over a bf16 tensor with element strides
// (sb, sh, ss, 1), boxes of 64 columns x `rows` rows, 128-byte swizzle.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
                  int S, int heads, int B, const int64_t* st, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Element strides (batch, head, row) of the eight tensors, in the order
// q, k, v, o, do, dq, dk, dv.
enum { TQ, TK, TV, TO, TDO, TDQ, TDK, TDV };

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta, *work;
  int B, H, KV, S, window;
  const int64_t* st;              // 24 strides, 3 a tensor
  cudaStream_t stream;
};

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The TMA maps and the launch of entry `which` (0 stats, 1 dkdv, 2 dq), or
// -(1000 + CUresult) when the driver refuses a map.
template <int D>
int launch(int which, EncodeTiled enc, const Args& a, const Params& p) {
  // rows a box of q/do and of k/v
  const int qrows = which == 1 ? 64 : 128, krows = which == 2 ? 64 : 128;
  CUtensorMap tq, tdo, tk, tv;
  CUresult r = make_map(enc, &tq, a.q, D, a.S, a.H, a.B, a.st + 3 * TQ, qrows);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &tk, a.k, D, a.S, a.KV, a.B, a.st + 3 * TK, krows);
  if (r == CUDA_SUCCESS && which != 0)
    r = make_map(enc, &tdo, a.dout, D, a.S, a.H, a.B, a.st + 3 * TDO, qrows);
  if (r == CUDA_SUCCESS && which != 0)
    r = make_map(enc, &tv, a.v, D, a.S, a.KV, a.B, a.st + 3 * TV, krows);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  const int bytes = Layout<D>::alloc(which);
  cudaError_t err;
  if (which == 0) {
    auto kern = swa_bwd_stats_wgmma_kernel<D>;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<(a.S / 128) * a.B * a.H, NTH, bytes, a.stream>>>(tq, tk, p);
  } else if (which == 1) {
    auto kern = swa_bwd_dkdv_wgmma_kernel<D>;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<(a.S / 128) * a.B * a.KV, NTH, bytes, a.stream>>>(tq, tdo, tk, tv,
                                                             p);
  } else {
    auto kern = swa_bwd_dq_wgmma_kernel<D>;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<(a.S / 128) * a.B * a.H, NTH, bytes, a.stream>>>(tq, tdo, tk, tv,
                                                            p);
  }
  return cudaGetLastError();
}

int run(int which, const Args& a, int D, float scale) {
  if (a.B <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.S <= 0 ||
      a.S % 128 != 0 || a.window <= 0 || (D != 64 && D != 128) ||
      static_cast<int64_t>(a.B) * a.H * (a.S / 128) > 0x7fffffff)
    return cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  Params p;
  p.o = static_cast<const __nv_bfloat16*>(a.o);
  p.dout = static_cast<const __nv_bfloat16*>(a.dout);
  p.ob = a.st[3 * TO];
  p.oh = a.st[3 * TO + 1];
  p.os = a.st[3 * TO + 2];
  p.db = a.st[3 * TDO];
  p.dh = a.st[3 * TDO + 1];
  p.ds = a.st[3 * TDO + 2];
  p.lse = a.lse;
  p.delta = a.delta;
  p.work = reinterpret_cast<float4*>(a.work);
  const int g0 = which == 2 ? TDQ : TDK;
  p.g0 = static_cast<__nv_bfloat16*>(which == 2 ? a.dq : a.dk);
  p.g1 = static_cast<__nv_bfloat16*>(a.dv);
  p.g0b = a.st[3 * g0];
  p.g0h = a.st[3 * g0 + 1];
  p.g0s = a.st[3 * g0 + 2];
  p.g1b = a.st[3 * TDV];
  p.g1h = a.st[3 * TDV + 1];
  p.g1s = a.st[3 * TDV + 2];
  p.KV = a.KV;
  p.G = a.H / a.KV;
  p.S = a.S;
  p.window = a.window;
  p.c = static_cast<float>(static_cast<double>(scale) * LOG2E_D);
  p.scale = scale;
  return D == 64 ? launch<64>(which, enc, a, p)
                 : launch<128>(which, enc, a, p);
}

}  // namespace

// C entry points, bound with ctypes; all three take the same arguments and
// each reads the ones it needs. bf16 q, k, v, o, do, dq, dk, dv; D 64 or
// 128; S a multiple of 128; H a multiple of KV; `strides` holds 24 element
// strides, (batch, head, row) of q, k, v, o, do, dq, dk, dv, whose last
// dimension is contiguous and the others and every base address 16-byte
// multiples; lse and delta are contiguous float32 (B, H, S); `work` is
// dkdv's float32 workspace of B * KV * S * 2 * D elements, 16-byte aligned
// (the other two do not read it). Each returns 0
// on success, a cudaError_t for a refused launch, -1 when the driver has
// no cuTensorMapEncodeTiled, or -(1000 + CUresult) when it refuses a map;
// launches are asynchronous, on `stream`.
#define SWA_BWD_WGMMA_ENTRY(name, which)                                      \
  extern "C" int name(const void* q, const void* k, const void* v,            \
                      const void* o, const void* dout, void* dq, void* dk,    \
                      void* dv, float* lse, float* delta, float* work, int B, \
                      int H, int KV, int S, int D, int window, float scale,   \
                      const int64_t* strides, void* stream) {                 \
    const Args a{q,     k,    v, o, dout, dq,     dk,      dv, lse,        \
                 delta, work, B, H, KV,   S,  window, strides,                \
                 static_cast<cudaStream_t>(stream)};                          \
    return run(which, a, D, scale);                                           \
  }

SWA_BWD_WGMMA_ENTRY(swa_attention_bwd_wgmma_stats, 0)
SWA_BWD_WGMMA_ENTRY(swa_attention_bwd_wgmma_dkdv, 1)
SWA_BWD_WGMMA_ENTRY(swa_attention_bwd_wgmma_dq, 2)

// Dynamic shared memory of each launch (0 stats, 1 dkdv, 2 dq) at head dim
// D (bytes), or -1 for a D the kernels do not take.
extern "C" int swa_attention_bwd_wgmma_smem(int which, int D) {
  return D == 64 ? Layout<64>::alloc(which)
         : D == 128 ? Layout<128>::alloc(which)
                    : -1;
}
