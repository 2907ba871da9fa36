// Banded (sliding-window) causal flash attention for Hopper (sm_90a) on
// bf16 tensor cores: wgmma for both products, K/V fed by TMA into a ring of
// shared-memory stages by a producer warp, two consumer warpgroups.
//
// Replaces the TPU kernel src/repro/kernels/swa.py:swa_attention_pallas
// (body _swa_kernel) for bf16 inputs with D = 64, 128 or 256; float32
// inputs stay on csrc/swa_attention.cu. For query row r and key c of one
// (batch, head):
//
//     valid(r, c) = 0 <= r - c < window
//     o[r] = sum_c softmax_c(scale * q[r] . k[c] | valid) v[c]
//
// q is (B, H, S, D); k and v are (B, KV, S, D), and query head h reads KV
// head h / (H / KV). Any strides with a contiguous last dimension and
// 16-byte multiples elsewhere are taken: the model's (B, S, H, D)
// activations are read in place through the TMA maps.
//
// Numerics (what the one-ulp gate against the float32 plain version
// needs; rounding P once to bf16 fails it on more than 5% of the outputs,
// tests/test_torch_swa.py, and so does rounding q * scale to bf16 before
// q.k):
//   * q.k runs on the raw bf16 q and k (exact products, float32 sums), and
//     the scale is applied to S afterwards in float32, folded with log2(e)
//     into exp2: p = exp2(s * c - m * c), c = scale * log2(e), with the
//     running max m kept in raw q.k units;
//   * masked scores are the finite NEG_INF = -1e30 and masked p are set to
//     0 after the exp, as in the TPU kernel;
//   * l sums the float32 p; P goes to the tensor cores split in two bf16
//     parts, hi = bf16(p) and lo = bf16(p - hi), and o += hi V + lo V, all
//     sums in float32;
//   * the output is o / max(l, 1e-30), rounded once to bf16.
//
// Design. A CTA owns BQ = 128 query rows of one (b, h): consumer
// warpgroups 0 and 1 hold 64 rows each; warpgroup 2 is the producer, of
// which one thread issues every TMA load (setmaxnreg gives the consumers
// 240 registers and the producer 24). The producer loads the Q tile once,
// then streams the BK-key K and V tiles that hold any in-band key of the
// CTA's rows, from max(0, q0 - window + 1) / BK to the diagonal tile, into
// a ring of STAGES stages with full barriers (TMA transaction bytes, one
// for K and one for V, so q.k starts before V lands) and an empty barrier
// (one arrival per consumer warp). At D = 64 and 128, BK = 128 and STAGES
// = 3 (Q 32 KB + 3 x 64 KB of K and V = 224 KB of shared memory at D =
// 128; two stages ran slower on an H100). At D = 256 a 128-key stage
// alone is 128 KB, so BK = 64 and STAGES = 2: Q 64 KB + 2 x (32 + 32 KB)
// = 192 KB. Tiles are 64-column boxes with the 128-byte swizzle, as the
// wgmma descriptors read them: a D = 128 row is two boxes, a D = 256 row
// four. Per key tile a consumer warpgroup runs S = Q K^T as D/16 wgmma
// m64nBKk16 (A = Q, B = K, both K-major from shared memory), the online
// softmax on the accumulator layout (a row lives in the 4 threads of a
// quad: two shuffles; the mask arithmetic only on the tiles that straddle
// the diagonal or the window's far edge), and o += hi V + lo V as 2 BK/16
// register-A wgmma m64nDk16 (B = V, MN-major, the descriptor's transpose
// bit). Each consumer thread holds o (D/2 floats), S (BK/2) and P's hi and
// lo (BK/8 + BK/8 registers): 192 at D = 128 and at D = 256 alike. The
// loop is software-pipelined: S of tile j and p.v of tile j - 1 are issued
// together, and the softmax of tile j runs while the tensor cores do that
// p.v; o takes on tile j's rescale factor after it. No atomics and no
// split across CTAs, so the result is deterministic. CTAs run the
// full-window query tiles of one KV head first and its G query heads next
// to each other, so their K/V tiles meet in L2 and the short early tiles
// fill the tail.
//
// What bounds it on this card. At the main path's shape (B 2, H 32, KV 8,
// S 16384, window 4096, D 128) the band holds 1.924 TFLOP of q.k and p.v
// (1.946 ms at 989 TFLOP/s): operations, not the 0.67 GB of q, k, v and o
// (0.200 ms). The split of P issues p.v twice: 2.886 TFLOP issued, 2.92 ms
// at the dense bf16 rate. At paligemma-3b's and gemma-2b's (B 2, H 8, KV
// 1, S 16384, window 4096, D 256) the band holds 0.962 TFLOP (0.9728 ms,
// operations; 1.443 TFLOP issued with the split P) against 0.30 GB of q,
// k, v and o (0.090 ms). The softmax (one exp2 a score), the split of P
// and the O rescale run on the CUDA cores; the pipeline and the second
// consumer warpgroup keep the tensor cores busy meanwhile. At D = 256 the
// O rescale is D/2 = 128 multiplies a thread for every 64 keys, four times
// D = 128's share of CUDA-core work per key.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;             // query rows per CTA (two warpgroups)
constexpr int NCONSUMER_WARPS = 8;
constexpr int NTH = 384;            // 2 consumer warpgroups + 1 producer
constexpr float NEG_INF = -1e30f;
constexpr double LOG2E = 1.4426950408889634;

struct Params {
  __nv_bfloat16* o;
  int64_t ob, oh, os;               // output strides, in elements
  int B, KV, G, nq, window;
  float c;                          // scale * log2(e)
};

// Per head dim: BK keys a tile and a ring of STAGES K/V stages. Shared
// memory: the Q tile, then STAGES x (K tile, V tile), then the barriers.
// Each tile is D / 64 column halves of rows x 64 bf16 (128-byte rows,
// 128-byte swizzle), the layout of one TMA box each. At D = 256 a 128-key
// stage is 128 KB, so the tile is 64 keys and the ring two stages deep.
template <int D>
struct Smem {
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int HALVES = D / 64;
  static constexpr int Q_HALF = BQ * 128;          // bytes of one Q half
  static constexpr int KV_HALF = BK * 128;         // bytes of one K/V half
  static constexpr int Q_BYTES = HALVES * Q_HALF;
  static constexpr int TILE_BYTES = HALVES * KV_HALF;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * TILE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES);
  static constexpr int ALLOC = BYTES + 1024;       // room to align to 1 KB
  static_assert(ALLOC <= 232448, "over a CTA's 227 KB of shared memory");
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

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(a[i][j]) :: "memory");
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

template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ---- the softmax on the accumulator layout -----------------------------
// Thread (warp w of its warpgroup, lane) holds rows 16 w + lane / 4 (half
// 0) and that + 8 (half 1) of the warpgroup's 64; register j of a 64 x N
// accumulator is at row half (j / 2) % 2, column 8 (j / 4) + 2 (lane % 4)
// + j % 2. A row lives in the 4 threads of a quad.

__device__ __forceinline__ bool in_band(int rel, int window) {
  return rel >= 0 && rel < window;
}

// One key tile: mask (MASK only), running max m (raw q.k units), s -> p,
// l = l * alpha + sum p (per-thread part of the row sum); returns in
// alpha the factor that o must take on before this tile's p.v adds to it.
template <bool MASK, int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], float c,
                                             int rel0, int window) {
  // rel0 = row of half 0 - column of register 0
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    const int hf = (j >> 1) & 1;
    if (MASK && !in_band(rel0 + 8 * hf - 8 * (j >> 2) - (j & 1), window))
      s[j] = NEG_INF;
    mx[hf] = fmaxf(mx[hf], s[j]);
  }
  float mc[2];
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
  for (int j = 0; j < BK / 2; ++j) {
    const int hf = (j >> 1) & 1;
    float p = exp2f(fmaf(s[j], c, -mc[hf]));
    if (MASK && !in_band(rel0 + 8 * hf - 8 * (j >> 2) - (j & 1), window))
      p = 0.f;
    s[j] = p;
    sum[hf] += p;
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = l[hf] * alpha[hf] + sum[hf];
}

// The softmax of the key tile at k0 for a warpgroup whose rows start at
// r0 (this thread's half-0 row: `row`), masked only where the tile
// straddles the diagonal or the far edge of the window for some row.
template <int BK>
__device__ __forceinline__ void softmax_at(float (&s)[BK / 2], float (&m)[2],
                                           float (&l)[2], float (&alpha)[2],
                                           float c, int row, int r0, int k0,
                                           int window) {
  const int rel0 = row - (k0 + 2 * (threadIdx.x & 3));
  if (k0 + BK - 1 > r0 || r0 + 63 - k0 >= window)
    softmax_tile<true, BK>(s, m, l, alpha, c, rel0, window);
  else
    softmax_tile<false, BK>(s, m, l, alpha, c, rel0, window);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// P as register A operands of the p.v products, split in two bf16 parts:
// hi = bf16(p), lo = bf16(p - hi). The accumulator layout of S is the A
// layout of P: k-step kk's four registers pack s[8 kk + 2 i], s[.. + 1].
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2],
                                        uint32_t (&hi)[BK / 16][4],
                                        uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = s[8 * kk + 2 * i], x1 = s[8 * kk + 2 * i + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][i] = bf16x2_bits(h);
      lo[kk][i] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// S = Q K^T (64 x BK, raw float32) of this warpgroup's Q rows at q_addr
// and the K tile at k_addr, issued and committed as one group.
template <int D, int BK = Smem<D>::BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk & 3) * 32;   // 16 columns into the half
    wgmma_ss<BK>(s, desc(q_addr + (kk >> 2) * Smem<D>::Q_HALF + off, 16,
                         1024),
                 desc(k_addr + (kk >> 2) * Smem<D>::KV_HALF + off, 16, 1024),
                 kk > 0);
  }
  wg_commit();
}

// o += hi V + lo V with the V tile at v_addr, issued and committed as one
// group.
template <int D, int BK = Smem<D>::BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&hi)[BK / 16][4],
                                         const uint32_t (&lo)[BK / 16][4],
                                         uint32_t v_addr) {
  // B: 16 keys (two 8-row groups, 1 KB apart) a step, the D columns in
  // 64-column halves KV_HALF apart
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(o, hi[kk], desc(v_addr + kk * 2048, Smem<D>::KV_HALF, 1024));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(o, lo[kk], desc(v_addr + kk * 2048, Smem<D>::KV_HALF, 1024));
  wg_commit();
}

template <int D>
__global__ void __launch_bounds__(NTH, 1)
swa_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const Params p) {
  using L = Smem<D>;
  constexpr int BK = L::BK, STAGES = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bars = base + L::BAR_OFF;
  const uint32_t full_q = bars;
  // stage s: K tile at sk(s), V tile at sk(s) + TILE_BYTES
  auto sk = [&](int s) { return base + L::Q_BYTES + s * 2 * L::TILE_BYTES; };
  auto full_k = [&](int s) { return bars + 8 * (1 + s); };
  auto full_v = [&](int s) { return bars + 8 * (1 + STAGES + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * STAGES + s); };

  // CTA -> (b, KV head, query tile, query head): the G heads of one KV
  // head next to each other, the full-window query tiles first.
  const int g = blockIdx.x % p.G;
  const int t = blockIdx.x / p.G;
  const int qt = p.nq - 1 - t % p.nq;
  const int bkv = t / p.nq;
  const int b = bkv / p.KV, kh = bkv % p.KV, h = kh * p.G + g;
  const int q0 = qt * BQ;
  const int kt_first = max(0, q0 - p.window + 1) / BK;
  const int kt_last = (q0 + BQ - 1) / BK;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), NCONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NCONSUMER_WARPS) {
    // ---- producer warpgroup: one thread issues every load --------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == NCONSUMER_WARPS * 32) {
      mbar_expect_tx(full_q, L::Q_BYTES);
      for (int hf = 0; hf < L::HALVES; ++hf)
        tma_load(sq + hf * L::Q_HALF, &tq, full_q, hf * 64, q0, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = kt_first; kt <= kt_last; ++kt) {
        mbar_wait(empty(stage), phase ^ 1);
        const uint32_t dk = sk(stage), dv = dk + L::TILE_BYTES;
        mbar_expect_tx(full_k(stage), L::TILE_BYTES);
        for (int hf = 0; hf < L::HALVES; ++hf)
          tma_load(dk + hf * L::KV_HALF, &tk, full_k(stage), hf * 64,
                   kt * BK, kh, b);
        mbar_expect_tx(full_v(stage), L::TILE_BYTES);
        for (int hf = 0; hf < L::HALVES; ++hf)
          tma_load(dv + hf * L::KV_HALF, &tv, full_v(stage), hf * 64,
                   kt * BK, kh, b);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each -----------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp >> 2;
    const int r0 = q0 + 64 * wg;                  // first row of the group
    const int row = r0 + 16 * (warp & 3) + (lane >> 2);   // half 0's row
    const uint32_t sq_wg = sq + 64 * 128 * wg;    // its 64 rows of Q

    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    // Software pipeline over the key tiles: while the tensor cores run
    // p.v of tile j - 1, the warpgroup runs the softmax of tile j; o takes
    // on tile j's factor once that p.v is done.
    float s[BK / 2], alpha[2];
    uint32_t hi[BK / 16][4], lo[BK / 16][4];
    int stage = 0;
    uint32_t phase = 0;
    mbar_wait(full_q, 0);
    mbar_wait(full_k(stage), phase);
    wg_fence();
    issue_qk<D>(s, sq_wg, sk(stage));
    wg_wait<0>();
    fence_regs(s);
    softmax_at<BK>(s, m, l, alpha, p.c, row, r0, kt_first * BK, p.window);
    split_p<BK>(s, hi, lo);                       // o = 0: alpha unused
    for (int kt = kt_first + 1; kt <= kt_last; ++kt) {
      const int prev = stage;
      const uint32_t prev_phase = phase;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
      mbar_wait(full_k(stage), phase);
      fence_regs(o);
      fence_regs(hi);
      fence_regs(lo);
      wg_fence();
      issue_qk<D>(s, sq_wg, sk(stage));
      mbar_wait(full_v(prev), prev_phase);
      issue_pv<D>(o, hi, lo, sk(prev) + L::TILE_BYTES);
      wg_wait<1>();                               // S of tile kt is in
      fence_regs(s);
      softmax_at<BK>(s, m, l, alpha, p.c, row, r0, kt * BK, p.window);
      wg_wait<0>();                               // p.v of tile kt - 1 too
      fence_regs(o);
      if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      split_p<BK>(s, hi, lo);
    }
    mbar_wait(full_v(stage), phase);
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    wg_fence();
    issue_pv<D>(o, hi, lo, sk(stage) + L::TILE_BYTES);
    wg_wait<0>();
    fence_regs(o);

    // o / max(l, 1e-30), rounded once to bf16
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
      l[hf] = fmaxf(l[hf], 1e-30f);
    }
    __nv_bfloat16* out = p.o + b * p.ob + h * p.oh + 2 * (lane & 3);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      __nv_bfloat16* orow = out + static_cast<int64_t>(row + 8 * hf) * p.os;
#pragma unroll
      for (int c8 = 0; c8 < D / 8; ++c8)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c8) =
            __floats2bfloat162_rn(o[4 * c8 + 2 * hf] / l[hf],
                                  o[4 * c8 + 2 * hf + 1] / l[hf]);
    }
  }
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
                  int S, int heads, int B, int64_t sb, int64_t sh, int64_t ss,
                  int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The TMA maps (K and V in boxes of the D's key tile) and the launch, or
// -(1000 + CUresult) when the driver refuses a map.
template <int D>
int launch(EncodeTiled enc, const void* q, const void* k, const void* v,
           const int64_t (&st)[9], const Params& p, int B, int H, int S,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  CUresult r = make_map(enc, &tq, q, D, S, H, B, st[0], st[1], st[2], BQ);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &tk, k, D, S, p.KV, B, st[3], st[4], st[5],
                 Smem<D>::BK);
  if (r == CUDA_SUCCESS)
    r = make_map(enc, &tv, v, D, S, p.KV, B, st[6], st[7], st[8],
                 Smem<D>::BK);
  if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  auto kern = swa_attention_wgmma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::ALLOC);
  if (err != cudaSuccess) return err;
  const int64_t ctas = static_cast<int64_t>(p.nq) * B * H;
  kern<<<static_cast<unsigned>(ctas), NTH, Smem<D>::ALLOC, stream>>>(tq, tk,
                                                                     tv, p);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. bf16 q (B, H, S, D), k and v
// (B, KV, S, D), o like q; strides in elements, the last dimension
// contiguous, the others and every base address 16-byte multiples; D 64,
// 128 or 256; S a multiple of 128; H a multiple of KV. Returns 0 on
// success, a cudaError_t for a refused launch, or -1 when the driver has no
// cuTensorMapEncodeTiled and -(1000 + CUresult) when it refuses a map. The
// launch is asynchronous, on `stream`.
extern "C" int swa_attention_wgmma_fwd(const void* q, const void* k,
                                       const void* v, void* o, int B, int H,
                                       int KV, int S, int D, int window,
                                       float scale, int64_t qb, int64_t qh,
                                       int64_t qs, int64_t kb, int64_t kh,
                                       int64_t ks, int64_t vb, int64_t vh,
                                       int64_t vs, int64_t ob, int64_t oh,
                                       int64_t os, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || S % BQ != 0 ||
      window <= 0 || (D != 64 && D != 128 && D != 256) ||
      static_cast<int64_t>(B) * H * (S / BQ) > 0x7fffffff)
    return cudaErrorInvalidValue;
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return -1;
  const int64_t st[9] = {qb, qh, qs, kb, kh, ks, vb, vh, vs};
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.ob = ob;
  p.oh = oh;
  p.os = os;
  p.B = B;
  p.KV = KV;
  p.G = H / KV;
  p.nq = S / BQ;
  p.window = window;
  p.c = static_cast<float>(static_cast<double>(scale) * LOG2E);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64    ? launch<64>(enc, q, k, v, st, p, B, H, S, s)
         : D == 128 ? launch<128>(enc, q, k, v, st, p, B, H, S, s)
                    : launch<256>(enc, q, k, v, st, p, B, H, S, s);
}

// Dynamic shared memory a CTA of the kernel takes for head dim D (bytes),
// or -1 for a D it does not take.
extern "C" int swa_attention_wgmma_smem(int D) {
  return D == 64    ? Smem<64>::ALLOC
         : D == 128 ? Smem<128>::ALLOC
         : D == 256 ? Smem<256>::ALLOC
                    : -1;
}
