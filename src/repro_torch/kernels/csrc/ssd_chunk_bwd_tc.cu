// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a) on bf16 tensor
// cores: the bf16 route of ssd._bwd_route ("tc"), for P 64, N 64 or 128 and
// Q a multiple of 64 up to 256 (mamba2-780m's and zamba2-7b's mixers).
// float32 stays on csrc/ssd_chunk_bwd.cu (float32 FMA), whose bK1 this
// route shares.
//
// No TPU kernel: the JAX package differentiates the model zoo's
// src/repro/models/ssm.py:ssd_chunked through XLA. It computes what
// csrc/ssd_chunk_bwd.cu computes, in its notation (x (b, L, H, P), B and C
// (b, L, N) shared by every head, dts and la float32 (b, L, H), S_c the
// state entering chunk c, g_c the gradient of the state leaving it, per
// chunk W[s, t] = G[s, t] M[s, t] dts_t, G = C B^T, M = exp(la_s - la_t)
// for s >= t, dW[s, t] = dy_s . x_t), split into four launches after bK1:
//
//   scan  g_c-1 = exp(la_end) g_c + R_c from the last chunk; each block
//         owns a slice of 1,024 entries of one (b, head) state (bK2 of the
//         FMA file walks a whole state per block: 768 blocks at the
//         training path's shape, 5.2 ms against its plain version's 2.2);
//         <g_c, S_c> is written as one partial a slice, which the head
//         launch adds in slice order
//   dgs   dGs[s, t] = sum_h dW_h[s, t] M_h[s, t] dts_t,h on the causal
//         triangle, float32 (b, nc, Q, Q): one block a (b, chunk, causal
//         64 x 64 tile pair) walks the heads in order, dW as wgmma
//         m64n64k16 from TMA-fed stages, scaled in registers (the mask
//         before the exp) and summed over the heads in float32 registers
//   dbdc  dC_s = (dGs B)_s + sum_h exp(la_s,h) (dy_s,h S_c,h)
//         dB_t = (dGs^T C)_t + sum_h w_t,h (x_t,h g_c,h),
//         w = exp(la_end - la) dts; one block a (b, chunk, dB or dC, 64-row
//         tile, 64 state columns); dGs as register A in three bf16 parts
//         against B or C tiles, then per head dy (or x) against S_c (or
//         g_c) in three parts; the head's sum scaled by its row's factor
//         and added in float32. It also writes the row sums
//         qc = sum_n C (dy S) = dy . (C S^T) and xg = sum_n B (x g) =
//         x . (g B), one partial a 64-column box, which the head launch
//         needs for d la and d dts
//   head  per (b, chunk, head): dx, d dts, d da and D's partial sum, as
//         the FMA file's head blocks, with G^T, dW^T, W^T dy and B g^T on
//         wgmma; d da is the reverse cumulative sum in row order by one
//         thread, the row and column sums in a fixed order
//
// Tensor cores. wgmma m64n64k16, f32 += bf16 x bf16, on 64-row tiles, the
// helpers of csrc/swa_attention_bwd_wgmma.cu: K-major operands from TMA
// boxes of 64 columns with the 128-byte swizzle; an MN-major operand (a
// tile whose rows are the product's K) through the descriptor's transpose
// bit; register A operands in the accumulator layout. B, C, x and dy enter
// as they are (exact products). The float32 operands (dGs, S_c, g_c and W)
// go in three bf16 parts, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v -
// hi - mid), each part's product into the same accumulator, as
// ssd_chunk_tc.cu: two parts miss the one-ulp gate on the model's
// activations there. Parts written by threads into shared memory (S_c and
// g_c) take the TMA box's swizzled layout and a proxy fence before the
// wgmma reads them. No accumulator sums more than 24 wgmma steps (the
// tensor cores' float32 sums truncate): sums over heads and tiles are
// taken in float32 on the CUDA cores.
//
// Copies. x, dy, B and C tiles arrive by TMA (4-d maps over x and dy, 3-d
// over B and C; strided views, as ssd._kernel_operand takes them). dgs and
// dbdc stream them through a ring of stages fed by a producer (a warp in
// dgs, a warpgroup in dbdc that also splits S_c or g_c and computes the
// rows' scales); head loads a chunk's tiles of one head once, B first.
//
// No atomics anywhere: two calls give the same bits.
//
// What bounds it on this card. At the training path's shape (b 16, L 4096,
// H 48, P 64, N 128, Q 256, bf16) the gradient must move 1.75 GB, 0.52 ms
// at 3.35 TB/s, and its products are 0.37 TFLOP, 0.37 ms at the dense bf16
// rate (chip_smoke.py:ssd_bwd_bound): bytes, with operations close behind.
// This design moves and issues more: it writes and reads dGs (67 MB), the
// row sums (50 MB) and g (0.8 GB); dbdc reads S_c and g_c (0.8 GB each)
// once per 64-row tile, four times, mostly from L2; it issues dgs 0.06
// TFLOP (dW per head and tile pair), dbdc 0.33 (the three-part products,
// dy S and x g per 64-row tile), head 0.54 (G and dW per head and tile
// pair, W^T dy and B g^T in three parts), 0.93 TFLOP in all, 0.94 ms at
// the dense rate. The head blocks keep a chunk's tiles resident (216 KB at
// Q 256, N 128: one block an SM, two consumer warpgroups) and take the
// most time; dgs and dbdc fit two or more blocks an SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int PD = 64;              // head dim P
constexpr int T = 64;               // rows of a tile, columns of a box
constexpr int QMAX = 256;           // the longest chunk
constexpr int NP = 3;               // bf16 parts of a float32 operand
constexpr int WGT = 128;            // threads of a warpgroup
constexpr int TILE = T * 128;       // bytes of a 64-row box of 64 bf16
constexpr int SCAN_NTH = 256;
constexpr int SLICE = 4 * SCAN_NTH; // state entries of a scan block
constexpr int A_STAGES = 4;         // dgs's ring
constexpr int B_STAGES = 3;         // dbdc's ring

struct Args {
  const float* dts;                 // (b, L, H)
  const float* la;                  // (b, L, H)
  const float* D;                   // (H,)
  const float* st;                  // (b, nc, H, P, N): S_c
  const float* R;                   // scan: bK1's R (may alias g)
  float* g;                         // (b, nc, H, P, N): g_c
  const float* dstate;              // (b, H, P, N) or null
  float* dinit;                     // (b, H, P, N) or null
  float* dlep;                      // (b, nc, H, P N / SLICE): <g, S> slices
  float* dgs;                       // (b, nc, Q, Q)
  bf16* dB;                         // (b, L, N)
  bf16* dC;
  float* qc;                        // (N / 64, b, L, H)
  float* xg;
  bf16* dx;                         // (b, L, H, P)
  float* ddts;                      // (b, L, H)
  float* dda;
  float* dDp;                       // (b, nc, H)
  int b, L, H, N, Q, nc;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier ---------------------------------------------------------------
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

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Shared-memory writes of this thread visible to the async proxy (wgmma).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of warpgroup `wg` (named barrier 1 + wg).
__device__ __forceinline__ void wg_bar(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// ---- TMA ------------------------------------------------------------------
// One box of a 4-d map (P, L, H, b) at element coordinates (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load4(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box of a 3-d map (N, L, b) at element coordinates (c0, c1, c2).
__device__ __forceinline__ void tma_load3(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

// Byte offset of element (row, col) of a box of 64 bf16 columns with the
// 128-byte swizzle (16-byte chunk index XOR row % 8), as TMA writes it.
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

__device__ __forceinline__ float2 ld_pair(const unsigned char* box, int row,
                                          int col) {
  return __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(box + swz(row, col)));
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

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

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

// d (64 x 64, float32) (+)= A (64 x 16) B (16 x 64), A K-major in shared
// memory, B K-major (TB 0) or MN-major (TB 1); scale_d = 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (64 x 64) += A (64 x 16, bf16 in registers) B (16 x 64); B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
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

// d (64 x 64) (+)= A B^T over K = 64 * boxes: A's and B's rows K-major in
// boxes of 64 columns, `box` bytes apart. `first` 1 overwrites d. Not
// committed.
__device__ __forceinline__ void issue_kk(float (&d)[32], uint32_t a_addr,
                                         uint32_t b_addr, int boxes,
                                         int first) {
  for (int kb = 0; kb < boxes; ++kb)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss<0>(d, desc(a_addr + kb * TILE + kk * 32, 16, 1024),
                  desc(b_addr + kb * TILE + kk * 32, 16, 1024),
                  !(first && kb == 0 && kk == 0));
}

// d += (sum of the parts) B: A (64 x 64) in registers as NP bf16 parts, B's
// 64 rows (the product's K) at b_addr, MN-major. Not committed.
__device__ __forceinline__ void issue_rs(float (&d)[32],
                                         const uint32_t (&a)[NP][4][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int part = 0; part < NP; ++part)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs(d, a[part][kk], desc(b_addr + kk * 2048, TILE, 1024));
}

// ---- the accumulator layout -------------------------------------------
// Thread (warp w of its warpgroup, lane) holds rows 16 w + lane / 4 (half
// 0) and that + 8 (half 1) of the warpgroup's 64; register j of a 64 x 64
// accumulator is at row half (j / 2) % 2, column 8 (j / 4) + 2 (lane % 4)
// + j % 2. The accumulator layout of a 64 x 64 product is the register-A
// layout of a 64 x 64 operand: k-step kk's four registers pack registers
// 8 kk + 2 i and 8 kk + 2 i + 1.
__device__ __forceinline__ int col_of(int j) {
  return 8 * (j >> 2) + 2 * (threadIdx.x & 3) + (j & 1);
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// x (64 x 64, accumulator layout) as register A operands in NP bf16 parts,
// each the rounding of what the ones before leave.
__device__ __forceinline__ void split(const float (&x)[32],
                                      uint32_t (&a)[NP][4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x0 = x[8 * kk + 2 * i], x1 = x[8 * kk + 2 * i + 1];
#pragma unroll
      for (int part = 0; part < NP; ++part) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
        const float2 hf = __bfloat1622float2(h);
        a[part][kk][i] = bf16x2_bits(h);
        x0 -= hf.x;
        x1 -= hf.y;
      }
    }
}

// 8 consecutive float32 values (16-byte aligned) split in NP bf16 parts,
// part k stored as 16 bytes at dst + k * TILE.
__device__ __forceinline__ void split8(const float* src, unsigned char* dst) {
  const float4 v0 = *reinterpret_cast<const float4*>(src);
  const float4 v1 = *reinterpret_cast<const float4*>(src + 4);
  float r[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    __align__(16) __nv_bfloat162 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      h[j] = __floats2bfloat162_rn(r[2 * j], r[2 * j + 1]);
      const float2 back = __bfloat1622float2(h[j]);
      r[2 * j] -= back.x;
      r[2 * j + 1] -= back.y;
    }
    *reinterpret_cast<uint4*>(dst + k * TILE) =
        *reinterpret_cast<const uint4*>(h);
  }
}

// A 64 x 64 float32 block (row stride `ld` floats) in NP bf16 parts, the
// parts TILE bytes apart from `parts`, each in a swizzled box: rows of the
// block are rows of the box. `nth` threads, this one `i`.
__device__ __forceinline__ void split_block(const float* src, int64_t ld,
                                            unsigned char* parts, int i,
                                            int nth) {
  for (int k = i; k < T * 8; k += nth) {
    const int row = k >> 3, c8 = (k & 7) * 8;
    split8(src + row * ld + c8, parts + swz(row, c8));
  }
}

// The producer's ring position.
template <int STAGES>
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

// one value per block of `nth` threads, summed in a fixed order; valid in
// thread 0; `red` holds nth / 32 floats
__device__ __forceinline__ float block_sum(float v, float* red, int nth) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < nth / 32; ++w) t += red[w];
  return t;
}

// ---------------------------------------------------------------------------
// scan: grid (P N / SLICE, H, b); each thread owns 4 consecutive entries of
// the state's gradient. R is read and g written in place (they may alias);
// the decay's multiply and the add round separately, as the plain version.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(SCAN_NTH) ssd_bwd_tc_scan_kernel(Args a) {
  constexpr int NS = PD * N / SLICE;
  constexpr int64_t HS = static_cast<int64_t>(PD) * N;
  __shared__ float red[SCAN_NTH / 32];
  const int sl = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t off = static_cast<int64_t>(sl) * SLICE + 4 * threadIdx.x;
  const int64_t fb = (static_cast<int64_t>(b) * a.H + h) * HS + off;
  float4 g = a.dstate ? *reinterpret_cast<const float4*>(a.dstate + fb)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = a.nc - 1; c >= 0; --c) {
    const int64_t bch = (static_cast<int64_t>(b) * a.nc + c) * a.H + h;
    const float decay = expf(a.la[(static_cast<int64_t>(b) * a.L +
                                   static_cast<int64_t>(c) * a.Q + a.Q - 1) *
                                      a.H + h]);
    const int64_t i = bch * HS + off;
    const float4 r = *reinterpret_cast<const float4*>(a.R + i);
    const float4 s = *reinterpret_cast<const float4*>(a.st + i);
    float part = g.x * s.x;
    part = fmaf(g.y, s.y, part);
    part = fmaf(g.z, s.z, part);
    part = fmaf(g.w, s.w, part);
    *reinterpret_cast<float4*>(a.g + i) = g;
    g.x = __fadd_rn(__fmul_rn(g.x, decay), r.x);
    g.y = __fadd_rn(__fmul_rn(g.y, decay), r.y);
    g.z = __fadd_rn(__fmul_rn(g.z, decay), r.z);
    g.w = __fadd_rn(__fmul_rn(g.w, decay), r.w);
    const float tot = block_sum(part, red, SCAN_NTH);
    if (threadIdx.x == 0) a.dlep[bch * NS + sl] = tot;
    __syncthreads();                     // red is free again
  }
  if (a.dinit) *reinterpret_cast<float4*>(a.dinit + fb) = g;
}

// ---------------------------------------------------------------------------
// dgs: one block a (b, chunk, causal tile pair), 4 consumer warps (one
// warpgroup) and a producer warp. The producer streams, per head, the dy
// tile of the rows s and the x tile of the rows t by TMA, and that head's
// la_s, la_t and dts_t, into A_STAGES stages.
// ---------------------------------------------------------------------------
struct LayA {
  static constexpr int STAGE = 2 * TILE;                // dy (rows s), x (t)
  static constexpr int ROWS = A_STAGES * STAGE;         // 3 x 64 floats each
  static constexpr int BAR = ROWS + A_STAGES * 3 * T * 4;
  static constexpr int BYTES = BAR + 16 * A_STAGES + 1024;
};

__global__ void __launch_bounds__(WGT + 32)
ssd_bwd_tc_dgs_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tdy, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bars = base + LayA::BAR;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (A_STAGES + s); };
  auto rows_of = [&](int s) {
    return reinterpret_cast<float*>(gbase + LayA::ROWS + s * 3 * T * 4);
  };

  const int nt = a.Q / T, npair = nt * (nt + 1) / 2;
  int ti = blockIdx.x % npair, si = 0;
  while (ti > si) {                      // pair k -> (si >= ti), si-major
    ti -= si + 1;
    ++si;
  }
  const int bc = blockIdx.x / npair, b = bc / a.nc, c = bc % a.nc;
  const int s0 = si * T, t0 = ti * T;
  const int l0 = c * a.Q;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < A_STAGES; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == 4) {                       // the producer warp
    Ring<A_STAGES> r;
    const int64_t rb = (static_cast<int64_t>(b) * a.L + l0) * a.H;
    for (int h = 0; h < a.H; ++h, r.next()) {
      mbar_wait(empty(r.stage), r.phase ^ 1);
      float* rows = rows_of(r.stage);
      for (int i = lane; i < T; i += 32) {
        rows[i] = a.la[rb + static_cast<int64_t>(s0 + i) * a.H + h];
        rows[T + i] = a.la[rb + static_cast<int64_t>(t0 + i) * a.H + h];
        rows[2 * T + i] = a.dts[rb + static_cast<int64_t>(t0 + i) * a.H + h];
      }
      const uint32_t f = full(r.stage), dst = base + r.stage * LayA::STAGE;
      if (lane == 0) {
        mbar_expect_tx(f, 2 * TILE);
        tma_load4(dst, &tdy, f, 0, l0 + s0, h, b);
        tma_load4(dst + TILE, &tx, f, 0, l0 + t0, h, b);
      } else {
        mbar_arrive(f);
      }
    }
    return;
  }

  const int r0 = 16 * warp + (lane >> 2);   // half 0's row in the tile
  const bool diag = si == ti;
  float acc[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  Ring<A_STAGES> r;
  for (int h = 0; h < a.H; ++h, r.next()) {
    mbar_wait(full(r.stage), r.phase);
    const uint32_t sdy = base + r.stage * LayA::STAGE;
    float d[32];
    wg_fence();
    issue_kk(d, sdy, sdy + TILE, 1, 1);  // dW = dy_s x_t^T over P
    wg_commit();
    wg_wait<0>();
    fence_regs(d);
    const float* rows = rows_of(r.stage);
    const float ls[2] = {rows[r0], rows[r0 + 8]};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int hf = (j >> 1) & 1, cl = col_of(j);
      if (!diag || r0 + 8 * hf >= cl) {  // mask before the exp
        const float v = d[j] * expf(ls[hf] - rows[T + cl]);
        acc[j] += v * rows[2 * T + cl];
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(r.stage));
  }
  float* out = a.dgs + (static_cast<int64_t>(bc) * a.Q + s0 + r0) * a.Q + t0 +
               2 * (lane & 3);
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(out + 8 * hf * a.Q + 8 * c8) =
          make_float2(acc[4 * c8 + 2 * hf], acc[4 * c8 + 2 * hf + 1]);
}

// ---------------------------------------------------------------------------
// dbdc: one block a (b, chunk, dC or dB, 64-row tile, 64-column box of N);
// a consumer warpgroup and a producer warpgroup. Jobs in ring order: the
// tiles of the other side of the triangle (B rows t <= s for dC, C rows
// s >= t for dB), then the heads; a head's stage holds its dy (dC) or x
// (dB) tile by TMA, the NP parts of S_c (dC) or g_c (dB) for the box,
// split by the producer, and the rows' scales exp(la) (dC) or exp(la_end -
// la) dts (dB).
// ---------------------------------------------------------------------------
struct LayB {
  static constexpr int STAGE = (1 + NP) * TILE;         // op tile, parts
  static constexpr int RES = B_STAGES * STAGE;          // C (dC) or B rows
  static constexpr int SC = RES + TILE;                 // 64 floats a stage
  static constexpr int BAR = SC + B_STAGES * T * 4;
  static constexpr int BYTES = BAR + 8 * (2 * B_STAGES + 1) + 1024;
};

__global__ void __launch_bounds__(2 * WGT)
ssd_bwd_tc_dbdc_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tdy,
                       const __grid_constant__ CUtensorMap tB,
                       const __grid_constant__ CUtensorMap tC, const Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const uint32_t bars = base + LayB::BAR;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (B_STAGES + s); };
  const uint32_t res = bars + 8 * 2 * B_STAGES;
  auto scale_of = [&](int s) {
    return reinterpret_cast<float*>(gbase + LayB::SC + s * T * 4);
  };

  const int nt = a.Q / T, nh_n = a.N / T;
  int idx = blockIdx.x;
  const int nh = idx % nh_n;
  idx /= nh_n;
  const int rt = idx % nt;
  idx /= nt;
  const int which = idx & 1;             // 0: dC (rows s), 1: dB (rows t)
  const int bc = idx >> 1, b = bc / a.nc, c = bc % a.nc;
  const int l0 = c * a.Q, row0 = rt * T;
  const int k_first = which ? rt : 0, k_last = which ? nt - 1 : rt;
  const int n1 = k_last - k_first + 1;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(full(s), WGT);
      mbar_init(empty(s), 4);
    }
    mbar_init(res, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (tid >= WGT) {                      // the producer warpgroup
    const int p = tid - WGT;
    if (p == 0) {
      mbar_expect_tx(res, TILE);
      tma_load3(base + LayB::RES, which ? &tB : &tC, res, nh * T, l0 + row0,
                b);
    }
    const int64_t rb = (static_cast<int64_t>(b) * a.L + l0) * a.H;
    Ring<B_STAGES> r;
    for (int j = 0; j < n1 + a.H; ++j, r.next()) {
      mbar_wait(empty(r.stage), r.phase ^ 1);
      const uint32_t f = full(r.stage), dst = base + r.stage * LayB::STAGE;
      if (j < n1) {
        if (p == 0) {
          mbar_expect_tx(f, TILE);
          tma_load3(dst, which ? &tC : &tB, f, nh * T,
                    l0 + (k_first + j) * T, b);
        } else {
          mbar_arrive(f);
        }
        continue;
      }
      const int h = j - n1;
      const float* src = (which ? a.g : a.st) +
                         (static_cast<int64_t>(bc) * a.H + h) * PD * a.N +
                         nh * T;
      split_block(src, a.N, gbase + r.stage * LayB::STAGE + TILE, p, WGT);
      if (p < T) {
        const int64_t ri = rb + static_cast<int64_t>(row0 + p) * a.H + h;
        scale_of(r.stage)[p] =
            which ? expf(a.la[rb + static_cast<int64_t>(a.Q - 1) * a.H + h] -
                         a.la[ri]) * a.dts[ri]
                  : expf(a.la[ri]);
      }
      fence_proxy_async();
      if (p == 0) {
        mbar_expect_tx(f, TILE);
        tma_load4(dst, which ? &tx : &tdy, f, 0, l0 + row0, h, b);
      } else {
        mbar_arrive(f);
      }
    }
    return;
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp + (lane >> 2);
  const int64_t dgs0 = static_cast<int64_t>(bc) * a.Q * a.Q;
  float tot[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) tot[j] = 0.f;
  Ring<B_STAGES> r;
  // (dGs B)_s for dC, (dGs^T C)_t for dB
  for (int j = 0; j < n1; ++j, r.next()) {
    const int k0 = (k_first + j) * T;
    float f[32];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int row = row0 + r0 + 8 * ((jj >> 1) & 1), col = k0 + col_of(jj);
      f[jj] = which ? a.dgs[dgs0 + static_cast<int64_t>(col) * a.Q + row]
                    : a.dgs[dgs0 + static_cast<int64_t>(row) * a.Q + col];
    }
    uint32_t ap[NP][4][4];
    split(f, ap);
    float tmp[32];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) tmp[jj] = 0.f;
    mbar_wait(full(r.stage), r.phase);
    fence_regs(ap);
    fence_regs(tmp);
    wg_fence();
    issue_rs(tmp, ap, base + r.stage * LayB::STAGE);
    wg_commit();
    wg_wait<0>();
    fence_regs(tmp);
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) tot[jj] += tmp[jj];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(r.stage));
  }
  // sum_h scale (dy S) for dC, sum_h scale (x g) for dB; the row sums
  // against C (dC) or B (dB)
  mbar_wait(res, 0);
  const unsigned char* rbox = gbase + LayB::RES;
  float* qout = (which ? a.xg : a.qc) +
                ((static_cast<int64_t>(nh) * a.b + b) * a.L + l0 + row0 + r0) *
                    a.H;
  for (int h = 0; h < a.H; ++h, r.next()) {
    mbar_wait(full(r.stage), r.phase);
    const uint32_t sop = base + r.stage * LayB::STAGE, sparts = sop + TILE;
    float tmp[32];
    wg_fence();
#pragma unroll
    for (int part = 0; part < NP; ++part)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<1>(tmp, desc(sop + kk * 32, 16, 1024),
                    desc(sparts + part * TILE + kk * 2048, TILE, 1024),
                    part | kk);
    wg_commit();
    wg_wait<0>();
    fence_regs(tmp);
    const float* sc = scale_of(r.stage);
    const float e[2] = {sc[r0], sc[r0 + 8]};
    float q[2] = {0.f, 0.f};
#pragma unroll
    for (int jj = 0; jj < 32; jj += 2) {
      const int hf = (jj >> 1) & 1;
      const float2 v = ld_pair(rbox, r0 + 8 * hf, col_of(jj));
      q[hf] = fmaf(v.x, tmp[jj], q[hf]);
      q[hf] = fmaf(v.y, tmp[jj + 1], q[hf]);
      tot[jj] = fmaf(e[hf], tmp[jj], tot[jj]);
      tot[jj + 1] = fmaf(e[hf], tmp[jj + 1], tot[jj + 1]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      q[hf] += __shfl_xor_sync(0xffffffffu, q[hf], 1);
      q[hf] += __shfl_xor_sync(0xffffffffu, q[hf], 2);
    }
    if ((lane & 3) == 0) {
      qout[h] = q[0];
      qout[8 * a.H + h] = q[1];
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(r.stage));
  }
  bf16* o = (which ? a.dB : a.dC) +
            (static_cast<int64_t>(b) * a.L + l0 + row0 + r0) * a.N + nh * T +
            2 * (lane & 3);
#pragma unroll
  for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * hf * a.N + 8 * c8) =
          __floats2bfloat162_rn(tot[4 * c8 + 2 * hf],
                                tot[4 * c8 + 2 * hf + 1]);
}

// ---------------------------------------------------------------------------
// head: one block a (b, chunk, head), two consumer warpgroups; warpgroup 0
// owns the t tiles 0 and 3, warpgroup 1 the tiles 1 and 2 (of Q / 64), so
// that each walks about half the tile pairs. Shared memory: B, x, dy and C
// of the chunk (TMA, B on its own barrier), the NP parts of one 64-column
// box of g_c, then the per-row floats.
// ---------------------------------------------------------------------------
struct LayC {
  int bt, xt, dyt, ct, gp, fl, scr, red, bar, bytes;
  __host__ __device__ LayC(int Q, int N) {
    const int nt = Q / T, nb = N / T;
    bt = 0;
    xt = bt + nt * nb * TILE;
    dyt = xt + nt * TILE;
    ct = dyt + nt * TILE;
    gp = ct + nt * nb * TILE;
    fl = gp + NP * TILE;                 // la, dts, dlr x 2, dlc, ddt: Q each
    scr = fl + 6 * Q * 4;                // column sums: 2 x 4 warps x 64
    red = scr + 2 * 4 * T * 4;
    bar = red + 8 * 4;
    bytes = bar + 16 + 1024;
  }
};

template <int N>
__global__ void __launch_bounds__(2 * WGT, 1)
ssd_bwd_tc_head_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tdy,
                       const __grid_constant__ CUtensorMap tB,
                       const __grid_constant__ CUtensorMap tC, const Args a) {
  constexpr int NB = N / T;
  constexpr int NS = PD * N / SLICE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - smem_addr(smem_raw));
  const LayC lay(a.Q, N);
  const int Q = a.Q, nt = Q / T;
  const int h = blockIdx.x % a.H, bc = blockIdx.x / a.H;
  const int b = bc / a.nc, c = bc % a.nc, l0 = c * Q;
  const uint32_t bar0 = base + lay.bar, bar1 = bar0 + 8;
  float* la = reinterpret_cast<float*>(gbase + lay.fl);
  float* dts = la + Q;
  float* dlr = dts + Q;                  // [2][Q], a warpgroup's each
  float* dlc = dlr + 2 * Q;
  float* ddt = dlc + Q;
  float* red = reinterpret_cast<float*>(gbase + lay.red);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127;
  const int warp = wt >> 5, lane = tid & 31;
  float* scr = reinterpret_cast<float*>(gbase + lay.scr) + wg * 4 * T;

  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar0, nt * NB * TILE);
    for (int ti = 0; ti < nt; ++ti)
      for (int hb = 0; hb < NB; ++hb)
        tma_load3(base + lay.bt + (ti * NB + hb) * TILE, &tB, bar0, hb * T,
                  l0 + ti * T, b);
    mbar_expect_tx(bar1, nt * (2 + NB) * TILE);
    for (int ti = 0; ti < nt; ++ti) {
      tma_load4(base + lay.xt + ti * TILE, &tx, bar1, 0, l0 + ti * T, h, b);
      tma_load4(base + lay.dyt + ti * TILE, &tdy, bar1, 0, l0 + ti * T, h, b);
      for (int hb = 0; hb < NB; ++hb)
        tma_load3(base + lay.ct + (ti * NB + hb) * TILE, &tC, bar1, hb * T,
                  l0 + ti * T, b);
    }
  }
  const int64_t rb = (static_cast<int64_t>(b) * a.L + l0) * a.H + h;
  for (int i = tid; i < Q; i += 2 * WGT) {
    la[i] = a.la[rb + static_cast<int64_t>(i) * a.H];
    dts[i] = a.dts[rb + static_cast<int64_t>(i) * a.H];
    dlr[i] = dlr[Q + i] = dlc[i] = ddt[i] = 0.f;
  }

  // the t tiles this warpgroup owns (-1 for none)
  int own[2] = {-1, -1};
  if (wg == 0) {
    own[0] = 0;
    if (nt == 4) own[1] = 3;
  } else {
    if (nt >= 2) own[0] = 1;
    if (nt >= 3) own[1] = 2;
  }
  const int r0 = 16 * warp + (lane >> 2);

  // B_t g^T (rows t, P columns) over the boxes of N, into dx
  float dx[2][32];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int j = 0; j < 32; ++j) dx[k][j] = 0.f;
  const float* gsrc = a.g + (static_cast<int64_t>(bc) * a.H + h) * PD * N;
  for (int hb = 0; hb < NB; ++hb) {
    __syncthreads();                     // the parts' box is free
    split_block(gsrc + hb * T, N, gbase + lay.gp, tid, 2 * WGT);
    fence_proxy_async();
    __syncthreads();
    if (hb == 0) mbar_wait(bar0, 0);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (own[k] < 0) continue;
      fence_regs(dx[k]);
      wg_fence();
#pragma unroll
      for (int part = 0; part < NP; ++part)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<0>(dx[k],
                      desc(base + lay.bt + (own[k] * NB + hb) * TILE + kk * 32,
                           16, 1024),
                      desc(base + lay.gp + part * TILE + kk * 32, 16, 1024),
                      hb | part | kk);
      wg_commit();
      wg_wait<0>();
      fence_regs(dx[k]);
    }
  }
  const float la_end = la[Q - 1];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (own[k] < 0) continue;
    const int t = own[k] * T + r0;
    const float wv[2] = {expf(la_end - la[t]) * dts[t],
                         expf(la_end - la[t + 8]) * dts[t + 8]};
#pragma unroll
    for (int j = 0; j < 32; ++j) dx[k][j] *= wv[(j >> 1) & 1];
  }

  mbar_wait(bar1, 0);
  float dsum = 0.f;
  const float Dh = a.D[h];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int ti = own[k];
    if (ti < 0) continue;
    const int t0 = ti * T;
    const float lt[2] = {la[t0 + r0], la[t0 + r0 + 8]};
    const float dt[2] = {dts[t0 + r0], dts[t0 + r0 + 8]};
    float rm[2] = {0.f, 0.f}, ra[2] = {0.f, 0.f};
    for (int si = ti; si < nt; ++si) {
      const int s0 = si * T;
      float G[32], W[32];
      wg_fence();
      // G^T = B_t C_s^T over N, dW^T = x_t dy_s^T over P
      issue_kk(G, base + lay.bt + ti * NB * TILE,
               base + lay.ct + si * NB * TILE, NB, 1);
      issue_kk(W, base + lay.xt + ti * TILE, base + lay.dyt + si * TILE, 1, 1);
      wg_commit();
      wg_wait<0>();
      fence_regs(G);
      fence_regs(W);
      const bool diag = si == ti;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int hf = (j >> 1) & 1, cs = col_of(j);
        float w = 0.f, m = 0.f, av = 0.f;
        if (!diag || cs >= r0 + 8 * hf) {  // s >= t; mask before the exp
          const float gm = G[j] * expf(la[s0 + cs] - lt[hf]);
          w = gm * dt[hf];
          m = W[j] * gm;
          av = m * dt[hf];
        }
        G[j] = w;                        // W^T, the A operand of dx
        W[j] = av;                       // A^T, for the column sums
        rm[hf] += m;
        ra[hf] += av;
      }
      // d la_s += sum_t A[s, t]: this tile's columns, summed over the two
      // rows of a thread, the 8 lanes of a column, then the 4 warps
#pragma unroll
      for (int cj = 0; cj < 16; ++cj) {
        const int j0 = 4 * (cj >> 1) + (cj & 1);
        float v = W[j0] + W[j0 + 2];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (lane < 4) scr[warp * T + 8 * (cj >> 1) + 2 * lane + (cj & 1)] = v;
      }
      wg_bar(wg);
      if (wt < T)
        dlr[wg * Q + s0 + wt] +=
            ((scr[wt] + scr[T + wt]) + scr[2 * T + wt]) + scr[3 * T + wt];
      // dx_t += W^T dy_s
      uint32_t ap[NP][4][4];
      split(G, ap);
      fence_regs(ap);
      fence_regs(dx[k]);
      wg_fence();
      issue_rs(dx[k], ap, base + lay.dyt + si * TILE);
      wg_commit();
      wg_wait<0>();
      fence_regs(dx[k]);
      wg_bar(wg);                        // scr is free again
    }
    // d dts_t += sum_s dW G M, d la_t -= sum_s A: rows of this warpgroup
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      rm[hf] += __shfl_xor_sync(0xffffffffu, rm[hf], 1);
      rm[hf] += __shfl_xor_sync(0xffffffffu, rm[hf], 2);
      ra[hf] += __shfl_xor_sync(0xffffffffu, ra[hf], 1);
      ra[hf] += __shfl_xor_sync(0xffffffffu, ra[hf], 2);
      if ((lane & 3) == 0) {
        ddt[t0 + r0 + 8 * hf] = rm[hf];
        dlc[t0 + r0 + 8 * hf] = -ra[hf];
      }
    }
    // D dy_t into dx, D's sum dy.x; dx rounded once
    const unsigned char* dyb = gbase + lay.dyt + ti * TILE;
    const unsigned char* xb = gbase + lay.xt + ti * TILE;
    bf16* o = a.dx + (static_cast<int64_t>(b) * a.L + l0 + t0 + r0) * a.H * PD +
              h * PD + 2 * (lane & 3);
#pragma unroll
    for (int c8 = 0; c8 < 8; ++c8)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 4 * c8 + 2 * hf;
        const float2 dv = ld_pair(dyb, r0 + 8 * hf, col_of(j));
        const float2 xv = ld_pair(xb, r0 + 8 * hf, col_of(j));
        dx[k][j] = fmaf(Dh, dv.x, dx[k][j]);
        dx[k][j + 1] = fmaf(Dh, dv.y, dx[k][j + 1]);
        dsum = fmaf(dv.x, xv.x, dsum);
        dsum = fmaf(dv.y, xv.y, dsum);
        *reinterpret_cast<__nv_bfloat162*>(
            o + static_cast<int64_t>(8 * hf) * a.H * PD + 8 * c8) =
            __floats2bfloat162_rn(dx[k][j], dx[k][j + 1]);
      }
  }
  __syncthreads();
  const float dtot = block_sum(dsum, red, 2 * WGT);
  if (tid == 0) a.dDp[static_cast<int64_t>(bc) * a.H + h] = dtot;
  // per row: u = exp(la_end - la) x.(g B), v = dts u; the row terms of
  // d la (exp(la) dy.(C S^T) and the row sums of A), less the column sums
  // and v, into dlr; v into dlr's second half
  const int64_t pb = static_cast<int64_t>(a.b) * a.L * a.H;
  for (int i = tid; i < Q; i += 2 * WGT) {
    float qs = 0.f, xs = 0.f;
    for (int nb = 0; nb < NB; ++nb) {
      qs += a.qc[nb * pb + rb + static_cast<int64_t>(i) * a.H];
      xs += a.xg[nb * pb + rb + static_cast<int64_t>(i) * a.H];
    }
    const float u = expf(la_end - la[i]) * xs;
    const float v = dts[i] * u;
    ddt[i] += u;
    dlr[i] = expf(la[i]) * qs + dlr[i] + dlr[Q + i] + dlc[i] - v;
    dlr[Q + i] = v;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int sl = 0; sl < NS; ++sl)
      s += a.dlep[(static_cast<int64_t>(bc) * a.H + h) * NS + sl];
    float e = expf(la_end) * s;
    for (int t = 0; t < Q; ++t) e += dlr[Q + t];
    float acc = 0.f;                     // d da: reverse cumulative sum
    for (int t = Q - 1; t >= 0; --t) {
      acc += dlr[t] + (t == Q - 1 ? e : 0.f);
      dlr[t] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += 2 * WGT) {
    a.dda[rb + static_cast<int64_t>(i) * a.H] = dlr[i];
    a.ddts[rb + static_cast<int64_t>(i) * a.H] = ddt[i];
  }
}

// ---- host side --------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime, so the
// library needs no -lcuda.
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

// A map over a bf16 tensor of `rank` dims (the first contiguous) with
// element strides st[0..rank-2] of dims 1.., boxes of 64 x 64 (x 1 ...),
// 128-byte swizzle.
CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int rank,
                  const cuuint64_t* dims, const int64_t* st) {
  cuuint64_t strides[3];
  for (int i = 0; i < rank - 1; ++i)
    strides[i] = static_cast<cuuint64_t>(st[i]) * 2;
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
             const_cast<void*>(ptr), dims, strides, box, estride,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

int stage_bytes(int stage, int Q, int N) {
  switch (stage) {
    case 0: return 0;
    case 1: return LayA::BYTES;
    case 2: return LayB::BYTES;
    case 3: return LayC(Q, N).bytes;
    default: return -1;
  }
}

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <int N>
int launch(int stage, const Args& a, const CUtensorMap* maps,
           cudaStream_t s) {
  const int nt = a.Q / T;
  const int64_t bc = static_cast<int64_t>(a.b) * a.nc;
  int64_t blocks = 0;
  const int bytes = stage_bytes(stage, a.Q, N);
  cudaError_t err = cudaSuccess;
  if (stage == 0) {
    ssd_bwd_tc_scan_kernel<N><<<dim3(PD * N / SLICE, a.H, a.b), SCAN_NTH, 0,
                                s>>>(a);
  } else if (stage == 1) {
    blocks = bc * (nt * (nt + 1) / 2);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    if ((err = set_smem(ssd_bwd_tc_dgs_kernel, bytes)) != cudaSuccess)
      return err;
    ssd_bwd_tc_dgs_kernel<<<static_cast<unsigned>(blocks), WGT + 32, bytes,
                            s>>>(maps[0], maps[1], a);
  } else if (stage == 2) {
    blocks = bc * 2 * nt * (N / T);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    if ((err = set_smem(ssd_bwd_tc_dbdc_kernel, bytes)) != cudaSuccess)
      return err;
    ssd_bwd_tc_dbdc_kernel<<<static_cast<unsigned>(blocks), 2 * WGT, bytes,
                             s>>>(maps[0], maps[1], maps[2], maps[3], a);
  } else {
    blocks = bc * a.H;
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    auto kern = ssd_bwd_tc_head_kernel<N>;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<static_cast<unsigned>(blocks), 2 * WGT, bytes, s>>>(
        maps[0], maps[1], maps[2], maps[3], a);
  }
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. stage 0 is the scan, 1 dgs, 2 dbdc, 3
// head. bf16 x, B, C, dy, dx, dB, dC; the rest float32 and contiguous. P
// is 64, N 64 or 128, Q a multiple of 64 up to 256 dividing L; x (b, L, H,
// P) and B, C (b, L, N) with element strides (xb, xl, xh), (bb, bl), (cb,
// cl), the last dimension contiguous and rows 16-byte aligned; dy and dx
// contiguous (b, L, H, P). A stage reads only its own pointers; dstate and
// dinit may be null. Returns 0 on success, a cudaError_t for a refused
// launch, -1 when libcuda has no cuTensorMapEncodeTiled, or -(1000 +
// CUresult) when it refuses a map; the launch is asynchronous, on
// `stream`.
extern "C" int ssd_chunk_bwd_tc(
    int stage, const void* x, const void* dts, const void* la, const void* B,
    const void* C, const void* D, const void* dy, const void* st,
    const void* R, void* g, const void* dstate, void* dinit, void* dlep,
    void* dgs, void* dB, void* dC, void* qc, void* xg, void* dx, void* ddts,
    void* dda, void* dDp, int b, int L, int H, int P, int N, int Q,
    int64_t xb, int64_t xl, int64_t xh, int64_t bb, int64_t bl, int64_t cb,
    int64_t cl, void* stream) {
  if (b <= 0 || b > 65535 || H <= 0 || H > 65535 || P != PD || Q <= 0 ||
      Q > QMAX || Q % T != 0 || L <= 0 || L % Q != 0 || stage < 0 ||
      stage > 3 || (N != 64 && N != 128))
    return cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(dts), static_cast<const float*>(la),
               static_cast<const float*>(D), static_cast<const float*>(st),
               static_cast<const float*>(R), static_cast<float*>(g),
               static_cast<const float*>(dstate), static_cast<float*>(dinit),
               static_cast<float*>(dlep), static_cast<float*>(dgs),
               static_cast<bf16*>(dB), static_cast<bf16*>(dC),
               static_cast<float*>(qc), static_cast<float*>(xg),
               static_cast<bf16*>(dx), static_cast<float*>(ddts),
               static_cast<float*>(dda), static_cast<float*>(dDp),
               b, L, H, N, Q, L / Q};
  CUtensorMap maps[4];
  if (stage > 0) {
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return -1;
    const int64_t hp = static_cast<int64_t>(H) * PD;
    const cuuint64_t d4[4] = {PD, static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(b)};
    const cuuint64_t d3[3] = {static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(b)};
    const int64_t sx[3] = {xl, xh, xb}, sdy[3] = {hp, PD, hp * L};
    const int64_t sb[2] = {bl, bb}, sc[2] = {cl, cb};
    CUresult r = make_map(enc, &maps[0], x, 4, d4, sx);
    if (r == CUDA_SUCCESS) r = make_map(enc, &maps[1], dy, 4, d4, sdy);
    if (r == CUDA_SUCCESS && stage > 1) r = make_map(enc, &maps[2], B, 3, d3, sb);
    if (r == CUDA_SUCCESS && stage > 1) r = make_map(enc, &maps[3], C, 3, d3, sc);
    if (r != CUDA_SUCCESS) return -(1000 + static_cast<int>(r));
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return N == 64 ? launch<64>(stage, a, maps, s) : launch<128>(stage, a, maps, s);
}

// Dynamic shared memory of a stage at chunk Q and state size N, in bytes.
extern "C" int ssd_chunk_bwd_tc_smem(int stage, int Q, int N) {
  return stage_bytes(stage, Q, N);
}
