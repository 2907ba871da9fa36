// Backward of the Mamba2 SSD chunk scan for Hopper (sm_90a): three launches
// on float32 FMA.
//
// No TPU kernel: the JAX package differentiates the model zoo's
// src/repro/models/ssm.py:ssd_chunked through XLA. This is the gradient of
// the function that ssd_chunked.cu and ssd_chunk_tc.cu compute (they
// replace src/repro/kernels/ssd.py:ssd_chunked_pallas). Notation of
// ssd_chunk_tc.cu: x (b, L, H, P), B and C (b, L, N) shared by every head,
// dts = softplus(dt) and la, the cumulative sum of da within a chunk of Q
// rows, float32 (b, L, H); S_c the (P, N) state entering chunk c; per chunk
// W[s, t] = (C B^T)[s, t] exp(la_s - la_t) dts_t for s >= t. With dy the
// gradient of y and g_c that of the state leaving chunk c (the final
// state's gradient for the last chunk, zero when it is null):
//
//   bK1  R_c = sum_s exp(la_s) dy_s^T C_s                 chunk-parallel
//   bK2  g_c-1 = exp(la_end) g_c + R_c, from the last chunk to the first;
//        the gradient of init_state is g_-1, and la_end's share from the
//        state's decay is dle_c = exp(la_end) <g_c, S_c>
//   bK3  per chunk, from S_c (the forward's own workspace, kept for the
//        backward) and g_c:
//        dx_t  = dts_t sum_{s>=t} (C_s.B_t) exp(la_s - la_t) dy_s
//                + exp(la_end - la_t) dts_t g B_t + D dy_t
//        d dts_t = sum_{s>=t} dW G M + exp(la_end - la_t) x_t.(g B_t),
//                  dW[s, t] = dy_s.x_t, G = C B^T, M = exp(la_s - la_t)
//        d la  = the row sums less the column sums of A = dW W, plus
//                exp(la_s) dy_s.(C_s S^T), less v_t = exp(la_end - la_t)
//                dts_t x_t.(g B_t), plus dle + sum v at la_end; d da is its
//                reverse cumulative sum within the chunk
//        dC_s  = sum_h [sum_t dG B_t + exp(la_s) dy_s S_c]
//        dB_t  = sum_h [sum_s dG C_s + exp(la_end - la_t) dts_t x_t g]
//                with dG[s, t] = dW M dts_t, per head
//        D's partial sums dy.x per (b, chunk, head)
//
// bK3 has two kinds of block in one grid. A head block (b, chunk, head)
// computes dx, d dts and d da, which need the whole chunk of one head (the
// reverse cumulative sum). A shared block (b, chunk, 32 state columns)
// owns those columns of dB and dC for the chunk and walks the heads in
// order, recomputing each head's dG, so that the sum over heads is taken
// in one fixed order with no atomics and no per-head partials (which at
// the training path's shape, b 16 x L 4096 x H 48 x N 128 in float32,
// would take 1.61 GB for each of dB and dC). Its memory: its accumulators
// in shared memory (2 x Q x 32 floats). No launch uses atomics, so two
// calls give the same bits.
//
// Translation and tiling. As ssd_chunked.cu: 256 threads, chunks cut into
// 64-row tiles (Q a multiple of 64, no ragged edge), products of 64 x 64
// tiles with each thread owning 4 rows x 4 columns, operands staged as
// float32 in shared memory from bf16 or float32 inputs, masks applied
// before the exp. P is 64 (mamba2-780m and zamba2-7b), N 64 or 128. x, B
// and C may be strided views (last dimension contiguous, rows 16-byte
// aligned); dy is contiguous (b, L, H, P); dx, dB, dC are written
// contiguous in the inputs' type, rounded once; the rest is float32.
//
// What bounds it on this card. At the training path's shape (b 16, L 4096,
// H 48, P 64, N 128, Q 256, bf16) the gradient must read x, dy, B, C, dts,
// la and the entering states S_c and write dx, dB, dC, d dts and d da: about
// 1.3 GB, ~0.4 ms at 3.35 TB/s; its products are ~0.5 TFLOP, ~0.5 ms at
// the dense bf16 tensor-core rate (chip_smoke.py:ssd_bwd_bound counts both
// for the inputs it is given). This first design runs float32 FMA from
// shared memory on the CUDA cores (67 TFLOP/s), recomputes C B^T in every
// head block and dW in every shared block, and writes R and g (the size of
// S_c) between launches: it is bound by the issue rate of those FMA and
// their shared-memory loads. wgmma on bf16 tiles and TMA-fed stages are
// the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;      // threads per block
constexpr int PD = 64;        // head dim P
constexpr int TQ = 64;        // rows of a tile
constexpr int NS = 32;        // state columns of a shared block of bK3
constexpr int PAD = 4;        // floats of padding per shared row
constexpr int QMAX = 256;     // the longest chunk
constexpr int LD64 = TQ + PAD;
constexpr int LDS = NS + PAD;

struct Args {
  const void* x;              // (b, L, H, P), strided
  const float* dts;           // (b, L, H)
  const float* la;            // (b, L, H)
  const void* B;              // (b, L, N), strided
  const void* C;              // (b, L, N), strided
  const float* D;             // (H,)
  const void* dy;             // (b, L, H, P) contiguous
  const float* st;            // (b, nc, H, P, N): S_c
  float* gbuf;                // (b, nc, H, P, N): R (bK1), then g (bK2)
  const float* dstate;        // (b, H, P, N) or null
  float* dinit;               // (b, H, P, N) or null
  float* dle;                 // (b, nc, H)
  void* dx;                   // (b, L, H, P)
  float* ddts;                // (b, L, H)
  float* dda;                 // (b, L, H)
  void* dB;                   // (b, L, N)
  void* dC;                   // (b, L, N)
  float* dDp;                 // (b, nc, H): dy.x per chunk and head
  int b, L, H, N, Q, nc;
  int64_t xb, xl, xh, bb, bl, cb, cl;   // strides in elements
};

// 16-byte global loads, converted to float32.
__device__ inline void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ inline void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ inline void store1(float* dst, float v) { *dst = v; }
__device__ inline void store1(__nv_bfloat16* dst, float v) {
  *dst = __float2bfloat16_rn(v);
}

// `rows` rows of COLS elements from global (row stride `stride`) into
// shared float32 rows of `ld`.
template <typename T, int COLS>
__device__ inline void load_rows(const T* __restrict__ src, int64_t stride,
                                 int rows, float* __restrict__ dst, int ld) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER_ROW = COLS / VN;
  static_assert(COLS % VN == 0, "a row must be whole 16-byte loads");
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NTH) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VN;
    float f[VN];
    load16(src + r * stride + c, f);
#pragma unroll
    for (int j = 0; j < VN; j += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
}

__device__ inline float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// acc[i][j] = sum_k A[r0 + i][k] * Bm[c0 + 16 j][k], k < K, in k order.
template <int K>
__device__ inline void prod44(const float* __restrict__ A, int lda, int r0,
                              const float* __restrict__ Bm, int ldb, int c0,
                              float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(r0 + i) * lda + k]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&Bm[(c0 + 16 * j) * ldb + k]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// sum over the 16 lanes that share a row group (lanes 0-15 or 16-31)
__device__ inline float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// one value per block, summed in a fixed order; `red` holds NTH / 32
__device__ inline float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NTH / 32; ++w) t += red[w];
  return t;                   // valid in thread 0
}

__host__ __device__ constexpr int dstate_smem_floats(int N) {
  return TQ * LD64 + TQ * (N + PAD) + TQ;
}

__host__ __device__ constexpr int head_smem_floats(int Q, int N) {
  return PD * (N + PAD) + 2 * TQ * LD64 + 2 * TQ * (N + PAD) + 3 * TQ * LD64 +
         6 * Q + NTH / 32;
}

__host__ __device__ constexpr int shared_smem_floats(int Q) {
  return 4 * Q * LDS + 3 * TQ * LD64 + 2 * PD * LDS + 4 * Q;
}

// ---------------------------------------------------------------------------
// bK1: R_c = sum_s exp(la_s) dy_s^T C_s, grid (nc, H, b)
// ---------------------------------------------------------------------------
template <typename T, int N>
__global__ void __launch_bounds__(NTH) ssd_bwd_dstate_kernel(Args a) {
  constexpr int LDN = N + PAD;
  constexpr int NJ = N / 16;             // state columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                     // [TQ][LD64]
  float* cs = dys + TQ * LD64;           // [TQ][LDN]
  float* el = cs + TQ * LDN;             // [TQ] exp(la)
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, pg = tid >> 4, ng = tid & 15;
  const int64_t l0 = static_cast<int64_t>(c) * a.Q;
  const int64_t dyl = static_cast<int64_t>(a.H) * PD;
  const T* dy = static_cast<const T*>(a.dy) +
                (static_cast<int64_t>(b) * a.L + l0) * dyl + h * PD;
  const T* Cm = static_cast<const T*>(a.C) + b * a.cb + l0 * a.cl;
  const int64_t dbase = (static_cast<int64_t>(b) * a.L + l0) * a.H + h;

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < a.Q; k += TQ) {
    __syncthreads();
    load_rows<T, PD>(dy + k * dyl, dyl, TQ, dys, LD64);
    load_rows<T, N>(Cm + k * a.cl, a.cl, TQ, cs, LDN);
    for (int i = tid; i < TQ; i += NTH) el[i] = expf(a.la[dbase + (k + i) * a.H]);
    __syncthreads();
#pragma unroll 4
    for (int s = 0; s < TQ; ++s) {
      const float e = el[s];
      const float4 d4 = *reinterpret_cast<const float4*>(&dys[s * LD64 + pg * 4]);
      const float d[4] = {d4.x * e, d4.y * e, d4.z * e, d4.w * e};
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float cv = cs[s * LDN + ng + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(d[i], cv, acc[i][j]);
      }
    }
  }
  float* R = a.gbuf + ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * PD * N;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) R[(pg * 4 + i) * N + ng + 16 * j] = acc[i][j];
}

// ---------------------------------------------------------------------------
// bK2: the reverse scan over chunks, grid (H, b); each thread owns P * N /
// NTH entries of the state's gradient. gbuf holds R_c and is overwritten
// with g_c; the decay's multiply and the add round separately, as the
// plain version's.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(NTH) ssd_bwd_scan_kernel(Args a) {
  constexpr int E = PD * N / NTH;
  __shared__ float red[NTH / 32];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  constexpr int64_t hs = static_cast<int64_t>(PD) * N;
  const int64_t fb = (static_cast<int64_t>(b) * a.H + h) * hs;
  float g[E];
#pragma unroll
  for (int e = 0; e < E; ++e) g[e] = a.dstate ? a.dstate[fb + tid + NTH * e] : 0.f;
  for (int c = a.nc - 1; c >= 0; --c) {
    const float decay = expf(a.la[((static_cast<int64_t>(b) * a.L +
                                    static_cast<int64_t>(c) * a.Q + a.Q - 1) *
                                   a.H) + h]);
    const int64_t base = ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * hs;
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int64_t i = base + tid + NTH * e;
      const float r = a.gbuf[i];
      part = fmaf(g[e], a.st[i], part);
      a.gbuf[i] = g[e];
      g[e] = __fadd_rn(__fmul_rn(g[e], decay), r);
    }
    const float tot = block_sum(part, red);
    if (tid == 0) a.dle[(static_cast<int64_t>(b) * a.nc + c) * a.H + h] = decay * tot;
    __syncthreads();                     // red is free again
  }
  if (a.dinit)
#pragma unroll
    for (int e = 0; e < E; ++e) a.dinit[fb + tid + NTH * e] = g[e];
}

// ---------------------------------------------------------------------------
// bK3, a head block (b, chunk, head): dx, d dts, d da and D's partial sum
// ---------------------------------------------------------------------------
template <typename T, int N>
__device__ void head_grads(const Args& a, int b, int c, int h, float* smem) {
  constexpr int LDN = N + PAD;
  const int Q = a.Q, nt = Q / TQ;
  float* sst = smem;                     // [PD][LDN] S_c, then g_c
  float* xt = sst + PD * LDN;            // [TQ][LD64] x of the key tile
  float* dys = xt + TQ * LD64;           // [TQ][LD64] dy of the query tile
  float* bt = dys + TQ * LD64;           // [TQ][LDN] B of the key tile
  float* cs = bt + TQ * LDN;             // [TQ][LDN] C of the query tile
  float* wt = cs + TQ * LDN;             // [TQ][LD64] W
  float* at = wt + TQ * LD64;            // [TQ][LD64] A = dW W
  float* mt = at + TQ * LD64;            // [TQ][LD64] dW G M
  float* la = mt + TQ * LD64;            // [Q]
  float* dtv = la + Q;                   // [Q]
  float* dlr = dtv + Q;                  // [Q] d la: row sums, exp(la) C S^T
  float* dlc = dlr + Q;                  // [Q] d la: column sums, -v
  float* ddt = dlc + Q;                  // [Q] d dts
  float* vv = ddt + Q;                   // [Q] v
  float* red = vv + Q;                   // [NTH / 32]

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int64_t l0 = static_cast<int64_t>(c) * Q;
  const int64_t dbase = (static_cast<int64_t>(b) * a.L + l0) * a.H + h;
  const int64_t sbase = ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * PD * N;
  const int64_t dyl = static_cast<int64_t>(a.H) * PD;
  const T* x = static_cast<const T*>(a.x) + b * a.xb + h * a.xh + l0 * a.xl;
  const T* dy = static_cast<const T*>(a.dy) +
                (static_cast<int64_t>(b) * a.L + l0) * dyl + h * PD;
  const T* Bm = static_cast<const T*>(a.B) + b * a.bb + l0 * a.bl;
  const T* Cm = static_cast<const T*>(a.C) + b * a.cb + l0 * a.cl;
  T* dx = static_cast<T*>(a.dx) + (static_cast<int64_t>(b) * a.L + l0) * dyl +
          h * PD;
  const float Dh = a.D[h];

  for (int i = tid; i < Q; i += NTH) {
    la[i] = a.la[dbase + i * a.H];
    dtv[i] = a.dts[dbase + i * a.H];
    dlc[i] = ddt[i] = vv[i] = 0.f;
  }
  load_rows<float, N>(a.st + sbase, N, PD, sst, LDN);
  __syncthreads();
  const float la_end = la[Q - 1];

  // d la_s = exp(la_s) dy_s.(C_s S_c^T), every row once
  for (int k = 0; k < nt; ++k) {
    __syncthreads();
    load_rows<T, N>(Cm + k * TQ * a.cl, a.cl, TQ, cs, LDN);
    load_rows<T, PD>(dy + k * TQ * dyl, dyl, TQ, dys, LD64);
    __syncthreads();
    float cst[4][4];
    prod44<N>(cs, LDN, rg * 4, sst, LDN, cg, cst);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float q = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        q = fmaf(cst[i][j], dys[(rg * 4 + i) * LD64 + cg + 16 * j], q);
      q = half_warp_sum(q);
      const int s = k * TQ + rg * 4 + i;
      if (cg == 0) dlr[s] = expf(la[s]) * q;
    }
  }
  __syncthreads();
  load_rows<float, N>(a.gbuf + sbase, N, PD, sst, LDN);   // g_c
  float dsum = 0.f;

  for (int ti = 0; ti < nt; ++ti) {
    const int t0 = ti * TQ;
    __syncthreads();                     // xt and bt are free
    load_rows<T, PD>(x + t0 * a.xl, a.xl, TQ, xt, LD64);
    load_rows<T, N>(Bm + t0 * a.bl, a.bl, TQ, bt, LDN);
    float dxa[4][4];                     // rows t = rg*4 + i, P cols cg + 16j
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dxa[i][j] = 0.f;

    for (int si = ti; si < nt; ++si) {
      const int s0 = si * TQ;
      __syncthreads();                   // cs, dys, wt, at, mt are free
      load_rows<T, N>(Cm + s0 * a.cl, a.cl, TQ, cs, LDN);
      load_rows<T, PD>(dy + s0 * dyl, dyl, TQ, dys, LD64);
      __syncthreads();
      float G[4][4], dW[4][4];           // rows s = rg*4 + i, keys cg + 16j
      prod44<N>(cs, LDN, rg * 4, bt, LDN, cg, G);
      prod44<PD>(dys, LD64, rg * 4, xt, LD64, cg, dW);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + rg * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int t = t0 + cg + 16 * j;
          float w = 0.f, m = 0.f, av = 0.f;
          if (s >= t) {                  // mask before the exp
            const float gm = G[i][j] * expf(la[s] - la[t]);
            w = gm * dtv[t];
            m = dW[i][j] * gm;
            av = m * dtv[t];
          }
          const int o = (rg * 4 + i) * LD64 + cg + 16 * j;
          wt[o] = w;
          mt[o] = m;
          at[o] = av;
        }
      }
      if (si == ti) {                    // D dy_t, and D's sum dy.x
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = (rg * 4 + i) * LD64 + cg + 16 * j;
            dxa[i][j] = fmaf(Dh, dys[o], dxa[i][j]);
            dsum = fmaf(dys[o], xt[o], dsum);
          }
      }
      __syncthreads();
      // dx_t += sum_s W[s, t] dy_s
#pragma unroll 4
      for (int s = 0; s < TQ; ++s) {
        const float4 w4 = *reinterpret_cast<const float4*>(&wt[s * LD64 + rg * 4]);
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) d[j] = dys[s * LD64 + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dxa[i][j] = fmaf(comp(w4, i), d[j], dxa[i][j]);
      }
      // row sums of A into d la_s, column sums out of d la_t and into
      // d dts_t, each entry by one thread in a fixed order
      if (tid < TQ) {
        float r = 0.f;
        for (int t = 0; t < TQ; ++t) r += at[tid * LD64 + t];
        dlr[s0 + tid] += r;
      } else if (tid < 2 * TQ) {
        const int t = tid - TQ;
        float r = 0.f;
        for (int s = 0; s < TQ; ++s) r += at[s * LD64 + t];
        dlc[t0 + t] -= r;
      } else if (tid < 3 * TQ) {
        const int t = tid - 2 * TQ;
        float r = 0.f;
        for (int s = 0; s < TQ; ++s) r += mt[s * LD64 + t];
        ddt[t0 + t] += r;
      }
    }
    __syncthreads();
    // the state's terms: g B_t (rows t, P cols), into dx, d dts and v
    float gb[4][4];
    prod44<N>(bt, LDN, rg * 4, sst, LDN, cg, gb);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + rg * 4 + i;
      const float e2 = expf(la_end - la[t]);
      const float wv = e2 * dtv[t];
      float xg = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dxa[i][j] = fmaf(wv, gb[i][j], dxa[i][j]);
        xg = fmaf(xt[(rg * 4 + i) * LD64 + cg + 16 * j], gb[i][j], xg);
      }
      xg = half_warp_sum(xg);
      if (cg == 0) {
        const float u = e2 * xg;
        const float v = dtv[t] * u;
        ddt[t] += u;
        vv[t] = v;
        dlc[t] -= v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store1(dx + (t0 + rg * 4 + i) * dyl + cg + 16 * j, dxa[i][j]);
  }
  __syncthreads();
  const float dtot = block_sum(dsum, red);
  if (tid == 0) {
    a.dDp[(static_cast<int64_t>(b) * a.nc + c) * a.H + h] = dtot;
    float e = a.dle[(static_cast<int64_t>(b) * a.nc + c) * a.H + h];
    for (int t = 0; t < Q; ++t) e += vv[t];
    float acc = 0.f;                     // d da: reverse cumulative sum
    for (int t = Q - 1; t >= 0; --t) {
      acc += dlr[t] + dlc[t] + (t == Q - 1 ? e : 0.f);
      dlr[t] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < Q; i += NTH) {
    a.dda[dbase + i * a.H] = dlr[i];
    a.ddts[dbase + i * a.H] = ddt[i];
  }
}

// ---------------------------------------------------------------------------
// bK3, a shared block (b, chunk, 32 state columns): dB and dC, the heads
// walked in order
// ---------------------------------------------------------------------------
template <typename T, int N>
__device__ void shared_grads(const Args& a, int b, int c, int ns, float* smem) {
  const int Q = a.Q, nt = Q / TQ, n0 = ns * NS;
  float* bsl = smem;                     // [Q][LDS] B's columns
  float* csl = bsl + Q * LDS;            // [Q][LDS] C's columns
  float* accc = csl + Q * LDS;           // [Q][LDS] dC
  float* accb = accc + Q * LDS;          // [Q][LDS] dB
  float* xt = accb + Q * LDS;            // [TQ][LD64]
  float* dys = xt + TQ * LD64;           // [TQ][LD64]
  float* dg = dys + TQ * LD64;           // [TQ][LD64] dG of a tile pair
  float* ssl = dg + TQ * LD64;           // [PD][LDS] S_c's columns
  float* gsl = ssl + PD * LDS;           // [PD][LDS] g_c's columns
  float* la = gsl + PD * LDS;            // [Q]
  float* dtv = la + Q;                   // [Q]
  float* el = dtv + Q;                   // [Q] exp(la)
  float* wv = el + Q;                    // [Q] exp(la_end - la) dts

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int r = tid >> 2, nq = tid & 3;  // accumulators: row r, cols nq + 4u
  const int64_t l0 = static_cast<int64_t>(c) * Q;
  const int64_t dyl = static_cast<int64_t>(a.H) * PD;
  const T* X = static_cast<const T*>(a.x) + b * a.xb + l0 * a.xl;
  const T* DY = static_cast<const T*>(a.dy) +
                (static_cast<int64_t>(b) * a.L + l0) * dyl;
  load_rows<T, NS>(static_cast<const T*>(a.B) + b * a.bb + l0 * a.bl + n0,
                   a.bl, Q, bsl, LDS);
  load_rows<T, NS>(static_cast<const T*>(a.C) + b * a.cb + l0 * a.cl + n0,
                   a.cl, Q, csl, LDS);
  for (int i = tid; i < Q * LDS; i += NTH) accc[i] = accb[i] = 0.f;

  for (int h = 0; h < a.H; ++h) {
    __syncthreads();
    const int64_t dbase = (static_cast<int64_t>(b) * a.L + l0) * a.H + h;
    const int64_t sbase =
        ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) * PD * N + n0;
    for (int i = tid; i < Q; i += NTH) {
      la[i] = a.la[dbase + i * a.H];
      dtv[i] = a.dts[dbase + i * a.H];
    }
    load_rows<float, NS>(a.st + sbase, N, PD, ssl, LDS);
    load_rows<float, NS>(a.gbuf + sbase, N, PD, gsl, LDS);
    __syncthreads();
    const float la_end = la[Q - 1];
    for (int i = tid; i < Q; i += NTH) {
      el[i] = expf(la[i]);
      wv[i] = expf(la_end - la[i]) * dtv[i];
    }
    const T* x = X + h * a.xh;
    const T* dy = DY + h * PD;
    // exp(la_s) dy_s S_c into dC_s, exp(la_end - la_t) dts_t x_t g_c into dB_t
    for (int k = 0; k < nt; ++k) {
      __syncthreads();
      load_rows<T, PD>(dy + k * TQ * dyl, dyl, TQ, dys, LD64);
      load_rows<T, PD>(x + k * TQ * a.xl, a.xl, TQ, xt, LD64);
      __syncthreads();
      float sc[8], sb[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) sc[u] = sb[u] = 0.f;
#pragma unroll 4
      for (int p = 0; p < PD; ++p) {
        const float d = dys[r * LD64 + p], xv = xt[r * LD64 + p];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          sc[u] = fmaf(d, ssl[p * LDS + nq + 4 * u], sc[u]);
          sb[u] = fmaf(xv, gsl[p * LDS + nq + 4 * u], sb[u]);
        }
      }
      const int s = k * TQ + r;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        accc[s * LDS + nq + 4 * u] = fmaf(el[s], sc[u], accc[s * LDS + nq + 4 * u]);
        accb[s * LDS + nq + 4 * u] = fmaf(wv[s], sb[u], accb[s * LDS + nq + 4 * u]);
      }
    }
    // dG over the causal tile pairs, into dC_s and dB_t
    for (int ti = 0; ti < nt; ++ti) {
      for (int si = ti; si < nt; ++si) {
        __syncthreads();
        load_rows<T, PD>(dy + si * TQ * dyl, dyl, TQ, dys, LD64);
        load_rows<T, PD>(x + ti * TQ * a.xl, a.xl, TQ, xt, LD64);
        __syncthreads();
        float dW[4][4];
        prod44<PD>(dys, LD64, rg * 4, xt, LD64, cg, dW);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = si * TQ + rg * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = ti * TQ + cg + 16 * j;
            dg[(rg * 4 + i) * LD64 + cg + 16 * j] =
                s >= t ? dW[i][j] * expf(la[s] - la[t]) * dtv[t] : 0.f;
          }
        }
        __syncthreads();
        float pc[8], pb[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) pc[u] = pb[u] = 0.f;
#pragma unroll 4
        for (int q = 0; q < TQ; ++q) {
          const float g1 = dg[r * LD64 + q];     // dG[s = r][t = q]
          const float g2 = dg[q * LD64 + r];     // dG[s = q][t = r]
          const float* brow = &bsl[(ti * TQ + q) * LDS + nq];
          const float* crow = &csl[(si * TQ + q) * LDS + nq];
#pragma unroll
          for (int u = 0; u < 8; ++u) {
            pc[u] = fmaf(g1, brow[4 * u], pc[u]);
            pb[u] = fmaf(g2, crow[4 * u], pb[u]);
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          accc[(si * TQ + r) * LDS + nq + 4 * u] += pc[u];
          accb[(ti * TQ + r) * LDS + nq + 4 * u] += pb[u];
        }
      }
    }
  }
  __syncthreads();
  T* dC = static_cast<T*>(a.dC) + (static_cast<int64_t>(b) * a.L + l0) * a.N + n0;
  T* dB = static_cast<T*>(a.dB) + (static_cast<int64_t>(b) * a.L + l0) * a.N + n0;
  for (int i = tid; i < Q * NS; i += NTH) {
    const int s = i / NS, n = i % NS;
    store1(dC + static_cast<int64_t>(s) * a.N + n, accc[s * LDS + n]);
    store1(dB + static_cast<int64_t>(s) * a.N + n, accb[s * LDS + n]);
  }
}

// bK3: the first b * nc * N / NS blocks are shared blocks, the rest head
// blocks (the shared ones walk every head, so they start first)
template <typename T, int N>
__global__ void __launch_bounds__(NTH, 1) ssd_bwd_grads_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  constexpr int NSL = N / NS;
  const int64_t nb = static_cast<int64_t>(a.b) * a.nc * NSL;
  const int64_t i = blockIdx.x;
  if (i < nb) {
    shared_grads<T, N>(a, static_cast<int>(i / (a.nc * NSL)),
                       static_cast<int>((i / NSL) % a.nc),
                       static_cast<int>(i % NSL), smem);
  } else {
    const int64_t j = i - nb;
    head_grads<T, N>(a, static_cast<int>(j / (static_cast<int64_t>(a.nc) * a.H)),
                     static_cast<int>((j / a.H) % a.nc),
                     static_cast<int>(j % a.H), smem);
  }
}

int grads_smem_bytes(int Q, int N) {
  const int h = head_smem_floats(Q, N), s = shared_smem_floats(Q);
  return (h > s ? h : s) * static_cast<int>(sizeof(float));
}

int stage_smem_bytes(int stage, int Q, int N) {
  switch (stage) {
    case 0: return dstate_smem_floats(N) * static_cast<int>(sizeof(float));
    case 1: return 0;
    case 2: return grads_smem_bytes(Q, N);
    default: return -1;
  }
}

template <typename T, int N>
cudaError_t launch(int stage, const Args& a, cudaStream_t stream) {
  if (stage == 0) {
    auto kern = ssd_bwd_dstate_kernel<T, N>;
    const int smem = stage_smem_bytes(0, a.Q, N);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.nc, a.H, a.b), NTH, smem, stream>>>(a);
  } else if (stage == 1) {
    ssd_bwd_scan_kernel<N><<<dim3(a.H, a.b), NTH, 0, stream>>>(a);
  } else {
    auto kern = ssd_bwd_grads_kernel<T, N>;
    const int smem = stage_smem_bytes(2, a.Q, N);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int64_t blocks =
        static_cast<int64_t>(a.b) * a.nc * (N / NS + a.H);
    if (blocks > 0x7fffffff) return cudaErrorInvalidValue;
    kern<<<static_cast<unsigned>(blocks), NTH, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int stage, const Args& a, cudaStream_t s) {
  switch (a.N) {
    case 64: return launch<T, 64>(stage, a, s);
    case 128: return launch<T, 128>(stage, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. stage 0 is bK1, 1 bK2, 2 bK3; dtype 0
// is float32, 1 bfloat16 (of x, B, C, dy, dx, dB, dC); the rest float32.
// P is 64, N 64 or 128, Q a multiple of 64 up to 256 dividing L; strides
// in elements (last dimension contiguous, rows 16-byte aligned). A stage
// reads only its own pointers; dstate and dinit may be null. Returns a
// cudaError_t (0 on success); the launch is asynchronous, on `stream`.
extern "C" int ssd_chunk_bwd(int stage, int dtype, const void* x,
                             const void* dts, const void* la, const void* B,
                             const void* C, const void* D, const void* dy,
                             const void* st, void* gbuf, const void* dstate,
                             void* dinit, void* dle, void* dx, void* ddts,
                             void* dda, void* dB, void* dC, void* dDp, int b,
                             int L, int H, int P, int N, int Q, int64_t xb,
                             int64_t xl, int64_t xh, int64_t bb, int64_t bl,
                             int64_t cb, int64_t cl, void* stream) {
  if (b <= 0 || b > 65535 || H <= 0 || H > 65535 || P != PD || Q <= 0 ||
      Q > QMAX || Q % TQ != 0 || L <= 0 || L % Q != 0 || stage < 0 ||
      stage > 2)
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(dts), static_cast<const float*>(la),
               B, C, static_cast<const float*>(D), dy,
               static_cast<const float*>(st), static_cast<float*>(gbuf),
               static_cast<const float*>(dstate), static_cast<float*>(dinit),
               static_cast<float*>(dle), dx, static_cast<float*>(ddts),
               static_cast<float*>(dda), dB, dC, static_cast<float*>(dDp),
               b, L, H, N, Q, L / Q, xb, xl, xh, bb, bl, cb, cl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_n<float>(stage, a, s);
    case 1: return dispatch_n<__nv_bfloat16>(stage, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a stage at chunk Q and state size N, in bytes.
extern "C" int ssd_chunk_bwd_smem(int stage, int Q, int N) {
  return stage_smem_bytes(stage, Q, N);
}
