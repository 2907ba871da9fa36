// The backward pass of banded (sliding-window) causal attention for Hopper
// (sm_90a): dq, dk and dv of swa_attention_fwd / swa_attention_wgmma_fwd.
//
// The TPU kernel src/repro/kernels/swa.py:swa_attention_pallas has no
// backward: the reference trains through XLA's autodiff of the model zoo's
// src/repro/models/attention.py:swa_attention (chunk + halo, jnp), whose
// gradient is the flash backward of attention.py:_flash_vjp_bwd under the
// band mask. For query row r and key c of one (batch, head), with query
// head h reading KV head h / G:
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
// S, D); any strides with a contiguous last dimension and 16-byte aligned
// rows. Inputs float32 or bfloat16; all arithmetic float32; outputs in the
// input type. lse and delta are float32 workspaces (B, H, S).
//
// Three launches, no atomics, so two calls give the same bits:
//   1. swa_attention_bwd_stats: one block per (b, h, BQ query rows) walks
//      the key tiles of its band, as the forward does, for the row max and
//      sum (the forward's finite NEG_INF, masked p zeroed, max(l, 1e-30)),
//      writes lse, and delta = sum do * o from its rows;
//   2. swa_attention_bwd_dkdv: one block per (b, KV head, BK keys) keeps
//      its K and V tiles and the dk and dv sums in registers, and walks
//      the G query heads of its group in order, for each the query tiles
//      whose band covers its keys in order: S, P, dP = dO V^T and
//      dS = P (dP - delta) from the stats, then dv += P^T dO, dk +=
//      dS^T (q * scale);
//   3. swa_attention_bwd_dq: one block per (b, h, BQ query rows) walks the
//      key tiles of its band: S, P, dP, dS, dq += dS K, times scale once
//      at the end.
// lse is recomputed here rather than written by the forward, so the
// forward kernels stay as they are.
//
// Tiles. 256 threads form 16 row groups by 16 column groups; a row group's
// 16 threads are one half-warp (row sums by shuffles). BQ = BK = 64 at D
// 64 and 128, 32 at D 256 (a 64-row float32 tile of D 256 is 64 KB; four
// of them do not fit the 227 KB a block may hold). Operands sit in shared
// memory as float32 rows of D + 4 floats, q already times scale. Every
// product is float32 FMA from shared memory: S and dP as 16 x 16 thread
// tiles of (BQ / 16) rows by (BQ / 16) keys, the sums as (BK / 16) keys
// (or BQ / 16 rows) by D / 16 columns a thread. A query tile that shares
// no in-band pair with some of its rows gives those rows p = 0, so they
// add nothing (the same as the forward's wholly masked tile).
//
// What bounds it on this card. At the training path's shape (B 2, H 32,
// KV 8, S 16384, window 4096, D 128, bf16) the band holds 58.7 M pairs per
// (b, h): the five band products (s twice, dp, dv, dq, dk; s once more
// for the stats) are 2.5x the forward's two, ~4.8 TFLOP by the forward's
// counting, 4.9 ms at the dense bf16 tensor-core rate. This first design
// runs on the CUDA cores in float32 FMA (67 TFLOP/s peak), eight products
// of D per pair in all, so it is bound by FMA issue and shared-memory
// loads, not by bytes. Tensor cores (wgmma on bf16 tiles), TMA-fed tiles
// and an lse written by the forward are the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;      // 16 row groups x 16 column groups
constexpr int PAD = 4;        // floats of padding per shared row
constexpr float NEG_INF = -1e30f;

template <int D>
struct Tile {
  static constexpr int B = D == 256 ? 32 : 64;   // BQ = BK
  static constexpr int R = B / 16;               // rows (keys) a thread
  static constexpr int LD = D + PAD;             // shared row, floats
  static constexpr int LDP = B + PAD;            // shared row of P, dS
  static constexpr int DC = D / 64;              // float4 column groups
};

// Element strides (batch, head, row) of the eight tensors, in the order
// q, k, v, o, do, dq, dk, dv.
struct Strides {
  int64_t t[8][3];
};
enum { TQ, TK, TV, TO, TDO, TDQ, TDK, TDV };

__device__ inline void load16(const float* src, float* dst) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  dst[0] = a.x; dst[1] = a.y; dst[2] = a.z; dst[3] = a.w;
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

// 4 elements (16 bytes of float32, 8 of bf16) to float32.
__device__ inline void load4(const float* src, float* dst) { load16(src, dst); }

__device__ inline void load4(const __nv_bfloat16* src, float* dst) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  dst[0] = a.x; dst[1] = a.y; dst[2] = b.x; dst[3] = b.y;
}

__device__ inline void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ inline void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}

// ROWS x D elements from global (row stride `stride`) into shared float32
// rows of D + PAD, each value multiplied by `mul`.
template <typename T, int D, int ROWS>
__device__ inline void load_tile(const T* __restrict__ src, int64_t stride,
                                 float* __restrict__ dst, float mul) {
  constexpr int VN = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int PER_ROW = D / VN;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += NTH) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VN;
    float f[VN];
    load16(src + r * stride + c, f);
#pragma unroll
    for (int j = 0; j < VN; j += 4) {
      const float g[4] = {f[j] * mul, f[j + 1] * mul, f[j + 2] * mul,
                          f[j + 3] * mul};
      store4(dst + r * (D + PAD) + c + j, g);
    }
  }
}

// out[i][j] = a[rg*R + i] . b[cg + 16 j] over D, both shared float32 tiles
// of rows D + PAD.
template <int D>
__device__ inline void tile_dot(const float* __restrict__ a,
                                const float* __restrict__ b, int rg, int cg,
                                float (&out)[Tile<D>::R][Tile<D>::R]) {
  constexpr int R = Tile<D>::R, LD = Tile<D>::LD;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) out[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; d += 4) {
    float4 x[R], y[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      x[i] = *reinterpret_cast<const float4*>(&a[(rg * R + i) * LD + d]);
#pragma unroll
    for (int j = 0; j < R; ++j)
      y[j] = *reinterpret_cast<const float4*>(&b[(cg + 16 * j) * LD + d]);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        out[i][j] = fmaf(x[i].x, y[j].x, out[i][j]);
        out[i][j] = fmaf(x[i].y, y[j].y, out[i][j]);
        out[i][j] = fmaf(x[i].z, y[j].z, out[i][j]);
        out[i][j] = fmaf(x[i].w, y[j].w, out[i][j]);
      }
  }
}

// acc[i][.] += sum_c w[rg*R + i][c] * m[c][columns], for the thread's
// columns dc*64 + cg*4 .. +4; w is (rows, B + PAD), m is (B, D + PAD).
// With w transposed (`trans`), w[c][rg*R + i] is read instead.
template <int D, bool trans>
__device__ inline void tile_acc(const float* __restrict__ w,
                                const float* __restrict__ m, int rg, int cg,
                                float (&acc)[Tile<D>::R][4 * Tile<D>::DC]) {
  constexpr int R = Tile<D>::R, B = Tile<D>::B, LD = Tile<D>::LD,
                LDP = Tile<D>::LDP, DC = Tile<D>::DC;
#pragma unroll 4
  for (int c = 0; c < B; ++c) {
    float wv[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      wv[i] = trans ? w[c * LDP + rg * R + i] : w[(rg * R + i) * LDP + c];
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const float4 mv =
          *reinterpret_cast<const float4*>(&m[c * LD + dc * 64 + cg * 4]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i][dc * 4 + 0] = fmaf(wv[i], mv.x, acc[i][dc * 4 + 0]);
        acc[i][dc * 4 + 1] = fmaf(wv[i], mv.y, acc[i][dc * 4 + 1]);
        acc[i][dc * 4 + 2] = fmaf(wv[i], mv.z, acc[i][dc * 4 + 2]);
        acc[i][dc * 4 + 3] = fmaf(wv[i], mv.w, acc[i][dc * 4 + 3]);
      }
    }
  }
}

// Write a thread's R rows of acc (times `mul`) at rows row0 + rg*R + i of
// a (row stride `stride`) output.
template <typename T, int D>
__device__ inline void store_rows(T* __restrict__ base, int64_t stride,
                                  int row0, int rg, int cg,
                                  const float (&acc)[Tile<D>::R][4 * Tile<D>::DC],
                                  float mul) {
  constexpr int R = Tile<D>::R, DC = Tile<D>::DC;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    T* row = base + static_cast<int64_t>(row0 + rg * R + i) * stride;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const float f[4] = {acc[i][dc * 4] * mul, acc[i][dc * 4 + 1] * mul,
                          acc[i][dc * 4 + 2] * mul,
                          acc[i][dc * 4 + 3] * mul};
      store4(row + dc * 64 + cg * 4, f);
    }
  }
}

__device__ inline bool in_band(int r, int c, int window) {
  const int rel = r - c;
  return rel >= 0 && rel < window;
}

// P and dS' = P (dP - delta) of one (query tile q0, key tile k0) pair, for
// the thread's rows rg*R + i and keys cg + 16 j; lse and delta of each
// row are read through `row_lse(i)` and `row_delta(i)`.
template <int D, typename F, typename G2>
__device__ inline void probs(const float (&s)[Tile<D>::R][Tile<D>::R],
                             const float (&dp)[Tile<D>::R][Tile<D>::R],
                             int q0, int k0, int rg, int cg, int window,
                             F row_lse, G2 row_delta,
                             float (&p)[Tile<D>::R][Tile<D>::R],
                             float (&ds)[Tile<D>::R][Tile<D>::R]) {
  constexpr int R = Tile<D>::R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + rg * R + i;
    const float lse = row_lse(i), delta = row_delta(i);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const bool valid = in_band(r, k0 + cg + 16 * j, window);
      p[i][j] = valid ? expf(s[i][j] - lse) : 0.f;
      ds[i][j] = p[i][j] * (dp[i][j] - delta);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. row statistics: lse over the band, delta = sum do * o
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
swa_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ lse, float* __restrict__ delta,
                     int H, int G, int S, int window, float scale,
                     Strides st) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::B, BK = Tl::B, R = Tl::R, DC = Tl::DC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [BQ][LD]  q * scale
  float* ks = qs + BQ * Tl::LD;          // [BK][LD]

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / G;
  const int q0 = blockIdx.x * BQ;

  load_tile<T, D, BQ>(q + b * st.t[TQ][0] + h * st.t[TQ][1] + q0 * st.t[TQ][2],
                      st.t[TQ][2], qs, scale);
  const T* kbase = k + b * st.t[TK][0] + kh * st.t[TK][1];

  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) { m[i] = NEG_INF; l[i] = 0.f; }

  const int lo = max(0, q0 - window + 1);      // lowest in-band key
  for (int k0 = (lo / BK) * BK; k0 < q0 + BQ; k0 += BK) {
    __syncthreads();                           // last step is done with ks
    load_tile<T, D, BK>(kbase + k0 * st.t[TK][2], st.t[TK][2], ks, 1.f);
    __syncthreads();
    float s[R][R];
    tile_dot<D>(qs, ks, rg, cg, s);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = q0 + rg * R + i;
      bool valid[R];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        valid[j] = in_band(r, k0 + cg + 16 * j, window);
        if (!valid[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j)
        sum += valid[j] ? expf(s[i][j] - m_new) : 0.f;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * expf(m[i] - m_new) + sum;
      m[i] = m_new;
    }
  }

  const T* obase = o + b * st.t[TO][0] + h * st.t[TO][1];
  const T* dbase = dout + b * st.t[TDO][0] + h * st.t[TDO][1];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = q0 + rg * R + i;
    float part = 0.f;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      float a[4], c[4];
      load4(obase + r * st.t[TO][2] + dc * 64 + cg * 4, a);
      load4(dbase + r * st.t[TDO][2] + dc * 64 + cg * 4, c);
#pragma unroll
      for (int e = 0; e < 4; ++e) part = fmaf(a[e], c[e], part);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (cg == 0) {
      lse[static_cast<int64_t>(bh) * S + r] = m[i] + logf(fmaxf(l[i], 1e-30f));
      delta[static_cast<int64_t>(bh) * S + r] = part;
    }
  }
}

// ---------------------------------------------------------------------------
// 2. dk and dv: one block per (b, KV head, key tile)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
swa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dk,
                    T* __restrict__ dv, int H, int KV, int G, int S,
                    int window, float scale, Strides st) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::B, BK = Tl::B, R = Tl::R, LD = Tl::LD,
                LDP = Tl::LDP, DC = Tl::DC;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                      // [BK][LD]
  float* vs = ks + BK * LD;              // [BK][LD]
  float* qs = vs + BK * LD;              // [BQ][LD]  q * scale
  float* dos = qs + BQ * LD;             // [BQ][LD]
  float* ps = dos + BQ * LD;             // [BQ][LDP] P
  float* dss = ps + BQ * LDP;            // [BQ][LDP] dS'
  float* lses = dss + BQ * LDP;          // [BQ]
  float* deltas = lses + BQ;             // [BQ]

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int b = blockIdx.y / KV, kh = blockIdx.y % KV;
  const int k0 = blockIdx.x * BK;

  load_tile<T, D, BK>(k + b * st.t[TK][0] + kh * st.t[TK][1] + k0 * st.t[TK][2],
                      st.t[TK][2], ks, 1.f);
  load_tile<T, D, BK>(v + b * st.t[TV][0] + kh * st.t[TV][1] + k0 * st.t[TV][2],
                      st.t[TV][2], vs, 1.f);

  float acc_dk[R][4 * DC], acc_dv[R][4 * DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) { acc_dk[i][c] = 0.f; acc_dv[i][c] = 0.f; }

  // rows that see a key of this tile: k0 .. k0 + BK - 2 + window
  const int rows_end = min(S, k0 + BK - 1 + window);
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const int64_t bh = static_cast<int64_t>(b) * H + h;
    const T* qbase = q + b * st.t[TQ][0] + h * st.t[TQ][1];
    const T* dbase = dout + b * st.t[TDO][0] + h * st.t[TDO][1];
    for (int q0 = k0; q0 < rows_end; q0 += BQ) {
      __syncthreads();                   // last step is done with qs .. dss
      load_tile<T, D, BQ>(qbase + q0 * st.t[TQ][2], st.t[TQ][2], qs, scale);
      load_tile<T, D, BQ>(dbase + q0 * st.t[TDO][2], st.t[TDO][2], dos, 1.f);
      if (tid < BQ) {
        lses[tid] = lse[bh * S + q0 + tid];
        deltas[tid] = delta[bh * S + q0 + tid];
      }
      __syncthreads();
      float s[R][R], dp[R][R], p[R][R], ds[R][R];
      tile_dot<D>(qs, ks, rg, cg, s);
      tile_dot<D>(dos, vs, rg, cg, dp);
      probs<D>(s, dp, q0, k0, rg, cg, window,
               [&](int i) { return lses[rg * R + i]; },
               [&](int i) { return deltas[rg * R + i]; }, p, ds);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          ps[(rg * R + i) * LDP + cg + 16 * j] = p[i][j];
          dss[(rg * R + i) * LDP + cg + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // keys rg*R + i: dv += P^T dO, dk += dS'^T (q * scale)
      tile_acc<D, true>(ps, dos, rg, cg, acc_dv);
      tile_acc<D, true>(dss, qs, rg, cg, acc_dk);
    }
  }

  store_rows<T, D>(dk + b * st.t[TDK][0] + kh * st.t[TDK][1], st.t[TDK][2], k0,
                   rg, cg, acc_dk, 1.f);
  store_rows<T, D>(dv + b * st.t[TDV][0] + kh * st.t[TDV][1], st.t[TDV][2], k0,
                   rg, cg, acc_dv, 1.f);
}

// ---------------------------------------------------------------------------
// 3. dq: one block per (b, h, query tile)
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NTH, 1)
swa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta, T* __restrict__ dq, int H,
                  int G, int S, int window, float scale, Strides st) {
  using Tl = Tile<D>;
  constexpr int BQ = Tl::B, BK = Tl::B, R = Tl::R, LD = Tl::LD,
                LDP = Tl::LDP, DC = Tl::DC;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [BQ][LD]  q * scale
  float* dos = qs + BQ * LD;             // [BQ][LD]
  float* ks = dos + BQ * LD;             // [BK][LD]
  float* vs = ks + BK * LD;              // [BK][LD]
  float* dss = vs + BK * LD;             // [BQ][LDP] dS'

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int bh = blockIdx.y, b = bh / H, h = bh % H, kh = h / G;
  const int q0 = blockIdx.x * BQ;

  load_tile<T, D, BQ>(q + b * st.t[TQ][0] + h * st.t[TQ][1] + q0 * st.t[TQ][2],
                      st.t[TQ][2], qs, scale);
  load_tile<T, D, BQ>(dout + b * st.t[TDO][0] + h * st.t[TDO][1] +
                          q0 * st.t[TDO][2],
                      st.t[TDO][2], dos, 1.f);
  float row_lse[R], row_delta[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    row_lse[i] = lse[static_cast<int64_t>(bh) * S + q0 + rg * R + i];
    row_delta[i] = delta[static_cast<int64_t>(bh) * S + q0 + rg * R + i];
  }
  const T* kbase = k + b * st.t[TK][0] + kh * st.t[TK][1];
  const T* vbase = v + b * st.t[TV][0] + kh * st.t[TV][1];

  float acc[R][4 * DC];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.f;

  const int lo = max(0, q0 - window + 1);      // lowest in-band key
  for (int k0 = (lo / BK) * BK; k0 < q0 + BQ; k0 += BK) {
    __syncthreads();                           // last step is done with ks, vs, dss
    load_tile<T, D, BK>(kbase + k0 * st.t[TK][2], st.t[TK][2], ks, 1.f);
    load_tile<T, D, BK>(vbase + k0 * st.t[TV][2], st.t[TV][2], vs, 1.f);
    __syncthreads();
    float s[R][R], dp[R][R], p[R][R], ds[R][R];
    tile_dot<D>(qs, ks, rg, cg, s);
    tile_dot<D>(dos, vs, rg, cg, dp);
    probs<D>(s, dp, q0, k0, rg, cg, window,
             [&](int i) { return row_lse[i]; },
             [&](int i) { return row_delta[i]; }, p, ds);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) dss[(rg * R + i) * LDP + cg + 16 * j] = ds[i][j];
    __syncthreads();
    tile_acc<D, false>(dss, ks, rg, cg, acc);  // rows rg*R + i: dq += dS' K
  }

  store_rows<T, D>(dq + b * st.t[TDQ][0] + h * st.t[TDQ][1], st.t[TDQ][2], q0,
                   rg, cg, acc, scale);
}

template <int D>
constexpr int smem_bytes(int which) {
  using Tl = Tile<D>;
  const int tile = Tl::B * Tl::LD, ptile = Tl::B * Tl::LDP;
  const int floats = which == 0 ? 2 * tile                         // stats
                     : which == 1 ? 4 * tile + 2 * ptile + 2 * Tl::B  // dkdv
                                  : 4 * tile + ptile;             // dq
  return floats * static_cast<int>(sizeof(float));
}

template <typename K>
cudaError_t set_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float *lse, *delta;
  int B, H, KV, S, window;
  float scale;
  Strides st;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t launch(int which, const Args& a) {
  using Tl = Tile<D>;
  const int G = a.H / a.KV;
  const int bytes = smem_bytes<D>(which);
  cudaError_t err;
  if (which == 0) {
    auto kern = swa_bwd_stats_kernel<T, D>;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<dim3(a.S / Tl::B, a.B * a.H), NTH, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.lse,
        a.delta, a.H, G, a.S, a.window, a.scale, a.st);
  } else if (which == 1) {
    auto kern = swa_bwd_dkdv_kernel<T, D>;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<dim3(a.S / Tl::B, a.B * a.KV), NTH, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KV, G,
        a.S, a.window, a.scale, a.st);
  } else {
    auto kern = swa_bwd_dq_kernel<T, D>;
    if ((err = set_smem(kern, bytes)) != cudaSuccess) return err;
    kern<<<dim3(a.S / Tl::B, a.B * a.H), NTH, bytes, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
        a.delta, static_cast<T*>(a.dq), a.H, G, a.S, a.window, a.scale, a.st);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, int which, const Args& a) {
  switch (D) {
    case 64: return launch<T, 64>(which, a);
    case 128: return launch<T, 128>(which, a);
    case 256: return launch<T, 256>(which, a);
    default: return cudaErrorInvalidValue;
  }
}

int run(int which, int dtype, const void* q, const void* k, const void* v,
        const void* o, const void* dout, void* dq, void* dk, void* dv,
        float* lse, float* delta, int B, int H, int KV, int S, int D,
        int window, float scale, const int64_t* strides, void* stream) {
  // S a multiple of 128 covers every tile (64 or 32 rows)
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || S % 128 != 0 ||
      window <= 0 || static_cast<int64_t>(B) * H > 65535)
    return cudaErrorInvalidValue;
  Args a{q, k, v, o, dout, dq, dk, dv, lse, delta, B, H, KV, S, window,
         scale, {}, static_cast<cudaStream_t>(stream)};
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) a.st.t[t][j] = strides[3 * t + j];
  switch (dtype) {
    case 0: return dispatch_d<float>(D, which, a);
    case 1: return dispatch_d<__nv_bfloat16>(D, which, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry points, bound with ctypes; all three take the same arguments and
// each reads the ones it needs. dtype 0 is float32, 1 is bfloat16; D is 64,
// 128 or 256; S a multiple of 128; H a multiple of KV; `strides` holds 24
// element strides, (batch, head, row) of q, k, v, o, do, dq, dk, dv, whose
// last dimension is contiguous and rows 16-byte aligned; lse and delta are
// contiguous float32 (B, H, S). Each returns a cudaError_t (0 on success);
// launches are asynchronous, on `stream`.
#define SWA_BWD_ENTRY(name, which)                                            \
  extern "C" int name(int dtype, const void* q, const void* k, const void* v, \
                      const void* o, const void* dout, void* dq, void* dk,    \
                      void* dv, float* lse, float* delta, int B, int H,       \
                      int KV, int S, int D, int window, float scale,          \
                      const int64_t* strides, void* stream) {                 \
    return run(which, dtype, q, k, v, o, dout, dq, dk, dv, lse, delta, B, H,  \
               KV, S, D, window, scale, strides, stream);                     \
  }

SWA_BWD_ENTRY(swa_attention_bwd_stats, 0)
SWA_BWD_ENTRY(swa_attention_bwd_dkdv, 1)
SWA_BWD_ENTRY(swa_attention_bwd_dq, 2)

// Dynamic shared memory of each launch (0 stats, 1 dkdv, 2 dq) at head dim D.
extern "C" int swa_attention_bwd_smem(int which, int D) {
  switch (D) {
    case 64: return smem_bytes<64>(which);
    case 128: return smem_bytes<128>(which);
    case 256: return smem_bytes<256>(which);
    default: return -1;
  }
}
