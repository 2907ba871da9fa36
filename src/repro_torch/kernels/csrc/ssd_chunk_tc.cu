// Mamba2 SSD (state-space duality) chunk scan on bf16 tensor cores for
// Hopper (sm_90a): three chunk-parallel kernels.
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:ssd_chunked_pallas
// (body _ssd_kernel) for bf16 inputs; ssd_chunked.cu keeps float32 and the
// shapes this file does not take. Notation as in ssd_chunked.cu: x is
// (b, L, H, P), B and C are (b, L, N) shared by every head, dt (after
// softplus) and da = dt * a are float32 (b, L, H), D is float32 (H,). The
// sequence is cut into nc = L / Q chunks of Q rows, and la is the
// cumulative sum of da within a chunk. Per chunk c, with S_c the (P, N)
// state entering it:
//
//     ds_c    = (x * exp(la_end - la) * dt)^T B                 (K1)
//     S_c+1   = exp(la_end) S_c + ds_c                          (K2)
//     y       = W x + (C S_c^T) exp(la) + D x,                  (K3)
//     W[s, t] = (C B^T)[s, t] exp(la_s - la_t) dt_t for s >= t, else 0
//
// Translation. The TPU kernel runs the chunk axis in order, with the state
// in VMEM scratch. Here the chunk axis is parallel: K1 (grid nc x H x b)
// writes every chunk's ds into a float32 workspace st (b, nc, H, P, N); K2
// (one thread per (b, h, p, n)) walks the chunks in order, replacing each
// ds in st by the state entering that chunk and writing the final state;
// K3 (grid P/64 x nc x H*b) computes every chunk's y from its entering
// state. All three run on the caller's stream, in order, from one call.
//
// Numerics. Tensor cores are reached through nvcuda::wmma, bf16 m16n16k16
// fragments with float32 accumulators, loaded from and stored to shared
// memory only. B, C and x are bf16 inputs and enter a product as they are
// (C B^T is then exact in float32). The other operands are float32 values
// (u = x exp(la_end - la) dt in K1, S_c and W in K3). Each is split into
// NP = 3 bf16 parts, hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi -
// mid), 24 bits of it, and its product is taken once a part, into the same
// accumulator. Fewer parts miss the one-ulp gate of chip_smoke.py: one
// part of any of the three fails it on random inputs, and two parts fail
// it on the activations of the mamba2-780m model, where y is a small sum
// of large terms (W in two parts fails a few outputs in a million, and u
// and S_c in two parts leave up to 1.5 and 0.4 bf16 ulp of error before
// y's rounding, against 0.05 with three; see the emulation in
// tests/test_torch_ssm.py). la is summed in row order by one thread, as
// ssd_chunked.cu and the plain version add it; the mask is applied before
// the exp (above the diagonal la_s - la_t is positive and overflows); the
// state scan multiplies and adds with separate roundings, as the plain
// version does; D x is added to the float32 y before its one rounding.
//
// Shapes: P a multiple of 64 (one 64-column slice per K3 block, a loop of
// slices in K1), N 64 or 128, Q a multiple of 64 up to 256 (64-row slabs
// and tiles, no ragged edge), H * b <= 65535. x, B and C may be strided
// views (the last dimension contiguous, rows 16-byte aligned); tiles are
// staged into shared memory with plain 16-byte loads, since wmma loads
// need 32-byte aligned pointers that the views do not give.
//
// Shared memory: K1 47,104 bytes (the parts of u and a B slab of 64 rows,
// la and the weights), several blocks an SM. K3 223,232 bytes at Q 256,
// N 128 (the chunk's B and x slice, the parts of S_c, a C tile, a G tile
// and the parts of W; the epilogue's staging reuses G and W), one block an
// SM.
//
// What bounds it on this card. At the main path's shape (b 4, L 32768,
// H 48, P 64, N 128, Q 256, bf16) the function must move 1.697 GB, 0.51 ms
// at 3.35 TB/s (chip_smoke.py:ssd_bound). This design moves more: the
// workspaces la (25,165,824 bytes) and st (805,306,368 bytes) are written
// by K1, st is read and written by K2 and read by K3, and x is read by K1
// and K3: K1 1.720 GB, K2 1.617 GB, K3 2.533 GB, 5.870 GB in all, 1.75 ms
// at 3.35 TB/s, its own floor. Its tensor work at that shape: K1 12.58
// MFLOP a (b, chunk, head) (u^T B, three times), K3 38.80 MFLOP (C S^T
// three times, G on the 10 tile pairs of the triangle, W x three times),
// 1.263 TFLOP issued for the 0.31 TFLOP the function needs (G per head,
// every split product once a part): 1.28 ms at 989 TFLOP/s. So this
// design is bound by its bytes, with its tensor work close behind.
// Sharing G across heads, fusing the scan away (no st), TMA and wgmma are
// the next redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int NTH = 256;      // threads per block (8 warps) in K1 and K3
constexpr int T = 64;         // rows of a slab or tile, columns of a P slice
constexpr int QMAX = 256;     // the longest chunk
constexpr int PADH = 8;       // bf16 padding per shared row (16 bytes)
constexpr int PADF = 4;       // float padding per shared row (16 bytes)
constexpr int NP = 3;         // bf16 parts a float32 operand is split into

struct Args {
  const bf16* x;
  const float* dts;           // softplus(dt), (b, L, H) contiguous
  const float* da;            // softplus(dt) * a, (b, L, H) contiguous
  const bf16* B;
  const bf16* C;
  const float* D;             // (H,)
  const float* s0;            // (b, H, P, N) contiguous, or null
  float* la;                  // workspace (b, L, H)
  float* st;                  // workspace (b, nc, H, P, N)
  bf16* y;                    // (b, L, H, P) contiguous
  float* s_out;               // (b, H, P, N) contiguous
  int b, L, H, P, N, Q, nc;
  int64_t xb, xl, xh, bb, bl, cb, cl;   // strides in elements
};

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int STAGED = 8;     // 16-byte loads a thread keeps in flight

// `rows` rows of COLS bf16 from global (row stride `stride` elements) into
// shared rows of `ld` elements, 16 bytes a load. Each thread issues
// STAGED loads before it stores any: with one block an SM, nothing else
// hides their latency.
template <int COLS>
__device__ inline void copy_rows(const bf16* __restrict__ src, int64_t stride,
                                 int rows, bf16* __restrict__ dst, int ld) {
  constexpr int PER_ROW = COLS / 8;
  const int total = rows * PER_ROW;
  int i = threadIdx.x;
  for (; i + (STAGED - 1) * NTH < total; i += STAGED * NTH) {
    uint4 v[STAGED];
#pragma unroll
    for (int u = 0; u < STAGED; ++u) {
      const int k = i + u * NTH, r = k / PER_ROW, c = (k % PER_ROW) * 8;
      v[u] = *reinterpret_cast<const uint4*>(src + r * stride + c);
    }
#pragma unroll
    for (int u = 0; u < STAGED; ++u) {
      const int k = i + u * NTH, r = k / PER_ROW, c = (k % PER_ROW) * 8;
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v[u];
    }
  }
  for (; i < total; i += NTH) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

// V consecutive float32 values split into NP bf16 parts, each the bf16
// rounding of what the parts before it leave (hi, mid, lo); part j is
// stored as V bf16 at dst + j * stride (V * 2 bytes, aligned to that).
template <int V>
__device__ inline void split_store(const float* v, bf16* dst, int stride) {
  float r[V];
#pragma unroll
  for (int j = 0; j < V; ++j) r[j] = v[j];
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    __align__(16) __nv_bfloat162 h[V / 2];
#pragma unroll
    for (int j = 0; j < V / 2; ++j) {
      h[j] = __float22bfloat162_rn(make_float2(r[2 * j], r[2 * j + 1]));
      const float2 back = __bfloat1622float2(h[j]);
      r[2 * j] -= back.x;
      r[2 * j + 1] -= back.y;
    }
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(dst + k * stride) =
          *reinterpret_cast<const uint4*>(h);
    } else {
      static_assert(V == 4, "4 or 8 values");
      *reinterpret_cast<uint2*>(dst + k * stride) =
          *reinterpret_cast<const uint2*>(h);
    }
  }
}

__device__ inline void unpack8(const uint4& raw, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

// ---------------------------------------------------------------------------
// K1: la of the chunk, and ds = u^T B, u = x exp(la_end - la) dt.
// Grid (nc, H, b). Warp w owns ds rows 16*(w/2).. (P in the slice) and the
// N/32 column tiles from (w%2)*N/32.
// ---------------------------------------------------------------------------
template <int N>
__global__ void __launch_bounds__(NTH) ssd_chunk_state_kernel(Args a) {
  constexpr int LDU = T + PADH;          // shared row of u (P of the slice)
  constexpr int LDB = N + PADH;          // shared row of a B slab
  constexpr int LDF = N + PADF;          // shared row of the ds staging
  constexpr int NW = N / 32;             // accumulator tiles a warp owns
  constexpr int SLAB = NP * T * LDU * 2 + T * LDB * 2;
  constexpr int STAGE = T * LDF * 4;
  __shared__ __align__(128) unsigned char raw[SLAB > STAGE ? SLAB : STAGE];
  __shared__ float la[QMAX];
  __shared__ float wv[QMAX];
  bf16* us = reinterpret_cast<bf16*>(raw);  // NP parts of u, T * LDU each
  bf16* bs = us + NP * T * LDU;
  float* stage = reinterpret_cast<float*>(raw);

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Q = a.Q, l0 = c * Q, tid = threadIdx.x, warp = tid >> 5;
  const int mt = warp >> 1, nt0 = (warp & 1) * NW;
  const int64_t drow = (static_cast<int64_t>(b) * a.L + l0) * a.H + h;

  for (int i = tid; i < Q; i += NTH) la[i] = a.da[drow + i * int64_t(a.H)];
  __syncthreads();
  if (tid == 0) {                        // la in row order
    float acc = la[0];
    for (int i = 1; i < Q; ++i) {
      acc += la[i];
      la[i] = acc;
    }
  }
  __syncthreads();
  const float la_end = la[Q - 1];
  for (int i = tid; i < Q; i += NTH) {
    a.la[drow + i * int64_t(a.H)] = la[i];
    wv[i] = expf(la_end - la[i]) * a.dts[drow + i * int64_t(a.H)];
  }

  const bf16* Bm = a.B + b * a.bb + l0 * a.bl;
  for (int p0 = 0; p0 < a.P; p0 += T) {
    const bf16* x = a.x + b * a.xb + l0 * a.xl + h * a.xh + p0;
    Acc acc[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int t0 = 0; t0 < Q; t0 += T) {
      __syncthreads();                   // wv is written; the last slab read
      for (int i = tid; i < T * T / 8; i += NTH) {
        const int r = i / (T / 8), col = (i % (T / 8)) * 8;
        float u[8];
        unpack8(*reinterpret_cast<const uint4*>(x + (t0 + r) * a.xl + col), u);
        const float w = wv[t0 + r];
#pragma unroll
        for (int j = 0; j < 8; ++j) u[j] *= w;
        split_store<8>(u, us + r * LDU + col, T * LDU);
      }
      copy_rows<N>(Bm + t0 * a.bl, a.bl, T, bs, LDB);
      __syncthreads();
#pragma unroll
      for (int k = 0; k < T; k += 16) {
        FragAT au[NP];                   // A[p][t] = u[t][p]
#pragma unroll
        for (int q = 0; q < NP; ++q)
          wmma::load_matrix_sync(au[q], us + q * T * LDU + k * LDU + mt * 16,
                                 LDU);
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          FragB bf;
          wmma::load_matrix_sync(bf, bs + k * LDB + (nt0 + j) * 16, LDB);
#pragma unroll
          for (int q = 0; q < NP; ++q) wmma::mma_sync(acc[j], au[q], bf, acc[j]);
        }
      }
    }
    __syncthreads();                     // the slab is read: stage over it
#pragma unroll
    for (int j = 0; j < NW; ++j)
      wmma::store_matrix_sync(stage + mt * 16 * LDF + (nt0 + j) * 16, acc[j],
                              LDF, wmma::mem_row_major);
    __syncthreads();
    float* out = a.st + ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) *
                            a.P * N + static_cast<int64_t>(p0) * N;
    for (int i = tid; i < T * N / 4; i += NTH) {
      const int r = i / (N / 4), col = (i % (N / 4)) * 4;
      *reinterpret_cast<float4*>(out + r * N + col) =
          *reinterpret_cast<const float4*>(stage + r * LDF + col);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: the state scan over the chunks, float32, one (b, h, p, n) a thread.
// Grid (P*N/256, H, b). st holds ds_c and receives S_c in its place.
// ---------------------------------------------------------------------------
constexpr int SCAN_AHEAD = 8;            // chunks loaded before they are used

__global__ void __launch_bounds__(NTH) ssd_state_scan_kernel(Args a) {
  const int PN = a.P * a.N;
  const int e = blockIdx.x * NTH + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const int64_t cstep = static_cast<int64_t>(a.H) * PN;
  float* st = a.st + (static_cast<int64_t>(b) * a.nc * a.H + h) * PN + e;
  const float* lend = a.la + (static_cast<int64_t>(b) * a.L + a.Q - 1) * a.H + h;
  const int64_t lstep = static_cast<int64_t>(a.Q) * a.H;
  const int64_t so = (static_cast<int64_t>(b) * a.H + h) * PN + e;
  float S = a.s0 ? a.s0[so] : 0.f;
  for (int c0 = 0; c0 < a.nc; c0 += SCAN_AHEAD) {
    float ds[SCAN_AHEAD], dec[SCAN_AHEAD];
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      if (c0 + j < a.nc) {
        ds[j] = st[(c0 + j) * cstep];
        dec[j] = lend[(c0 + j) * lstep];
      }
    }
#pragma unroll
    for (int j = 0; j < SCAN_AHEAD; ++j) {
      if (c0 + j < a.nc) {
        st[(c0 + j) * cstep] = S;
        S = __fadd_rn(__fmul_rn(S, expf(dec[j])), ds[j]);
      }
    }
  }
  a.s_out[so] = S;
}

// ---------------------------------------------------------------------------
// K3: y of a chunk's 64-column P slice from the state entering the chunk.
// Grid (P/64, nc, H*b). Per 64-row query tile s: yint = C_s S^T (S in its
// parts), then for each key tile t <= s: G = C_s B_t^T, W from G in
// float32 through shared memory, y_acc += W x_t a part of W at a time.
// Warp w owns rows 16*(w/2).. of the tile and the 16-column tiles
// 2*(w%2), 2*(w%2)+1 (of P for y, of the keys for G).
// ---------------------------------------------------------------------------
__host__ __device__ constexpr int out_ldb(int N) { return N + PADH; }
constexpr int LDX = T + PADH;            // shared row of the x slice
constexpr int LDG = T + PADF;            // shared row of G (and y staging)
constexpr int LDW = T + PADH;            // shared row of a part of W

__host__ __device__ constexpr int out_smem(int Q, int N) {
  return Q * out_ldb(N) * 2              // the chunk's B
         + T * out_ldb(N) * 2            // a C tile
         + Q * LDX * 2                   // the chunk's x slice
         + NP * T * out_ldb(N) * 2       // the parts of S
         + T * LDG * 4                   // G, then the y_acc staging
         + NP * T * LDW * 2              // the parts of W, then yint staging
         + 2 * Q * 4;                    // la, dt
}

template <int N>
__global__ void __launch_bounds__(NTH, 1) ssd_chunk_out_kernel(Args a) {
  constexpr int LDB = out_ldb(N);
  static_assert(NP * T * LDW * 2 >= T * LDG * 4, "yint staging over W");
  extern __shared__ __align__(128) unsigned char smem[];
  const int Q = a.Q;
  bf16* Bs = reinterpret_cast<bf16*>(smem);
  bf16* Cs = Bs + Q * LDB;
  bf16* Xs = Cs + T * LDB;
  bf16* Ss = Xs + Q * LDX;               // NP parts of S, T * LDB each
  float* Gs = reinterpret_cast<float*>(Ss + NP * T * LDB);
  bf16* Ws = reinterpret_cast<bf16*>(Gs + T * LDG);  // NP parts, T * LDW
  float* Is = reinterpret_cast<float*>(Ws);
  float* las = reinterpret_cast<float*>(Ws + NP * T * LDW);
  float* dtv = las + Q;

  const int p0 = blockIdx.x * T, c = blockIdx.y;
  const int h = blockIdx.z % a.H, b = blockIdx.z / a.H;
  const int l0 = c * Q, tid = threadIdx.x, warp = tid >> 5;
  const int mt = warp >> 1, nt0 = (warp & 1) * 2;
  const int64_t drow = (static_cast<int64_t>(b) * a.L + l0) * a.H + h;
  const bf16* x = a.x + b * a.xb + l0 * a.xl + h * a.xh + p0;
  const bf16* Cm = a.C + b * a.cb + l0 * a.cl;
  bf16* y = a.y + ((static_cast<int64_t>(b) * a.L + l0) * a.H + h) * a.P + p0;
  const int64_t yrow = static_cast<int64_t>(a.H) * a.P;
  const float Dh = a.D[h];

  for (int i = tid; i < Q; i += NTH) {
    las[i] = a.la[drow + i * int64_t(a.H)];
    dtv[i] = a.dts[drow + i * int64_t(a.H)];
  }
  copy_rows<N>(a.B + b * a.bb + l0 * a.bl, a.bl, Q, Bs, LDB);
  copy_rows<T>(x, a.xl, Q, Xs, LDX);
  const float* s_in = a.st + ((static_cast<int64_t>(b) * a.nc + c) * a.H + h) *
                                 a.P * N + static_cast<int64_t>(p0) * N;
  {
    constexpr int R = T * N / 4 / NTH;   // float4 loads a thread: 8 or 4
    float4 v[R];
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = tid + u * NTH, r = i / (N / 4), col = (i % (N / 4)) * 4;
      v[u] = *reinterpret_cast<const float4*>(s_in + r * N + col);
    }
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int i = tid + u * NTH, r = i / (N / 4), col = (i % (N / 4)) * 4;
      const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      split_store<4>(f, Ss + r * LDB + col, T * LDB);
    }
  }

  for (int s0 = 0; s0 < Q; s0 += T) {
    __syncthreads();                     // the last tile's epilogue is done
    copy_rows<N>(Cm + s0 * a.cl, a.cl, T, Cs, LDB);
    __syncthreads();
    Acc yacc[2], yint[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(yacc[j], 0.f);
      wmma::fill_fragment(yint[j], 0.f);
    }
    // yint = C_s S^T: B[n][p] = S[p][n], column-major over S's rows
#pragma unroll
    for (int k = 0; k < N; k += 16) {
      FragA ca;
      wmma::load_matrix_sync(ca, Cs + mt * 16 * LDB + k, LDB);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int q = 0; q < NP; ++q) {
          FragBT sp;
          wmma::load_matrix_sync(
              sp, Ss + q * T * LDB + (nt0 + j) * 16 * LDB + k, LDB);
          wmma::mma_sync(yint[j], ca, sp, yint[j]);
        }
      }
    }
    for (int t0 = 0; t0 <= s0; t0 += T) {
      Acc g[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(g[j], 0.f);
      // G = C_s B_t^T: B[n][t] = B_t[t][n], column-major over B's rows
#pragma unroll
      for (int k = 0; k < N; k += 16) {
        FragA ca;
        wmma::load_matrix_sync(ca, Cs + mt * 16 * LDB + k, LDB);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragBT bt;
          wmma::load_matrix_sync(bt, Bs + (t0 + (nt0 + j) * 16) * LDB + k, LDB);
          wmma::mma_sync(g[j], ca, bt, g[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(Gs + mt * 16 * LDG + (nt0 + j) * 16, g[j], LDG,
                                wmma::mem_row_major);
      __syncthreads();
      // W, masked before the exp, split into its parts. A thread takes 4
      // keys of rows r0 + 16 k, k < 4: 16 independent values, their loads
      // first (the W step is bound by latency at 8 warps an SM).
      {
        constexpr int RG = NTH / (T / 4);  // row groups: 16
        const int r0 = tid / (T / 4), col = (tid % (T / 4)) * 4;
        const float4 lt = *reinterpret_cast<const float4*>(las + t0 + col);
        const float4 dv = *reinterpret_cast<const float4*>(dtv + t0 + col);
        const float ltf[4] = {lt.x, lt.y, lt.z, lt.w};
        const float dvf[4] = {dv.x, dv.y, dv.z, dv.w};
        float4 gv[T / RG];
        float ls[T / RG];
#pragma unroll
        for (int k = 0; k < T / RG; ++k) {
          gv[k] = *reinterpret_cast<const float4*>(Gs + (r0 + RG * k) * LDG +
                                                   col);
          ls[k] = las[s0 + r0 + RG * k];
        }
#pragma unroll
        for (int k = 0; k < T / RG; ++k) {
          const int s = s0 + r0 + RG * k;
          const float gf[4] = {gv[k].x, gv[k].y, gv[k].z, gv[k].w};
          float w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            w[u] = s >= t0 + col + u ? gf[u] * expf(ls[k] - ltf[u]) * dvf[u]
                                     : 0.f;
          split_store<4>(w, Ws + (r0 + RG * k) * LDW + col, T * LDW);
        }
      }
      __syncthreads();
      // y_acc += W x_t, one product a part of W
#pragma unroll
      for (int k = 0; k < T; k += 16) {
        FragA wp[NP];
#pragma unroll
        for (int q = 0; q < NP; ++q)
          wmma::load_matrix_sync(wp[q], Ws + q * T * LDW + mt * 16 * LDW + k,
                                 LDW);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB xb;
          wmma::load_matrix_sync(xb, Xs + (t0 + k) * LDX + (nt0 + j) * 16, LDX);
#pragma unroll
          for (int q = 0; q < NP; ++q)
            wmma::mma_sync(yacc[j], wp[q], xb, yacc[j]);
        }
      }
    }
    __syncthreads();                     // G and W are read: stage over them
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(Gs + mt * 16 * LDG + (nt0 + j) * 16, yacc[j], LDG,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(Is + mt * 16 * LDG + (nt0 + j) * 16, yint[j], LDG,
                              wmma::mem_row_major);
    }
    __syncthreads();
    // y = y_acc + yint exp(la) + D x, rounded once
    for (int i = tid; i < T * T / 8; i += NTH) {
      const int r = i / (T / 8), col = (i % (T / 8)) * 8;
      const int s = s0 + r;
      const float e = expf(las[s]);
      float xv[8];
      unpack8(*reinterpret_cast<const uint4*>(Xs + s * LDX + col), xv);
      __align__(16) bf16 o[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        o[j] = __float2bfloat16_rn(Gs[r * LDG + col + j] +
                                   Is[r * LDG + col + j] * e + Dh * xv[j]);
      *reinterpret_cast<uint4*>(y + s * yrow + col) =
          *reinterpret_cast<const uint4*>(o);
    }
  }
}

template <int N>
cudaError_t launch(int stages, const Args& a, cudaStream_t s) {
  if (stages & 1) {
    ssd_chunk_state_kernel<N><<<dim3(a.nc, a.H, a.b), NTH, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 2) {
    ssd_state_scan_kernel<<<dim3(a.P * N / NTH, a.H, a.b), NTH, 0, s>>>(a);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (stages & 4) {
    auto kern = ssd_chunk_out_kernel<N>;
    const int smem = out_smem(a.Q, N);
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<dim3(a.P / T, a.nc, a.H * a.b), NTH, smem, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// C entry point, bound with ctypes. `stages` selects the kernels to launch,
// in order: 1 K1 (reads x, dts, da, B; writes la and st), 2 K2 (reads la,
// st and s0, which may be null for a zero state; writes st and s_out), 4 K3
// (reads x, dts, la, B, C, D, st; writes y); 7 runs the scan. x, B, C and
// y are bfloat16, the rest float32. N is 64 or 128, P a multiple of 64,
// Q a multiple of 64 up to 256 with L % Q == 0, H * b <= 65535; strides
// are in elements (the last dimension contiguous) and every row 16-byte
// aligned. Returns a cudaError_t (0 on success); the launches are
// asynchronous, on `stream`.
extern "C" int ssd_chunk_tc_fwd(int stages, const void* x, const void* dts,
                                const void* da, const void* B, const void* C,
                                const void* D, const void* s0, void* la,
                                void* st, void* y, void* s_out, int b, int L,
                                int H, int P, int N, int Q, int64_t xb,
                                int64_t xl, int64_t xh, int64_t bb,
                                int64_t bl, int64_t cb, int64_t cl,
                                void* stream) {
  if (stages <= 0 || stages > 7 || b <= 0 || H <= 0 || H * b > 65535 ||
      P <= 0 || P % T != 0 || Q < T || Q > QMAX || Q % T != 0 || L <= 0 ||
      L % Q != 0)
    return cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(x), static_cast<const float*>(dts),
               static_cast<const float*>(da), static_cast<const bf16*>(B),
               static_cast<const bf16*>(C), static_cast<const float*>(D),
               static_cast<const float*>(s0), static_cast<float*>(la),
               static_cast<float*>(st), static_cast<bf16*>(y),
               static_cast<float*>(s_out), b, L, H, P, N, Q, L / Q,
               xb, xl, xh, bb, bl, cb, cl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (N) {
    case 64: return launch<64>(stages, a, s);
    case 128: return launch<128>(stages, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// Dynamic shared memory a block of K3 takes at chunk Q and state size N.
extern "C" int ssd_chunk_out_smem(int Q, int N) { return out_smem(Q, N); }
