// Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd.py:ssd_chunked_pallas
// (body _ssd_kernel). For one (batch, head), the sequence is cut into
// chunks of Q rows, and a (P, N) float32 state S is carried across them.
// Per chunk, with la = cumsum(dt * a) over the chunk's rows:
//
//     W[s, t] = (C B^T)[s, t] * exp(la_s - la_t) * dt_t   for s >= t, else 0
//     y       = W x + (C S^T) * exp(la) + D * x
//     S'      = exp(la_{Q-1}) S + (x * exp(la_{Q-1} - la) * dt)^T B
//
// x is (b, L, H, P); B and C are (b, L, N), shared by every head; dt (after
// softplus) and da = dt * a are float32 (b, L, H), computed by the wrapper;
// D is float32 (H,). x, B and C may be strided views (the last dimension
// contiguous, rows 16-byte aligned), so mamba_block's slices of its conv
// output are read in place. Inputs are float32 or bfloat16; all arithmetic
// is float32, y is written in x's type, rounded once, and the final state
// in float32. The initial state is read from s0, or is zero when s0 is null.
// Under grad the wrapper also passes la_out (b, L, H) and st_out (b, nc, H,
// P, N), float32: the kernel then writes each chunk's la and the state
// entering each chunk, which the backward (ssd_chunk_bwd.cu) reads; both
// are null otherwise.
//
// Numerics kept from the model zoo's models/ssm.py:ssd_chunked (the
// function the JAX model path calls): la is a cumulative sum taken in row
// order (one thread adds the chunk's rows in turn, as the plain version
// does); the mask is applied before the exp (above the diagonal
// la_s - la_t is positive and overflows, and inf * 0 would be NaN); the
// D * x skip is added to the float32 y before its one rounding.
//
// Translation. On the TPU the grid (b, h, chunk) runs its chunk axis in
// order with S in VMEM scratch. Here a thread block owns one (b, h) and 32
// of the P columns (a "P-slice"), and loops over the chunks itself; the P
// rows of S and the P columns of y are independent once W is known, so the
// carry is exactly the TPU's. The grid (P / 32, H, b) offers 384 blocks at
// the main path's shape (b 4, H 48, P 64), enough to fill 132 SMs at two
// blocks each; the price is that each P-slice recomputes C B^T. W at
// Q = 256 would take 256 KB of float32, above the 227 KB a block may use,
// so a chunk is tiled into 64-row query tiles s and 64-row key tiles t
// (t <= s): per pair, C B^T (64 x 64, N staged 64 columns at a time), W,
// then y_s += W x_t. C S^T is accumulated on the diagonal pair, and the
// state update runs after the chunk's y, over the key tiles with all N
// columns of B staged. 256 threads: for C B^T and W each thread owns 4
// rows x 4 keys, for y 4 rows x 2 columns, for S 4 (N 128) or 2 (N 64)
// rows x 4 columns. Shared memory holds the chunk's x slice, S, the C, B
// and W tiles and la, dt, exp(la_{Q-1} - la) * dt: 106.5 KB at Q = 256,
// N = 128, so two blocks fit an SM (opt-in above 48 KB).
//
// What bounds it on this card. At the main path's shape (b 4, L 32768,
// H 48, P 64, N 128, Q 256, bf16) the function must move 1.697 GB (x and
// y, dt, B, C, the final state): 0.51 ms at 3.35 TB/s. Its products, with
// C B^T counted once per (b, chunk) and the triangle only, are 0.31 TFLOP:
// 0.32 ms at 989 TFLOP/s bf16. So it is bound by bytes. This first design
// runs plain float32 FMA from shared memory on the CUDA cores
// (67 TFLOP/s), recomputes C B^T for every head and P-slice (0.85 TFLOP
// done in all), and overlaps no load with compute: it is bound by the
// issue rate of those FMA and their shared-memory loads. wgmma on bf16
// tiles with C B^T shared across heads, TMA loads into a ring of stages,
// and a chunk-parallel state pass are the later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;      // threads per block
constexpr int PS = 32;        // P columns per block
constexpr int TQ = 64;        // rows of a query tile and of a key tile
constexpr int NK = 64;        // state columns staged per step of C B^T
constexpr int PAD = 4;        // floats of padding per shared row
constexpr int QMAX = 256;     // the longest chunk

struct Args {
  const void* x;
  const float* dts;           // softplus(dt), (b, L, H) contiguous
  const float* da;            // softplus(dt) * a, (b, L, H) contiguous
  const void* B;
  const void* C;
  const float* D;             // (H,)
  const float* s0;            // (b, H, P, N) contiguous, or null
  void* y;                    // (b, L, H, P) contiguous
  float* s_out;               // (b, H, P, N) contiguous
  float* la_out;              // (b, L, H) contiguous, or null
  float* st_out;              // (b, nc, H, P, N) contiguous, or null
  int L, H, P, Q;
  int64_t xb, xl, xh, bb, bl, cb, cl;   // strides in elements
};

// 16-byte global loads, converted to float32.
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

__device__ inline void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

__device__ inline void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// `rows` rows of COLS elements from global (row stride `stride`) into
// shared float32 rows of `ld`; rows at or past `valid` are zero.
template <typename T, int COLS>
__device__ inline void load_rows(const T* __restrict__ src, int64_t stride,
                                 int rows, int valid, float* __restrict__ dst,
                                 int ld) {
  constexpr int VN = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int PER_ROW = COLS / VN;
  static_assert(COLS % VN == 0, "a row must be whole 16-byte loads");
  for (int i = threadIdx.x; i < rows * PER_ROW; i += NTH) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VN;
    float f[VN];
    if (r < valid) {
      load16(src + r * stride + c, f);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) f[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; j += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
}

__device__ inline float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__host__ __device__ constexpr int smem_floats(int Qp, int N) {
  return Qp * (PS + PAD) + PS * (N + PAD) + 2 * TQ * (NK + PAD) +
         TQ * (TQ + PAD) + 3 * Qp;
}

template <typename T, int N>
__global__ void __launch_bounds__(NTH, 2) ssd_chunked_kernel(Args a) {
  constexpr int LDX = PS + PAD;          // shared row of x
  constexpr int LDS = N + PAD;           // shared row of S, and of a B tile
  constexpr int LDK = NK + PAD;          // shared row of a C or B sub-tile
  constexpr int LDW = TQ + PAD;          // shared row of W
  constexpr int NG = N / 4;              // state pass: column groups of 4
  constexpr int PG = NTH / NG;           // state pass: row groups
  constexpr int PPT = PS / PG;           // state pass: rows per thread
  static_assert(N % NK == 0 && PS % PG == 0, "tile sizes");
  static_assert(TQ * LDS <= 2 * TQ * LDK, "B tile must fit over C and B");

  extern __shared__ __align__(16) float smem[];
  const int Q = a.Q, Qp = (Q + TQ - 1) / TQ * TQ, nt = Qp / TQ;
  float* xs = smem;                      // [Qp][LDX] the chunk's x slice
  float* ss = xs + Qp * LDX;             // [PS][LDS] state rows of the slice
  float* cs = ss + PS * LDS;             // [TQ][LDK] C sub-tile
  float* bs = cs + TQ * LDK;             // [TQ][LDK] B sub-tile
  float* bfull = cs;                     // [TQ][LDS] state pass, over cs, bs
  float* ws = bs + TQ * LDK;             // [TQ][LDW] W tile
  float* la = ws + TQ * LDW;             // [Qp] cumulative log decay
  float* dtv = la + Qp;                  // [Qp] softplus(dt)
  float* wv = dtv + Qp;                  // [Qp] exp(la_{Q-1} - la) * dt

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int ng = tid % NG, pg = tid / NG;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const T* x = static_cast<const T*>(a.x) + b * a.xb + h * a.xh + p0;
  const T* Bm = static_cast<const T*>(a.B) + b * a.bb;
  const T* Cm = static_cast<const T*>(a.C) + b * a.cb;
  const int64_t yrow = static_cast<int64_t>(a.H) * a.P;
  T* y = static_cast<T*>(a.y) + static_cast<int64_t>(b) * a.L * yrow +
         h * a.P + p0;
  const int64_t dbase = static_cast<int64_t>(b) * a.L * a.H + h;
  const float Dh = a.D[h];
  const int64_t sbase = ((static_cast<int64_t>(b) * a.H + h) * a.P + p0) * N;

  for (int i = tid; i < PS * N / 4; i += NTH) {
    const int r = i / (N / 4), c = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(ss + r * LDS + c) =
        a.s0 ? *reinterpret_cast<const float4*>(a.s0 + sbase + r * N + c)
             : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int l0 = 0; l0 < a.L; l0 += Q) {
    __syncthreads();                     // the last chunk is done with smem
    if (a.st_out) {                      // the state entering this chunk
      const int64_t sb =
          ((static_cast<int64_t>(b) * (a.L / Q) + l0 / Q) * a.H + h) * a.P +
          p0;
      for (int i = tid; i < PS * N / 4; i += NTH) {
        const int r = i / (N / 4), c = (i % (N / 4)) * 4;
        *reinterpret_cast<float4*>(a.st_out + (sb + r) * N + c) =
            *reinterpret_cast<const float4*>(ss + r * LDS + c);
      }
    }
    for (int i = tid; i < Qp; i += NTH) {
      const int64_t off = dbase + static_cast<int64_t>(l0 + i) * a.H;
      la[i] = i < Q ? a.da[off] : 0.f;
      dtv[i] = i < Q ? a.dts[off] : 0.f;
    }
    load_rows<T, PS>(x + l0 * a.xl, a.xl, Qp, Q, xs, LDX);
    __syncthreads();
    if (tid == 0) {                      // la in row order; padding rows
      float acc = la[0];                 // keep the last value (dt is 0)
      for (int i = 1; i < Q; ++i) {
        acc += la[i];
        la[i] = acc;
      }
      for (int i = Q; i < Qp; ++i) la[i] = acc;
    }
    __syncthreads();
    if (a.la_out && blockIdx.x == 0)
      for (int i = tid; i < Q; i += NTH)
        a.la_out[dbase + static_cast<int64_t>(l0 + i) * a.H] = la[i];
    const float la_end = la[Q - 1];
    for (int i = tid; i < Qp; i += NTH) wv[i] = expf(la_end - la[i]) * dtv[i];

    for (int st = 0; st < nt; ++st) {
      const int s0 = st * TQ;
      float yacc[4][2], yint[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) yacc[i][c] = yint[i][c] = 0.f;

      for (int tt = 0; tt <= st; ++tt) {
        const int t0 = tt * TQ;
        float cb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;

#pragma unroll
        for (int k0 = 0; k0 < N; k0 += NK) {
          __syncthreads();               // cs, bs (and ws) are free
          load_rows<T, NK>(Cm + (l0 + s0) * a.cl + k0, a.cl, TQ, Q - s0, cs,
                           LDK);
          load_rows<T, NK>(Bm + (l0 + t0) * a.bl + k0, a.bl, TQ, Q - t0, bs,
                           LDK);
          __syncthreads();
          // C B^T: rows rg*4 + i, keys cg + 16*j
#pragma unroll 4
          for (int k = 0; k < NK; k += 4) {
            float4 ca[4], bb[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              ca[i] = *reinterpret_cast<const float4*>(
                  &cs[(rg * 4 + i) * LDK + k]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bb[j] = *reinterpret_cast<const float4*>(
                  &bs[(cg + 16 * j) * LDK + k]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                cb[i][j] = fmaf(ca[i].x, bb[j].x, cb[i][j]);
                cb[i][j] = fmaf(ca[i].y, bb[j].y, cb[i][j]);
                cb[i][j] = fmaf(ca[i].z, bb[j].z, cb[i][j]);
                cb[i][j] = fmaf(ca[i].w, bb[j].w, cb[i][j]);
              }
          }
          if (tt == st) {
            // C S^T: rows rg*4 + i, P columns 2*cg + c
#pragma unroll 4
            for (int k = 0; k < NK; k += 4) {
              float4 ca[4], sv[2];
#pragma unroll
              for (int i = 0; i < 4; ++i)
                ca[i] = *reinterpret_cast<const float4*>(
                    &cs[(rg * 4 + i) * LDK + k]);
#pragma unroll
              for (int c = 0; c < 2; ++c)
                sv[c] = *reinterpret_cast<const float4*>(
                    &ss[(2 * cg + c) * LDS + k0 + k]);
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int c = 0; c < 2; ++c) {
                  yint[i][c] = fmaf(ca[i].x, sv[c].x, yint[i][c]);
                  yint[i][c] = fmaf(ca[i].y, sv[c].y, yint[i][c]);
                  yint[i][c] = fmaf(ca[i].z, sv[c].z, yint[i][c]);
                  yint[i][c] = fmaf(ca[i].w, sv[c].w, yint[i][c]);
                }
            }
          }
        }

        // W, masked before the exp
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = s0 + rg * 4 + i;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + cg + 16 * j;
            ws[(rg * 4 + i) * LDW + cg + 16 * j] =
                s >= t ? cb[i][j] * expf(la[s] - la[t]) * dtv[t] : 0.f;
          }
        }
        __syncthreads();
        // y += W x_t: rows rg*4 + i, P columns 2*cg + c
#pragma unroll 4
        for (int t = 0; t < TQ; t += 4) {
          float4 wa[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            wa[i] = *reinterpret_cast<const float4*>(&ws[(rg * 4 + i) * LDW + t]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 xv = *reinterpret_cast<const float2*>(
                &xs[(t0 + t + u) * LDX + 2 * cg]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float w = comp(wa[i], u);
              yacc[i][0] = fmaf(w, xv.x, yacc[i][0]);
              yacc[i][1] = fmaf(w, xv.y, yacc[i][1]);
            }
          }
        }
      }

      // y = W x + (C S^T) exp(la) + D x, rounded once
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = s0 + rg * 4 + i;
        if (s < Q) {
          const float e = expf(la[s]);
          const float* xr = &xs[s * LDX + 2 * cg];
          store2(y + (l0 + s) * yrow + 2 * cg,
                 yacc[i][0] + yint[i][0] * e + Dh * xr[0],
                 yacc[i][1] + yint[i][1] * e + Dh * xr[1]);
        }
      }
    }

    // S' = exp(la_{Q-1}) S + sum_t (x_t * w_t)^T B_t: rows pg*PPT + q,
    // columns 4*ng .. 4*ng + 3
    float ds[PPT][4];
#pragma unroll
    for (int q = 0; q < PPT; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) ds[q][c] = 0.f;
    for (int tt = 0; tt < nt; ++tt) {
      const int t0 = tt * TQ;
      __syncthreads();                   // cs, bs are free
      load_rows<T, N>(Bm + (l0 + t0) * a.bl, a.bl, TQ, Q - t0, bfull, LDS);
      __syncthreads();
#pragma unroll 4
      for (int t = 0; t < TQ; ++t) {
        const float w = wv[t0 + t];
        const float4 bv =
            *reinterpret_cast<const float4*>(&bfull[t * LDS + 4 * ng]);
        const float* xr = &xs[(t0 + t) * LDX + pg * PPT];
#pragma unroll
        for (int q = 0; q < PPT; ++q) {
          const float xw = xr[q] * w;
          ds[q][0] = fmaf(xw, bv.x, ds[q][0]);
          ds[q][1] = fmaf(xw, bv.y, ds[q][1]);
          ds[q][2] = fmaf(xw, bv.z, ds[q][2]);
          ds[q][3] = fmaf(xw, bv.w, ds[q][3]);
        }
      }
    }
    // every read of S in this chunk (C S^T) came before the syncs above,
    // and each thread rewrites only its own entries
    const float decay = expf(la_end);
#pragma unroll
    for (int q = 0; q < PPT; ++q) {
      float* sr = &ss[(pg * PPT + q) * LDS + 4 * ng];
      const float4 old = *reinterpret_cast<const float4*>(sr);
      *reinterpret_cast<float4*>(sr) =
          make_float4(old.x * decay + ds[q][0], old.y * decay + ds[q][1],
                      old.z * decay + ds[q][2], old.w * decay + ds[q][3]);
    }
  }

  __syncthreads();
  for (int i = tid; i < PS * N / 4; i += NTH) {
    const int r = i / (N / 4), c = (i % (N / 4)) * 4;
    *reinterpret_cast<float4*>(a.s_out + sbase + r * N + c) =
        *reinterpret_cast<const float4*>(ss + r * LDS + c);
  }
}

template <typename T, int N>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  auto kern = ssd_chunked_kernel<T, N>;
  const int Qp = (a.Q + TQ - 1) / TQ * TQ;
  const int smem = smem_floats(Qp, N) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.P / PS, a.H, batch);
  kern<<<grid, NTH, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_n(int N, const Args& a, int batch, cudaStream_t s) {
  switch (N) {
    case 64: return launch<T, 64>(a, batch, s);
    case 128: return launch<T, 128>(a, batch, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. dtype 0 is float32, 1 is bfloat16 (of
// x, B, C and y); dts, da, D, s0 and s_out are float32. N is 64 or 128, P a
// multiple of 32, 0 < Q <= 256 with L % Q == 0; strides are in elements
// (the last dimension contiguous) and every row 16-byte aligned; s0 may be
// null (zero initial state); la_out and st_out are null or the float32
// la (b, L, H) and entering states (b, L / Q, H, P, N) to write. Returns a
// cudaError_t (0 on success); the launch is asynchronous, on `stream`.
extern "C" int ssd_chunked_fwd(int dtype, const void* x, const void* dts,
                               const void* da, const void* B, const void* C,
                               const void* D, const void* s0, void* y,
                               void* s_out, void* la_out, void* st_out,
                               int b, int L, int H, int P, int N,
                               int Q, int64_t xb, int64_t xl, int64_t xh,
                               int64_t bb, int64_t bl, int64_t cb, int64_t cl,
                               void* stream) {
  if (b <= 0 || b > 65535 || H <= 0 || H > 65535 || P <= 0 || P % PS != 0 ||
      Q <= 0 || Q > QMAX || L <= 0 || L % Q != 0)
    return cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(dts), static_cast<const float*>(da),
               B, C, static_cast<const float*>(D),
               static_cast<const float*>(s0), y, static_cast<float*>(s_out),
               static_cast<float*>(la_out), static_cast<float*>(st_out),
               L, H, P, Q, xb, xl, xh, bb, bl, cb, cl};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_n<float>(N, a, b, s);
    case 1: return dispatch_n<__nv_bfloat16>(N, a, b, s);
    default: return cudaErrorInvalidValue;
  }
}
