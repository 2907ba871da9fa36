// Banded (sliding-window) causal flash attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/swa.py:swa_attention_pallas
// (body _swa_kernel). For query row r and key c of one (batch, head):
//
//     valid(r, c) = 0 <= r - c < window
//     o[r] = sum_c softmax_c(q[r] * scale . k[c] | valid) v[c]
//
// q is (B, H, S, D); k and v are (B, KV, S, D), and query head h reads KV
// head h / (H / KV) (GQA, no broadcast in memory). Any strides are taken
// as long as the last dimension is contiguous and rows are 16-byte
// aligned, so the model's (B, S, H, D) activations are read in place.
// Inputs are float32 or bfloat16; all arithmetic is float32, and the
// output is written in the input type.
//
// Numerics kept from the TPU kernel:
//   * q is converted to float32 and multiplied by scale before q.k;
//   * masked scores are the finite NEG_INF = -1e30, and a masked p is set
//     to 0 after the exp, so a row that is wholly masked in one step adds
//     nothing (exp(NEG_INF - NEG_INF) = 1 is zeroed; -inf would give NaN);
//   * the online softmax carries (m, l, acc) over the key steps, and the
//     output is acc / max(l, 1e-30).
//
// Translation. On the TPU the grid (b, h, query block i, step j) runs in
// order and (m, l, acc) live in VMEM scratch across j; query block i visits
// key blocks i - nkv + 1 .. i of 128 keys, negative ones skipped. Here a
// thread block owns BQ = 64 query rows of one (b, h) and walks, in a loop,
// the BK = 64-key tiles that hold any in-band key of its rows: from tile
// max(0, q0 - window + 1) / BK to the diagonal tile. That covers every
// in-band pair (the result does not depend on the tile), and no tile
// wholly outside the band is visited. 256 threads form 16 row groups of
// 4 rows by 16 column groups; a row group's 16 threads are one half-warp,
// so the row max and row sum reduce with shuffles. Per step the block
// stages the K and V tiles in shared memory as float32, forms S = Q K^T
// (each thread 4 rows x 4 keys), updates (m, l, acc) in registers, writes
// P over the K tile, and accumulates P V (each thread 4 rows x D/16
// columns). Shared memory: (64 + 2 * 64) rows of D + 4 floats, 99 KB at
// D = 128, above the 48 KB default, so the launcher opts in.
//
// What bounds it on this card. At the main path's shape (B 2, H 32, KV 8,
// S 16384, window 4096, D 128, bf16) the band holds 58.7 M (row, key)
// pairs per (b, h): 1.92 TFLOP of q.k and p.v, against 0.67 GB of q, k, v
// and o. With tensor cores in bf16 (989 TFLOP/s) that is about 1.9 ms,
// bound by operations. This first design uses no tensor cores: plain
// float32 FMA from shared memory, whose peak on the CUDA cores is
// 67 TFLOP/s (29 ms), and it is bound by issue rate (two 16-byte shared
// loads per 16 FMA) and by the unoverlapped tile loads. wgmma on bf16
// tiles, TMA loads into a ring of stages and warp specialisation are the
// later redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per thread block
constexpr int BK = 64;        // keys per step
constexpr int NTH = 256;      // 16 row groups x 16 column groups
constexpr int PAD = 4;        // floats of padding per shared row
constexpr float NEG_INF = -1e30f;

struct Strides {              // in elements: batch, head, row
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
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

__device__ inline void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ inline void store4(__nv_bfloat16* dst, const float* v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
}

// rows x D elements from global (row stride `stride`) into shared float32
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

template <typename T, int D, int MINB>
__global__ void __launch_bounds__(NTH, MINB)
swa_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H,
                     int G, int window, float scale, Strides st) {
  constexpr int LD = D + PAD;            // shared row of q, k, v (floats)
  constexpr int LDP = BK + PAD;          // shared row of P
  constexpr int DC = D / 64;             // float4 column groups per thread
  static_assert(D % 64 == 0, "D must be a multiple of 64");
  static_assert(BQ * LDP <= BK * LD, "P must fit over the K tile");
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [BQ][LD]  q * scale
  float* ks = qs + BQ * LD;              // [BK][LD]  K tile, then P
  float* vs = ks + BK * LD;              // [BK][LD]  V tile
  float* ps = ks;                        // [BQ][LDP] P over the K tile

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kh = h / G;
  const int q0 = blockIdx.x * BQ;

  load_tile<T, D, BQ>(q + b * st.qb + h * st.qh + q0 * st.qs, st.qs, qs,
                      scale);
  const T* kbase = k + b * st.kb + kh * st.kh;
  const T* vbase = v + b * st.vb + kh * st.vh;

  float m[4], l[4], acc[4][4 * DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * DC; ++c) acc[i][c] = 0.f;
  }

  const int lo = max(0, q0 - window + 1);    // lowest in-band key
  for (int k0 = (lo / BK) * BK; k0 <= q0; k0 += BK) {
    __syncthreads();                         // last step is done with ks, vs
    load_tile<T, D, BK>(kbase + k0 * st.ks, st.ks, ks, 1.f);
    load_tile<T, D, BK>(vbase + k0 * st.vs, st.vs, vs, 1.f);
    __syncthreads();

    // S = (q * scale) K^T: rows rg*4 + i, keys cg + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&qs[(rg * 4 + i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(&ks[(cg + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // mask, online softmax; p overwrites s
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + rg * 4 + i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int rel = r - (k0 + cg + 16 * j);
        valid[j] = rel >= 0 && rel < window;
        if (!valid[j]) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                         // every thread is done with ks
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[(rg * 4 + i) * LDP + cg + 16 * j] = s[i][j];
    __syncthreads();

    // acc += P V: rows rg*4 + i, columns dc*64 + cg*4 .. + 4
#pragma unroll 4
    for (int c = 0; c < BK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(&ps[(rg * 4 + i) * LDP + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int dc = 0; dc < DC; ++dc) {
          const float4 vv = *reinterpret_cast<const float4*>(
              &vs[(c + cc) * LD + dc * 64 + cg * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = cc == 0 ? pa[i].x : cc == 1 ? pa[i].y
                          : cc == 2 ? pa[i].z : pa[i].w;
            acc[i][dc * 4 + 0] = fmaf(p, vv.x, acc[i][dc * 4 + 0]);
            acc[i][dc * 4 + 1] = fmaf(p, vv.y, acc[i][dc * 4 + 1]);
            acc[i][dc * 4 + 2] = fmaf(p, vv.z, acc[i][dc * 4 + 2]);
            acc[i][dc * 4 + 3] = fmaf(p, vv.w, acc[i][dc * 4 + 3]);
          }
        }
    }
  }

  T* obase = o + b * st.ob + h * st.oh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = obase + (q0 + rg * 4 + i) * st.os;
#pragma unroll
    for (int dc = 0; dc < DC; ++dc) {
      const float f[4] = {acc[i][dc * 4] / denom, acc[i][dc * 4 + 1] / denom,
                          acc[i][dc * 4 + 2] / denom,
                          acc[i][dc * 4 + 3] / denom};
      store4(orow + dc * 64 + cg * 4, f);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int G, int S, int window, float scale,
                   const Strides& st, cudaStream_t stream) {
  constexpr int MINB = D <= 128 ? 2 : 1;
  auto kern = swa_attention_kernel<T, D, MINB>;
  const int smem = (BQ + 2 * BK) * (D + PAD) * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(S / BQ, B * H);
  kern<<<grid, NTH, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, G, window, scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* o, int B, int H, int G, int S, int window,
                       float scale, const Strides& st, cudaStream_t s) {
  switch (D) {
    case 64: return launch<T, 64>(q, k, v, o, B, H, G, S, window, scale, st, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, G, S, window, scale, st, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, G, S, window, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. dtype 0 is float32, 1 is bfloat16; D is
// 64, 128 or 256; S a multiple of 64; H a multiple of KV; strides are in
// elements (the last dimension is contiguous) and every row 16-byte
// aligned. Returns a cudaError_t (0 on success); the launch is
// asynchronous, on `stream`.
extern "C" int swa_attention_fwd(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int B, int H,
                                 int KV, int S, int D, int window,
                                 float scale, int64_t qb, int64_t qh,
                                 int64_t qs, int64_t kb, int64_t kh,
                                 int64_t ks, int64_t vb, int64_t vh,
                                 int64_t vs, int64_t ob, int64_t oh,
                                 int64_t os, void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || S <= 0 || S % BQ != 0 ||
      window <= 0 || static_cast<int64_t>(B) * H > 65535)
    return cudaErrorInvalidValue;
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  switch (dtype) {
    case 0: return dispatch_d<float>(D, q, k, v, o, B, H, G, S, window, scale, st, s);
    case 1: return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, G, S, window, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}
