// Row-wise CSR SpMM for Hopper (sm_90a), float32.
//
// Computes the same function as the TPU kernel
// src/repro/kernels/spmm.py:spmm_blocked_ell (body _spmm_kernel),
//
//     out = A @ X,   A sparse (M, K), X dense (K, N) row-major, out (M, N),
//
// but reads A as its non-zeros in row order (CSR: int32 indptr (M+1),
// int32 indices (nnz), fp32 values (nnz)), not as dense 16x16 tiles.
//
// Why not the TPU's format. The TPU kernel re-blocks A into blocked-ELL
// because its MXU wants 128x128 dense tiles (its docstring); the Sextans
// FPGA SpMM it stands in for streams CSR non-zeros. At ogbn-arxiv size
// (170,000 vertices, 1,269,962 non-zeros, rows of 1 to 21) a 16x16 tile
// holds about 1.15 non-zeros of its 256 entries, so the padded format
// reads 1.5 GB of tiles for 5 MB of values. Here the work's own bytes set
// the bound: indptr, indices and values once, X once and out once,
// 184,919,700 bytes at N = 128, 0.055 ms at 3.35 TB/s; its 0.33 GFLOP
// of FMA take 5 us at the fp32 rate, so the kernel is bound by bytes.
//
// Design (simple first):
//   * one warp per output row, WARPS warps a block;
//   * the lanes split a 128-column slab of the row: with N % 4 == 0 and
//     16-byte aligned X and out, lane j owns columns 4j..4j+3 as one
//     float4, so a gathered row of X is one coalesced 512-byte warp load;
//     otherwise lane j owns columns j, j+32, j+64, j+96 (scalar path, e.g.
//     N = 100). N > 128 loops over slabs;
//   * the warp loads the row's (column, value) pairs 32 at a time, one
//     coalesced load each, and hands each pair to all lanes with
//     __shfl_sync; UNROLL gathered X rows are in flight at once;
//   * each lane accumulates with fp32 fmaf in the row's column order. No
//     atomics, so two calls give bit-identical outputs;
//   * the output row is written once; an empty row writes zeros.
// Indices and values are read, and out written, with evict-first hints
// (__ldcs, __stcs), and X through the read-only path (__ldg), so that L2
// keeps as much of X (87 MB at ogbn-arxiv, against 50 MB of L2) as it can.
// No shared memory and no tensor cores.
//
// A column outside [0, K) reads as an explicit zero (the host-side
// operand constructors never make one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;           // rows (warps) per thread block
constexpr int SLAB = 128;          // output columns a warp covers per pass
constexpr int UNROLL = 4;          // gathered X rows in flight per warp
constexpr unsigned FULL = 0xffffffffu;

// One gathered row of X, the lane's share of slab n0: four columns.
template <bool VEC>
__device__ __forceinline__ void gather(const float* __restrict__ x, int c,
                                       int N, int n0, int lane,
                                       float (&xv)[4]) {
  const float* row = x + static_cast<int64_t>(c) * N + n0;
  if (VEC) {
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c >= 0 && n0 + 4 * lane < N)
      t = __ldg(reinterpret_cast<const float4*>(row) + lane);
    xv[0] = t.x; xv[1] = t.y; xv[2] = t.z; xv[3] = t.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int n = lane + 32 * q;
      xv[q] = (c >= 0 && n0 + n < N) ? __ldg(row + n) : 0.f;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
spmm_csr_rows_kernel(const int* __restrict__ indptr,
                     const int* __restrict__ indices,
                     const float* __restrict__ values,
                     const float* __restrict__ x, float* __restrict__ out,
                     int M, int K, int N) {
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;              // whole warps only: shuffles stay full
  const int start = __ldg(indptr + row);
  const int end = __ldg(indptr + row + 1);
  float* orow = out + static_cast<int64_t>(row) * N;

  for (int n0 = 0; n0 < N; n0 += SLAB) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = start; base < end; base += 32) {
      // one coalesced load of up to 32 (column, value) pairs
      const int p = base + lane;
      int col = -1;
      float val = 0.f;
      if (p < end) {
        col = __ldcs(indices + p);
        val = __ldcs(values + p);
        if (col < 0 || col >= K) { col = -1; val = 0.f; }
      }
      const int cnt = min(32, end - base);   // the same for every lane
      int i = 0;
      for (; i + UNROLL <= cnt; i += UNROLL) {
        int c[UNROLL];
        float v[UNROLL], xv[UNROLL][4];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          c[u] = __shfl_sync(FULL, col, i + u);
          v[u] = __shfl_sync(FULL, val, i + u);
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
          gather<VEC>(x, c[u], N, n0, lane, xv[u]);
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(v[u], xv[u][q], acc[q]);
      }
      for (; i < cnt; ++i) {
        const int c = __shfl_sync(FULL, col, i);
        const float v = __shfl_sync(FULL, val, i);
        float xv[4];
        gather<VEC>(x, c, N, n0, lane, xv);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = fmaf(v, xv[q], acc[q]);
      }
    }
    if (VEC) {
      if (n0 + 4 * lane < N)
        __stcs(reinterpret_cast<float4*>(orow + n0) + lane,
               make_float4(acc[0], acc[1], acc[2], acc[3]));
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + lane + 32 * q;
        if (n < N) __stcs(orow + n, acc[q]);
      }
    }
  }
}

}  // namespace

// C entry point, bound with ctypes. All arrays are contiguous and on the
// device of `stream`: indptr (M+1) and indices (nnz) int32, values (nnz),
// x (K, N) and out (M, N) float32. Returns a cudaError_t (0 on success);
// the launch is asynchronous.
extern "C" int spmm_csr_rows_f32(const int* indptr, const int* indices,
                                 const float* values, const float* x,
                                 float* out, int M, int K, int N,
                                 void* stream) {
  if (M < 0 || K < 0 || N < 0) return cudaErrorInvalidValue;
  if (M == 0 || N == 0) return cudaSuccess;
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const unsigned grid =
      static_cast<unsigned>((static_cast<int64_t>(M) + WARPS - 1) / WARPS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    spmm_csr_rows_kernel<true><<<grid, WARPS * 32, 0, s>>>(
        indptr, indices, values, x, out, M, K, N);
  else
    spmm_csr_rows_kernel<false><<<grid, WARPS * 32, 0, s>>>(
        indptr, indices, values, x, out, M, K, N);
  return cudaGetLastError();
}
