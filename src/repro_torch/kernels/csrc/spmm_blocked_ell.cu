// Blocked-ELL SpMM for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py:spmm_blocked_ell (body
// _spmm_kernel):
//
//     out[r*bm : (r+1)*bm, :] = sum_e blocks[r, e] @ X[idx[r, e]*bk : +bk, :]
//
// blocks (nbr, ell, bm, bk) and idx (nbr, ell) int32 are the blocked-ELL
// adjacency; X is (K, N) row-major; out is (nbr*bm, N). Padding slots point
// at column block 0 with zero values, so they add nothing and need no branch.
//
// Translation. On the TPU the grid (block-row, e) runs in order on one core
// and the output tile stays in VMEM across the e axis; the idx row comes in
// by scalar prefetch and the BlockSpec gathers the (bk, N) slab of X. Here
// thread blocks run in parallel in no order, so:
//   * one thread block owns one block-row r and one tile of NT output
//     columns, and walks e in a loop (the TPU's sequential grid axis);
//   * the block reads its own idx row entry by entry;
//   * each step stages a (bm, KC) slice of the tile (transposed) and the
//     idx-selected (KC, NT) slice of the X slab in shared memory;
//   * the (bm, NT) output tile lives in fp32 registers, bm/4 values per
//     thread, and is written once at the end.
// The arithmetic is plain fp32 FMA (no TF32), so the result agrees with the
// plain PyTorch version to float32 rounding.
//
// What bounds it on this card. At ogbn-arxiv size (170,000 vertices, bm = bk
// = 16, N = 128, ell = 142) the tiles are 1.54 GB, read once (0.46 ms at
// 3.35 TB/s), but the padded format asks for 10,625 * 142 tiles of
// 16x16x128 FMA: about 99 GFLOP of fp32 work for 0.33 GFLOP of useful work
// (1.27 M non-zeros). Without tensor cores that is about 1.5 ms at the
// 67 TFLOP/s fp32 peak; this first design also pays a shared-memory load per
// FMA on the A side (vectorised to float4) and two barriers per step, so it
// is bound by issue rate, not by bytes. The gathered X slabs (about 12 GB of
// reads in all) mostly hit L2. Skipping padding tiles, TMA gathers, wgmma on
// bf16/TF32 and a format with less padding are the later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;   // output columns per thread block (threadIdx.x)
constexpr int TY = 4;    // row groups per thread block (threadIdx.y)
constexpr int KC = 16;   // depth of one shared-memory step
constexpr int PAD = 4;   // keeps float4 alignment, breaks store bank conflicts

template <int BM>
__global__ void __launch_bounds__(NT * TY)
spmm_blocked_ell_kernel(const float* __restrict__ blocks,
                        const int* __restrict__ idx,
                        const float* __restrict__ x,
                        float* __restrict__ out,
                        int ell, int bk, int nbc, int N, int n_tiles) {
  constexpr int RPT = BM / TY;           // output rows per thread
  static_assert(RPT % 4 == 0, "rows per thread must be a multiple of 4");
  __shared__ __align__(16) float a_s[KC][BM + PAD];   // a_s[k][m] = A[m][k]
  __shared__ __align__(16) float x_s[KC][NT];

  const int r = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * NT;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * NT + tx;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  const int64_t tile = static_cast<int64_t>(BM) * bk;
  const float* a_row = blocks + static_cast<int64_t>(r) * ell * tile;
  const int* idx_row = idx + static_cast<int64_t>(r) * ell;

  for (int e = 0; e < ell; ++e) {
    const int c = __ldg(idx_row + e);
    // An out-of-range column block is skipped (the host converter never
    // makes one); c is the same for the whole block, so the barriers below
    // stay uniform.
    if (c < 0 || c >= nbc) continue;
    const float* a = a_row + e * tile;
    const float* xb = x + static_cast<int64_t>(c) * bk * N;
    for (int k0 = 0; k0 < bk; k0 += KC) {
      for (int i = tid; i < BM * KC; i += NT * TY) {
        const int m = i / KC, k = i % KC;
        a_s[k][m] = __ldg(a + static_cast<int64_t>(m) * bk + k0 + k);
      }
      for (int i = tid; i < KC * NT; i += NT * TY) {
        const int k = i / NT, j = i % NT;
        const int col = n0 + j;
        x_s[k][j] = col < N
            ? __ldg(xb + static_cast<int64_t>(k0 + k) * N + col) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const float xv = x_s[k][tx];
#pragma unroll
        for (int i = 0; i < RPT; i += 4) {
          const float4 av =
              *reinterpret_cast<const float4*>(&a_s[k][ty * RPT + i]);
          acc[i + 0] = fmaf(av.x, xv, acc[i + 0]);
          acc[i + 1] = fmaf(av.y, xv, acc[i + 1]);
          acc[i + 2] = fmaf(av.z, xv, acc[i + 2]);
          acc[i + 3] = fmaf(av.w, xv, acc[i + 3]);
        }
      }
      __syncthreads();
    }
  }

  const int n = n0 + tx;
  if (n < N) {
    float* o = out + (static_cast<int64_t>(r) * BM + ty * RPT) * N + n;
#pragma unroll
    for (int i = 0; i < RPT; ++i) o[static_cast<int64_t>(i) * N] = acc[i];
  }
}

template <int BM>
cudaError_t launch(const float* blocks, const int* idx, const float* x,
                   float* out, int nbr, int ell, int bk, int nbc, int N,
                   cudaStream_t stream) {
  const int n_tiles = (N + NT - 1) / NT;
  const int64_t grid = static_cast<int64_t>(nbr) * n_tiles;
  if (grid > 0x7fffffff) return cudaErrorInvalidConfiguration;
  spmm_blocked_ell_kernel<BM><<<static_cast<unsigned>(grid), dim3(NT, TY), 0,
                                stream>>>(blocks, idx, x, out, ell, bk, nbc,
                                          N, n_tiles);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. All tensors are contiguous and on the
// device of `stream`; bm is one of 16, 32, 64, 128 and bk a multiple of 16.
// Returns a cudaError_t (0 on success); the launch is asynchronous.
extern "C" int spmm_blocked_ell_f32(const float* blocks, const int* idx,
                                    const float* x, float* out, int nbr,
                                    int ell, int bm, int bk, int K, int N,
                                    void* stream) {
  if (bk <= 0 || bk % KC != 0 || K % bk != 0) return cudaErrorInvalidValue;
  if (nbr == 0 || N == 0) return cudaSuccess;
  const int nbc = K / bk;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16: return launch<16>(blocks, idx, x, out, nbr, ell, bk, nbc, N, s);
    case 32: return launch<32>(blocks, idx, x, out, nbr, ell, bk, nbc, N, s);
    case 64: return launch<64>(blocks, idx, x, out, nbr, ell, bk, nbc, N, s);
    case 128: return launch<128>(blocks, idx, x, out, nbr, ell, bk, nbc, N, s);
    default: return cudaErrorInvalidValue;
  }
}
