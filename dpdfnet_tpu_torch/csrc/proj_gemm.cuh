// Tiled shared-memory SGEMM with a bias, Y = X . W + bias, for the input
// projections that gru_scan.cu hoists out of its recurrence.  X [M, K] is
// float32 or bfloat16, W [K, Nc] and bias [Nc] float32; the sum is float32
// and rounds once into Y (float32 or bfloat16).  A 64 x 64 output tile per block of 256 threads,
// 4 x 4 outputs per thread, K in steps of 16, the next step's tiles loaded
// into registers while the current one is multiplied (at small M, as one
// exact streaming hop gives gru_scan, the kernel is bound by that load
// latency); the k order of every output is fixed, so a row's result does
// not depend on M.
#pragma once

#include "gru64_walk.cuh"

namespace dpdf {

constexpr int PBM = 64, PBN = 64, PBK = 16;

template <typename TX, typename TY>
__global__ void __launch_bounds__(256)
proj_gemm_kernel(const TX* __restrict__ X, const float* __restrict__ W,
                 const float* __restrict__ bias, TY* __restrict__ Y, int64_t M, int K,
                 int Nc) {
  __shared__ float sa[PBK][PBM + 4];
  __shared__ float sb[PBK][PBN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t m0 = (int64_t)blockIdx.y * PBM;
  const int n0 = blockIdx.x * PBN;
  // this thread's 4 elements of each tile, fetched one tile ahead so the
  // loads of tile k0 + PBK are in flight while tile k0 is multiplied
  float ra[4], rb[4];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = threadIdx.x + 256 * e;
      const int64_t m = m0 + i / PBK;
      const int ka = k0 + i % PBK;
      ra[e] = (m < M && ka < K) ? load_f(X + m * K + ka) : 0.0f;
      const int kb = k0 + i / PBN, n = n0 + i % PBN;
      rb[e] = (kb < K && n < Nc) ? W[(int64_t)kb * Nc + n] : 0.0f;
    }
  };
  float acc[4][4] = {};
  fetch(0);
  for (int k0 = 0; k0 < K; k0 += PBK) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = threadIdx.x + 256 * e;
      sa[i % PBK][i / PBK] = ra[e];
      sb[i / PBN][i % PBN] = rb[e];
    }
    __syncthreads();
    if (k0 + PBK < K) fetch(k0 + PBK);
#pragma unroll
    for (int kk = 0; kk < PBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < Nc) store_f(Y + m * Nc + n, acc[i][j] + bias[n]);
    }
  }
}

template <typename TX, typename TY>
cudaError_t launch_proj_gemm(const TX* X, const float* W, const float* bias, TY* Y, int64_t M,
                             int K, int Nc, cudaStream_t stream) {
  dim3 grid((unsigned)((Nc + PBN - 1) / PBN), (unsigned)((M + PBM - 1) / PBM));
  proj_gemm_kernel<TX, TY><<<grid, 256, 0, stream>>>(X, W, bias, Y, M, K, Nc);
  return cudaGetLastError();
}

}  // namespace dpdf
