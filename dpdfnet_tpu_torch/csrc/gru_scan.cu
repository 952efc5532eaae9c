// GRU scan on Hopper: ys, h_last = GRU over x [N, T, I] from h0 [N, H],
// forward or reverse in time (gate packing (r, z, n), torch's
// linear-before-reset n gate).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py gru_scan_tm, kernel _kernel (TPU).
//
// What bounds it on the H100: on the main path N = B rows (8 .. 64) and
// H = I = 256, so Wh is 256 x 768 = 768 KB in f32, over the 227 KB a block
// may hold in shared memory.  Useful work is 6 H (I + H) FLOPs per
// row-step; the roofline bound is arithmetic, but a step cannot start
// before the previous hidden exists, and with N = B rows there are only
// a few rows to spread over 132 SMs.
//
// Design (simple first):
//  1. gru_proj_kernel: the input projection xp = x . Wi + bi for all T at
//     once, a tiled shared-memory SGEMM over the N*T rows (no recurrence,
//     fully parallel) into a scratch [N, T, 3H].
//  2. gru_recur_kernel: one block owns R = 1..8 rows and walks T; thread u
//     owns hidden unit u (blockDim = H).  h lives in shared memory; Wh is
//     streamed from L2 (which holds it) every step, each load feeding the
//     block's R rows.  R is chosen so the grid stays within one wave.
// Splitting Wh over a thread-block cluster (DSMEM) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16;   // projection tile, 16 x 16 threads, 4 x 4 each

__global__ void __launch_bounds__(256)
gru_proj_kernel(const float* __restrict__ X, const float* __restrict__ W,
                const float* __restrict__ bias, float* __restrict__ Y,
                int64_t M, int K, int Nc) {
  __shared__ float sa[BK][BM + 4];
  __shared__ float sb[BK][BN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t m0 = (int64_t)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = threadIdx.x; i < BM * BK; i += 256) {
      const int mm = i / BK, kk = i % BK;
      const int64_t m = m0 + mm;
      const int k = k0 + kk;
      sa[kk][mm] = (m < M && k < K) ? X[m * K + k] : 0.0f;
    }
    for (int i = threadIdx.x; i < BK * BN; i += 256) {
      const int kk = i / BN, nn = i % BN;
      const int k = k0 + kk, n = n0 + nn;
      sb[kk][nn] = (k < K && n < Nc) ? W[(int64_t)k * Nc + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
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
      if (n < Nc) Y[m * Nc + n] = acc[i][j] + bias[n];
    }
  }
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

// xp: [N, T, 3H] (bias bi included); ys: [N, T, H]; h0, h_last: [N, H].
template <int R>
__global__ void gru_recur_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                                 const float* __restrict__ wh, const float* __restrict__ bh,
                                 float* __restrict__ ys, float* __restrict__ h_last,
                                 int N, int T, int H, int reverse) {
  extern __shared__ __align__(16) float sh[];     // [R][H]
  const int u = threadIdx.x;
  const int n0 = blockIdx.x * R;
  const int H3 = 3 * H;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int n = n0 + j;
    sh[j * H + u] = (n < N) ? h0[(int64_t)n * H + u] : 0.0f;
  }
  const float bhr = bh[u], bhz = bh[H + u], bhn = bh[2 * H + u];
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? (T - 1 - s) : s;
    float ar[R], az[R], an[R];
#pragma unroll
    for (int j = 0; j < R; ++j) ar[j] = az[j] = an[j] = 0.0f;
    for (int k = 0; k < H; k += 4) {
      float4 hv[R];
#pragma unroll
      for (int j = 0; j < R; ++j) hv[j] = *reinterpret_cast<const float4*>(&sh[j * H + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* row = wh + (int64_t)(k + kk) * H3;
        const float wr = __ldg(row + u), wz = __ldg(row + H + u), wn = __ldg(row + 2 * H + u);
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float hs = (&hv[j].x)[kk];
          ar[j] = fmaf(hs, wr, ar[j]);
          az[j] = fmaf(hs, wz, az[j]);
          an[j] = fmaf(hs, wn, an[j]);
        }
      }
    }
    float hnew[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int n = n0 + j;
      const int nn = n < N ? n : N - 1;
      const float* x = xp + ((int64_t)nn * T + t) * H3;
      const float rg = sigmoid_f(x[u] + (ar[j] + bhr));
      const float zg = sigmoid_f(x[H + u] + (az[j] + bhz));
      const float ng = tanhf(x[2 * H + u] + rg * (an[j] + bhn));
      hnew[j] = (1.0f - zg) * ng + zg * sh[j * H + u];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      sh[j * H + u] = hnew[j];
      const int n = n0 + j;
      if (n < N) ys[((int64_t)n * T + t) * H + u] = hnew[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int n = n0 + j;
    if (n < N) h_last[(int64_t)n * H + u] = sh[j * H + u];
  }
}

template <int R>
cudaError_t launch_recur(const float* xp, const float* h0, const float* wh, const float* bh,
                         float* ys, float* h_last, int N, int T, int H, int reverse,
                         cudaStream_t st) {
  const size_t smem = sizeof(float) * R * H;
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  gru_recur_kernel<R><<<blocks, H, smem, st>>>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse);
  return cudaGetLastError();
}

}  // namespace

// x: [N, T, I]; xp scratch: [N, T, 3H]; ys: [N, T, H]; h0, h_last: [N, H].
extern "C" int gru_scan_launch(const float* x, const float* h0, const float* wi,
                               const float* bi, const float* wh, const float* bh,
                               float* xp, float* ys, float* h_last, int N, int T, int I,
                               int H, int reverse, int rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t M = (int64_t)N * T;
  const int Nc = 3 * H;
  dim3 pgrid((unsigned)((Nc + BN - 1) / BN), (unsigned)((M + BM - 1) / BM));
  gru_proj_kernel<<<pgrid, 256, 0, st>>>(x, wi, bi, xp, M, I, Nc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (rows_per_block) {
    case 1: err = launch_recur<1>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st); break;
    case 2: err = launch_recur<2>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st); break;
    case 4: err = launch_recur<4>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st); break;
    default: err = launch_recur<8>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st); break;
  }
  return (int)err;
}
