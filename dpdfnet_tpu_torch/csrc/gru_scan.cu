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
//  1. proj_gemm_kernel (proj_gemm.cuh): the input projection
//     xp = x . Wi + bi for all T at once, a tiled shared-memory SGEMM over
//     the N*T rows (no recurrence, fully parallel) into a scratch
//     [N, T, 3H].
//  2. gru_recur_kernel: one block owns R = 1..8 rows and walks T; thread u
//     owns hidden unit u (blockDim = H).  h lives in shared memory; Wh is
//     streamed from L2 (which holds it) every step, each load feeding the
//     block's R rows.  R is chosen so the grid stays within one wave.
// Splitting Wh over a thread-block cluster (DSMEM) is later work.
// x and ys are float32 or bfloat16 (loads upcast, stores round once); the
// projection scratch, h0 / h_last, the weights and all arithmetic are
// float32.
#include "proj_gemm.cuh"

using namespace dpdf;

namespace {

// xp: [N, T, 3H] (bias bi included); ys: [N, T, H]; h0, h_last: [N, H].
template <int R, typename TX>
__global__ void gru_recur_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                                 const float* __restrict__ wh, const float* __restrict__ bh,
                                 TX* __restrict__ ys, float* __restrict__ h_last,
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
      if (n < N) store_f(ys + ((int64_t)n * T + t) * H + u, hnew[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int n = n0 + j;
    if (n < N) h_last[(int64_t)n * H + u] = sh[j * H + u];
  }
}

template <int R, typename TX>
cudaError_t launch_recur(const float* xp, const float* h0, const float* wh, const float* bh,
                         TX* ys, float* h_last, int N, int T, int H, int reverse,
                         cudaStream_t st) {
  const size_t smem = sizeof(float) * R * H;
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  gru_recur_kernel<R, TX><<<blocks, H, smem, st>>>(xp, h0, wh, bh, ys, h_last, N, T, H,
                                                   reverse);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t run(const TX* x, const float* h0, const float* wi, const float* bi,
                const float* wh, const float* bh, float* xp, TX* ys, float* h_last, int N,
                int T, int I, int H, int reverse, int rows_per_block, cudaStream_t st) {
  cudaError_t err = launch_proj_gemm(x, wi, bi, xp, (int64_t)N * T, I, 3 * H, st);
  if (err != cudaSuccess) return err;
  switch (rows_per_block) {
    case 1: return launch_recur<1>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st);
    case 2: return launch_recur<2>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st);
    case 4: return launch_recur<4>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st);
    default: return launch_recur<8>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, st);
  }
}

}  // namespace

// x: [N, T, I]; xp scratch: [N, T, 3H] f32; ys: [N, T, H]; h0, h_last:
// [N, H] f32.  x and ys are float32, or bfloat16 when plane_bf16.
extern "C" int gru_scan_launch(const void* x, const float* h0, const float* wi,
                               const float* bi, const float* wh, const float* bh,
                               float* xp, void* ys, float* h_last, int N, int T, int I,
                               int H, int reverse, int rows_per_block, int plane_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), h0, wi, bi, wh, bh, xp,
                    static_cast<bf16*>(ys), h_last, N, T, I, H, reverse, rows_per_block, st);
  return (int)run(static_cast<const float*>(x), h0, wi, bi, wh, bh, xp,
                  static_cast<float*>(ys), h_last, N, T, I, H, reverse, rows_per_block, st);
}
