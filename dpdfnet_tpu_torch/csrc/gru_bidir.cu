// Bidirectional GRU (input size == hidden size == 64) from a zero state over
// every row of x [N, L, C]: ys_fw[n, l] is the forward hidden after step l,
// ys_bw[n, l] the backward hidden after the reverse walk reached l.
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py gru_bidir_tm, kernel _bidir_kernel
// (TPU).  It is the DPRNN intra recurrence when the parameters are not
// pre-packed (Engine(fuse=False)), the fc + LayerNorm + residual then run
// as separate ops.
//
// What bounds it on the H100: each row walks L dependent steps per
// direction; the useful work is 24 C^2 FLOPs per row-step (x and h
// projections of both directions) against 3 C * 4 bytes (x read once, the
// two hiddens written once), so the roofline bound is arithmetic and the
// walk's latency chain is what the kernel pays.
//
// Design: the intra kernel's walk (gru64_walk.cuh) with the hidden itself
// as the per-step output instead of the fc partials.  Both directions'
// useful f32 weights (192 KB) do not fit one block beside a row tile, and
// no epilogue needs both directions at once, so the directions run in
// separate blocks (grid.y), each holding its 96 KB of Wi / Wh in shared
// memory.  The packed direction-blockdiag weights (wi2 / wh2 [2C, 6C],
// b2 [2, 6C]) are read with their zero cross-direction blocks skipped.
// x and ys are float32 or bfloat16 (loads upcast, stores round once); the
// weights and all arithmetic are float32.
#include "gru64_walk.cuh"

using namespace dpdf;

template <int RPT, typename TX>
__global__ void __launch_bounds__(THREADS)
gru_bidir_kernel(const TX* __restrict__ x, TX* __restrict__ ys_fw,
                 TX* __restrict__ ys_bw, const float* __restrict__ wi2,
                 const float* __restrict__ wh2, const float* __restrict__ b2,
                 Rows rows, int64_t N, int L) {
  const int d = blockIdx.y;                       // 0 forward, 1 backward
  GruWeights w{wi2, wh2, b2, b2 + 6 * C, 6 * C, d * C, 2 * C, d * C};
  Epilogue<TX> ep{nullptr, nullptr, nullptr, nullptr, d == 0 ? ys_fw : ys_bw, 0.0f};
  gru64_walk<RPT, MODE_YS>(x, rows, N, L, d == 1, w, ep, nullptr, nullptr);
}

template <int RPT, typename TX>
static cudaError_t launch(const TX* x, TX* ys_fw, TX* ys_bw, const float* wi2,
                          const float* wh2, const float* b2, Rows rows, int64_t N, int L,
                          cudaStream_t stream) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * walk_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(gru_bidir_kernel<RPT, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + R - 1) / R), 2);
  gru_bidir_kernel<RPT, TX><<<grid, THREADS, smem, stream>>>(x, ys_fw, ys_bw, wi2, wh2, b2,
                                                              rows, N, L);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t run(const TX* x, TX* ys_fw, TX* ys_bw, const float* wi2, const float* wh2,
                       const float* b2, int64_t N, int L, int rows_per_block,
                       cudaStream_t st) {
  Rows rows{N, 0, (int64_t)L * C, C};
  return rows_per_block == 16 ? launch<4>(x, ys_fw, ys_bw, wi2, wh2, b2, rows, N, L, st)
                              : launch<2>(x, ys_fw, ys_bw, wi2, wh2, b2, rows, N, L, st);
}

// x, ys_fw, ys_bw: [N, L, C] contiguous, float32, or bfloat16 when plane_bf16.
extern "C" int gru_bidir_launch(const void* x, void* ys_fw, void* ys_bw,
                                const float* wi2, const float* wh2, const float* b2,
                                long long N, int L, int rows_per_block, int plane_bf16,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(ys_fw),
                    static_cast<bf16*>(ys_bw), wi2, wh2, b2, N, L, rows_per_block, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(ys_fw),
                  static_cast<float*>(ys_bw), wi2, wh2, b2, N, L, rows_per_block, st);
}
