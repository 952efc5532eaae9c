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
// two hiddens written once), so the roofline bound is arithmetic, and what
// the kernel pays is the walk's dependent chain and, per SM, every warp's
// shared-memory reads of its weights at every step.
//
// Design: the warp walk of gru64_warp.cuh (DPRNN intra's walk) with the
// hidden itself as the per-step output (OUT_YS): one warp owns 1 or 2
// rows, lane l units l and l + 32; x . Wi + bi is hoisted per chunk of TS
// steps inside the launch and the next chunk's x prefetched; the step's
// product is h . Wh alone (192 columns, 6 per lane, 48 KB of weights read
// per warp and step).  No epilogue needs both directions at once, so each
// direction runs in CTAs of its own (even blockIdx.x forward, odd
// backward), each staging its Wi and Wh (96 KB) once in shared memory;
// the CTAs are persistent over row tiles (CTA pair q walks tiles q,
// q + ctas, ...), and the plan (rows per warp, walking warps, warps, CTAs
// per direction) is gru_kernels.gru_bidir_plan.  The packed
// direction-blockdiag weights (wi2 / wh2 [2C, 6C], b2 [2, 6C]) are read
// with their zero cross-direction blocks skipped.  x and ys are float32 or
// bfloat16 (loads upcast, stores round once); the weights and all
// arithmetic are float32.
#include "gru64_warp.cuh"

using namespace dpdf;

namespace {

constexpr int MAX_WARPS = 8;
constexpr int TS = 4;                            // steps per pass over Wi
constexpr int W_FLOATS = 2 * ww::WI_FLOATS;      // Wi and Wh of one direction

template <int R, typename TX>
__global__ void __launch_bounds__(MAX_WARPS * ww::LANES, 1)
gru_bidir_kernel(const TX* __restrict__ x, TX* __restrict__ ys_fw, TX* __restrict__ ys_bw,
                 const float* __restrict__ wi2, const float* __restrict__ wh2,
                 const float* __restrict__ b2, Rows rows, int64_t N, int L, int walk_warps,
                 int tiles) {
  const int d = blockIdx.x & 1;                   // 0 forward, 1 backward
  const int q = blockIdx.x >> 1, ctas = gridDim.x >> 1;
  const int warp = threadIdx.x / ww::LANES, lane = threadIdx.x % ww::LANES;
  extern __shared__ __align__(16) float smem[];
  const GruWeights w{wi2, wh2, b2, b2 + 6 * C, 6 * C, d * C, 2 * C, d * C};
  ww::stage_weights_ys(smem, w);
  const ww::LaneParams p = ww::lane_params(w, nullptr, nullptr, nullptr, lane);
  __syncthreads();                                // the only block-wide barrier
  if (warp >= walk_warps) return;
  float* wbuf = smem + W_FLOATS + warp * ww::warp_floats(R, TS);
  TX* ys = d == 0 ? ys_fw : ys_bw;
  const int rows_cta = walk_warps * R;
  for (int tile = q; tile < tiles; tile += ctas) {
    const int64_t row0 = (int64_t)tile * rows_cta + warp * R;
    if (row0 < N)
      ww::walk<R, TS, ww::OUT_YS>(smem, wbuf, x, rows, rows, rows, row0, N, L, d == 1, p, ys,
                                  nullptr, 0, nullptr, nullptr, lane);
  }
}

template <int R, typename TX>
cudaError_t launch(const TX* x, TX* ys_fw, TX* ys_bw, const float* wi2, const float* wh2,
                   const float* b2, Rows rows, int64_t N, int L, int walk_warps, int warps,
                   int ctas, cudaStream_t st) {
  const int64_t rows_cta = (int64_t)walk_warps * R;
  const size_t smem = sizeof(float) * (W_FLOATS + (size_t)walk_warps * ww::warp_floats(R, TS));
  cudaError_t err = cudaFuncSetAttribute(gru_bidir_kernel<R, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (int)((N + rows_cta - 1) / rows_cta);
  gru_bidir_kernel<R, TX><<<2 * ctas, warps * ww::LANES, smem, st>>>(
      x, ys_fw, ys_bw, wi2, wh2, b2, rows, N, L, walk_warps, tiles);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t run(const TX* x, TX* ys_fw, TX* ys_bw, const float* wi2, const float* wh2,
                const float* b2, int64_t N, int L, int rows_per_warp, int walk_warps, int warps,
                int ctas, cudaStream_t st) {
  if (walk_warps < 1 || warps < walk_warps || warps > MAX_WARPS || ctas < 1 || N < 1 || L < 1)
    return cudaErrorInvalidConfiguration;
  const Rows rows{N, 0, (int64_t)L * C, C};       // x[n, l] at n * L * C + l * C
  switch (rows_per_warp) {
    case 1: return launch<1>(x, ys_fw, ys_bw, wi2, wh2, b2, rows, N, L, walk_warps, warps, ctas, st);
    case 2: return launch<2>(x, ys_fw, ys_bw, wi2, wh2, b2, rows, N, L, walk_warps, warps, ctas, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, ys_fw, ys_bw: [N, L, C] contiguous, float32, or bfloat16 when
// plane_bf16; weights float32, wi2 / wh2 16-byte aligned.  The plan (rows
// per walking warp 1 / 2, walking warps, warps per CTA up to 8, CTAs per
// direction) comes from gru_kernels.gru_bidir_plan.
extern "C" int gru_bidir_launch(const void* x, void* ys_fw, void* ys_bw, const float* wi2,
                                const float* wh2, const float* b2, long long N, int L,
                                int rows_per_warp, int walk_warps, int warps, int ctas,
                                int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(ys_fw),
                    static_cast<bf16*>(ys_bw), wi2, wh2, b2, N, L, rows_per_warp, walk_warps,
                    warps, ctas, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(ys_fw),
                  static_cast<float*>(ys_bw), wi2, wh2, b2, N, L, rows_per_warp, walk_warps,
                  warps, ctas, st);
}
