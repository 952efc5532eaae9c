// The DPRNN inter kernel of dprnn_inter.cu (its design is described there)
// as templates: the step body (STEP) and the LayerNorm form (LN) are
// compile-time hooks whose defaults are the production step, so
// inter_step_ablation.cu's specializations are instances of this kernel
// and its `full` (and its `gru`, the defer mode) is the production
// instantiation with the production plan.
#pragma once

#include "gru64_warp.cuh"

namespace dpdf {
namespace inter {

constexpr int MAX_WARPS = 12;

template <int R, int TS, int OUT, typename TX, typename STEP = ww::StepGru,
          int LN = ww::LN_TWO_PASS>
__global__ void __launch_bounds__(MAX_WARPS * ww::LANES, 1)
dprnn_inter_kernel(const TX* __restrict__ x, TX* __restrict__ out,
                   const float* __restrict__ h0, float* __restrict__ h_last, GruWeights w,
                   const float* __restrict__ wfc, const float* __restrict__ bfc,
                   const float* __restrict__ g, const float* __restrict__ bln, Rows rows,
                   Rows orows, Rows hrows, int64_t N, int T) {
  extern __shared__ __align__(16) float smem[];
  ww::stage_weights(smem, w, wfc);
  __syncthreads();                       // the only block-wide barrier
  const int warp = threadIdx.x / ww::LANES, lane = threadIdx.x % ww::LANES;
  const int warps = blockDim.x / ww::LANES;
  const int64_t row0 = ((int64_t)blockIdx.x * warps + warp) * R;
  if (row0 >= N) return;
  const ww::LaneParams p = ww::lane_params(w, bfc, g, bln, lane);
  ww::walk<R, TS, OUT, TX, TX, STEP, LN>(smem,
                                         smem + ww::W_FLOATS + warp * ww::warp_floats(R, TS), x,
                                         rows, orows, hrows, row0, N, T, false, p, out, nullptr,
                                         0, h0, h_last, lane);
}

template <int R, int TS, int OUT, typename STEP, int LN, typename TX>
cudaError_t launch(const TX* x, TX* out, const float* h0, float* h_last, GruWeights w,
                   const float* wfc, const float* bfc, const float* g, const float* bln,
                   Rows rows, Rows orows, Rows hrows, int64_t N, int T, int warps, int blocks,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (ww::W_FLOATS + (size_t)warps * ww::warp_floats(R, TS));
  cudaError_t err = cudaFuncSetAttribute(dprnn_inter_kernel<R, TS, OUT, TX, STEP, LN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dprnn_inter_kernel<R, TS, OUT, TX, STEP, LN><<<blocks, warps * ww::LANES, smem, stream>>>(
      x, out, h0, h_last, w, wfc, bfc, g, bln, rows, orows, hrows, N, T);
  return cudaGetLastError();
}

// OUT's walk over x [B, T, Fq, C] (fm == 0) or the freq-major layout (fm;
// see dprnn_inter.cu), with the plan of gru_kernels.inter_v1_plan.
template <int OUT, typename STEP = ww::StepGru, int LN = ww::LN_TWO_PASS, typename TX>
cudaError_t run(const TX* x, TX* out, const float* h0, float* h_last, const float* wi,
                const float* bi, const float* wh, const float* bh, const float* wfc,
                const float* bfc, const float* g, const float* bln, int B, int T, int Fq,
                int rows_per_warp, int ts, int warps, int blocks, int fm, int h_bm,
                cudaStream_t st) {
  const int64_t N = (int64_t)B * Fq;
  if (warps < 1 || warps > MAX_WARPS || blocks < 1 || T < 1 || N < 1 ||
      (int64_t)blocks * warps * rows_per_warp < N)
    return cudaErrorInvalidConfiguration;
  GruWeights w{wi, wh, bi, bh, G3, 0, C, 0};
  Rows rows, orows, hrows;
  if (fm) {
    // row n = f * B + b; x[t, n] at t*N*C + n*C; out[f, t, b] at
    // f*T*B*C + t*B*C + b*C; h_bm: h[b, f] at b*Fq*C + f*C
    rows = Rows{N, 0, C, N * C};
    orows = Rows{B, (int64_t)T * B * C, C, (int64_t)B * C};
    hrows = h_bm ? Rows{B, C, (int64_t)Fq * C, 0} : dense_rows(N);
  } else {
    // row n = b * Fq + f; x[b, t, f, :] at b*T*Fq*C + f*C + t*Fq*C
    rows = Rows{Fq, (int64_t)T * Fq * C, C, (int64_t)Fq * C};
    orows = rows;
    hrows = dense_rows(N);
  }
#define DPDF_LAUNCH(R, TS)                                                                    \
  launch<R, TS, OUT, STEP, LN>(x, out, h0, h_last, w, wfc, bfc, g, bln, rows, orows, hrows, N, \
                               T, warps, blocks, st)
  if (rows_per_warp == 1 && ts == 1) return DPDF_LAUNCH(1, 1);
  if (rows_per_warp == 1 && ts == 8) return DPDF_LAUNCH(1, 8);
  if (rows_per_warp == 2 && ts == 1) return DPDF_LAUNCH(2, 1);
  if (rows_per_warp == 2 && ts == 4) return DPDF_LAUNCH(2, 4);
  return cudaErrorInvalidValue;
#undef DPDF_LAUNCH
}

}  // namespace inter
}  // namespace dpdf
