// DPRNN inter stage on Hopper: a GRU along time over every (b, f) row of
// the [B, T, Fq, C] plane, fused with out[t] = x[t] + LN(h_t . Wfc + bfc).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_inter_block, kernels
// _inter_block_kernel_packed / _inter_block_kernel (TPU).
//
// What bounds it on the H100: the recurrence is sequential in T (112 steps
// per segment) and only B * Fq rows run in parallel (384 at B=8, 3072 at
// B=64).  Useful work is 14 C^2 FLOPs per row-step against 2 C plane
// elements, so the roofline bound is arithmetic; what the kernel pays is
// the step's dependent chain and, per SM, the shared-memory reads of the
// weights by every warp at every step.
//
// Design: the warp-per-row walk of gru64_warp.cuh.  A warp owns 1 or 2
// rows; the input projection x . Wi + bi runs off the recurrence, once per
// chunk of TS steps, inside this launch (the TPU kernel's in-kernel hoist);
// one product h . [Wh | Wfc] per step gives the next step's recurrent term
// and this step's fc (the TPU kernel's fcfuse), so the step loop has one
// __syncwarp and two warp-shuffle sums, and no block barrier.  Wi and
// [Wh | Wfc] (112 KB) are staged once per block.  One block per SM (up to
// 12 warps); the plan (rows per warp, warps, TS, blocks) is
// gru_kernels.inter_v1_plan.  h0 is read from, and h_last written to, the
// state's [B, Fq, C] layout (row n = b * Fq + f); the plane is read and
// written in place through strides.
//
// Modes (the TPU kernel's fm_batch, h_bm and defer), each a stride set or
// an output kind of the same walk, with the arithmetic unchanged:
//   fm_batch = B  x is the freq-major [T, Fq * B, C] (rows f-major,
//                 n = f * B + b) and out the freq-leading [Fq, T, B, C]
//                 that the next fm intra stage reads;
//   h_bm          (with fm_batch) h0 / h_last in the state's [B, Fq, C]
//                 instead of the rows' [Fq * B, C];
//   defer         the walk stores the raw hidden h_t in out's layout at
//                 the plane's dtype; the fc + LayerNorm + residual tail
//                 runs outside the kernel.
#include "gru64_warp.cuh"

using namespace dpdf;

namespace {

constexpr int MAX_WARPS = 12;

template <int R, int TS, int OUT, typename TX>
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
  ww::walk<R, TS, OUT>(smem, smem + ww::W_FLOATS + warp * ww::warp_floats(R, TS), x, rows,
                       orows, hrows, row0, N, T, false, p, out, nullptr, 0, h0, h_last, lane);
}

template <int R, int TS, int OUT, typename TX>
cudaError_t launch(const TX* x, TX* out, const float* h0, float* h_last, GruWeights w,
                   const float* wfc, const float* bfc, const float* g, const float* bln,
                   Rows rows, Rows orows, Rows hrows, int64_t N, int T, int warps, int blocks,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (ww::W_FLOATS + (size_t)warps * ww::warp_floats(R, TS));
  cudaError_t err = cudaFuncSetAttribute(dprnn_inter_kernel<R, TS, OUT, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dprnn_inter_kernel<R, TS, OUT, TX><<<blocks, warps * ww::LANES, smem, stream>>>(
      x, out, h0, h_last, w, wfc, bfc, g, bln, rows, orows, hrows, N, T);
  return cudaGetLastError();
}

template <int OUT, typename TX>
cudaError_t dispatch(const TX* x, TX* out, const float* h0, float* h_last, GruWeights w,
                     const float* wfc, const float* bfc, const float* g, const float* bln,
                     Rows rows, Rows orows, Rows hrows, int64_t N, int T, int rows_per_warp,
                     int ts, int warps, int blocks, cudaStream_t st) {
#define DPDF_LAUNCH(R, TS)                                                                    \
  launch<R, TS, OUT>(x, out, h0, h_last, w, wfc, bfc, g, bln, rows, orows, hrows, N, T, warps, \
                     blocks, st)
  if (rows_per_warp == 1 && ts == 1) return DPDF_LAUNCH(1, 1);
  if (rows_per_warp == 1 && ts == 8) return DPDF_LAUNCH(1, 8);
  if (rows_per_warp == 2 && ts == 1) return DPDF_LAUNCH(2, 1);
  if (rows_per_warp == 2 && ts == 4) return DPDF_LAUNCH(2, 4);
  return cudaErrorInvalidValue;
#undef DPDF_LAUNCH
}

template <typename TX>
cudaError_t run(const TX* x, TX* out, const float* h0, float* h_last, const float* wi,
                const float* bi, const float* wh, const float* bh, const float* wfc,
                const float* bfc, const float* g, const float* bln, int B, int T, int Fq,
                int rows_per_warp, int ts, int warps, int blocks, int fm, int h_bm, int defer,
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
  return defer ? dispatch<ww::OUT_HIDDEN>(x, out, h0, h_last, w, wfc, bfc, g, bln, rows, orows,
                                          hrows, N, T, rows_per_warp, ts, warps, blocks, st)
               : dispatch<ww::OUT_LN_RESIDUAL>(x, out, h0, h_last, w, wfc, bfc, g, bln, rows,
                                               orows, hrows, N, T, rows_per_warp, ts, warps,
                                               blocks, st);
}

}  // namespace

// fm_batch == 0: x, out [B, T, Fq, C]; h0, h_last [B, Fq, C].  fm_batch:
// x [T, Fq * B, C] (f-major rows), out [Fq, T, B, C]; h0, h_last
// [Fq * B, C], or [B, Fq, C] with h_bm.  defer: out holds the raw hidden.
// Planes float32, or bfloat16 when plane_bf16; hiddens and weights
// float32, the weights 16-byte aligned.  The plan (rows per warp 1 / 2,
// TS 1 or 8 / rows per warp, warps 1..12, blocks) comes from
// gru_kernels.inter_v1_plan.
extern "C" int dprnn_inter_launch(const void* x, void* out, const float* h0,
                                  float* h_last, const float* wi, const float* bi,
                                  const float* wh, const float* bh, const float* wfc,
                                  const float* bfc, const float* g, const float* bln,
                                  int B, int T, int Fq, int rows_per_warp, int ts, int warps,
                                  int blocks, int plane_bf16, int fm_batch, int h_bm, int defer,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(out), h0, h_last, wi, bi,
                    wh, bh, wfc, bfc, g, bln, B, T, Fq, rows_per_warp, ts, warps, blocks,
                    fm_batch, h_bm, defer, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), h0, h_last, wi, bi,
                  wh, bh, wfc, bfc, g, bln, B, T, Fq, rows_per_warp, ts, warps, blocks,
                  fm_batch, h_bm, defer, st);
}
