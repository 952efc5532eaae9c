// DPRNN inter stage, v2, on Hopper: the GRU along time over every (b, f)
// row of the [B, T, Fq, C] plane with its input projections precomputed,
// fused with out[t] = x[t] + LN(h_t . Wfc + bfc).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_inter_block_v2, kernel
// _inter_v2_kernel (TPU).
//
// Inputs: xp [B, T, Fq, 3C] = x . Wi + bi (computed by the caller, float32
// or bfloat16), the residual plane x [B, T, Fq, C] (float32 or bfloat16),
// h0 [B, Fq, C] f32, whfc [C, 4C] = [Wh | Wfc], bh [3C], bfc, g, bln [C].
// Outputs: out (the plane's type) and h_last [B, Fq, C] f32.  Rows are
// addressed through strides (row n = b * Fq + f), as in dprnn_inter.cu:
// no transpose of either plane.
//
// What bounds it on the H100: the recurrence is sequential in T, and only
// B * Fq rows run in parallel (384 at B=8).  The kernel's useful work is
// 8 C^2 FLOPs per row-step (one 64 x 256 product) against x and xp read
// once and out written once (5 C plane values); the caller's xp GEMM adds
// 6 C^2.  Arithmetic on paper; what the kernel pays is the per-step chain
// gates -> h_new -> one 64-deep shared-memory product -> LayerNorm.
//
// Design: the walk of gru64_v2.cuh.  [Wh | Wfc] (64 KB f32) stays in
// shared memory; the carried raw h . Wh of unit u stays in thread u's
// registers; xp and x are read straight from device memory.  The step-0
// product h0 . Wh comes first.
#include "gru64_v2.cuh"

using namespace dpdf;

template <int RPT, typename TP, typename TX>
__global__ void __launch_bounds__(THREADS)
dprnn_inter_v2_kernel(const TP* __restrict__ xp, const TX* __restrict__ x, TX* __restrict__ out,
                      const float* __restrict__ h0, float* __restrict__ h_last,
                      FusedWeights w, Epilogue<TX> ep, XpRows xr, Rows rows, int64_t N,
                      int T) {
  ep.out = out;
  gru64_v2_walk<RPT, MODE_LN_RESIDUAL>(xp, xr, x, rows, N, T, false, w, ep, h0, h_last);
}

template <int RPT, typename TP, typename TX>
static cudaError_t launch(const TP* xp, const TX* x, TX* out, const float* h0, float* h_last,
                          FusedWeights w, Epilogue<TX> ep, XpRows xr, Rows rows, int64_t N,
                          int T, cudaStream_t stream) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * v2_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(dprnn_inter_v2_kernel<RPT, TP, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  dprnn_inter_v2_kernel<RPT, TP, TX><<<blocks, THREADS, smem, stream>>>(
      xp, x, out, h0, h_last, w, ep, xr, rows, N, T);
  return cudaGetLastError();
}

template <typename TP, typename TX>
static cudaError_t run(const TP* xp, const TX* x, TX* out, const float* h0, float* h_last,
                       const float* whfc, const float* bh, const float* bfc, const float* g,
                       const float* bln, int B, int T, int Fq, int rows_per_block,
                       cudaStream_t st) {
  FusedWeights w{whfc, bh, 4 * C, 0, C, 0, G3};
  Epilogue<TX> ep{nullptr, bfc, g, bln, out, 1e-5f};
  // row n = b * Fq + f; x[b, t, f, :] at b*T*Fq*C + f*C + t*Fq*C, xp likewise with 3C
  Rows rows{Fq, (int64_t)T * Fq * C, C, (int64_t)Fq * C};
  XpRows xr{Rows{Fq, (int64_t)T * Fq * G3, G3, (int64_t)Fq * G3}, C, 0};
  const int64_t N = (int64_t)B * Fq;
  return rows_per_block == 16 ? launch<4>(xp, x, out, h0, h_last, w, ep, xr, rows, N, T, st)
                              : launch<2>(xp, x, out, h0, h_last, w, ep, xr, rows, N, T, st);
}

// xp: [B, T, Fq, 3C], float32, or bfloat16 when xp_bf16; x, out:
// [B, T, Fq, C], float32, or bfloat16 when plane_bf16; h0, h_last:
// [B, Fq, C] f32; whfc [C, 4C], bh [3C], bfc / g / bln [C] f32.
extern "C" int dprnn_inter_v2_launch(const void* xp, const void* x, void* out, const float* h0,
                                     float* h_last, const float* whfc, const float* bh,
                                     const float* bfc, const float* g, const float* bln, int B,
                                     int T, int Fq, int rows_per_block, int xp_bf16,
                                     int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DPDF_RUN(TP, TX)                                                                      \
  return (int)run(static_cast<const TP*>(xp), static_cast<const TX*>(x), static_cast<TX*>(out), \
                  h0, h_last, whfc, bh, bfc, g, bln, B, T, Fq, rows_per_block, st)
  if (xp_bf16 && plane_bf16) DPDF_RUN(bf16, bf16);
  if (xp_bf16) DPDF_RUN(bf16, float);
  if (plane_bf16) DPDF_RUN(float, bf16);
  DPDF_RUN(float, float);
#undef DPDF_RUN
}
