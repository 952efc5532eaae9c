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
// The kernel's templates live in dprnn_inter.cuh, which
// inter_step_ablation.cu instantiates too.
#include "dprnn_inter.cuh"

using namespace dpdf;

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
  const auto go = [&](auto* xt, auto* ot) {
    return defer ? inter::run<ww::OUT_HIDDEN>(xt, ot, h0, h_last, wi, bi, wh, bh, wfc, bfc, g,
                                              bln, B, T, Fq, rows_per_warp, ts, warps, blocks,
                                              fm_batch, h_bm, st)
                 : inter::run<ww::OUT_LN_RESIDUAL>(xt, ot, h0, h_last, wi, bi, wh, bh, wfc, bfc,
                                                   g, bln, B, T, Fq, rows_per_warp, ts, warps,
                                                   blocks, fm_batch, h_bm, st);
  };
  return (int)(plane_bf16 ? go(static_cast<const bf16*>(x), static_cast<bf16*>(out))
                          : go(static_cast<const float*>(x), static_cast<float*>(out)));
}
