// DPRNN intra stage, v2, on Hopper: x + LN(fc([ys_fw, ys_bw])) with a
// bidirectional GRU along frequency from a zero state over every row of
// x [N, L, C], its input projections hoisted off the recurrence.
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_intra_block_v2, kernel
// _intra_v2_kernel (TPU).  Weights from pack_intra_v2: wi_cat [C, 6C]
// (both directions' Wi side by side, gate-major columns
// [r_f r_b z_f z_b n_f n_b]), wh_big [2C, 8C] = [Wh2 | blockdiag(Wfc_f,
// Wfc_b)], plus the v1 b2 [2, 6C].
//
// What bounds it on the H100: per row-step 28 C^2 useful FLOPs (both
// directions' x and h products and the fc) against the plane read and
// written once; arithmetic on paper, but each row walks L = 40 / 48
// dependent steps per direction, and every walking warp reads its weights
// from shared memory at every step (dprnn_intra.cu).
//
// Design: the TPU kernel's two ideas, xp = x . wi_cat + b2[0] hoisted off
// the walk and one product h . [Wh2 | blockdiag(Wfc)] per step, are what
// the production intra kernel (dprnn_intra.cuh on the warp walk of
// gru64_warp.cuh) already does on this card: per chunk of TS steps each
// warp computes its rows' xp into a warp-private shared slice, and each
// step's one product h . [Wh_d | Wfc_d] gives the next step's gates and
// this step's fc partial; a two-CTA cluster (one CTA per direction) sums
// the partials and applies LayerNorm and the residual in the same launch.
// So this file is that kernel, instantiated to read its weights straight
// from the v2 packs (intra::W_GIVEN, the layout that
// gru_kernels.intra_v2_layout gives: direction d's Wi in wi_cat's columns,
// its Wh and fc in wh_big's nonzero blocks; the zero cross-direction
// blocks are never read), with the production plan (gru_kernels.intra_plan).
// One launch; no xp plane in device memory.  With xp_bf16 the step body
// rounds the hoisted xp (bias included) to bfloat16 before the gates
// (ww::StepGruXpBf16), as the TPU kernel stores its xp scratch; with f32 xp
// it is the production step, and the output is bit for bit the v1 stage's
// (dprnn_intra_block on the matching packs).
#include "dprnn_intra.cuh"

using namespace dpdf;

// x, out: [N, L, C] contiguous, float32, or bfloat16 when plane_bf16;
// part: f32 scratch [2, N, L, C]; wi_cat, wh_big, b2, bfc, g, bln float32,
// wi_cat and wh_big 16-byte aligned; direction d's weights where
// (wi_drow, wi_ld, wh_ld, fc_off, fc_doff, fc_ld) put them
// (intra::PackLayout, the fc inside wh_big).  The plan (rows per walking
// warp 1 / 2, walking warps, warps per CTA up to 8, clusters of two CTAs)
// comes from gru_kernels.intra_plan.
extern "C" int dprnn_intra_v2_launch(const void* x, void* out, float* part, const float* wi_cat,
                                     const float* wh_big, const float* b2, const float* bfc,
                                     const float* g, const float* bln, long long N, int L,
                                     int wi_drow, int wi_ld, int wh_ld, int fc_off, int fc_doff,
                                     int fc_ld, int rows_per_warp, int walk_warps, int warps,
                                     int clusters, int xp_bf16, int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const intra::PackLayout lay{wi_drow, wi_ld, wh_ld, fc_off, fc_doff, fc_ld};
#define DPDF_RUN(STEP, TX)                                                                  \
  return (int)intra::run<ww::STEP, intra::FIN_STAGE, intra::W_GIVEN>(                        \
      static_cast<const TX*>(x), static_cast<TX*>(out), part, wi_cat, wh_big, b2, wh_big, bfc, \
      g, bln, N, L, 0, rows_per_warp, walk_warps, warps, clusters, st, lay)
  if (plane_bf16 && xp_bf16) DPDF_RUN(StepGruXpBf16, bf16);
  if (plane_bf16) DPDF_RUN(StepGru, bf16);
  if (xp_bf16) DPDF_RUN(StepGruXpBf16, float);
  DPDF_RUN(StepGru, float);
#undef DPDF_RUN
}
