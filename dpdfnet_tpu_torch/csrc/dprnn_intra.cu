// DPRNN intra stage on Hopper: a bidirectional GRU along frequency from a
// zero state over every (b, t) row, then x + LN(fc_[2C->C]([ys_fw, ys_bw])).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_intra_block and
// dprnn_intra_block_tm, kernels _intra_block_kernel /
// _intra_block_kernel_tm (TPU).
//
// What bounds it on the H100: each row walks Fq = 40 / 48 dependent steps
// per direction; the useful work is 28 C^2 FLOPs per row-step (gates of
// both directions and the fc) against 2 C plane elements, so the roofline
// bound is arithmetic, and what the kernel pays is the walk's dependent
// chain and, per SM, every warp's shared-memory reads of its weights at
// every step.
//
// Design: the two directions of a tile of rows run as a two-CTA
// thread-block cluster, CTA rank d walking direction d (0 forward, 1
// backward) with the warp-per-row walk of gru64_warp.cuh: its own Wi_d and
// [Wh_d | Wfc_d] (112 KB) in shared memory, the input projection of each
// chunk of TS steps hoisted off the recurrence in the same launch, and one
// product h . [Wh_d | Wfc_d] per step whose last C columns are that
// step's fc partial.  Each direction stores its partials to a scratch
// [2][N][Fq][C] in device memory (a tile's partials are read back soon
// after, mostly from L2); after one cluster barrier each CTA finishes half
// of the positions: it sums both directions' partials, adds the bias,
// applies LayerNorm and the residual and stores the row.  So the stage is
// one launch, and shared memory holds only the weights and the warps'
// chunk slices, which lets a tile hold 8 warps of two rows each (each
// weight load from shared memory, the step's bound, then feeds two rows;
// partials kept in shared memory capped a tile at 6 rows).  The CTAs are
// persistent (a cluster walks tiles q, q + clusters, ...) so the weights
// are staged once per CTA; the plan (rows per warp, walking warps, warps,
// clusters) is gru_kernels.intra_plan.  The kernel reads the packed,
// direction-blockdiag weights (wi2 / wh2 [2C, 6C], b2 [2, 6C]) and skips
// their zero cross-direction blocks.  The plane x / out is float32 or
// bfloat16 (loads upcast, the store rounds once); the weights, the
// partials and all arithmetic are float32.
//
// Layouts (replacing the TPU kernel's fm_batch mode, which the freq-major
// DPRNN chain runs): row-major x, out [N, Fq, C]; or, with fm_batch = B,
// the freq-leading x [Fq, N, C] (rows t-major, n = t * B + b) and out
// [T, Fq, B, C], the layout the fm inter stage reads.  Both are a stride
// set of the walk and a row map of the store; the arithmetic does not
// change.  The kernel's templates live in dprnn_intra.cuh, which
// intra_step_ablation.cu instantiates too.
#include "dprnn_intra.cuh"

using namespace dpdf;

// fm_batch == 0: x, out [N, Fq, C] contiguous (N = B * T rows of the
// [B, T, Fq, C] plane).  fm_batch == B > 0: x [Fq, N, C] with N = T * B
// t-major rows, out [T, Fq, B, C].  Planes float32, or bfloat16 when
// plane_bf16; part: f32 scratch of 2 * N * Fq * C; weights float32,
// 16-byte aligned.  The plan (rows per walking warp 1 / 2, walking warps,
// warps per CTA up to 8, clusters of two CTAs) comes from
// gru_kernels.intra_plan.
extern "C" int dprnn_intra_launch(const void* x, void* out, float* part, const float* wi2,
                                  const float* wh2, const float* b2, const float* wfc,
                                  const float* bfc, const float* g, const float* bln,
                                  long long N, int Fq, long long fm_batch, int rows_per_warp,
                                  int walk_warps, int warps, int clusters, int plane_bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)intra::run(static_cast<const bf16*>(x), static_cast<bf16*>(out), part, wi2, wh2,
                           b2, wfc, bfc, g, bln, N, Fq, fm_batch, rows_per_warp, walk_warps,
                           warps, clusters, st);
  return (int)intra::run(static_cast<const float*>(x), static_cast<float*>(out), part, wi2, wh2,
                         b2, wfc, bfc, g, bln, N, Fq, fm_batch, rows_per_warp, walk_warps, warps,
                         clusters, st);
}
