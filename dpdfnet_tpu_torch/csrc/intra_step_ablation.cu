// Timing ablation of the DPRNN intra step (the bidirectional C = 64 GRU
// walk along frequency, then fc + LayerNorm + residual).  Every
// specialization is an instance of the production intra kernel
// (dprnn_intra.cuh, the warp walk of gru64_warp.cuh on a two-CTA cluster)
// templated on its step body and finish, so no runtime branch sits in the
// timed step, and every one launches with the production plan
// (gru_kernels.intra_plan): `full` is the production kernel, the same
// instantiation as dprnn_intra_launch's, bit for bit.  Driven by
// dpdfnet_tpu_torch/tools/intra_step_ablation.py, which maps the JAX tool's
// variant names onto these specializations.
//
// Replaces: tools/intra_step_ablation.py build -> pallas_call, kernel
// _kernel (TPU).
//
// What bounds it on the H100: the production walk's bound, operations
// (28 C^2 FLOPs per row-step for `full`); the wrong-math specializations
// drop pieces of that work and have no bound of their own.
//
// What each specialization keeps of the production step: per warp-step the
// shared-memory bytes of the step's weight product (a warp reads them once
// for its R rows), per lane and row-step the product's FMAs; every
// specialization with products also keeps the hoisted x . Wi (48 KB of Wi
// per chunk of TS = 4 steps, 384 FMAs per lane and row-step).
//   I_FULL           the production stage: the GRU step, h . [Wh | Wfc]
//                    (64 KB, 512 FMAs), the fc partials stored per step,
//                    the LayerNorm epilogue after the cluster barrier;
//   I_HLAST          the GRU step, h . Wh alone (OUT_NONE: 48 KB, 384
//                    FMAs), no per-step store, no epilogue; out = the
//                    forward direction's last hidden;
//   I_DOTS           as I_HLAST with the gates replaced by the r-column add
//                    (StepRSum, the z and n columns kept alive);
//   I_INDEP          as I_DOTS with the product applied to the next step's
//                    x (StepIndep): the same work with no dependence on h;
//   I_GATES          the gates with identity weights (StepGates): no hoist,
//                    no product (0 KB, 0 FMAs);
//   I_FLOOR          h += x (StepFloor): the chunk loads, the slot, the
//                    __syncwarp and one add; out = the forward sum;
//   I_FLOOR_FB       StepFloor, out = the forward sum + the backward sum;
//   I_FLOOR_FB_BF16  each sum rounded to bfloat16 (StepFloorBf16), out as
//                    I_FLOOR_FB.
// Both directions walk in every specialization (the two CTAs of each
// cluster), so each keeps the production's two-direction work shape.  x is
// read in the row-major [rows, T, C] layout or, with `tm`, the
// freq-leading [T, rows, C] one (the production's fm_batch = rows).
//
// FFMA instructions in the SASS at the tools' default plan (two rows per
// warp, bfloat16 planes; nvcc 12.9, cuobjdump -sass, printed by
// chip_smoke.py): I_FULL 1916, as dprnn_intra_launch's (768 of the x . Wi
// hoist, 1024 of h . [Wh | Wfc], 124 of the gates, the LayerNorm and the
// epilogue); I_HLAST 1631 (768 + 768 of h . Wh + 95 of the gates); I_DOTS
// 1536, every product FFMA of I_HLAST; I_INDEP 2304 (I_DOTS' and the 768
// of its step-0 product on x_0); I_GATES 67; the floors 0.  None spills.
#include "dprnn_intra.cuh"

using namespace dpdf;

namespace {

enum IntraSpec {
  I_FULL = 0, I_HLAST = 1, I_DOTS = 2, I_INDEP = 3, I_GATES = 4,
  I_FLOOR = 5, I_FLOOR_FB = 6, I_FLOOR_FB_BF16 = 7,
};

template <typename TX>
cudaError_t run_spec(int spec, const TX* x, TX* out, float* part, const float* wi2,
                     const float* wh2, const float* b2, const float* wfc, const float* bfc,
                     const float* g, const float* bln, int64_t N, int T, int tm, int rows_per_warp,
                     int walk_warps, int warps, int clusters, cudaStream_t st) {
  const int64_t fm_b = tm ? N : 0;
#define DPDF_RUN(STEP, FIN)                                                                 \
  intra::run<ww::STEP, intra::FIN>(x, out, part, wi2, wh2, b2, wfc, bfc, g, bln, N, T, fm_b, \
                                   rows_per_warp, walk_warps, warps, clusters, st)
  switch (spec) {
    case I_FULL: return DPDF_RUN(StepGru, FIN_STAGE);
    case I_HLAST: return DPDF_RUN(StepGru, FIN_FW);
    case I_DOTS: return DPDF_RUN(StepRSum, FIN_FW);
    case I_INDEP: return DPDF_RUN(StepIndep, FIN_FW);
    case I_GATES: return DPDF_RUN(StepGates, FIN_FW);
    case I_FLOOR: return DPDF_RUN(StepFloor, FIN_FW);
    case I_FLOOR_FB: return DPDF_RUN(StepFloor, FIN_SUM);
    case I_FLOOR_FB_BF16: return DPDF_RUN(StepFloorBf16, FIN_SUM);
    default: return cudaErrorInvalidValue;
  }
#undef DPDF_RUN
}

}  // namespace

// x: [N, T, C] (tm == 0) or [T, N, C] (tm == 1), float32 or bfloat16
// (plane_bf16); out: x's shape for I_FULL, else [N, C], at x's dtype.
// Packed direction-blockdiag wi2 / wh2 [2C, 6C], b2 [2, 6C]; wfc [2C, C];
// bfc, g, bln [C]; the weights 16-byte aligned.  Scratch part f32:
// [2, N, T, C] for I_FULL, else [2, N, C].  The plan (rows per walking
// warp, walking warps, warps per CTA, clusters) is gru_kernels.intra_plan's
// for N rows of T positions.
extern "C" int intra_ablation_launch(int spec, const void* x, void* out, float* part,
                                     const float* wi2, const float* wh2, const float* b2,
                                     const float* wfc, const float* bfc, const float* g,
                                     const float* bln, long long N, int T, int tm,
                                     int rows_per_warp, int walk_warps, int warps, int clusters,
                                     int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto go = [&](auto* xt, auto* ot) {
    return run_spec(spec, xt, ot, part, wi2, wh2, b2, wfc, bfc, g, bln, N, T, tm, rows_per_warp,
                    walk_warps, warps, clusters, st);
  };
  return (int)(plane_bf16 ? go(static_cast<const bf16*>(x), static_cast<bf16*>(out))
                          : go(static_cast<const float*>(x), static_cast<float*>(out)));
}
