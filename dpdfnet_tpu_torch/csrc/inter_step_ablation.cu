// Timing ablation of the DPRNN inter step (the C = 64 GRU walk along time
// with its fc + LayerNorm + residual tail).  Every specialization is an
// instance of the production inter kernel (dprnn_inter.cuh, the warp walk
// of gru64_warp.cuh) templated on its output, step body and LayerNorm
// form, so no runtime branch sits in the timed step, and every one
// launches with the production plan (gru_kernels.inter_v1_plan) on the
// rows as a plane [1, T, rows, C]: `full` is the production kernel (and
// `gru` its defer mode), the same instantiation as dprnn_inter_launch's,
// bit for bit.  Driven by dpdfnet_tpu_torch/tools/inter_step_ablation.py,
// which maps the JAX tool's variant names onto these specializations.
//
// Replaces: tools/inter_step_ablation.py build -> pallas_call, kernel
// _kernel (TPU).
//
// What bounds it on the H100: the production walk's bound, operations
// (14 C^2 FLOPs per row-step for `full`); the wrong-math specializations
// drop pieces of that work and have no bound of their own.
//
// What each specialization keeps of the production step: per warp-step the
// shared-memory bytes of the step's product h . [Wh | Wfc] (64 KB, read
// once for the warp's R rows), per lane and row-step its FMAs (512, of
// which 128 are the fc columns); every specialization with products also
// keeps the hoisted x . Wi (48 KB of Wi per chunk of TS steps, 384 FMAs
// per lane and row-step).
//   E_FULL     the production step: GRU, fc, two-pass LayerNorm, residual;
//   E_FLOOR    h += x (StepFloor), out = h (OUT_HIDDEN): no hoist, no
//              product (0 KB, 0 FMAs), the loads, the slot, the
//              __syncwarp, the stores;
//   E_DOT      the products, h += the r-column sum (StepRSumAcc, the z and
//              n columns kept alive), out = h: the fc columns are read
//              and, as in the defer mode, not computed (384 FMAs);
//   E_GRU      the GRU step, out = h: the production's defer mode;
//   E_NOGATES  StepRSumAcc with the fc + LayerNorm + residual tail;
//   E_NOLN     the GRU step, out = x + (fc(h) + bfc) * g + bln (LN_NONE);
//   E_LN1PASS  the LayerNorm's variance as E[y^2] - mean^2 (LN_ONE_PASS);
//   E_LNBF16   the LayerNorm's statistics summed from bfloat16-rounded
//              terms (LN_BF16_STATS, the TPU's one-pass bf16 MXU
//              statistics).
// The weights arrive unpacked (wi, wh [C, 3C], bi, bh [3C]): the tool
// unpacks the JAX tool's packed [x | h] gate matrix.
//
// FFMA instructions in the SASS at the tools' default plan (two rows per
// warp, TS 4, bfloat16 planes; nvcc 12.9, cuobjdump -sass, printed by
// chip_smoke.py): E_FULL 2954, as dprnn_inter_launch's (768 of the hoist,
// 2 x 1024 of h . [Wh | Wfc]: the product on h0 and the step's, 138 of the
// gates and the LayerNorm), with its 24 + 38 local loads and stores
// (spills); E_NOLN 2919, E_LN1PASS 2946, E_LNBF16 2950; E_NOGATES 2866,
// every product FFMA of E_FULL; E_GRU 2399 (2304 of the products without
// the fc columns, 95 of the gates); E_DOT 2304, every product FFMA of
// E_GRU; E_FLOOR 0.
#include "dprnn_inter.cuh"

using namespace dpdf;

namespace {

enum InterSpec {
  E_FULL = 0, E_FLOOR = 1, E_DOT = 2, E_GRU = 3, E_NOGATES = 4, E_NOLN = 5, E_LN1PASS = 6,
  E_LNBF16 = 7,
};

template <typename TX>
cudaError_t run_spec(int spec, const TX* x, TX* out, const float* h0, float* h_last,
                     const float* wi, const float* bi, const float* wh, const float* bh,
                     const float* wfc, const float* bfc, const float* g, const float* bln,
                     int N, int T, int rows_per_warp, int ts, int warps, int blocks,
                     cudaStream_t st) {
#define DPDF_RUN(OUT, STEP, LN)                                                                \
  inter::run<ww::OUT, ww::STEP, ww::LN>(x, out, h0, h_last, wi, bi, wh, bh, wfc, bfc, g, bln, 1, \
                                        T, N, rows_per_warp, ts, warps, blocks, 0, 0, st)
  switch (spec) {
    case E_FULL: return DPDF_RUN(OUT_LN_RESIDUAL, StepGru, LN_TWO_PASS);
    case E_FLOOR: return DPDF_RUN(OUT_HIDDEN, StepFloor, LN_TWO_PASS);
    case E_DOT: return DPDF_RUN(OUT_HIDDEN, StepRSumAcc, LN_TWO_PASS);
    case E_GRU: return DPDF_RUN(OUT_HIDDEN, StepGru, LN_TWO_PASS);
    case E_NOGATES: return DPDF_RUN(OUT_LN_RESIDUAL, StepRSumAcc, LN_TWO_PASS);
    case E_NOLN: return DPDF_RUN(OUT_LN_RESIDUAL, StepGru, LN_NONE);
    case E_LN1PASS: return DPDF_RUN(OUT_LN_RESIDUAL, StepGru, LN_ONE_PASS);
    case E_LNBF16: return DPDF_RUN(OUT_LN_RESIDUAL, StepGru, LN_BF16_STATS);
    default: return cudaErrorInvalidValue;
  }
#undef DPDF_RUN
}

}  // namespace

// x, out: [T, N, C], float32 or bfloat16 (plane_bf16); h0, h_last: [N, C]
// float32; wi, wh [C, 3C], bi, bh [3C], wfc [C, C], bfc, g, bln [C]; wi,
// wh, wfc 16-byte aligned.  The plan (rows per warp, TS, warps, blocks) is
// gru_kernels.inter_v1_plan's for N rows of T steps.
extern "C" int inter_ablation_launch(int spec, const void* x, void* out, const float* h0,
                                     float* h_last, const float* wi, const float* bi,
                                     const float* wh, const float* bh, const float* wfc,
                                     const float* bfc, const float* g, const float* bln,
                                     long long N, int T, int rows_per_warp, int ts, int warps,
                                     int blocks, int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N < 1 || N > (1 << 30)) return (int)cudaErrorInvalidValue;
  const auto go = [&](auto* xt, auto* ot) {
    return run_spec(spec, xt, ot, h0, h_last, wi, bi, wh, bh, wfc, bfc, g, bln, (int)N, T,
                    rows_per_warp, ts, warps, blocks, st);
  };
  return (int)(plane_bf16 ? go(static_cast<const bf16*>(x), static_cast<bf16*>(out))
                          : go(static_cast<const float*>(x), static_cast<float*>(out)));
}
