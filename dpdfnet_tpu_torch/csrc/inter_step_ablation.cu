// Timing ablation of the DPRNN inter step (the C = 64 GRU walk along time
// with its fc + LayerNorm + residual tail): one kernel templated on the
// specialization, so no runtime branch sits in the timed step.  Driven by
// dpdfnet_tpu_torch/tools/inter_step_ablation.py, which maps the JAX tool's
// variant names onto these specializations.
//
// Replaces: tools/inter_step_ablation.py build -> pallas_call, kernel
// _kernel (TPU).
//
// What bounds it on the H100: the production walk's bound, operations
// (14 C^2 FLOPs per row-step for `full`); the wrong-math specializations
// drop pieces of that work and have no bound of their own.
//
// Design: every specialization is the original block-wide inter walk of
// gru64_block_walk.cuh (Wi, Wh, Wfc in shared memory, 16 rows per block,
// the hidden carried in shared memory; the production inter kernel now
// walks with gru64_warp.cuh) with a different step body
// (Step), output (Mode) or LayerNorm (LnVariant):
//   E_FULL     the production step: GRU, fc, two-pass LayerNorm, residual;
//   E_FLOOR    STEP_SUM (h += x), out = h: loads, stores and barriers only;
//   E_DOT      STEP_RSUM_ACC (the products, h += r-column sum), out = h;
//   E_GRU      the GRU step, out = h (the deferred tail's kernel);
//   E_NOGATES  STEP_RSUM_ACC with the fc + LayerNorm + residual tail;
//   E_NOLN     the GRU step, out = x + (fc(h) * g + bln): no normalisation;
//   E_LN1PASS  the LayerNorm's variance as E[y^2] - mean^2;
//   E_LNBF16   the LayerNorm's statistics summed from bfloat16-rounded
//              terms (the TPU's one-pass bf16 MXU statistics).
// The weights arrive unpacked (wi, wh [C, 3C], bi, bh [3C]): the tool
// unpacks the JAX tool's packed [x | h] gate matrix.
#include "gru64_block_walk.cuh"

using namespace dpdf;

enum InterSpec {
  E_FULL = 0, E_FLOOR = 1, E_DOT = 2, E_GRU = 3, E_NOGATES = 4, E_NOLN = 5, E_LN1PASS = 6,
  E_LNBF16 = 7,
};

constexpr int RPT = 4;   // 16 rows per block: the production choice at the tool's row counts

template <int MODE, int STEP, int LNV, typename TX>
__global__ void __launch_bounds__(THREADS)
inter_ablation_kernel(const TX* __restrict__ x, TX* __restrict__ out,
                      const float* __restrict__ h0, float* __restrict__ h_last, GruWeights w,
                      Epilogue<TX> ep, Rows rows, int64_t N, int T) {
  ep.out = out;
  gru64_walk_io<RPT, MODE, TX, TX, STEP, LNV>(x, rows, rows, dense_rows(N), N, T, false, w, ep,
                                              h0, h_last);
}

template <int MODE, int STEP, int LNV, typename TX>
static cudaError_t launch(const TX* x, TX* out, const float* h0, float* h_last, GruWeights w,
                          Epilogue<TX> ep, Rows rows, int64_t N, int T, cudaStream_t st) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * walk_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(inter_ablation_kernel<MODE, STEP, LNV, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  inter_ablation_kernel<MODE, STEP, LNV, TX><<<blocks, THREADS, smem, st>>>(
      x, out, h0, h_last, w, ep, rows, N, T);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t run(int spec, const TX* x, TX* out, const float* h0, float* h_last,
                       const float* wi, const float* bi, const float* wh, const float* bh,
                       const float* wfc, const float* bfc, const float* g, const float* bln,
                       int64_t N, int T, cudaStream_t st) {
  GruWeights w{wi, wh, bi, bh, G3, 0, C, 0};
  Epilogue<TX> ep{wfc, bfc, g, bln, out, 1e-5f};
  const Rows rows{N, 0, C, N * C};                 // x[t, n] of [T, N, C]
  switch (spec) {
    case E_FULL:
      return launch<MODE_LN_RESIDUAL, STEP_GRU, LN_TWO_PASS>(x, out, h0, h_last, w, ep, rows, N,
                                                            T, st);
    case E_FLOOR:
      return launch<MODE_YS, STEP_SUM, LN_TWO_PASS>(x, out, h0, h_last, w, ep, rows, N, T, st);
    case E_DOT:
      return launch<MODE_YS, STEP_RSUM_ACC, LN_TWO_PASS>(x, out, h0, h_last, w, ep, rows, N, T,
                                                         st);
    case E_GRU:
      return launch<MODE_YS, STEP_GRU, LN_TWO_PASS>(x, out, h0, h_last, w, ep, rows, N, T, st);
    case E_NOGATES:
      return launch<MODE_LN_RESIDUAL, STEP_RSUM_ACC, LN_TWO_PASS>(x, out, h0, h_last, w, ep,
                                                                 rows, N, T, st);
    case E_NOLN:
      return launch<MODE_LN_RESIDUAL, STEP_GRU, LN_NONE>(x, out, h0, h_last, w, ep, rows, N, T,
                                                        st);
    case E_LN1PASS:
      return launch<MODE_LN_RESIDUAL, STEP_GRU, LN_ONE_PASS>(x, out, h0, h_last, w, ep, rows, N,
                                                            T, st);
    case E_LNBF16:
      return launch<MODE_LN_RESIDUAL, STEP_GRU, LN_BF16_STATS>(x, out, h0, h_last, w, ep, rows,
                                                              N, T, st);
    default: return cudaErrorInvalidValue;
  }
}

// x, out: [T, N, C], float32 or bfloat16 (plane_bf16); h0, h_last: [N, C]
// float32; wi, wh [C, 3C], bi, bh [3C], wfc [C, C], bfc, g, bln [C].
extern "C" int inter_ablation_launch(int spec, const void* x, void* out, const float* h0,
                                     float* h_last, const float* wi, const float* bi,
                                     const float* wh, const float* bh, const float* wfc,
                                     const float* bfc, const float* g, const float* bln,
                                     long long N, int T, int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(spec, static_cast<const bf16*>(x), static_cast<bf16*>(out), h0, h_last, wi,
                    bi, wh, bh, wfc, bfc, g, bln, N, T, st);
  return (int)run(spec, static_cast<const float*>(x), static_cast<float*>(out), h0, h_last, wi,
                  bi, wh, bh, wfc, bfc, g, bln, N, T, st);
}
