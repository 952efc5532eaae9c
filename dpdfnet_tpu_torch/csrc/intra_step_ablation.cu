// Timing ablation of the DPRNN intra step (the bidirectional C = 64 GRU
// walk along frequency): one kernel templated on the specialization, so no
// runtime branch sits in the timed step.  Driven by
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
// Design: every specialization is the original block-wide walk of
// gru64_block_walk.cuh (shared-memory weights, four row groups, block
// barriers, one direction per grid.y block; the production intra kernel
// now walks with gru64_warp.cuh) with a different step body
// (Step) and output (Mode):
//   I_FULL         the production intra stage: STEP_GRU, fc partials per
//                  step, then the production epilogue kernel;
//   I_HLAST        STEP_GRU with no per-step output; out = the forward
//                  direction's last hidden;
//   I_DOTS         STEP_RSUM (products, no gates), out = forward last h;
//   I_INDEP        STEP_RSUM_INDEP (Wh applied to x: no dependence on h);
//   I_GATES        STEP_GATES (gates with identity weights, no products);
//   I_FLOOR        STEP_SUM (h += x), out = the forward sum;
//   I_FLOOR_FB     STEP_SUM, out = forward sum + backward sum;
//   I_FLOOR_FB_BF16 STEP_SUM_BF16 (each sum rounded to bfloat16), out as
//                  I_FLOOR_FB.
// The backward direction always runs (its hidden lands in scratch where
// the output does not use it), so every specialization keeps the
// production's two-direction work shape.  x is read through strides in
// either the row-major [rows, T, C] layout or the freq-leading
// [T, rows, C] one (`tm`).
#include "gru64_block_walk.cuh"

using namespace dpdf;

enum IntraSpec {
  I_FULL = 0, I_HLAST = 1, I_DOTS = 2, I_INDEP = 3, I_GATES = 4,
  I_FLOOR = 5, I_FLOOR_FB = 6, I_FLOOR_FB_BF16 = 7,
};

constexpr int RPT = 4;   // 16 rows per block: the production choice at the tool's row counts

template <int MODE, int STEP, typename TX>
__global__ void __launch_bounds__(THREADS)
intra_ablation_walk(const TX* __restrict__ x, float* __restrict__ part,
                    float* __restrict__ hl, const float* __restrict__ wi2,
                    const float* __restrict__ wh2, const float* __restrict__ b2,
                    const float* __restrict__ wfc, Rows rows, int64_t N, int T) {
  const int d = blockIdx.y;                       // 0 forward, 1 backward
  GruWeights w{wi2, wh2, b2, b2 + 6 * C, 6 * C, d * C, 2 * C, d * C};
  Epilogue<float> ep{wfc == nullptr ? nullptr : wfc + d * C * C, nullptr, nullptr, nullptr,
                     part == nullptr ? nullptr : part + (int64_t)d * N * T * C, 0.0f};
  gru64_walk_io<RPT, MODE, TX, float, STEP>(x, rows, rows, dense_rows(N), N, T, d == 1, w, ep,
                                            nullptr,
                                            hl == nullptr ? nullptr : hl + (int64_t)d * N * C);
}

// out[n, c] = hl[0][n, c] (+ hl[1][n, c] with SUM2), rounded to out's dtype
template <typename TO, bool SUM2>
__global__ void __launch_bounds__(256)
intra_ablation_finish(const float* __restrict__ hl, TO* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = hl[i];
  if (SUM2) v = v + hl[n + i];
  store_f(out + i, v);
}

template <int MODE, int STEP, typename TX>
static cudaError_t walk(const TX* x, float* part, float* hl, const float* wi2, const float* wh2,
                        const float* b2, const float* wfc, Rows rows, int64_t N, int T,
                        cudaStream_t st) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * walk_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(intra_ablation_walk<MODE, STEP, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + R - 1) / R), 2);
  intra_ablation_walk<MODE, STEP, TX><<<grid, THREADS, smem, st>>>(x, part, hl, wi2, wh2, b2,
                                                                   wfc, rows, N, T);
  return cudaGetLastError();
}

template <typename TX, bool SUM2>
static cudaError_t finish(const float* hl, TX* out, int64_t N, cudaStream_t st) {
  const int64_t n = N * C;
  intra_ablation_finish<TX, SUM2><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(hl, out, n);
  return cudaGetLastError();
}

template <int STEP, bool SUM2, typename TX>
static cudaError_t reduced(const TX* x, TX* out, float* hl, const float* wi2, const float* wh2,
                           const float* b2, Rows rows, int64_t N, int T, cudaStream_t st) {
  cudaError_t err = walk<MODE_NONE, STEP>(x, nullptr, hl, wi2, wh2, b2, nullptr, rows, N, T, st);
  if (err != cudaSuccess) return err;
  return finish<TX, SUM2>(hl, out, N, st);
}

template <typename TX>
static cudaError_t run(int spec, const TX* x, TX* out, float* part, float* hl, const float* wi2,
                       const float* wh2, const float* b2, const float* wfc, const float* bfc,
                       const float* g, const float* bln, int64_t N, int T, int tm,
                       cudaStream_t st) {
  // row n, step t: x[n, t] (row-major) or x[t, n] (tm)
  const Rows rows = tm ? Rows{N, 0, C, N * C} : Rows{N, 0, (int64_t)T * C, C};
  switch (spec) {
    case I_FULL: {
      cudaError_t err = walk<MODE_FC_PART, STEP_GRU>(x, part, nullptr, wi2, wh2, b2, wfc, rows,
                                                     N, T, st);
      if (err != cudaSuccess) return err;
      return launch_intra_epilogue(x, part, bfc, g, bln, out, N * T, st);
    }
    case I_HLAST: return reduced<STEP_GRU, false>(x, out, hl, wi2, wh2, b2, rows, N, T, st);
    case I_DOTS: return reduced<STEP_RSUM, false>(x, out, hl, wi2, wh2, b2, rows, N, T, st);
    case I_INDEP:
      return reduced<STEP_RSUM_INDEP, false>(x, out, hl, wi2, wh2, b2, rows, N, T, st);
    case I_GATES: return reduced<STEP_GATES, false>(x, out, hl, wi2, wh2, b2, rows, N, T, st);
    case I_FLOOR: return reduced<STEP_SUM, false>(x, out, hl, wi2, wh2, b2, rows, N, T, st);
    case I_FLOOR_FB: return reduced<STEP_SUM, true>(x, out, hl, wi2, wh2, b2, rows, N, T, st);
    case I_FLOOR_FB_BF16:
      return reduced<STEP_SUM_BF16, true>(x, out, hl, wi2, wh2, b2, rows, N, T, st);
    default: return cudaErrorInvalidValue;
  }
}

// x: [N, T, C] (tm == 0) or [T, N, C] (tm == 1), float32 or bfloat16
// (plane_bf16); out: x's shape for I_FULL, else [N, C], at x's dtype.
// Packed direction-blockdiag wi2 / wh2 [2C, 6C], b2 [2, 6C]; wfc [2C, C];
// bfc, g, bln [C].  Scratch: part f32 [2, N, T, C] (I_FULL), hl f32
// [2, N, C] (the others).
extern "C" int intra_ablation_launch(int spec, const void* x, void* out, float* part, float* hl,
                                     const float* wi2, const float* wh2, const float* b2,
                                     const float* wfc, const float* bfc, const float* g,
                                     const float* bln, long long N, int T, int tm,
                                     int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(spec, static_cast<const bf16*>(x), static_cast<bf16*>(out), part, hl, wi2,
                    wh2, b2, wfc, bfc, g, bln, N, T, tm, st);
  return (int)run(spec, static_cast<const float*>(x), static_cast<float*>(out), part, hl, wi2,
                  wh2, b2, wfc, bfc, g, bln, N, T, tm, st);
}
