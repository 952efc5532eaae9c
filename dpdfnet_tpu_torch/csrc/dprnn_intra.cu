// DPRNN intra stage on Hopper: a bidirectional GRU along frequency from a
// zero state over every (b, t) row, then x + LN(fc_[2C->C]([ys_fw, ys_bw])).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_intra_block and
// dprnn_intra_block_tm, kernels _intra_block_kernel /
// _intra_block_kernel_tm (TPU).
//
// What bounds it on the H100: each row walks Fq = 40 / 48 dependent steps
// per direction; the useful work is 28 C^2 FLOPs per row-step (gates of
// both directions and the fc) against 2 C * 4 bytes of plane traffic, so
// its roofline bound is arithmetic, and the walk's latency chain is what
// the kernel actually pays.
//
// Design.  Both directions' useful GRU weights take 192 KB in f32 and the
// ys history of one row 24 KB at Fq = 48, so a block cannot hold both at a
// useful row tile.  The two directions therefore run in separate blocks
// (grid.y = direction), each with its own 96 KB of Wi/Wh plus its half of
// Wfc (16 KB) in shared memory.  A block never keeps ys: at every step it
// multiplies its new hidden by its half of Wfc and writes that partial fc
// row to a scratch plane part[d] (no shared history, no cross-block sync).
// A second, fully parallel kernel then sums the two partial rows, adds the
// bias, applies LayerNorm and the residual.  The kernel reads the packed,
// direction-blockdiag weights (wi2 / wh2 [2C, 6C], b2 [2, 6C]) and skips
// their zero cross-direction blocks: half the packed FLOPs.  The plane x /
// out is float32 or bfloat16 (loads upcast, the store rounds once); the
// weights, the partials and all arithmetic are float32.
//
// Layouts (replacing the TPU kernel's fm_batch mode, which the freq-major
// DPRNN chain runs): row-major x, out [N, Fq, C]; or, with fm_batch = B,
// the freq-leading x [Fq, N, C] (rows t-major, n = t * B + b) and out
// [T, Fq, B, C], the layout the fm inter stage reads.  Both are stride sets
// of the same walk (the partials keep x's layout) and a row map of the
// epilogue's store; the arithmetic does not change.
#include "gru64_walk.cuh"

using namespace dpdf;

template <int RPT, typename TX>
__global__ void __launch_bounds__(THREADS)
dprnn_intra_walk_kernel(const TX* __restrict__ x, float* __restrict__ part,
                        const float* __restrict__ wi2, const float* __restrict__ wh2,
                        const float* __restrict__ b2, const float* __restrict__ wfc,
                        Rows rows, int64_t N, int Fq) {
  const int d = blockIdx.y;                       // 0 forward, 1 backward
  GruWeights w{wi2, wh2, b2, b2 + 6 * C, 6 * C, d * C, 2 * C, d * C};
  Epilogue<float> ep{wfc + d * C * C, nullptr, nullptr, nullptr,
                     part + (int64_t)d * N * Fq * C, 0.0f};
  gru64_walk<RPT, MODE_FC_PART>(x, rows, N, Fq, d == 1, w, ep, nullptr, nullptr);
}

template <int RPT, typename TX>
static cudaError_t launch_walk(const TX* x, float* part, const float* wi2,
                               const float* wh2, const float* b2, const float* wfc,
                               Rows rows, int64_t N, int Fq, cudaStream_t stream) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * walk_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(dprnn_intra_walk_kernel<RPT, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + R - 1) / R), 2);
  dprnn_intra_walk_kernel<RPT, TX><<<grid, THREADS, smem, stream>>>(x, part, wi2, wh2, b2,
                                                                    wfc, rows, N, Fq);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t run(const TX* x, TX* out, float* part, const float* wi2, const float* wh2,
                       const float* b2, const float* wfc, const float* bfc, const float* g,
                       const float* bln, int64_t N, int Fq, int rows_per_block, int64_t fm_b,
                       cudaStream_t st) {
  // row n, step f: x[n, f] (row-major) or x[f, n] (freq-leading)
  const Rows rows = fm_b ? Rows{N, 0, C, N * C} : Rows{N, 0, (int64_t)Fq * C, C};
  // flat row f * N + t * B + b of the freq-leading plane -> out[t, f, b]
  const RowMap omap = fm_b ? RowMap{N, fm_b, fm_b * C, Fq * fm_b * C, C} : dense_map(N * Fq);
  cudaError_t err = rows_per_block == 16
                        ? launch_walk<4>(x, part, wi2, wh2, b2, wfc, rows, N, Fq, st)
                        : launch_walk<2>(x, part, wi2, wh2, b2, wfc, rows, N, Fq, st);
  if (err != cudaSuccess) return err;
  return launch_intra_epilogue(x, part, bfc, g, bln, out, N * Fq, omap, st);
}

// fm_batch == 0: x, out [N, Fq, C] contiguous (N = B * T rows of the
// [B, T, Fq, C] plane).  fm_batch == B > 0: x [Fq, N, C] with N = T * B
// t-major rows, out [T, Fq, B, C].  Planes float32, or bfloat16 when
// plane_bf16; part: f32 scratch of 2 * N * Fq * C.
extern "C" int dprnn_intra_launch(const void* x, void* out, float* part,
                                  const float* wi2, const float* wh2, const float* b2,
                                  const float* wfc, const float* bfc, const float* g,
                                  const float* bln, long long N, int Fq,
                                  int rows_per_block, int plane_bf16, long long fm_batch,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(out), part, wi2, wh2, b2,
                    wfc, bfc, g, bln, N, Fq, rows_per_block, fm_batch, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), part, wi2, wh2, b2,
                  wfc, bfc, g, bln, N, Fq, rows_per_block, fm_batch, st);
}
