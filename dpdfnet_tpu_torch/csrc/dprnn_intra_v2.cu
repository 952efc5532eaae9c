// DPRNN intra stage, v2, on Hopper: x + LN(fc([ys_fw, ys_bw])) with a
// bidirectional GRU along frequency from a zero state over every row of
// x [N, L, C], its input projections hoisted out of the walk.
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
// dependent steps per direction.
//
// Design, three launches:
//  1. proj_gemm_kernel (proj_gemm.cuh): xp = x . wi_cat + b2[0] for every
//     position of every row, a parallel tiled SGEMM, stored bfloat16
//     (xp_bf16, the TPU kernel's default) or float32.  xp stays in device
//     memory, not shared memory: one direction's xp of a 16-row block is
//     L * 16 * 3C values (295 KB in bf16 at L = 48), above a block's 227
//     KB, and 8-row blocks would halve the rows that share each weight
//     load.  Written just before the walk, it is read back from L2 (33 MB
//     bf16 at the flagship's 896 x 48 rows, inside the 50 MB L2).
//  2. the walk (gru64_v2.cuh), directions split over grid.y as in
//     dprnn_intra.cu: each direction's block holds only its own useful
//     [Wh_d | Wfc_d] (64 KB f32 of the 256 KB wh_big, whose off-diagonal
//     blocks are zero) and runs one product h . [Wh_d | Wfc_d] per step,
//     which gives the next step's gates and this position's fc partial,
//     written to a f32 scratch part[d].
//  3. the epilogue of gru64_walk.cuh: part[0] + part[1] + bfc, LayerNorm,
//     residual; it needs both directions, so it runs after both walks.
// The TPU kernel's clamped partial slots (it applies each step's product
// to the previous hidden) are its pipelining detail; here the product of
// h_new is stored at h_new's own position.
#include "gru64_v2.cuh"
#include "proj_gemm.cuh"

using namespace dpdf;

template <int RPT, typename TP>
__global__ void __launch_bounds__(THREADS)
dprnn_intra_v2_walk_kernel(const TP* __restrict__ xp, float* __restrict__ part,
                           const float* __restrict__ wh_big, const float* __restrict__ b2,
                           Rows rows, int64_t N, int L) {
  const int d = blockIdx.y;                       // 0 forward, 1 backward
  FusedWeights w{wh_big, b2 + 6 * C, 8 * C, d * C, 2 * C, d * C, 6 * C + d * C};
  XpRows xr{Rows{N, 0, (int64_t)L * 6 * C, 6 * C}, 2 * C, d * C};
  Epilogue<float> ep{nullptr, nullptr, nullptr, nullptr, part + (int64_t)d * N * L * C, 0.0f};
  gru64_v2_walk<RPT>(xp, xr, rows, N, L, d == 1, w, ep, nullptr, nullptr);
}

template <int RPT, typename TP>
static cudaError_t launch_walk(const TP* xp, float* part, const float* wh_big, const float* b2,
                               Rows rows, int64_t N, int L, cudaStream_t stream) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * v2_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(dprnn_intra_v2_walk_kernel<RPT, TP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((N + R - 1) / R), 2);
  dprnn_intra_v2_walk_kernel<RPT, TP><<<grid, THREADS, smem, stream>>>(xp, part, wh_big, b2,
                                                                       rows, N, L);
  return cudaGetLastError();
}

template <typename TX, typename TP>
static cudaError_t run(const TX* x, TX* out, TP* xp, float* part, const float* wi_cat,
                       const float* wh_big, const float* b2, const float* bfc, const float* g,
                       const float* bln, int64_t N, int L, int rows_per_block,
                       cudaStream_t st) {
  cudaError_t err = launch_proj_gemm(x, wi_cat, b2, xp, N * L, C, 6 * C, st);
  if (err != cudaSuccess) return err;
  Rows rows{N, 0, (int64_t)L * C, C};
  err = rows_per_block == 16 ? launch_walk<4>(xp, part, wh_big, b2, rows, N, L, st)
                             : launch_walk<2>(xp, part, wh_big, b2, rows, N, L, st);
  if (err != cudaSuccess) return err;
  return launch_intra_epilogue(x, part, bfc, g, bln, out, N * L, st);
}

// x, out: [N, L, C], float32, or bfloat16 when plane_bf16; xp: scratch
// [N, L, 6C], bfloat16 when xp_bf16, else float32; part: f32 scratch
// [2, N, L, C]; weights f32.
extern "C" int dprnn_intra_v2_launch(const void* x, void* out, void* xp, float* part,
                                     const float* wi_cat, const float* wh_big, const float* b2,
                                     const float* bfc, const float* g, const float* bln,
                                     long long N, int L, int rows_per_block, int xp_bf16,
                                     int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DPDF_RUN(TX, TP)                                                                      \
  return (int)run(static_cast<const TX*>(x), static_cast<TX*>(out), static_cast<TP*>(xp), part, \
                  wi_cat, wh_big, b2, bfc, g, bln, N, L, rows_per_block, st)
  if (plane_bf16 && xp_bf16) DPDF_RUN(bf16, bf16);
  if (plane_bf16) DPDF_RUN(bf16, float);
  if (xp_bf16) DPDF_RUN(float, bf16);
  DPDF_RUN(float, float);
#undef DPDF_RUN
}
