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
// change.
#include <cooperative_groups.h>

#include "gru64_warp.cuh"

namespace cg = cooperative_groups;
using namespace dpdf;

namespace {

constexpr int MAX_WARPS = 8;
constexpr int TS = 4;        // steps per pass over Wi

// Block: ``blockDim.x / 32`` warps, of which the first ``walk_warps`` walk
// R rows each (a tile of walk_warps * R rows); every warp stages the
// weights and takes part in the epilogue.  part: [2][N][Fq][C], the fc
// partials of each direction.
template <int R, typename TX>
__global__ void __launch_bounds__(MAX_WARPS * ww::LANES, 1)
dprnn_intra_kernel(const TX* __restrict__ x, TX* __restrict__ out, float* __restrict__ part,
                   const float* __restrict__ wi2, const float* __restrict__ wh2,
                   const float* __restrict__ b2, const float* __restrict__ wfc,
                   const float* __restrict__ bfc, const float* __restrict__ g,
                   const float* __restrict__ bln, Rows rows, RowMap omap, int64_t N, int Fq,
                   int walk_warps, int tiles) {
  cg::cluster_group cluster = cg::this_cluster();
  const int d = (int)cluster.block_rank();        // 0 forward, 1 backward
  const int warp = threadIdx.x / ww::LANES, lane = threadIdx.x % ww::LANES;
  const int warps = blockDim.x / ww::LANES;
  const int rows_cta = walk_warps * R;
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem + ww::W_FLOATS + warp * ww::warp_floats(R, TS);
  const GruWeights w{wi2, wh2, b2, b2 + 6 * C, 6 * C, d * C, 2 * C, d * C};
  ww::stage_weights(smem, w, wfc + d * C * C);
  const ww::LaneParams p = ww::lane_params(w, bfc, g, bln, lane);
  __syncthreads();
  const int half = (Fq + 1) / 2;
  const int f_lo = d == 0 ? 0 : half, nf = d == 0 ? half : Fq - half;
  const int64_t part_row = (int64_t)Fq * C;
  const int items = rows_cta * nf;

  for (int tile = blockIdx.x / 2; tile < tiles; tile += gridDim.x / 2) {
    const int64_t base = (int64_t)tile * rows_cta;
    const int64_t row0 = base + warp * R;
    if (warp < walk_warps && row0 < N)
      ww::walk<R, TS, ww::OUT_FC_PART>(smem, wbuf, x, rows, rows, rows, row0, N, Fq, d == 1, p,
                                       static_cast<float*>(nullptr),
                                       part + ((int64_t)d * N + row0) * part_row, (int)part_row,
                                       nullptr, nullptr, lane);
    cluster.sync();                               // both directions' partials are stored
    // this CTA's half of the positions, two (row, position) items per warp
    // at a time so the loads of the second overlap the first's LayerNorm;
    // the partials are read past L1, where the peer's writes are not
    for (int i0 = warp; i0 < items; i0 += 2 * warps) {
      float y[2][2], xv[2][2];
      int64_t xo[2];
      bool st[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int it = i0 + e * warps < items ? i0 + e * warps : i0;
        const int f = f_lo + it % nf;
        const int64_t n0 = base + it / nf, n = n0 < N ? n0 : N - 1;
        st[e] = it == i0 + e * warps && n0 < N;
        const float* pf = part + n * part_row + f * C + lane;
        const float* pb = pf + N * part_row;
        xo[e] = rows.off(n, f);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          y[e][q] = __ldcg(pf + ww::LANES * q) + __ldcg(pb + ww::LANES * q);
          xv[e][q] = load_f(x + xo[e] + lane + ww::LANES * q);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ww::ln_store(y[e][0], y[e][1], xv[e][0], xv[e][1], p, out + omap.off(xo[e] / C), lane,
                     st[e]);
    }
  }
}

template <int R, typename TX>
cudaError_t launch(const TX* x, TX* out, float* part, const float* wi2, const float* wh2,
                   const float* b2, const float* wfc, const float* bfc, const float* g,
                   const float* bln, Rows rows, RowMap omap, int64_t N, int Fq, int walk_warps,
                   int warps, int clusters, cudaStream_t st) {
  const int64_t rows_cta = (int64_t)walk_warps * R;
  const size_t smem =
      sizeof(float) * (ww::W_FLOATS + (size_t)walk_warps * ww::warp_floats(R, TS));
  cudaError_t err = cudaFuncSetAttribute(dprnn_intra_kernel<R, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (int)((N + rows_cta - 1) / rows_cta);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(2 * clusters));
  cfg.blockDim = dim3((unsigned)(warps * ww::LANES));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dprnn_intra_kernel<R, TX>, x, out, part, wi2, wh2, b2, wfc, bfc,
                           g, bln, rows, omap, N, Fq, walk_warps, tiles);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX>
cudaError_t run(const TX* x, TX* out, float* part, const float* wi2, const float* wh2,
                const float* b2, const float* wfc, const float* bfc, const float* g,
                const float* bln, int64_t N, int Fq, int64_t fm_b, int rows_per_warp,
                int walk_warps, int warps, int clusters, cudaStream_t st) {
  if (walk_warps < 1 || warps < walk_warps || warps > MAX_WARPS || clusters < 1 || N < 1 ||
      Fq < 1)
    return cudaErrorInvalidConfiguration;
  // row n, step f: x[n, f] (row-major) or x[f, n] (freq-leading)
  const Rows rows = fm_b ? Rows{N, 0, C, N * C} : Rows{N, 0, (int64_t)Fq * C, C};
  // flat row f * N + t * B + b of the freq-leading plane -> out[t, f, b]
  const RowMap omap = fm_b ? RowMap{N, fm_b, fm_b * C, Fq * fm_b * C, C} : dense_map(N * Fq);
#define DPDF_LAUNCH(R)                                                                       \
  launch<R>(x, out, part, wi2, wh2, b2, wfc, bfc, g, bln, rows, omap, N, Fq, walk_warps, warps, \
            clusters, st)
  switch (rows_per_warp) {
    case 1: return DPDF_LAUNCH(1);
    case 2: return DPDF_LAUNCH(2);
    default: return cudaErrorInvalidValue;
  }
#undef DPDF_LAUNCH
}

}  // namespace

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
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(out), part, wi2, wh2, b2,
                    wfc, bfc, g, bln, N, Fq, fm_batch, rows_per_warp, walk_warps, warps,
                    clusters, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), part, wi2, wh2, b2,
                  wfc, bfc, g, bln, N, Fq, fm_batch, rows_per_warp, walk_warps, warps,
                  clusters, st);
}
