// The DPRNN intra kernel of dprnn_intra.cu (its design is described there)
// as templates: the step body (STEP), what a CTA stores after each tile
// (FIN) and where it reads its weights (LAYOUT) are compile-time hooks
// whose defaults are the production stage, so intra_step_ablation.cu's
// specializations are instances of this kernel and its `full` is the
// production instantiation with the production plan, and dprnn_intra_v2.cu
// is this kernel on pack_intra_v2's weights.
#pragma once

#include <cooperative_groups.h>

#include "gru64_warp.cuh"

namespace dpdf {
namespace intra {

namespace cg = cooperative_groups;

constexpr int MAX_WARPS = 8;
constexpr int TS = 4;        // steps per pass over Wi

// What a CTA stores after each tile's walk.
enum Finish {
  FIN_STAGE = 0,   // the stage: fc partials per step, then x + LN(fc) (production)
  FIN_FW = 1,      // the forward direction's last hidden, out [N, C] (step ablations)
  FIN_SUM = 2,     // the sum of both directions' last hiddens, out [N, C] (step ablations)
};

// Where direction d reads its weights (floats; gate-major columns
// [r_f r_b z_f z_b n_f n_b], gate stride 2C): Wi element (k, gate, u) at
// wi[(d * wi_drow + k) * wi_ld + gate * 2C + d * C + u], Wh element at
// wh[(d * C + k) * wh_ld + gate * 2C + d * C + u], fc element (k, j) at
// wfc[fc_off + d * fc_doff + k * fc_ld + j].  Every offset is a multiple
// of 4.
struct PackLayout {
  int wi_drow, wi_ld, wh_ld, fc_off, fc_doff, fc_ld;
};

// The packed v1 set: wi2 / wh2 [2C, 6C] direction-blockdiag, wfc [2C, C].
__host__ __device__ constexpr PackLayout packed_layout() {
  return PackLayout{C, 6 * C, 6 * C, 0, C * C, C};
}

enum Layout {
  W_PACKED = 0,   // packed_layout(), folded at compile time (production)
  W_GIVEN = 1,    // the kernel's ``lay`` argument (intra v2: gru_kernels.intra_v2_layout)
};

// Block: ``blockDim.x / 32`` warps, of which the first ``walk_warps`` walk
// R rows each (a tile of walk_warps * R rows); every warp stages the
// weights and takes part in the epilogue.  part: [2][N][Fq][C], the fc
// partials of each direction (FIN_STAGE), or [2][N][C], each direction's
// last hidden (the other finishes, whose walk is OUT_NONE: no per-step
// store, the product h . Wh alone, Wh staged in Wi's layout).
template <int R, typename TX, typename STEP = ww::StepGru, int FIN = FIN_STAGE,
          int LAYOUT = W_PACKED>
__global__ void __launch_bounds__(MAX_WARPS * ww::LANES, 1)
dprnn_intra_kernel(const TX* __restrict__ x, TX* __restrict__ out, float* __restrict__ part,
                   const float* __restrict__ wi2, const float* __restrict__ wh2,
                   const float* __restrict__ b2, const float* __restrict__ wfc,
                   const float* __restrict__ bfc, const float* __restrict__ g,
                   const float* __restrict__ bln, Rows rows, RowMap omap, int64_t N, int Fq,
                   int walk_warps, int tiles, PackLayout lay) {
  static_assert(LAYOUT == W_PACKED || FIN == FIN_STAGE, "a given layout stages the fc");
  cg::cluster_group cluster = cg::this_cluster();
  const int d = (int)cluster.block_rank();        // 0 forward, 1 backward
  const int warp = threadIdx.x / ww::LANES, lane = threadIdx.x % ww::LANES;
  const int warps = blockDim.x / ww::LANES;
  const int rows_cta = walk_warps * R;
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem + ww::W_FLOATS + warp * ww::warp_floats(R, TS);
  const PackLayout L = LAYOUT == W_PACKED ? packed_layout() : lay;
  const GruWeights w{wi2, wh2, b2, b2 + 6 * C, L.wh_ld, d * C, 2 * C, d * C};
  if constexpr (FIN == FIN_STAGE)
    ww::stage_weights(smem, w, wfc + L.fc_off + d * L.fc_doff, d * L.wi_drow, L.wi_ld,
                      L.fc_ld);
  else
    ww::stage_weights_ys(smem, w);
  const ww::LaneParams p = ww::lane_params(w, bfc, g, bln, lane);
  __syncthreads();
  const int half = (Fq + 1) / 2;
  const int f_lo = d == 0 ? 0 : half, nf = d == 0 ? half : Fq - half;
  const int64_t part_row = (int64_t)Fq * C;
  const int items = rows_cta * nf;

  for (int tile = blockIdx.x / 2; tile < tiles; tile += gridDim.x / 2) {
    const int64_t base = (int64_t)tile * rows_cta;
    const int64_t row0 = base + warp * R;
    if (warp < walk_warps && row0 < N) {
      if constexpr (FIN == FIN_STAGE)
        ww::walk<R, TS, ww::OUT_FC_PART, TX, float, STEP>(
            smem, wbuf, x, rows, rows, rows, row0, N, Fq, d == 1, p,
            static_cast<float*>(nullptr), part + ((int64_t)d * N + row0) * part_row,
            (int)part_row, nullptr, nullptr, lane);
      else
        ww::walk<R, TS, ww::OUT_NONE, TX, float, STEP>(
            smem, wbuf, x, rows, rows, dense_rows(N), row0, N, Fq, d == 1, p,
            static_cast<float*>(nullptr), nullptr, 0, nullptr, part + (int64_t)d * N * C, lane);
    }
    cluster.sync();                               // both directions' results are stored
    if constexpr (FIN == FIN_STAGE) {
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
    } else {
      // this CTA's half of the tile's rows, a warp per row; read past L1
      const int mid = (rows_cta + 1) / 2;
      for (int i = (d == 0 ? 0 : mid) + warp; i < (d == 0 ? mid : rows_cta); i += warps) {
        const int64_t n = base + i;
        if (n >= N) break;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int64_t o = n * C + lane + ww::LANES * q;
          float v = __ldcg(part + o);
          if constexpr (FIN == FIN_SUM) v = v + __ldcg(part + N * C + o);
          store_f(out + o, v);
        }
      }
    }
  }
}

template <int R, typename TX, typename STEP, int FIN, int LAYOUT>
cudaError_t launch(const TX* x, TX* out, float* part, const float* wi2, const float* wh2,
                   const float* b2, const float* wfc, const float* bfc, const float* g,
                   const float* bln, Rows rows, RowMap omap, int64_t N, int Fq, int walk_warps,
                   int warps, int clusters, PackLayout lay, cudaStream_t st) {
  const int64_t rows_cta = (int64_t)walk_warps * R;
  const size_t smem =
      sizeof(float) * (ww::W_FLOATS + (size_t)walk_warps * ww::warp_floats(R, TS));
  cudaError_t err = cudaFuncSetAttribute(dprnn_intra_kernel<R, TX, STEP, FIN, LAYOUT>,
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
  err = cudaLaunchKernelEx(&cfg, dprnn_intra_kernel<R, TX, STEP, FIN, LAYOUT>, x, out, part,
                           wi2, wh2, b2, wfc, bfc, g, bln, rows, omap, N, Fq, walk_warps, tiles,
                           lay);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// fm_b == 0: x, out [N, Fq, C]; fm_b == B: x [Fq, N, C] (t-major rows
// n = t * B + b), out [T, Fq, B, C] (FIN_STAGE; the other finishes store
// out [N, C] in either layout).  The plan comes from gru_kernels.intra_plan.
// ``lay``: where the weights lie (read with LAYOUT == W_GIVEN only).
template <typename STEP = ww::StepGru, int FIN = FIN_STAGE, int LAYOUT = W_PACKED, typename TX>
cudaError_t run(const TX* x, TX* out, float* part, const float* wi2, const float* wh2,
                const float* b2, const float* wfc, const float* bfc, const float* g,
                const float* bln, int64_t N, int Fq, int64_t fm_b, int rows_per_warp,
                int walk_warps, int warps, int clusters, cudaStream_t st,
                PackLayout lay = packed_layout()) {
  if (walk_warps < 1 || warps < walk_warps || warps > MAX_WARPS || clusters < 1 || N < 1 ||
      Fq < 1)
    return cudaErrorInvalidConfiguration;
  // row n, step f: x[n, f] (row-major) or x[f, n] (freq-leading)
  const Rows rows = fm_b ? Rows{N, 0, C, N * C} : Rows{N, 0, (int64_t)Fq * C, C};
  // flat row f * N + t * B + b of the freq-leading plane -> out[t, f, b]
  const RowMap omap = fm_b ? RowMap{N, fm_b, fm_b * C, Fq * fm_b * C, C} : dense_map(N * Fq);
#define DPDF_LAUNCH(R)                                                                       \
  launch<R, TX, STEP, FIN, LAYOUT>(x, out, part, wi2, wh2, b2, wfc, bfc, g, bln, rows, omap, \
                                   N, Fq, walk_warps, warps, clusters, lay, st)
  switch (rows_per_warp) {
    case 1: return DPDF_LAUNCH(1);
    case 2: return DPDF_LAUNCH(2);
    default: return cudaErrorInvalidValue;
  }
#undef DPDF_LAUNCH
}

}  // namespace intra
}  // namespace dpdf
