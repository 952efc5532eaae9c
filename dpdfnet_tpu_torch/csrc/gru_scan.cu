// GRU scan on Hopper: ys, h_last = GRU over x [N, T, I] from h0 [N, H],
// forward or reverse in time (gate packing (r, z, n), torch's
// linear-before-reset n gate).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py gru_scan_tm, kernel _kernel (TPU).
//
// What bounds it on the H100: on the main path N = B rows (8 .. 64) and
// H = I = 256, so Wh is 256 x 768 = 768 KB in f32, more than one SM holds.
// Useful work is 6 H (I + H) FLOPs per row-step; the roofline bound is
// arithmetic, but a step cannot start before the previous hidden exists,
// and with N = B rows there are only a few rows to spread over 132 SMs.
// A block that walks its rows alone must stream all of Wh from L2 every
// step (768 KB per step per block), which bounded the earlier design.
//
// Design:
//  1. proj_gemm_kernel (proj_gemm.cuh): the input projection
//     xp = x . Wi + bi for all T at once, a tiled shared-memory SGEMM over
//     the N*T rows (no recurrence, fully parallel) into a scratch
//     [N, T, 3H].
//  2. gru_recur_cluster_kernel: a thread-block cluster of S = H / 32 CTAs
//     walks R rows (R = 1, 2, 4 or 8).  CTA c owns the 32 hidden units
//     32c .. 32c + 31 and holds their three gate columns of Wh (H x 96,
//     96 KB at H = 256) for the whole walk, spread over its registers:
//     warp w, lane l keeps Wh[32w .. 32w + 31][r, z, n of unit 32c + l],
//     96 floats.  All of Wh is read once per launch.  Per step:
//       a. every warp dots its 32-row k-slice of the full h (each CTA's own
//          copy, float4 broadcasts from shared memory) for the R rows;
//       b. one block barrier; warp w sums the S slice partials of rows
//          w, w + S, ... in slice order and runs the gates of its units;
//       c. each new hidden value is stored into every CTA's double-buffered
//          h through distributed shared memory (map_shared_rank);
//       d. one cluster barrier (arrive.release / wait.acquire) closes the
//          step; the next step's xp loads are issued between the arrive and
//          the wait.
//     The plan (R, the number of clusters) is gru_kernels.gru_scan_plan;
//     rows are split across clusters so the grid fills the card.  A row's
//     dot runs k-slice by k-slice, each slice k-ascending, the slices
//     summed in order, whatever R, N, T or the plan: a row's result does
//     not depend on the batch.  H is a multiple of 32 up to 256 (S <= 8,
//     the portable cluster size); I is any size.
// x and ys are float32 or bfloat16 (loads upcast, stores round once); the
// projection scratch, h0 / h_last, the weights and all arithmetic are
// float32.
#include <cooperative_groups.h>

#include "proj_gemm.cuh"

namespace cg = cooperative_groups;
using namespace dpdf;

namespace {

constexpr int KW = 32;          // k-slice per warp == hidden units per CTA
constexpr int MAX_H = 256;      // S = H / KW <= 8

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

size_t recur_smem(int R, int H) {
  // h [2][R][H], partials [S][R][3][KW]
  return sizeof(float) * (2 * (size_t)R * H + (size_t)(H / KW) * R * 3 * KW);
}

// xp: [N, T, 3H] (bias bi included); ys: [N, T, H]; h0, h_last: [N, H].
template <int R, typename TX>
__global__ void __launch_bounds__(MAX_H, 1)
gru_recur_cluster_kernel(const float* __restrict__ xp, const float* __restrict__ h0,
                         const float* __restrict__ wh, const float* __restrict__ bh,
                         TX* __restrict__ ys, float* __restrict__ h_last, int N, int T, int H,
                         int reverse) {
  cg::cluster_group cluster = cg::this_cluster();
  const int S = H / KW;
  const int c = (int)cluster.block_rank();
  const int q = blockIdx.x / S;                   // cluster index: rows q*R .. q*R + R-1
  const int warp = threadIdx.x / KW, lane = threadIdx.x % KW;
  const int H3 = 3 * H;
  const int j = c * KW + lane;                    // this lane's hidden unit
  const int kb = warp * KW;                       // this warp's k-slice
  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;                             // [2][R][H]
  float* part = smem + 2 * R * H;                 // [S][R][3][KW]

  float w[KW][3];
#pragma unroll
  for (int kk = 0; kk < KW; ++kk) {
    const float* row = wh + (int64_t)(kb + kk) * H3 + j;
    w[kk][0] = row[0];
    w[kk][1] = row[H];
    w[kk][2] = row[2 * H];
  }
  for (int i = threadIdx.x; i < R * H; i += blockDim.x) {
    const int n = q * R + i / H;
    hbuf[i] = n < N ? h0[(int64_t)n * H + i % H] : 0.0f;
  }
  const float bhr = bh[j], bhz = bh[H + j], bhn = bh[2 * H + j];

  // gate rows of this warp: r = warp + i * S (< R); their xp for the step
  float xr[R], xz[R], xn[R], hl[R];
  auto load_xp = [&](int t) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp + i * S;
      if (r < R) {
        const int n = min(q * R + r, N - 1);
        const float* p = xp + ((int64_t)n * T + t) * H3 + j;
        xr[i] = p[0];
        xz[i] = p[H];
        xn[i] = p[2 * H];
      }
    }
  };
  load_xp(reverse ? T - 1 : 0);
  cluster.sync();          // every CTA runs, and each holds the full h0 of its rows

  for (int s = 0; s < T; ++s) {
    const int t = reverse ? T - 1 - s : s;
    const float* hc = hbuf + (s & 1) * R * H;
    float* hn_next = hbuf + ((s + 1) & 1) * R * H;
    // a. this warp's k-slice of h . Wh for every row
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KW; kk += 4) {
        const float4 hv = *reinterpret_cast<const float4*>(hc + r * H + kb + kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float hs = (&hv.x)[e];
          a0 = fmaf(hs, w[kk + e][0], a0);
          a1 = fmaf(hs, w[kk + e][1], a1);
          a2 = fmaf(hs, w[kk + e][2], a2);
        }
      }
      float* pp = part + ((warp * R + r) * 3) * KW + lane;
      pp[0] = a0;
      pp[KW] = a1;
      pp[2 * KW] = a2;
    }
    __syncthreads();
    // b, c. the slices summed in order, the gates, h_new to every CTA
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = warp + i * S;
      if (r < R) {
        float sr = 0.0f, sz = 0.0f, sn = 0.0f;
        for (int ks = 0; ks < S; ++ks) {
          const float* pp = part + ((ks * R + r) * 3) * KW + lane;
          sr += pp[0];
          sz += pp[KW];
          sn += pp[2 * KW];
        }
        const float rg = sigmoid_f(xr[i] + (sr + bhr));
        const float zg = sigmoid_f(xz[i] + (sz + bhz));
        const float ng = tanhf(fmaf(rg, sn + bhn, xn[i]));
        const float hnew = fmaf(zg, hc[r * H + j], (1.0f - zg) * ng);
        for (int d = 0; d < S; ++d) cluster.map_shared_rank(hn_next, d)[r * H + j] = hnew;
        const int n = q * R + r;
        if (n < N) store_f(ys + ((int64_t)n * T + t) * H + j, hnew);
        hl[i] = hnew;
      }
    }
    // d. close the step; the next xp is fetched while the cluster arrives
    cluster_arrive();
    if (s + 1 < T) load_xp(reverse ? T - 2 - s : s + 1);
    cluster_wait();
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = warp + i * S;
    const int n = q * R + r;
    if (r < R && n < N) h_last[(int64_t)n * H + j] = hl[i];
  }
}

template <int R, typename TX>
cudaError_t launch_recur(const float* xp, const float* h0, const float* wh, const float* bh,
                         TX* ys, float* h_last, int N, int T, int H, int reverse,
                         int clusters, cudaStream_t st) {
  const int S = H / KW;
  const size_t smem = recur_smem(R, H);
  cudaError_t err = cudaFuncSetAttribute(gru_recur_cluster_kernel<R, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * S));
  cfg.blockDim = dim3((unsigned)H);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, gru_recur_cluster_kernel<R, TX>, xp, h0, wh, bh, ys, h_last, N,
                           T, H, reverse);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_h(int H) { return H % KW == 0 && H >= KW && H <= MAX_H; }

template <typename TX>
cudaError_t run(const TX* x, const float* h0, const float* wi, const float* bi,
                const float* wh, const float* bh, float* xp, TX* ys, float* h_last, int N,
                int T, int I, int H, int reverse, int rows_per_cluster, int clusters,
                cudaStream_t st) {
  if (!valid_h(H) || N < 1 || T < 1 || clusters < 1 ||
      (int64_t)clusters * rows_per_cluster < N)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = launch_proj_gemm(x, wi, bi, xp, (int64_t)N * T, I, 3 * H, st);
  if (err != cudaSuccess) return err;
#define DPDF_RECUR(R) \
  launch_recur<R>(xp, h0, wh, bh, ys, h_last, N, T, H, reverse, clusters, st)
  switch (rows_per_cluster) {
    case 1: return DPDF_RECUR(1);
    case 2: return DPDF_RECUR(2);
    case 4: return DPDF_RECUR(4);
    case 8: return DPDF_RECUR(8);
    default: return cudaErrorInvalidValue;
  }
#undef DPDF_RECUR
}

}  // namespace

// x: [N, T, I]; xp scratch: [N, T, 3H] f32; ys: [N, T, H]; h0, h_last:
// [N, H] f32.  x and ys are float32, or bfloat16 when plane_bf16.  The plan
// (rows per cluster 1 / 2 / 4 / 8, clusters) comes from
// gru_kernels.gru_scan_plan.
extern "C" int gru_scan_launch(const void* x, const float* h0, const float* wi,
                               const float* bi, const float* wh, const float* bh,
                               float* xp, void* ys, float* h_last, int N, int T, int I,
                               int H, int reverse, int rows_per_cluster, int clusters,
                               int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), h0, wi, bi, wh, bh, xp,
                    static_cast<bf16*>(ys), h_last, N, T, I, H, reverse, rows_per_cluster,
                    clusters, st);
  return (int)run(static_cast<const float*>(x), h0, wi, bi, wh, bh, xp,
                  static_cast<float*>(ys), h_last, N, T, I, H, reverse, rows_per_cluster,
                  clusters, st);
}

// How many clusters of the recurrence for hidden size H (with R = 8 rows,
// its largest shared-memory footprint) the device holds at once, into
// *out; the return value is the CUDA error code.
extern "C" int gru_scan_max_clusters(int H, int* out) {
  if (!valid_h(H)) return (int)cudaErrorInvalidValue;
  const int S = H / KW;
  const size_t smem = recur_smem(8, H);
  cudaError_t err = cudaFuncSetAttribute(gru_recur_cluster_kernel<8, float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)S);
  cfg.blockDim = dim3((unsigned)H);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(out, gru_recur_cluster_kernel<8, float>, &cfg);
}
