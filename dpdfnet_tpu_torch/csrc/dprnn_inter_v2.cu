// DPRNN inter stage, v2, on Hopper: the GRU along time over every (b, f)
// row of the [B, T, Fq, C] plane with its input projections precomputed,
// fused with out[t] = x[t] + LN(h_t . Wfc + bfc).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_inter_block_v2, kernel
// _inter_v2_kernel (TPU).
//
// Inputs: xp [B, T, Fq, 3C] = x . Wi + bi (computed by the caller, float32
// or bfloat16), the residual plane x [B, T, Fq, C] (float32 or bfloat16),
// h0 [B, Fq, C] f32, whfc [C, 4C] = [Wh | Wfc], bh [3C], bfc, g, bln [C].
// Outputs: out (the plane's type) and h_last [B, Fq, C] f32.  Rows are
// addressed through strides (row n = b * Fq + f): no transpose of either
// plane.  Per step and row (bh added at use; bh_n inside r *, as in torch):
//     r = sigma(xp_r + hh_r + bh_r) ; z = sigma(xp_z + hh_z + bh_z)
//     n = tanh(xp_n + r * (hh_n + bh_n)) ; h = (1 - z) * n + z * h
//     [hh | y] = h . [Wh | Wfc] ;  out = x + LN(y + bfc) * g + bln
// so the carried raw hh of the next step and this step's fc come out of
// one 64 x 256 product.
//
// What bounds it on the H100: the recurrence is sequential in T, and only
// B * Fq rows run in parallel (320 / 384 at B=8, 2560 / 3072 at B=64).
// The useful work is 8 C^2 FLOPs per row-step against x and xp read once
// and out written once; at B=64 the f32 FMA rate is the bound, at B=8 the
// latency of one step: gates -> h_new -> the product -> LayerNorm.
//
// Design: one warp owns R rows (R = 1 or 2).  Lane l owns units l and
// l + 32, so it computes 8 of the 256 product columns (r, z, n, fc of its
// two units) for each of its rows, and a row's 64 hidden values and its
// LayerNorm live in one warp:
//  - h_new goes through a warp-private double-buffered shared slice with
//    one __syncwarp per step (read back as float4 broadcasts);
//  - the LayerNorm mean and variance are warp shuffles;
//  - nothing block-wide happens inside the step loop.
// [Wh | Wfc] (64 KB f32) is packed once per block into shared memory in
// the order the lanes read it, [k][half][lane][4 columns]: two
// conflict-free 16-byte loads per k, each feeding R rows; the 64-deep
// product is unrolled whole, so its loads run ahead.  The next step's
// xp and this step's residual x are loaded at the top of the step, so
// their latency hides under the gates and the product.  The launch plan
// (rows per warp, warps per block) is gru_kernels.inter_v2_plan.  Every
// row runs the same instruction sequence (k ascending, the same shuffle
// tree) whatever the plan, so a row's result does not depend on N.
#include "gru64_walk.cuh"

using namespace dpdf;

namespace {

constexpr int LANES = 32;
constexpr int MAX_WARPS = 8;
constexpr int W_FLOATS = C * 2 * LANES * 4;   // packed [Wh | Wfc]: 64 KB

template <int R>
constexpr size_t smem_bytes(int warps) {
  return sizeof(float) * (W_FLOATS + (size_t)warps * 2 * R * C);
}

// acc[j][0..3] = h_j . [Wh_r Wh_z Wh_n Wfc] at unit lane, acc[j][4..7] at
// unit lane + 32; h_j from the warp's slice sh [R][C].  k ascends.
template <int R>
__device__ __forceinline__ void product(const float4* __restrict__ sw,
                                        const float* __restrict__ sh, int lane,
                                        float (&acc)[R][8]) {
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
#pragma unroll
  for (int k = 0; k < C; k += 4) {
    float4 hv[R];
#pragma unroll
    for (int j = 0; j < R; ++j) hv[j] = *reinterpret_cast<const float4*>(&sh[j * C + k]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 a = sw[((k + kk) * 2) * LANES + lane];
      const float4 b = sw[((k + kk) * 2 + 1) * LANES + lane];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float hs = (&hv[j].x)[kk];
        acc[j][0] = fmaf(hs, a.x, acc[j][0]);
        acc[j][1] = fmaf(hs, a.y, acc[j][1]);
        acc[j][2] = fmaf(hs, a.z, acc[j][2]);
        acc[j][3] = fmaf(hs, a.w, acc[j][3]);
        acc[j][4] = fmaf(hs, b.x, acc[j][4]);
        acc[j][5] = fmaf(hs, b.y, acc[j][5]);
        acc[j][6] = fmaf(hs, b.z, acc[j][6]);
        acc[j][7] = fmaf(hs, b.w, acc[j][7]);
      }
    }
  }
}

// out[t] = x[t] + LN(y + bfc) * g + bln for each of the warp's rows, with
// y = acc[j][3] (unit lane) and acc[j][7] (unit lane + 32): the LayerNorm
// over the row's 64 units is two warp sums.  Stored only where ``store``.
template <int R, typename TX>
__device__ __forceinline__ void layer_norm_out(const float (&acc)[R][8], const float (&xr)[R][2],
                                               const float (&fcb)[2], const float (&gain)[2],
                                               const float (&shift)[2], TX* __restrict__ out,
                                               const int64_t (&xo)[R], int t, int64_t ss,
                                               int64_t row0, int64_t N, int lane, bool store) {
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float y0 = acc[j][3] + fcb[0], y1 = acc[j][7] + fcb[1];
    const float mu = warp_sum(y0 + y1) * (1.0f / C);
    const float d0 = y0 - mu, d1 = y1 - mu;
    const float var = warp_sum(fmaf(d0, d0, d1 * d1)) * (1.0f / C);
    const float inv = 1.0f / sqrtf(var + 1e-5f);
    if (store && row0 + j < N) {
      const int64_t o = xo[j] + t * ss + lane;
      store_f(out + o, xr[j][0] + fmaf(d0 * inv, gain[0], shift[0]));
      store_f(out + o + LANES, xr[j][1] + fmaf(d1 * inv, gain[1], shift[1]));
    }
  }
}

template <int R, typename TP, typename TX>
__global__ void __launch_bounds__(MAX_WARPS * LANES)
dprnn_inter_v2_kernel(const TP* __restrict__ xp, const TX* __restrict__ x, TX* __restrict__ out,
                      const float* __restrict__ h0, float* __restrict__ h_last,
                      const float* __restrict__ whfc, const float* __restrict__ bh,
                      const float* __restrict__ bfc, const float* __restrict__ g,
                      const float* __restrict__ bln, Rows rows, Rows xrows, int64_t N, int T) {
  extern __shared__ __align__(16) float smem[];
  const float4* sw = reinterpret_cast<const float4*>(smem);
  const int warp = threadIdx.x / LANES, lane = threadIdx.x % LANES;
  const int warps = blockDim.x / LANES;
  float* sh = smem + W_FLOATS + warp * 2 * R * C;          // this warp's [2][R][C]

  // whfc[k][c * C + u] -> smem[((k * 2 + u / 32) * 32 + u % 32) * 4 + c]:
  // 16-byte loads, 8 in flight per thread (whfc is 16-byte aligned)
  const float4* w4 = reinterpret_cast<const float4*>(whfc);
  for (int base = threadIdx.x; base < W_FLOATS / 4; base += 8 * blockDim.x) {
    float4 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = base + e * blockDim.x;
      if (i < W_FLOATS / 4) v[e] = w4[i];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = base + e * blockDim.x;
      if (i < W_FLOATS / 4) {
        const int k = i / C, c = (i / (C / 4)) % 4, u = (4 * i) % C;
#pragma unroll
        for (int f = 0; f < 4; ++f)
          smem[((k * 2 + (u + f) / LANES) * LANES + (u + f) % LANES) * 4 + c] = (&v[e].x)[f];
      }
    }
  }
  __syncthreads();                       // the only block-wide barrier
  const int64_t row0 = ((int64_t)blockIdx.x * warps + warp) * R;
  if (row0 >= N) return;

  float bhr[2], bhz[2], bhn[2], fcb[2], gain[2], shift[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int u = lane + LANES * q;
    bhr[q] = bh[u];
    bhz[q] = bh[C + u];
    bhn[q] = bh[2 * C + u];
    fcb[q] = bfc[u];
    gain[q] = g[u];
    shift[q] = bln[u];
  }
  int64_t xo[R], po[R];                   // step-0 offsets of each row (clamped) in x, xp
  float h[R][2];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int64_t n = row0 + j;
    xo[j] = rows.off(n < N ? n : N - 1, 0);
    po[j] = xrows.off(n < N ? n : N - 1, 0);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      h[j][q] = (h0 != nullptr && n < N) ? h0[n * C + lane + LANES * q] : 0.0f;
      sh[j * C + lane + LANES * q] = h[j][q];
    }
  }
  __syncwarp();

  // raw h0 . Wh for step 0 (zero for a zero start)
  float acc[R][8];
  if (h0 != nullptr) {
    product<R>(sw, sh, lane, acc);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
  }

  // xp of the current step: [row][gate][half]
  float xpc[R][3][2];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int gt = 0; gt < 3; ++gt)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        xpc[j][gt][q] = load_f(xp + po[j] + gt * C + lane + LANES * q);

  // Step s: the gates from the product of h(s - 1), h(s) to the slice,
  // then the LayerNorm of step s - 1 (from the same product) ahead of the
  // product of h(s) in one straight-line block, so the shuffles' latency
  // hides under the product; step T - 1's LayerNorm follows the loop.
  float xr[R][2] = {};                    // the residual of the previous step
  for (int s = 0; s < T; ++s) {
    // this step's residual and the next step's projections, issued first
    float xrn[R][2], xpn[R][3][2];
    const int sn = s + 1 < T ? s + 1 : s;
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        xrn[j][q] = load_f(x + xo[j] + s * rows.ss + lane + LANES * q);
#pragma unroll
        for (int gt = 0; gt < 3; ++gt)
          xpn[j][gt][q] = load_f(xp + po[j] + sn * xrows.ss + gt * C + lane + LANES * q);
      }
    }

    float* shp = sh + ((s + 1) & 1) * R * C;
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float rg = sigmoid_f(xpc[j][0][q] + (acc[j][4 * q] + bhr[q]));
        const float zg = sigmoid_f(xpc[j][1][q] + (acc[j][4 * q + 1] + bhz[q]));
        const float ng = tanhf(fmaf(rg, acc[j][4 * q + 2] + bhn[q], xpc[j][2][q]));
        h[j][q] = fmaf(zg, h[j][q], (1.0f - zg) * ng);
        shp[j * C + lane + LANES * q] = h[j][q];
      }
    }
    __syncwarp();
    layer_norm_out<R>(acc, xr, fcb, gain, shift, out, xo, s - 1, rows.ss, row0, N, lane, s > 0);
    product<R>(sw, shp, lane, acc);
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        xr[j][q] = xrn[j][q];
#pragma unroll
        for (int gt = 0; gt < 3; ++gt) xpc[j][gt][q] = xpn[j][gt][q];
      }
  }
  layer_norm_out<R>(acc, xr, fcb, gain, shift, out, xo, T - 1, rows.ss, row0, N, lane, true);

#pragma unroll
  for (int j = 0; j < R; ++j) {
    if (row0 + j < N) {
      h_last[(row0 + j) * C + lane] = h[j][0];
      h_last[(row0 + j) * C + lane + LANES] = h[j][1];
    }
  }
}

template <int R, typename TP, typename TX>
cudaError_t launch(const TP* xp, const TX* x, TX* out, const float* h0, float* h_last,
                   const float* whfc, const float* bh, const float* bfc, const float* g,
                   const float* bln, Rows rows, Rows xrows, int64_t N, int T, int warps,
                   int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(warps);
  cudaError_t err = cudaFuncSetAttribute(dprnn_inter_v2_kernel<R, TP, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dprnn_inter_v2_kernel<R, TP, TX><<<blocks, warps * LANES, smem, stream>>>(
      xp, x, out, h0, h_last, whfc, bh, bfc, g, bln, rows, xrows, N, T);
  return cudaGetLastError();
}

template <typename TP, typename TX>
cudaError_t run(const TP* xp, const TX* x, TX* out, const float* h0, float* h_last,
                const float* whfc, const float* bh, const float* bfc, const float* g,
                const float* bln, int B, int T, int Fq, int rows_per_warp, int warps,
                int blocks, cudaStream_t st) {
  if (warps < 1 || warps > MAX_WARPS || blocks < 1 ||
      (int64_t)blocks * warps * rows_per_warp < (int64_t)B * Fq)
    return cudaErrorInvalidConfiguration;
  // row n = b * Fq + f; x[b, t, f, :] at b*T*Fq*C + f*C + t*Fq*C, xp likewise with 3C
  Rows rows{Fq, (int64_t)T * Fq * C, C, (int64_t)Fq * C};
  Rows xrows{Fq, (int64_t)T * Fq * G3, G3, (int64_t)Fq * G3};
  const int64_t N = (int64_t)B * Fq;
#define DPDF_LAUNCH(R) \
  launch<R>(xp, x, out, h0, h_last, whfc, bh, bfc, g, bln, rows, xrows, N, T, warps, blocks, st)
  switch (rows_per_warp) {
    case 1: return DPDF_LAUNCH(1);
    case 2: return DPDF_LAUNCH(2);
    default: return cudaErrorInvalidValue;
  }
#undef DPDF_LAUNCH
}

}  // namespace

// xp: [B, T, Fq, 3C], float32, or bfloat16 when xp_bf16; x, out:
// [B, T, Fq, C], float32, or bfloat16 when plane_bf16; h0, h_last:
// [B, Fq, C] f32; whfc [C, 4C], bh [3C], bfc / g / bln [C] f32.  The plan
// (rows per warp 1 or 2, warps per block 1..8, blocks) comes from
// gru_kernels.inter_v2_plan.
extern "C" int dprnn_inter_v2_launch(const void* xp, const void* x, void* out, const float* h0,
                                     float* h_last, const float* whfc, const float* bh,
                                     const float* bfc, const float* g, const float* bln, int B,
                                     int T, int Fq, int rows_per_warp, int warps, int blocks,
                                     int xp_bf16, int plane_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DPDF_RUN(TP, TX)                                                                      \
  return (int)run(static_cast<const TP*>(xp), static_cast<const TX*>(x), static_cast<TX*>(out), \
                  h0, h_last, whfc, bh, bfc, g, bln, B, T, Fq, rows_per_warp, warps, blocks, st)
  if (xp_bf16 && plane_bf16) DPDF_RUN(bf16, bf16);
  if (xp_bf16) DPDF_RUN(bf16, float);
  if (plane_bf16) DPDF_RUN(float, bf16);
  DPDF_RUN(float, float);
#undef DPDF_RUN
}
