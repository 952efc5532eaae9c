// The warp-per-row C = 64 GRU walk of dprnn_inter.cu, dprnn_intra.cu,
// dprnn_intra_v2.cu and gru_bidir.cu; dprnn_stack.cu runs its step
// (gru_unit) and its LayerNorm (ln_store) in a walk of its own, so the
// stack gives these kernels' bits.  Intra v2 and the two step-ablation
// kernels (intra_step_ablation.cu, inter_step_ablation.cu) instantiate
// the same walk through its compile-time hooks: a step body (STEP), an
// output (OUT_NONE) and a LayerNorm form (LN), whose defaults are the
// production step (gru_unit, step_product, ln_store), so their `full` is
// the production kernel.
//
// The TPU kernels it stands in for compute the same way: the fc of step s
// folded into step s + 1's hidden product (_inter_block_kernel_packed's
// fcfuse) and the input projection hoisted off the recurrence
// (_inter_hoist, the hoist branch of _intra_block_kernel), both in
// dpdfnet_tpu/ops/pallas_gru.py.
//
// What bounds a C = 64 walk on the H100: every warp that walks rows reads
// its weight columns from shared memory once per step (64 KB of [Wh | Wfc]
// per warp and step, and 48 KB of Wi per chunk), and with several warps
// per SM that traffic and the products' FMA issue, not the step's
// dependent chain, set the step time: the step ablations (PERF.md)
// put 57% of intra's step in the products and their loads, 31% in the fc
// columns, partial stores and epilogue, 6% in the gates, and nothing in
// the dependence on h (the same work with x in place of h is no faster).
//
// Design.  One warp owns R rows (R = 1 or 2); lane l owns hidden units l
// and l + 32, so a row's 64 units, its gates and its LayerNorm live in one
// warp and the step loop has no block barrier:
//  - h_new goes through a warp-private double-buffered slice behind one
//    __syncwarp and is read back as float4 broadcasts;
//  - one product h . [Wh | Wfc] per step (64 x 256, k ascending) gives the
//    next step's raw h . Wh and this step's fc columns (the LayerNorm is
//    two warp sums); with OUT_YS (a plain GRU layer, no fc) the product is
//    h . Wh alone (64 x 192), Wh staged in Wi's layout;
//  - x . Wi + bi is hoisted off the chain: per chunk of TS steps the warp
//    stages its rows' x into a warp-private slice, then one pass over Wi
//    (read once for all TS x R row-steps) computes every xp of the chunk
//    into the slice, each lane its own six columns (r, z, n of its two
//    units) beside its residual x, as one float4 per unit;
//  - the next chunk's x is loaded into registers while this chunk walks.
// Wi (48 KB, [k][gate][lane] float2 of units l, l + 32) and [Wh | Wfc]
// (64 KB, [k][half][lane][r z n fc]) are staged once per block with
// 16-byte loads, 8 in flight per thread, and stay in shared memory.
// Every row runs the same instruction sequence (k ascending, the same
// shuffle tree) whatever R, TS, the warp count or the row layout, so a
// row's bits do not depend on the launch plan or on the batch.
// Planes are float32 or bfloat16 (loads upcast, stores round once); the
// weights, the carried hidden and all arithmetic are float32.
#pragma once

#include "gru64_walk.cuh"

namespace dpdf {
namespace ww {

constexpr int LANES = 32;
constexpr int WI_FLOATS = C * 3 * LANES * 2;      // packed Wi: 48 KB
constexpr int WHF_FLOATS = C * 2 * LANES * 4;     // packed [Wh | Wfc]: 64 KB
constexpr int W_FLOATS = WI_FLOATS + WHF_FLOATS;
constexpr int SLOT = 8 * LANES;                   // floats of one (step, row) chunk slot

// Shared floats of one warp: the chunk slots [TS][R][SLOT] and h [2][R][C].
__host__ __device__ constexpr int warp_floats(int R, int TS) { return TS * R * SLOT + 2 * R * C; }

// What the walk does with each step's result.
enum WalkOut {
  OUT_LN_RESIDUAL = 0,   // out[t] = x[t] + LN(h_t . Wfc + bfc) * g + bln (DPRNN inter)
  OUT_HIDDEN = 1,        // out[t] = h_t (the inter defer mode)
  OUT_FC_PART = 2,       // part[row][t] = h_t . Wfc_d (one direction of DPRNN intra)
  OUT_YS = 3,            // out[t] = h_t, product h . Wh only (a plain GRU layer: gru_bidir)
  OUT_NONE = 4,          // nothing per step, product h . Wh only (the step ablations)
};

// The LayerNorm of OUT_LN_RESIDUAL: the production's two-pass form, or one
// of the inter step ablation's variants.
enum LnForm {
  LN_TWO_PASS = 0,       // the mean, then the mean square of the centred values
  LN_NONE = 1,           // no normalisation: x + (y + bfc) * g + bln
  LN_ONE_PASS = 2,       // var = E[y^2] - mean^2
  LN_BF16_STATS = 3,     // both statistics summed from bfloat16-rounded terms
};

// One lane's biases and LayerNorm parameters for units lane, lane + 32.
struct LaneParams {
  float bi[3][2], bh[3][2], fcb[2], gain[2], shift[2];
};

// bfc == nullptr (OUT_YS: no fc, no LayerNorm) leaves those fields zero.
__device__ __forceinline__ LaneParams lane_params(const GruWeights& w, const float* bfc,
                                                  const float* g, const float* bln, int lane) {
  LaneParams p;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int u = lane + LANES * q;
#pragma unroll
    for (int gt = 0; gt < 3; ++gt) {
      p.bi[gt][q] = w.bi[gt * w.gstride + w.col0 + u];
      p.bh[gt][q] = w.bh[gt * w.gstride + w.col0 + u];
    }
    p.fcb[q] = bfc != nullptr ? bfc[u] : 0.0f;
    p.gain[q] = bfc != nullptr ? g[u] : 0.0f;
    p.shift[q] = bfc != nullptr ? bln[u] : 0.0f;
  }
  return p;
}

// One hidden unit's GRU update from its hoisted xp = x . Wi + bi (r, z, n),
// its raw h . Wh products (r, z, n), bh and the previous h.  The one
// expression of the step: every kernel that must give the walk's bits
// calls it.
// (The two sigmoids are sigmoid_f with both exponentials first, so the
// two divisions' branch regions do not serialize the exponentials.)
__device__ __forceinline__ float gru_unit(float xr, float xz, float xn, float ar, float az,
                                          float an, float br, float bz, float bn, float h) {
  const float er = expf(-(xr + (ar + br)));
  const float ez = expf(-(xz + (az + bz)));
  const float rg = 1.0f / (1.0f + er);
  const float zg = 1.0f / (1.0f + ez);
  const float ng = tanhf(fmaf(rg, an + bn, xn));
  return fmaf(zg, h, (1.0f - zg) * ng);
}

// Makes the compiler compute v although nothing reads it, so a step
// ablation keeps the product work of the step it stands in for: v is
// stored to a sink where it is NaN, which the compiler cannot rule out (an
// empty asm statement does not survive ptxas, which then drops the work).
__device__ float keep_alive_sink;
__device__ __forceinline__ void keep_alive(float v) {
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.nan.f32 p, %0, %0;\n\t@p st.global.f32 [%1], %0;\n\t}"
      ::"f"(v), "l"(&keep_alive_sink));
}

// The walk's step body: h_new of one unit from its chunk slot xp (the
// hoisted r, z, n and, in .w, the unit's x), its raw products a (r, z, n),
// bh and the previous h.  PRODUCTS: the walk runs the x . Wi hoist and the
// step's product; FEED_X: the product reads the next step's x instead of
// h_new.  StepGru is the production step; the others are the step
// ablations' bodies, which keep alive the products they do not use.
struct StepGru {
  static constexpr bool PRODUCTS = true, FEED_X = false;
  __device__ static float unit(float4 xp, float ar, float az, float an, float br, float bz,
                               float bn, float h) {
    return gru_unit(xp.x, xp.y, xp.z, ar, az, an, br, bz, bn, h);
  }
};

// StepGru on the hoisted xp rounded to bfloat16, its bias included: DPRNN
// intra v2 with bfloat16 input projections (the TPU kernel's bf16 xp
// scratch)
struct StepGruXpBf16 {
  static constexpr bool PRODUCTS = true, FEED_X = false;
  __device__ static float unit(float4 xp, float ar, float az, float an, float br, float bz,
                               float bn, float h) {
    return gru_unit(round_bf16(xp.x), round_bf16(xp.y), round_bf16(xp.z), ar, az, an, br, bz,
                    bn, h);
  }
};

// h = (x . Wi_r + bi_r) + (h . Wh_r + bh_r): the products, no gates
struct StepRSum {
  static constexpr bool PRODUCTS = true, FEED_X = false;
  __device__ static float unit(float4 xp, float ar, float az, float an, float br, float, float,
                               float) {
    keep_alive(az + an);
    return xp.x + (ar + br);
  }
};

// StepRSum with the product applied to x: no dependence on h
struct StepIndep : StepRSum {
  static constexpr bool FEED_X = true;
};

// h = (x . Wi_r + bi_r) + (h . Wh_r + bh_r) + h
struct StepRSumAcc {
  static constexpr bool PRODUCTS = true, FEED_X = false;
  __device__ static float unit(float4 xp, float ar, float az, float an, float br, float, float,
                               float h) {
    keep_alive(az + an);
    return (xp.x + (ar + br)) + h;
  }
};

// gru_unit with identity weights: r = z = sigma(x + h), n = tanh(x + r h)
struct StepGates {
  static constexpr bool PRODUCTS = false, FEED_X = false;
  __device__ static float unit(float4 xp, float, float, float, float, float, float, float h) {
    return gru_unit(xp.w, xp.w, xp.w, h, h, h, 0.0f, 0.0f, 0.0f, h);
  }
};

// h = h + x: loads, the slot and the __syncwarp, one add
struct StepFloor {
  static constexpr bool PRODUCTS = false, FEED_X = false;
  __device__ static float unit(float4 xp, float, float, float, float, float, float, float h) {
    return h + xp.w;
  }
};

// h = bf16(h + x)
struct StepFloorBf16 : StepFloor {
  __device__ static float unit(float4 xp, float, float, float, float, float, float, float h) {
    return round_bf16(h + xp.w);
  }
};

// Stage Wi and [Wh | Wfc] of one GRU into smem in the lanes' read order:
// Wh as GruWeights says, Wi element (k, gate, u) at
// w.wi[(wi_row0 + k) * wi_ld + gate * w.gstride + w.col0 + u], fc element
// (k, j) at wfc[k * fc_ld + j].  Every pointer and offset is 16-byte
// aligned (the wrappers check the bases).
__device__ __forceinline__ void stage_weights(float* smem, const GruWeights& w,
                                              const float* __restrict__ wfc, int wi_row0,
                                              int wi_ld, int fc_ld) {
  constexpr int NWI = C * G3 / 4;       // float4s of Wi
  constexpr int NWH = C * 4 * C / 4;    // float4s of [Wh | Wfc]
  float* swh = smem + WI_FLOATS;
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < NWI + NWH; base += 8 * nt) {
    float4 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = base + e * nt;
      if (i < NWI) {
        const int k = i / (G3 / 4), c4 = i % (G3 / 4);
        const int gt = c4 / (C / 4), u0 = (c4 % (C / 4)) * 4;
        v[e] = *reinterpret_cast<const float4*>(w.wi + (int64_t)(wi_row0 + k) * wi_ld +
                                                gt * w.gstride + w.col0 + u0);
      } else if (i < NWI + NWH) {
        const int j = i - NWI;
        const int k = j / C, c = (j % C) / (C / 4), u0 = (j % (C / 4)) * 4;
        const float* src = c < 3 ? w.wh + (int64_t)(w.row0 + k) * w.ld + c * w.gstride +
                                       w.col0 + u0
                                 : wfc + k * fc_ld + u0;
        v[e] = *reinterpret_cast<const float4*>(src);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = base + e * nt;
      if (i < NWI) {
        const int k = i / (G3 / 4), c4 = i % (G3 / 4);
        const int gt = c4 / (C / 4), u0 = (c4 % (C / 4)) * 4;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int u = u0 + f;
          smem[((k * 3 + gt) * LANES + u % LANES) * 2 + u / LANES] = (&v[e].x)[f];
        }
      } else if (i < NWI + NWH) {
        const int j = i - NWI;
        const int k = j / C, c = (j % C) / (C / 4), u0 = (j % (C / 4)) * 4;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int u = u0 + f;
          swh[((k * 2 + u / LANES) * LANES + u % LANES) * 4 + c] = (&v[e].x)[f];
        }
      }
    }
  }
}

// stage_weights with Wi in Wh's rows and a dense [C][C] fc (every kernel
// but intra v2).
__device__ __forceinline__ void stage_weights(float* smem, const GruWeights& w,
                                              const float* __restrict__ wfc) {
  stage_weights(smem, w, wfc, w.row0, w.ld, C);
}

// OUT_YS: stage Wi and Wh of one GRU, both in Wi's layout ([k][gate][lane]
// float2 of units lane, lane + 32; 96 KB), with stage_weights' loads.
__device__ __forceinline__ void stage_weights_ys(float* smem, const GruWeights& w) {
  constexpr int NW = C * G3 / 4;        // float4s of one matrix
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < 2 * NW; base += 8 * nt) {
    float4 v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = base + e * nt;
      if (i < 2 * NW) {
        const int m = i / NW, j = i % NW;
        const int k = j / (G3 / 4), c4 = j % (G3 / 4);
        const int gt = c4 / (C / 4), u0 = (c4 % (C / 4)) * 4;
        v[e] = *reinterpret_cast<const float4*>((m == 0 ? w.wi : w.wh) +
                                                (int64_t)(w.row0 + k) * w.ld + gt * w.gstride +
                                                w.col0 + u0);
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = base + e * nt;
      if (i < 2 * NW) {
        const int m = i / NW, j = i % NW;
        const int k = j / (G3 / 4), c4 = j % (G3 / 4);
        const int gt = c4 / (C / 4), u0 = (c4 % (C / 4)) * 4;
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const int u = u0 + f;
          smem[m * WI_FLOATS + ((k * 3 + gt) * LANES + u % LANES) * 2 + u / LANES] =
              (&v[e].x)[f];
        }
      }
    }
  }
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

// OUT_YS: acc[j][0..2] = h_j . [Wh_r Wh_z Wh_n] at unit lane, acc[j][4..6]
// at unit lane + 32 (acc[j][3], acc[j][7] stay zero); Wh in Wi's layout.
template <int R>
__device__ __forceinline__ void product_h(const float2* __restrict__ sw,
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
      const float2 wr = sw[((k + kk) * 3) * LANES + lane];
      const float2 wz = sw[((k + kk) * 3 + 1) * LANES + lane];
      const float2 wn = sw[((k + kk) * 3 + 2) * LANES + lane];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const float hs = (&hv[j].x)[kk];
        acc[j][0] = fmaf(hs, wr.x, acc[j][0]);
        acc[j][1] = fmaf(hs, wz.x, acc[j][1]);
        acc[j][2] = fmaf(hs, wn.x, acc[j][2]);
        acc[j][4] = fmaf(hs, wr.y, acc[j][4]);
        acc[j][5] = fmaf(hs, wz.y, acc[j][5]);
        acc[j][6] = fmaf(hs, wn.y, acc[j][6]);
      }
    }
  }
}

// The step's product: h . [Wh | Wfc], or h . Wh alone for OUT_YS / OUT_NONE.
template <int R, int OUT>
__device__ __forceinline__ void step_product(const float* __restrict__ sw,
                                             const float* __restrict__ sh, int lane,
                                             float (&acc)[R][8]) {
  if constexpr (OUT == OUT_YS || OUT == OUT_NONE)
    product_h<R>(reinterpret_cast<const float2*>(sw + WI_FLOATS), sh, lane, acc);
  else
    product<R>(reinterpret_cast<const float4*>(sw + WI_FLOATS), sh, lane, acc);
}

// out = x + LN(y + bfc) * g + bln for the two units of this lane, with
// y = (y0, y1) of the row: the mean and the variance are warp sums (LN:
// LnForm, two-pass in production).  Stored only where ``store`` (the
// shuffles run on every lane regardless).
template <int LN = LN_TWO_PASS, typename TO>
__device__ __forceinline__ void ln_store(float y0, float y1, float x0, float x1,
                                         const LaneParams& p, TO* __restrict__ o, int lane,
                                         bool store = true) {
  y0 += p.fcb[0];
  y1 += p.fcb[1];
  if constexpr (LN == LN_NONE) {
    if (store) {
      store_f(o + lane, x0 + fmaf(y0, p.gain[0], p.shift[0]));
      store_f(o + lane + LANES, x1 + fmaf(y1, p.gain[1], p.shift[1]));
    }
    return;
  }
  const float mu =
      warp_sum(LN == LN_BF16_STATS ? round_bf16(y0) + round_bf16(y1) : y0 + y1) * (1.0f / C);
  const float d0 = y0 - mu, d1 = y1 - mu;
  float var;
  if constexpr (LN == LN_ONE_PASS)
    var = warp_sum(fmaf(y0, y0, y1 * y1)) * (1.0f / C) - mu * mu;
  else if constexpr (LN == LN_BF16_STATS)
    var = warp_sum(round_bf16(d0 * d0) + round_bf16(d1 * d1)) * (1.0f / C);
  else
    var = warp_sum(fmaf(d0, d0, d1 * d1)) * (1.0f / C);
  const float inv = 1.0f / sqrtf(var + 1e-5f);
  if (store) {
    store_f(o + lane, x0 + fmaf(d0 * inv, p.gain[0], p.shift[0]));
    store_f(o + lane + LANES, x1 + fmaf(d1 * inv, p.gain[1], p.shift[1]));
  }
}

// Walk S steps of rows row0 .. row0 + R - 1 (those < N live; the others
// are walked on row N - 1's data and store nothing).  sw: the staged
// weights; wbuf: this warp's warp_floats(R, TS).  x element c of row n at
// step t: rows.off(n, t) + c; the step's output at orows.off(n, t) + c
// (OUT_LN_RESIDUAL, OUT_HIDDEN) or part[j * part_row + t * C + c]
// (OUT_FC_PART, j the row's index in the warp); h0 / h_last at
// hrows.off(n, 0) + c (h0 == nullptr: zeros; h_last == nullptr: not
// stored).  reverse walks t = S - 1 .. 0.  STEP and LN are the step
// ablations' hooks (StepGru and LN_TWO_PASS: the production step).
template <int R, int TS, int OUT, typename TX, typename TO, typename STEP = StepGru,
          int LN = LN_TWO_PASS>
__device__ __forceinline__ void walk(const float* __restrict__ sw, float* __restrict__ wbuf,
                                     const TX* __restrict__ x, Rows rows, Rows orows,
                                     Rows hrows, int64_t row0, int64_t N, int S, bool reverse,
                                     const LaneParams& p, TO* __restrict__ out,
                                     float* __restrict__ part, int part_row,
                                     const float* __restrict__ h0, float* __restrict__ h_last,
                                     int lane) {
  constexpr bool RES = OUT == OUT_LN_RESIDUAL;
  const float2* swi = reinterpret_cast<const float2*>(sw);
  float* slots = wbuf;                            // [TS][R][SLOT]
  float* sh = wbuf + TS * R * SLOT;               // [2][R][C]

  bool live[R];
  int64_t xo[R], oo[R], ho[R];
  float h[R][2];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    live[j] = row0 + j < N;
    const int64_t n = live[j] ? row0 + j : N - 1;
    xo[j] = rows.off(n, 0);
    oo[j] = orows.off(n, 0);
    ho[j] = hrows.off(n, 0);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      h[j][q] = (h0 != nullptr && live[j]) ? h0[ho[j] + lane + LANES * q] : 0.0f;
      sh[j * C + lane + LANES * q] = h[j][q];
    }
  }
  __syncwarp();
  float acc[R][8];                                // raw h . Wh for the next step, and its fc
  if (STEP::PRODUCTS && h0 != nullptr) {
    step_product<R, OUT>(sw, sh, lane, acc);
  } else {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[j][i] = 0.0f;
  }

  // x of a chunk's steps (clamped to step S - 1), this lane's two channels
  float xn[TS][R][2];
  auto load_chunk = [&](int c0) {
#pragma unroll
    for (int tt = 0; tt < TS; ++tt) {
      const int s = c0 + tt < S ? c0 + tt : S - 1;
      const int64_t t = reverse ? S - 1 - s : s;
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          xn[tt][j][q] = load_f(x + xo[j] + t * rows.ss + lane + LANES * q);
    }
  };
  load_chunk(0);
  if constexpr (STEP::FEED_X) {                   // step 0's product reads x_0
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int q = 0; q < 2; ++q) sh[j * C + lane + LANES * q] = xn[0][j][q];
    __syncwarp();
    step_product<R, OUT>(sw, sh, lane, acc);
  }

  float xr[R][2] = {};                            // the residual of the previous step
  for (int c0 = 0; c0 < S; c0 += TS) {
    float res[TS][R][2];
    __syncwarp();                                 // the previous chunk's slots are read
#pragma unroll
    for (int tt = 0; tt < TS; ++tt)
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          slots[(tt * R + j) * SLOT + lane + LANES * q] = xn[tt][j][q];
          res[tt][j][q] = xn[tt][j][q];
        }
    __syncwarp();
    if (c0 + TS < S) load_chunk(c0 + TS);         // in flight while this chunk runs

    // xp of the chunk: [step][row][r0 r1 z0 z1 n0 n1], k ascending
    float a[TS][R][6];
#pragma unroll
    for (int tt = 0; tt < TS; ++tt)
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < 6; ++i) a[tt][j][i] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < (STEP::PRODUCTS ? C : 0); k += 4) {
      float4 xv[TS][R];
#pragma unroll
      for (int tt = 0; tt < TS; ++tt)
#pragma unroll
        for (int j = 0; j < R; ++j)
          xv[tt][j] = *reinterpret_cast<const float4*>(&slots[(tt * R + j) * SLOT + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 wr = swi[((k + kk) * 3) * LANES + lane];
        const float2 wz = swi[((k + kk) * 3 + 1) * LANES + lane];
        const float2 wn = swi[((k + kk) * 3 + 2) * LANES + lane];
#pragma unroll
        for (int tt = 0; tt < TS; ++tt)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const float xs = (&xv[tt][j].x)[kk];
            a[tt][j][0] = fmaf(xs, wr.x, a[tt][j][0]);
            a[tt][j][1] = fmaf(xs, wr.y, a[tt][j][1]);
            a[tt][j][2] = fmaf(xs, wz.x, a[tt][j][2]);
            a[tt][j][3] = fmaf(xs, wz.y, a[tt][j][3]);
            a[tt][j][4] = fmaf(xs, wn.x, a[tt][j][4]);
            a[tt][j][5] = fmaf(xs, wn.y, a[tt][j][5]);
          }
      }
    }
    __syncwarp();                                 // every lane has read the chunk's x
#pragma unroll
    for (int tt = 0; tt < TS; ++tt)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float4* sp = reinterpret_cast<float4*>(&slots[(tt * R + j) * SLOT]);
#pragma unroll
        for (int q = 0; q < 2; ++q)
          sp[q * LANES + lane] = make_float4(a[tt][j][q] + p.bi[0][q], a[tt][j][2 + q] + p.bi[1][q],
                              a[tt][j][4 + q] + p.bi[2][q], res[tt][j][q]);
      }
    // each lane reads back only its own slot entries: no barrier before the walk

    const int c1 = c0 + TS < S ? c0 + TS : S;
    for (int s = c0; s < c1; ++s) {
      const int64_t t = reverse ? S - 1 - s : s;
      float4 xp[R][2];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q)
          xp[j][q] = reinterpret_cast<const float4*>(
              &slots[((s - c0) * R + j) * SLOT])[q * LANES + lane];
      float* shp = sh + ((s + 1) & 1) * R * C;
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          h[j][q] = STEP::unit(xp[j][q], acc[j][4 * q], acc[j][4 * q + 1], acc[j][4 * q + 2],
                               p.bh[0][q], p.bh[1][q], p.bh[2][q], h[j][q]);
          float feed = h[j][q];
          if constexpr (STEP::FEED_X)                 // x of step s + 1 (this lane's own entry)
            feed = s + 1 < c1 ? reinterpret_cast<const float4*>(
                                    &slots[((s + 1 - c0) * R + j) * SLOT])[q * LANES + lane].w
                              : xn[0][j][q];
          shp[j * C + lane + LANES * q] = feed;
        }
      __syncwarp();
      if constexpr (OUT == OUT_LN_RESIDUAL) {
        // step s - 1's LayerNorm (its fc came out of the last product),
        // ahead of this step's product so the shuffles overlap its loads
        const int64_t tp = reverse ? t + 1 : t - 1;
#pragma unroll
        for (int j = 0; j < R; ++j)
          ln_store<LN>(acc[j][3], acc[j][7], xr[j][0], xr[j][1], p,
                       out + oo[j] + tp * orows.ss, lane, s > 0 && live[j]);
      } else if constexpr (OUT == OUT_HIDDEN || OUT == OUT_YS) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (live[j]) {
            store_f(out + oo[j] + t * orows.ss + lane, h[j][0]);
            store_f(out + oo[j] + t * orows.ss + lane + LANES, h[j][1]);
          }
      }
      if constexpr (STEP::PRODUCTS) step_product<R, OUT>(sw, shp, lane, acc);
      if constexpr (OUT == OUT_FC_PART) {
#pragma unroll
        for (int j = 0; j < R; ++j)
          if (live[j]) {
            part[j * part_row + t * C + lane] = acc[j][3];
            part[j * part_row + t * C + lane + LANES] = acc[j][7];
          }
      }
      if constexpr (RES) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          xr[j][0] = xp[j][0].w;
          xr[j][1] = xp[j][1].w;
        }
      }
    }
  }
  if constexpr (OUT == OUT_LN_RESIDUAL) {
    const int64_t tl = reverse ? 0 : S - 1;
#pragma unroll
    for (int j = 0; j < R; ++j)
      ln_store<LN>(acc[j][3], acc[j][7], xr[j][0], xr[j][1], p, out + oo[j] + tl * orows.ss,
                   lane, live[j]);
  }

  if (h_last != nullptr) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (live[j]) {
        h_last[ho[j] + lane] = h[j][0];
        h_last[ho[j] + lane + LANES] = h[j][1];
      }
  }
}

}  // namespace ww
}  // namespace dpdf
