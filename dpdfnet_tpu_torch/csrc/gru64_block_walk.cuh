// The original block-wide C = 64 GRU walk, which only the two step-ablation
// kernels run (intra_step_ablation.cu, inter_step_ablation.cu): they time
// it on purpose, so it stays as it was.  The production kernels walk with
// gru64_warp.cuh.
//
// One thread block owns R = GROUPS * RPT independent rows and walks S steps
// of a GRU with input size == hidden size == 64 inside the block.  The 256
// threads are 4 row groups of 64: thread (grp, u) computes hidden unit u of
// rows grp, grp + 4, ... (RPT rows).  Per step and row:
//
//     xp = x_t . Wi + bi ;  hh = h . Wh + bh           (64 x 192 each)
//     r = sigma(xp_r + hh_r) ; z = sigma(xp_z + hh_z)
//     n = tanh(xp_n + r * hh_n)                         (bh_n inside r *)
//     h = (1 - z) * n + z * h
//
// then an epilogue on h (see MODE below).  Wi, Wh (48 KB each) and Wfc
// (16 KB) stay in shared memory for the whole walk; x_t and h rows are
// staged in shared memory and read as float4 broadcasts.  Each weight load
// from shared memory feeds RPT rows.
//
// The per-step output and the carried hidden h0 / h_last have strides of
// their own (gru64_walk_io); gru64_walk keeps x's layout for the output
// and a dense [N, C] hidden.
//
// STEP and LNV select timing-ablation bodies (tools/*_step_ablation.py of
// the port): every default instantiation is the walk's GRU step.
#pragma once

#include "gru64_walk.cuh"

namespace dpdf {

enum Mode {
  // out = x + LN(h . Wfc + bfc) * g + bln   (DPRNN inter stage)
  MODE_LN_RESIDUAL = 0,
  // part = h . Wfc_d, no bias: one direction's half of the intra fc
  MODE_FC_PART = 1,
  // out = h: the hidden itself (a plain GRU layer; no Wfc is read)
  MODE_YS = 2,
  // no per-step output: only h_last (the ablation walks)
  MODE_NONE = 3,
};

// The per-step update of the hidden.  Only STEP_GRU is a GRU; the others
// are the ablation tools' wrong-math bodies (the dot products they skip
// from the update are still computed, see keep_alive).
enum Step {
  STEP_GRU = 0,          // the GRU step
  STEP_SUM = 1,          // h = h + x: no products, no gates
  STEP_SUM_BF16 = 2,     // h = bf16(h + x)
  STEP_RSUM = 3,         // h = (x . Wi_r + bi_r) + (h . Wh_r + bh_r): products, no gates
  STEP_RSUM_INDEP = 4,   // as STEP_RSUM with x in place of h: no dependence on h
  STEP_RSUM_ACC = 5,     // h = (x . Wi_r + bi_r) + (h . Wh_r + bh_r) + h
  STEP_GATES = 6,        // the gates with identity weights: no products
};

// The LayerNorm of MODE_LN_RESIDUAL.
enum LnVariant {
  LN_TWO_PASS = 0,       // mean, then the mean square of the centred values
  LN_NONE = 1,           // no normalisation: y * g + bln
  LN_ONE_PASS = 2,       // var = E[y^2] - mean^2
  LN_BF16_STATS = 3,     // both statistics summed from bfloat16-rounded terms
};

// Makes the compiler compute v although nothing reads it: the ablation
// steps keep the full product cost of the step they stand in for.
__device__ __forceinline__ void keep_alive(float v) { asm volatile("" ::"f"(v)); }

template <int RPT>
constexpr int walk_smem_floats() {
  // swi, swh, swfc, sbi, sbh, sx, sh, sred
  return 2 * C * G3 + C * C + 2 * G3 + 2 * (GROUPS * RPT) * C + 2 * (GROUPS * RPT);
}

// Walk S steps for the block's rows: x read through ``rows``, the per-step
// output written through ``orows``, h0 / h_last (element c of row n at
// hrows.off(n, 0) + c) read and written through ``hrows``.  h0 == nullptr
// starts from zeros; h_last == nullptr skips the final hidden.
template <int RPT, int MODE, typename TX, typename TO, int STEP = STEP_GRU,
          int LNV = LN_TWO_PASS>
__device__ void gru64_walk_io(const TX* __restrict__ x, Rows rows, Rows orows, Rows hrows,
                              int64_t N, int S, bool reverse, GruWeights w, Epilogue<TO> ep,
                              const float* __restrict__ h0, float* __restrict__ h_last) {
  constexpr bool DOTS = STEP == STEP_GRU || STEP == STEP_RSUM || STEP == STEP_RSUM_INDEP ||
                        STEP == STEP_RSUM_ACC;
  constexpr int R = GROUPS * RPT;
  extern __shared__ __align__(16) float smem[];
  float* swi = smem;                 // [C][G3]
  float* swh = swi + C * G3;         // [C][G3]
  float* swfc = swh + C * G3;        // [C][C]
  float* sbi = swfc + C * C;         // [G3]
  float* sbh = sbi + G3;             // [G3]
  float* sx = sbh + G3;              // [R][C]
  float* sh = sx + R * C;            // [R][C]
  float* sred = sh + R * C;          // [R][2]

  const int tid = threadIdx.x;
  const int u = tid % C;
  const int grp = tid / C;
  const int half = (tid / 32) % 2;   // which warp of the row group
  const int lane = tid % 32;
  const int64_t row0 = (int64_t)blockIdx.x * R;

  for (int i = tid; i < C * G3; i += THREADS) {
    const int k = i / G3, col = i % G3, gate = col / C, uu = col % C;
    const int64_t src = (int64_t)(w.row0 + k) * w.ld + gate * w.gstride + w.col0 + uu;
    swi[i] = w.wi[src];
    swh[i] = w.wh[src];
  }
  if constexpr (MODE != MODE_YS && MODE != MODE_NONE) {
    for (int i = tid; i < C * C; i += THREADS) swfc[i] = ep.wfc[i];
  }
  for (int i = tid; i < G3; i += THREADS) {
    const int src = (i / C) * w.gstride + w.col0 + i % C;
    sbi[i] = w.bi[src];
    sbh[i] = w.bh[src];
  }
  for (int i = tid; i < R * C; i += THREADS) {
    const int64_t n = row0 + i / C;
    sh[i] = (h0 != nullptr && n < N) ? h0[hrows.off(n, 0) + i % C] : 0.0f;
  }
  __syncthreads();

  const float bir = sbi[u], biz = sbi[C + u], bin = sbi[2 * C + u];
  const float bhr = sbh[u], bhz = sbh[C + u], bhn = sbh[2 * C + u];
  float gain = 0.0f, shift = 0.0f, fcb = 0.0f;
  if (MODE == MODE_LN_RESIDUAL) {
    gain = ep.g[u];
    shift = ep.bln[u];
    fcb = ep.bfc[u];
  }

  for (int s = 0; s < S; ++s) {
    const int64_t t = reverse ? (S - 1 - s) : s;
    for (int i = tid; i < R * C; i += THREADS) {
      const int64_t n = row0 + i / C;
      sx[i] = (n < N) ? load_f(x + rows.off(n, t) + i % C) : 0.0f;
    }
    __syncthreads();

    float hnew[RPT];
    if constexpr (DOTS) {
      float axr[RPT], axz[RPT], axn[RPT], ahr[RPT], ahz[RPT], ahn[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        axr[j] = axz[j] = axn[j] = ahr[j] = ahz[j] = ahn[j] = 0.0f;
      }
      // STEP_RSUM_INDEP multiplies Wh by x instead of h
      const float* hsrc = STEP == STEP_RSUM_INDEP ? sx : sh;
      for (int k = 0; k < C; k += 4) {
        float4 xv[RPT], hv[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = grp + GROUPS * j;
          xv[j] = *reinterpret_cast<const float4*>(&sx[r * C + k]);
          hv[j] = *reinterpret_cast<const float4*>(&hsrc[r * C + k]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* wir = &swi[(k + kk) * G3];
          const float* whr = &swh[(k + kk) * G3];
          const float wr = wir[u], wz = wir[C + u], wn = wir[2 * C + u];
          const float vr = whr[u], vz = whr[C + u], vn = whr[2 * C + u];
#pragma unroll
          for (int j = 0; j < RPT; ++j) {
            const float xs = (&xv[j].x)[kk];
            const float hs = (&hv[j].x)[kk];
            axr[j] = fmaf(xs, wr, axr[j]);
            axz[j] = fmaf(xs, wz, axz[j]);
            axn[j] = fmaf(xs, wn, axn[j]);
            ahr[j] = fmaf(hs, vr, ahr[j]);
            ahz[j] = fmaf(hs, vz, ahz[j]);
            ahn[j] = fmaf(hs, vn, ahn[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = grp + GROUPS * j;
        if constexpr (STEP == STEP_GRU) {
          const float rg = sigmoid_f((axr[j] + bir) + (ahr[j] + bhr));
          const float zg = sigmoid_f((axz[j] + biz) + (ahz[j] + bhz));
          const float ng = tanhf((axn[j] + bin) + rg * (ahn[j] + bhn));
          hnew[j] = (1.0f - zg) * ng + zg * sh[r * C + u];
        } else {
          keep_alive(axz[j]);
          keep_alive(axn[j]);
          keep_alive(ahz[j]);
          keep_alive(ahn[j]);
          const float rs = (axr[j] + bir) + (ahr[j] + bhr);
          hnew[j] = STEP == STEP_RSUM_ACC ? rs + sh[r * C + u] : rs;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = grp + GROUPS * j;
        const float xs = sx[r * C + u], hs = sh[r * C + u];
        if constexpr (STEP == STEP_SUM) {
          hnew[j] = hs + xs;
        } else if constexpr (STEP == STEP_SUM_BF16) {
          hnew[j] = round_bf16(hs + xs);
        } else {                                    // STEP_GATES
          const float rg = sigmoid_f(xs + hs);
          const float zg = sigmoid_f(xs + hs);
          const float ng = tanhf(xs + rg * hs);
          hnew[j] = (1.0f - zg) * ng + zg * hs;
        }
      }
    }
    __syncthreads();                       // every read of the old h is done
#pragma unroll
    for (int j = 0; j < RPT; ++j) sh[(grp + GROUPS * j) * C + u] = hnew[j];
    __syncthreads();

    if constexpr (MODE == MODE_NONE) {
    } else if constexpr (MODE == MODE_YS) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int64_t n = row0 + grp + GROUPS * j;
        if (n < N) store_f(ep.out + orows.off(n, t) + u, hnew[j]);
      }
    } else {
      // epilogue: y = h . Wfc for this unit
      float y[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) y[j] = 0.0f;
      for (int k = 0; k < C; k += 4) {
        float4 hv[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          hv[j] = *reinterpret_cast<const float4*>(&sh[(grp + GROUPS * j) * C + k]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float wf = swfc[(k + kk) * C + u];
#pragma unroll
          for (int j = 0; j < RPT; ++j) y[j] = fmaf((&hv[j].x)[kk], wf, y[j]);
        }
      }
      if (MODE == MODE_FC_PART) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int64_t n = row0 + grp + GROUPS * j;
          if (n < N) store_f(ep.out + orows.off(n, t) + u, y[j]);
        }
      } else if constexpr (LNV == LN_NONE) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = grp + GROUPS * j;
          const int64_t n = row0 + r;
          if (n < N) store_f(ep.out + orows.off(n, t) + u,
                             sx[r * C + u] + ((y[j] + fcb) * gain + shift));
        }
      } else {
        // LayerNorm over the 64 units of each row: two warps per row group
        float d[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          y[j] += fcb;
          const float sm = warp_sum(LNV == LN_BF16_STATS ? round_bf16(y[j]) : y[j]);
          if (lane == 0) sred[(grp + GROUPS * j) * 2 + half] = sm;
        }
        __syncthreads();
        float msq[RPT];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = grp + GROUPS * j;
          const float mu = (sred[r * 2] + sred[r * 2 + 1]) * (1.0f / C);
          d[j] = y[j] - mu;
          msq[j] = mu * mu;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          float q;
          if constexpr (LNV == LN_ONE_PASS) {
            q = y[j] * y[j];
          } else if constexpr (LNV == LN_BF16_STATS) {
            q = round_bf16(d[j] * d[j]);
          } else {
            q = d[j] * d[j];
          }
          const float sq = warp_sum(q);
          if (lane == 0) sred[(grp + GROUPS * j) * 2 + half] = sq;
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const int r = grp + GROUPS * j;
          float var = (sred[r * 2] + sred[r * 2 + 1]) * (1.0f / C);
          if constexpr (LNV == LN_ONE_PASS) var -= msq[j];
          const float yn = d[j] * (1.0f / sqrtf(var + ep.eps));
          const int64_t n = row0 + r;
          if (n < N) store_f(ep.out + orows.off(n, t) + u, sx[r * C + u] + (yn * gain + shift));
        }
      }
    }  // MODE != MODE_YS
    __syncthreads();                       // sx / sred reused next step
  }

  if (h_last != nullptr) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int64_t n = row0 + grp + GROUPS * j;
      if (n < N) h_last[hrows.off(n, 0) + u] = sh[(grp + GROUPS * j) * C + u];
    }
  }
}

// The walk with the output in x's layout and a dense [N, C] hidden.
template <int RPT, int MODE, typename TX, typename TO>
__device__ __forceinline__ void gru64_walk(const TX* __restrict__ x, Rows rows, int64_t N, int S,
                                           bool reverse, GruWeights w, Epilogue<TO> ep,
                                           const float* __restrict__ h0,
                                           float* __restrict__ h_last) {
  gru64_walk_io<RPT, MODE>(x, rows, rows, dense_rows(N), N, S, reverse, w, ep, h0, h_last);
}

}  // namespace dpdf
