// The C = 64 "v2" GRU walk of dprnn_intra_v2.cu: the input projections
// xp = x . Wi + bi arrive precomputed, and each step runs ONE product of
// the new hidden with the fused [Wh | Wfc] (64 x 256): its first 3C
// columns are the next step's raw h . Wh, its last C columns this step's
// fc partial.  So the only dependent chain per step is gates -> h_new ->
// one 64-deep product.  (dprnn_inter_v2.cu has a walk of its own, one
// warp per row group.)
//
// One thread block owns R = GROUPS * RPT rows; the 256 threads are 4 row
// groups of 64, thread (grp, u) owns hidden unit u of rows grp, grp + 4,
// ...  Thread u needs only column u of each gate, so the carried raw
// h . Wh products stay in its registers; only h_new is exchanged, through
// a ping-pong shared buffer (one barrier per step).  [Wh | Wfc] (64 KB
// f32) stays in shared memory for the whole walk.  xp is read straight
// from device memory (each thread its own three gate columns, coalesced
// across u) in float32 or bfloat16.  All arithmetic is float32.
//
// Per step and row (bh added at use; bh_n inside r *, as in torch):
//     r = sigma(xp_r + hh_r + bh_r) ; z = sigma(xp_z + hh_z + bh_z)
//     n = tanh(xp_n + r * (hh_n + bh_n)) ; h = (1 - z) * n + z * h
//     [hh | y] = h . [Wh | Wfc]
// then out = y, one direction's fc partial.
#pragma once

#include "gru64_walk.cuh"

namespace dpdf {

// Column j of the fused [Wh | Wfc] for hidden row k lives at
//   w[(row0 + k) * ld + (j < 3C ? (j / C) * gstride + col0 + j % C : fcol + j % C)]
// and the bias (gate, u) at bh[gate * gstride + col0 + u].
struct FusedWeights {
  const float* w;
  const float* bh;
  int ld, row0, gstride, col0, fcol;
};

// xp element (row n, step t, gate, u) at xp[rows.off(n, t) + gate * gstride + col0 + u].
struct XpRows {
  Rows rows;
  int gstride, col0;
};

template <int RPT>
constexpr int v2_smem_floats() {
  // sw [C][4C], sh [2][R][C]
  return C * 4 * C + 2 * (GROUPS * RPT) * C;
}

// Walk S steps; h0 == nullptr starts from zeros, h_last == nullptr skips
// the final hidden (both [N, C] f32).  Step t's fc partial y goes to
// ep.out at rows.off(n, t) + u.
template <int RPT, typename TP, typename TO>
__device__ void gru64_v2_walk(const TP* __restrict__ xp, XpRows xr, Rows rows, int64_t N, int S,
                              bool reverse, FusedWeights w, Epilogue<TO> ep,
                              const float* __restrict__ h0, float* __restrict__ h_last) {
  constexpr int R = GROUPS * RPT;
  constexpr int W4 = 4 * C;
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                  // [C][4C]
  float* sh = sw + C * W4;           // [2][R][C]

  const int tid = threadIdx.x;
  const int u = tid % C;
  const int grp = tid / C;
  const int64_t row0 = (int64_t)blockIdx.x * R;

  for (int i = tid; i < C * W4; i += THREADS) {
    const int k = i / W4, j = i % W4;
    const int col = j < G3 ? (j / C) * w.gstride + w.col0 + j % C : w.fcol + j % C;
    sw[i] = w.w[(int64_t)(w.row0 + k) * w.ld + col];
  }
  float h[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t n = row0 + grp + GROUPS * j;
    h[j] = (h0 != nullptr && n < N) ? h0[n * C + u] : 0.0f;
    sh[(grp + GROUPS * j) * C + u] = h[j];
  }
  const float bhr = w.bh[w.col0 + u], bhz = w.bh[w.gstride + w.col0 + u],
              bhn = w.bh[2 * w.gstride + w.col0 + u];
  __syncthreads();

  // raw h0 . Wh for step 0 (zero for a zero start)
  float hr[RPT], hz[RPT], hn[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) hr[j] = hz[j] = hn[j] = 0.0f;
  if (h0 != nullptr) {
    for (int k = 0; k < C; k += 4) {
      float4 hv[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        hv[j] = *reinterpret_cast<const float4*>(&sh[(grp + GROUPS * j) * C + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = &sw[(k + kk) * W4 + u];
        const float a = wr[0], b = wr[C], c = wr[2 * C];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float hs = (&hv[j].x)[kk];
          hr[j] = fmaf(hs, a, hr[j]);
          hz[j] = fmaf(hs, b, hz[j]);
          hn[j] = fmaf(hs, c, hn[j]);
        }
      }
    }
  }

  for (int s = 0; s < S; ++s) {
    const int64_t t = reverse ? (S - 1 - s) : s;
    const int par = (s + 1) & 1;     // sh[0] held h0
    float* shp = sh + par * R * C;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int64_t n = row0 + grp + GROUPS * j;
      const TP* p = xp + xr.rows.off(n < N ? n : N - 1, t) + xr.col0 + u;
      const float rg = sigmoid_f(load_f(p) + (hr[j] + bhr));
      const float zg = sigmoid_f(load_f(p + xr.gstride) + (hz[j] + bhz));
      const float ng = tanhf(load_f(p + 2 * xr.gstride) + rg * (hn[j] + bhn));
      h[j] = (1.0f - zg) * ng + zg * h[j];
      shp[(grp + GROUPS * j) * C + u] = h[j];
    }
    __syncthreads();

    float y[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) hr[j] = hz[j] = hn[j] = y[j] = 0.0f;
    for (int k = 0; k < C; k += 4) {
      float4 hv[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
        hv[j] = *reinterpret_cast<const float4*>(&shp[(grp + GROUPS * j) * C + k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float* wr = &sw[(k + kk) * W4 + u];
        const float a = wr[0], b = wr[C], c = wr[2 * C], d = wr[3 * C];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float hs = (&hv[j].x)[kk];
          hr[j] = fmaf(hs, a, hr[j]);
          hz[j] = fmaf(hs, b, hz[j]);
          hn[j] = fmaf(hs, c, hn[j]);
          y[j] = fmaf(hs, d, y[j]);
        }
      }
    }

#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int64_t n = row0 + grp + GROUPS * j;
      if (n < N) store_f(ep.out + rows.off(n, t) + u, y[j]);
    }
  }

  if (h_last != nullptr) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int64_t n = row0 + grp + GROUPS * j;
      if (n < N) h_last[n * C + u] = h[j];
    }
  }
}

}  // namespace dpdf
