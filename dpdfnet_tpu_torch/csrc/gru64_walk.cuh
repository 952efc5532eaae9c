// The block-wide C = 64 GRU walk of gru_bidir.cu and of the two step-ablation
// kernels (intra_step_ablation.cu, inter_step_ablation.cu).  Its helpers
// (plane loads and stores, Rows / RowMap, GruWeights, warp_sum) and the
// intra epilogue kernel serve the other kernels too; DPRNN inter and intra
// walk with gru64_warp.cuh.
//
// Planes (x, and the out / ys plane) are float32 or bfloat16 (TX / TO):
// loads upcast, stores round once, every value in between is float32.
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
// Rows are addressed through strides, so the kernels read the model's
// [B, T, Fq, C] plane directly: element c of row n at step s lives at
//   (n / rpg) * sg + (n % rpg) * sr + t(s) * ss + c,
// t(s) = s, or S - 1 - s for a reverse walk.  The per-step output and the
// carried hidden h0 / h_last have strides of their own (gru64_walk_io), so
// one walk reads one layout and writes another (the freq-major DPRNN chain
// and its batch-major hidden); gru64_walk keeps x's layout for the output
// and a dense [N, C] hidden.
//
// STEP and LNV select timing-ablation bodies (tools/*_step_ablation.py of
// the port): every default instantiation is the production step.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dpdf {

using bf16 = __nv_bfloat16;

// plane element <-> float32
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) { *p = __float2bfloat16(v); }

constexpr int C = 64;                 // channels == hidden size
constexpr int G3 = 3 * C;             // gate columns r | z | n
constexpr int THREADS = 256;
constexpr int GROUPS = THREADS / C;   // row groups per block

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

struct Rows {
  int64_t rpg, sg, sr, ss;   // row n, step t -> (n/rpg)*sg + (n%rpg)*sr + t*ss
  __device__ __forceinline__ int64_t off(int64_t n, int64_t t) const {
    return (n / rpg) * sg + (n % rpg) * sr + t * ss;
  }
};

// A dense [N, C] hidden: row n at n * C.
__host__ __device__ inline Rows dense_rows(int64_t N) { return Rows{N, 0, C, 0}; }

// Flat row r of a plane -> its offset in another layout:
//   i0 = r / n1, i1 = (r % n1) / n2, i2 = r % n2 -> i0 * s0 + i1 * s1 + i2 * s2.
struct RowMap {
  int64_t n1, n2, s0, s1, s2;
  __device__ __forceinline__ int64_t off(int64_t r) const {
    const int64_t rem = r % n1;
    return (r / n1) * s0 + (rem / n2) * s1 + (rem % n2) * s2;
  }
};

// The identity map of a [rows_total, C] plane.
__host__ __device__ inline RowMap dense_map(int64_t rows_total) { return RowMap{rows_total, 1, 0, C, 0}; }

// Weight element (k, gate, u) at w[(row0 + k) * ld + gate * gstride + col0 + u];
// bias (gate, u) at b[gate * gstride + col0 + u].  Plain GRU weights
// [C, 3C]: ld = 3C, row0 = col0 = 0, gstride = C.  Direction d of the packed
// bidirectional weights [2C, 6C] (gate-major [r_f r_b z_f z_b n_f n_b]):
// ld = 6C, row0 = col0 = d*C, gstride = 2C.
struct GruWeights {
  const float* wi;
  const float* wh;
  const float* bi;
  const float* bh;
  int ld, row0, gstride, col0;
};

template <typename TO>
struct Epilogue {
  const float* wfc;   // [C, C] rows for this walk (HWIO-style [in, out])
  const float* bfc;   // [C] (MODE_LN_RESIDUAL)
  const float* g;     // [C] LayerNorm gain
  const float* bln;   // [C] LayerNorm bias
  TO* out;            // same row addressing as x
  float eps;
};

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

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

// The DPRNN intra epilogue, one warp per (row, f) element of the plane:
// y = part0 + part1 + bfc, out = x + LN(y) * g + bln.  part: [2][rows][C]
// f32 fc partials of the two directions; x: [rows][C]; flat row r of out
// at omap.off(r).  Each lane holds two of the 64 channels.
template <typename TX>
__global__ void __launch_bounds__(256)
dprnn_intra_epilogue_kernel(const TX* __restrict__ x, const float* __restrict__ part,
                            const float* __restrict__ bfc, const float* __restrict__ g,
                            const float* __restrict__ bln, TX* __restrict__ out,
                            int64_t rows_total, RowMap omap) {
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows_total) return;
  const float* p0 = part + r * C;
  const float* p1 = part + rows_total * C + r * C;
  float y0 = (p0[lane] + p1[lane]) + bfc[lane];
  float y1 = (p0[lane + 32] + p1[lane + 32]) + bfc[lane + 32];
  const float mu = warp_sum(y0 + y1) * (1.0f / C);
  y0 -= mu;
  y1 -= mu;
  const float var = warp_sum(y0 * y0 + y1 * y1) * (1.0f / C);
  const float inv = 1.0f / sqrtf(var + 1e-5f);
  TX* o = out + omap.off(r);
  store_f(o + lane, load_f(x + r * C + lane) + (y0 * inv * g[lane] + bln[lane]));
  store_f(o + lane + 32,
          load_f(x + r * C + lane + 32) + (y1 * inv * g[lane + 32] + bln[lane + 32]));
}

template <typename TX>
cudaError_t launch_intra_epilogue(const TX* x, const float* part, const float* bfc,
                                  const float* g, const float* bln, TX* out,
                                  int64_t rows_total, RowMap omap, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows_total + 7) / 8);
  dprnn_intra_epilogue_kernel<TX><<<blocks, 256, 0, stream>>>(x, part, bfc, g, bln, out,
                                                              rows_total, omap);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t launch_intra_epilogue(const TX* x, const float* part, const float* bfc,
                                  const float* g, const float* bln, TX* out,
                                  int64_t rows_total, cudaStream_t stream) {
  return launch_intra_epilogue(x, part, bfc, g, bln, out, rows_total, dense_map(rows_total),
                               stream);
}

}  // namespace dpdf
