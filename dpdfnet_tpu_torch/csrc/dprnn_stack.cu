// A whole DPRNN stack (K dual-path blocks) on Hopper, one time step at a
// time: for every frame t of a stream and every block k,
//
//     cur  = x[b, t]                                    [Fq, C]
//     cur += LN(fc([ys_fw, ys_bw]))   ys = bidirGRU along Fq of cur, from 0
//     h[k] = GRUstep(h[k], cur)                         the time recurrence
//     cur += LN(fc(h[k]))
//     out[b, t] = cur after the last block
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_stack, kernel _stack_kernel
// (TPU).  Same math as K applications of dprnn_intra.cu + dprnn_inter.cu;
// the plane never goes back to device memory between blocks, and one
// launch replaces 2K per-stage launches, which is what a one-frame-per-call
// streaming program pays for.
//
// What bounds it on the H100: per (stream, t, k) about 42 C^2 Fq useful
// FLOPs (intra 28, inter 14) against x read once and out written once,
// plus the h carries: arithmetic on paper, but the intra walk is a chain
// of Fq dependent steps per block, and T and k are sequential too.
//
// Design: one thread block per stream (rows are independent; T and k run
// in order inside the block).  Per (t, k) the block stages each phase's
// weights from L2 into shared memory (16 blocks' weights are ~5.4 MB in
// f32: L2-resident), keeps cur, the intra input projections of both
// directions and both directions' hidden histories in shared memory, and
// reads / writes the inter hiddens (h0 -> h_last, [K, B, Fq, C]) in place
// in device memory.  Phases of one block k:
//   1. x.Wi of both directions for all Fq positions at once (hoisted out
//      of the walk: a parallel product, no recurrence);
//   2. the walk: 128 threads = 2 directions x 64 units, one step per
//      barrier, h.Wh from shared memory;
//   3. fc [2C -> C] + LayerNorm + residual, one warp per frequency row;
//   4. one inter GRU step + fc + LayerNorm + residual, one warp per row.
// Every reduction runs in a fixed order that depends on nothing but the
// row's own data, so a row's result does not depend on B or T.  x / out are
// float32 or bfloat16 (each frame's row is upcast into shared memory and
// rounded once on the way out); h0 / h_last, the weights and all
// arithmetic are float32.
#include "gru64_walk.cuh"

using namespace dpdf;

namespace {

constexpr int ST_THREADS = 256;
constexpr int WARPS = ST_THREADS / 32;
constexpr int FQ_MAX = 50;                           // shared memory limit
constexpr int W_FLOATS = 2 * C * G3 + C * C;         // largest staged phase

struct StackW {   // per-block weights stacked on a leading K axis (pack_stack)
  const float *wi2, *wh2, *b2, *wfc_i, *bfc_i, *g_i, *bln_i;
  const float *wi_t, *wh_t, *b2_t, *wfc_t, *bfc_t, *g_t, *bln_t;
};

__host__ __device__ constexpr int stack_smem_floats(int Fq) {
  // sw, sxp [2][Fq][G3], scur [Fq][C], sys [2][Fq][C], shb [2][2][C]
  return W_FLOATS + 2 * Fq * G3 + Fq * C + 2 * Fq * C + 4 * C;
}

__device__ __forceinline__ void copy_f4(float* __restrict__ dst, const float* __restrict__ src,
                                        int n) {
  for (int i = threadIdx.x; i < n / 4; i += ST_THREADS)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}

// A plane row of n floats (n % 4 == 0) into shared f32 and back, in float4
// groups with copy_f4's group-to-thread mapping.
__device__ __forceinline__ void load_row(float* __restrict__ dst, const float* __restrict__ src,
                                         int n) {
  copy_f4(dst, src, n);
}
__device__ __forceinline__ void load_row(float* __restrict__ dst, const bf16* __restrict__ src,
                                         int n) {
  const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(src);
  for (int i = threadIdx.x; i < n / 4; i += ST_THREADS) {
    const float2 a = __bfloat1622float2(s2[2 * i]), b = __bfloat1622float2(s2[2 * i + 1]);
    reinterpret_cast<float4*>(dst)[i] = make_float4(a.x, a.y, b.x, b.y);
  }
}
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float* __restrict__ src,
                                          int n) {
  copy_f4(dst, src, n);
}
__device__ __forceinline__ void store_row(bf16* __restrict__ dst, const float* __restrict__ src,
                                          int n) {
  __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(dst);
  for (int i = threadIdx.x; i < n / 4; i += ST_THREADS) {
    const float4 v = reinterpret_cast<const float4*>(src)[i];
    d2[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    d2[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// Direction d's useful [C][G3] block of a packed [2C][6C] weight
// (gate-major columns [r_f r_b z_f z_b n_f n_b]) -> sw[d][c][g * C + u].
__device__ __forceinline__ void stage_dirs(float* __restrict__ sw,
                                           const float* __restrict__ w2) {
  for (int i = threadIdx.x; i < 2 * C * G3; i += ST_THREADS) {
    const int d = i / (C * G3), r = i % (C * G3), c = r / G3, j = r % G3;
    sw[i] = w2[(d * C + c) * (6 * C) + (j / C) * (2 * C) + d * C + j % C];
  }
}

// LayerNorm of one row held as two values per lane (units lane, lane + 32),
// added to the residual row res[0..C).
__device__ __forceinline__ void ln_residual(float y0, float y1, float* __restrict__ res,
                                            const float* __restrict__ g,
                                            const float* __restrict__ bln, int lane) {
  const float mu = warp_sum(y0 + y1) * (1.0f / C);
  const float d0 = y0 - mu, d1 = y1 - mu;
  const float var = warp_sum(d0 * d0 + d1 * d1) * (1.0f / C);
  const float inv = 1.0f / sqrtf(var + 1e-5f);
  res[lane] = res[lane] + (d0 * inv * g[lane] + bln[lane]);
  res[lane + 32] = res[lane + 32] + (d1 * inv * g[lane + 32] + bln[lane + 32]);
}

// RPW = rows of the frequency axis per warp (ceil(Fq / 8)).
template <int RPW, typename TX>
__global__ void __launch_bounds__(ST_THREADS, 1)
dprnn_stack_kernel(const TX* __restrict__ x, TX* __restrict__ out,
                   const float* __restrict__ h0, float* __restrict__ h_last, StackW w,
                   int B, int T, int Fq, int K) {
  extern __shared__ __align__(16) float smem[];
  float* sw = smem;                      // staged weights of the current phase
  float* sxp = sw + W_FLOATS;            // intra x.Wi + bi [2][Fq][G3]; inter h / h_new
  float* scur = sxp + 2 * Fq * G3;       // the plane row of this (b, t) [Fq][C]
  float* sys = scur + Fq * C;            // intra hidden histories [2][Fq][C]
  float* shb = sys + 2 * Fq * C;         // walk hiddens [2 ping-pong][2 dir][C]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x;
  const int64_t frame = (int64_t)Fq * C;
  const int64_t carry = (int64_t)B * frame;           // one block's [B, Fq, C]

  for (int t = 0; t < T; ++t) {
    load_row(scur, x + ((int64_t)b * T + t) * frame, Fq * C);
    for (int k = 0; k < K; ++k) {
      const float* b2 = w.b2 + (int64_t)k * 2 * 6 * C;
      // ---- 1. intra input projections, both directions, all positions ----
      __syncthreads();                                  // sw / scur free
      stage_dirs(sw, w.wi2 + (int64_t)k * 2 * C * 6 * C);
      __syncthreads();
      for (int d = 0; d < 2; ++d) {
        const float* wd = sw + d * C * G3;
        float acc[RPW][6];
#pragma unroll
        for (int r = 0; r < RPW; ++r)
#pragma unroll
          for (int m = 0; m < 6; ++m) acc[r][m] = 0.0f;
        for (int c = 0; c < C; c += 4) {
          float4 xv[RPW];
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int f = min(warp + WARPS * r, Fq - 1);
            xv[r] = *reinterpret_cast<const float4*>(&scur[f * C + c]);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            float wv[6];
#pragma unroll
            for (int m = 0; m < 6; ++m) wv[m] = wd[(c + kk) * G3 + lane + 32 * m];
#pragma unroll
            for (int r = 0; r < RPW; ++r)
#pragma unroll
              for (int m = 0; m < 6; ++m) acc[r][m] = fmaf((&xv[r].x)[kk], wv[m], acc[r][m]);
          }
        }
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int f = warp + WARPS * r;
          if (f < Fq) {
#pragma unroll
            for (int m = 0; m < 6; ++m) {
              const int j = lane + 32 * m;
              sxp[(d * Fq + f) * G3 + j] = acc[r][m] + b2[(j / C) * (2 * C) + d * C + j % C];
            }
          }
        }
      }
      // ---- 2. the bidirectional walk along Fq ----
      __syncthreads();                                  // sw (Wi) reads done
      stage_dirs(sw, w.wh2 + (int64_t)k * 2 * C * 6 * C);
      const int d = tid / C, u = tid % C;               // walk threads: tid < 2C
      float bhr = 0.0f, bhz = 0.0f, bhn = 0.0f;
      if (tid < 2 * C) {
        const float* bh = b2 + 6 * C + d * C + u;
        bhr = bh[0];
        bhz = bh[2 * C];
        bhn = bh[4 * C];
        shb[d * C + u] = 0.0f;
      }
      __syncthreads();
      for (int s = 0; s < Fq; ++s) {
        if (tid < 2 * C) {
          const int f = d == 0 ? s : Fq - 1 - s;
          const float* h = shb + ((s & 1) * 2 + d) * C;
          const float* wd = sw + d * C * G3;
          float ar0 = 0.0f, az0 = 0.0f, an0 = 0.0f, ar1 = 0.0f, az1 = 0.0f, an1 = 0.0f;
          for (int c = 0; c < C; c += 4) {
            const float4 hv = *reinterpret_cast<const float4*>(&h[c]);
            const float* w0 = wd + c * G3 + u;
            ar0 = fmaf(hv.x, w0[0], ar0);
            az0 = fmaf(hv.x, w0[C], az0);
            an0 = fmaf(hv.x, w0[2 * C], an0);
            ar1 = fmaf(hv.y, w0[G3], ar1);
            az1 = fmaf(hv.y, w0[G3 + C], az1);
            an1 = fmaf(hv.y, w0[G3 + 2 * C], an1);
            ar0 = fmaf(hv.z, w0[2 * G3], ar0);
            az0 = fmaf(hv.z, w0[2 * G3 + C], az0);
            an0 = fmaf(hv.z, w0[2 * G3 + 2 * C], an0);
            ar1 = fmaf(hv.w, w0[3 * G3], ar1);
            az1 = fmaf(hv.w, w0[3 * G3 + C], az1);
            an1 = fmaf(hv.w, w0[3 * G3 + 2 * C], an1);
          }
          const float* xp = sxp + (d * Fq + f) * G3;
          const float rg = sigmoid_f(xp[u] + ((ar0 + ar1) + bhr));
          const float zg = sigmoid_f(xp[C + u] + ((az0 + az1) + bhz));
          const float ng = tanhf(xp[2 * C + u] + rg * ((an0 + an1) + bhn));
          const float hn = (1.0f - zg) * ng + zg * h[u];
          shb[(((s + 1) & 1) * 2 + d) * C + u] = hn;
          sys[(d * Fq + f) * C + u] = hn;
        }
        __syncthreads();
      }
      // ---- 3. intra fc [2C -> C] + LayerNorm + residual ----
      copy_f4(sw, w.wfc_i + (int64_t)k * 2 * C * C, 2 * C * C);
      __syncthreads();
      {
        float y[RPW][2];
#pragma unroll
        for (int r = 0; r < RPW; ++r) y[r][0] = y[r][1] = 0.0f;
        for (int dd = 0; dd < 2; ++dd) {
          const float* wf = sw + dd * C * C;
          for (int c = 0; c < C; c += 4) {
            float4 yv[RPW];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
              const int f = min(warp + WARPS * r, Fq - 1);
              yv[r] = *reinterpret_cast<const float4*>(&sys[(dd * Fq + f) * C + c]);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const float w0 = wf[(c + kk) * C + lane], w1 = wf[(c + kk) * C + lane + 32];
#pragma unroll
              for (int r = 0; r < RPW; ++r) {
                y[r][0] = fmaf((&yv[r].x)[kk], w0, y[r][0]);
                y[r][1] = fmaf((&yv[r].x)[kk], w1, y[r][1]);
              }
            }
          }
        }
        const float* bfc = w.bfc_i + k * C;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int f = warp + WARPS * r;
          if (f < Fq)
            ln_residual(y[r][0] + bfc[lane], y[r][1] + bfc[lane + 32], scur + f * C,
                        w.g_i + k * C, w.bln_i + k * C, lane);
        }
      }
      // ---- 4. one inter GRU step + fc + LayerNorm + residual ----
      __syncthreads();                                  // sw (Wfc_i) reads done
      copy_f4(sw, w.wi_t + (int64_t)k * C * G3, C * G3);
      copy_f4(sw + C * G3, w.wh_t + (int64_t)k * C * G3, C * G3);
      copy_f4(sw + 2 * C * G3, w.wfc_t + (int64_t)k * C * C, C * C);
      float* sh = sxp;                                  // h rows [Fq][C]
      float* shn = sxp + Fq * C;                        // new h rows [Fq][C]
      copy_f4(sh, (t == 0 ? h0 : h_last) + k * carry + b * frame, Fq * C);
      __syncthreads();
      {
        const float* bi = w.b2_t + (int64_t)k * 2 * G3;
        const float* bh = bi + G3;
        const float* wi = sw;
        const float* wh = sw + C * G3;
        const float* wfc = sw + 2 * C * G3;
        constexpr int RC = RPW < 3 ? RPW : 3;           // rows per pass
#pragma unroll
        for (int r0 = 0; r0 < RPW; r0 += RC) {
          float ax[RC][3][2], ah[RC][3][2];
#pragma unroll
          for (int r = 0; r < RC; ++r)
#pragma unroll
            for (int g = 0; g < 3; ++g) ax[r][g][0] = ax[r][g][1] = ah[r][g][0] = ah[r][g][1] = 0.0f;
          for (int c = 0; c < C; c += 4) {
            float4 xv[RC], hv[RC];
#pragma unroll
            for (int r = 0; r < RC; ++r) {
              const int f = min(warp + WARPS * (r0 + r), Fq - 1);
              xv[r] = *reinterpret_cast<const float4*>(&scur[f * C + c]);
              hv[r] = *reinterpret_cast<const float4*>(&sh[f * C + c]);
            }
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
              for (int g = 0; g < 3; ++g) {
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                  const float wiv = wi[(c + kk) * G3 + g * C + lane + 32 * q];
                  const float whv = wh[(c + kk) * G3 + g * C + lane + 32 * q];
#pragma unroll
                  for (int r = 0; r < RC; ++r) {
                    ax[r][g][q] = fmaf((&xv[r].x)[kk], wiv, ax[r][g][q]);
                    ah[r][g][q] = fmaf((&hv[r].x)[kk], whv, ah[r][g][q]);
                  }
                }
              }
            }
          }
#pragma unroll
          for (int r = 0; r < RC; ++r) {
            const int f = warp + WARPS * (r0 + r);
            if (r0 + r < RPW && f < Fq) {
#pragma unroll
              for (int q = 0; q < 2; ++q) {
                const int uu = lane + 32 * q;
                const float rg = sigmoid_f((ax[r][0][q] + bi[uu]) + (ah[r][0][q] + bh[uu]));
                const float zg = sigmoid_f((ax[r][1][q] + bi[C + uu]) + (ah[r][1][q] + bh[C + uu]));
                const float ng = tanhf((ax[r][2][q] + bi[2 * C + uu])
                                       + rg * (ah[r][2][q] + bh[2 * C + uu]));
                const float hn = (1.0f - zg) * ng + zg * sh[f * C + uu];
                shn[f * C + uu] = hn;
                h_last[k * carry + b * frame + f * C + uu] = hn;
              }
            }
          }
        }
        __syncwarp();                                   // this warp's shn rows
        float y[RPW][2];
#pragma unroll
        for (int r = 0; r < RPW; ++r) y[r][0] = y[r][1] = 0.0f;
        for (int c = 0; c < C; c += 4) {
          float4 hv[RPW];
#pragma unroll
          for (int r = 0; r < RPW; ++r) {
            const int f = min(warp + WARPS * r, Fq - 1);
            hv[r] = *reinterpret_cast<const float4*>(&shn[f * C + c]);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float w0 = wfc[(c + kk) * C + lane], w1 = wfc[(c + kk) * C + lane + 32];
#pragma unroll
            for (int r = 0; r < RPW; ++r) {
              y[r][0] = fmaf((&hv[r].x)[kk], w0, y[r][0]);
              y[r][1] = fmaf((&hv[r].x)[kk], w1, y[r][1]);
            }
          }
        }
        const float* bfc = w.bfc_t + k * C;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const int f = warp + WARPS * r;
          if (f < Fq)
            ln_residual(y[r][0] + bfc[lane], y[r][1] + bfc[lane + 32], scur + f * C,
                        w.g_t + k * C, w.bln_t + k * C, lane);
        }
      }
    }
    __syncthreads();
    // same float4-group-to-thread mapping as load_row, so the next frame's
    // load into scur only overwrites what this thread has already stored
    store_row(out + ((int64_t)b * T + t) * frame, scur, Fq * C);
  }
}

template <int RPW, typename TX>
cudaError_t launch(const TX* x, TX* out, const float* h0, float* h_last,
                   const StackW& w, int B, int T, int Fq, int K, cudaStream_t stream) {
  const size_t smem = sizeof(float) * stack_smem_floats(Fq);
  cudaError_t err = cudaFuncSetAttribute(dprnn_stack_kernel<RPW, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dprnn_stack_kernel<RPW, TX><<<B, ST_THREADS, smem, stream>>>(x, out, h0, h_last, w, B, T,
                                                                Fq, K);
  return cudaGetLastError();
}

template <typename TX>
cudaError_t run(const TX* x, TX* out, const float* h0, float* h_last, const StackW& w, int B,
                int T, int Fq, int K, cudaStream_t st) {
  switch ((Fq + WARPS - 1) / WARPS) {
    case 1: return launch<1>(x, out, h0, h_last, w, B, T, Fq, K, st);
    case 2: return launch<2>(x, out, h0, h_last, w, B, T, Fq, K, st);
    case 3: return launch<3>(x, out, h0, h_last, w, B, T, Fq, K, st);
    case 4: return launch<4>(x, out, h0, h_last, w, B, T, Fq, K, st);
    case 5: return launch<5>(x, out, h0, h_last, w, B, T, Fq, K, st);
    case 6: return launch<6>(x, out, h0, h_last, w, B, T, Fq, K, st);
    case 7:
      if (Fq <= FQ_MAX) return launch<7>(x, out, h0, h_last, w, B, T, Fq, K, st);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x, out: [B, T, Fq, C], float32, or bfloat16 when plane_bf16; h0, h_last:
// [K, B, Fq, C] float32; weights as pack_stack
// lays them out (wi2 / wh2 [K, 2C, 6C], b2 [K, 2, 6C], wfc_i [K, 2C, C],
// bfc_i / g_i / bln_i [K, 1, C], wi_t / wh_t [K, C, 3C], b2_t [K, 2, 3C],
// wfc_t [K, C, C], bfc_t / g_t / bln_t [K, 1, C]); all contiguous f32.
// Returns a cudaError_t; 1 (cudaErrorInvalidValue) for Fq outside [1, 50].
extern "C" int dprnn_stack_launch(const void* x, void* out, const float* h0, float* h_last,
                                  const float* wi2, const float* wh2, const float* b2,
                                  const float* wfc_i, const float* bfc_i, const float* g_i,
                                  const float* bln_i, const float* wi_t, const float* wh_t,
                                  const float* b2_t, const float* wfc_t, const float* bfc_t,
                                  const float* g_t, const float* bln_t, int B, int T, int Fq,
                                  int K, int plane_bf16, void* stream) {
  const StackW w{wi2, wh2, b2, wfc_i, bfc_i, g_i, bln_i,
                 wi_t, wh_t, b2_t, wfc_t, bfc_t, g_t, bln_t};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(out), h0, h_last, w, B, T,
                    Fq, K, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), h0, h_last, w, B, T,
                  Fq, K, st);
}
