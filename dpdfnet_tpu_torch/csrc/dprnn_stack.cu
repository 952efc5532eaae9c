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
// (TPU), whose definition is K applications of the intra and inter block
// kernels with the same per-step op sequence.  Here that holds bit for
// bit: on float32 planes out and h_last are bit-identical to K
// applications of dprnn_intra.cu + dprnn_inter.cu, frame by frame.  Every
// column of every product is one fmaf chain from 0 with k ascending (the
// chain of gru64_warp.cuh's products), the gates are gru_unit, the intra
// fc is the forward partial plus the backward partial plus the bias, and
// the LayerNorms are ln_store with lane l holding units l and l + 32.  On
// bfloat16 planes the stack computes in float32 throughout and rounds
// once on the way out (the JAX kernel's meaning), so there it is held to
// its plain version, not to the per-stage chain.  One launch replaces 2K
// per-stage launches, which is what a one-frame-per-call streaming
// program pays for.
//
// What bounds it on the H100: per (stream, t, k) about 42 C^2 Fq useful
// FLOPs (intra 28, inter 14) against x read once and out written once,
// plus the h carries: arithmetic on paper, but the intra walk is a chain
// of Fq dependent steps per block, each step a 64-deep fmaf chain per
// column plus the gates, and T and k are sequential too.
//
// Design: per stream either one 256-thread CTA (CL = 1) or a two-CTA
// thread-block cluster (CL = 2, CTA rank r walking direction r), picked by
// gru_kernels.stack_plan: the cluster while every stream's pair is
// resident at once.  Streams are independent; t and k run in order.  The
// plane row of (b, t) stays in shared memory (each CTA of a cluster holds
// all of it) for all K blocks.  Per (t, k):
//   1. x . Wi_d + bi_d of the walk's direction(s) at every position: each
//      thread loads one column's 64 weights from L2 into registers and
//      runs it over its rows;
//   2. the walk along Fq.  A direction is 4 warps (one per SM
//      sub-partition); a lane pair owns one hidden unit, the even lane its
//      r and z columns, the odd lane its n and fc columns of
//      [Wh_d | Wfc_d], 128 weights per lane held in registers for the whole
//      walk.  Per step each lane runs its two 64-deep chains over h (float4
//      broadcasts from shared memory), one shuffle hands n to the even
//      lane, which runs gru_unit (its xp read before the chain) and writes
//      h_new into its direction's double-buffered slice, and the
//      direction's 128 threads meet at a named barrier: no block barrier
//      and no weight traffic inside the walk.  CL = 2: meanwhile warps 4-7
//      also compute their CTA's half of the inter h . Wh columns;
//   3. the intra epilogue, one warp per position (two positions per pass):
//      ln_store of the two directions' fc partials plus bfc, added to the
//      row in place (CL = 2: each CTA the whole row, after the partials
//      were exchanged through distributed shared memory);
//   4. the inter step: x . Wi + bi and h . Wh (CL = 2: each CTA half the
//      columns, written to both), gru_unit per (position, unit) (CL = 2:
//      each CTA half the positions), the new hidden to h_last, its fc
//      (64 columns, split likewise), and ln_store per position.
// Phases meet at block (CL = 1) or cluster (CL = 2) barriers, five to seven
// per (t, k), none inside the walk.  The weights of all K blocks stay
// L2-resident (5.4 MB per branch).  h0 / h_last ([K, B, Fq, C]) are read
// (past L1: the peer CTA writes half of them) and written in place in
// device memory; x / out are float32 or bfloat16 (each frame's row is
// upcast into shared memory and rounded once on the way out).
#include <cooperative_groups.h>

#include "gru64_warp.cuh"

namespace cg = cooperative_groups;
using namespace dpdf;

namespace {

constexpr int ST_THREADS = 256;
constexpr int WARPS = ST_THREADS / 32;
constexpr int DIR_THREADS = ST_THREADS / 2;          // the walk: 4 warps per direction
constexpr int FQ_MAX = 50;                           // gru_kernels._STACK_FQ_MAX
constexpr int RG = 4;                                // rows per pass of a column

struct StackW {   // per-block weights stacked on a leading K axis (pack_stack)
  const float *wi2, *wh2, *b2, *wfc_i, *bfc_i, *g_i, *bln_i;
  const float *wi_t, *wh_t, *b2_t, *wfc_t, *bfc_t, *g_t, *bln_t;
};

__host__ __device__ constexpr int stack_smem_floats(int Fq) {
  // scur [Fq][C], sxp [2][Fq][G3], spart [2][Fq][C], sh [Fq][C], shb [2][2][C]
  return Fq * C + 2 * Fq * G3 + 2 * Fq * C + Fq * C + 4 * C;
}

// One column of a product over rows [r0, r1): out[r * ldo] = in[r] . w
// (+ *bias), in[r] the C floats at in + r * C in shared memory, w the
// column's C weights at w[k * ldw] in device memory (loaded into registers
// once).  Each row is one fmaf chain from 0 with k ascending, the chain of
// gru64_warp.cuh's products; the bias is added after it, as the walk adds
// bi to its hoisted x . Wi.  out2 (the cluster peer's copy) may be null.
__device__ __forceinline__ void column(const float* __restrict__ w, int ldw,
                                       const float* __restrict__ in, int r0, int r1,
                                       const float* __restrict__ bias, float* __restrict__ out,
                                       float* __restrict__ out2, int ldo) {
  if (r0 >= r1) return;
  float wc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) wc[k] = __ldg(w + k * ldw);
  const float bv = bias != nullptr ? __ldg(bias) : 0.0f;
  for (int r = r0; r < r1; r += RG) {
    float a[RG];
    const float* xr[RG];
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      a[i] = 0.0f;
      xr[i] = in + min(r + i, r1 - 1) * C;
    }
#pragma unroll
    for (int k = 0; k < C; k += 4) {
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(xr[i] + k);
        a[i] = fmaf(v.x, wc[k], a[i]);
        a[i] = fmaf(v.y, wc[k + 1], a[i]);
        a[i] = fmaf(v.z, wc[k + 2], a[i]);
        a[i] = fmaf(v.w, wc[k + 3], a[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RG; ++i)
      if (r + i < r1) {
        const float v = bias != nullptr ? a[i] + bv : a[i];
        out[(r + i) * ldo] = v;
        if (out2 != nullptr) out2[(r + i) * ldo] = v;
      }
  }
}

// Columns [0, ncols) over rows [0, nrows) on NT threads (t = 0 .. NT - 1):
// one whole column per thread while NT columns remain, then the rest
// (a multiple of 32 columns) as (column, row part) tasks, the rows split in
// NT / gcd(rest, NT) parts so every thread gets the same number of tasks.
// A warp's threads share one row range, so the row loads are broadcasts.
// col(c, r0, r1).
template <int NT, typename Col>
__device__ __forceinline__ void columns(int ncols, int nrows, int t, Col col) {
  int c0 = 0;
  for (; c0 + NT <= ncols; c0 += NT) col(c0 + t, 0, nrows);
  const int rem = ncols - c0;
  if (rem > 0) {
    int a = rem, b = NT;
    while (b != 0) {
      const int m = a % b;
      a = b;
      b = m;
    }
    const int parts = NT / a, per = (nrows + parts - 1) / parts;
    for (int i = t; i < rem * parts; i += NT) {
      const int r0 = min(i / rem * per, nrows);
      col(c0 + i % rem, r0, min(r0 + per, nrows));
    }
  }
}

// The LayerNorm parameters of ln_store for lane (units lane, lane + 32).
__device__ __forceinline__ ww::LaneParams ln_params(const float* bfc, const float* g,
                                                    const float* bln, int lane) {
  ww::LaneParams p = {};
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    p.fcb[q] = bfc[lane + 32 * q];
    p.gain[q] = g[lane + 32 * q];
    p.shift[q] = bln[lane + 32 * q];
  }
  return p;
}

// The 128 threads of one named barrier.
__device__ __forceinline__ void group_barrier(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(DIR_THREADS) : "memory");
}

#ifdef DPDF_STACK_PHASES
// tools/stack_phases.py: clock64 stamps at the phase boundaries, summed
// over the calls by thread 0 of CTA 0 (compiled out of the production build).
__device__ unsigned long long g_phase_cycles[9];
#define PHASE_START long long phase_last = clock64();
#define PHASE(i)                                                                    \
  if (threadIdx.x == 0 && blockIdx.x == 0) {                                        \
    const long long c = clock64();                                                  \
    atomicAdd(&g_phase_cycles[i], (unsigned long long)(c - phase_last));            \
    phase_last = c;                                                                 \
  }
#else
#define PHASE_START
#define PHASE(i)
#endif

// CL = 1: one CTA per stream runs both directions.  CL = 2: a two-CTA
// cluster per stream, CTA rank r walking direction r; see the file notes.
template <int CL, typename TX>
__global__ void __launch_bounds__(ST_THREADS, 1)
dprnn_stack_kernel(const TX* __restrict__ x, TX* __restrict__ out,
                   const float* __restrict__ h0, float* __restrict__ h_last, StackW w, int B,
                   int T, int Fq, int K) {
  extern __shared__ __align__(16) float smem[];
  float* scur = smem;                    // the plane row of (b, t) [Fq][C]
  float* sxp = scur + Fq * C;            // intra x.Wi_d + bi_d [2][Fq][G3]; inter [x.Wi + bi | h.Wh]
  float* spart = sxp + 2 * Fq * G3;      // intra fc partials [2][Fq][C]; inter [h_new | fc]
  float* sh = spart + 2 * Fq * C;        // inter h[k] rows [Fq][C]
  float* shb = sh + Fq * C;              // walk hiddens [2 dir][2 ping-pong][C]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int rank = 0;
  float* peer = nullptr;                 // the cluster peer's shared memory (CL = 2)
  if constexpr (CL == 2) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = (int)cluster.block_rank();
    peer = cluster.map_shared_rank(smem, rank ^ 1);
  }
  // mirror of an address of this CTA's shared memory in the peer's (or null)
  auto mirror = [&](float* a) -> float* { return CL == 2 ? peer + (a - smem) : nullptr; };
  auto sync_all = [&]() {
    if constexpr (CL == 2) cg::this_cluster().sync();
    else __syncthreads();
  };
  const int b = blockIdx.x / CL;
  // the walk: direction d, unit u; the even lane runs columns r, z, the odd
  // n, fc.  CL = 2: warps 0-3 walk direction rank, warps 4-7 help.
  const bool walker = CL == 1 || tid < DIR_THREADS;
  const int d = CL == 1 ? tid / DIR_THREADS : rank;
  const int u = (tid % DIR_THREADS) / 2;
  const bool odd = (lane & 1) != 0;
  float* sxpd = sxp + (CL == 1 ? d : 0) * Fq * G3;    // the walk's xp
  const int64_t frame = (int64_t)Fq * C;
  const int64_t carry = (int64_t)B * frame;           // one block's [B, Fq, C]
  // CL = 2: this CTA's half of the positions (inter gates, the output store)
  const int hf = (Fq + 1) / 2;
  const int lo = CL == 2 && rank == 1 ? hf * C : 0;
  const int hi = CL == 2 && rank == 0 ? hf * C : Fq * C;
  PHASE_START

  for (int t = 0; t < T; ++t) {
    const TX* xt = x + ((int64_t)b * T + t) * frame;
    // same element-to-thread map as the store below: no barrier between them
    for (int i = tid; i < Fq * C; i += ST_THREADS) scur[i] = load_f(xt + i);
    for (int k = 0; k < K; ++k) {
      const float* wi2 = w.wi2 + (int64_t)k * 2 * C * 6 * C;
      const float* wh2 = w.wh2 + (int64_t)k * 2 * C * 6 * C;
      const float* b2 = w.b2 + (int64_t)k * 2 * 6 * C;
      const float* hsrc = (t == 0 ? h0 : h_last) + k * carry + b * frame;
      sync_all();                                       // scur complete; the peer is done with k - 1
      PHASE(0)
      // ---- 1. intra x . Wi_d + bi_d at every position (CL = 2: direction rank) ----
      columns<ST_THREADS>(2 * G3 / CL, Fq, tid, [&](int c, int r0, int r1) {
        const int dd = CL == 1 ? c / G3 : rank, j = c % G3;
        const int col = (j / C) * 2 * C + dd * C + j % C;
        column(wi2 + (int64_t)dd * C * 6 * C + col, 6 * C, scur, r0, r1, b2 + col,
               sxp + (CL == 1 ? dd : 0) * Fq * G3 + j, nullptr, G3);
      });
      // this lane's two columns of [Wh_d | Wfc_d], k = 0 .. C - 1
      float wa[C], wb[C];
      if (walker) {
        const float* whd = wh2 + (int64_t)d * C * 6 * C + d * C + u;
        const float* pa = whd + (odd ? 4 * C : 0);                       // n : r
        const float* pb = odd ? w.wfc_i + (int64_t)k * 2 * C * C + (int64_t)d * C * C + u
                              : whd + 2 * C;                             // fc : z
        const int lb = odd ? C : 6 * C;
#pragma unroll
        for (int kk = 0; kk < C; ++kk) {
          wa[kk] = __ldg(pa + kk * 6 * C);
          wb[kk] = __ldg(pb + kk * lb);
        }
      }
      __syncthreads();                                  // the walk's xp is in sxp
      PHASE(1)
      if (walker) {
        // ---- 2. the walk along Fq of direction d ----
        const float* bh = b2 + 6 * C + d * C + u;
        const float bhr = bh[0], bhz = bh[2 * C], bhn = bh[4 * C];
        float* hb = shb + d * 2 * C;
        float h = 0.0f;
        int fp = 0;                                     // the previous step's position
        for (int s = 0; s <= Fq; ++s) {
          // this step's xp (read ahead of the chain, whose latency hides it)
          const int f = d == 0 ? s : Fq - 1 - s;
          float xr = 0.0f, xz = 0.0f, xn = 0.0f;
          if (!odd && s < Fq) {
            const float* xp = sxpd + f * G3;
            xr = xp[u];
            xz = xp[C + u];
            xn = xp[2 * C + u];
          }
          // h_{s-1} . [this lane's two columns]; zero before the first step
          float a0 = 0.0f, a1 = 0.0f;
          if (s > 0) {
            const float* hs = hb + (s & 1) * C;
#pragma unroll
            for (int kk = 0; kk < C; kk += 4) {
              const float4 v = *reinterpret_cast<const float4*>(hs + kk);
              a0 = fmaf(v.x, wa[kk], a0);
              a1 = fmaf(v.x, wb[kk], a1);
              a0 = fmaf(v.y, wa[kk + 1], a0);
              a1 = fmaf(v.y, wb[kk + 1], a1);
              a0 = fmaf(v.z, wa[kk + 2], a0);
              a1 = fmaf(v.z, wb[kk + 2], a1);
              a0 = fmaf(v.w, wa[kk + 3], a0);
              a1 = fmaf(v.w, wb[kk + 3], a1);
            }
          }
          const float an = __shfl_xor_sync(0xffffffffu, a0, 1);   // n, to the even lane
          if (s == Fq) {
            if (odd) spart[(d * Fq + fp) * C + u] = a1;
            break;
          }
          if (!odd) {
            h = ww::gru_unit(xr, xz, xn, a0, a1, an, bhr, bhz, bhn, h);
            hb[((s + 1) & 1) * C + u] = h;
          } else if (s > 0) {
            spart[(d * Fq + fp) * C + u] = a1;                    // position fp's fc partial
          }
          fp = f;
          group_barrier(1 + (CL == 1 ? d : 0));
        }
        if constexpr (CL == 2) {
          // this direction's partials to the peer, once the walk is done
          group_barrier(1);
          float4* dst = reinterpret_cast<float4*>(mirror(spart + d * Fq * C));
          const float4* src = reinterpret_cast<const float4*>(spart + d * Fq * C);
          for (int i = tid; i < Fq * C / 4; i += DIR_THREADS) dst[i] = src[i];
        }
        PHASE(2)
      }
      if constexpr (CL == 2) {
        if (!walker) {
          // warps 4-7 meanwhile: the h[k] rows, then this CTA's half of the
          // inter h . Wh columns (96 of 192) for both CTAs
          const int ht = tid - DIR_THREADS;
          for (int i = ht; i < Fq * C / 4; i += DIR_THREADS)
            reinterpret_cast<float4*>(sh)[i] = __ldcg(reinterpret_cast<const float4*>(hsrc) + i);
          group_barrier(2);
          columns<DIR_THREADS>(G3 / 2, Fq, ht, [&](int c, int r0, int r1) {
            const int j = rank * (G3 / 2) + c;
            float* o = sxp + Fq * G3 + j;
            column(w.wh_t + (int64_t)k * C * G3 + j, G3, sh, r0, r1, nullptr, o, mirror(o), G3);
          });
        }
      } else {
        // the inter h[k] rows, read while the other direction may still walk
        for (int i = tid; i < Fq * C / 4; i += ST_THREADS)
          reinterpret_cast<float4*>(sh)[i] = __ldcg(reinterpret_cast<const float4*>(hsrc) + i);
      }
      sync_all();                                       // both directions' partials stored
      PHASE(3)
      // ---- 3. intra epilogue: x + LN(fc_fw + fc_bw + bfc), a warp per position ----
      {
        const ww::LaneParams p = ln_params(w.bfc_i + k * C, w.g_i + k * C, w.bln_i + k * C, lane);
        // two positions per pass, so one's loads overlap the other's sums
        for (int f0 = warp; f0 < Fq; f0 += 2 * WARPS) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = f0 + e * WARPS;
            if (f < Fq) {
              float* xf = scur + f * C;
              const float* pf = spart + f * C;
              const float* pbk = spart + (Fq + f) * C;
              ww::ln_store(pf[lane] + pbk[lane], pf[lane + 32] + pbk[lane + 32], xf[lane],
                           xf[lane + 32], p, xf, lane);
            }
          }
        }
      }
      __syncthreads();                                  // scur and sh complete
      PHASE(4)
      // ---- 4. the inter step: x . Wi + bi (and, CL = 1, h . Wh) of every position ----
      if constexpr (CL == 1) {
        columns<ST_THREADS>(2 * G3, Fq, tid, [&](int c, int r0, int r1) {
          if (c < G3)
            column(w.wi_t + (int64_t)k * C * G3 + c, G3, scur, r0, r1,
                   w.b2_t + (int64_t)k * 2 * G3 + c, sxp + c, nullptr, G3);
          else
            column(w.wh_t + (int64_t)k * C * G3 + (c - G3), G3, sh, r0, r1, nullptr,
                   sxp + Fq * G3 + (c - G3), nullptr, G3);
        });
      } else {
        columns<ST_THREADS>(G3 / 2, Fq, tid, [&](int c, int r0, int r1) {
          const int j = rank * (G3 / 2) + c;
          column(w.wi_t + (int64_t)k * C * G3 + j, G3, scur, r0, r1,
                 w.b2_t + (int64_t)k * 2 * G3 + j, sxp + j, mirror(sxp + j), G3);
        });
      }
      sync_all();
      PHASE(5)
      {
        const float* bh = w.b2_t + (int64_t)k * 2 * G3 + G3;
        float* hl = h_last + k * carry + b * frame;
#pragma unroll 2
        for (int i = lo + tid; i < hi; i += ST_THREADS) {
          const int f = i / C, uu = i % C;
          const float* xp = sxp + f * G3;
          const float* ah = sxp + (Fq + f) * G3;
          const float hn = ww::gru_unit(xp[uu], xp[C + uu], xp[2 * C + uu], ah[uu],
                                        ah[C + uu], ah[2 * C + uu], bh[uu], bh[C + uu],
                                        bh[2 * C + uu], sh[i]);
          spart[i] = hn;
          if constexpr (CL == 2) *mirror(spart + i) = hn;
          hl[i] = hn;
        }
      }
      sync_all();
      PHASE(6)
      columns<ST_THREADS>(C / CL, Fq, tid, [&](int c, int r0, int r1) {
        const int j = rank * (C / CL) + c;
        float* o = spart + Fq * C + j;
        column(w.wfc_t + (int64_t)k * C * C + j, C, spart, r0, r1, nullptr, o, mirror(o), C);
      });
      sync_all();
      PHASE(7)
      {
        const ww::LaneParams p = ln_params(w.bfc_t + k * C, w.g_t + k * C, w.bln_t + k * C, lane);
        for (int f0 = warp; f0 < Fq; f0 += 2 * WARPS) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = f0 + e * WARPS;
            if (f < Fq) {
              float* xf = scur + f * C;
              const float* y = spart + (Fq + f) * C;
              ww::ln_store(y[lane], y[lane + 32], xf[lane], xf[lane + 32], p, xf, lane);
            }
          }
        }
      }
      PHASE(8)
    }
    __syncthreads();
    TX* ot = out + ((int64_t)b * T + t) * frame;
    for (int i = tid; i < Fq * C; i += ST_THREADS)
      if (i >= lo && i < hi) store_f(ot + i, scur[i]);
  }
  if constexpr (CL == 2) cg::this_cluster().sync();     // the peer's last writes to us landed
}

template <int CL, typename TX>
cudaError_t launch(const TX* x, TX* out, const float* h0, float* h_last, const StackW& w,
                   int B, int T, int Fq, int K, cudaStream_t st) {
  const size_t smem = sizeof(float) * stack_smem_floats(Fq);
  cudaError_t err = cudaFuncSetAttribute(dprnn_stack_kernel<CL, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(CL * B));
  cfg.blockDim = dim3(ST_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dprnn_stack_kernel<CL, TX>, x, out, h0, h_last, w, B, T, Fq, K);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename TX>
cudaError_t run(const TX* x, TX* out, const float* h0, float* h_last, const StackW& w, int B,
                int T, int Fq, int K, int ctas, int threads, cudaStream_t st) {
  if (Fq < 1 || Fq > FQ_MAX || B < 1 || T < 1 || K < 1) return cudaErrorInvalidValue;
  if (threads != ST_THREADS) return cudaErrorInvalidConfiguration;
  if (ctas == B) return launch<1>(x, out, h0, h_last, w, B, T, Fq, K, st);
  if (ctas == 2 * B) return launch<2>(x, out, h0, h_last, w, B, T, Fq, K, st);
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// x, out: [B, T, Fq, C], float32, or bfloat16 when plane_bf16; h0, h_last:
// [K, B, Fq, C] float32, 16-byte aligned; weights as pack_stack lays them
// out (wi2 / wh2 [K, 2C, 6C], b2 [K, 2, 6C], wfc_i [K, 2C, C],
// bfc_i / g_i / bln_i [K, 1, C], wi_t / wh_t [K, C, 3C], b2_t [K, 2, 3C],
// wfc_t [K, C, C], bfc_t / g_t / bln_t [K, 1, C]); all contiguous f32.
// The plan (gru_kernels.stack_plan): threads == 256 per CTA, ctas == B (one
// CTA per stream) or 2 * B (a two-CTA cluster per stream).  Returns a
// cudaError_t; 1 (cudaErrorInvalidValue) for Fq outside [1, 50].
extern "C" int dprnn_stack_launch(const void* x, void* out, const float* h0, float* h_last,
                                  const float* wi2, const float* wh2, const float* b2,
                                  const float* wfc_i, const float* bfc_i, const float* g_i,
                                  const float* bln_i, const float* wi_t, const float* wh_t,
                                  const float* b2_t, const float* wfc_t, const float* bfc_t,
                                  const float* g_t, const float* bln_t, int B, int T, int Fq,
                                  int K, int ctas, int threads, int plane_bf16, void* stream) {
  const StackW w{wi2, wh2, b2, wfc_i, bfc_i, g_i, bln_i,
                 wi_t, wh_t, b2_t, wfc_t, bfc_t, g_t, bln_t};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(out), h0, h_last, w, B, T,
                    Fq, K, ctas, threads, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), h0, h_last, w, B, T,
                  Fq, K, ctas, threads, st);
}

#ifdef DPDF_STACK_PHASES
// The summed cycles of the 9 phases (tools/stack_phases.py); reset zeroes them.
extern "C" int dprnn_stack_phases_read(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e == cudaSuccess && reset) {
    const unsigned long long z[9] = {};
    e = cudaMemcpyToSymbol(g_phase_cycles, z, sizeof(z));
  }
  return (int)e;
}
#endif
