// DPRNN inter stage on Hopper: a GRU along time over every (b, f) row of
// the [B, T, Fq, C] plane, fused with out[t] = x[t] + LN(h_t . Wfc + bfc).
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py dprnn_inter_block, kernels
// _inter_block_kernel_packed / _inter_block_kernel (TPU).
//
// What bounds it on the H100: the recurrence is sequential in T (112 steps
// per segment), and only B * Fq rows run in parallel (384 at B=8, 3072 at
// B=64), so the card cannot reach either roofline: each step is a chain of
// dependent shared-memory dot products of length 64, then a LayerNorm.
// Useful work is 14 C^2 FLOPs per row-step against 2 C * 4 bytes of plane
// traffic, so its roofline bound is arithmetic.
//
// Design: one block owns 8 or 16 rows and loops over T.  Wi, Wh (64 x 192)
// and Wfc (64 x 64) stay in shared memory (112 KB, dynamic, above the 48 KB
// default) for the whole walk, so weights are read from device memory once
// per block.  The carried hidden lives in shared memory; h0 is read from,
// and h_last written to, the state's [B, Fq, C] layout (row n = b * Fq + f).
// The plane is read and written in place through strides: no transpose.
// The plane is float32 or bfloat16 (loads upcast, the store rounds once);
// h0 / h_last, the weights and all arithmetic are float32.
//
// Modes (the TPU kernel's fm_batch, h_bm and defer), each a stride set or
// a template flag of the same walk, with the arithmetic unchanged:
//   fm_batch = B  x is the freq-major [T, Fq * B, C] (rows f-major,
//                 n = f * B + b) and out the freq-leading [Fq, T, B, C]
//                 that the next fm intra stage reads;
//   h_bm          (with fm_batch) h0 / h_last in the state's [B, Fq, C]
//                 instead of the rows' [Fq * B, C];
//   defer         the walk stores the raw hidden h_t (MODE_YS) in out's
//                 layout at the plane's dtype; the fc + LayerNorm +
//                 residual tail runs outside the kernel.
#include "gru64_walk.cuh"

using namespace dpdf;

template <int RPT, int MODE, typename TX>
__global__ void __launch_bounds__(THREADS)
dprnn_inter_kernel(const TX* __restrict__ x, TX* __restrict__ out,
                   const float* __restrict__ h0, float* __restrict__ h_last,
                   GruWeights w, Epilogue<TX> ep, Rows rows, Rows orows, Rows hrows, int64_t N,
                   int T) {
  ep.out = out;
  gru64_walk_io<RPT, MODE>(x, rows, orows, hrows, N, T, false, w, ep, h0, h_last);
}

template <int RPT, int MODE, typename TX>
static cudaError_t launch(const TX* x, TX* out, const float* h0, float* h_last,
                          GruWeights w, Epilogue<TX> ep, Rows rows, Rows orows, Rows hrows,
                          int64_t N, int T, cudaStream_t stream) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * walk_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(dprnn_inter_kernel<RPT, MODE, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  dprnn_inter_kernel<RPT, MODE, TX><<<blocks, THREADS, smem, stream>>>(
      x, out, h0, h_last, w, ep, rows, orows, hrows, N, T);
  return cudaGetLastError();
}

template <int MODE, typename TX>
static cudaError_t launch_rpb(const TX* x, TX* out, const float* h0, float* h_last,
                              GruWeights w, Epilogue<TX> ep, Rows rows, Rows orows, Rows hrows,
                              int64_t N, int T, int rows_per_block, cudaStream_t st) {
  return rows_per_block == 16
             ? launch<4, MODE>(x, out, h0, h_last, w, ep, rows, orows, hrows, N, T, st)
             : launch<2, MODE>(x, out, h0, h_last, w, ep, rows, orows, hrows, N, T, st);
}

template <typename TX>
static cudaError_t run(const TX* x, TX* out, const float* h0, float* h_last, const float* wi,
                       const float* bi, const float* wh, const float* bh, const float* wfc,
                       const float* bfc, const float* g, const float* bln, int B, int T,
                       int Fq, int rows_per_block, int fm, int h_bm, int defer,
                       cudaStream_t st) {
  GruWeights w{wi, wh, bi, bh, G3, 0, C, 0};
  Epilogue<TX> ep{wfc, bfc, g, bln, out, 1e-5f};
  const int64_t N = (int64_t)B * Fq;
  Rows rows, orows, hrows;
  if (fm) {
    // row n = f * B + b; x[t, n] at t*N*C + n*C; out[f, t, b] at
    // f*T*B*C + t*B*C + b*C; h_bm: h[b, f] at b*Fq*C + f*C
    rows = Rows{N, 0, C, N * C};
    orows = Rows{B, (int64_t)T * B * C, C, (int64_t)B * C};
    hrows = h_bm ? Rows{B, C, (int64_t)Fq * C, 0} : dense_rows(N);
  } else {
    // row n = b * Fq + f; x[b, t, f, :] at b*T*Fq*C + f*C + t*Fq*C
    rows = Rows{Fq, (int64_t)T * Fq * C, C, (int64_t)Fq * C};
    orows = rows;
    hrows = dense_rows(N);
  }
  return defer ? launch_rpb<MODE_YS>(x, out, h0, h_last, w, ep, rows, orows, hrows, N, T,
                                     rows_per_block, st)
               : launch_rpb<MODE_LN_RESIDUAL>(x, out, h0, h_last, w, ep, rows, orows, hrows, N,
                                              T, rows_per_block, st);
}

// fm_batch == 0: x, out [B, T, Fq, C]; h0, h_last [B, Fq, C].  fm_batch:
// x [T, Fq * B, C] (f-major rows), out [Fq, T, B, C]; h0, h_last
// [Fq * B, C], or [B, Fq, C] with h_bm.  defer: out holds the raw hidden.
// Planes float32, or bfloat16 when plane_bf16; hiddens float32.
extern "C" int dprnn_inter_launch(const void* x, void* out, const float* h0,
                                  float* h_last, const float* wi, const float* bi,
                                  const float* wh, const float* bh, const float* wfc,
                                  const float* bfc, const float* g, const float* bln,
                                  int B, int T, int Fq, int rows_per_block, int plane_bf16,
                                  int fm_batch, int h_bm, int defer, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(out), h0, h_last, wi, bi,
                    wh, bh, wfc, bfc, g, bln, B, T, Fq, rows_per_block, fm_batch, h_bm, defer,
                    st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), h0, h_last, wi, bi,
                  wh, bh, wfc, bfc, g, bln, B, T, Fq, rows_per_block, fm_batch, h_bm, defer,
                  st);
}
