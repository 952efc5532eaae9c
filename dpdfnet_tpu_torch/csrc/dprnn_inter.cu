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
#include "gru64_walk.cuh"

using namespace dpdf;

template <int RPT, typename TX>
__global__ void __launch_bounds__(THREADS)
dprnn_inter_kernel(const TX* __restrict__ x, TX* __restrict__ out,
                   const float* __restrict__ h0, float* __restrict__ h_last,
                   GruWeights w, Epilogue<TX> ep, Rows rows, int64_t N, int T) {
  ep.out = out;
  gru64_walk<RPT, MODE_LN_RESIDUAL>(x, rows, N, T, false, w, ep, h0, h_last);
}

template <int RPT, typename TX>
static cudaError_t launch(const TX* x, TX* out, const float* h0, float* h_last,
                          GruWeights w, Epilogue<TX> ep, Rows rows, int64_t N, int T,
                          cudaStream_t stream) {
  constexpr int R = GROUPS * RPT;
  const size_t smem = sizeof(float) * walk_smem_floats<RPT>();
  cudaError_t err = cudaFuncSetAttribute(dprnn_inter_kernel<RPT, TX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((N + R - 1) / R);
  dprnn_inter_kernel<RPT, TX><<<blocks, THREADS, smem, stream>>>(x, out, h0, h_last, w, ep,
                                                                 rows, N, T);
  return cudaGetLastError();
}

template <typename TX>
static cudaError_t run(const TX* x, TX* out, const float* h0, float* h_last, const float* wi,
                       const float* bi, const float* wh, const float* bh, const float* wfc,
                       const float* bfc, const float* g, const float* bln, int B, int T,
                       int Fq, int rows_per_block, cudaStream_t st) {
  GruWeights w{wi, wh, bi, bh, G3, 0, C, 0};
  Epilogue<TX> ep{wfc, bfc, g, bln, out, 1e-5f};
  // row n = b * Fq + f; x[b, t, f, :] at b*T*Fq*C + f*C + t*Fq*C
  Rows rows{Fq, (int64_t)T * Fq * C, C, (int64_t)Fq * C};
  const int64_t N = (int64_t)B * Fq;
  return rows_per_block == 16 ? launch<4>(x, out, h0, h_last, w, ep, rows, N, T, st)
                              : launch<2>(x, out, h0, h_last, w, ep, rows, N, T, st);
}

// x, out: [B, T, Fq, C], float32, or bfloat16 when plane_bf16; h0, h_last:
// [B, Fq, C] float32.
extern "C" int dprnn_inter_launch(const void* x, void* out, const float* h0,
                                  float* h_last, const float* wi, const float* bi,
                                  const float* wh, const float* bh, const float* wfc,
                                  const float* bfc, const float* g, const float* bln,
                                  int B, int T, int Fq, int rows_per_block, int plane_bf16,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (plane_bf16)
    return (int)run(static_cast<const bf16*>(x), static_cast<bf16*>(out), h0, h_last, wi, bi,
                    wh, bh, wfc, bfc, g, bln, B, T, Fq, rows_per_block, st);
  return (int)run(static_cast<const float*>(x), static_cast<float*>(out), h0, h_last, wi, bi,
                  wh, bh, wfc, bfc, g, bln, B, T, Fq, rows_per_block, st);
}
