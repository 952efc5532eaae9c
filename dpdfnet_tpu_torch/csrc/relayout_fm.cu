// Entry relayout of the freq-major DPRNN chain: x [B, T, F, C] ->
// out [F, T, B, C], with the plane's dtype cast (float32 / bfloat16 either
// way) folded into the store.
//
// Replaces: dpdfnet_tpu/ops/pallas_gru.py relayout_fm, kernel
// _relayout_kernel (TPU).  The TPU wrapper falls back to an XLA transpose
// when F, T or B is not a multiple of 8 (its block shape); this kernel
// takes every shape.
//
// What bounds it on the H100: memory.  It reads every element once and
// writes it once (88 MB in and 88 MB out at [64, 112, 48, 64] float32) and
// computes nothing, so its bound is bytes over 3.35 TB/s.
//
// Design: the permute keeps C innermost, so each (b, t, f) row of C
// elements is contiguous on both sides (256 B in float32 at C = 64).  One
// thread moves 4 consecutive channels with one vector load and one vector
// store (16 B float32, 8 B bfloat16); consecutive threads cover one output
// row and then the next b, so the stores are fully coalesced and the loads
// come in whole contiguous rows.  No shared-memory transpose is needed.
// Where C is not a multiple of 4, or a pointer is not aligned for the
// vector access, a thread moves one element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// four consecutive elements, moved as one aligned vector
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<bf16> { struct __align__(8) type { bf16 v[4]; }; };

__device__ __forceinline__ void unpack(const float4& a, float* f) {
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void unpack(const Vec4<bf16>::type& a, float* f) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat162float(a.v[i]);
}
__device__ __forceinline__ void pack(const float* f, float4& a) {
  a = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void pack(const float* f, Vec4<bf16>::type& a) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a.v[i] = __float2bfloat16(f[i]);
}

// Element group k (V channels) of output row ro = (f * T + t) * B + b comes
// from input row (b * T + t) * F + f.  IDX is 32-bit where the element
// count allows (the index divisions dominate the instruction count).
template <typename TI, typename TO, int V, typename IDX>
__global__ void __launch_bounds__(256)
relayout_fm_kernel(const TI* __restrict__ x, TO* __restrict__ out, IDX B, IDX T, IDX F,
                   IDX C) {
  const IDX groups = C / V;
  const IDX total = F * T * B * groups;
  for (IDX i = (IDX)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (IDX)gridDim.x * blockDim.x) {
    const IDX ro = i / groups;
    const IDX k = (i % groups) * V;
    const IDX b = ro % B;
    const IDX ft = ro / B;
    const IDX t = ft % T;
    const IDX f = ft / T;
    const IDX src = ((b * T + t) * F + f) * C + k;
    const IDX dst = ro * C + k;
    if constexpr (V == 4) {
      float v[4];
      unpack(*reinterpret_cast<const typename Vec4<TI>::type*>(x + src), v);
      typename Vec4<TO>::type o;
      pack(v, o);
      *reinterpret_cast<typename Vec4<TO>::type*>(out + dst) = o;
    } else {
      out[dst] = from_f<TO>(to_f(x[src]));
    }
  }
}

template <typename TI, typename TO>
cudaError_t run(const void* x, void* out, int64_t B, int64_t T, int64_t F, int64_t C, int vec,
                cudaStream_t st) {
  const int V = vec ? 4 : 1;
  const int64_t total = F * T * B * (C / V);
  if (total == 0) return cudaSuccess;
  const int64_t want = (total + 255) / 256;
  const unsigned blocks = (unsigned)(want < 132 * 32 ? want : 132 * 32);
  const TI* xi = static_cast<const TI*>(x);
  TO* o = static_cast<TO*>(out);
  // 32-bit indices while every element offset (and the loop's overshoot)
  // stays below 2^31
  const bool narrow = F * T * B * C + (int64_t)blocks * 256 * 4 < ((int64_t)1 << 31);
  if (vec && narrow)
    relayout_fm_kernel<TI, TO, 4, uint32_t><<<blocks, 256, 0, st>>>(
        xi, o, (uint32_t)B, (uint32_t)T, (uint32_t)F, (uint32_t)C);
  else if (vec)
    relayout_fm_kernel<TI, TO, 4, int64_t><<<blocks, 256, 0, st>>>(xi, o, B, T, F, C);
  else if (narrow)
    relayout_fm_kernel<TI, TO, 1, uint32_t><<<blocks, 256, 0, st>>>(
        xi, o, (uint32_t)B, (uint32_t)T, (uint32_t)F, (uint32_t)C);
  else
    relayout_fm_kernel<TI, TO, 1, int64_t><<<blocks, 256, 0, st>>>(xi, o, B, T, F, C);
  return cudaGetLastError();
}

}  // namespace

// x [B, T, F, C] contiguous, out [F, T, B, C] contiguous; in_bf16 / out_bf16
// pick bfloat16 over float32 for each side.  vec = 1 requires C % 4 == 0 and
// both pointers aligned to a 4-element vector (the wrapper checks).
extern "C" int relayout_fm_launch(const void* x, void* out, long long B, long long T,
                                  long long F, long long C, int in_bf16, int out_bf16, int vec,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_bf16 && out_bf16) return (int)run<bf16, bf16>(x, out, B, T, F, C, vec, st);
  if (in_bf16) return (int)run<bf16, float>(x, out, B, T, F, C, vec, st);
  if (out_bf16) return (int)run<float, bf16>(x, out, B, T, F, C, vec, st);
  return (int)run<float, float>(x, out, B, T, F, C, vec, st);
}
