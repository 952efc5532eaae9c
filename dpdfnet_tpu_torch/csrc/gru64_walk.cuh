// Shared helpers of the port's C = 64 kernels: plane loads and stores,
// the row addressing (Rows, RowMap), the GRU weight addressing
// (GruWeights), and the gate and warp-sum primitives.  The walk lives in
// gru64_warp.cuh (DPRNN inter and intra, intra v2, gru_bidir, the step
// ablations).
//
// Planes (x, and the out / ys plane) are float32 or bfloat16 (TX / TO):
// loads upcast, stores round once, every value in between is float32.
// Rows are addressed through strides, so the kernels read the model's
// [B, T, Fq, C] plane directly: element c of row n at step s lives at
//   (n / rpg) * sg + (n % rpg) * sr + t(s) * ss + c,
// t(s) = s, or S - 1 - s for a reverse walk.
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

__device__ __forceinline__ float sigmoid_f(float x) { return 1.0f / (1.0f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

}  // namespace dpdf
