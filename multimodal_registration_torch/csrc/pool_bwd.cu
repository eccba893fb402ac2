// K4 max_pool_2x_bwd: gradient of the 2x2x2 stride-2 max-pool with respect to
// its input.
//
// Replaces multimodal_registration_tpu/ops/pallas/pool_bwd.py::max_pool_2x_bwd
// and ::max_pool_2x_bwd_v3 (one function, two TPU pairings of z; mode `first`
// here) and the elementwise production adjoint of ops/pool.py::_bwd (mode
// `equal`). x (B, X, Y, Z, C) and g (B, X/2, Y/2, Z/2, C) in bf16 or f32, even
// spatial dims, any batch; grad (B, X, Y, Z, C) in x's type.
//
//   equal: every voxel that equals its window's max gets g / count, count the
//          number of such voxels, the quotient rounded once to g's type.
//   first: one winner per window, by the tournament of pool_bwd.py:84-97: the
//          z pair first, then the x pair, then the y pair; `a >= b` sends the
//          cotangent to a, so the lower index wins each tie. Compared in f32.
//          This is not the first maximum in row-major order.
//
// What bounds it on an H100 SXM: bytes. Each x is read once, each grad written
// once, g read once: at (1,160,160,192,64) bf16 629 + 79 + 629 MB = 1.34 GB,
// 0.40 ms at 3.35 TB/s; the compares are a few operations per value.
// Design: one thread per window and channel (the channel is the fastest
// index), so a warp's loads and stores cover 64 neighbouring channels
// of one voxel: full 128/256-byte lines. No shared memory: nothing is reused.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// total = B * Xh * Yh * Zh * C windows-times-channels, c fastest.
template <typename T>
__global__ void __launch_bounds__(THREADS) pool_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ out,
    int64_t total, int Xh, int Yh, int Zh, int C, int first) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  const int c = (int)(i % C);
  int64_t r = i / C;
  const int zh = (int)(r % Zh); r /= Zh;
  const int yh = (int)(r % Yh); r /= Yh;
  const int xh = (int)(r % Xh);
  const int64_t b = r / Xh;
  const int Y = 2 * Yh, Z = 2 * Zh;
  const int64_t sz = C, sy = (int64_t)Z * C, sx = (int64_t)Y * Z * C;
  const int64_t base = (((b * 2 * Xh + 2 * xh) * Y + 2 * yh) * Z + 2 * zh) * C + c;
  // v[dx][dy][dz]
  float v[2][2][2];
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        v[dx][dy][dz] = to_f(x[base + dx * sx + dy * sy + dz * sz]);
  const float gv = to_f(g[i]);
  float o[2][2][2];
  if (first) {
    // forward recompute: z pairs, then x pairs, then the y pair
    float mz[2][2], mx[2];
    int wz[2][2], wx[2];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        wz[dx][dy] = v[dx][dy][0] >= v[dx][dy][1] ? 0 : 1;
        mz[dx][dy] = fmaxf(v[dx][dy][0], v[dx][dy][1]);
      }
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      wx[dy] = mz[0][dy] >= mz[1][dy] ? 0 : 1;
      mx[dy] = fmaxf(mz[0][dy], mz[1][dy]);
    }
    const int wy = mx[0] >= mx[1] ? 0 : 1;
    const int wxx = wx[wy];
    const int wzz = wz[wxx][wy];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dz = 0; dz < 2; ++dz)
          o[dx][dy][dz] = (dx == wxx && dy == wy && dz == wzz) ? gv : 0.f;
  } else {
    float m = v[0][0][0];
#pragma unroll
    for (int k = 1; k < 8; ++k) m = fmaxf(m, v[k >> 2][(k >> 1) & 1][k & 1]);
    int cnt = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) cnt += v[k >> 2][(k >> 1) & 1][k & 1] == m;
    // the quotient rounded once to the tensor's type, as a division of two
    // values of that type is
    const float share = to_f(from_f<T>(__fdiv_rn(gv, (float)cnt)));
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k >> 2][(k >> 1) & 1][k & 1] = v[k >> 2][(k >> 1) & 1][k & 1] == m ? share : 0.f;
  }
#pragma unroll
  for (int dx = 0; dx < 2; ++dx)
#pragma unroll
    for (int dy = 0; dy < 2; ++dy)
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        out[base + dx * sx + dy * sy + dz * sz] = from_f<T>(o[dx][dy][dz]);
}

}  // namespace

extern "C" int pool_bwd_launch(const void* x, const void* g, void* out, int B,
                               int X, int Y, int Z, int C, int first,
                               int is_bf16, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int Xh = X / 2, Yh = Y / 2, Zh = Z / 2;
  const int64_t total = (int64_t)B * Xh * Yh * Zh * C;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + THREADS - 1) / THREADS);
  if (is_bf16)
    pool_bwd_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(out), total, Xh, Yh, Zh, C, first);
  else
    pool_bwd_kernel<float><<<blocks, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(out), total, Xh, Yh, Zh, C, first);
  return (int)cudaGetLastError();
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
