// K5 warp_trilinear_bwd: the backward of K2 (csrc/warp.cu), the edge-clamped
// dense-displacement sampler.
//
// Replaces what jax.grad derives from multimodal_registration_tpu/ops/warp.py
// ::sample / warp / warp_batch (:369): the transpose of the corner gather, a
// scatter-add into the volume, and the gradient with respect to the
// coordinates through the trilinear weights. The TPU package has no kernel
// for it (XLA transposes its gathers); on Hopper it is one pass with atomics.
//
// From vol (B, X, Y, Z, C), coords (B, N, 3) f32 (absolute, or displacements
// on an (Xo, Yo, Zo) grid) and the output's cotangent gout (B, N, C):
//   (a) gvol (B, X, Y, Z, C) FLOAT32, zeroed by the caller: each of the 8
//       corners receives weight * gout by atomicAdd; the caller rounds the
//       sum once to the volume's type. A bf16 atomicAdd would lose the small
//       contributions. Skipped when gvol is null.
//   (b) gcoords (B, N, 3) f32: sum over channels of gout times the derivative
//       of the trilinear mix along each axis, times the derivative of the
//       clip. Skipped when gcoords is null; nearest has none.
// The clip min(max(c, 0), dim-1) follows the reference's rule: derivative 1
// inside, 0 outside, and one half at exact equality with a bound (each of
// max and min splits its derivative evenly between equal arguments).
//
// What bounds it on an H100 SXM: bytes at the stream's rate, atomics at the
// L2's. At (1,80,80,96,3): coords 7.4 MB, vol and gout 3.7 MB each (bf16),
// gvol 7.4 MB of atomics, gcoords 7.4 MB written: ~30 MB, ~9 us at 3.35 TB/s.
// Design: one thread per output voxel looping over channels, as K2; smooth
// fields send neighbouring threads to neighbouring corners, so the atomics
// of a warp mostly fall into a few L2 lines.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// d/dc of min(max(c, 0), hi) at the unclipped coordinate c
__device__ __forceinline__ float clip_grad(float c, float hi) {
  const float lo_d = c > 0.f ? 1.f : (c == 0.f ? 0.5f : 0.f);
  const float m = fmaxf(c, 0.f);
  const float hi_d = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return lo_d * hi_d;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) warp_bwd_kernel(
    const T* __restrict__ vol, const float* __restrict__ coords,
    const T* __restrict__ gout, float* __restrict__ gvol,
    float* __restrict__ gcoords, int X, int Y, int Z, int C, int N, int Yo,
    int Zo, int coords_are_flow, int nearest) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const float* cp = coords + ((int64_t)b * N + n) * 3;
  float rx = cp[0], ry = cp[1], rz = cp[2];
  if (coords_are_flow) {
    const int z = n % Zo, r = n / Zo;
    const int y = r % Yo, x = r / Yo;
    rx = __fadd_rn((float)x, rx);
    ry = __fadd_rn((float)y, ry);
    rz = __fadd_rn((float)z, rz);
  }
  const float hx = (float)(X - 1), hy = (float)(Y - 1), hz = (float)(Z - 1);
  const float cx = fminf(fmaxf(rx, 0.f), hx);
  const float cy = fminf(fmaxf(ry, 0.f), hy);
  const float cz = fminf(fmaxf(rz, 0.f), hz);
  const int64_t vbase = (int64_t)b * X * Y * Z * C;
  const T* go = gout + ((int64_t)b * N + n) * C;
  if (nearest) {
    if (gvol == nullptr) return;
    const int64_t lin =
        (((int64_t)(int)rintf(cx) * Y + (int)rintf(cy)) * Z + (int)rintf(cz)) * C;
    for (int c = 0; c < C; ++c) atomicAdd(gvol + vbase + lin + c, to_f(go[c]));
    return;
  }
  const float fx = floorf(cx), fy = floorf(cy), fz = floorf(cz);
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  const int xs[2] = {x0, min(x0 + 1, X - 1)};
  const int ys[2] = {y0, min(y0 + 1, Y - 1)};
  const int zs[2] = {z0, min(z0 + 1, Z - 1)};
  const float ax = cx - fx, ay = cy - fy, az = cz - fz;
  const float wxs[2] = {1.f - ax, ax}, wys[2] = {1.f - ay, ay}, wzs[2] = {1.f - az, az};
  float wk[8], dxk[8], dyk[8], dzk[8];
  int64_t lk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    wk[k] = wxs[dx] * wys[dy] * wzs[dz];
    dxk[k] = (dx ? 1.f : -1.f) * wys[dy] * wzs[dz];
    dyk[k] = (dy ? 1.f : -1.f) * wxs[dx] * wzs[dz];
    dzk[k] = (dz ? 1.f : -1.f) * wxs[dx] * wys[dy];
    lk[k] = vbase + (((int64_t)xs[dx] * Y + ys[dy]) * Z + zs[dz]) * C;
  }
  float gx = 0.f, gy = 0.f, gz = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g = to_f(go[c]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (gvol != nullptr) atomicAdd(gvol + lk[k] + c, g * wk[k]);
      if (gcoords != nullptr) {
        const float gv = g * to_f(vol[lk[k] + c]);
        gx += gv * dxk[k];
        gy += gv * dyk[k];
        gz += gv * dzk[k];
      }
    }
  }
  if (gcoords != nullptr) {
    float* gc = gcoords + ((int64_t)b * N + n) * 3;
    gc[0] = gx * clip_grad(rx, hx);
    gc[1] = gy * clip_grad(ry, hy);
    gc[2] = gz * clip_grad(rz, hz);
  }
}

}  // namespace

extern "C" int warp_bwd_launch(const void* vol, const void* coords,
                               const void* gout, void* gvol, void* gcoords,
                               int B, int X, int Y, int Z, int C, int N,
                               int Yo, int Zo, int coords_are_flow, int nearest,
                               int is_bf16, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + THREADS - 1) / THREADS, B);
  const float* cf = static_cast<const float*>(coords);
  float* gv = static_cast<float*>(gvol);
  float* gc = static_cast<float*>(gcoords);
  if (is_bf16)
    warp_bwd_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), cf,
        static_cast<const __nv_bfloat16*>(gout), gv, gc, X, Y, Z, C, N, Yo, Zo,
        coords_are_flow, nearest);
  else
    warp_bwd_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(vol), cf, static_cast<const float*>(gout), gv,
        gc, X, Y, Z, C, N, Yo, Zo, coords_are_flow, nearest);
  return (int)cudaGetLastError();
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
