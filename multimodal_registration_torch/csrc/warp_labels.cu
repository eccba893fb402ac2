// K6 warp_labels_soft_hard and K7 its backward: the trilinear warp of the
// one-hot of an integer label map, without ever forming the one-hot.
//
// Replaces multimodal_registration_tpu/ops/warp.py::warp_labels_soft_hard
// (:570) and ::warp_onehot (:601). The TPU package has no kernel for it: it
// packs the 8 corner labels per voxel, gathers rows through XLA and mixes a
// checkpointed (X, Y, Z, 8, L) one-hot. Here the corner labels stay in
// registers and shared memory.
//
// K6: labels (B, X, Y, Z) uint8 or int32, flow (B, X, Y, Z, 3) f32 ->
//   soft (B, X, Y, Z, L) f32: soft[l] = sum over the 8 corners, in (dx, dy,
//     dz) order, of the corner's trilinear weight (wx*wy)*wz where the
//     corner's label is l (labels outside [0, L) add to no channel);
//   hard (B, X, Y, Z) int32: the label at the clipped coordinate rounded half
//     to even (rintf), the corner jnp.round selects.
//   Coordinates: c = min(max(x + flow(x), 0), dim-1), i0 = floor(c),
//   i1 = min(i0+1, dim-1), as K2.
// K7: g (B, X, Y, Z, L) f32, labels, flow -> gflow (B, X, Y, Z, 3) f32: per
//   axis, the sum over the corners of d weight / d coordinate times g[label
//   of that corner], times the derivative of the clip (1 inside, 0 outside,
//   one half at exact equality with a bound, as K5).
//
// What bounds them on an H100 SXM: bytes. At 160x160x192, L = 26: K6 writes
// 511 MB of soft and 20 MB of hard and reads 59 MB of flow and 5 MB of
// labels (0.18 ms at 3.35 TB/s); K7 writes 59 MB and reads 59 + 5 MB and, of
// the 511 MB cotangent, only the entries at each voxel's corner labels (one
// to two per voxel on label maps with compact regions; 0.19 ms if all).
// Design, K6: one thread per voxel computes its 8 (label, weight) pairs into
// shared memory; then the whole block writes its 256 x L block of soft,
// which is contiguous in memory, with neighbouring threads on neighbouring
// addresses. K7: one thread per voxel reads the up to 8 entries of its own
// g row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Corners {
  int64_t lin[8];  // voxel index of each corner inside the batch element
  float w[8];      // trilinear weights
  float rx, ry, rz;  // unclipped coordinates
  float wxs[2], wys[2], wzs[2];
  int64_t nearest;  // voxel index of the rounded coordinate
};

__device__ __forceinline__ Corners corners_of(const float* __restrict__ flow,
                                              int64_t b, int n, int X, int Y, int Z) {
  Corners k;
  const int z = n % Z, r = n / Z;
  const int y = r % Y, x = r / Y;
  const float* f = flow + ((int64_t)b * X * Y * Z + n) * 3;
  k.rx = __fadd_rn((float)x, f[0]);
  k.ry = __fadd_rn((float)y, f[1]);
  k.rz = __fadd_rn((float)z, f[2]);
  const float cx = fminf(fmaxf(k.rx, 0.f), (float)(X - 1));
  const float cy = fminf(fmaxf(k.ry, 0.f), (float)(Y - 1));
  const float cz = fminf(fmaxf(k.rz, 0.f), (float)(Z - 1));
  const float fx = floorf(cx), fy = floorf(cy), fz = floorf(cz);
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  const int xs[2] = {x0, min(x0 + 1, X - 1)};
  const int ys[2] = {y0, min(y0 + 1, Y - 1)};
  const int zs[2] = {z0, min(z0 + 1, Z - 1)};
  const float ax = __fsub_rn(cx, fx), ay = __fsub_rn(cy, fy), az = __fsub_rn(cz, fz);
  k.wxs[0] = __fsub_rn(1.f, ax); k.wxs[1] = ax;
  k.wys[0] = __fsub_rn(1.f, ay); k.wys[1] = ay;
  k.wzs[0] = __fsub_rn(1.f, az); k.wzs[1] = az;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dx = i >> 2, dy = (i >> 1) & 1, dz = i & 1;
    k.w[i] = __fmul_rn(__fmul_rn(k.wxs[dx], k.wys[dy]), k.wzs[dz]);
    k.lin[i] = ((int64_t)xs[dx] * Y + ys[dy]) * Z + zs[dz];
  }
  k.nearest = ((int64_t)(int)rintf(cx) * Y + (int)rintf(cy)) * Z + (int)rintf(cz);
  return k;
}

__device__ __forceinline__ float clip_grad(float c, float hi) {
  const float lo_d = c > 0.f ? 1.f : (c == 0.f ? 0.5f : 0.f);
  const float m = fmaxf(c, 0.f);
  const float hi_d = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return lo_d * hi_d;
}

template <typename LT>
__global__ void __launch_bounds__(THREADS) warp_labels_kernel(
    const LT* __restrict__ labels, const float* __restrict__ flow,
    float* __restrict__ soft, int* __restrict__ hard, int X, int Y, int Z, int L) {
  __shared__ int s_lab[THREADS * 8];
  __shared__ float s_w[THREADS * 8];
  const int N = X * Y * Z;
  const int64_t b = blockIdx.y;
  const int n0 = blockIdx.x * THREADS;
  const int n = n0 + threadIdx.x;
  const LT* lab = labels + b * N;
  if (n < N) {
    const Corners k = corners_of(flow, b, n, X, Y, Z);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s_lab[threadIdx.x * 8 + i] = (int)lab[k.lin[i]];
      s_w[threadIdx.x * 8 + i] = k.w[i];
    }
    hard[b * N + n] = (int)lab[k.nearest];
  }
  __syncthreads();
  const int count = min(THREADS, N - n0) * L;  // values of soft this block writes
  float* out = soft + (b * N + n0) * L;
  for (int j = threadIdx.x; j < count; j += THREADS) {
    const int v = j / L, l = j - v * L;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s_lab[v * 8 + i] == l) acc = __fadd_rn(acc, s_w[v * 8 + i]);
    out[j] = acc;
  }
}

template <typename LT>
__global__ void __launch_bounds__(THREADS) warp_labels_bwd_kernel(
    const float* __restrict__ g, const LT* __restrict__ labels,
    const float* __restrict__ flow, float* __restrict__ gflow, int X, int Y,
    int Z, int L) {
  const int N = X * Y * Z;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int64_t b = blockIdx.y;
  const Corners k = corners_of(flow, b, n, X, Y, Z);
  const LT* lab = labels + b * N;
  const float* gr = g + (b * N + n) * L;
  float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dx = i >> 2, dy = (i >> 1) & 1, dz = i & 1;
    const int l = (int)lab[k.lin[i]];
    const float gv = (l >= 0 && l < L) ? gr[l] : 0.f;
    gx += gv * (dx ? 1.f : -1.f) * k.wys[dy] * k.wzs[dz];
    gy += gv * (dy ? 1.f : -1.f) * k.wxs[dx] * k.wzs[dz];
    gz += gv * (dz ? 1.f : -1.f) * k.wxs[dx] * k.wys[dy];
  }
  float* o = gflow + (b * N + n) * 3;
  o[0] = gx * clip_grad(k.rx, (float)(X - 1));
  o[1] = gy * clip_grad(k.ry, (float)(Y - 1));
  o[2] = gz * clip_grad(k.rz, (float)(Z - 1));
}

}  // namespace

extern "C" int warp_labels_launch(const void* labels, const void* flow,
                                  void* soft, void* hard, int B, int X, int Y,
                                  int Z, int L, int labels_are_u8, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((X * Y * Z + THREADS - 1) / THREADS, B);
  const float* f = static_cast<const float*>(flow);
  float* so = static_cast<float*>(soft);
  int* ha = static_cast<int*>(hard);
  if (labels_are_u8)
    warp_labels_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(labels), f, so, ha, X, Y, Z, L);
  else
    warp_labels_kernel<int><<<grid, THREADS, 0, s>>>(
        static_cast<const int*>(labels), f, so, ha, X, Y, Z, L);
  return (int)cudaGetLastError();
}

extern "C" int warp_labels_bwd_launch(const void* g, const void* labels,
                                      const void* flow, void* gflow, int B,
                                      int X, int Y, int Z, int L,
                                      int labels_are_u8, void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((X * Y * Z + THREADS - 1) / THREADS, B);
  const float* gg = static_cast<const float*>(g);
  const float* f = static_cast<const float*>(flow);
  float* go = static_cast<float*>(gflow);
  if (labels_are_u8)
    warp_labels_bwd_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        gg, static_cast<const uint8_t*>(labels), f, go, X, Y, Z, L);
  else
    warp_labels_bwd_kernel<int><<<grid, THREADS, 0, s>>>(
        gg, static_cast<const int*>(labels), f, go, X, Y, Z, L);
  return (int)cudaGetLastError();
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
