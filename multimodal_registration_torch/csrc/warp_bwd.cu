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
// of a warp mostly fall into a few L2 lines. The float32 sums live in a
// scratch buffer that the wrapper owns and keeps zero between backward
// passes: warp_bwd_finish rounds them once into the gradient and zeroes them
// behind it, so no memset and no separate rounding pass surround the kernel.
//
// self_warp_add_bwd (a second entry of K5): the backward of the fused
// squaring step of csrc/warp.cu, out = phi + f32(round_T(warp(T(phi), phi))).
// For the cotangent g (float32):
//   g_phi = g + f32(round_T(gvol)) + gcoords,
// gvol the scatter-add of w_k * T(g) into the corners, gcoords the gradient
// through the trilinear weights of the T-rounded field values times the
// clip's derivative: the chain autograd builds from the unfused step, term
// for term. Two launches: kernel A writes g + gcoords and accumulates gvol in
// the scratch buffer; kernel B (self_warp_add_finish) adds the scratch,
// rounded once to T, into the output and zeroes it. Kernel A takes the 3-D
// tiles of the forward (warp_tile.cuh): the eight corners of a voxel are the
// corners of its neighbours too, so a global atomic per contribution (24 per
// voxel) serialises in the L2; here contributions go into a float32 window in
// shared memory with shared-memory atomics, and the block flushes the window
// once, with one 16-byte vector atomic per touched chunk. A contribution to a
// corner outside the window goes to global memory directly. phi's own corner
// values, which only gcoords needs, are gathered through the L1. Tiles of
// 4 x 4 x 16 voxels with a halo of 1 and 128 threads, as measured: 13.4 KB of
// shared memory a block. Sums through atomics differ from run to run in the
// last bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_tile.cuh"

namespace {

using warp_tile::clip_grad;

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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

// The same backward for a displacement field on the volume's own grid, with
// the scatter reduced in shared memory: 3-D tiles of output voxels, the sums
// of gvol collected in a float32 window (shared-memory atomics) and flushed
// once (warp_tile.cuh); corners outside the window go to global memory. The
// volume's corner values, which only gcoords needs, are gathered from global
// memory as in the kernel above.
using TiledShape = warp_tile::Shape<4, 4, 16, 1, 128>;

template <class S, typename T, int C>
__global__ void __launch_bounds__(S::THREADS) warp_bwd_tiled_kernel(
    const T* __restrict__ vol, const float* __restrict__ flow, const T* __restrict__ gout,
    float* __restrict__ gvol, float* __restrict__ gcoords, int X, int Y, int Z, int nty,
    int ntz, int vec) {
  __shared__ __align__(16) float acc[S::WIN * C];  // (WX, WY, WZ, C)
  int tx0, ty0, tz0;
  warp_tile::tile_origin<S>(nty, ntz, tx0, ty0, tz0);
  const int nvox = X * Y * Z;
  const float* fb = flow + blockIdx.y * nvox * 3;
  const T* vb = vol + blockIdx.y * nvox * C;
  const T* gb = gout + blockIdx.y * nvox * C;
  float* sb = gvol + blockIdx.y * nvox * C;
  const warp_tile::Window w = warp_tile::window_of<S>(fb, X, Y, Z, tx0, ty0, tz0);
  for (int i = threadIdx.x; i < S::WIN * C; i += S::THREADS) acc[i] = 0.f;
  __syncthreads();
  const float hx = (float)(X - 1), hy = (float)(Y - 1), hz = (float)(Z - 1);
  for (int v = threadIdx.x; v < S::VOX; v += S::THREADS) {
    const int lz = v % S::TZ, r = v / S::TZ;
    const int x = tx0 + r / S::TY, y = ty0 + r % S::TY, z = tz0 + lz;
    if (x >= X || y >= Y || z >= Z) continue;
    const int n = (x * Y + y) * Z + z;
    const float rx = __fadd_rn((float)x, fb[n * 3]), ry = __fadd_rn((float)y, fb[n * 3 + 1]),
                rz = __fadd_rn((float)z, fb[n * 3 + 2]);
    const warp_tile::Corners k = warp_tile::corners_of(rx, ry, rz, X, Y, Z);
    float g[C];
#pragma unroll
    for (int c = 0; c < C; ++c) g[c] = to_f(gb[n * C + c]);
    float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int dx = kk >> 2, dy = (kk >> 1) & 1, dz = kk & 1;
      const float wk = k.wx[dx] * k.wy[dy] * k.wz[dz];
      const int off = warp_tile::window_offset<S>(w, k.xs[dx], k.ys[dy], k.zs[dz]);
      const int lin = ((k.xs[dx] * Y + k.ys[dy]) * Z + k.zs[dz]) * C;
      if (off >= 0) {
#pragma unroll
        for (int c = 0; c < C; ++c) atomicAdd(acc + off * C + c, g[c] * wk);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) atomicAdd(sb + lin + c, g[c] * wk);
      }
      if (gcoords != nullptr) {
        float t = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) t += g[c] * to_f(vb[lin + c]);
        gx += t * ((dx ? 1.f : -1.f) * k.wy[dy] * k.wz[dz]);
        gy += t * ((dy ? 1.f : -1.f) * k.wx[dx] * k.wz[dz]);
        gz += t * ((dz ? 1.f : -1.f) * k.wx[dx] * k.wy[dy]);
      }
    }
    if (gcoords != nullptr) {
      float* gc = gcoords + (blockIdx.y * nvox + n) * 3;
      gc[0] = gx * clip_grad(rx, hx);
      gc[1] = gy * clip_grad(ry, hy);
      gc[2] = gz * clip_grad(rz, hz);
    }
  }
  __syncthreads();
  warp_tile::flush_window<S, C>(acc, sb, X, Y, Z, w, vec);
}

template <typename T, int C>
int launch_warp_bwd_tiled(const void* vol, const float* flow, const void* gout, float* gvol,
                          float* gcoords, int B, int X, int Y, int Z, cudaStream_t s) {
  using S = TiledShape;
  const int ntx = (X + S::TX - 1) / S::TX, nty = (Y + S::TY - 1) / S::TY,
            ntz = (Z + S::TZ - 1) / S::TZ;
  const int vec = (Z * C) % 4 == 0 && reinterpret_cast<uintptr_t>(gvol) % 16 == 0;
  warp_bwd_tiled_kernel<S, T, C><<<dim3(ntx * nty * ntz, B), S::THREADS, 0, s>>>(
      static_cast<const T*>(vol), flow, static_cast<const T*>(gout), gvol, gcoords, X, Y, Z,
      nty, ntz, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_warp_bwd_tiled_c(const void* vol, const float* flow, const void* gout, float* gvol,
                            float* gcoords, int B, int X, int Y, int Z, int C, cudaStream_t s) {
  switch (C) {
    case 1: return launch_warp_bwd_tiled<T, 1>(vol, flow, gout, gvol, gcoords, B, X, Y, Z, s);
    case 2: return launch_warp_bwd_tiled<T, 2>(vol, flow, gout, gvol, gcoords, B, X, Y, Z, s);
    case 3: return launch_warp_bwd_tiled<T, 3>(vol, flow, gout, gvol, gcoords, B, X, Y, Z, s);
    case 4: return launch_warp_bwd_tiled<T, 4>(vol, flow, gout, gvol, gcoords, B, X, Y, Z, s);
  }
  return (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// grad (type T) = the float32 sums rounded once; the sums are zeroed. Four
// values a thread where both pointers allow (n4 = n / 4), the rest one each.
template <typename T>
__global__ void __launch_bounds__(THREADS) warp_bwd_finish_kernel(
    T* __restrict__ grad, float* __restrict__ scratch, int n4, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n4) {
    const float4 v = reinterpret_cast<float4*>(scratch)[i];
    reinterpret_cast<float4*>(scratch)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (sizeof(T) == 2) {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 packed;
      packed.x = *reinterpret_cast<unsigned*>(&lo);
      packed.y = *reinterpret_cast<unsigned*>(&hi);
      reinterpret_cast<uint2*>(grad)[i] = packed;
    } else {
      reinterpret_cast<float4*>(grad)[i] = v;
    }
  } else {
    const int j = n4 * 4 + (i - n4);
    if (j < n) {
      put(grad + j, scratch[j]);
      scratch[j] = 0.f;
    }
  }
}

// ---- the fused squaring step's backward ------------------------------------

// Kernel A: out = g + gcoords; scratch += gvol (float32 sums, through the
// window in shared memory).
template <bool BF16>
__global__ void __launch_bounds__(TiledShape::THREADS) self_warp_add_bwd_kernel(
    const float* __restrict__ phi, const float* __restrict__ g, float* __restrict__ out,
    float* __restrict__ scratch, int X, int Y, int Z, int nty, int ntz, int vec) {
  using S = TiledShape;
  __shared__ __align__(16) float gbuf[S::VOX * 3];  // (TX, TY, TZ, 3): g in, g + gcoords out
  __shared__ __align__(16) float acc[S::WIN * 3];   // (WX, WY, WZ, 3): the sums of gvol
  int tx0, ty0, tz0;
  warp_tile::tile_origin<S>(nty, ntz, tx0, ty0, tz0);
  const int nvol = X * Y * Z * 3;
  const float* pb = phi + blockIdx.y * nvol;
  float* sb = scratch + blockIdx.y * nvol;
  const warp_tile::Window w = warp_tile::window_of<S>(pb, X, Y, Z, tx0, ty0, tz0);
  for (int i = threadIdx.x; i < S::WIN * 3; i += S::THREADS) acc[i] = 0.f;
  warp_tile::move_tile<S, 3, false>(gbuf, const_cast<float*>(g) + blockIdx.y * nvol, X, Y, Z,
                                    tx0, ty0, tz0, vec);
  __syncthreads();
  const float hx = (float)(X - 1), hy = (float)(Y - 1), hz = (float)(Z - 1);
  for (int v = threadIdx.x; v < S::VOX; v += S::THREADS) {
    const int lz = v % S::TZ, r = v / S::TZ;
    const int x = tx0 + r / S::TY, y = ty0 + r % S::TY, z = tz0 + lz;
    if (x >= X || y >= Y || z >= Z) continue;
    const float* q = pb + ((x * Y + y) * Z + z) * 3;
    const float rx = __fadd_rn((float)x, q[0]), ry = __fadd_rn((float)y, q[1]),
                rz = __fadd_rn((float)z, q[2]);
    const warp_tile::Corners k = warp_tile::corners_of(rx, ry, rz, X, Y, Z);
    float* gv = gbuf + v * 3;
    const float g3[3] = {gv[0], gv[1], gv[2]};
    // the cotangent enters the warp's backward in the payload's type
    const float gt[3] = {BF16 ? warp_tile::round_bf16(g3[0]) : g3[0],
                         BF16 ? warp_tile::round_bf16(g3[1]) : g3[1],
                         BF16 ? warp_tile::round_bf16(g3[2]) : g3[2]};
    float gc[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int dx = kk >> 2, dy = (kk >> 1) & 1, dz = kk & 1;
      const float wk = k.wx[dx] * k.wy[dy] * k.wz[dz];
      const int off = warp_tile::window_offset<S>(w, k.xs[dx], k.ys[dy], k.zs[dz]);
      const int lin = ((k.xs[dx] * Y + k.ys[dy]) * Z + k.zs[dz]) * 3;
      if (off >= 0) {  // two branches: each atomic knows its address space
#pragma unroll
        for (int c = 0; c < 3; ++c) atomicAdd(acc + off * 3 + c, gt[c] * wk);
      } else {
#pragma unroll
        for (int c = 0; c < 3; ++c) atomicAdd(sb + lin + c, gt[c] * wk);
      }
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        s += gt[c] * (BF16 ? warp_tile::round_bf16(pb[lin + c]) : pb[lin + c]);
      gc[0] += s * ((dx ? 1.f : -1.f) * k.wy[dy] * k.wz[dz]);
      gc[1] += s * ((dy ? 1.f : -1.f) * k.wx[dx] * k.wz[dz]);
      gc[2] += s * ((dz ? 1.f : -1.f) * k.wx[dx] * k.wy[dy]);
    }
    gv[0] = g3[0] + gc[0] * clip_grad(rx, hx);
    gv[1] = g3[1] + gc[1] * clip_grad(ry, hy);
    gv[2] = g3[2] + gc[2] * clip_grad(rz, hz);
  }
  __syncthreads();
  warp_tile::move_tile<S, 3, true>(gbuf, out + blockIdx.y * nvol, X, Y, Z, tx0, ty0, tz0, vec);
  warp_tile::flush_window<S, 3>(acc, sb, X, Y, Z, w, vec);
}

// Kernel B: out += f32(round_T(scratch)); scratch = 0. Four values a thread
// where both pointers are 16-byte aligned (n4 = n / 4), the rest one each.
template <bool BF16>
__global__ void __launch_bounds__(THREADS) self_warp_add_finish_kernel(
    float* __restrict__ out, float* __restrict__ scratch, int n4, int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i < n4) {
    float4 s = reinterpret_cast<float4*>(scratch)[i];
    float4 o = reinterpret_cast<float4*>(out)[i];
    o.x += BF16 ? warp_tile::round_bf16(s.x) : s.x;
    o.y += BF16 ? warp_tile::round_bf16(s.y) : s.y;
    o.z += BF16 ? warp_tile::round_bf16(s.z) : s.z;
    o.w += BF16 ? warp_tile::round_bf16(s.w) : s.w;
    reinterpret_cast<float4*>(out)[i] = o;
    reinterpret_cast<float4*>(scratch)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    const int j = n4 * 4 + (i - n4);
    if (j < n) {
      const float s = scratch[j];
      out[j] += BF16 ? warp_tile::round_bf16(s) : s;
      scratch[j] = 0.f;
    }
  }
}

}  // namespace

// Kernel A of the fused step's backward: phi, g, out, scratch (B, X, Y, Z, 3)
// float32; scratch holds zeros or the sums of earlier launches.
extern "C" int self_warp_add_bwd_launch(const void* phi, const void* g, void* out,
                                        void* scratch, int B, int X, int Y, int Z,
                                        int payload_is_bf16, void* stream) {
  using S = TiledShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(phi);
  const float* gg = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  const int ntx = (X + S::TX - 1) / S::TX, nty = (Y + S::TY - 1) / S::TY,
            ntz = (Z + S::TZ - 1) / S::TZ;
  const int vec = Z % 4 == 0 && reinterpret_cast<uintptr_t>(gg) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(sc) % 16 == 0;
  const dim3 grid(ntx * nty * ntz, B);
  if (payload_is_bf16)
    self_warp_add_bwd_kernel<true><<<grid, S::THREADS, 0, s>>>(p, gg, o, sc, X, Y, Z, nty, ntz,
                                                               vec);
  else
    self_warp_add_bwd_kernel<false><<<grid, S::THREADS, 0, s>>>(p, gg, o, sc, X, Y, Z, nty, ntz,
                                                                vec);
  return (int)cudaGetLastError();
}

// Kernel B of the fused step's backward over n float32 values.
extern "C" int self_warp_add_finish_launch(void* out, void* scratch, int n,
                                           int payload_is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  float* sc = static_cast<float*>(scratch);
  const bool aligned = reinterpret_cast<uintptr_t>(o) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(sc) % 16 == 0;
  const int n4 = aligned ? n / 4 : 0;
  const int threads = n4 + (n - 4 * n4);
  if (threads == 0) return 0;
  const int blocks = (threads + THREADS - 1) / THREADS;
  if (payload_is_bf16)
    self_warp_add_finish_kernel<true><<<blocks, THREADS, 0, s>>>(o, sc, n4, n);
  else
    self_warp_add_finish_kernel<false><<<blocks, THREADS, 0, s>>>(o, sc, n4, n);
  return (int)cudaGetLastError();
}

// The general backward's finish: grad (bf16 or float32) = scratch rounded
// once, scratch = 0, over n values.
extern "C" int warp_bwd_finish_launch(void* grad, void* scratch, int n, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const bool aligned = reinterpret_cast<uintptr_t>(grad) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(sc) % 16 == 0;
  const int n4 = aligned ? n / 4 : 0;
  const int threads = n4 + (n - 4 * n4);
  if (threads == 0) return 0;
  const int blocks = (threads + THREADS - 1) / THREADS;
  if (is_bf16)
    warp_bwd_finish_kernel<__nv_bfloat16><<<blocks, THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(grad), sc, n4, n);
  else
    warp_bwd_finish_kernel<float><<<blocks, THREADS, 0, s>>>(static_cast<float*>(grad), sc, n4,
                                                             n);
  return (int)cudaGetLastError();
}

extern "C" int warp_bwd_launch(const void* vol, const void* coords,
                               const void* gout, void* gvol, void* gcoords,
                               int B, int X, int Y, int Z, int C, int N,
                               int Yo, int Zo, int coords_are_flow, int nearest,
                               int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + THREADS - 1) / THREADS, B);
  const float* cf = static_cast<const float*>(coords);
  float* gv = static_cast<float*>(gvol);
  float* gc = static_cast<float*>(gcoords);
  // a linear warp by a field on the volume's own grid with a volume gradient
  // to scatter: the tiled kernel (a flow-only gradient scatters nothing)
  if (gv != nullptr && coords_are_flow && !nearest && N == X * Y * Z && Yo == Y &&
      Zo == Z && C <= 4)
    return is_bf16 ? launch_warp_bwd_tiled_c<__nv_bfloat16>(vol, cf, gout, gv, gc, B, X, Y, Z, C, s)
                   : launch_warp_bwd_tiled_c<float>(vol, cf, gout, gv, gc, B, X, Y, Z, C, s);
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
