// Shared pieces of the tiled self-warp kernels (csrc/warp.cu: the fused
// squaring step; csrc/warp_bwd.cu: its backward and the tiled scatter of the
// general warp backward).
//
// A block owns a 3-D tile of TX x TY x TZ output voxels of a channels-last
// volume (X, Y, Z, C); its inputs and results move between global memory and
// a tile buffer in shared memory in 16-byte chunks. The backward kernels also
// keep a *window* of float32 sums in shared memory: the tile plus a halo of R
// voxels on every side, moved by the rounded displacement of the tile's
// centre voxel, so that a large coherent shift still lands inside it. The
// window's z origin is rounded down to a multiple of 4 voxels: with
// Z % 4 == 0 every 16-byte chunk of a window row is then 16-byte aligned in
// global memory and lies wholly inside or wholly outside the volume, so the
// window is flushed with vector atomics. Other shapes take the scalar path.
//
// Whether a corner lies in the window is decided on its clamped integer
// index, per block; a contribution to a corner outside goes to global memory,
// so every displacement stays correct. Offsets are 32-bit: the wrappers
// refuse tensors of 2^31 elements.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace warp_tile {

template <int TX_, int TY_, int TZ_, int R_, int THREADS_>
struct Shape {
  static constexpr int TX = TX_, TY = TY_, TZ = TZ_, R = R_, THREADS = THREADS_;
  static constexpr int WX = TX + 2 * R, WY = TY + 2 * R;
  // + 3 voxels of slack for the alignment of the origin, then a multiple of 4
  static constexpr int WZ = (TZ + 2 * R + 3 + 3) / 4 * 4;
  static constexpr int VOX = TX * TY * TZ;   // output voxels of a tile
  static constexpr int WIN = WX * WY * WZ;   // voxels of a window
  static_assert(TZ % 4 == 0, "a tile row must be a whole number of 16-byte chunks");
};

struct Window {
  int x0, y0, z0;  // volume index of the window's first voxel; z0 % 4 == 0
};

// The tile of this block: blockIdx.x counts tiles with z fastest.
template <class S>
__device__ __forceinline__ void tile_origin(int nty, int ntz, int& tx0, int& ty0, int& tz0) {
  const int t = blockIdx.x;
  tz0 = (t % ntz) * S::TZ;
  const int r = t / ntz;
  ty0 = (r % nty) * S::TY;
  tx0 = (r / nty) * S::TX;
}

// Window of the tile at (tx0, ty0, tz0), moved by the rounded displacement
// `flow` (X, Y, Z, 3) has at the tile's centre voxel. Every thread reads the
// same three values (one broadcast), so no thread waits for another.
template <class S>
__device__ __forceinline__ Window window_of(const float* __restrict__ flow, int X, int Y, int Z,
                                            int tx0, int ty0, int tz0) {
  Window w;
  const int cx = min(tx0 + S::TX / 2, X - 1), cy = min(ty0 + S::TY / 2, Y - 1),
            cz = min(tz0 + S::TZ / 2, Z - 1);
  const float* p = flow + ((cx * Y + cy) * Z + cz) * 3;
  // clamped before the conversion: a NaN or huge value must not overflow
  const int sx = (int)rintf(fminf(fmaxf(p[0], -(float)X), (float)X));
  const int sy = (int)rintf(fminf(fmaxf(p[1], -(float)Y), (float)Y));
  const int sz = (int)rintf(fminf(fmaxf(p[2], -(float)Z), (float)Z));
  w.x0 = tx0 - S::R + sx;
  w.y0 = ty0 - S::R + sy;
  w.z0 = (tz0 - S::R + sz) & ~3;  // floor to a multiple of 4, negatives too
  return w;
}

// Offset (in voxels) of volume voxel (x, y, z) inside the window, or -1.
template <class S>
__device__ __forceinline__ int window_offset(const Window& w, int x, int y, int z) {
  const unsigned ux = x - w.x0, uy = y - w.y0, uz = z - w.z0;
  return (ux < (unsigned)S::WX && uy < (unsigned)S::WY && uz < (unsigned)S::WZ)
             ? (int)((ux * S::WY + uy) * S::WZ + uz) : -1;
}

// Rows of the block's tile between global memory `g` (X, Y, Z, C) and the
// tile buffer `buf` (TX, TY, TZ, C), in 16-byte chunks; parts of the tile
// outside the volume are skipped. No barrier.
template <class S, int C, bool STORE>
__device__ __forceinline__ void move_tile(float* __restrict__ buf, float* __restrict__ g, int X,
                                          int Y, int Z, int tx0, int ty0, int tz0, int vec) {
  constexpr int ROWF = S::TZ * C;
  constexpr int CH = ROWF / 4;
  const int zf = Z * C;
  for (int i = threadIdx.x; i < S::TX * S::TY * CH; i += S::THREADS) {
    const int ch = i % CH, row = i / CH;
    const int x = tx0 + row / S::TY, y = ty0 + row % S::TY;
    if (x >= X || y >= Y) continue;
    const int f0 = tz0 * C + ch * 4;
    float* b = buf + row * ROWF + ch * 4;
    float* p = g + (x * Y + y) * zf + f0;
    if (vec) {
      if (f0 + 4 <= zf) {
        if (STORE) *reinterpret_cast<float4*>(p) = *reinterpret_cast<const float4*>(b);
        else *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(p);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f0 + j < zf) {
          if (STORE) p[j] = b[j];
          else b[j] = p[j];
        }
    }
  }
}

// Add the block's float32 sums `acc` (WX, WY, WZ, C) into `dst` (X, Y, Z, C)
// with one global atomic per touched element: a 16-byte vector atomic
// (compute capability 9.x) per chunk that holds a non-zero where `vec`.
template <class S, int C>
__device__ __forceinline__ void flush_window(const float* __restrict__ acc, float* __restrict__ dst,
                                             int X, int Y, int Z, const Window& w, int vec) {
  constexpr int ROWF = S::WZ * C;
  constexpr int CH = ROWF / 4;
  const int zf = Z * C;
  for (int i = threadIdx.x; i < S::WX * S::WY * CH; i += S::THREADS) {
    const int ch = i % CH, row = i / CH;
    const int x = w.x0 + row / S::WY, y = w.y0 + row % S::WY;
    if ((unsigned)x >= (unsigned)X || (unsigned)y >= (unsigned)Y) continue;
    const int f0 = w.z0 * C + ch * 4;
    const float4 a = *reinterpret_cast<const float4*>(acc + row * ROWF + ch * 4);
    float* p = dst + (x * Y + y) * zf + f0;
    if (vec) {
      if (f0 >= 0 && f0 + 4 <= zf && (a.x != 0.f || a.y != 0.f || a.z != 0.f || a.w != 0.f))
        atomicAdd(reinterpret_cast<float4*>(p), a);
    } else {
      const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (f0 + j >= 0 && f0 + j < zf && v[j] != 0.f) atomicAdd(p + j, v[j]);
    }
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Clamped coordinate, corner indices and the trilinear weights of the plain
// version: i0 = floor(c), i1 = min(i0 + 1, dim - 1), weight (wx * wy) * wz in
// (dx, dy, dz) order, every product rounded on its own (no FMA contraction).
struct Corners {
  int xs[2], ys[2], zs[2];
  float wx[2], wy[2], wz[2];
};

__device__ __forceinline__ Corners corners_of(float cx, float cy, float cz, int X, int Y, int Z) {
  Corners k;
  cx = fminf(fmaxf(cx, 0.f), (float)(X - 1));
  cy = fminf(fmaxf(cy, 0.f), (float)(Y - 1));
  cz = fminf(fmaxf(cz, 0.f), (float)(Z - 1));
  const float fx = floorf(cx), fy = floorf(cy), fz = floorf(cz);
  k.xs[0] = (int)fx; k.xs[1] = min(k.xs[0] + 1, X - 1);
  k.ys[0] = (int)fy; k.ys[1] = min(k.ys[0] + 1, Y - 1);
  k.zs[0] = (int)fz; k.zs[1] = min(k.zs[0] + 1, Z - 1);
  const float ax = __fsub_rn(cx, fx), ay = __fsub_rn(cy, fy), az = __fsub_rn(cz, fz);
  k.wx[0] = __fsub_rn(1.f, ax); k.wx[1] = ax;
  k.wy[0] = __fsub_rn(1.f, ay); k.wy[1] = ay;
  k.wz[0] = __fsub_rn(1.f, az); k.wz[1] = az;
  return k;
}

// d/dc of min(max(c, 0), hi) at the unclipped coordinate c: 1 inside, 0
// outside, one half at equality with a bound (each of max and min splits
// its derivative evenly between equal arguments).
__device__ __forceinline__ float clip_grad(float c, float hi) {
  const float lo_d = c > 0.f ? 1.f : (c == 0.f ? 0.5f : 0.f);
  const float m = fmaxf(c, 0.f);
  const float hi_d = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return lo_d * hi_d;
}

}  // namespace warp_tile
