// K2 warp_trilinear and K3 warp_up2x: the edge-clamped dense-displacement
// sampler of the registration forward.
//
// Replaces multimodal_registration_tpu/ops/warp.py::sample / warp / warp_batch
// (K2) and ::warp_up2x_batch (K3). The TPU design for this kernel
// (ops/pallas/warp3d.py) never compiled, because Mosaic had no in-kernel
// gathers; XLA gathers did the work there. On Hopper it is a plain gather.
//
// Semantics (ops/warp.py:1-10): out(x) = vol(clip(coord(x), 0, dim-1)) with
// coord = x + flow(x) (K2 in flow mode, K3) or an absolute coordinate (K2 in
// coordinate mode, for sample / affine_resample). Linear: i0 = floor(c),
// i1 = min(i0+1, dim-1), trilinear mix of the 8 corners in f32, corners in
// (dx, dy, dz) order, weight (wx*wy)*wz, one rounding to the volume's type.
// Nearest: round half to even (rintf; roundf would round half away from zero).
// Products and sums use __fmul_rn/__fadd_rn so that no FMA contraction makes
// the kernel differ from its plain PyTorch version.
//
// K3 computes, per full-res voxel, the corner-aligned 2x upsample of the
// half-res field on the fly (per axis: even i reads v[i/2], odd i reads
// 0.5*(v[(i-1)/2] + v[min((i+1)/2, n-1)]), z first, then y, then x, as
// ops/resize.py::_upsample2x_axis does), multiplies it by 2 and samples the
// moving image. The full-res field is never written.
//
// What bounds them on an H100 SXM: bytes. K2 on the integration field
// (1,80,80,96,3), bf16 payload: f32 flow read 7.4 MB, payload 3.7 MB (the
// gathers mostly hit L2), bf16 write 3.7 MB: ~15 MB, ~4.5 us at 3.35 TB/s,
// so launch overhead is of the same size. K3 at (1,160,160,192,1) f32 with a
// (1,80,80,96,3) field: 19.7 + 7.4 MB read, 19.7 MB written, ~14 us.
// Design: one thread per output voxel, looping over channels; neighbouring
// threads take neighbouring z, so coordinate reads and output writes are
// coalesced and corner gathers of neighbours share cache lines.
//
// self_warp_add (a second entry of K2): one squaring step of the
// scaling-and-squaring integration (ops/integrate.py::_integrate),
//   out = phi + f32(round_T(sum_k w_k * T(phi[corner_k]))),
// for a float32 field phi (B, X, Y, Z, 3) and payload type T (bf16 or f32),
// in one launch where the general kernel needs a cast of the field, the warp,
// a cast back and an add. The field is read once, as coordinates and as
// payload: a gathered corner is rounded to T in the register, which is what a
// gather from phi.to(T) gives; the mix keeps sample_point's order and
// roundings, is rounded once to T, and the add is float32: the step equals
// the four operations bit for bit. What bounds it: bytes (7.4 MB read and
// written at (1,80,80,96,3), ~4.4 us at 3.35 TB/s); the field stays in the
// 50 MB L2 from step to step, so what is left is instruction throughput and
// latency (24 gathers, a rounding for each with a bf16 payload, and the
// unfused multiplies and adds of the mix): 10 us on an H100. A block takes a
// 3-D tile of output voxels (warp_tile.cuh), 4 x 4 x 32 as measured, gathers
// the 24 corner values through the L1 (a shared-memory window of the field
// was no faster there) and writes its results through shared memory as
// 16-byte stores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "warp_tile.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float clampf(float c, int dim) {
  return fminf(fmaxf(c, 0.f), (float)(dim - 1));
}

// Sample vol (X, Y, Z, C) at (cx, cy, cz) into o[0..C).
template <typename T>
__device__ __forceinline__ void sample_point(const T* __restrict__ vol, int X,
                                             int Y, int Z, int C, float cx,
                                             float cy, float cz, int nearest,
                                             T* __restrict__ o) {
  cx = clampf(cx, X);
  cy = clampf(cy, Y);
  cz = clampf(cz, Z);
  if (nearest) {
    const int64_t lin =
        ((int64_t)(int)rintf(cx) * Y + (int)rintf(cy)) * Z + (int)rintf(cz);
    for (int c = 0; c < C; ++c) o[c] = vol[lin * C + c];
    return;
  }
  const float fx = floorf(cx), fy = floorf(cy), fz = floorf(cz);
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  const int xs[2] = {x0, min(x0 + 1, X - 1)};
  const int ys[2] = {y0, min(y0 + 1, Y - 1)};
  const int zs[2] = {z0, min(z0 + 1, Z - 1)};
  const float ax = __fsub_rn(cx, fx), ay = __fsub_rn(cy, fy), az = __fsub_rn(cz, fz);
  const float wxs[2] = {__fsub_rn(1.f, ax), ax};
  const float wys[2] = {__fsub_rn(1.f, ay), ay};
  const float wzs[2] = {__fsub_rn(1.f, az), az};
  float wk[8];
  int64_t lk[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    wk[k] = __fmul_rn(__fmul_rn(wxs[dx], wys[dy]), wzs[dz]);
    lk[k] = (((int64_t)xs[dx] * Y + ys[dy]) * Z + zs[dz]) * C;
  }
  for (int c = 0; c < C; ++c) {
    float acc = __fmul_rn(to_f(vol[lk[0] + c]), wk[0]);
#pragma unroll
    for (int k = 1; k < 8; ++k) acc = __fadd_rn(acc, __fmul_rn(to_f(vol[lk[k] + c]), wk[k]));
    put(o + c, acc);
  }
}

// K2: coords (B, N, 3) f32, either absolute or a displacement added to the
// index of output voxel n on the (Xo, Yo, Zo) grid with N = Xo*Yo*Zo.
template <typename T>
__global__ void __launch_bounds__(THREADS) warp_kernel(
    const T* __restrict__ vol, const float* __restrict__ coords,
    T* __restrict__ out, int X, int Y, int Z, int C, int N, int Yo, int Zo,
    int coords_are_flow, int nearest) {
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const float* cp = coords + ((int64_t)b * N + n) * 3;
  float cx = cp[0], cy = cp[1], cz = cp[2];
  if (coords_are_flow) {
    const int z = n % Zo, r = n / Zo;
    const int y = r % Yo, x = r / Yo;
    cx = __fadd_rn((float)x, cx);
    cy = __fadd_rn((float)y, cy);
    cz = __fadd_rn((float)z, cz);
  }
  sample_point(vol + (int64_t)b * X * Y * Z * C, X, Y, Z, C, cx, cy, cz,
               nearest, out + ((int64_t)b * N + n) * C);
}

// K3: vol (B, X, Y, Z, C), flow_half (B, X/2, Y/2, Z/2, 3) f32.
template <typename T>
__global__ void __launch_bounds__(THREADS) warp_up2x_kernel(
    const T* __restrict__ vol, const float* __restrict__ fh,
    T* __restrict__ out, int X, int Y, int Z, int C) {
  const int N = X * Y * Z;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int b = blockIdx.y;
  const int z = n % Z, r = n / Z;
  const int y = r % Y, x = r / Y;
  const int Xh = X / 2, Yh = Y / 2, Zh = Z / 2;
  const int xa = x >> 1, ya = y >> 1, za = z >> 1;
  const int xb = min(xa + 1, Xh - 1), yb = min(ya + 1, Yh - 1), zb = min(za + 1, Zh - 1);
  const bool ox = x & 1, oy = y & 1, oz = z & 1;
  const float* f = fh + (int64_t)b * Xh * Yh * Zh * 3;
  float d[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float vy[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int xi = i ? xb : xa;
      float vz[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int yj = j ? yb : ya;
        const int64_t row = ((int64_t)xi * Yh + yj) * Zh;
        const float lo = f[(row + za) * 3 + ch];
        vz[j] = oz ? __fmul_rn(0.5f, __fadd_rn(lo, f[(row + zb) * 3 + ch])) : lo;
      }
      vy[i] = oy ? __fmul_rn(0.5f, __fadd_rn(vz[0], vz[1])) : vz[0];
    }
    const float u = ox ? __fmul_rn(0.5f, __fadd_rn(vy[0], vy[1])) : vy[0];
    d[ch] = __fmul_rn(2.f, u);
  }
  sample_point(vol + (int64_t)b * N * C, X, Y, Z, C, __fadd_rn((float)x, d[0]),
               __fadd_rn((float)y, d[1]), __fadd_rn((float)z, d[2]), 0,
               out + ((int64_t)b * N + n) * C);
}

// ---- the fused squaring step ------------------------------------------------

using StepShape = warp_tile::Shape<4, 4, 32, 0, 256>;

template <bool BF16>
__global__ void __launch_bounds__(StepShape::THREADS) self_warp_add_kernel(
    const float* __restrict__ phi, float* __restrict__ out, int X, int Y, int Z,
    int nty, int ntz, int vec) {
  using S = StepShape;
  __shared__ __align__(16) float obuf[S::VOX * 3];  // (TX, TY, TZ, 3): the output's tile
  int tx0, ty0, tz0;
  warp_tile::tile_origin<S>(nty, ntz, tx0, ty0, tz0);
  const int nvol = X * Y * Z * 3;
  const float* pb = phi + blockIdx.y * nvol;
  for (int v = threadIdx.x; v < S::VOX; v += S::THREADS) {
    const int lz = v % S::TZ, r = v / S::TZ;
    const int x = tx0 + r / S::TY, y = ty0 + r % S::TY, z = tz0 + lz;
    if (x >= X || y >= Y || z >= Z) continue;
    const float* q = pb + ((x * Y + y) * Z + z) * 3;
    const float d[3] = {q[0], q[1], q[2]};
    const warp_tile::Corners k = warp_tile::corners_of(
        __fadd_rn((float)x, d[0]), __fadd_rn((float)y, d[1]), __fadd_rn((float)z, d[2]),
        X, Y, Z);
    // the mix of the corners, each rounded to the payload type at the read
    float a[3];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const int dx = kk >> 2, dy = (kk >> 1) & 1, dz = kk & 1;
      const float wk = __fmul_rn(__fmul_rn(k.wx[dx], k.wy[dy]), k.wz[dz]);
      const float* c = pb + ((k.xs[dx] * Y + k.ys[dy]) * Z + k.zs[dz]) * 3;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float t = __fmul_rn(BF16 ? warp_tile::round_bf16(c[ch]) : c[ch], wk);
        a[ch] = kk == 0 ? t : __fadd_rn(a[ch], t);
      }
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      obuf[v * 3 + ch] = __fadd_rn(d[ch], BF16 ? warp_tile::round_bf16(a[ch]) : a[ch]);
  }
  __syncthreads();
  warp_tile::move_tile<S, 3, true>(obuf, out + blockIdx.y * nvol, X, Y, Z, tx0, ty0, tz0, vec);
}

}  // namespace

// One squaring step: phi, out (B, X, Y, Z, 3) float32, out != phi.
extern "C" int self_warp_add_launch(const void* phi, void* out, int B, int X, int Y, int Z,
                                    int payload_is_bf16, void* stream) {
  using S = StepShape;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(phi);
  float* o = static_cast<float*>(out);
  const int ntx = (X + S::TX - 1) / S::TX, nty = (Y + S::TY - 1) / S::TY,
            ntz = (Z + S::TZ - 1) / S::TZ;
  const int vec = Z % 4 == 0 && reinterpret_cast<uintptr_t>(o) % 16 == 0;
  const dim3 grid(ntx * nty * ntz, B);
  if (payload_is_bf16)
    self_warp_add_kernel<true><<<grid, S::THREADS, 0, s>>>(p, o, X, Y, Z, nty, ntz, vec);
  else
    self_warp_add_kernel<false><<<grid, S::THREADS, 0, s>>>(p, o, X, Y, Z, nty, ntz, vec);
  return (int)cudaGetLastError();
}

extern "C" int warp_launch(const void* vol, const void* coords, void* out,
                           int B, int X, int Y, int Z, int C, int N, int Yo,
                           int Zo, int coords_are_flow, int nearest,
                           int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + THREADS - 1) / THREADS, B);
  const float* cf = static_cast<const float*>(coords);
  if (is_bf16)
    warp_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), cf,
        static_cast<__nv_bfloat16*>(out), X, Y, Z, C, N, Yo, Zo,
        coords_are_flow, nearest);
  else
    warp_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(vol), cf, static_cast<float*>(out), X, Y, Z,
        C, N, Yo, Zo, coords_are_flow, nearest);
  return (int)cudaGetLastError();
}

extern "C" int warp_up2x_launch(const void* vol, const void* flow_half,
                                void* out, int B, int X, int Y, int Z, int C,
                                int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((X * Y * Z + THREADS - 1) / THREADS, B);
  const float* ff = static_cast<const float*>(flow_half);
  if (is_bf16)
    warp_up2x_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vol), ff,
        static_cast<__nv_bfloat16*>(out), X, Y, Z, C);
  else
    warp_up2x_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(vol), ff, static_cast<float*>(out), X, Y, Z, C);
  return (int)cudaGetLastError();
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
