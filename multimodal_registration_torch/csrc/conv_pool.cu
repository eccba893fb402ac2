// K1 conv3_lrelu_pool: maxpool2(leaky_relu(conv3x3x3_SAME(x, w) + b, slope)).
//
// Replaces multimodal_registration_tpu/ops/pallas/conv_pool.py::conv3_lrelu_pool
// (the fused first U-Net level, enc_0). The full-resolution activation is never
// written: only the pooled tensor leaves the chip.
//
// Layouts: x (B, X, Y, Z, Cin) channels-last, bf16 or f32; w (27*Cin, Cout) f32
// with row k = ((dx*3 + dy)*3 + dz)*Cin + ci, already rounded to x's type by the
// wrapper; bias (Cout) f32; out (B, X/2, Y/2, Z/2, Cout) in x's type.
// Arithmetic: products of the (rounded) operands summed in f32 in tap order k,
// + f32 bias, LeakyReLU, max over the 2x2x2 window, one rounding to the output
// type.
//
// What bounds it on an H100 SXM (flagship shape 160x160x192x2 -> 64, bf16):
// device memory moves 19.7 MB of input and 78.6 MB of output, ~29 us at
// 3.35 TB/s; the work is 34 GFLOP, ~34 us on bf16 tensor cores but ~0.5 ms on
// the FP32 SIMT units this kernel uses. So it is bound by FP32 issue rate, and
// the next step is an implicit GEMM (K = 27*Cin) on the tensor cores.
//
// Design: one block owns a 2x4x8 tile of pooled outputs (a 4x8x16 full-res
// window). It stages the tile's (6x10x18)*Cin input halo, zero-filled outside
// the volume (SAME padding), and all weights in shared memory. A work item is
// one pooled voxel and CPT consecutive output channels; a thread keeps the
// 8 window voxels x CPT channels of accumulators in registers, so each tap
// costs 8 input loads and CPT/4 vector weight loads from shared memory for
// 8*CPT FMAs (the FMAs, not shared-memory traffic, set the pace). Neighbouring
// threads take neighbouring channel groups of one voxel, so a warp's input
// loads are broadcasts and its stores cover whole voxels. Batch is grid
// dimension y.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int PX = 2, PY = 4, PZ = 8;                  // pooled outputs per block
constexpr int HX = 2 * PX + 2, HY = 2 * PY + 2, HZ = 2 * PZ + 2;  // input halo
constexpr int NVOX = PX * PY * PZ;                     // 64 pooled voxels
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, int CPT>
__global__ void __launch_bounds__(THREADS) conv3_lrelu_pool_kernel(
    const T* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, T* __restrict__ out,
    int X, int Y, int Z, int Cin, int Cout, float slope,
    int tiles_y, int tiles_z) {
  extern __shared__ float4 smem4[];  // float4: vector weight loads stay aligned
  float* ws = reinterpret_cast<float*>(smem4);  // [27*Cin][Cout]
  float* hs = ws + 27 * Cin * Cout;             // [Cin][HX][HY][HZ]

  const int b = blockIdx.y;
  int t = blockIdx.x;
  const int tz = t % tiles_z;
  t /= tiles_z;
  const int ty = t % tiles_y;
  const int tx = t / tiles_y;
  const int px0 = tx * PX, py0 = ty * PY, pz0 = tz * PZ;
  const int gx0 = 2 * px0 - 1, gy0 = 2 * py0 - 1, gz0 = 2 * pz0 - 1;

  const int nw = 27 * Cin * Cout;
  for (int i = threadIdx.x; i < nw; i += THREADS) ws[i] = w[i];

  // halo: consecutive threads read consecutive channels-last addresses
  const int64_t vol = (int64_t)b * X * Y * Z * Cin;
  const int nh = HX * HY * HZ * Cin;
  for (int i = threadIdx.x; i < nh; i += THREADS) {
    const int ci = i % Cin;
    int r = i / Cin;
    const int hz = r % HZ;
    r /= HZ;
    const int hy = r % HY;
    const int hx = r / HY;
    const int gx = gx0 + hx, gy = gy0 + hy, gz = gz0 + hz;
    float v = 0.f;
    if (gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z)
      v = to_f(x[vol + (((int64_t)gx * Y + gy) * Z + gz) * Cin + ci]);
    hs[((ci * HX + hx) * HY + hy) * HZ + hz] = v;
  }
  __syncthreads();

  const int PXt = X / 2, PYt = Y / 2, PZt = Z / 2;
  const int groups = Cout / CPT;
  for (int item = threadIdx.x; item < NVOX * groups; item += THREADS) {
    const int c0 = (item % groups) * CPT;
    const int v = item / groups;
    const int lz = v % PZ, ly = (v / PZ) % PY, lx = v / (PZ * PY);
    const int px = px0 + lx, py = py0 + ly, pz = pz0 + lz;
    if (px >= PXt || py >= PYt || pz >= PZt) continue;

    float acc[8][CPT];
#pragma unroll
    for (int wv = 0; wv < 8; ++wv)
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[wv][j] = 0.f;

    for (int dx = 0; dx < 3; ++dx)
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz)
          for (int ci = 0; ci < Cin; ++ci) {
            const float* hp =
                hs + ((ci * HX + 2 * lx + dx) * HY + 2 * ly + dy) * HZ + 2 * lz + dz;
            float xv[8];
#pragma unroll
            for (int wv = 0; wv < 8; ++wv)
              xv[wv] = hp[(wv >> 2) * HY * HZ + ((wv >> 1) & 1) * HZ + (wv & 1)];
            const float* wr = ws + (((dx * 3 + dy) * 3 + dz) * Cin + ci) * Cout + c0;
            float wk[CPT];
            if constexpr (CPT % 4 == 0) {
#pragma unroll
              for (int q = 0; q < CPT / 4; ++q) {
                const float4 w4 = reinterpret_cast<const float4*>(wr)[q];
                wk[4 * q] = w4.x;
                wk[4 * q + 1] = w4.y;
                wk[4 * q + 2] = w4.z;
                wk[4 * q + 3] = w4.w;
              }
            } else {
#pragma unroll
              for (int j = 0; j < CPT; ++j) wk[j] = wr[j];
            }
#pragma unroll
            for (int wv = 0; wv < 8; ++wv)
#pragma unroll
              for (int j = 0; j < CPT; ++j) acc[wv][j] = fmaf(xv[wv], wk[j], acc[wv][j]);
          }

    T* o = out + ((((int64_t)b * PXt + px) * PYt + py) * PZt + pz) * Cout + c0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float bj = bias[c0 + j];
      float best = -INFINITY;
#pragma unroll
      for (int wv = 0; wv < 8; ++wv) {
        float a = acc[wv][j] + bj;
        a = a >= 0.f ? a : slope * a;
        best = fmaxf(best, a);
      }
      put(o + j, best);
    }
  }
}

template <typename T, int CPT>
int launch_cpt(const void* x, const float* w, const float* b, void* out, int B,
               int X, int Y, int Z, int Cin, int Cout, float slope,
               cudaStream_t stream) {
  const int tiles_x = (X / 2 + PX - 1) / PX;
  const int tiles_y = (Y / 2 + PY - 1) / PY;
  const int tiles_z = (Z / 2 + PZ - 1) / PZ;
  const size_t smem = sizeof(float) * (27 * Cin * Cout + Cin * HX * HY * HZ);
  auto kern = conv3_lrelu_pool_kernel<T, CPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(tiles_x * tiles_y * tiles_z, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(out), X, Y, Z, Cin, Cout,
      slope, tiles_y, tiles_z);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const void* x, const float* w, const float* b, void* out, int B,
             int X, int Y, int Z, int Cin, int Cout, float slope,
             cudaStream_t s) {
  if (Cout % 8 == 0) return launch_cpt<T, 8>(x, w, b, out, B, X, Y, Z, Cin, Cout, slope, s);
  if (Cout % 4 == 0) return launch_cpt<T, 4>(x, w, b, out, B, X, Y, Z, Cin, Cout, slope, s);
  return launch_cpt<T, 1>(x, w, b, out, B, X, Y, Z, Cin, Cout, slope, s);
}

}  // namespace

extern "C" int conv3_lrelu_pool_launch(const void* x, const void* w,
                                       const void* b, void* out, int B, int X,
                                       int Y, int Z, int Cin, int Cout,
                                       float slope, int is_bf16, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  if (is_bf16)
    return launch_t<__nv_bfloat16>(x, wf, bf, out, B, X, Y, Z, Cin, Cout, slope, s);
  return launch_t<float>(x, wf, bf, out, B, X, Y, Z, Cin, Cout, slope, s);
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
