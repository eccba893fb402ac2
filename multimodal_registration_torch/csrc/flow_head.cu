// K9 flow_head: the flow head of VxmDense, the float32 3x3x3 SAME conv from
// the U-Net's C features to the 3-channel SVF, its forward and both gradients.
//
// Replaces no Pallas kernel: the JAX package runs the head as an XLA conv
// (multimodal_registration_tpu/models/vxm_dense.py:116, nn.Conv(3, (3, 3, 3))
// in float32 on feat.astype(float32)). It was added because the library conv
// that the port first used for it (an implicit GEMM, float32 without TF32) ran
// at about 3.7% of the card's float32 rate: three output channels leave an
// implicit GEMM's tiles nearly empty in N, and its weight gradient ran at
// 0.9%. The head was then the largest layer of the training step and the
// second of the forward.
//
//   forward  svf[b, v, o]   = bias[o] + sum_{tap, c} w[o, c, tap] * feat[b, v + tap - 1, c]
//   dgrad    dfeat[b, v, c] = sum_{tap, o} w[o, c, tap] * g[b, v - tap + 1, o]
//   wgrad    dw[o, c, tap]  = sum_{b, v} feat[b, v + tap - 1, c] * g[b, v, o],
//            db[o]          = sum_{b, v} g[b, v, o]
// with zeros outside the grid. feat (B, X, Y, Z, C) channels-last, bf16 or
// f32; w (3, C, 3, 3, 3) f32 in PyTorch's layout, tap = (dx*3 + dy)*3 + dz;
// svf and g (B, X, Y, Z, 3) f32; dfeat in feat's type. Every product and sum
// is float32 on the FMA units (a bf16 feature converts to float32 exactly);
// dfeat in bf16 is rounded once from its float32 sum.
//
// What bounds it on an H100 SXM: float32 FMAs. Each entry is 2 * V * 27 * C * 3
// operations: at the flagship head (80 x 80 x 96, C = 64) 6.37 GFLOP, 95 us
// at 66.9 TFLOP/s, against 79 MB of bf16 features (24 us at 3.35 TB/s); at
// C = 256 four times that.
//
// Design: the channel dimension lies across the lanes of a warp. A lane owns
// a slot of VEC channels (VEC = 2 for bf16 with C even: one 32-bit word per
// voxel, so that a warp reads one voxel's 64 channels as 128 contiguous
// bytes; VEC = 1 otherwise); C > 32 * VEC takes several groups of 32 slots.
// The weights of a slot for one (dx, dy) are 9 * VEC values per output,
// staged by each block in shared memory so that lane i reads bank i.
//  * forward: a block of TY = 4 warps owns 4 neighbouring z-lines, a warp ZB =
//    32 consecutive voxels of its line and their 3 outputs in registers:
//    ZB x 3 partial sums over the lane's channels. The inputs pass through
//    shared memory one channel group and one x-plane at a time (6 lines of
//    ZB + 2 voxels, cp.async, zeros
//    outside the volume; 47 KB a block with the weights, so that 4 blocks
//    share an SM). For each (dx, dy) a warp walks the ZB + 2 inputs of one
//    line once; each input feeds 3 dz x 3 outputs x VEC channels. The 3-wide
//    output costs nothing: outputs are never a tile dimension, and each input
//    is reused 9 times from a register. At the end the warp sums its 32
//    lanes' partial sums by recursive halving (each step exchanges half of
//    the values still held), which leaves lane l with the sums of voxel l:
//    ZB * 3 sums in ZB * 3 - 3 shuffles, in a fixed order.
//  * dgrad: the same block layout, transposed: a warp owns ZB voxels x its
//    lane's channels of one group; the block stages the 3-channel cotangent
//    around its lines as float4, which every lane reads at once, and a warp
//    writes its channels as one 32-bit word a voxel. No reduction across
//    lanes.
//  * wgrad: a block owns one dx, one channel group and a range of z-lines;
//    a lane holds the 3 dy x 3 dz x VEC x 3 sums of its channels and walks
//    its lines along z with a rolling window of inputs per dy, read from
//    device memory one step ahead of their use. The block's warps are summed
//    in shared memory in warp order; a second pass sums the blocks' partials
//    in block order. No float atomics: a training step is bit-for-bit
//    reproducible.
//  * Lines and z-blocks inside the volume take no bounds checks in their
//    inner loops; the borders are zeros staged in shared memory (forward,
//    dgrad) or checked once per z-line (wgrad).
// Measured on an H100 SXM at 700 W (chip_smoke.py phase 16): at the flagship
// head 40 % (forward), 50 % (dgrad) and 38 % (wgrad) of the FMA bound.
// The wrapper is multimodal_registration_torch/ops/flow_head.py, which also
// holds the three plain versions that the tests hold these entries against.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WGRAD_WARPS = 8;
constexpr int ZB = 32;  // the voxels along z of a forward or input-gradient warp, one a lane

// A slot's word as float32: the value's bits (VEC = 1), or the bf16 pair as
// it lies in memory (VEC = 2)
__device__ __forceinline__ void unpack(uint32_t w, float (&v)[1]) { v[0] = __uint_as_float(w); }
__device__ __forceinline__ void unpack(uint32_t w, float (&v)[2]) {
  v[0] = __uint_as_float(w << 16);          // the lower address: channel 2s
  v[1] = __uint_as_float(w & 0xffff0000u);  // channel 2s + 1
}

// VEC channels of one voxel as float32
__device__ __forceinline__ void load_slot(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
__device__ __forceinline__ void load_slot(const __nv_bfloat16* p, float (&v)[1]) {
  unpack(static_cast<uint32_t>(__ldg(reinterpret_cast<const unsigned short*>(p))) << 16, v);
}
__device__ __forceinline__ void load_slot(const __nv_bfloat16* p, float (&v)[2]) {
  unpack(__ldg(reinterpret_cast<const unsigned int*>(p)), v);
}
template <int VEC>
__device__ __forceinline__ void zero(float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = 0.f;
}

__device__ __forceinline__ void store_slot(float* p, const float (&v)[1]) { *p = v[0]; }
__device__ __forceinline__ void store_slot(__nv_bfloat16* p, const float (&v)[1]) {
  *p = __float2bfloat16_rn(v[0]);
}
__device__ __forceinline__ void store_slot(__nv_bfloat16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// One step of the recursive halving and the steps below it: lanes l and
// l ^ M exchange the half of acc[0, 2M) that the other keeps; lane l keeps
// the upper half when bit M of l is set. After the last step acc[0] holds,
// in lane l, the sum over the 32 lanes of voxel l.
template <int M>
__device__ __forceinline__ void halve(float (&acc)[ZB][3], int lane) {
  if constexpr (M >= 1) {
    const bool up = (lane & M) != 0;
#pragma unroll
    for (int q = 0; q < M; ++q)
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float send = up ? acc[q][o] : acc[q + M][o];
        const float keep = up ? acc[q + M][o] : acc[q][o];
        acc[q][o] = keep + __shfl_xor_sync(FULL, send, M);
      }
    halve<M / 2>(acc, lane);
  }
}

// A forward or input-gradient block owns TY z-lines (one a warp) at
// (x, y0 .. y0 + TY - 1) over the z-block [z0, z0 + ZB). Its inputs are the
// 3 x-planes x (TY + 2) y-lines around them, each at z0 - 1 .. z0 + ZB, zero
// outside the volume: ROWS rows of ZB + 2 voxels, row a * (TY + 2) + ry at
// (x + a - 1, y0 + ry - 1).
constexpr int TY = 4;
constexpr int ROWS = 3 * (TY + 2);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// One channel group's weights: ws[((dx * 3 + dy) * 9 * VEC + k) * 32 + lane] =
// w[o, c, dx, dy, dz], c = (g * 32 + lane) * VEC + j, k = (j * 3 + o) * 3 + dz;
// zero where c >= C. Lane i reads bank i. A thread copies the 27 taps of one
// (o, c) at a time.
template <int VEC>
__device__ __forceinline__ void stage_weights(const float* __restrict__ w, float* ws, int C,
                                              int g) {
  constexpr int KV = 9 * VEC;
  for (int r = threadIdx.x; r < 3 * 32 * VEC; r += blockDim.x) {
    const int j = r % VEC, lane = (r / VEC) % 32, o = r / (32 * VEC);
    const int c = (g * 32 + lane) * VEC + j;
    const float* src = w + ((long long)o * C + c) * 27;
    float* dst = ws + (j * 3 + o) * 3 * 32 + lane;
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int dz = 0; dz < 3; ++dz)
        dst[(t * KV + dz) * 32] = c < C ? __ldg(src + t * 3 + dz) : 0.f;
  }
}

// The features of channel group g on x-plane x + dx - 1 of the block's
// inputs (its TY + 2 rows), 32 words a voxel: for VEC = 2 the bf16 pair of
// lane i's slot as it lies in memory, for VEC = 1 the float32 value's bits.
// With C a multiple of 64 and VEC = 2 a voxel's 128 bytes of the group are
// contiguous and 16-byte aligned: cp.async, zero-filled outside the volume.
// Otherwise one word a thread, zero for idle lanes.
template <typename T, int VEC>
__device__ __forceinline__ void stage_plane(const T* __restrict__ feat, uint32_t* tile,
                                            long long b, int xx, int y0, int z0, int X, int Y,
                                            int Z, int C, int g) {
  constexpr int NZ = ZB + 2;
  const int S = (C + VEC - 1) / VEC;
  for (int ry = 0; ry < TY + 2; ++ry) {
    const int yy = y0 + ry - 1;
    const bool row_ok = xx >= 0 && xx < X && yy >= 0 && yy < Y;
    const T* line =
        feat + ((b * X + (row_ok ? xx : 0)) * Y + (row_ok ? yy : 0)) * (long long)Z * C;
    uint32_t* dst = tile + ry * NZ * 32;
    if (VEC == 2 && C % 64 == 0) {
      for (int k = threadIdx.x; k < NZ * 8; k += blockDim.x) {
        const int zz = z0 - 1 + (k >> 3);
        const bool ok = row_ok && zz >= 0 && zz < Z;
        cp_async16(dst + k * 4, ok ? line + zz * C + g * 64 + (k & 7) * 8 : feat, ok ? 16 : 0);
      }
    } else {
      for (int k = threadIdx.x; k < NZ * 32; k += blockDim.x) {
        const int s = g * 32 + (k & 31), zz = z0 - 1 + (k >> 5);
        uint32_t word = 0u;
        if (row_ok && s < S && zz >= 0 && zz < Z) {
          const T* p = line + zz * C + s * VEC;
          if constexpr (VEC == 2) {
            word = __ldg(reinterpret_cast<const unsigned int*>(p));
          } else {
            float v[1];
            load_slot(p, v);
            word = __float_as_uint(v[0]);
          }
        }
        dst[k] = word;
      }
    }
  }
  cp_async_wait_all();
}

// ---- forward ----------------------------------------------------------------
// A block: the z-block [z0, z0 + ZB) of the TY z-lines (b, x, y0 + warp). Its
// inputs pass through shared memory one channel group and one x-plane at a
// time (47 KB a block, so that four blocks share an SM).
template <typename T, int VEC>
__global__ void __launch_bounds__(TY * 32, 4) flow_head_fwd_kernel(
    const T* __restrict__ feat, const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ out, int X, int Y, int Z, int C, int NG, int nyb, int nzb) {
  extern __shared__ float4 smem4[];
  constexpr int KV = 9 * VEC, NZ = ZB + 2;
  float* ws = reinterpret_cast<float*>(smem4);
  uint32_t* tile = reinterpret_cast<uint32_t*>(ws + 9 * KV * 32);  // [TY + 2][NZ][32]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long r = blockIdx.x;
  const int z0 = (int)(r % nzb) * ZB;
  r /= nzb;
  const int y0 = (int)(r % nyb) * TY;
  r /= nyb;
  const int x = (int)(r % X);
  const long long b = r / X;

  float acc[ZB][3];
#pragma unroll
  for (int q = 0; q < ZB; ++q)
#pragma unroll
    for (int o = 0; o < 3; ++o) acc[q][o] = 0.f;

  for (int g = 0; g < NG; ++g) {
#pragma unroll 1
    for (int dx = 0; dx < 3; ++dx) {
      if (g > 0 || dx > 0) __syncthreads();  // every warp is done with the last plane
      if (dx == 0) stage_weights<VEC>(w, ws, C, g);
      stage_plane<T, VEC>(feat, tile, b, x + dx - 1, y0, z0, X, Y, Z, C, g);
      __syncthreads();
#pragma unroll 1
      for (int dy = 0; dy < 3; ++dy) {
        float wk[KV];
#pragma unroll
        for (int k = 0; k < KV; ++k) wk[k] = ws[((dx * 3 + dy) * KV + k) * 32 + lane];
        const uint32_t* row = tile + (warp + dy) * NZ * 32 + lane;
#pragma unroll
        for (int i = 0; i < NZ; ++i) {  // input z = z0 - 1 + i
          float v[VEC];
          unpack(row[i * 32], v);
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const int q = i - dz;  // output z = z0 + q
            if (q < 0 || q >= ZB) continue;
#pragma unroll
            for (int o = 0; o < 3; ++o)
#pragma unroll
              for (int j = 0; j < VEC; ++j)
                acc[q][o] = fmaf(v[j], wk[(j * 3 + o) * 3 + dz], acc[q][o]);
          }
        }
      }
    }
  }

  halve<ZB / 2>(acc, lane);
  const int y = y0 + warp, z = z0 + lane;
  if (y < Y && z < Z) {
    float* op = out + (((b * X + x) * Y + y) * (long long)Z + z) * 3;
#pragma unroll
    for (int o = 0; o < 3; ++o) op[o] = acc[0][o] + bias[o];
  }
}

// ---- input gradient -----------------------------------------------------------
// A block: the z-block [z0, z0 + ZB) of the TY z-lines (b, x, y0 + warp),
// channel group g. The cotangent over the tile is staged as float4 (x, y, z,
// 0), which every lane reads at once.
template <typename T, int VEC>
__global__ void __launch_bounds__(TY * 32, 4) flow_head_dgrad_kernel(
    const float* __restrict__ gsvf, const float* __restrict__ w, T* __restrict__ dfeat,
    int X, int Y, int Z, int C, int NG, int nyb, int nzb) {
  extern __shared__ float4 smem4[];
  constexpr int KV = 9 * VEC, NZ = ZB + 2;
  float4* gt = smem4;                                     // [ROWS][NZ]
  float* ws = reinterpret_cast<float*>(smem4 + ROWS * NZ);  // one group's weights
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long r = blockIdx.x;
  const int g = (int)(r % NG);
  r /= NG;
  const int z0 = (int)(r % nzb) * ZB;
  r /= nzb;
  const int y0 = (int)(r % nyb) * TY;
  r /= nyb;
  const int x = (int)(r % X);
  const long long b = r / X;

  stage_weights<VEC>(w, ws, C, g);
  for (int k = threadIdx.x; k < ROWS * NZ; k += blockDim.x) {
    const int i = k % NZ, row = k / NZ;
    const int xx = x + row / (TY + 2) - 1, yy = y0 + row % (TY + 2) - 1, zz = z0 - 1 + i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (xx >= 0 && xx < X && yy >= 0 && yy < Y && zz >= 0 && zz < Z) {
      const float* p = gsvf + (((b * X + xx) * Y + yy) * (long long)Z + zz) * 3;
      v = make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), 0.f);
    }
    gt[k] = v;
  }
  __syncthreads();

  float acc[ZB][VEC];
#pragma unroll
  for (int q = 0; q < ZB; ++q) zero(acc[q]);
#pragma unroll 1
  for (int t = 0; t < 9; ++t) {  // (dx, dy): the source line (x + 1 - dx, y + 1 - dy)
    float wk[KV];
#pragma unroll
    for (int k = 0; k < KV; ++k) wk[k] = ws[(t * KV + k) * 32 + lane];
    const float4* row = gt + ((2 - t / 3) * (TY + 2) + warp + 2 - t % 3) * NZ;
#pragma unroll
    for (int i = 0; i < NZ; ++i) {  // source z = z0 - 1 + i
      const float4 g4 = row[i];
      const float gv[3] = {g4.x, g4.y, g4.z};
#pragma unroll
      for (int dz = 0; dz < 3; ++dz) {
        const int q = i + dz - 2;  // output z = z0 + q
        if (q < 0 || q >= ZB) continue;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
#pragma unroll
          for (int o = 0; o < 3; ++o)
            acc[q][j] = fmaf(gv[o], wk[(j * 3 + o) * 3 + dz], acc[q][j]);
      }
    }
  }

  const int s = g * 32 + lane, y = y0 + warp;
  if (s >= (C + VEC - 1) / VEC || y >= Y) return;
  T* dl = dfeat + ((b * X + x) * Y + y) * (long long)Z * C + s * VEC;
#pragma unroll
  for (int q = 0; q < ZB; ++q)
    if (z0 + q < Z) store_slot(dl + (z0 + q) * C, acc[q]);
}

// One z of the weight gradient's walk along a line. The window fw[dy][zz % 4]
// holds the inputs zz = z - 1 .. z + 1 of each dy line and receives z + 2,
// used a step later, so that a load has a whole step to arrive; the
// cotangent likewise (gq[zz % 2] holds z, receives z + 1). Then 3 dy x 3 dz x
// VEC x 3 products. TAIL: z + 1 or z + 2 may leave the volume; CHECKED: a dy
// line may lie outside the volume, or the lane be idle (fv false). Such
// inputs read a voxel that exists and are zeroed.
template <int U, bool CHECKED, bool TAIL, typename T, int VEC>
__device__ __forceinline__ void wgrad_z(float (&acc)[3][3][VEC][3], float (&gs)[3],
                                        float (&fw)[3][4][VEC], float (&gq)[2][3],
                                        const T* const (&fl)[3], const bool (&fv)[3],
                                        const float* gl, int z, int Z, int C, bool with_bias) {
  const bool ok2 = !TAIL || z + 2 < Z, ok1 = !TAIL || z + 1 < Z;
  const int z2 = ok2 ? z + 2 : z, z1 = ok1 ? z + 1 : z;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    float(&nx)[VEC] = fw[dy][(U + 2) % 4];
    load_slot(fl[dy] + z2 * C, nx);
    if (CHECKED || TAIL) {
      const bool ok = ok2 && (!CHECKED || fv[dy]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) nx[j] = ok ? nx[j] : 0.f;
    }
  }
  const float gv[3] = {gq[U % 2][0], gq[U % 2][1], gq[U % 2][2]};
#pragma unroll
  for (int o = 0; o < 3; ++o) {
    const float v = __ldg(gl + z1 * 3 + o);
    gq[(U + 1) % 2][o] = ok1 ? v : 0.f;
  }
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
#pragma unroll
        for (int o = 0; o < 3; ++o)  // input zz = z + dz - 1, in slot (U + dz + 3) % 4
          acc[dy][dz][j][o] = fmaf(fw[dy][(U + dz + 3) % 4][j], gv[o], acc[dy][dz][j][o]);
  if (with_bias) {
#pragma unroll
    for (int o = 0; o < 3; ++o) gs[o] += gv[o];
  }
}

// The weight gradient's walk along one z-line (its dy lines fl, the cotangent
// gl): z in groups of four, so that the window's slots are static; the last
// groups with the inputs ahead checked.
template <bool CHECKED, typename T, int VEC>
__device__ __forceinline__ void wgrad_line(float (&acc)[3][3][VEC][3], float (&gs)[3],
                                           const T* const (&fl)[3], const bool (&fv)[3],
                                           const float* gl, int Z, int C, bool with_bias) {
  float fw[3][4][VEC], gq[2][3];
  const int z1 = Z > 1 ? 1 : 0;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    zero(fw[dy][3]);  // zz = -1
    load_slot(fl[dy], fw[dy][0]);
    load_slot(fl[dy] + z1 * C, fw[dy][1]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      fw[dy][0][j] = !CHECKED || fv[dy] ? fw[dy][0][j] : 0.f;
      fw[dy][1][j] = (!CHECKED || fv[dy]) && z1 == 1 ? fw[dy][1][j] : 0.f;
    }
  }
#pragma unroll
  for (int o = 0; o < 3; ++o) gq[0][o] = __ldg(gl + o);
  int zb = 0;
  for (; zb + 6 <= Z; zb += 4) {  // z + 2 < Z for every z of the group
    wgrad_z<0, CHECKED, false>(acc, gs, fw, gq, fl, fv, gl, zb, Z, C, with_bias);
    wgrad_z<1, CHECKED, false>(acc, gs, fw, gq, fl, fv, gl, zb + 1, Z, C, with_bias);
    wgrad_z<2, CHECKED, false>(acc, gs, fw, gq, fl, fv, gl, zb + 2, Z, C, with_bias);
    wgrad_z<3, CHECKED, false>(acc, gs, fw, gq, fl, fv, gl, zb + 3, Z, C, with_bias);
  }
  for (; zb < Z; zb += 4) {
    wgrad_z<0, CHECKED, true>(acc, gs, fw, gq, fl, fv, gl, zb, Z, C, with_bias);
    if (zb + 1 < Z) wgrad_z<1, CHECKED, true>(acc, gs, fw, gq, fl, fv, gl, zb + 1, Z, C, with_bias);
    if (zb + 2 < Z) wgrad_z<2, CHECKED, true>(acc, gs, fw, gq, fl, fv, gl, zb + 2, Z, C, with_bias);
    if (zb + 3 < Z) wgrad_z<3, CHECKED, true>(acc, gs, fw, gq, fl, fv, gl, zb + 3, Z, C, with_bias);
  }
}

// ---- weight gradient --------------------------------------------------------------
// Block (blk, dx, g): z-lines [blk * span, (blk + 1) * span) of the flat
// (b, x, y) index, warp w taking every WGRAD_WARPS-th from the w-th. Writes
// part[blk][tap][o][c] for its taps and channels, and (dx = 1, g = 0 only)
// part_bias[blk][o].
template <typename T, int VEC>
__global__ void __launch_bounds__(WGRAD_WARPS * 32, 2) flow_head_wgrad_kernel(
    const T* __restrict__ feat, const float* __restrict__ gsvf, float* __restrict__ part,
    float* __restrict__ part_bias, int B, int X, int Y, int Z, int C, int span) {
  constexpr int PW = 27 * VEC;  // a lane's sums: [dy][dz][j][o]
  __shared__ float red[PW * 32];
  __shared__ float redb[3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int blk = blockIdx.x, dx = blockIdx.y, g = blockIdx.z;
  const int s = g * 32 + lane;
  const bool active = s < (C + VEC - 1) / VEC;
  const bool with_bias = dx == 1 && g == 0;
  const long long lines = (long long)B * X * Y;
  const long long l1 = min(lines, (long long)(blk + 1) * span);

  float acc[3][3][VEC][3];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dz = 0; dz < 3; ++dz)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
#pragma unroll
        for (int o = 0; o < 3; ++o) acc[dy][dz][j][o] = 0.f;
  float gs[3] = {0.f, 0.f, 0.f};

  const bool lanes_full = (g + 1) * 32 <= (C + VEC - 1) / VEC;
  for (long long l = (long long)blk * span + warp; l < l1; l += WGRAD_WARPS) {
    const int y = (int)(l % Y);
    const long long r = l / Y;
    const int x = (int)(r % X);
    const long long b = r / X;
    const int xx = x + dx - 1;
    if (xx < 0 || xx >= X) continue;  // never for dx = 1, the block that sums the bias
    const T* fl[3];
    bool fv[3];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int yy = y + dy - 1;
      fv[dy] = active && yy >= 0 && yy < Y;
      fl[dy] = feat + ((b * X + xx) * Y + (fv[dy] ? yy : y)) * (long long)Z * C +
               (active ? s : 0) * VEC;
    }
    const float* gl = gsvf + l * (long long)Z * 3;
    if (lanes_full && y >= 1 && y + 1 < Y)  // warp-uniform
      wgrad_line<false>(acc, gs, fl, fv, gl, Z, C, with_bias);
    else
      wgrad_line<true>(acc, gs, fl, fv, gl, Z, C, with_bias);
  }

  // the block's warps, summed in warp order
  for (int wv = 0; wv < WGRAD_WARPS; ++wv) {
    if (warp == wv) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
#pragma unroll
            for (int o = 0; o < 3; ++o) {
              float* p = red + (((dy * 3 + dz) * VEC + j) * 3 + o) * 32 + lane;
              *p = (wv == 0 ? 0.f : *p) + acc[dy][dz][j][o];
            }
      if (lane == 0)
#pragma unroll
        for (int o = 0; o < 3; ++o) redb[o] = (wv == 0 ? 0.f : redb[o]) + gs[o];
    }
    __syncthreads();
  }
  const int Cpad = gridDim.z * 32 * VEC;
  for (int i = threadIdx.x; i < PW * 32; i += WGRAD_WARPS * 32) {
    const int k = i >> 5, ln = i & 31;
    const int o = k % 3, j = (k / 3) % VEC, dz = (k / (3 * VEC)) % 3, dy = k / (9 * VEC);
    const int tap = (dx * 3 + dy) * 3 + dz;
    part[((long long)blk * 81 + tap * 3 + o) * Cpad + (g * 32 + ln) * VEC + j] = red[i];
  }
  if (with_bias && threadIdx.x < 3) part_bias[blk * 3 + threadIdx.x] = redb[threadIdx.x];
}

// dw[o, c, tap] = sum over blk, in order, of part[blk][tap][o][c]; db likewise.
__global__ void flow_head_wgrad_finish_kernel(const float* __restrict__ part,
                                              const float* __restrict__ part_bias,
                                              float* __restrict__ dw, float* __restrict__ db,
                                              int C, int Cpad, int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = 81 * Cpad;
  if (i < n) {
    const int c = i % Cpad;
    if (c >= C) return;
    float sum = 0.f;
#pragma unroll 8
    for (int k = 0; k < nblk; ++k) sum += part[(long long)k * n + i];
    const int o = (i / Cpad) % 3, tap = i / (3 * Cpad);
    dw[(o * C + c) * 27 + tap] = sum;
  } else if (i < n + 3) {
    float sum = 0.f;
    for (int k = 0; k < nblk; ++k) sum += part_bias[k * 3 + (i - n)];
    db[i - n] = sum;
  }
}

// ---- launchers ---------------------------------------------------------------------

int vec_of(int C, int is_bf16) { return is_bf16 && C % 2 == 0 ? 2 : 1; }
int groups_of(int C, int vec) { return (C + 32 * vec - 1) / (32 * vec); }

// Shared memory a block: the forward's weights and one x-plane; the input
// gradient's cotangent tile and weights. Both stay under the 48 KB a block
// may take without opting in.
template <int VEC>
constexpr size_t fwd_smem() { return (size_t)(81 * VEC * 32 + (TY + 2) * (ZB + 2) * 32) * 4; }
template <int VEC>
constexpr size_t dgrad_smem() { return (size_t)ROWS * (ZB + 2) * 16 + 81 * VEC * 32 * 4; }
static_assert(fwd_smem<2>() <= 48 * 1024 && dgrad_smem<2>() <= 48 * 1024,
              "a block's shared memory exceeds 48 KB");

template <typename T, int VEC>
int fwd(const void* feat, const void* w, const void* bias, void* out, int B, int X, int Y,
        int Z, int C, cudaStream_t s) {
  const int nyb = (Y + TY - 1) / TY, nzb = (Z + ZB - 1) / ZB;
  const long long blocks = (long long)B * X * nyb * nzb;
  if (blocks == 0) return 0;
  flow_head_fwd_kernel<T, VEC><<<(unsigned)blocks, TY * 32, fwd_smem<VEC>(), s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(w), static_cast<const float*>(bias),
      static_cast<float*>(out), X, Y, Z, C, groups_of(C, VEC), nyb, nzb);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int dgrad(const void* g, const void* w, void* dfeat, int B, int X, int Y, int Z, int C,
          cudaStream_t s) {
  const int NG = groups_of(C, VEC), nyb = (Y + TY - 1) / TY, nzb = (Z + ZB - 1) / ZB;
  const long long blocks = (long long)B * X * nyb * nzb * NG;
  if (blocks == 0) return 0;
  flow_head_dgrad_kernel<T, VEC><<<(unsigned)blocks, TY * 32, dgrad_smem<VEC>(), s>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), static_cast<T*>(dfeat), X, Y,
      Z, C, NG, nyb, nzb);
  return (int)cudaGetLastError();
}

template <typename T, int VEC>
int wgrad(const void* feat, const void* g, void* part, void* part_bias, int B, int X, int Y,
          int Z, int C, int span, int nblk, cudaStream_t s) {
  dim3 grid(nblk, 3, groups_of(C, VEC));
  flow_head_wgrad_kernel<T, VEC><<<grid, WGRAD_WARPS * 32, 0, s>>>(
      static_cast<const T*>(feat), static_cast<const float*>(g), static_cast<float*>(part),
      static_cast<float*>(part_bias), B, X, Y, Z, C, span);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flow_head_fwd_launch(const void* feat, const void* w, const void* bias, void* out,
                                    int B, int X, int Y, int Z, int C, int is_bf16,
                                    void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return fwd<float, 1>(feat, w, bias, out, B, X, Y, Z, C, s);
  if (vec_of(C, is_bf16) == 2) return fwd<__nv_bfloat16, 2>(feat, w, bias, out, B, X, Y, Z, C, s);
  return fwd<__nv_bfloat16, 1>(feat, w, bias, out, B, X, Y, Z, C, s);
}

extern "C" int flow_head_dgrad_launch(const void* g, const void* w, void* dfeat, int B, int X,
                                      int Y, int Z, int C, int is_bf16, void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return dgrad<float, 1>(g, w, dfeat, B, X, Y, Z, C, s);
  if (vec_of(C, is_bf16) == 2) return dgrad<__nv_bfloat16, 2>(g, w, dfeat, B, X, Y, Z, C, s);
  return dgrad<__nv_bfloat16, 1>(g, w, dfeat, B, X, Y, Z, C, s);
}

// part (nblk, 81, Cpad) and part_bias (nblk, 3) float32, Cpad = 32 * VEC * groups;
// span z-lines a block (ops/flow_head.py::wgrad_blocks)
extern "C" int flow_head_wgrad_launch(const void* feat, const void* g, void* part,
                                      void* part_bias, int B, int X, int Y, int Z, int C,
                                      int span, int nblk, int is_bf16, void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return wgrad<float, 1>(feat, g, part, part_bias, B, X, Y, Z, C, span, nblk, s);
  if (vec_of(C, is_bf16) == 2)
    return wgrad<__nv_bfloat16, 2>(feat, g, part, part_bias, B, X, Y, Z, C, span, nblk, s);
  return wgrad<__nv_bfloat16, 1>(feat, g, part, part_bias, B, X, Y, Z, C, span, nblk, s);
}

extern "C" int flow_head_wgrad_finish_launch(const void* part, const void* part_bias, void* dw,
                                             void* db, int C, int nblk, int is_bf16,
                                             void* stream) {
  cudaGetLastError();
  const int vec = vec_of(C, is_bf16);
  const int Cpad = groups_of(C, vec) * 32 * vec;
  const int n = 81 * Cpad + 3;
  flow_head_wgrad_finish_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const float*>(part_bias),
      static_cast<float*>(dw), static_cast<float*>(db), C, Cpad, nblk);
  return (int)cudaGetLastError();
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
