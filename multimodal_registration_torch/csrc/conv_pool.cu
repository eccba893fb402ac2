// K1 conv3_lrelu_pool: maxpool2(leaky_relu(conv3x3x3_SAME(x, w) + b, slope)).
//
// Replaces multimodal_registration_tpu/ops/pallas/conv_pool.py::conv3_lrelu_pool
// (the fused first U-Net level, enc_0). The full-resolution activation is never
// written: only the pooled tensor leaves the chip.
//
// x (B, X, Y, Z, Cin) channels-last, bf16 or f32; bias (Cout) f32; out
// (B, X/2, Y/2, Z/2, Cout) in x's type. Arithmetic: products of the operands
// (rounded to x's type by the wrapper) summed in f32, + f32 bias, LeakyReLU,
// max over the 2x2x2 window, one rounding to the output type.
//
// What bounds it on an H100 SXM (flagship shape 160x160x192x2 -> 64, bf16):
// device memory moves 19.7 MB of input and 78.6 MB of output, ~29 us at
// 3.35 TB/s; the work is 34 GFLOP, ~34 us on the bf16 tensor cores (989
// TFLOP/s) but ~0.5 ms on the FP32 SIMT units (67 TFLOP/s). So the bf16 kernel
// runs on the tensor cores, and its pace is then set by the other
// instructions it issues per matrix instruction (operand loads, the pool, the
// stores) and by how many warps stand ready while one waits for its product.
//
// bf16: an implicit GEMM, M = voxels, N = Cout, K = 27 * Cin, on the
// warpgroup instruction wgmma m64n64k16 (bf16 in, f32 accumulate, A from
// registers, B from shared memory). Nothing of the TPU kernel's K-major im2col
// scratch carries over: the im2col matrix is never formed.
//  * A block (two warpgroups) owns a 4x8x8 tile of pooled outputs (an 8x16x16
//    full-res window). It stages the tile's 10x18x18 halo in shared memory as
//    it lies in device memory, bf16 channels-last (Cin padded to even: a voxel
//    is CP2 32-bit words), zero outside the volume (SAME padding), with
//    asynchronous copies that are all in flight at once.
//  * The wrapper hands over the weights as the bf16 matrix [K_pad][Cout_pad],
//    rows k = tap * Cin_pad + ci with tap = (dx*3 + dy)*3 + dz, already cut
//    into the tiles of 16 k x 64 n that the instruction reads from shared
//    memory (see B_TILE below); the block copies them 16 bytes at a time.
//  * An A register holds two consecutive k of one row: two channels of one tap
//    of one voxel, that is one aligned 32-bit word of the halo at (voxel
//    offset + tap offset). A lane reads its four words of a k-step straight
//    from the halo into the fragment; the tap offsets come from a small table
//    in shared memory (the zero rows that pad K read tap 0).
//  * Row order makes the pool free of shuffles. A warp takes 8 pooled windows
//    that are neighbours along z: 64 voxels, four m-tiles of 16 rows; the four
//    warps of a group make up the instruction's 64 rows, each with its own
//    windows. Rows g and g + 8 of m-tile t (the two rows whose sums a lane
//    with lane / 4 == g holds) are voxels 2t and 2t + 1 of window g, so all 8
//    voxels of window g end in registers of the same four lanes and the max is
//    taken in registers, before bias and LeakyReLU (which keep the order of
//    values for slope >= 0; the wrapper refuses a negative slope).
//  * One m-tile is in flight per warpgroup: the A words of all its k-steps are
//    loaded, the k-steps issued, and the group waits for them. What hides the
//    wait is the other five warpgroups of the SM (three blocks of 85
//    registers a thread). N goes in chunks of 64 columns.
//  * Pooled rows leave through a per-warp buffer in shared memory as 16-byte
//    stores, a window's 64 bf16 channels being 128 contiguous bytes.
// The same design on mma.sync m16n8k16 (B fragments from shared memory, two
// m-tiles in flight, 128 registers a thread) was 1.3 times slower.
//
// f32 keeps the SIMT kernel (the tensor cores have no full-float32 product):
// one block owns a 2x4x8 tile of pooled outputs, stages the f32 halo and all
// weights ((27*Cin, Cout) f32, row k = tap * Cin + ci) in shared memory; a
// work item is one pooled voxel and CPT consecutive output channels, with
// 8 x CPT accumulators in registers. Its pace is the FP32 issue rate.
//
// Batch is grid dimension y in both.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

// ---- bf16: implicit GEMM on the tensor cores --------------------------------

namespace tc {

constexpr int PX = 4, PY = 8, PZ = 8;                  // pooled outputs per block
constexpr int HX = 2 * PX + 2, HY = 2 * PY + 2, HZ = 2 * PZ + 2;  // input halo
constexpr int HVOX = HX * HY * HZ;
constexpr int GROUPS = PX * PY * (PZ / 8);             // groups of 8 windows along z
constexpr int WARPS = 8, THREADS = 32 * WARPS;
// bf16 values per row of a warp's output buffer: 64 columns and 8 of padding,
// so that the 8 windows' rows start in different banks and stay 16-byte aligned
constexpr int OROW = 72;

struct Dims {
  int CP2, KP, S, NC;  // words per halo voxel, padded K, k-steps, chunks of 64 columns
  __host__ __device__ Dims(int Cin, int Cout)
      : CP2((Cin + 1) / 2), KP((27 * 2 * CP2 + 15) / 16 * 16), S(KP / 16), NC((Cout + 63) / 64) {}
  __host__ __device__ size_t smem() const {
    return (size_t)NC * S * 2048 + NC * 256 + KP * 2 + WARPS * 8 * OROW * 2 +
           (size_t)HVOX * CP2 * 4;
  }
};

// Asynchronous copy of BYTES (4 or 16) from device to shared memory; zeros if !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  const int n = valid ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// A B tile in shared memory: 16 k x 64 n bf16 as 2 x 8 core matrices of 8 n x 8
// k, k contiguous (16 bytes a row, 128 bytes a core matrix): byte offset
// (k / 8) * 1024 + (n / 8) * 128 + (n % 8) * 16 + (k % 8) * 2. In the matrix
// descriptor (no swizzle) the stride between core matrices along k stands at
// bit 16 and the stride along n at bit 32, both in units of 16 bytes.
constexpr int B_TILE = 2048;
constexpr uint64_t B_STRIDES = (uint64_t(1024 / 16) << 16) | (uint64_t(128 / 16) << 32);

// One warpgroup instruction: D (64 x 64 f32, 32 registers a thread) = A B +
// (accumulate ? D : 0), with A (64 x 16 bf16) from registers, each warp of the
// group giving its 16 rows in the m16k16 fragment layout, and B from the tile
// that desc describes. It runs asynchronously: d and a are the tensor cores'
// until wgmma_wait().
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// ST: the number of k-steps when it is known at compile time, 4 for Cin <= 2:
// all of them are then in flight at once, each with its own A registers, and a
// thread needs few enough registers for three blocks on an SM, which a kernel
// that waits for each of its m-tiles needs to keep the tensor cores busy. 0 for
// a wider Cin: one k-step at a time.
template <int ST>
__global__ void __launch_bounds__(THREADS, ST == 4 ? 3 : 2) conv3_lrelu_pool_wgmma_kernel(
    const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wtiles,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
    int X, int Y, int Z, int Cin, int Cout, float slope, int tiles_y, int tiles_z) {
  extern __shared__ uint4 smem[];
  const Dims d(Cin, Cout);
  const int CP2 = ST == 4 ? 1 : d.CP2, S = ST ? ST : d.S, NC = d.NC;
  uint4* ws = smem;                                           // [NC][S] B tiles
  float* bs = reinterpret_cast<float*>(ws + NC * S * (B_TILE / 16));  // [NC * 64], 0 beyond Cout
  int* koff = reinterpret_cast<int*>(bs + NC * 64);           // [KP / 2] halo offset of a k pair
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(koff + d.KP / 2);  // [WARPS][8][OROW]
  uint32_t* hs = reinterpret_cast<uint32_t*>(ob + WARPS * 8 * OROW);      // [HX][HY][HZ][CP2]

  const int b = blockIdx.y;
  int t = blockIdx.x;
  const int tz = t % tiles_z;
  t /= tiles_z;
  const int ty = t % tiles_y;
  const int tx = t / tiles_y;
  const int px0 = tx * PX, py0 = ty * PY, pz0 = tz * PZ;

  // weights and halo go to shared memory as asynchronous copies, all in flight
  // at once; a halo word outside the volume is filled with zeros (src-size 0)
  for (int i = threadIdx.x; i < NC * S * (B_TILE / 16); i += THREADS)
    cp_async<16>(ws + i, wtiles + i, true);
  for (int i = threadIdx.x; i < NC * 64; i += THREADS) bs[i] = i < Cout ? bias[i] : 0.f;
  // a row that pads K has zero weights: it reads tap 0, whose values are finite
  // wherever the window's own are
  for (int p = threadIdx.x; p < d.KP / 2; p += THREADS) {
    const int tap = p / CP2, c2 = p % CP2;
    koff[p] = tap < 27 ? (((tap / 9) * HY + (tap / 3) % 3) * HZ + tap % 3) * CP2 + c2 : 0;
  }
  const __nv_bfloat16* xb = x + (size_t)b * X * Y * Z * Cin;
  const bool words = Cin % 2 == 0;  // a voxel is whole 32-bit words in device memory too
#pragma unroll
  for (int v0 = 0; v0 < HVOX; v0 += THREADS) {  // consecutive threads, consecutive voxels
    const int v = v0 + threadIdx.x;
    if (v >= HVOX) break;
    const int hz = v % HZ, r = v / HZ;
    const int gx = 2 * px0 - 1 + r / HY, gy = 2 * py0 - 1 + r % HY, gz = 2 * pz0 - 1 + hz;
    const bool in = gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z;
    const __nv_bfloat16* p = in ? xb + ((gx * Y + gy) * Z + gz) * Cin : xb;
    for (int c2 = 0; c2 < CP2; ++c2) {
      if (words) {
        cp_async<4>(hs + v * CP2 + c2, p + 2 * c2, in);
      } else {
        uint32_t w = 0;
        if (in) {
          w = __bfloat16_as_ushort(p[2 * c2]);
          if (2 * c2 + 1 < Cin) w |= (uint32_t)__bfloat16_as_ushort(p[2 * c2 + 1]) << 16;
        }
        hs[v * CP2 + c2] = w;
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // the tensor cores read shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tid = lane & 3;
  const int PXt = X / 2, PYt = Y / 2, PZt = Z / 2;
  __nv_bfloat16* myob = ob + warp * 8 * OROW;

  for (int grp = warp; grp < GROUPS; grp += WARPS) {
    const int lz0 = (grp % (PZ / 8)) * 8;
    const int ly = (grp / (PZ / 8)) % PY, lx = grp / (PZ / 8) / PY;
    // word offset of window g's first voxel in the halo
    const int base = ((2 * lx * HY + 2 * ly) * HZ + 2 * (lz0 + g)) * CP2;
    const int px = px0 + lx, py = py0 + ly, pz = pz0 + lz0;
    const bool in_xy = px < PXt && py < PYt;

    for (int nc = 0; nc < NC; ++nc) {  // 64 output columns at a time; beyond Cout they are zeros
      float pooled[8][2];
      constexpr int SB = ST ? ST : 1;  // k-steps in flight
      const uint32_t wbase = (uint32_t)__cvta_generic_to_shared(ws) + nc * S * B_TILE;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {  // m-tile: the window's voxels with (vx, vy) = (mt / 2, mt % 2)
        // zeroed although the first k-step overwrites them: ptxas was seen to
        // drop the first m-tile's instructions when they start from nothing.
        // The first k-step still ignores them (scale-d 0), so that the sums are
        // not live while the A words load: with every step accumulating, the
        // Cin <= 2 kernel spilled 180 bytes instead of 20 under the register
        // limit of three blocks an SM and was 1.4 times slower
        float acc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = 0.f;
        const uint32_t* h = hs + base + ((mt >> 1) * HY + (mt & 1)) * HZ * CP2;
        for (int s0 = 0; s0 < S; s0 += SB) {
          uint32_t a[SB][4];
#pragma unroll
          for (int i = 0; i < SB; ++i) {  // registers 1 and 3 are the voxel at vz = 1
            const int o0 = koff[(s0 + i) * 8 + tid], o1 = koff[(s0 + i) * 8 + 4 + tid];
            a[i][0] = h[o0];
            a[i][1] = h[o0 + CP2];
            a[i][2] = h[o1];
            a[i][3] = h[o1 + CP2];
          }
          wgmma_fence();
#pragma unroll
          for (int i = 0; i < SB; ++i)
            wgmma_64x64x16(acc, a[i], ((wbase + (s0 + i) * B_TILE) >> 4) | B_STRIDES, s0 + i > 0);
          wgmma_commit();
          wgmma_wait();
          // the tensor cores wrote acc and read a until here: the compiler must
          // neither read the sums earlier nor reuse the A registers before
#pragma unroll
          for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(acc[i])::"memory");
#pragma unroll
          for (int i = 0; i < SB; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(a[i][q])::"memory");
        }
        // the max over the window first: adding the bias and a LeakyReLU with
        // slope >= 0 do not change which value is the largest. Registers 4 j + c
        // and 4 j + c + 2 are rows g and g + 8, the window's voxels at vz = 0, 1
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float m = fmaxf(acc[4 * j + c], acc[4 * j + c + 2]);
            pooled[j][c] = mt == 0 ? m : fmaxf(pooled[j][c], m);
          }
      }

      // window g, columns nc * 64 + j * 8 + tid * 2 + {0, 1}: through the warp's
      // buffer, then whole rows to device memory
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bs + nc * 64 + j * 8 + tid * 2);
        const float p0 = pooled[j][0] + bb.x, p1 = pooled[j][1] + bb.y;
        *reinterpret_cast<__nv_bfloat162*>(myob + g * OROW + j * 8 + tid * 2) =
            __floats2bfloat162_rn(p0 >= 0.f ? p0 : slope * p0, p1 >= 0.f ? p1 : slope * p1);
      }
      __syncwarp();
      const int c0 = nc * 64, ncols = min(64, Cout - c0);
      __nv_bfloat16* o = out + ((((size_t)b * PXt + px) * PYt + py) * PZt + pz) * Cout + c0;
      if (Cout % 8 == 0) {
#pragma unroll
        for (int i = lane; i < 64; i += 32) {  // 8 lanes a window: 128 contiguous bytes
          const int w = i >> 3, c = i & 7;
          if (in_xy && pz + w < PZt && c * 8 < ncols)
            *reinterpret_cast<uint4*>(o + w * Cout + c * 8) =
                *reinterpret_cast<const uint4*>(myob + w * OROW + c * 8);
        }
      } else {
        for (int i = lane; i < 8 * ncols; i += 32) {
          const int w = i / ncols, c = i % ncols;
          if (in_xy && pz + w < PZt) o[w * Cout + c] = myob[w * OROW + c];
        }
      }
      __syncwarp();
    }
  }
}

template <int ST>
int launch_st(const void* x, const void* wtiles, const float* bias, void* out, int B, int X, int Y,
              int Z, int Cin, int Cout, float slope, cudaStream_t stream) {
  const int tiles_x = (X / 2 + PX - 1) / PX;
  const int tiles_y = (Y / 2 + PY - 1) / PY;
  const int tiles_z = (Z / 2 + PZ - 1) / PZ;
  const size_t smem = Dims(Cin, Cout).smem();
  auto kern = conv3_lrelu_pool_wgmma_kernel<ST>;
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(tiles_x * tiles_y * tiles_z, B);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(wtiles), bias,
      static_cast<__nv_bfloat16*>(out), X, Y, Z, Cin, Cout, slope, tiles_y, tiles_z);
  return (int)cudaGetLastError();
}

int launch(const void* x, const void* wtiles, const float* bias, void* out, int B, int X, int Y,
           int Z, int Cin, int Cout, float slope, cudaStream_t s) {
  const int S = Dims(Cin, Cout).S;
  if (S == 4) return launch_st<4>(x, wtiles, bias, out, B, X, Y, Z, Cin, Cout, slope, s);
  return launch_st<0>(x, wtiles, bias, out, B, X, Y, Z, Cin, Cout, slope, s);
}

}  // namespace tc

// ---- f32: SIMT ---------------------------------------------------------------

namespace simt {

constexpr int PX = 2, PY = 4, PZ = 8;                  // pooled outputs per block
constexpr int HX = 2 * PX + 2, HY = 2 * PY + 2, HZ = 2 * PZ + 2;  // input halo
constexpr int NVOX = PX * PY * PZ;                     // 64 pooled voxels
constexpr int THREADS = 256;

template <int CPT>
__global__ void __launch_bounds__(THREADS) conv3_lrelu_pool_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out,
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
      v = x[vol + (((int64_t)gx * Y + gy) * Z + gz) * Cin + ci];
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

    float* o = out + ((((int64_t)b * PXt + px) * PYt + py) * PZt + pz) * Cout + c0;
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
      o[j] = best;
    }
  }
}

template <int CPT>
int launch_cpt(const float* x, const float* w, const float* b, float* out, int B,
               int X, int Y, int Z, int Cin, int Cout, float slope,
               cudaStream_t stream) {
  const int tiles_x = (X / 2 + PX - 1) / PX;
  const int tiles_y = (Y / 2 + PY - 1) / PY;
  const int tiles_z = (Z / 2 + PZ - 1) / PZ;
  const size_t smem = sizeof(float) * (27 * Cin * Cout + Cin * HX * HY * HZ);
  auto kern = conv3_lrelu_pool_kernel<CPT>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(tiles_x * tiles_y * tiles_z, B);
  kern<<<grid, THREADS, smem, stream>>>(x, w, b, out, X, Y, Z, Cin, Cout, slope, tiles_y,
                                        tiles_z);
  return (int)cudaGetLastError();
}

int launch(const float* x, const float* w, const float* b, float* out, int B,
           int X, int Y, int Z, int Cin, int Cout, float slope, cudaStream_t s) {
  if (Cout % 8 == 0) return launch_cpt<8>(x, w, b, out, B, X, Y, Z, Cin, Cout, slope, s);
  if (Cout % 4 == 0) return launch_cpt<4>(x, w, b, out, B, X, Y, Z, Cin, Cout, slope, s);
  return launch_cpt<1>(x, w, b, out, B, X, Y, Z, Cin, Cout, slope, s);
}

}  // namespace simt

}  // namespace

// w: for bf16 the bf16 matrix [K_pad][Cout_pad] cut into B tiles, for f32 the
// f32 matrix (27*Cin, Cout); see ops/conv_pool.py::prepared_weights.
extern "C" int conv3_lrelu_pool_launch(const void* x, const void* w,
                                       const void* b, void* out, int B, int X,
                                       int Y, int Z, int Cin, int Cout,
                                       float slope, int is_bf16, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(b);
  if (is_bf16) return tc::launch(x, w, bf, out, B, X, Y, Z, Cin, Cout, slope, s);
  return simt::launch(static_cast<const float*>(x), static_cast<const float*>(w), bf,
                      static_cast<float*>(out), B, X, Y, Z, Cin, Cout, slope, s);
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
