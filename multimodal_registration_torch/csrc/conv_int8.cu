// K8 conv3_int8: the int8 x int8 -> int32 3x3x3 SAME conv of the U-Net's wide
// blocks, with the dequantization, bias and LeakyReLU fused.
//
// Replaces multimodal_registration_tpu/models/unet.py::ConvBlock._int8_conv
// (an XLA int8 conv with int32 accumulation; no Pallas kernel). The same
// arithmetic, in the same order:
//   xq = clip(rint(x_f32 * inv_a), +-127)             (quantize_act_kernel)
//   acc = sum over 27 taps and Cin of xq * wq, int32    (conv3_int8_wgmma_kernel)
//   y = acc_f32 * scale[n] + bias[n]; y = y >= 0 ? y : slope * y
// with scale = a_scale * w_scale[n] and the weights quantized once per
// parameter version by the wrapper (ops/conv_int8.py::prepared_int8_weights).
// Products and sums are rounded one at a time (__fmul_rn, __fadd_rn: no FMA
// contraction), so the kernel and its plain version agree bit for bit.
// Integer sums do not depend on their order, and the largest one, 27 * 512 *
// 127^2 < 2.3e8, is far below 2^31: no saturation is asked for.
//
// What bounds it on an H100 SXM (the widest call of the published model,
// dec_3: 512 -> 256 channels at 80x80x96, batch 1): 2 * 614,400 * 256 * 27 *
// 512 = 4.35e12 integer operations, 2.2 ms at the int8 tensor-core peak
// (1,979 TOPS), against 629 MB of bf16 input and 315 MB of bf16 output, 0.28 ms
// at 3.35 TB/s. So it is bound by operations, on the tensor cores.
//
// The first version of this kernel (mma.sync m16n8k32, 128 x 128 tiles, four
// cp.async stages, two blocks of 8 warps an SM) stopped at 27% of that peak:
// each warp read its A and B fragments from shared memory with ldmatrix, 48 KB
// a block per 2.1 M operations, about 350 GB/s an SM at the SM's share of the
// peak against the ~230 GB/s that shared memory serves; every voxel's 27
// neighbour rows were fetched one by one with 16-byte cp.async, so each A row
// crossed L2 27 times for each of the two blocks of output channels, and each
// block read all the weights of its columns (about 34 GB through L2 at dec_3).
//
// Design (Hopper: wgmma, TMA, a cluster of two blocks):
//  * The conv is an implicit GEMM, M = output voxels, N = Cout, K = 27 * Cp:
//    a block owns a box of 2 (x) x 4 (y) x 16 (z) output voxels and 256
//    output channels. Two consumer warpgroups each own one x-plane of the box,
//    a 64 x 256 tile of s32 sums, 128 registers a thread, on
//    wgmma.mma_async m64n256k32 s32.s8.s8 with both operands in shared memory
//    (K-major, 64-byte swizzle); the first k-step of a tile zeroes the sums
//    (scale-d = 0).
//  * A is not gathered per tap: for each chunk of 64 input channels a TMA load
//    per dz in {-1, 0, 1} stages the halo box of 4 x 6 x 16 voxels x 64 bytes
//    at (x0 - 1, y0 - 1, z0 + dz) of xq (B, X, Y, Z, Cp), 384 rows of 64 bytes.
//    TMA fills what lies outside the tensor with zeros: that is SAME padding
//    (0 quantizes to 0) at the faces, past a ragged last z box and past the
//    batch, with no index arithmetic here. A row (x, y) of the plane is 16
//    consecutive rows (z), so tap (dx, dy, dz) of x-plane xo is the 64
//    consecutive rows of the dz plane from ((xo + 1 + dx) * 6 + 1 + dy) * 16
//    (a multiple of 16 rows, 1024 bytes: whole swizzle atoms), one descriptor
//    with a uniform 512-byte stride between 8-row groups. The second k32 step
//    of a 64-byte row is the descriptor's start + 32 bytes. A chunk is read
//    once for its 27 taps: 9 bytes of L2 traffic per output voxel and input
//    channel, against 54 for the first version. Two chunks are in flight.
//  * The weights, rows n with k = tap * Cp + ci contiguous (K-major), stream
//    in tiles of one (tap, chunk), 256 rows x 64 bytes, through a ring of four
//    stages. The two blocks of a cluster own consecutive boxes and the same
//    columns: each loads half of every tile and multicasts it to both, which
//    halves the weights' L2 traffic. A weight stage is free again when the
//    consumers of both blocks have arrived on its empty barrier (remote
//    arrivals through mapa).
//  * One producer thread (its warpgroup lowered to 40 registers with
//    setmaxnreg, the consumers raised to 232) keeps the TMA loads in flight on
//    full/empty mbarriers. The kernel is persistent: a cluster walks its tiles
//    with a stride of the grid, so the next tile's loads overlap this tile's
//    epilogue. An odd number of boxes leaves the last cluster's second block
//    idle: it loads zeros, arrives on every barrier, stores nothing.
//  * Epilogue, in registers: a thread holds rows warp * 16 + lane / 4 (+ 8),
//    i.e. one y row and two z of its x-plane, and columns 8 j + 2 (lane % 4)
//    (+ 1); __int2float_rn, __fmul_rn by scale[n], __fadd_rn of bias[n],
//    LeakyReLU by __fmul_rn, one cast; pairs of channels are stored together,
//    scale and bias from a table in shared memory.
//  * What holds it back on an H100 (tools/k8_stamps.py, PERF.md): a tile's
//    mainloop runs at ~80% of the tensor rate and waits the rest on weight
//    stages (an SM takes in 16 KB of weights and 2.7 KB of halo per 512
//    clocks of wgmma; three stages wait longer than four), and the epilogue,
//    not overlapped with wgmma (both consumers store at once), is ~15% of a
//    tile: its unrolled code with two warps a scheduler, so the case where
//    every column lies inside Cout runs a loop of its own.
//  * The quantize pass stays a launch of its own: TMA moves bytes and cannot
//    quantize, and bf16 halos staged beside the int8 planes do not fit in the
//    227 KB of shared memory. It moves 2 + 1 bytes per input value at ~78% of
//    its byte bound.
//  * Tensor maps are encoded on the host with cuTensorMapEncodeTiled, found
//    through cudaGetDriverEntryPoint (no link against libcuda), and passed as
//    __grid_constant__ parameters; the cluster launch is cudaLaunchKernelEx.
//  * Offsets into out are 64-bit: B*X*Y*Z*C passes 2^31 at dec_3 with batches
//    of 4 tiles.

#include <cuda.h>  // CUtensorMap and its enums; the function itself comes through cudart
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BOX_X = 2, BOX_Y = 4, BOX_Z = 16;        // output voxels of a block
constexpr int HALO_X = BOX_X + 2, HALO_Y = BOX_Y + 2;  // a staged dz plane: 4 x 6 x 16 voxels
constexpr int KC = 64;                                 // input channels (bytes) of a chunk
constexpr int BN = 256;                                // output channels of a block
constexpr int CLUSTER = 2;
constexpr int PLANE = HALO_X * HALO_Y * BOX_Z * KC;    // 24,576 B: 384 rows of 64 B
constexpr int A_STAGE = 3 * PLANE;                     // the three dz planes of a chunk
constexpr int W_TILE = BN * KC;                        // the weights of one (tap, chunk)
constexpr int W_PART = W_TILE / CLUSTER;               // the rows each block of the cluster loads
constexpr int W_STAGES = 4;  // 3 were slower on an H100 (PERF.md); 5 do not fit
constexpr int A_AHEAD_TAP = 3;  // the next chunk's halo is asked for after this tap's weights
constexpr int THREADS = 384;    // a producer warpgroup and two consumer warpgroups
constexpr int SMEM_W = 2 * A_STAGE, SMEM_BAR = SMEM_W + W_STAGES * W_TILE;
constexpr int N_BARS = 4 + 2 * W_STAGES;
constexpr int SMEM_EPI = SMEM_BAR + N_BARS * 8;       // each consumer's (scale, bias) of its columns
constexpr int SMEM = SMEM_EPI + 2 * 128 * 16 + 1024;  // + slack to align the base to 1024 B
static_assert(SMEM <= 232448, "more shared memory than a block may have");

// launcher errors beside cudaError_t's, described by mmreg_error_string
constexpr int ERR_PLAN = -1, ERR_NO_ENCODE = -2, ERR_ENCODE = -3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// ---- mbarriers, the cluster, TMA -------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// arrive on the barrier at the same offset in block `cta` of the cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 ra;\n mapa.shared::cluster.u32 ra, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [ra];\n}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
// A phase that has not completed after ~10 s of waiting never will (a load or
// an arrival is missing): trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0)
      start = now;
    else if (now - start > (1LL << 34))
      __trap();
  }
}
__device__ __forceinline__ void fence_mbarrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n barrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t n_clusters_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
// the box lands at `dst` and signals `bar` (the same offsets) in every block of `mask`
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst, const CUtensorMap* map,
                                                      uint32_t bar, int c0, int c1,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// ---- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor of a K-major operand in rows of 64 bytes
// with the 64-byte swizzle: start address >> 4 (bits 0-13), leading offset
// 1 (unused by swizzled K-major layouts, bits 16-29), stride between 8-row
// groups 512 B >> 4 (bits 32-45), base offset 0 (every start lies on a
// 512-byte swizzle atom, or 32 bytes into one for the second k-step), layout
// type 2 = 64-byte swizzle (bits 62-63). The start of the second k32 step of
// a row is the descriptor + 2 (32 bytes).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(512 >> 4) << 32) |
         ((uint64_t)2 << 62);
}
// a barrier of the 128 threads of one warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of the sums across a wait
__device__ __forceinline__ void fence_sums(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (64 x 256 s32, the warpgroup's fragments) = [d +] A (64 x 32 s8) B^T (256 x 32 s8)
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- the quantize pass -------------------------------------------------------
// xq (M, Cp) int8 from x (M, Cin), bf16 or f32: 4 channels a thread.
template <typename T>
__global__ void quantize_act_kernel(const T* __restrict__ x, char4* __restrict__ xq, int64_t M,
                                    int Cin, int Cp, float inv) {
  const int64_t words = M * (Cp / 4);
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < words;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t m = i / (Cp / 4);
    const int c0 = (int)(i % (Cp / 4)) * 4;
    signed char q[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float v = 0.f;
      if (c0 + j < Cin) {
        if constexpr (sizeof(T) == 2)
          v = __bfloat162float(x[m * Cin + c0 + j]);
        else
          v = x[m * Cin + c0 + j];
      }
      q[j] = (signed char)fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
    }
    xq[i] = make_char4(q[0], q[1], q[2], q[3]);
  }
}

// ---- the conv ----------------------------------------------------------------
struct ConvArgs {
  const float* scale;  // (cout_pad,) a_scale * w_scale
  const float* bias;   // (cout_pad,)
  void* out;           // (B, X, Y, Z, Cout): int32 (mode 0), bf16 (1) or f32 (2)
  int B, X, Y, Z, Cp, Cout, n_blocks_n, nbx, nby, nbz, n_tiles, mode;
  float slope;
};

// (b, x0, y0, z0) of the box of block `rank` in tile t; b == B past the last box
__device__ __forceinline__ void box_origin(const ConvArgs& p, int t, int rank, int& b, int& x0,
                                           int& y0, int& z0) {
  int box = CLUSTER * (t / p.n_blocks_n) + rank;
  z0 = (box % p.nbz) * BOX_Z;
  box /= p.nbz;
  y0 = (box % p.nby) * BOX_Y;
  box /= p.nby;
  x0 = (box % p.nbx) * BOX_X;
  b = box / p.nbx;
}

// The output of two channels from their sums: the sums themselves (MODE 0),
// or acc_f32 * scale + bias and LeakyReLU, one rounding an operation, as
// bf16 (MODE 1) or f32 (2).
template <int MODE>
struct Out;
template <>
struct Out<0> {
  using T = int;
  using T2 = int2;
  static __device__ __forceinline__ int2 make(int s0, int s1, float2, float2, float) {
    return make_int2(s0, s1);
  }
  static __device__ __forceinline__ int one(int s, float, float, float) { return s; }
};
__device__ __forceinline__ float epilogue(int s, float scale, float bias, float slope) {
  const float y = __fadd_rn(__fmul_rn(__int2float_rn(s), scale), bias);
  return y >= 0.f ? y : __fmul_rn(y, slope);
}
template <>
struct Out<1> {
  using T = __nv_bfloat16;
  using T2 = __nv_bfloat162;
  static __device__ __forceinline__ __nv_bfloat162 make(int s0, int s1, float2 sc, float2 bi,
                                                        float slope) {
    // one cvt.rn.bf16x2.f32: both halves rounded to nearest even, as two casts would
    return __floats2bfloat162_rn(epilogue(s0, sc.x, bi.x, slope), epilogue(s1, sc.y, bi.y, slope));
  }
  static __device__ __forceinline__ __nv_bfloat16 one(int s, float sc, float bi, float slope) {
    return __float2bfloat16_rn(epilogue(s, sc, bi, slope));
  }
};
template <>
struct Out<2> {
  using T = float;
  using T2 = float2;
  static __device__ __forceinline__ float2 make(int s0, int s1, float2 sc, float2 bi,
                                                float slope) {
    return make_float2(epilogue(s0, sc.x, bi.x, slope), epilogue(s1, sc.y, bi.y, slope));
  }
  static __device__ __forceinline__ float one(int s, float sc, float bi, float slope) {
    return epilogue(s, sc, bi, slope);
  }
};

// the sums of a consumer warpgroup's 64 x 256 tile into out: thread (warp w,
// lane l) holds d[4 j + 2 h + e] = row w * 16 + l / 4 + 8 h, column
// 8 j + 2 (l % 4) + e; row r of x-plane xo is voxel (x0 + xo, y0 + r / 16,
// z0 + r % 16). The scale and bias of column pair (lane % 4) + 4 j come from
// the warpgroup's table in shared memory, {scale[n], scale[n + 1], bias[n],
// bias[n + 1]}, one 16-byte read for both rows.
template <int MODE>
__device__ __forceinline__ void store_tile(const int (&d)[128], const float4* table,
                                           const ConvArgs& p, int t, int rank, int xo, int warp,
                                           int lane) {
  using T = typename Out<MODE>::T;
  using T2 = typename Out<MODE>::T2;
  int b, x0, y0, z0;
  box_origin(p, t, rank, b, x0, y0, z0);
  const int x = x0 + xo, y = y0 + warp, z = z0 + (lane >> 2);
  if (b >= p.B || x >= p.X || y >= p.Y || z >= p.Z) return;
  const bool row1 = z + 8 < p.Z;
  const int nb = (t % p.n_blocks_n) * BN, n0 = nb + 2 * (lane & 3);
  // every column pair of the block lies inside Cout and is 2-aligned
  const bool whole = (p.Cout & 1) == 0 && nb + BN <= p.Cout;
  T* __restrict__ out0 =
      static_cast<T*>(p.out) + ((((int64_t)b * p.X + x) * p.Y + y) * p.Z + z) * p.Cout + n0;
  T* __restrict__ out1 = out0 + 8 * (int64_t)p.Cout;
  table += lane & 3;
  // two loops, not one branch inside: the unrolled code is read once a tile
  // and the instruction cache, not the arithmetic, sets its time
  if (whole) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float2 s2 = make_float2(0.f, 0.f), b2 = s2;
      if constexpr (MODE != 0) {
        const float4 v = table[4 * j];
        s2 = make_float2(v.x, v.y);
        b2 = make_float2(v.z, v.w);
      }
      *reinterpret_cast<T2*>(out0 + 8 * j) = Out<MODE>::make(d[4 * j], d[4 * j + 1], s2, b2, p.slope);
      if (row1)
        *reinterpret_cast<T2*>(out1 + 8 * j) =
            Out<MODE>::make(d[4 * j + 2], d[4 * j + 3], s2, b2, p.slope);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      float2 s2 = make_float2(0.f, 0.f), b2 = s2;
      if constexpr (MODE != 0) {
        const float4 v = table[4 * j];
        s2 = make_float2(v.x, v.y);
        b2 = make_float2(v.z, v.w);
      }
      const int n = n0 + 8 * j;
      if (n < p.Cout) {
        out0[8 * j] = Out<MODE>::one(d[4 * j], s2.x, b2.x, p.slope);
        if (row1) out1[8 * j] = Out<MODE>::one(d[4 * j + 2], s2.x, b2.x, p.slope);
      }
      if (n + 1 < p.Cout) {
        out0[8 * j + 1] = Out<MODE>::one(d[4 * j + 1], s2.y, b2.y, p.slope);
        if (row1) out1[8 * j + 1] = Out<MODE>::one(d[4 * j + 3], s2.y, b2.y, p.slope);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    conv3_int8_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                      const __grid_constant__ CUtensorMap tm_w, const ConvArgs p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms need 512 B
  const uint32_t sA = base, sW = base + SMEM_W, bars = base + SMEM_BAR;
  // full_a(s) / empty_a(s): the halo of a chunk; full_w / empty_w: a weight stage
  const auto full_a = [&](int s) { return bars + 8 * s; };
  const auto empty_a = [&](int s) { return bars + 8 * (2 + s); };
  const auto full_w = [&](int s) { return bars + 8 * (4 + s); };
  const auto empty_w = [&](int s) { return bars + 8 * (4 + W_STAGES + s); };

  const int tid = threadIdx.x, wg = tid >> 7;
  const int rank = (int)cluster_ctarank();
  const int cluster = (int)cluster_id_x(), n_clusters = (int)n_clusters_x();
  const int chunks = p.Cp / KC;
  const int my_tiles = cluster < p.n_tiles ? (p.n_tiles - 1 - cluster) / n_clusters + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full_a(s), 1);   // the producer's expect_tx; the bytes of three planes
      mbar_init(empty_a(s), 2);  // both consumer warpgroups
    }
    for (int s = 0; s < W_STAGES; ++s) {
      mbar_init(full_w(s), 1);                // the producer's expect_tx; both halves' bytes
      mbar_init(empty_w(s), 2 * CLUSTER);     // both consumer warpgroups of both blocks
    }
    fence_mbarrier_init();
  }
  cluster_sync();  // every barrier of both blocks exists before anyone signals one

  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0 && my_tiles > 0) {
      tma_prefetch(&tm_x);
      tma_prefetch(&tm_w);
      const int n_chunks = my_tiles * chunks;
      const auto load_a = [&](int q) {  // the halo of this block's q-th chunk
        const int t = cluster + (q / chunks) * n_clusters, c = q % chunks, s = q & 1;
        int b, x0, y0, z0;
        box_origin(p, t, rank, b, x0, y0, z0);
        mbar_wait(empty_a(s), ((q >> 1) & 1) ^ 1);
        mbar_expect_tx(full_a(s), A_STAGE);
#pragma unroll
        for (int dz = 0; dz < 3; ++dz)
          tma_load_5d(sA + s * A_STAGE + dz * PLANE, &tm_x, full_a(s), c * KC, z0 + dz - 1, y0 - 1,
                      x0 - 1, b);
      };
      load_a(0);
      int w_it = 0;
      for (int q = 0; q < n_chunks; ++q) {
        const int t = cluster + (q / chunks) * n_clusters, c = q % chunks;
        const int row = (t % p.n_blocks_n) * BN + rank * (BN / CLUSTER);
        for (int tap = 0; tap < 27; ++tap, ++w_it) {
          const int s = w_it % W_STAGES;
          mbar_wait(empty_w(s), ((w_it / W_STAGES) & 1) ^ 1);  // free in both blocks
          mbar_expect_tx(full_w(s), W_TILE);
          tma_load_2d_multicast(sW + s * W_TILE + rank * W_PART, &tm_w, full_w(s),
                                tap * p.Cp + c * KC, row, (uint16_t)((1 << CLUSTER) - 1));
          if (tap == A_AHEAD_TAP && q + 1 < n_chunks) load_a(q + 1);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns x-plane xo = wg - 1 of the box
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int xo = wg - 1, warp = (tid >> 5) & 3, lane = tid & 31;
    const bool signals = (tid & 127) == 0;
    float4* table = reinterpret_cast<float4*>(smem_raw + (base - smem_u32(smem_raw)) + SMEM_EPI) +
                    128 * xo;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;
    const auto release_w = [&](int it) {
      if (signals)
        for (int r = 0; r < CLUSTER; ++r) mbar_arrive_cluster(empty_w(it % W_STAGES), r);
    };
    const auto release_a = [&](int q) {
      if (signals) mbar_arrive(empty_a(q & 1));
    };
    int w_it = 0, q = 0;
    for (int i = 0; i < my_tiles; ++i) {
      const int t = cluster + i * n_clusters;
      {  // this tile's (scale, bias) pairs: columns below cout_pad, which the arrays hold
        const int n = (t % p.n_blocks_n) * BN + 2 * (tid & 127);
        table[tid & 127] = make_float4(p.scale[n], p.scale[n + 1], p.bias[n], p.bias[n + 1]);
      }
      fence_sums(acc);
      for (int c = 0; c < chunks; ++c, ++q) {
        mbar_wait(full_a(q & 1), (q >> 1) & 1);
        const uint32_t a_base = sA + (q & 1) * A_STAGE;
#pragma unroll 1
        for (int tap = 0; tap < 27; ++tap, ++w_it) {
          const int dx = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dz = tap % 3 - 1;
          const int s = w_it % W_STAGES;
          mbar_wait(full_w(s), (w_it / W_STAGES) & 1);
          const uint64_t da = sw64_desc(
              a_base + (dz + 1) * PLANE + (((xo + 1 + dx) * HALO_Y + 1 + dy) * BOX_Z) * KC);
          const uint64_t db = sw64_desc(sW + s * W_TILE);
          wgmma_fence();
          wgmma_m64n256k32_s8(acc, da, db, (c | tap) != 0);
          wgmma_m64n256k32_s8(acc, da + 2, db + 2, 1);
          wgmma_commit();
          wgmma_wait<1>();  // the previous tap's products are done with their stages
          if (c | tap) {
            release_w(w_it - 1);
            if (tap == 0) release_a(q - 1);
          }
        }
      }
      wgmma_wait<0>();
      fence_sums(acc);
      release_w(w_it - 1);
      release_a(q - 1);
      warpgroup_sync(wg);  // the table is written
      if (p.mode == 0)
        store_tile<0>(acc, table, p, t, rank, xo, warp, lane);
      else if (p.mode == 1)
        store_tile<1>(acc, table, p, t, rank, xo, warp, lane);
      else
        store_tile<2>(acc, table, p, t, rank, xo, warp, lane);
      warpgroup_sync(wg);  // and read: the next tile may write it again
    }
  }
  // no block leaves while its peer may still multicast into it or arrive on its barriers
  cluster_sync();
}

// One m64n256k32 of a 64 x 64 A and a 256 x 64 B (int8, rows of 64 bytes),
// k-step `kstep` (bytes 32 kstep .. 32 kstep + 31 of each row), both staged by
// TMA with the 64-byte swizzle and read through the conv's descriptors; out
// (64, 256) int32. A test of the descriptor and fragment layout alone.
__global__ void __launch_bounds__(128, 1)
    wgmma_tile_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                      int* __restrict__ out, int kstep) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sa = base, sb = base + 64 * KC, bar = sb + BN * KC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_mbarrier_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar, 64 * KC + BN * KC);
    tma_load_2d(sa, &ta, bar, 0, 0);
    tma_load_2d(sb, &tb, bar, 0, 0);
  }
  mbar_wait(bar, 0);
  int acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
  fence_sums(acc);
  wgmma_fence();
  wgmma_m64n256k32_s8(acc, sw64_desc(sa) + 2 * kstep, sw64_desc(sb) + 2 * kstep, 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_sums(acc);
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        out[(warp * 16 + (lane >> 2) + 8 * h) * BN + 8 * j + 2 * (lane & 3) + e] =
            acc[4 * j + 2 * h + e];
}

// ---- the host side -----------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// an int8 tensor map with the 64-byte swizzle: dims and box innermost first,
// strides (bytes) of dims 1.. ; zeros outside the tensor
int encode_int8(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODE;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, (cuuint32_t)rank,
                            const_cast<void*>(ptr), dims, strides, box, ones,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// x (M, Cin) bf16 (is_bf16) or f32 -> xq (M, Cp) int8, Cp a multiple of 64.
extern "C" int quantize_act_launch(const void* x, void* xq, long long M, int Cin, int Cp,
                                   float inv, int is_bf16, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t words = (int64_t)M * (Cp / 4);
  const int threads = 256;
  const int64_t needed = (words + threads - 1) / threads;
  const int blocks = (int)(needed < 132 * 16 ? needed : 132 * 16);  // a grid-stride loop beyond
  if (blocks == 0) return (int)cudaGetLastError();
  if (is_bf16)
    quantize_act_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<char4*>(xq), M, Cin, Cp, inv);
  else
    quantize_act_kernel<float><<<blocks, threads, 0, s>>>(static_cast<const float*>(x),
                                                          static_cast<char4*>(xq), M, Cin, Cp, inv);
  return (int)cudaGetLastError();
}

// xq (B, X, Y, Z, Cp) int8; wq (cout_pad, 27 * Cp) int8, row n, k = tap * Cp + ci with
// tap = (dx * 3 + dy) * 3 + dz; scale, bias (cout_pad,) f32; out (B, X, Y, Z, Cout) int32
// (mode 0), bf16 (1) or f32 (2). The tiling (ops/conv_int8.py::Int8ConvPlan): boxes of
// box_x * box_y * box_z voxels, nbx * nby * nbz of them per batch entry, n_tiles = pairs
// of boxes x blocks of 256 output channels; refused unless it is this kernel's.
extern "C" int conv3_int8_launch(const void* xq, const void* wq, const void* scale,
                                 const void* bias, void* out, int B, int X, int Y, int Z, int Cp,
                                 int Cout, int cout_pad, int box_x, int box_y, int box_z, int nbx,
                                 int nby, int nbz, int n_tiles, int mode, float slope,
                                 void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  if (box_x != BOX_X || box_y != BOX_Y || box_z != BOX_Z || Cp <= 0 || Cp % KC != 0 ||
      cout_pad % BN != 0 || Cout > cout_pad || Cout <= 0 || nbx != cdiv(X, BOX_X) ||
      nby != cdiv(Y, BOX_Y) || nbz != cdiv(Z, BOX_Z) || mode < 0 || mode > 2 ||
      (long long)n_tiles != (((long long)B * nbx * nby * nbz + CLUSTER - 1) / CLUSTER) *
                                (cout_pad / BN))
    return ERR_PLAN;
  if (n_tiles == 0) return 0;
  CUtensorMap tm_x, tm_w;
  {
    const cuuint64_t dims[5] = {(cuuint64_t)Cp, (cuuint64_t)Z, (cuuint64_t)Y, (cuuint64_t)X,
                                (cuuint64_t)B};
    const cuuint64_t row = (cuuint64_t)Cp;
    const cuuint64_t strides[4] = {row, row * Z, row * Z * Y, row * Z * Y * X};
    const cuuint32_t box[5] = {KC, BOX_Z, HALO_Y, HALO_X, 1};
    const int e = encode_int8(&tm_x, xq, 5, dims, strides, box);
    if (e != 0) return e;
  }
  {
    const cuuint64_t dims[2] = {(cuuint64_t)27 * Cp, (cuuint64_t)cout_pad};
    const cuuint64_t strides[1] = {(cuuint64_t)27 * Cp};
    const cuuint32_t box[2] = {KC, BN / CLUSTER};
    const int e = encode_int8(&tm_w, wq, 2, dims, strides, box);
    if (e != 0) return e;
  }
  ConvArgs args{static_cast<const float*>(scale), static_cast<const float*>(bias), out, B, X, Y,
                Z, Cp, Cout, cout_pad / BN, nbx, nby, nbz, n_tiles, mode, slope};

  cudaError_t e =
      cudaFuncSetAttribute(conv3_int8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card holds at once, each walking its tiles
  static int resident[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, conv3_int8_wgmma_kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n <= 0) return (int)cudaErrorInvalidConfiguration;
    resident[dev] = n;
  }
  const int clusters = n_tiles < resident[dev] ? n_tiles : resident[dev];
  cfg.gridDim = dim3(CLUSTER * clusters, 1, 1);
  e = cudaLaunchKernelEx(&cfg, conv3_int8_wgmma_kernel, tm_x, tm_w, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One wgmma m64n256k32 s8 of a (64, 64) and b (256, 64) int8, k-step kstep (0
// or 1) -> out (64, 256) int32: the descriptor and fragment layout of the conv.
extern "C" int wgmma_tile_launch(const void* a, const void* b, void* out, int kstep,
                                 void* stream) {
  cudaGetLastError();
  if (kstep < 0 || kstep > 1) return ERR_PLAN;
  CUtensorMap ta, tb;
  const cuuint64_t stride[1] = {KC};
  const cuuint64_t da[2] = {KC, 64}, db[2] = {KC, BN};
  const cuuint32_t ba[2] = {KC, 64}, bb[2] = {KC, BN};
  int r = encode_int8(&ta, a, 2, da, stride, ba);
  if (r == 0) r = encode_int8(&tb, b, 2, db, stride, bb);
  if (r != 0) return r;
  const int smem = 64 * KC + BN * KC + 8 + 1024;
  cudaError_t e =
      cudaFuncSetAttribute(wgmma_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  wgmma_tile_kernel<<<1, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      ta, tb, static_cast<int*>(out), kstep);
  return (int)cudaGetLastError();
}

// What the conv kernel was built to: registers a thread, bytes of local memory
// a thread (spills), static and dynamic shared memory a block, threads a block.
extern "C" int conv3_int8_attributes(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, conv3_int8_wgmma_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = SMEM;
  out[4] = a.maxThreadsPerBlock;
  return 0;
}

extern "C" const char* mmreg_error_string(int e) {
  switch (e) {
    case ERR_PLAN:
      return "the launch's tiling does not match the kernel's (ops/conv_int8.py::Int8ConvPlan)";
    case ERR_NO_ENCODE:
      return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
    case ERR_ENCODE:
      return "cuTensorMapEncodeTiled refused a tensor map (alignment, strides or box)";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(e));
  }
}
