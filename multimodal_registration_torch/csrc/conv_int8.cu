// K8 conv3_int8: the int8 x int8 -> int32 3x3x3 SAME conv of the U-Net's wide
// blocks, with the dequantization, bias and LeakyReLU fused.
//
// Replaces multimodal_registration_tpu/models/unet.py::ConvBlock._int8_conv
// (an XLA int8 conv with int32 accumulation; no Pallas kernel). The same
// arithmetic, in the same order:
//   xq = clip(rint(x_f32 * inv_a), +-127)           (quantize_act_kernel)
//   acc = sum over 27 taps and Cin of xq * wq, int32  (conv3_int8_kernel)
//   y = acc_f32 * scale[n] + bias[n]; y = y >= 0 ? y : slope * y
// with scale = a_scale * w_scale[n] and the weights quantized once per
// parameter version by the wrapper (ops/conv_int8.py::prepared_int8_weights).
// Products and sums are rounded one at a time (__fmul_rn, __fadd_rn: no FMA
// contraction), so the kernel and its plain version agree bit for bit.
//
// What bounds it on an H100 SXM (the widest call of the published model,
// dec_3: 512 -> 256 channels at 80x80x96, batch 1): 2 * 614,400 * 256 *
// 27 * 512 = 4.35e12 integer operations, 2.2 ms at the int8 tensor-core peak
// (1,979 TOPS), against 629 MB of bf16 input and 315 MB of bf16 output, 0.28 ms
// at 3.35 TB/s. So it is bound by operations: it must run on the tensor cores.
//
// Design (a first, simple kernel; wgmma and TMA are left for a later one):
//  * A quantize pass writes x as int8, channels-last, Cin padded with zeros to
//    Cp, a multiple of 64 (one k-chunk of one tap).
//  * The conv is an implicit GEMM: M = voxels (B*X*Y*Z), N = Cout, K = 27*Cp,
//    on mma.sync m16n8k32 (s8 operands, s32 accumulators). A block owns a tile
//    of 128 voxels (consecutive in memory, mostly along z) x 128 output
//    channels; its 8 warps each 64 x 32. K is streamed through shared memory
//    in chunks of one tap x 64 channels: the A chunk (128 voxel rows of 64
//    bytes, each the tap's neighbour of its voxel, zeros outside the volume,
//    which is SAME padding since zero quantizes to zero) and the B chunk (128
//    weight rows of 64 bytes), four stages in flight with cp.async. The
//    weights (27 * 512 * 256 B = 3.5 MB for dec_3) never fit in shared memory
//    whole, unlike K1's.
//  * Shared-memory rows are 80 bytes (64 + 16 of padding), so the eight rows
//    an ldmatrix phase reads fall in distinct banks.
//  * Fragments come from ldmatrix: an s8 m16n8k32 A fragment is, word for
//    word, a b16 m16n8k16 one (row g / g + 8, word t / t + 4), and B is
//    stored n-major, k contiguous (the "col" operand).
//  * Offsets into x and out are 64-bit: B*X*Y*Z*C passes 2^31 at dec_3 with
//    batches of 4 tiles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;  // voxels, output channels, k bytes per stage
constexpr int STAGES = 4;
constexpr int ROW = BK + 16;                // bytes per shared-memory row
constexpr int A_STAGE = BM * ROW, B_STAGE = BN * ROW;
constexpr int SMEM = STAGES * (A_STAGE + B_STAGE);  // 81,920 bytes
constexpr int THREADS = 256;

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;  // src-size 0: the 16 bytes are filled with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// mode 0: out int32 sums; 1: bf16 epilogue; 2: f32 epilogue.
__global__ void __launch_bounds__(THREADS, 2) conv3_int8_kernel(
    const int8_t* __restrict__ xq, const int8_t* __restrict__ wq, const float* __restrict__ scale,
    const float* __restrict__ bias, void* __restrict__ out, int64_t M, int X, int Y, int Z,
    int Cp, int Cout, int mode, float slope) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(smem);
  const uint32_t sA = s_base, sB = s_base + STAGES * A_STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int CC = Cp / BK;  // k-chunks per tap
  const int KT = 27 * CC;
  const int64_t K = 27 * (int64_t)Cp;

  // the two A rows and B rows this thread copies: rows tid / 4 and 64 + tid / 4,
  // 16-byte chunk tid % 4 of each
  const int chunk = tid & 3;
  int vx[2], vy[2], vz[2];
  int64_t vm[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int64_t m = m0 + (tid >> 2) + 64 * i;
    vm[i] = m;
    if (m < M) {
      int64_t r = m;
      vz[i] = (int)(r % Z);
      r /= Z;
      vy[i] = (int)(r % Y);
      r /= Y;
      vx[i] = (int)(r % X);
    } else {
      vx[i] = -100;  // every neighbour lies outside: the row stays zero
      vy[i] = vz[i] = 0;
    }
  }

  auto load_stage = [&](int slot, int kt) {
    const int tap = kt / CC, c0 = (kt % CC) * BK + chunk * 16;
    const int dx = tap / 9 - 1, dy = (tap / 3) % 3 - 1, dz = tap % 3 - 1;
    const int64_t delta = ((int64_t)dx * Y + dy) * Z + dz;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const int x = vx[i] + dx, y = vy[i] + dy, z = vz[i] + dz;
      const bool in = x >= 0 && x < X && y >= 0 && y < Y && z >= 0 && z < Z;
      const int8_t* src = in ? xq + (vm[i] + delta) * Cp + c0 : xq;
      cp_async16(sA + slot * A_STAGE + r * ROW + chunk * 16, src, in);
      const int8_t* wsrc = wq + (int64_t)(n0 + r) * K + (int64_t)kt * BK + chunk * 16;
      cp_async16(sB + slot * B_STAGE + r * ROW + chunk * 16, wsrc, true);
    }
  };

  const int wm = warp & 1, wn = warp >> 1;  // the warp's 64 x 32 tile
  int acc[4][4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0;

  // ldmatrix addresses of this lane within a stage: A row (lane % 16) of an
  // m-tile, bytes (lane / 16) * 16 of a k-step; B row (lane % 8) + 8 (lane / 16)
  // of an n-tile pair, bytes ((lane / 8) % 2) * 16
  const uint32_t a_off = (wm * 64 + (lane & 15)) * ROW + (lane >> 4) * 16;
  const uint32_t b_off = (wn * 32 + (lane & 7) + ((lane >> 4) << 3)) * ROW + ((lane >> 3) & 1) * 16;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with stage kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk);
    cp_async_commit();

    const int slot = kt % STAGES;
    const uint32_t As = sA + slot * A_STAGE + a_off, Bs = sB + slot * B_STAGE + b_off;
#pragma unroll
    for (int ks = 0; ks < BK / 32; ++ks) {
      uint32_t af[4][4], bfr[2][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(af[mt], As + mt * 16 * ROW + ks * 32);
#pragma unroll
      for (int np = 0; np < 2; ++np) ldmatrix_x4(bfr[np], Bs + np * 16 * ROW + ks * 32);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], af[mt], bfr[nt >> 1][(nt & 1) * 2], bfr[nt >> 1][(nt & 1) * 2 + 1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: register c of (mt, nt) is row g (+ 8 for c >= 2), column 2 t + c % 2
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int64_t m = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = n0 + wn * 32 + nt * 8 + 2 * t4 + j;
          if (n >= Cout) continue;
          const int s = acc[mt][nt][2 * h + j];
          const int64_t o = m * Cout + n;
          if (mode == 0) {
            static_cast<int*>(out)[o] = s;
          } else {
            float y = __fadd_rn(__fmul_rn(__int2float_rn(s), scale[n]), bias[n]);
            y = y >= 0.f ? y : __fmul_rn(y, slope);
            if (mode == 1)
              static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(y);
            else
              static_cast<float*>(out)[o] = y;
          }
        }
    }
}

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

// xq (B*X*Y*Z, Cp) int8; wq (Cout rounded up to 128, 27*Cp) int8, row n, k = tap * Cp + ci
// with tap = (dx*3 + dy)*3 + dz; scale, bias (Cout rounded up to 128) f32; out (M, Cout)
// int32 (mode 0), bf16 (1) or f32 (2).
extern "C" int conv3_int8_launch(const void* xq, const void* wq, const void* scale,
                                 const void* bias, void* out, int B, int X, int Y, int Z, int Cp,
                                 int Cout, int mode, float slope, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t M = (int64_t)B * X * Y * Z;
  if (M == 0 || Cout == 0) return 0;
  cudaError_t e =
      cudaFuncSetAttribute(conv3_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((Cout + BN - 1) / BN));
  conv3_int8_kernel<<<grid, THREADS, SMEM, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(scale), static_cast<const float*>(bias), out, M, X, Y, Z, Cp, Cout,
      mode, slope);
  return (int)cudaGetLastError();
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
