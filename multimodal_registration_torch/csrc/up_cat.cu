// K10 up_cat: the U-Net decoder's nearest 2x upsample and skip concatenation,
// out = [upsample_nearest_2x(x), skip] along channels, written in one pass.
//
// Replaces no Pallas kernel: the JAX package leaves the upsample (jnp.repeat
// on three axes) and the concatenation to XLA
// (multimodal_registration_tpu/models/unet.py:220, :272). It was added because
// PyTorch runs the pair as two copies far from the card's bandwidth: CUDA's
// upsample_nearest3d has no channels-last kernel, so it writes an NCDHW
// tensor one element a thread, and torch.cat then copies that back into
// channels-last through a transposing copy, each writing bytes the next only
// reads again.
//
//   out[b, i, j, k, c]     = x[b, i/2, j/2, k/2, c]   for c <  C
//   out[b, i, j, k, C + c] = skip[b, i, j, k, c]      for c <  Cs
// x (B, X, Y, Z, C), skip (B, 2X, 2Y, 2Z, Cs), out (B, 2X, 2Y, 2Z, C + Cs), all
// channels-last and contiguous. The kernel copies bytes and never reads a
// value's type: a voxel's row of x is x_row = C * size bytes, of skip
// skip_row = Cs * size, and the wrapper picks the access width W (16, 8, 4 or
// 2 bytes) that divides both rows and every pointer (ops/up_cat.py).
//
// What bounds it on an H100 SXM: bytes. x and skip are read once and out is
// written once: at the flagship's half-resolution level (80 x 80 x 96, C = Cs
// = 64, bf16) 9.8 + 78.6 MB read and 157.3 MB written; the decoder's three
// levels move 280 MB a pair, 84 us at 3.35 TB/s, and 1.12 GB, 0.335 ms, at
// 256 channels. There is no arithmetic beyond addresses.
// Design: a block owns one low-resolution line (b, i/2, j/2) and the four
// output lines (i, j) above it. Each low-resolution W-byte vector of x is read
// once (read-only path) and stored to its 8 children: rows 2k and 2k + 1 of
// the 4 lines. The skip's 4 lines are streamed through, a thread moving one
// vector of each line per step, 4 loads in flight before its 4 stores.
// Neighbouring threads take neighbouring vectors of a row, so a warp reads and
// writes whole 32-byte sectors (a row is 128 B of x and 128 B of skip in the
// flagship, 512 B each at 256 channels, at 16-byte access). The vector index
// within a row comes from a multiply-high division, set up once a launch. No
// shared memory: nothing is reused but x, from registers.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// n / d as (umulhi(n, m) + n) >> s for 0 <= n < 2^31 (Granlund-Montgomery
// with a 33-bit multiplier 2^32 + m; the sum cannot overflow for n < 2^31)
struct Div {
  uint32_t m, s;
};

Div div_of(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {static_cast<uint32_t>(m), s};
}

__device__ __forceinline__ uint32_t quot(uint32_t n, Div q) {
  return (__umulhi(n, q.m) + n) >> q.s;
}

// V the access type (W bytes); nx, ns the vectors of a row of x and of skip
template <typename V>
__global__ void __launch_bounds__(THREADS) up_cat_kernel(
    const V* __restrict__ x, const V* __restrict__ skip, V* __restrict__ out,
    int X, int Y, int Z, int nx, int ns, Div by_nx, Div by_ns) {
  const int64_t line = blockIdx.x;  // (b, i/2, j/2)
  const int64_t jh = line % Y, r = line / Y;
  const int64_t ih = r % X, b = r / X;
  const int64_t R = nx + ns;  // vectors of an output row
  const int64_t Zo = 2 * (int64_t)Z;
  // the four output lines (i, j) = (2 ih + di, 2 jh + dj), l = 2 di + dj
  int64_t o[4], sk[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int64_t ol = ((b * 2 * X + 2 * ih + (l >> 1)) * 2 * Y + 2 * jh + (l & 1)) * Zo;
    o[l] = ol * R;
    sk[l] = ol * ns;
  }

  const V* xl = x + line * Z * nx;
  for (int e = threadIdx.x; e < Z * nx; e += THREADS) {
    const int k = (int)quot(e, by_nx);
    const int w = e - k * nx;
    const V v = __ldg(xl + e);
    const int64_t at = 2 * (int64_t)k * R + w;
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      out[o[l] + at] = v;
      out[o[l] + at + R] = v;
    }
  }

  const int n = (int)(Zo * ns);
  for (int e = threadIdx.x; e < n; e += THREADS) {
    const int z = (int)quot(e, by_ns);
    const int w = e - z * ns;
    const int64_t at = z * R + nx + w;
    V v[4];
#pragma unroll
    for (int l = 0; l < 4; ++l) v[l] = __ldg(skip + sk[l] + e);
#pragma unroll
    for (int l = 0; l < 4; ++l) out[o[l] + at] = v[l];
  }
}

template <typename V>
int launch(const void* x, const void* skip, void* out, int B, int X, int Y, int Z,
           int nx, int ns, cudaStream_t s) {
  const unsigned blocks = (unsigned)((int64_t)B * X * Y);
  up_cat_kernel<V><<<blocks, THREADS, 0, s>>>(
      static_cast<const V*>(x), static_cast<const V*>(skip), static_cast<V*>(out), X, Y, Z,
      nx, ns, div_of(nx > 0 ? nx : 1), div_of(ns > 0 ? ns : 1));
  return (int)cudaGetLastError();
}

}  // namespace

// x_row, skip_row: bytes of a voxel's row of x and of skip; width: the access
// in bytes (16, 8, 4 or 2), dividing both rows and every pointer
extern "C" int up_cat_launch(const void* x, const void* skip, void* out, int B, int X, int Y,
                             int Z, int x_row, int skip_row, int width, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width <= 0 || x_row % width || skip_row % width) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * X * Y * Z == 0 || x_row + skip_row == 0) return 0;
  const int nx = x_row / width, ns = skip_row / width;
  switch (width) {
    case 16: return launch<uint4>(x, skip, out, B, X, Y, Z, nx, ns, s);
    case 8: return launch<uint2>(x, skip, out, B, X, Y, Z, nx, ns, s);
    case 4: return launch<unsigned int>(x, skip, out, B, X, Y, Z, nx, ns, s);
    case 2: return launch<unsigned short>(x, skip, out, B, X, Y, Z, nx, ns, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
