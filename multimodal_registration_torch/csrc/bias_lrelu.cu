// K11 bias_lrelu: the U-Net conv's per-channel bias and LeakyReLU, applied in
// place to the output of a library conv, in one pass over its bytes.
//
// Replaces no Pallas kernel: the JAX package leaves the bias and the
// activation to XLA (nn.Conv + leaky_relu, multimodal_registration_tpu/
// models/unet.py:171), which fuses them into the conv's epilogue. It was added
// because PyTorch's cuDNN route runs the conv without its bias and then adds
// the bias with a broadcast add_ over the output, a pass without vector
// accesses, and F.leaky_relu reads that output once more and writes a new
// tensor: each conv output is read twice and written twice, and the bias is
// cast to the compute type by a launch of its own.
//
//   y[b, c, v] = lrelu(round(y[b, c, v] + round(bias[c])))
//   lrelu(v)   = round(v > 0 ? v : v * slope)
// in float32 arithmetic, round() to the compute type (bf16 or float32, where
// it is the identity), which is what the cast, the add and the LeakyReLU gave,
// bit for bit. y is (B, C, D, H, W) in one of the two layouts cuDNN returns:
// channels-last (C the innermost axis, a voxel's row of C values contiguous)
// or contiguous NCDHW (a channel's plane of S = D H W values contiguous).
//
// What bounds it on an H100 SXM: bytes. The output is read once and written
// once; a w256 pair's nine library convs write 1.347 GB in bf16, 2.69 GB
// moved at 3.35 TB/s, 0.80 ms, four 315 MB outputs at 80 x 80 x 96 x 256
// among them. The arithmetic is two float operations a value.
// Design: accesses of W bytes (16, 8, 4 or 2; the wrapper takes the widest
// that divides the row, or the plane, and the pointer, ops/bias_lrelu.py),
// neighbouring threads on neighbouring vectors, so a warp moves whole 32-byte
// sectors. Channels-last: a block takes rpb = THREADS / nv rows of nv vectors
// at a step, so each thread keeps one column of vectors, and thereby the
// same channels, for the whole launch: their bias values sit in registers,
// rounded once, and the loop has no division. A row wider than THREADS
// vectors is walked by columns, each thread its own. NCDHW: a block walks
// one plane at a time, its one bias value in a register. Both are grid-stride
// loops over as many blocks as the card holds at once, four vectors in
// flight per thread before their stores. The small outputs lie in L2 right
// after their conv.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // vectors a thread loads before it stores them
constexpr int MAX_DEVICES = 64;

// the value type's bits: float, or bf16 as its 16 bits
template <typename T>
__device__ __forceinline__ float to_float(T v);
template <>
__device__ __forceinline__ float to_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_float<uint16_t>(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t from_float<uint16_t>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// a float32 rounded to the compute type and back
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return to_float<T>(from_float<T>(v));
}

// one value: round(y + b), then round(lrelu); b is rounded already
template <typename T>
__device__ __forceinline__ T act(T y, float b, float slope) {
  const float v = rounded<T>(__fadd_rn(to_float<T>(y), b));
  return from_float<T>(v > 0.f ? v : __fmul_rn(v, slope));
}

// one access of E = sizeof(V) / sizeof(T) values, each with its own bias
template <typename V, typename T>
__device__ __forceinline__ V apply(V v, const float* b, float slope) {
  constexpr int E = sizeof(V) / sizeof(T);
  T e[E];
  memcpy(e, &v, sizeof(V));
#pragma unroll
  for (int k = 0; k < E; ++k) e[k] = act<T>(e[k], b[k], slope);
  memcpy(&v, e, sizeof(V));
  return v;
}

// channels-last: rows of nv vectors (a voxel's C channels), rpb rows a block
// takes at a step (1 when nv >= THREADS)
template <typename V, typename T>
__global__ void __launch_bounds__(THREADS) bias_lrelu_cl_kernel(
    V* __restrict__ y, const float* __restrict__ bias, int64_t rows, int nv, int rpb,
    float slope) {
  constexpr int E = sizeof(V) / sizeof(T);
  const bool narrow = nv < THREADS;
  if (narrow && threadIdx.x >= rpb * nv) return;  // the block's last, partial row
  int col = narrow ? threadIdx.x % nv : threadIdx.x;
  const int cstep = narrow ? nv : THREADS;
  const int64_t first = (int64_t)blockIdx.x * rpb + (narrow ? threadIdx.x / nv : 0);
  const int64_t step = (int64_t)gridDim.x * rpb;
  for (; col < nv; col += cstep) {
    float b[E];
#pragma unroll
    for (int k = 0; k < E; ++k) b[k] = rounded<T>(__ldg(bias + col * E + k));
    int64_t r = first;
    for (; r + (UNROLL - 1) * step < rows; r += UNROLL * step) {
      V v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = y[(r + u * step) * nv + col];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        y[(r + u * step) * nv + col] = apply<V, T>(v[u], b, slope);
    }
    for (; r < rows; r += step) y[r * nv + col] = apply<V, T>(y[r * nv + col], b, slope);
  }
}

// NCDHW: planes of ns vectors, plane p of channel p % C
template <typename V, typename T>
__global__ void __launch_bounds__(THREADS) bias_lrelu_ncdhw_kernel(
    V* __restrict__ y, const float* __restrict__ bias, int planes, int C, int64_t ns,
    float slope) {
  constexpr int E = sizeof(V) / sizeof(T);
  const int64_t step = (int64_t)gridDim.x * THREADS;
  for (int p = blockIdx.y; p < planes; p += gridDim.y) {
    float b[E];
    const float bc = rounded<T>(__ldg(bias + p % C));
#pragma unroll
    for (int k = 0; k < E; ++k) b[k] = bc;
    V* yp = y + (int64_t)p * ns;
    int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x;
    for (; e + (UNROLL - 1) * step < ns; e += UNROLL * step) {
      V v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = yp[e + u * step];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) yp[e + u * step] = apply<V, T>(v[u], b, slope);
    }
    for (; e < ns; e += step) yp[e] = apply<V, T>(yp[e], b, slope);
  }
}

// blocks of THREADS the card holds at once for this kernel, on the current
// device, asked once a device; minus the error where a query fails
template <typename K>
int resident_blocks(K kernel) {
  static int cached[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < MAX_DEVICES && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (e != cudaSuccess) return -(int)e;
  const int n = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < MAX_DEVICES) cached[dev] = n;
  return n;
}

template <typename V, typename T>
int launch(void* y, const float* bias, int B, int C, int64_t S, int ncdhw, float slope,
           cudaStream_t s) {
  constexpr int E = sizeof(V) / sizeof(T);
  V* yv = static_cast<V*>(y);
  if (ncdhw) {
    const int64_t ns = S / E;
    const int planes = B * C;
    const int target = resident_blocks(bias_lrelu_ncdhw_kernel<V, T>);
    if (target <= 0) return -target;
    const unsigned gy = (unsigned)(planes < 65535 ? planes : 65535);
    int64_t gx = (target + gy - 1) / gy;
    const int64_t need = (ns + THREADS - 1) / THREADS;
    if (gx > need) gx = need;
    if (gx < 1) gx = 1;
    bias_lrelu_ncdhw_kernel<V, T><<<dim3((unsigned)gx, gy), THREADS, 0, s>>>(
        yv, bias, planes, C, ns, slope);
  } else {
    const int nv = C / E;
    const int rpb = nv < THREADS ? THREADS / nv : 1;
    const int64_t rows = (int64_t)B * S;
    const int target = resident_blocks(bias_lrelu_cl_kernel<V, T>);
    if (target <= 0) return -target;
    int64_t blocks = (rows + rpb - 1) / rpb;
    if (blocks > target) blocks = target;
    bias_lrelu_cl_kernel<V, T><<<(unsigned)blocks, THREADS, 0, s>>>(yv, bias, rows, nv, rpb,
                                                                     slope);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(void* y, const float* bias, int B, int C, int64_t S, int ncdhw, int width,
             float slope, cudaStream_t s) {
  switch (width) {
    case 16: return launch<uint4, T>(y, bias, B, C, S, ncdhw, slope, s);
    case 8: return launch<uint2, T>(y, bias, B, C, S, ncdhw, slope, s);
    case 4: return launch<unsigned int, T>(y, bias, B, C, S, ncdhw, slope, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y: the conv's output, B x C channels of S = D H W voxels, channels-last
// (ncdhw 0) or NCDHW (1), bf16 (is_bf16 1) or float32; bias: C float32
// values; width: the access in bytes (16, 8, 4 or, in bf16, 2), dividing the
// row (C values) or the plane (S values) and the pointer
extern "C" int bias_lrelu_launch(void* y, const void* bias, int B, int C, long long S,
                                 int ncdhw, int width, float slope, int is_bf16,
                                 void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int size = is_bf16 ? 2 : 4;
  const int64_t axis = ncdhw ? S : C;  // the values an access walks along
  if (width < size || width > 16 || (axis * size) % width) return (int)cudaErrorInvalidValue;
  if ((int64_t)B * C * S == 0) return 0;
  const float* b = static_cast<const float*>(bias);
  if (!is_bf16) return dispatch<float>(y, b, B, C, S, ncdhw, width, slope, s);
  if (width == 2) return launch<unsigned short, uint16_t>(y, b, B, C, S, ncdhw, slope, s);
  return dispatch<uint16_t>(y, b, B, C, S, ncdhw, width, slope, s);
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
