// K6 warp_labels_soft_hard and K7 its backward: the trilinear warp of the
// one-hot of an integer label map, without ever forming the one-hot; and the
// training loss's Dice pair, a second entry of each, which never forms the
// warped map either.
//
// Replaces multimodal_registration_tpu/ops/warp.py::warp_labels_soft_hard
// (:570) and ::warp_onehot (:601), and, for the pair, the JAX loss's
// dice_loss / dice_loss_zeropad (losses/losses.py:26, :37) of warp_onehot
// with its gradient w.r.t. the flow. The TPU package has no kernel for it: it
// packs the 8 corner labels per voxel, gathers rows through XLA and mixes a
// checkpointed (X, Y, Z, 8, L) one-hot. Here the corner labels stay in
// registers and shared memory.
//
// K6: labels (B, X, Y, Z) uint8 or int32, flow (B, X, Y, Z, 3) f32 ->
//   soft (B, X, Y, Z, L) f32: soft[l] = sum over the 8 corners, in (dx, dy,
//     dz) order, of the corner's trilinear weight (wx*wy)*wz where the
//     corner's label is l (labels outside [0, L) add to no channel);
//   hard (B, X, Y, Z) int32: the label at the clipped coordinate rounded half
//     to even (rintf), the corner jnp.round selects.
//   Coordinates: c = min(max(x + flow(x), 0), dim-1), i0 = floor(c),
//   i1 = min(i0+1, dim-1), as K2.
// K7: g (B, X, Y, Z, L) f32, labels, flow -> gflow (B, X, Y, Z, 3) f32: per
//   axis, the sum over the corners of d weight / d coordinate times g[label
//   of that corner], times the derivative of the clip (1 inside, 0 outside,
//   one half at exact equality with a bound, as K5).
// The Dice pair, with t (B, X, Y, Z, L) f32 the target map and p = K6's soft
//   map (never written): keep = 1, or with zeropad 0 where t[0] >= 1 or
//   p[0] >= 1 (p[0] summed as K6 sums it, bit for bit);
//   forward (K6's second entry): sums (B, L, 3) f32 = per (b, l) the sums
//     over voxels of keep*t*p, keep*p and keep*t (I, P, T);
//   backward (K7's second entry): coef (B, L, 2) f32 = (alpha, beta) ->
//     gflow as K7 with g[l] = keep * (alpha[l] * t[l] + beta[l]), formed in
//     registers: the Dice cotangent is affine in t (ops/warp.py has the
//     algebra), so no (B, X, Y, Z, L) tensor is read but t.
//
// What bounds them on an H100 SXM: bytes. At 160x160x192, L = 26: K6 writes
// 511 MB of soft and 20 MB of hard and reads 59 MB of flow and 5 MB of
// labels (0.18 ms at 3.35 TB/s); K7 writes 59 MB and reads 59 + 5 MB and, of
// the 511 MB cotangent, only the entries at each voxel's corner labels (one
// to two per voxel on label maps with compact regions; 0.19 ms if all). The
// Dice forward reads all 511 MB of t (T needs every entry) + 64 MB (0.17
// ms); the Dice backward reads of t what K7 reads of g.
// Design, K6: one thread per voxel computes its 8 (label, weight) pairs into
// shared memory; then the whole block writes its 256 x L block of soft,
// which is contiguous in memory, with neighbouring threads on neighbouring
// addresses. K7: one thread per voxel reads the up to 8 entries of its own
// g row. Dice forward: a block walks a fixed set of tiles of TV voxels (the
// set depends on N and L alone, so a batch element's sums do not depend on
// B); it stages the next tile's t rows and displacements (contiguous, TV * L
// and 3 * TV floats) with 16-byte cp.async while it works on this one, so a
// tile waits on one round trip, its corner labels; each voxel's thread
// writes its row of p into shared memory, in t's layout; then each thread
// sums 16-byte slots of both tiles a fixed stride apart (a multiple of L
// floats, so each of its 4 lanes keeps one label), in registers. The
// per-block partial sums (double) are reduced in a fixed order by a second
// kernel: no atomics, the same result run to run. Dice backward: K7's thread
// per voxel, alpha and beta in shared memory, t read only at the distinct
// corner labels.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Corners {
  int64_t lin[8];  // voxel index of each corner inside the batch element
  float w[8];      // trilinear weights
  float rx, ry, rz;  // unclipped coordinates
  float wxs[2], wys[2], wzs[2];
  int64_t nearest;  // voxel index of the rounded coordinate
};

// The corners of voxel n's sample, its displacement read at f (device or
// shared memory).
__device__ __forceinline__ Corners corners_at(const float* f, int n, int X, int Y, int Z) {
  Corners k;
  const int z = n % Z, r = n / Z;
  const int y = r % Y, x = r / Y;
  k.rx = __fadd_rn((float)x, f[0]);
  k.ry = __fadd_rn((float)y, f[1]);
  k.rz = __fadd_rn((float)z, f[2]);
  const float cx = fminf(fmaxf(k.rx, 0.f), (float)(X - 1));
  const float cy = fminf(fmaxf(k.ry, 0.f), (float)(Y - 1));
  const float cz = fminf(fmaxf(k.rz, 0.f), (float)(Z - 1));
  const float fx = floorf(cx), fy = floorf(cy), fz = floorf(cz);
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  const int xs[2] = {x0, min(x0 + 1, X - 1)};
  const int ys[2] = {y0, min(y0 + 1, Y - 1)};
  const int zs[2] = {z0, min(z0 + 1, Z - 1)};
  const float ax = __fsub_rn(cx, fx), ay = __fsub_rn(cy, fy), az = __fsub_rn(cz, fz);
  k.wxs[0] = __fsub_rn(1.f, ax); k.wxs[1] = ax;
  k.wys[0] = __fsub_rn(1.f, ay); k.wys[1] = ay;
  k.wzs[0] = __fsub_rn(1.f, az); k.wzs[1] = az;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dx = i >> 2, dy = (i >> 1) & 1, dz = i & 1;
    k.w[i] = __fmul_rn(__fmul_rn(k.wxs[dx], k.wys[dy]), k.wzs[dz]);
    k.lin[i] = ((int64_t)xs[dx] * Y + ys[dy]) * Z + zs[dz];
  }
  k.nearest = ((int64_t)(int)rintf(cx) * Y + (int)rintf(cy)) * Z + (int)rintf(cz);
  return k;
}

__device__ __forceinline__ Corners corners_of(const float* __restrict__ flow,
                                              int64_t b, int n, int X, int Y, int Z) {
  return corners_at(flow + ((int64_t)b * X * Y * Z + n) * 3, n, X, Y, Z);
}

__device__ __forceinline__ float clip_grad(float c, float hi) {
  const float lo_d = c > 0.f ? 1.f : (c == 0.f ? 0.5f : 0.f);
  const float m = fmaxf(c, 0.f);
  const float hi_d = m < hi ? 1.f : (m == hi ? 0.5f : 0.f);
  return lo_d * hi_d;
}

template <typename LT>
__global__ void __launch_bounds__(THREADS) warp_labels_kernel(
    const LT* __restrict__ labels, const float* __restrict__ flow,
    float* __restrict__ soft, int* __restrict__ hard, int X, int Y, int Z, int L) {
  __shared__ int s_lab[THREADS * 8];
  __shared__ float s_w[THREADS * 8];
  const int N = X * Y * Z;
  const int64_t b = blockIdx.y;
  const int n0 = blockIdx.x * THREADS;
  const int n = n0 + threadIdx.x;
  const LT* lab = labels + b * N;
  if (n < N) {
    const Corners k = corners_of(flow, b, n, X, Y, Z);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      s_lab[threadIdx.x * 8 + i] = (int)lab[k.lin[i]];
      s_w[threadIdx.x * 8 + i] = k.w[i];
    }
    hard[b * N + n] = (int)lab[k.nearest];
  }
  __syncthreads();
  const int count = min(THREADS, N - n0) * L;  // values of soft this block writes
  float* out = soft + (b * N + n0) * L;
  for (int j = threadIdx.x; j < count; j += THREADS) {
    const int v = j / L, l = j - v * L;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (s_lab[v * 8 + i] == l) acc = __fadd_rn(acc, s_w[v * 8 + i]);
    out[j] = acc;
  }
}

template <typename LT>
__global__ void __launch_bounds__(THREADS) warp_labels_bwd_kernel(
    const float* __restrict__ g, const LT* __restrict__ labels,
    const float* __restrict__ flow, float* __restrict__ gflow, int X, int Y,
    int Z, int L) {
  const int N = X * Y * Z;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const int64_t b = blockIdx.y;
  const Corners k = corners_of(flow, b, n, X, Y, Z);
  const LT* lab = labels + b * N;
  const float* gr = g + (b * N + n) * L;
  float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dx = i >> 2, dy = (i >> 1) & 1, dz = i & 1;
    const int l = (int)lab[k.lin[i]];
    const float gv = (l >= 0 && l < L) ? gr[l] : 0.f;
    gx += gv * (dx ? 1.f : -1.f) * k.wys[dy] * k.wzs[dz];
    gy += gv * (dy ? 1.f : -1.f) * k.wxs[dx] * k.wzs[dz];
    gz += gv * (dz ? 1.f : -1.f) * k.wxs[dx] * k.wys[dy];
  }
  float* o = gflow + (b * N + n) * 3;
  o[0] = gx * clip_grad(k.rx, (float)(X - 1));
  o[1] = gy * clip_grad(k.ry, (float)(Y - 1));
  o[2] = gz * clip_grad(k.rz, (float)(Z - 1));
}

// ---- the Dice pair -------------------------------------------------------------

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Where element 0 of the rows at src lands in a staging buffer: the offset
// (0..3 floats) that puts 16-byte-aligned device addresses on 16-byte-aligned
// shared ones.
__device__ __forceinline__ int stage_offset(const float* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

// Copy cnt floats from src to buf + stage_offset(src) (buf 16-byte aligned):
// 4-byte copies up to the first aligned address and after the last, 16-byte
// copies between.
__device__ __forceinline__ void stage_rows(float* buf, const float* src, int cnt) {
  const int off = stage_offset(src);
  const int head = min((4 - off) & 3, cnt);
  const int nvec = (cnt - head) >> 2;
  float* d = buf + off;
  for (int i = threadIdx.x; i < head; i += THREADS) cp_async<4>(d + i, src + i);
  for (int i = threadIdx.x; i < nvec; i += THREADS)
    cp_async<16>(d + head + 4 * i, src + head + 4 * i);
  for (int i = head + 4 * nvec + threadIdx.x; i < cnt; i += THREADS) cp_async<4>(d + i, src + i);
}

// The Dice forward's tile buffers, in floats: a staged tile of t rows, or of
// p rows in the same layout, with room for the alignment offset and the last
// 16-byte slot.
__host__ __device__ inline int dice_span(int TV, int L) { return TV * L + 8; }

// Its shared memory, in bytes: two t tiles, the p tile, two flow tiles; the
// block's final reduction (12 doubles a thread) reuses them.
inline size_t dice_fwd_smem(int TV, int L) {
  const size_t f = (size_t)3 * dice_span(TV, L) + (size_t)2 * (3 * TV + 4);
  return (f > (size_t)THREADS * 24 ? f : (size_t)THREADS * 24) * 4;
}

template <typename LT>
__global__ void __launch_bounds__(THREADS, 4) warp_labels_dice_fwd_kernel(
    const LT* __restrict__ labels, const float* __restrict__ flow,
    const float* __restrict__ t, double* __restrict__ partial, int X, int Y, int Z,
    int L, int TV, int zeropad) {
  extern __shared__ __align__(16) unsigned char dice_smem[];
  const int N = X * Y * Z;
  const int64_t b = blockIdx.y;
  const int ntiles = (N + TV - 1) / TV;
  // every span a multiple of 4 floats (TV is a multiple of 32): each buffer
  // starts 16-byte aligned
  const int span = dice_span(TV, L), span_f = 3 * TV + 4;
  float* s_t0 = reinterpret_cast<float*>(dice_smem);
  float* s_p = s_t0 + 2 * span;
  float* s_f0 = s_p + span;
  const LT* lab = labels + b * N;
  const float* tb = t + b * (int64_t)N * L;
  const float* fb = flow + b * (int64_t)N * 3;
  // a tile starts TV * L (t) and 3 * TV (flow) floats after the last, both
  // multiples of 4: the staging offsets are the batch element's
  const int off = stage_offset(tb), off_f = stage_offset(fb);
  // thread i sums the 16-byte slots i, i + Tp, i + 2 Tp, ... of a tile: 4 Tp
  // floats are a multiple of L, so the 4 labels of a thread's slots stay
  const int A = L / ((L & 3) == 0 ? 4 : ((L & 1) == 0 ? 2 : 1));
  const int Tp = (THREADS / A) * A;
  double dI[4] = {0.0, 0.0, 0.0, 0.0}, dP[4] = {0.0, 0.0, 0.0, 0.0},
         dT[4] = {0.0, 0.0, 0.0, 0.0};

  // the tile's t rows and displacements, staged one tile ahead
  auto stage = [&](int tile, int buf) {
    const int n0 = tile * TV, nv = min(TV, N - n0);
    stage_rows(s_t0 + buf * span, tb + (int64_t)n0 * L, nv * L);
    stage_rows(s_f0 + buf * span_f, fb + (int64_t)n0 * 3, nv * 3);
  };
  int tile = blockIdx.x;
  if (tile < ntiles) stage(tile, 0);
  cp_async_commit();
  for (int buf = 0; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int n0 = tile * TV;
    const int nv = min(TV, N - n0);
    const int E = nv * L;               // the tile's floats, at [off, off + E) of a buffer
    const int Q = (off + E + 3) >> 2;   // the 16-byte slots that hold them
    // the other buffers were last read before the previous tile's final barrier
    if (tile + (int)gridDim.x < ntiles) stage(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    for (int q = threadIdx.x; q < Q; q += THREADS)
      reinterpret_cast<float4*>(s_p)[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    cp_async_wait_all_but_one();  // this tile's rows (the next tile's may be in flight)
    __syncthreads();
    float* st = s_t0 + buf * span;
    // each voxel's p row, summed as K6 sums it; keep = 0 zeroes its t and p rows
    if (threadIdx.x < nv) {
      const int v = threadIdx.x;
      const Corners k = corners_at(s_f0 + buf * span_f + off_f + 3 * v, n0 + v, X, Y, Z);
      float* prow = s_p + off + v * L;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = (int)lab[k.lin[i]];
        if (c >= 0 && c < L) prow[c] = __fadd_rn(prow[c], k.w[i]);
      }
      float* trow = st + off + v * L;
      if (zeropad && (trow[0] >= 1.f || prow[0] >= 1.f))
        for (int j = 0; j < L; ++j) trow[j] = prow[j] = 0.f;
    }
    __syncthreads();
    if (threadIdx.x < Tp) {
      float aI[4] = {0.f, 0.f, 0.f, 0.f}, aP[4] = {0.f, 0.f, 0.f, 0.f},
            aT[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = threadIdx.x; q < Q; q += Tp) {
        const float4 t4 = reinterpret_cast<const float4*>(st)[q];
        const float4 p4 = reinterpret_cast<const float4*>(s_p)[q];  // zeros outside the tile
        const float tv[4] = {t4.x, t4.y, t4.z, t4.w}, pv[4] = {p4.x, p4.y, p4.z, p4.w};
        const int e0 = 4 * q - off;
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float x = (unsigned)(e0 + s) < (unsigned)E ? tv[s] : 0.f;
          aT[s] += x;
          aP[s] += pv[s];
          aI[s] = fmaf(x, pv[s], aI[s]);
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        dI[s] += aI[s];
        dP[s] += aP[s];
        dT[s] += aT[s];
      }
    }
    __syncthreads();
  }
  // the block's sums by label, in a fixed order; the buffers are free now
  double* s_red = reinterpret_cast<double*>(dice_smem);
  if (threadIdx.x < Tp) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      s_red[threadIdx.x * 12 + 3 * s + 0] = dI[s];
      s_red[threadIdx.x * 12 + 3 * s + 1] = dP[s];
      s_red[threadIdx.x * 12 + 3 * s + 2] = dT[s];
    }
  }
  __syncthreads();
  // threads i, i + A, i + 2 A, ... sum the same labels: fold them onto i < A
  for (int j = threadIdx.x; j < 12 * A; j += THREADS) {
    double sum = s_red[j];
    for (int c = 1; c < Tp / A; ++c) sum += s_red[c * 12 * A + j];
    s_red[j] = sum;
  }
  __syncthreads();
  double* out = partial + (b * gridDim.x + blockIdx.x) * 3 * L;
  for (int j = threadIdx.x; j < 3 * L; j += THREADS) {  // j = label * 3 + which sum
    const int l = j / 3, w = j % 3;
    double sum = 0.0;
    for (int i0 = 0; i0 < A; ++i0)
      for (int s = 0; s < 4; ++s) {
        const int e = (4 * i0 + s - off) % L;  // the label of slot (i0, s)
        if ((e < 0 ? e + L : e) == l) sum += s_red[i0 * 12 + 3 * s + w];
      }
    out[j] = sum;
  }
}

// sums[b, j] = the sum over the G blocks of partial[b, g, j], in a fixed order.
constexpr int REDUCE_THREADS = 128;
__global__ void __launch_bounds__(REDUCE_THREADS) warp_labels_dice_reduce_kernel(
    const double* __restrict__ partial, float* __restrict__ sums, int G, int L) {
  __shared__ double s[REDUCE_THREADS];
  const int j = blockIdx.x;
  const int64_t b = blockIdx.y;
  double acc = 0.0;
  for (int g = threadIdx.x; g < G; g += REDUCE_THREADS) acc += partial[(b * G + g) * 3 * L + j];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int w = REDUCE_THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) s[threadIdx.x] += s[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[b * 3 * L + j] = (float)s[0];
}

template <typename LT>
__global__ void __launch_bounds__(THREADS) warp_labels_dice_bwd_kernel(
    const float* __restrict__ t, const LT* __restrict__ labels,
    const float* __restrict__ flow, const float* __restrict__ coef,
    float* __restrict__ gflow, int X, int Y, int Z, int L, int zeropad) {
  extern __shared__ float s_coef[];  // (alpha, beta) of each label of this batch element
  const int64_t b = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * L; i += THREADS) s_coef[i] = coef[b * 2 * L + i];
  __syncthreads();
  const int N = X * Y * Z;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const Corners k = corners_of(flow, b, n, X, Y, Z);
  const LT* lab = labels + b * N;
  const float* tr = t + (b * N + n) * L;
  int lb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) lb[i] = (int)lab[k.lin[i]];
  bool keep = true;
  if (zeropad) {
    float p0 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lb[i] == 0) p0 = __fadd_rn(p0, k.w[i]);
    keep = !(tr[0] >= 1.f || p0 >= 1.f);
  }
  // the cotangent at each corner's label, read once per distinct label
  float gv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = lb[i];
    bool seen = false;
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < i; ++j)
      if (lb[j] == c) {
        seen = true;
        v = gv[j];
      }
    if (!seen && keep && c >= 0 && c < L) v = fmaf(s_coef[2 * c], tr[c], s_coef[2 * c + 1]);
    gv[i] = v;
  }
  float gx = 0.f, gy = 0.f, gz = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int dx = i >> 2, dy = (i >> 1) & 1, dz = i & 1;
    gx += gv[i] * (dx ? 1.f : -1.f) * k.wys[dy] * k.wzs[dz];
    gy += gv[i] * (dy ? 1.f : -1.f) * k.wxs[dx] * k.wzs[dz];
    gz += gv[i] * (dz ? 1.f : -1.f) * k.wxs[dx] * k.wys[dy];
  }
  float* o = gflow + (b * N + n) * 3;
  o[0] = gx * clip_grad(k.rx, (float)(X - 1));
  o[1] = gy * clip_grad(k.ry, (float)(Y - 1));
  o[2] = gz * clip_grad(k.rz, (float)(Z - 1));
}

template <typename LT>
int dice_fwd(const LT* labels, const float* flow, const float* t, double* partial, float* sums,
             int B, int X, int Y, int Z, int L, int TV, int G, int zeropad, cudaStream_t s) {
  const size_t smem = dice_fwd_smem(TV, L);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        warp_labels_dice_fwd_kernel<LT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  warp_labels_dice_fwd_kernel<LT><<<dim3(G, B), THREADS, smem, s>>>(
      labels, flow, t, partial, X, Y, Z, L, TV, zeropad);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  warp_labels_dice_reduce_kernel<<<dim3(3 * L, B), REDUCE_THREADS, 0, s>>>(partial, sums, G, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warp_labels_launch(const void* labels, const void* flow,
                                  void* soft, void* hard, int B, int X, int Y,
                                  int Z, int L, int labels_are_u8, void* stream) {
  cudaGetLastError();  // clear an unrelated pending error of this runtime
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((X * Y * Z + THREADS - 1) / THREADS, B);
  const float* f = static_cast<const float*>(flow);
  float* so = static_cast<float*>(soft);
  int* ha = static_cast<int*>(hard);
  if (labels_are_u8)
    warp_labels_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        static_cast<const uint8_t*>(labels), f, so, ha, X, Y, Z, L);
  else
    warp_labels_kernel<int><<<grid, THREADS, 0, s>>>(
        static_cast<const int*>(labels), f, so, ha, X, Y, Z, L);
  return (int)cudaGetLastError();
}

extern "C" int warp_labels_bwd_launch(const void* g, const void* labels,
                                      const void* flow, void* gflow, int B,
                                      int X, int Y, int Z, int L,
                                      int labels_are_u8, void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((X * Y * Z + THREADS - 1) / THREADS, B);
  const float* gg = static_cast<const float*>(g);
  const float* f = static_cast<const float*>(flow);
  float* go = static_cast<float*>(gflow);
  if (labels_are_u8)
    warp_labels_bwd_kernel<uint8_t><<<grid, THREADS, 0, s>>>(
        gg, static_cast<const uint8_t*>(labels), f, go, X, Y, Z, L);
  else
    warp_labels_bwd_kernel<int><<<grid, THREADS, 0, s>>>(
        gg, static_cast<const int*>(labels), f, go, X, Y, Z, L);
  return (int)cudaGetLastError();
}

// The Dice forward: partial is scratch of B * G * L * 3 doubles; sums (B, L, 3)
// f32. TV (tile voxels) is a multiple of 32, at most 256; G <= ceil(N / TV).
extern "C" int warp_labels_dice_fwd_launch(const void* labels, const void* flow, const void* t,
                                           void* partial, void* sums, int B, int X, int Y,
                                           int Z, int L, int TV, int G, int zeropad,
                                           int labels_are_u8, void* stream) {
  cudaGetLastError();
  const int ntiles = (X * Y * Z + TV - 1) / TV;
  if (TV < 32 || TV > THREADS || TV % 32 || L < 1 || L > THREADS || G < 1 || G > ntiles)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f = static_cast<const float*>(flow);
  const float* tt = static_cast<const float*>(t);
  double* pa = static_cast<double*>(partial);
  float* su = static_cast<float*>(sums);
  if (labels_are_u8)
    return dice_fwd(static_cast<const uint8_t*>(labels), f, tt, pa, su, B, X, Y, Z, L, TV, G,
                    zeropad, s);
  return dice_fwd(static_cast<const int*>(labels), f, tt, pa, su, B, X, Y, Z, L, TV, G, zeropad,
                  s);
}

// The Dice backward: coef (B, L, 2) f32, the loss's (alpha, beta) already
// scaled by the incoming gradient; gflow (B, X, Y, Z, 3) f32.
extern "C" int warp_labels_dice_bwd_launch(const void* t, const void* labels, const void* flow,
                                           const void* coef, void* gflow, int B, int X, int Y,
                                           int Z, int L, int zeropad, int labels_are_u8,
                                           void* stream) {
  cudaGetLastError();
  if (L < 1 || L > THREADS) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((X * Y * Z + THREADS - 1) / THREADS, B);
  const size_t smem = (size_t)2 * L * 4;
  const float* tt = static_cast<const float*>(t);
  const float* f = static_cast<const float*>(flow);
  const float* co = static_cast<const float*>(coef);
  float* go = static_cast<float*>(gflow);
  if (labels_are_u8)
    warp_labels_dice_bwd_kernel<uint8_t><<<grid, THREADS, smem, s>>>(
        tt, static_cast<const uint8_t*>(labels), f, co, go, X, Y, Z, L, zeropad);
  else
    warp_labels_dice_bwd_kernel<int><<<grid, THREADS, smem, s>>>(
        tt, static_cast<const int*>(labels), f, co, go, X, Y, Z, L, zeropad);
  return (int)cudaGetLastError();
}

extern "C" const char* mmreg_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
