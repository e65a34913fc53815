// Shared device helpers of the mesh-intersection kernels (cull.cu,
// stream.cu, packet.cu, wide.cu), and the vector arithmetic of analytic.cu,
// shade.cu and raygen.cu and the PCG draws of the last two.
//
// Every formula keeps the operation order of the JAX package's Pallas kernels
// and of the plain PyTorch versions beside the wrappers. The library is built
// with -fmad=false and without fast math, so no multiply-add is contracted,
// division and sqrt are IEEE, and each kernel matches its plain version on the
// same inputs bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace pt {

constexpr int TREELET_NONE = 0x3FFFFFF;  // scene/types.py TREELET_NONE
constexpr float FLT_MAX_F = 3.402823466e38f;
constexpr int TRIS_PER_ROW = 6;           // 6 tris x 20 fields per 128-lane row
constexpr int TRI_STRIDE = 20;
constexpr int ROW = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_HIT = 0xffffffffu;  // above every positive float's bits

// jnp.maximum / jnp.minimum / torch.maximum semantics: a NaN operand yields
// NaN (fmaxf / fminf would drop it and change which slabs are entered).
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// Slab test of box (lo, hi) against o + t d with inv = 1 / d; writes the
// entry (t0) and exit (t1) parameters.
__device__ __forceinline__ void slab(const float* lo, const float* hi,
                                     float ox, float oy, float oz,
                                     float ix, float iy, float iz,
                                     float& t0, float& t1) {
  const float tnx = (lo[0] - ox) * ix;
  const float tfx = (hi[0] - ox) * ix;
  const float tny = (lo[1] - oy) * iy;
  const float tfy = (hi[1] - oy) * iy;
  const float tnz = (lo[2] - oz) * iz;
  const float tfz = (hi[2] - oz) * iz;
  t0 = nan_max(nan_max(nan_min(tnx, tfx), nan_min(tny, tfy)),
               nan_min(tnz, tfz));
  t1 = nan_min(nan_min(nan_max(tnx, tfx), nan_max(tny, tfy)),
               nan_max(tnz, tfz));
}

// The slab test with fewer instructions, for a sweep that only compares the
// parameters: false when a slab parameter is NaN (slab's t0 and t1 would be
// NaN and fail every comparison); otherwise t0 and t1 equal slab's in value.
// Plain fminf / fmaxf differ from nan_min / nan_max only on NaN and in the
// sign of a zero, which no comparison sees; a kernel that outputs t0
// recomputes it with slab.
__device__ __forceinline__ bool slab_fast(float lx, float ly, float lz,
                                          float hx, float hy, float hz,
                                          float ox, float oy, float oz,
                                          float ix, float iy, float iz,
                                          float& t0, float& t1) {
  const float tnx = (lx - ox) * ix;
  const float tfx = (hx - ox) * ix;
  const float tny = (ly - oy) * iy;
  const float tfy = (hy - oy) * iy;
  const float tnz = (lz - oz) * iz;
  const float tfz = (hz - oz) * iz;
  const bool nan = tnx != tnx || tfx != tfx || tny != tny || tfy != tfy ||
                   tnz != tnz || tfz != tfz;
  t0 = fmaxf(fmaxf(fminf(tnx, tfx), fminf(tny, tfy)), fminf(tnz, tfz));
  t1 = fminf(fminf(fmaxf(tnx, tfx), fmaxf(tny, tfy)), fmaxf(tnz, tfz));
  return !nan;
}

struct Best {
  float t;       // closest accepted t so far (starts at the lane's bound)
  float nx, ny, nz;  // raw interpolated normal of the winner
  int mat;
};

// Moller-Trumbore against the triangle v0 + u e1 + v e2 (the first nine
// fields of a packed record): true on a valid hit in front of the origin,
// with its t and barycentrics u, v (a NaN t fails t >= 1e-6).
__device__ __forceinline__ bool tri_hit(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& t, float& u, float& v) {
  const float hx = dy * e2z - dz * e2y;
  const float hy = dz * e2x - dx * e2z;
  const float hz = dx * e2y - dy * e2x;
  const float a = e1x * hx + e1y * hy + e1z * hz;
  const bool parallel = fabsf(a) < 1e-6f;
  const float f = 1.0f / (parallel ? 1.0f : a);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  u = f * (sx * hx + sy * hy + sz * hz);
  const float qx = sy * e1z - sz * e1y;
  const float qy = sz * e1x - sx * e1z;
  const float qz = sx * e1y - sy * e1x;
  v = f * (dx * qx + dy * qy + dz * qz);
  t = f * (e2x * qx + e2y * qy + e2z * qz);
  const bool valid = !parallel && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                     (u + v) <= 1.0f && t >= 1e-6f;
  return valid && t > 0.0f;
}

// The same against one packed triangle record tv[0..19] (v0, e1, e2, n0,
// n1, n2, material_id).
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tv,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& t, float& u, float& v) {
  return tri_hit(tv[0], tv[1], tv[2], tv[3], tv[4], tv[5], tv[6], tv[7],
                 tv[8], ox, oy, oz, dx, dy, dz, t, u, v);
}

// Make the hit (t, u, v) on record tv the lane's best: t, the raw
// interpolated normal and the material.
__device__ __forceinline__ void take_hit(const float* __restrict__ tv,
                                         float t, float u, float v, Best& b) {
  const float w = 1.0f - u - v;
  b.t = t;
  b.nx = w * tv[9] + u * tv[12] + v * tv[15];
  b.ny = w * tv[10] + u * tv[13] + v * tv[16];
  b.nz = w * tv[11] + u * tv[14] + v * tv[17];
  b.mat = static_cast<int>(tv[18]);  // truncation, as astype(int32)
}

// Moller-Trumbore against one record; keeps the hit if strictly closer.
__device__ __forceinline__ void tri_test(const float* __restrict__ tv,
                                         float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         Best& b) {
  float t, u, v;
  if (tri_hit(tv, ox, oy, oz, dx, dy, dz, t, u, v) && t < b.t)
    take_hit(tv, t, u, v, b);
}

// The winner of one ray's triangle tests spread over the warp: lane l holds
// its first hit of least t (ck = -1: none) among the triangles k = l,
// l + 32, ... that it tested in increasing order. The winner is the arg-min
// of (t, k) over the warp, by two warp reductions (redux.sync): exactly the
// triangle that the serial strict-`<` loop over k keeps (a hit's t is
// positive, so its bits order as the floats do, and NO_HIT is above them
// all). Returns false on every lane when no lane has a hit; else every lane
// gets its t, k and barycentrics (from lane k % 32, which tested k). Call it
// on all 32 lanes.
__device__ __forceinline__ bool warp_winner(float ct, int ck, float cu,
                                            float cv, float& t_win,
                                            int& k_win, float& u_win,
                                            float& v_win) {
  const unsigned t_bits = ck >= 0 ? __float_as_uint(ct) : NO_HIT;
  const unsigned t_min = __reduce_min_sync(FULL, t_bits);
  if (t_min == NO_HIT) return false;
  k_win = static_cast<int>(__reduce_min_sync(
      FULL, t_bits == t_min ? static_cast<unsigned>(ck) : NO_HIT));
  t_win = __uint_as_float(t_min);
  u_win = __shfl_sync(FULL, cu, k_win % 32);
  v_win = __shfl_sync(FULL, cv, k_win % 32);
  return true;
}

// Deferred epilogue: normalize and face the winning normal toward the ray,
// and report a miss when nothing beat the incoming bound.
__device__ __forceinline__ void store_hit(const Best& b, float bound,
                                          float dx, float dy, float dz,
                                          int i, float* t_out, float* nx_out,
                                          float* ny_out, float* nz_out,
                                          int* mat_out) {
  const float len2 = b.nx * b.nx + b.ny * b.ny + b.nz * b.nz;
  const float inv_len = 1.0f / sqrtf(nan_max(len2, 1e-30f));
  const float fl = (dx * b.nx + dy * b.ny + dz * b.nz > 0.0f) ? -inv_len
                                                               : inv_len;
  const bool missed = b.t >= bound;
  t_out[i] = missed ? -1.0f : b.t;
  nx_out[i] = b.nx * fl;
  ny_out[i] = b.ny * fl;
  nz_out[i] = b.nz * fl;
  mat_out[i] = missed ? -1 : b.mat;
}

// store_hit of a lane that tested nothing (Best{bound, 0, 0, 0, -1}), which
// needs no direction: the zero normal's dot product is never positive, so
// its facing factor is positive and finite and the normal stays +0.
__device__ __forceinline__ void store_miss(float bound, int i, float* t_out,
                                           float* nx_out, float* ny_out,
                                           float* nz_out, int* mat_out) {
  t_out[i] = bound >= bound ? -1.0f : bound;  // a NaN bound is not missed
  nx_out[i] = 0.0f;
  ny_out[i] = 0.0f;
  nz_out[i] = 0.0f;
  mat_out[i] = -1;
}

// Append index i to `list` where `keep`, with one ballot and one atomicAdd
// on `count` a warp: the compaction before a walk whose warps then fetch
// their rays from the list (packet.cu, wide.cu). The list's order is not
// fixed; each walk writes only its own lane's outputs. Call it on all 32
// lanes of the warp.
__device__ __forceinline__ void append_active(bool keep, int i,
                                              unsigned* count, int* list) {
  const unsigned m = __ballot_sync(FULL, keep);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(FULL, base, leader);
  if (keep) list[base + __popc(m & ((1u << lane) - 1))] = i;
}

// A float3 of the plain versions' Vec3, with its operations in Vec3's order
// (utils/vec.py): dot as x*x' + y*y' + z*z' left to right.
struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
// Vec3.normalize: v * rsqrt(clamp(|v|^2, min=1e-30)); torch.rsqrt is rsqrtf
__device__ __forceinline__ V3 normalize(V3 v) {
  return scale(v, rsqrtf(nan_max(dot(v, v), static_cast<float>(1e-30))));
}

// The fast RNG (ops/rng.py): a lane's state is pcg(key ^ pixel *
// PIXEL_MUL) for the depth's key (IterationRng.depth_key), and draw j of a
// state is the top 24 bits of pcg(state + j * GOLDEN) times 2^-24
// (_pixel_mix, fast_uniforms_perlane), all in uint32 arithmetic.
constexpr unsigned GOLDEN = 0x9E3779B9u;     // ops/rng.py GOLDEN
constexpr unsigned PIXEL_MUL = 0xC2B2AE35u;  // ops/rng.py _pixel_mix
constexpr float UNIT = 1.0f / 16777216.0f;   // 2^-24

// ops/rng.py _pcg on a uint32 word
__device__ __forceinline__ unsigned pcg(unsigned x) {
  x = x * 747796405u + 2891336453u;
  x = ((x >> ((x >> 28) + 4u)) ^ x) * 277803737u;
  return (x >> 22) ^ x;
}

// The depth's key: read on the device where `key_dev` is set (a captured
// graph draws each replay's iteration), else the host's value.
__device__ __forceinline__ unsigned depth_key(const long long* key_dev,
                                              unsigned key_host) {
  return key_dev != nullptr ? static_cast<unsigned>(*key_dev) : key_host;
}

__device__ __forceinline__ unsigned pixel_state(unsigned key,
                                                long long pixel) {
  return pcg(key ^ (static_cast<unsigned>(pixel) * PIXEL_MUL));
}

__device__ __forceinline__ float hash_uniform(unsigned state, unsigned j) {
  return static_cast<float>(pcg(state + j * GOLDEN) >> 8) * UNIT;
}

// Blocks of `kernel` that the card holds at once (SMs x blocks an SM holds
// at `threads` threads and `smem` bytes of shared memory), the grid of a
// kernel whose blocks loop over the work. Cached per (kernel, device,
// shared-memory size): a table's size changes only with the scene.
inline cudaError_t resident_blocks(const void* kernel, int device,
                                   int threads, size_t smem, int& blocks) {
  struct Fit {
    const void* kernel = nullptr;
    int device = -1, blocks = 0;
    size_t smem = 0;
  };
  constexpr int SLOTS = 8;
  static thread_local Fit fits[SLOTS];
  static thread_local int next = 0;
  for (const Fit& f : fits) {
    if (f.kernel == kernel && f.device == device && f.smem == smem) {
      blocks = f.blocks;
      return cudaSuccess;
    }
  }
  int sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  blocks = sms * (per_sm > 0 ? per_sm : 1);
  fits[next] = Fit{kernel, device, blocks, smem};
  next = (next + 1) % SLOTS;
  return cudaSuccess;
}

}  // namespace pt
