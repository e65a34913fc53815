// Shared device helpers of the mesh-intersection kernels (cull.cu,
// stream.cu, packet.cu).
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

struct Best {
  float t;       // closest accepted t so far (starts at the lane's bound)
  float nx, ny, nz;  // raw interpolated normal of the winner
  int mat;
};

// Moller-Trumbore against one packed triangle record tv[0..19]
// (v0, e1, e2, n0, n1, n2, material_id): true on a valid hit in front of the
// origin, with its t and barycentrics u, v (a NaN t fails t >= 1e-6).
__device__ __forceinline__ bool tri_hit(const float* __restrict__ tv,
                                        float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float& t, float& u, float& v) {
  const float v0x = tv[0], v0y = tv[1], v0z = tv[2];
  const float e1x = tv[3], e1y = tv[4], e1z = tv[5];
  const float e2x = tv[6], e2y = tv[7], e2z = tv[8];
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

}  // namespace pt
