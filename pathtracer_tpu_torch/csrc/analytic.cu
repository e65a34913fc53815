// The analytic closest hit: every box and sphere of the scene against every
// lane of the pool, the first smallest positive t in table order, and the
// winner's normal and material.
//
// Replaces the TPU kernel that XLA fused from the JAX package's analytic
// loop (pathtracer_tpu/ops/intersect.py intersect_scene, its loop over
// box_intersect and sphere_intersect): the JAX package has no Pallas kernel
// here, because XLA made one program of the loop. The port's plain version,
// ops/intersect.py analytic_plain, is about 185 small elementwise torch
// kernels a geom; this kernel is one launch a bounce.
//
// Bit for bit the plain version's outputs on every lane, dead lanes
// included: t_best (FLT_MAX where no box or sphere is hit), the normal's
// three planes (+0 there), the material id (0 there) and the hit flag.
//   - The same operations on the same values in the same order: mat4_apply's
//     m00*x + m01*y + m02*z + w*m03 (the w*m03 term kept for w = 0, where it
//     turns a -0 sum into +0), the box's 1e-20 direction clamp, its slab
//     parameters by IEEE division, the axis one-hot times the sign (so an
//     off-axis zero keeps its sign), the sphere's full quadratic with
//     t * (1 / a), and normalize's rsqrt(max(|v|^2, 1e-30)). The library is
//     built with -fmad=false and without fast math, so nothing is contracted
//     and division and sqrt are IEEE (common.cuh).
//   - torch.minimum / maximum / clamp propagate NaN, so do pt::nan_min /
//     nan_max here: a NaN slab parameter must not let the other one through.
//   - The merge is the plain version's: a geom wins where t > 0 and t <
//     t_best, strictly, in table order, so the first of equal t wins.
//   - The loop computes t alone. The normal is computed once, after it, for
//     the winner only, by the same operations on the same values, so it has
//     the bits the plain version computes for that geom.
//   - The constants are the plain version's Python doubles cast to float,
//     as torch casts a scalar operand to the tensor's float32.
//
// What bounds it on an H100: bytes. A lane reads its ray (6 floats, 24 B)
// and writes t, three normal planes, the material (int32) and the hit flag
// (one byte): 45 B a lane a bounce, 28.8 MB for 640,000 lanes, 8.6 us at
// 3.35 TB/s. The arithmetic is ~80 FP32 operations a geom and lane (two
// 3x4 transforms and the slab test or the quadratic), near that time for
// a scene of a few geoms; the slab test's six IEEE divisions are several
// instructions each. Design: one thread a lane, coalesced loads and stores
// of the planes, nothing else touching memory, no shared memory and no
// barrier. The geom tables (a few hundred bytes) are read by every thread
// of a warp at the same address, through the read-only path: one
// broadcast a warp from L1. The type test is uniform across the warp, so
// the loop does not diverge; only the winner's normal does, once a lane.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SPHERE = 0;  // scene/types.py SPHERE, CUBE, MESH
constexpr int MESH = 2;
// the plain version's Python constants as torch casts them to float32
constexpr float CLAMP = static_cast<float>(1e-20);
constexpr float RADIUS2 = 0.25f;  // radius * radius, radius = 0.5

using pt::normalize;
using pt::V3;

// (m @ [v, w]).xyz for a row-major 4x4 matrix, rows 0-2 (utils/vec.py
// mat4_apply).
__device__ __forceinline__ V3 apply(const float4* __restrict__ m, V3 v,
                                    float w) {
  const float4 r0 = __ldg(m), r1 = __ldg(m + 1), r2 = __ldg(m + 2);
  return {r0.x * v.x + r0.y * v.y + r0.z * v.z + w * r0.w,
          r1.x * v.x + r1.y * v.y + r1.z * v.z + w * r1.w,
          r2.x * v.x + r2.y * v.y + r2.z * v.z + w * r2.w};
}

// box_intersect on the object-space ray (qo, qd): t of the unit cube, -1 on
// a miss; with NORMAL, also the object-space normal of the face it gives
// (n_obj, unnormalized).
template <bool NORMAL>
__device__ __forceinline__ float box_t(V3 qo, V3 qd, V3* n_obj) {
  const float o[3] = {qo.x, qo.y, qo.z};
  const float d[3] = {qd.x, qd.y, qd.z};
  float tmin = -pt::FLT_MAX_F, tmax = pt::FLT_MAX_F;
  float nmin[3] = {0.0f, 0.0f, 0.0f}, nmax[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int axis = 0; axis < 3; ++axis) {
    float dc = d[axis];
    if (fabsf(dc) < CLAMP) dc = dc < 0.0f ? -CLAMP : CLAMP;
    const float t1 = (-0.5f - o[axis]) / dc;
    const float t2 = (0.5f - o[axis]) / dc;
    const float ta = pt::nan_min(t1, t2);
    const float tb = pt::nan_max(t1, t2);
    const bool upd_min = ta > 0.0f && ta > tmin;
    const bool upd_max = tb < tmax;
    tmin = upd_min ? ta : tmin;
    tmax = upd_max ? tb : tmax;
    if (NORMAL) {
      const float sgn = t2 < t1 ? 1.0f : -1.0f;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float n = sgn * (c == axis ? 1.0f : 0.0f);
        nmin[c] = upd_min ? n : nmin[c];
        nmax[c] = upd_max ? n : nmax[c];
      }
    }
  }
  const bool hit = tmax >= tmin && tmax > 0.0f;
  const bool inside = tmin <= 0.0f;
  if (NORMAL) {
    *n_obj = inside ? V3{nmax[0], nmax[1], nmax[2]}
                    : V3{nmin[0], nmin[1], nmin[2]};
  }
  return hit ? (inside ? tmax : tmin) : -1.0f;
}

// sphere_intersect on the object-space ray (ro, rd): t of the r = 0.5
// sphere, -1 on a miss; with NORMAL, also the world normal through the
// inverse transpose inv_t.
template <bool NORMAL>
__device__ __forceinline__ float sphere_t(V3 ro, V3 rd,
                                          const float4* __restrict__ inv_t,
                                          V3* normal) {
  const float a = rd.x * rd.x + rd.y * rd.y + rd.z * rd.z;
  const float b = ro.x * rd.x + ro.y * rd.y + ro.z * rd.z;
  const float c = ro.x * ro.x + ro.y * ro.y + ro.z * ro.z - RADIUS2;
  const float radicand = b * b - a * c;
  const bool has_root = radicand >= 0.0f;
  const float sq = sqrtf(has_root ? pt::nan_max(radicand, 0.0f) : 1.0f);
  const float inv_a = 1.0f / a;
  const float t1 = (-b + sq) * inv_a;
  const float t2 = (-b - sq) * inv_a;
  const bool both_neg = t1 < 0.0f && t2 < 0.0f;
  const bool both_pos = t1 > 0.0f && t2 > 0.0f;
  const float t = both_pos ? pt::nan_min(t1, t2) : pt::nan_max(t1, t2);
  const bool hit = has_root && !both_neg;
  if (NORMAL) {
    const V3 p{ro.x + rd.x * t, ro.y + rd.y * t, ro.z + rd.z * t};
    const V3 n = normalize(apply(inv_t, p, 0.0f));
    const float s = both_pos ? 1.0f : -1.0f;
    *normal = {n.x * s, n.y * s, n.z * s};
  }
  return hit ? t : -1.0f;
}

__global__ void __launch_bounds__(THREADS)
pt_analytic_hit(const int* __restrict__ gtype, const int* __restrict__ mat,
                const float4* __restrict__ inv,
                const float4* __restrict__ inv_t, int n_geoms,
                const float* __restrict__ ox, const float* __restrict__ oy,
                const float* __restrict__ oz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                float* __restrict__ t_out, float* __restrict__ nx_out,
                float* __restrict__ ny_out, float* __restrict__ nz_out,
                int* __restrict__ mat_out, bool* __restrict__ hit_out,
                int n) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const V3 o{ox[i], oy[i], oz[i]};
  const V3 d{dx[i], dy[i], dz[i]};
  float t_best = pt::FLT_MAX_F;
  int best = -1;
  for (int g = 0; g < n_geoms; ++g) {
    const int type = __ldg(gtype + g);
    if (type == MESH) continue;
    const float4* m = inv + 4 * g;
    const V3 qo = apply(m, o, 1.0f);
    const V3 qd = apply(m, d, 0.0f);
    const float t = type == SPHERE ? sphere_t<false>(qo, qd, nullptr, nullptr)
                                   : box_t<false>(qo, qd, nullptr);
    if (t > 0.0f && t < t_best) {
      t_best = t;
      best = g;
    }
  }
  V3 nrm{0.0f, 0.0f, 0.0f};
  int m_best = 0;
  if (best >= 0) {
    const float4* m = inv + 4 * best;
    const float4* mt = inv_t + 4 * best;
    const V3 qo = apply(m, o, 1.0f);
    const V3 qd = apply(m, d, 0.0f);
    if (__ldg(gtype + best) == SPHERE) {
      sphere_t<true>(qo, qd, mt, &nrm);
    } else {
      V3 n_obj;
      box_t<true>(qo, qd, &n_obj);
      nrm = normalize(apply(mt, n_obj, 0.0f));
    }
    m_best = __ldg(mat + best);
  }
  t_out[i] = t_best;
  nx_out[i] = nrm.x;
  ny_out[i] = nrm.y;
  nz_out[i] = nrm.z;
  mat_out[i] = m_best;
  hit_out[i] = best >= 0;
}

}  // namespace

extern "C" int pt_analytic(int device, const void* gtype, const void* mat,
                           const void* inv, const void* inv_t, int n_geoms,
                           const void* ox, const void* oy, const void* oz,
                           const void* dx, const void* dy, const void* dz,
                           void* t_out, void* nx_out, void* ny_out,
                           void* nz_out, void* mat_out, void* hit_out, int n,
                           void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS - 1) / THREADS;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  pt_analytic_hit<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gtype), static_cast<const int*>(mat),
      static_cast<const float4*>(inv), static_cast<const float4*>(inv_t),
      n_geoms, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz), o(t_out),
      o(nx_out), o(ny_out), o(nz_out), static_cast<int*>(mat_out),
      static_cast<bool*>(hit_out), n);
  return static_cast<int>(cudaGetLastError());
}
