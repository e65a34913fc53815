// Brute-force mesh intersection: the first closest hit over every triangle
// of every mesh, in table order.
//
// Replaces the TPU kernel `_brute_kernel` (pathtracer_tpu/ops/bvh_pallas.py:
// 427, launched at :581 by mesh_intersect_brute), bvh_impl="brute". Moller-
// Trumbore is four linear forms of the ray's features F = [d, o, o x d, 1,
// 0 x 6] (scene/types.py pack_tris_mxu): a, u*a, v*a and t*a are 16-term
// dot products of F with the triangle's four coefficient rows. A hit is
// valid by the TPU kernel's sign-free tests (bvh_pallas.py:483-487) and has
// t = tn * (1/a); the ray keeps the FIRST triangle of smallest t (strict <
// in table order, which is the TPU kernel's smallest row index within a
// tile and strict improvement across tiles). The epilogue interpolates the
// winner's corner normals and faces the normal toward the ray
// (bvh_pallas.py:516-536); t = -1, mat = -1 on a miss.
//
// What bounds it on an H100: operations, issued one instruction each. The
// plain version (ops/brute.py brute_plain) sums all 16 terms of each form,
// but pack_tris_mxu fills only 19 of a triangle's 64 coefficients:
//   a: d (features 0-2); un, vn: d and o x d (0-2, 6-8); tn: o (3-5), 1 (9).
// This kernel reads those 19 from the compact table (scene/types.py
// pack_tris_brute, 20 floats a triangle) and sums only their terms, in
// feature order: 33 FP32 operations a pair where the dense forms take 124,
// then the validity test. Bit for bit the same, because:
//   - every other coefficient is +0 (pack_tris_brute checks it by its bits),
//     so with finite features each dropped term is a zero, which leaves a
//     non-zero partial sum as it is: the two sums differ at most in the sign
//     of an exact zero;
//   - the dense sum ends with (+0)*(+0), so its zero is +0; the winner's un
//     and vn get `+ 0.0f`, which turns a -0 into +0 and changes nothing else,
//     before u and v are formed. A zero a or tn fails the test either way
//     (a*a > eps^2, tn*a >= eps*a^2), and comparisons ignore a zero's sign;
//   - every feature 0-8 lies outside some form's terms, so when one is Inf or
//     NaN the dense forms are NaN (0 * Inf) for every triangle and the ray
//     misses: the kernel gives a ray with a non-finite feature the miss.
// Under -fmad=false each operation is its own instruction, so the floor for
// this arithmetic is twice the FP32 peak's time for its operations.
//
// Design. A block of THREADS threads answers THREADS * RAYS rays; each
// thread holds RAYS rays (its thread index + k * THREADS), so every
// coefficient read from shared memory feeds RAYS rays and a thread has
// 4 * RAYS independent sums in flight. The compact table streams through
// shared memory in chunks of CHUNK triangles (10 KB), double-buffered with
// cp.async: chunk c + 1 loads while chunk c is tested, one block barrier a
// chunk, and the 20 KB a block takes leave the 64 registers a thread as the
// limit on blocks an SM holds. Every thread of a warp reads the same
// triangle, a broadcast. After a and un, a warp whose rays all fail
// a*a > eps^2 or u*a >= 0 skips the rest of the pair (the skipped pairs are
// no hit either way). The thread's rays share one branch to the update. The
// sweep stops at n_tris, the last triangle whose `a` row is not all zero
// (the padding slots after it can never hold a valid hit).
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int RAYS = 2;      // rays a thread
constexpr int CHUNK = 128;   // triangles a staged chunk (divides TILE)
constexpr int TILE = 512;    // table padding unit (MXU_TRI_TILE)
constexpr int NFEAT = 16;    // attrs row width (MXU_NFEAT)
constexpr int ROW4 = 5;      // float4s a triangle in the compact table
constexpr float EPS = 1e-6f;
constexpr float EPS2 = 1e-12f;  // EPS * EPS

static_assert(TILE % CHUNK == 0, "whole chunks lie inside the padded table");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Start copying chunk c of the table into buffer `dst`.
__device__ __forceinline__ void stage(float4* dst,
                                      const float4* __restrict__ table,
                                      int c) {
  const float4* src = table + static_cast<size_t>(c) * CHUNK * ROW4;
  for (int k = threadIdx.x; k < CHUNK * ROW4; k += THREADS)
    cp_async16(dst + k, src + k);
}

__global__ void __launch_bounds__(THREADS)
brute_kernel(const float4* __restrict__ table, const float* __restrict__ attrs,
             int n_tris, const float* __restrict__ ox,
             const float* __restrict__ oy, const float* __restrict__ oz,
             const float* __restrict__ dx, const float* __restrict__ dy,
             const float* __restrict__ dz, float* __restrict__ t_out,
             float* __restrict__ nx_out, float* __restrict__ ny_out,
             float* __restrict__ nz_out, int* __restrict__ mat_out, int n) {
  __shared__ float4 buf[2][CHUNK * ROW4];
  // features 0-8 of each ray: d, o, o x d (feature 9 is 1, 10-15 are 0)
  float F[RAYS][9];
  float best_t[RAYS], best_u[RAYS], best_v[RAYS];
  int best_j[RAYS];
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int i = blockIdx.x * (THREADS * RAYS) + r * THREADS + threadIdx.x;
    const bool live = i < n;
    const float o_x = live ? ox[i] : 0.0f, o_y = live ? oy[i] : 0.0f;
    const float o_z = live ? oz[i] : 0.0f, d_x = live ? dx[i] : 1.0f;
    const float d_y = live ? dy[i] : 1.0f, d_z = live ? dz[i] : 1.0f;
    F[r][0] = d_x; F[r][1] = d_y; F[r][2] = d_z;
    F[r][3] = o_x; F[r][4] = o_y; F[r][5] = o_z;
    F[r][6] = o_y * d_z - o_z * d_y;
    F[r][7] = o_z * d_x - o_x * d_z;
    F[r][8] = o_x * d_y - o_y * d_x;
    best_t[r] = pt::FLT_MAX_F;
    best_u[r] = best_v[r] = 0.0f;
    best_j[r] = -1;
  }
  const int n_chunks = (n_tris + CHUNK - 1) / CHUNK;
  if (n_chunks > 0) stage(buf[0], table, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    // chunk c has landed for every thread, and every thread is done with
    // chunk c - 1, whose buffer takes chunk c + 1
    __syncthreads();
    if (c + 1 < n_chunks) stage(buf[(c + 1) & 1], table, c + 1);
    cp_async_commit();
    const float4* s = buf[c & 1];
    const int j0 = c * CHUNK;
    const int m = min(CHUNK, n_tris - j0);
#pragma unroll 4
    for (int jj = 0; jj < m; ++jj) {
      const float4* row = s + jj * ROW4;
      const float4 q0 = row[0], q1 = row[1], q2 = row[2], q3 = row[3];
      const float4 q4 = row[4];
      // the structural terms of each form, in feature order: a and un
      // first; a pair with a*a <= eps^2 or u*a < 0 is no hit, so when that
      // holds for every ray of the warp the rest is skipped (coherent rays,
      // such as a camera's, share the sign of u*a for most triangles)
      float a[RAYS], un[RAYS], vn[RAYS], tn[RAYS];
      bool maybe = false;
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        const float* f = F[r];
        a[r] = q0.x * f[0] + q0.y * f[1] + q0.z * f[2];
        un[r] = q0.w * f[0] + q1.x * f[1] + q1.y * f[2] + q1.z * f[6] +
                q1.w * f[7] + q2.x * f[8];
        maybe |= (a[r] * a[r] > EPS2) & (un[r] * a[r] >= 0.0f);
      }
      if (!__any_sync(pt::FULL, maybe)) continue;
      bool valid[RAYS], any = false;
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        const float* f = F[r];
        vn[r] = q2.y * f[0] + q2.z * f[1] + q2.w * f[2] + q3.x * f[6] +
                q3.y * f[7] + q3.z * f[8];
        tn[r] = q3.w * f[3] + q4.x * f[4] + q4.y * f[5] + q4.z;
        const float a2 = a[r] * a[r];
        const float ua = un[r] * a[r];
        const float va = vn[r] * a[r];
        valid[r] = (a2 > EPS2) & (ua >= 0.0f) & (va >= 0.0f) &
                   (ua + va <= a2) & (tn[r] * a[r] >= EPS * a2);
        any |= valid[r];
      }
      if (!any) continue;   // one branch for the thread's rays
#pragma unroll
      for (int r = 0; r < RAYS; ++r) {
        if (!valid[r]) continue;
        const float inv_a = 1.0f / a[r];
        const float t = tn[r] * inv_a;
        if (t < best_t[r]) {
          best_t[r] = t;
          best_j[r] = j0 + jj;
          best_u[r] = (un[r] + 0.0f) * inv_a;  // -0 -> +0, as the dense sum
          best_v[r] = (vn[r] + 0.0f) * inv_a;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RAYS; ++r) {
    const int i = blockIdx.x * (THREADS * RAYS) + r * THREADS + threadIdx.x;
    if (i >= n) continue;
    bool finite = true;
#pragma unroll
    for (int k = 0; k < 9; ++k) finite &= isfinite(F[r][k]);
    const bool hit = finite && best_t[r] < pt::FLT_MAX_F;
    float at[10];
#pragma unroll
    for (int c = 0; c < 10; ++c)
      at[c] = hit ? attrs[static_cast<size_t>(best_j[r]) * NFEAT + c] : 0.0f;
    const float u = hit ? best_u[r] : 0.0f, v = hit ? best_v[r] : 0.0f;
    const float w = 1.0f - u - v;
    const float nx = w * at[0] + u * at[3] + v * at[6];
    const float ny = w * at[1] + u * at[4] + v * at[7];
    const float nz = w * at[2] + u * at[5] + v * at[8];
    const float len2 = nx * nx + ny * ny + nz * nz;
    const float inv_len = 1.0f / sqrtf(pt::nan_max(len2, 1e-30f));
    const float fl =
        (F[r][0] * nx + F[r][1] * ny + F[r][2] * nz > 0.0f) ? -inv_len
                                                            : inv_len;
    t_out[i] = hit ? best_t[r] : -1.0f;
    nx_out[i] = nx * fl;
    ny_out[i] = ny * fl;
    nz_out[i] = nz * fl;
    mat_out[i] = hit ? static_cast<int>(at[9]) : -1;  // truncation, as astype
  }
}

}  // namespace

extern "C" int pt_brute(int device, const void* table, const void* attrs,
                        int n_tris, const void* ox, const void* oy,
                        const void* oz, const void* dx, const void* dy,
                        const void* dz, void* t_out, void* nx_out,
                        void* ny_out, void* nz_out, void* mat_out, int n,
                        void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS * RAYS - 1) / (THREADS * RAYS);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  brute_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(table), f(attrs), n_tris, f(ox), f(oy),
      f(oz), f(dx), f(dy), f(dz), o(t_out), o(nx_out), o(ny_out), o(nz_out),
      static_cast<int*>(mat_out), n);
  return static_cast<int>(cudaGetLastError());
}
