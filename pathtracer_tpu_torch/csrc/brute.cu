// Brute-force mesh intersection, one ray per thread: the first closest hit
// over every triangle of every mesh, in table order.
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
// Design. On the TPU the forms of 512 triangles x 128 rays were one
// [2048, 16] @ [16, 128] matrix product and the winner's attributes came
// back through a one-hot product. Here the dot products are summed term by
// term in FP32 on the CUDA cores (no tensor-core product: TF32 would change
// the numbers), in feature order, as the plain version sums them. A block of
// 128 rays stages the coefficient rows of 32 triangles at a time in shared
// memory; every thread of a warp reads the same row, a broadcast.
//
// What bounds it on an H100: operations. Each (ray, triangle) pair costs
// the four 16-term forms (128 FLOPs, multiplies and adds unfused under
// -fmad=false) plus the validity tests, against 256 bytes of coefficients
// that every ray of the block shares; so the FP32 rate bounds it, and the
// shared-memory reads feeding it come next.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 512;    // triangles per coefficient tile (MXU_TRI_TILE)
constexpr int NFEAT = 16;    // features per ray (MXU_NFEAT)
constexpr int CHUNK = 32;    // triangles staged in shared memory at a time
constexpr float EPS = 1e-6f;
constexpr float EPS2 = 1e-12f;  // EPS * EPS

static_assert(TILE % CHUNK == 0, "a staged chunk lies within one tile");

__global__ void __launch_bounds__(THREADS)
brute_kernel(const float* __restrict__ coeffs, const float* __restrict__ attrs,
             int n_tris, const float* __restrict__ ox,
             const float* __restrict__ oy, const float* __restrict__ oz,
             const float* __restrict__ dx, const float* __restrict__ dy,
             const float* __restrict__ dz, float* __restrict__ t_out,
             float* __restrict__ nx_out, float* __restrict__ ny_out,
             float* __restrict__ nz_out, int* __restrict__ mat_out, int n) {
  // [form a/un/vn/tn][triangle of the chunk][feature]
  __shared__ float4 stage[4 * CHUNK * NFEAT / 4];
  const float* sc = reinterpret_cast<const float*>(stage);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float F[NFEAT];
  {
    const float o_x = live ? ox[i] : 0.0f, o_y = live ? oy[i] : 0.0f;
    const float o_z = live ? oz[i] : 0.0f, d_x = live ? dx[i] : 1.0f;
    const float d_y = live ? dy[i] : 1.0f, d_z = live ? dz[i] : 1.0f;
    F[0] = d_x; F[1] = d_y; F[2] = d_z;
    F[3] = o_x; F[4] = o_y; F[5] = o_z;
    F[6] = o_y * d_z - o_z * d_y;
    F[7] = o_z * d_x - o_x * d_z;
    F[8] = o_x * d_y - o_y * d_x;
    F[9] = 1.0f;
#pragma unroll
    for (int f = 10; f < NFEAT; ++f) F[f] = 0.0f;
  }
  float best_t = pt::FLT_MAX_F, best_u = 0.0f, best_v = 0.0f;
  int best_j = -1;
  constexpr int FORM4 = CHUNK * NFEAT / 4;   // float4s per form and chunk
  for (int j0 = 0; j0 < n_tris; j0 += CHUNK) {
    __syncthreads();
    const int tile = j0 / TILE, r0 = j0 % TILE;
    for (int idx = threadIdx.x; idx < 4 * FORM4; idx += THREADS) {
      const int q = idx / FORM4;
      const float4* src = reinterpret_cast<const float4*>(
          coeffs + (static_cast<size_t>(tile * 4 + q) * TILE + r0) * NFEAT);
      stage[idx] = src[idx % FORM4];
    }
    __syncthreads();
    if (!live) continue;
    for (int jj = 0; jj < CHUNK; ++jj) {
      float form[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* row = sc + (q * CHUNK + jj) * NFEAT;
        float acc = row[0] * F[0];
#pragma unroll
        for (int f = 1; f < NFEAT; ++f) acc = acc + row[f] * F[f];
        form[q] = acc;
      }
      const float a = form[0], un = form[1], vn = form[2], tn = form[3];
      const float a2 = a * a;
      const float ua = un * a;
      const float va = vn * a;
      const bool valid = a2 > EPS2 && ua >= 0.0f && va >= 0.0f &&
                         ua + va <= a2 && tn * a >= EPS * a2;
      if (valid) {
        const float inv_a = 1.0f / a;
        const float t = tn * inv_a;
        if (t < best_t) {
          best_t = t;
          best_j = j0 + jj;
          best_u = un * inv_a;
          best_v = vn * inv_a;
        }
      }
    }
  }
  if (!live) return;
  const bool hit = best_t < pt::FLT_MAX_F;
  float at[10];
#pragma unroll
  for (int c = 0; c < 10; ++c)
    at[c] = hit ? attrs[static_cast<size_t>(best_j) * NFEAT + c] : 0.0f;
  const float u = hit ? best_u : 0.0f, v = hit ? best_v : 0.0f;
  const float w = 1.0f - u - v;
  const float nx = w * at[0] + u * at[3] + v * at[6];
  const float ny = w * at[1] + u * at[4] + v * at[7];
  const float nz = w * at[2] + u * at[5] + v * at[8];
  const float len2 = nx * nx + ny * ny + nz * nz;
  const float inv_len = 1.0f / sqrtf(pt::nan_max(len2, 1e-30f));
  const float fl = (F[0] * nx + F[1] * ny + F[2] * nz > 0.0f) ? -inv_len
                                                                : inv_len;
  t_out[i] = hit ? best_t : -1.0f;
  nx_out[i] = nx * fl;
  ny_out[i] = ny * fl;
  nz_out[i] = nz * fl;
  mat_out[i] = hit ? static_cast<int>(at[9]) : -1;  // truncation, as astype
}

}  // namespace

extern "C" int pt_brute(int device, const void* coeffs, const void* attrs,
                        int n_tris, const void* ox, const void* oy,
                        const void* oz, const void* dx, const void* dy,
                        const void* dz, void* t_out, void* nx_out,
                        void* ny_out, void* nz_out, void* mat_out, int n,
                        void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS - 1) / THREADS;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  brute_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      f(coeffs), f(attrs), n_tris, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz),
      o(t_out), o(nx_out), o(ny_out), o(nz_out), static_cast<int*>(mat_out),
      n);
  return static_cast<int>(cudaGetLastError());
}
