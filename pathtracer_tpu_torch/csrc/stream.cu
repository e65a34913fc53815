// Treelet stream: closest hit among the triangles of each lane's treelet.
//
// Replaces the TPU kernel `_stream_kernel` (pathtracer_tpu/ops/binned.py:446,
// launched at :868) in its default form (normals out, no chunk gate, every
// visit served). Per lane: the closest Moller-Trumbore hit strictly below
// `bound` among the triangle rows [row0, row0 + n_rows) of treelet `tid`
// (from treelet_i), with the raw interpolated normal normalized and faced
// toward the ray once at the end; a miss (t = -1, mat = -1) when nothing
// beats the bound or tid is TREELET_NONE.
//
// Design. One thread per ray, looping over its own treelet's rows only. The
// TPU kernel also tests every lane of a 16x128 block against the other ids
// binned into that block, an artefact of SIMD blocks: those rows can only
// add correct candidate hits, and the binned pipeline's final result is the
// true closest hit either way (the cull enumerates every wanted treelet and
// the packet walk finishes the rest). Rays arrive sorted by treelet id
// (ops/binned.py _seg_sort), so the 32 lanes of a warp mostly share a treelet:
// their row loads hit the same addresses and their loops have the same trip
// count.
//
// What bounds it on an H100: about 40 FP32 operations and one 80-byte
// triangle record per (ray, triangle), up to tre_rows * 6 = 96 triangles a
// ray. The triangle table is 560 KB for the teapot and stays in L2; warps
// whose lanes share a treelet read each record once per warp.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
stream_kernel(const int* __restrict__ tre_i, int n_treelets,
              const float* __restrict__ tris, int n_tri_rows, int max_rows,
              const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const float* __restrict__ bound, const int* __restrict__ tid,
              float* __restrict__ t_out, float* __restrict__ nx_out,
              float* __restrict__ ny_out, float* __restrict__ nz_out,
              int* __restrict__ mat_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float o_x = ox[i], o_y = oy[i], o_z = oz[i];
  const float d_x = dx[i], d_y = dy[i], d_z = dz[i];
  const float b = bound[i];
  pt::Best best{b, 0.0f, 0.0f, 0.0f, -1};
  const int g = tid[i];
  if (g >= 0 && g < n_treelets) {  // TREELET_NONE streams nothing
    const int row0 = tre_i[4 * g];
    const int n_rows = min(tre_i[4 * g + 1], max_rows);
    for (int r = 0; r < n_rows; ++r) {
      const float* row = tris + min(row0 + r, n_tri_rows - 1) * pt::ROW;
      for (int j = 0; j < pt::TRIS_PER_ROW; ++j)
        pt::tri_test(row + j * pt::TRI_STRIDE, o_x, o_y, o_z, d_x, d_y, d_z,
                     best);
    }
  }
  pt::store_hit(best, b, d_x, d_y, d_z, i, t_out, nx_out, ny_out, nz_out,
                mat_out);
}

}  // namespace

extern "C" int pt_stream(int device, const void* tre_i, int n_treelets,
                         const void* tris, int n_tri_rows, int max_rows,
                         const void* ox,
                         const void* oy, const void* oz, const void* dx,
                         const void* dy, const void* dz, const void* bound,
                         const void* tid, void* t_out, void* nx_out,
                         void* ny_out, void* nz_out, void* mat_out, int n,
                         void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS - 1) / THREADS;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  stream_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tre_i), n_treelets, f(tris), n_tri_rows,
      max_rows, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz), f(bound),
      static_cast<const int*>(tid), static_cast<float*>(t_out),
      static_cast<float*>(nx_out), static_cast<float*>(ny_out),
      static_cast<float*>(nz_out), static_cast<int*>(mat_out), n);
  return static_cast<int>(cudaGetLastError());
}
