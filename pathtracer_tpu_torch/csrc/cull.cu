// Treelet cull: per ray, the nearest not-yet-enumerated wanted treelet.
//
// Replaces the TPU kernel `_cull_kernel` (pathtracer_tpu/ops/binned.py:290,
// launched at :839) with k_wants = 1. Per lane: among the treelets whose box
// the ray enters closer than `bound`, the smallest (entry_t, id) strictly
// after (pt0, pid); (TREELET_NONE, FLT_MAX) when there is none or the lane is
// not live.
//
// Design. One thread per ray; the lane's result does not depend on its
// neighbours, so the TPU kernel's block-wide gates (`live_any`, the super-row
// `sum(want_s) > 0`) become per-thread branches: a dead lane skips the sweep,
// and a super row whose union box the ray does not want skips its 16
// treelets. Gates only skip work, so (id, t0) per lane is unchanged (a
// treelet's slab interval lies inside its super box's in float arithmetic
// too, since (b - o) * inv is monotone in b).
//
// What bounds it on an H100: the slab tests, about 30 FP32 operations per
// (ray, treelet); the tables are small (teapot: 89 treelets, 6 super rows, a
// few KB), so every block stages them in shared memory once and the sweep
// reads no device memory beyond the ten ray planes (40 bytes a ray in, 8
// out). Staging beat reading the same tables through L1/L2 on every
// bounce-1 cull of the mesh scenes (teapot: 3% with 100k live lanes of 641k,
// 15% with 30k; H100 80GB HBM3 at 700 W). Tables larger than SMEM_MAX_ROWS
// rows do not fit and are read through the cache.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TREELETS_PER_FROW = 16;
constexpr int SMEM_MAX_ROWS = 80;  // 80 * (512 + 32) bytes < 48 KB

template <bool kSmem>
__global__ void __launch_bounds__(THREADS)
cull_kernel(const float* __restrict__ tre_f, const float* __restrict__ sup,
            int n_rows, const float* __restrict__ ox,
            const float* __restrict__ oy, const float* __restrict__ oz,
            const float* __restrict__ dx, const float* __restrict__ dy,
            const float* __restrict__ dz, const float* __restrict__ bound,
            const float* __restrict__ pt0, const int* __restrict__ pid,
            const int* __restrict__ live, int* __restrict__ out_id,
            float* __restrict__ out_t0, int n) {
  extern __shared__ float smem[];
  const float* tf = tre_f;  // record k of row r at tf[r * 128 + k * 8]
  const float* sf = sup;    // row r's union box at sf[r * sstride]
  int sstride = pt::ROW;
  if (kSmem) {
    float* s_tf = smem;
    float* s_sf = smem + n_rows * pt::ROW;
    for (int k = threadIdx.x; k < n_rows * pt::ROW; k += blockDim.x)
      s_tf[k] = tre_f[k];
    for (int k = threadIdx.x; k < n_rows * 8; k += blockDim.x)
      s_sf[k] = sup[(k / 8) * pt::ROW + (k % 8)];
    __syncthreads();
    tf = s_tf;
    sf = s_sf;
    sstride = 8;
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  float best_t0 = pt::FLT_MAX_F;
  int best_id = pt::TREELET_NONE;
  if (live[i] > 0) {
    const float o_x = ox[i], o_y = oy[i], o_z = oz[i];
    const float ix = 1.0f / dx[i], iy = 1.0f / dy[i], iz = 1.0f / dz[i];
    const float b = bound[i];
    const float p_t0 = pt0[i];
    const int p_id = pid[i];
    for (int r = 0; r < n_rows; ++r) {
      const float* s = sf + r * sstride;
      float s0, s1;
      pt::slab(s, s + 3, o_x, o_y, o_z, ix, iy, iz, s0, s1);
      if (!(s0 <= s1 && s1 > 0.0f && s0 < b)) continue;
      const float* row = tf + r * pt::ROW;
      for (int k = 0; k < TREELETS_PER_FROW; ++k) {
        const float* box = row + 8 * k;
        const int tid = r * TREELETS_PER_FROW + k;
        float t0, t1;
        pt::slab(box, box + 3, o_x, o_y, o_z, ix, iy, iz, t0, t1);
        const bool want = t0 <= t1 && t1 > 0.0f && t0 < b;
        const bool after = t0 > p_t0 || (t0 == p_t0 && tid > p_id);
        const bool closer =
            t0 < best_t0 || (t0 == best_t0 && tid < best_id);
        if (want && after && closer) {
          best_t0 = t0;
          best_id = tid;
        }
      }
    }
  }
  out_id[i] = best_id;
  out_t0[i] = best_t0;
}

}  // namespace

extern "C" int pt_cull(int device, const void* tre_f, const void* sup,
                       int n_rows, const void* ox, const void* oy,
                       const void* oz,
                       const void* dx, const void* dy, const void* dz,
                       const void* bound, const void* pt0, const void* pid,
                       const void* live, void* out_id, void* out_t0, int n,
                       void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS - 1) / THREADS;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto k = [](const void* p) { return static_cast<const int*>(p); };
  if (n_rows <= SMEM_MAX_ROWS) {
    const size_t smem = static_cast<size_t>(n_rows) * (pt::ROW + 8) *
                        sizeof(float);
    cull_kernel<true><<<blocks, THREADS, smem, s>>>(
        f(tre_f), f(sup), n_rows, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz),
        f(bound), f(pt0), k(pid), k(live), static_cast<int*>(out_id),
        static_cast<float*>(out_t0), n);
  } else {
    cull_kernel<false><<<blocks, THREADS, 0, s>>>(
        f(tre_f), f(sup), n_rows, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz),
        f(bound), f(pt0), k(pid), k(live), static_cast<int*>(out_id),
        static_cast<float*>(out_t0), n);
  }
  return static_cast<int>(cudaGetLastError());
}
