// Stackless BVH walk: the true closest hit under a per-ray bound.
//
// Replaces the TPU kernel `_packet_kernel` (pathtracer_tpu/ops/bvh_pallas.py:70,
// launched at :293 by mesh_intersect_packet), which the binned intersector
// runs as its exact fallback (pathtracer_tpu/ops/binned.py:1183). Per active
// lane: the closest Moller-Trumbore hit strictly below t_bound over the mesh
// rooted at `root`, normal normalized and faced toward the ray once at the
// end; inactive lanes report a miss.
//
// Design. The TPU kernel walks ONE scalar ENTER/ADVANCE state machine per
// 128-lane block and descends where ANY lane wants a node, so each lane pays
// the union of its block's walks. Here every thread runs the same stackless
// walk for its own ray over the parent / sibling links
// (bvh_pallas.py:168-218): ENTER(n) tests the node box against the lane's
// current best and, at a leaf, its triangle rows; a wanted interior node
// descends to n + 1; otherwise ADVANCE goes to the sibling of a left child,
// or up to the parent. The walk needs no stack, so a thread carries a dozen
// registers of state. Each node is entered and left at most once, so the
// loop is capped at 2 * n_nodes + 2 steps, which also bounds a malformed
// table.
//
// What bounds it on an H100: divergence and dependent loads. Each step is a
// dependent 32-byte node load (the teapot's 192 nodes stay in L1) plus a slab
// test; leaves add up to 96 triangle tests. In the binned pipeline only the
// few lanes with wants left after the last pass are active (the rest exit at
// once), and they arrive clustered by the last bin sort.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
packet_kernel(const float* __restrict__ nodes_f,
              const int* __restrict__ nodes_i, int n_nodes,
              const float* __restrict__ tris, int root,
              const float* __restrict__ ox, const float* __restrict__ oy,
              const float* __restrict__ oz, const float* __restrict__ dx,
              const float* __restrict__ dy, const float* __restrict__ dz,
              const int* __restrict__ act, const float* __restrict__ tb,
              float* __restrict__ t_out, float* __restrict__ nx_out,
              float* __restrict__ ny_out, float* __restrict__ nz_out,
              int* __restrict__ mat_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float d_x = dx[i], d_y = dy[i], d_z = dz[i];
  const float bound = tb[i];
  pt::Best best{bound, 0.0f, 0.0f, 0.0f, -1};
  if (act[i] > 0) {
    const float o_x = ox[i], o_y = oy[i], o_z = oz[i];
    const float ix = 1.0f / d_x, iy = 1.0f / d_y, iz = 1.0f / d_z;
    int node = root;
    bool enter = true;
    const int max_steps = 2 * n_nodes + 2;
    for (int step = 0; node >= 0 && node < n_nodes && step < max_steps;
         ++step) {
      const float* fv = nodes_f + 8 * node;  // 16 nodes x 8 fields a row
      const int* iv = nodes_i + 4 * node;    // 32 nodes x 4 fields a row
      const int tri_first = iv[0], tri_count = iv[1];
      const int sib = iv[2], par = iv[3];
      bool want = false;
      if (enter) {
        float t0, t1;
        pt::slab(fv, fv + 3, o_x, o_y, o_z, ix, iy, iz, t0, t1);
        want = t0 <= t1 && t1 > 0.0f && t0 < best.t;
      }
      const bool is_leaf = tri_count > 0;
      if (want && is_leaf) {
        const int row0 = tri_first / pt::TRIS_PER_ROW;
        const int n_rows =
            (tri_count + pt::TRIS_PER_ROW - 1) / pt::TRIS_PER_ROW;
        for (int r = 0; r < n_rows; ++r) {
          const float* row = tris + (row0 + r) * pt::ROW;
          for (int j = 0; j < pt::TRIS_PER_ROW; ++j)
            if (r * pt::TRIS_PER_ROW + j < tri_count)
              pt::tri_test(row + j * pt::TRI_STRIDE, o_x, o_y, o_z, d_x,
                           d_y, d_z, best);
        }
      }
      const bool descend = want && !is_leaf;
      node = descend ? node + 1 : (sib >= 0 ? sib : par);
      enter = descend || sib >= 0;
    }
  }
  pt::store_hit(best, bound, d_x, d_y, d_z, i, t_out, nx_out, ny_out, nz_out,
                mat_out);
}

}  // namespace

extern "C" int pt_packet(int device, const void* nodes_f, const void* nodes_i,
                         int n_nodes, const void* tris, int root,
                         const void* ox, const void* oy, const void* oz,
                         const void* dx, const void* dy, const void* dz,
                         const void* act, const void* tb, void* t_out,
                         void* nx_out, void* ny_out, void* nz_out,
                         void* mat_out, int n, void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS - 1) / THREADS;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  packet_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      f(nodes_f), static_cast<const int*>(nodes_i), n_nodes, f(tris), root,
      f(ox), f(oy), f(oz), f(dx), f(dy), f(dz), static_cast<const int*>(act),
      f(tb), static_cast<float*>(t_out), static_cast<float*>(nx_out),
      static_cast<float*>(ny_out), static_cast<float*>(nz_out),
      static_cast<int*>(mat_out), n);
  return static_cast<int>(cudaGetLastError());
}
