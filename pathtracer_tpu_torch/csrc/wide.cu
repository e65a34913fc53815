// 8-wide BVH walk, one ray per thread: the true closest hit under a
// per-ray bound over every mesh of the scene.
//
// Replaces the TPU kernels `_wide_kernel` (pathtracer_tpu/ops/wide.py:177,
// entry point pt_wide_push) and `_wide_kernel_mask` (wide.py:319, entry
// point pt_wide_mask), launched by mesh_intersect_wide (wide.py:461) for
// bvh_impl "wide" / "wide_nosort" and the binned intersector's wide
// fallback. Per active lane: the closest Moller-Trumbore hit strictly below
// t_bound over the wide forest (scene/bvh8.py), normal normalized and faced
// toward the ray; t = -1, mat = -1 and a zero normal on a miss and on
// inactive lanes (the TPU kernel starts them at t_min = -FLT_MAX).
//
// Design. The TPU kernels keep ONE stack per 128-ray packet in SMEM and test
// a popped node's 8 children against the whole packet as one (8, 128) tile;
// the packet, the tiles and the lane rolls are TPU artefacts. Here each
// thread walks its own ray with its own stack in local memory:
//   push: one entry (node or leaf code, entry t) per wanted child, pushed
//         far to near along the node's sort axis by the sign of the ray's
//         own direction, so the nearest child is popped first. 148 entries
//         (7 * MAX_DEPTH + 8) bound it for a tree of depth <= MAX_DEPTH,
//         which the loader asserts; `cull` skips a popped entry whose
//         entry t is at or beyond the ray's closest hit so far.
//   mask: one packed int per node on the DFS path (bits 0..7 the wanted
//         children not yet taken, 8..29 the node, 30 the direction bit);
//         each step takes the nearest remaining child. MAX_DEPTH + 1
//         entries. It visits exactly what push visits, in the same order.
// A leaf's 8-triangle groups are tested in order with strict t < t_min,
// as the TPU kernel's `_mt_group8` does with its first-minimum selection.
// Empty child slots hold NaN boxes: the slab test uses the NaN-propagating
// min/max of common.cuh (fminf/fmaxf would drop the NaN) and the walk also
// skips kind == 0 slots.
//
// What bounds it on an H100: dependent loads and divergence, not FLOPs or
// bytes. Each step is a dependent read of one node's 8 child records
// (2 x 8 x 32 bytes; the teapot's 180 wide nodes stay in L1) and 8 slab
// tests; a leaf adds 8 or 16 triangle tests. Threads of a warp walk
// different paths, so a warp runs the union of its lanes' steps; the
// coherence sort of bvh_impl "wide" puts rays of one direction octant side
// by side to shrink that union.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int MAX_DEPTH = 20;                 // scene/bvh8.py MAX_DEPTH
constexpr int STACK = 7 * MAX_DEPTH + 8;      // push stack
constexpr int MASK_STACK = MAX_DEPTH + 1;     // mask stack
constexpr int LEAF_TAG = 1 << 30;             // push leaf code: TAG + g*4 + n
constexpr int MAX_WIDE_GROUPS = 2;            // 8-tri groups per leaf
constexpr int NODES_PER_BLOCK = 16;           // wide nodes per (8, 128) block
constexpr int GROUPS_PER_BLOCK = 6;           // tri groups per (8, 128) block
constexpr int KIND_LEAF = 2;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// Child slot c of wide node j: its 8 f32 box fields and 4 i32 record fields
// (kind, a, b, axis) in the packed (8, 128) blocks (scene/types.py
// pack_wide_tables).
__device__ __forceinline__ int child_offset(int node, int c) {
  return ((node / NODES_PER_BLOCK) * 8 + c) * pt::ROW +
         (node % NODES_PER_BLOCK) * 8;
}

// Slab-test node `node`'s 8 children: bit c of the result is set where slot
// c is not empty and the ray enters its box closer than t_min; t0s[c] gets
// the entry t. `near_first` is set when ascending slots run near to far.
__device__ __forceinline__ unsigned slab8(const float* __restrict__ nodes_f,
                                          const int* __restrict__ nodes_i,
                                          int node, const Ray& r,
                                          float t_min, float* t0s,
                                          bool& near_first) {
  const int axis = nodes_i[child_offset(node, 0) + 3];
  near_first = (axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz)) >= 0.0f;
  unsigned bits = 0;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int off = child_offset(node, c);
    float t0, t1;
    pt::slab(nodes_f + off, nodes_f + off + 3, r.ox, r.oy, r.oz, r.ix, r.iy,
             r.iz, t0, t1);
    t0s[c] = t0;
    if (nodes_i[off] != 0 && t0 <= t1 && t1 > 0.0f && t0 < t_min)
      bits |= 1u << c;
  }
  return bits;
}

// Moller-Trumbore against the 8-triangle groups g0 .. g0 + max(ng, 1) - 1.
__device__ __forceinline__ void leaf(const float* __restrict__ tris8,
                                     int n_groups, int g0, int ng,
                                     const Ray& r, pt::Best& best) {
  for (int g = 0; g < MAX_WIDE_GROUPS; ++g) {
    if (g > 0 && g >= ng) break;
    const int gi = g0 + g;
    if (gi < 0 || gi >= n_groups) continue;
    const float* base = tris8 + (gi / GROUPS_PER_BLOCK) * 8 * pt::ROW +
                        (gi % GROUPS_PER_BLOCK) * pt::TRI_STRIDE;
#pragma unroll 2
    for (int k = 0; k < 8; ++k)
      pt::tri_test(base + k * pt::ROW, r.ox, r.oy, r.oz, r.dx, r.dy, r.dz,
                   best);
  }
}

// The epilogue: t = -1 where no triangle was hit, the winner's normal
// normalized and faced toward the ray (a zero normal on a miss).
__device__ __forceinline__ void store(const pt::Best& b, const Ray& r, int i,
                                      float* t_out, float* nx_out,
                                      float* ny_out, float* nz_out,
                                      int* mat_out) {
  const float len2 = b.nx * b.nx + b.ny * b.ny + b.nz * b.nz;
  const float inv_len = 1.0f / sqrtf(pt::nan_max(len2, 1e-30f));
  const float fl =
      (r.dx * b.nx + r.dy * b.ny + r.dz * b.nz > 0.0f) ? -inv_len : inv_len;
  t_out[i] = b.mat < 0 ? -1.0f : b.t;
  nx_out[i] = b.nx * fl;
  ny_out[i] = b.ny * fl;
  nz_out[i] = b.nz * fl;
  mat_out[i] = b.mat;
}

__device__ __forceinline__ Ray load_ray(const float* ox, const float* oy,
                                        const float* oz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.ix = 1.0f / r.dx; r.iy = 1.0f / r.dy; r.iz = 1.0f / r.dz;
  return r;
}

__global__ void __launch_bounds__(THREADS)
wide_push_kernel(const float* __restrict__ nodes_f,
                 const int* __restrict__ nodes_i, int n_wide,
                 const float* __restrict__ tris8, int n_groups,
                 const int* __restrict__ root_p,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const int* __restrict__ act, const float* __restrict__ tb,
                 int cull, float* __restrict__ t_out,
                 float* __restrict__ nx_out, float* __restrict__ ny_out,
                 float* __restrict__ nz_out, int* __restrict__ mat_out,
                 int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const bool active = act[i] > 0;
  pt::Best best{active ? tb[i] : -pt::FLT_MAX_F, 0.0f, 0.0f, 0.0f, -1};
  const int root = *root_p;
  if (active && root >= 0 && root < n_wide) {
    int stack_e[STACK];
    float stack_t[STACK];
    stack_e[0] = root;
    stack_t[0] = -pt::FLT_MAX_F;
    int sp = 1;
    const int max_steps = 8 * n_wide + 1;
    for (int step = 0; sp > 0 && step < max_steps; ++step) {
      --sp;
      const int e = stack_e[sp];
      if (cull && !(stack_t[sp] < best.t)) continue;
      if (e >= LEAF_TAG) {
        const int code = e - LEAF_TAG;
        leaf(tris8, n_groups, code / 4, code % 4, r, best);
        continue;
      }
      if (e < 0 || e >= n_wide) continue;
      float t0s[8];
      bool near_first;
      const unsigned bits =
          slab8(nodes_f, nodes_i, e, r, best.t, t0s, near_first);
      // far to near, so the nearest wanted child ends on top
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int c = near_first ? 7 - k : k;
        if (!((bits >> c) & 1u) || sp >= STACK) continue;
        const int* rec = nodes_i + child_offset(e, c);
        stack_e[sp] = rec[0] == KIND_LEAF ? LEAF_TAG + rec[1] * 4 + rec[2]
                                          : rec[1];
        stack_t[sp] = t0s[c];
        ++sp;
      }
    }
  }
  store(best, r, i, t_out, nx_out, ny_out, nz_out, mat_out);
}

__global__ void __launch_bounds__(THREADS)
wide_mask_kernel(const float* __restrict__ nodes_f,
                 const int* __restrict__ nodes_i, int n_wide,
                 const float* __restrict__ tris8, int n_groups,
                 const int* __restrict__ root_p,
                 const float* __restrict__ ox, const float* __restrict__ oy,
                 const float* __restrict__ oz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const int* __restrict__ act, const float* __restrict__ tb,
                 float* __restrict__ t_out, float* __restrict__ nx_out,
                 float* __restrict__ ny_out, float* __restrict__ nz_out,
                 int* __restrict__ mat_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = load_ray(ox, oy, oz, dx, dy, dz, i);
  const bool active = act[i] > 0;
  pt::Best best{active ? tb[i] : -pt::FLT_MAX_F, 0.0f, 0.0f, 0.0f, -1};
  const int root = *root_p;
  if (active && root >= 0 && root < n_wide) {
    int stack[MASK_STACK];
    int sp = 0;
    float t0s[8];
    bool near_first;
    unsigned bits = slab8(nodes_f, nodes_i, root, r, best.t, t0s, near_first);
    if (bits) stack[sp++] = (root << 8) | bits | (int(near_first) << 30);
    const int max_steps = 8 * n_wide + 1;
    for (int step = 0; sp > 0 && step < max_steps; ++step) {
      const int e = stack[sp - 1];
      const unsigned mask = e & 0xFF;
      const int parent = (e >> 8) & 0x3FFFFF;
      // nearest remaining child: the lowest set bit when ascending slots run
      // near to far, else the highest
      const int c = ((e >> 30) & 1) ? __ffs(mask) - 1 : 31 - __clz(mask);
      const unsigned rest = mask & ~(1u << c);
      stack[sp - 1] = (e & ~0xFF) | static_cast<int>(rest);
      if (!rest) --sp;
      const int* rec = nodes_i + child_offset(parent, c);
      const int a = rec[1];
      if (rec[0] == KIND_LEAF) {
        leaf(tris8, n_groups, a, rec[2], r, best);
        continue;
      }
      if (a < 0 || a >= n_wide) continue;
      bits = slab8(nodes_f, nodes_i, a, r, best.t, t0s, near_first);
      if (bits && sp < MASK_STACK)
        stack[sp++] = (a << 8) | bits | (int(near_first) << 30);
    }
  }
  store(best, r, i, t_out, nx_out, ny_out, nz_out, mat_out);
}

inline const float* cf(const void* p) { return static_cast<const float*>(p); }
inline const int* ci(const void* p) { return static_cast<const int*>(p); }
inline float* of(void* p) { return static_cast<float*>(p); }

}  // namespace

extern "C" int pt_wide_push(int device, const void* nodes_f,
                            const void* nodes_i, int n_wide, const void* tris8,
                            int n_groups, const void* root, const void* ox,
                            const void* oy, const void* oz, const void* dx,
                            const void* dy, const void* dz, const void* act,
                            const void* tb, int cull, void* t_out,
                            void* nx_out, void* ny_out, void* nz_out,
                            void* mat_out, int n, void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS - 1) / THREADS;
  wide_push_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      cf(nodes_f), ci(nodes_i), n_wide, cf(tris8), n_groups, ci(root),
      cf(ox), cf(oy), cf(oz), cf(dx), cf(dy), cf(dz), ci(act), cf(tb), cull,
      of(t_out), of(nx_out), of(ny_out), of(nz_out),
      static_cast<int*>(mat_out), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pt_wide_mask(int device, const void* nodes_f,
                            const void* nodes_i, int n_wide, const void* tris8,
                            int n_groups, const void* root, const void* ox,
                            const void* oy, const void* oz, const void* dx,
                            const void* dy, const void* dz, const void* act,
                            const void* tb, void* t_out, void* nx_out,
                            void* ny_out, void* nz_out, void* mat_out, int n,
                            void* stream) {
  if (n <= 0) return 0;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (n + THREADS - 1) / THREADS;
  wide_mask_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      cf(nodes_f), ci(nodes_i), n_wide, cf(tris8), n_groups, ci(root),
      cf(ox), cf(oy), cf(oz), cf(dx), cf(dy), cf(dz), ci(act), cf(tb),
      of(t_out), of(nx_out), of(ny_out), of(nz_out),
      static_cast<int*>(mat_out), n);
  return static_cast<int>(cudaGetLastError());
}
