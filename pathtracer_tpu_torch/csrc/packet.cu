// Stackless BVH walk: the true closest hit under a per-ray bound.
//
// Replaces the TPU kernel `_packet_kernel` (pathtracer_tpu/ops/bvh_pallas.py:70,
// launched at :293 by mesh_intersect_packet), which the binned intersector
// runs as its exact fallback (pathtracer_tpu/ops/binned.py:1183). Per active
// lane: the closest Moller-Trumbore hit strictly below t_bound over the mesh
// rooted at `root`, normal normalized and faced toward the ray once at the
// end; inactive lanes report a miss.
//
// The walk. The TPU kernel walks ONE scalar ENTER/ADVANCE state machine per
// 128-lane block and descends where ANY lane wants a node. Here every thread
// walks its own ray over the parent / sibling links (bvh_pallas.py:168-218):
// ENTER(n) tests the node box against the lane's current best and, at a
// leaf, its triangles; a wanted interior node descends to n + 1; otherwise
// ADVANCE goes to the sibling of a left child, or up to the parent. That
// order (left child first) decides which of two triangles at exactly equal t
// in different leaves wins, so it is kept as it is. Each node is entered and
// left at most once, so a walk is capped at 2 * n_nodes + 2 steps, which
// also bounds a malformed table.
//
// What bounds it on an H100: latency, not bytes or operations. On the main
// path (teapot, bvh_impl "binned") the walk is the fallback for the ~1.3% of
// a 641,024-lane pool whose wants the binned passes left; each such ray
// makes ~28 box tests and ~250 triangle tests, in leaves of 66-96
// triangles, one after another. The design this one replaces ran one thread
// per pool lane: nearly every warp held one active lane, which tested its
// leaves' triangles one at a time, each a chain of scattered loads from a
// 560 KB table; the slowest rays of 2.4 waves of blocks set its 0.68-0.73
// ms, ~150x the 0.0048 ms its bytes need (H100 80GB HBM3 at 700 W). So the
// time is the longest dependent chain of node steps and leaf rounds, and
// the design shortens that chain and runs the chains side by side.
//
// The design:
//   1. packet_kernel_compact, over the pool: an inactive lane writes its
//      miss (as the walk would for a lane it never enters); the active lanes
//      of each warp append their indices to a device list with one ballot
//      and one atomicAdd. The list's order does not matter: every lane
//      writes only its own outputs. No host synchronization.
//   2. packet_kernel_walk, persistent: each warp fetches list entries by
//      atomicAdd (Aila & Laine, HPG 2009) until the list is done, so a warp
//      that finishes early takes more work. A warp takes `per` rays at a
//      time: the list's length (read on the device) over the grid's warps,
//      at most 32. A full pool keeps 32 rays a warp; the fallback's short
//      list leaves two or three a warp, so its rays walk side by side on
//      every SM, not 32 to a warp in a few hundred warps. (One ray a fetch,
//      several fetches a warp, was slower: a warp's rays share its node
//      steps but queue for its leaf tests, and the node steps weigh more.)
//      Blocks with no work exit before they stage anything. The node table
//      (teapot: 192 nodes, 9 KB) is staged in shared memory when it holds
//      at most `smem_nodes` nodes, and read through L1/L2 otherwise.
//   3. One ray a thread for the walk, with a short step: the box test
//      (`enters`) tests NaN once and then uses plain fminf / fmaxf, which
//      took a quarter off the fallback walk (H100 80GB HBM3 at 700 W): the
//      node steps, not the leaves, are most of a ray's chain.
//   4. Leaves, warp-cooperative. When lanes of a warp want leaves in the same
//      step, the warp takes them one at a time, broadcasts that ray by
//      shuffles, and its 32 lanes test 32 adjacent triangles of the leaf at
//      once (3 rounds for a 96-triangle leaf, 9 for 288). The winner is the
//      arg-min of (t, triangle index) over the warp among hits strictly
//      below the ray's best, found by two warp reductions (redux.sync) on
//      the bits of t and on the index: exactly what the serial strict-`<`
//      loop keeps (closest_hit in ops/bvh_packet.py states the same rule),
//      and its normal and material come from the same operations (common.cuh
//      take_hit), so the bits are the serial loop's. A per-lane serial leaf
//      loop over the same compacted list was several times slower on the
//      fallback and on the all-live pool alike, so every leaf is tested
//      this way.
// Every shuffle and ballot runs on all 32 lanes: a lane whose walk has ended
// stays in the warp's loop, without work, until the warp's last walk ends.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_HIT = 0xffffffffu;  // above every positive float's bits

// One lane's ray and best hit.
struct Lane {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, bound;
  pt::Best best;
};

__device__ __forceinline__ const float* tri_record(const float* tris,
                                                   int first, int k) {
  // leaves start on a row boundary (scene/bvh.py align_leaves)
  return tris + (first / pt::TRIS_PER_ROW + k / pt::TRIS_PER_ROW) * pt::ROW +
         (k % pt::TRIS_PER_ROW) * pt::TRI_STRIDE;
}

// The walk's box test: does the ray enter box (lo, hi) closer than `best`?
// The answer of common.cuh slab's (t0 <= t1 && t1 > 0 && t0 < best) with
// fewer instructions on the walk's critical path: a NaN slab parameter
// makes slab's t0 or t1 NaN and the answer false, so NaNs are tested once
// and the rest is plain fminf / fmaxf (which differ from nan_min / nan_max
// only on NaN and in the sign of a zero, which no comparison here sees).
__device__ __forceinline__ bool enters(const float* lo, const float* hi,
                                       const Lane& r) {
  const float tnx = (lo[0] - r.ox) * r.ix;
  const float tfx = (hi[0] - r.ox) * r.ix;
  const float tny = (lo[1] - r.oy) * r.iy;
  const float tfy = (hi[1] - r.oy) * r.iy;
  const float tnz = (lo[2] - r.oz) * r.iz;
  const float tfz = (hi[2] - r.oz) * r.iz;
  const bool nan = tnx != tnx || tfx != tfx || tny != tny || tfy != tfy ||
                   tnz != tnz || tfz != tfz;
  const float t0 = fmaxf(fmaxf(fminf(tnx, tfx), fminf(tny, tfy)),
                         fminf(tnz, tfz));
  const float t1 = fminf(fminf(fmaxf(tnx, tfx), fmaxf(tny, tfy)),
                         fmaxf(tnz, tfz));
  return !nan && t0 <= t1 && t1 > 0.0f && t0 < r.best.t;
}

// The leaves that the lanes in `mask` want this step, one after another,
// each tested by the whole warp: `first` / `count` are each lane's leaf.
__device__ __forceinline__ void leaf_tests(unsigned mask, int first,
                                           int count,
                                           const float* __restrict__ tris,
                                           Lane& r) {
  const int lane = threadIdx.x & 31;
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float ox = __shfl_sync(FULL, r.ox, src);
    const float oy = __shfl_sync(FULL, r.oy, src);
    const float oz = __shfl_sync(FULL, r.oz, src);
    const float dx = __shfl_sync(FULL, r.dx, src);
    const float dy = __shfl_sync(FULL, r.dy, src);
    const float dz = __shfl_sync(FULL, r.dz, src);
    const float bt = __shfl_sync(FULL, r.best.t, src);
    const int f = __shfl_sync(FULL, first, src);
    const int c = __shfl_sync(FULL, count, src);
    // this lane's triangles k = lane, lane + 32, ...: the first of its
    // smallest t strictly below the ray's best
    float ct = bt, cu = 0.0f, cv = 0.0f;
    int ck = -1;
    for (int k = lane; k < c; k += 32) {
      float t, u, v;
      if (pt::tri_hit(tri_record(tris, f, k), ox, oy, oz, dx, dy, dz, t, u,
                      v) && t < ct) {
        ct = t;
        cu = u;
        cv = v;
        ck = k;
      }
    }
    // arg-min of (t, k) over the warp by two integer reductions: a hit's t
    // is positive, so its bits order as the floats do, and NO_HIT is above
    // them all; then the least k among the lanes at that t. Lane k % 32
    // tested triangle k and hands over its barycentrics.
    const unsigned t_bits = ck >= 0 ? __float_as_uint(ct) : NO_HIT;
    const unsigned t_min = __reduce_min_sync(FULL, t_bits);
    if (t_min == NO_HIT) continue;
    const unsigned k_min =
        __reduce_min_sync(FULL, t_bits == t_min ? ck : NO_HIT);
    const float wu = __shfl_sync(FULL, cu, k_min % 32);
    const float wv = __shfl_sync(FULL, cv, k_min % 32);
    if (lane == src)
      pt::take_hit(tri_record(tris, f, k_min), __uint_as_float(t_min), wu, wv,
                   r.best);
  }
}

__global__ void __launch_bounds__(THREADS)
packet_kernel_compact(const int* __restrict__ act,
                      const float* __restrict__ dx,
                      const float* __restrict__ dy,
                      const float* __restrict__ dz,
                      const float* __restrict__ tb, float* __restrict__ t_out,
                      float* __restrict__ nx_out, float* __restrict__ ny_out,
                      float* __restrict__ nz_out, int* __restrict__ mat_out,
                      unsigned* __restrict__ count, int* __restrict__ list,
                      int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = i < n && act[i] > 0;
  if (i < n && !active) {
    const float bound = tb[i];
    pt::store_hit(pt::Best{bound, 0.0f, 0.0f, 0.0f, -1}, bound, dx[i], dy[i],
                  dz[i], i, t_out, nx_out, ny_out, nz_out, mat_out);
  }
  const unsigned m = __ballot_sync(FULL, active);
  if (m == 0) return;
  const int lane = threadIdx.x & 31, leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(m));
  base = __shfl_sync(FULL, base, leader);
  if (active) list[base + __popc(m & ((1u << lane) - 1))] = i;
}

template <bool kSmem>
__global__ void __launch_bounds__(THREADS)
packet_kernel_walk(const float* __restrict__ nodes_f,
                   const int* __restrict__ nodes_i, int n_nodes,
                   const float* __restrict__ tris, int root,
                   const float* __restrict__ ox, const float* __restrict__ oy,
                   const float* __restrict__ oz, const float* __restrict__ dx,
                   const float* __restrict__ dy, const float* __restrict__ dz,
                   const float* __restrict__ tb, float* __restrict__ t_out,
                   float* __restrict__ nx_out, float* __restrict__ ny_out,
                   float* __restrict__ nz_out, int* __restrict__ mat_out,
                   unsigned* __restrict__ counters,
                   const int* __restrict__ list) {
  extern __shared__ float smem[];
  const unsigned count = counters[0];  // written by packet_kernel_compact
  // rays a warp fetches at a time: the list spread over every warp of the
  // grid, at most 32 (the binned fallback's short list leaves two or three
  // rays a warp, whose leaves the whole warp tests); the blocks the list
  // does not need exit before staging
  constexpr int WARPS = THREADS / 32;
  const unsigned long long warps =
      static_cast<unsigned long long>(gridDim.x) * WARPS;
  const unsigned per = static_cast<unsigned>(
      min(32ULL, max(1ULL, (count + warps - 1) / warps)));
  if (static_cast<unsigned long long>(blockIdx.x) * WARPS * per >= count)
    return;
  const float* nf = nodes_f;
  const int* ni = nodes_i;
  if (kSmem) {
    for (int k = threadIdx.x; k < 8 * n_nodes; k += THREADS)
      smem[k] = nodes_f[k];
    int* si = reinterpret_cast<int*>(smem + 8 * n_nodes);
    for (int k = threadIdx.x; k < 4 * n_nodes; k += THREADS)
      si[k] = nodes_i[k];
    __syncthreads();
    nf = smem;
    ni = si;
  }
  const int lane = threadIdx.x & 31;
  const int max_steps = 2 * n_nodes + 2;
  for (;;) {
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(counters + 1, per);
    base = __shfl_sync(FULL, base, 0);
    if (base >= count) break;
    const bool has = lane < per && base + lane < count;
    const int i = has ? list[base + lane] : 0;
    Lane r;
    r.dx = dx[i];
    r.dy = dy[i];
    r.dz = dz[i];
    r.bound = tb[i];
    r.best = pt::Best{r.bound, 0.0f, 0.0f, 0.0f, -1};
    r.ox = ox[i];
    r.oy = oy[i];
    r.oz = oz[i];
    r.ix = 1.0f / r.dx;
    r.iy = 1.0f / r.dy;
    r.iz = 1.0f / r.dz;
    int node = root, step = 0;
    bool enter = true;
    bool walking = has && node >= 0 && node < n_nodes;
    while (__any_sync(FULL, walking)) {
      int tri_first = 0, tri_count = 0, sib = -1, par = -1;
      bool want = false;
      if (walking) {
        const float* fv = nf + 8 * node;  // 16 nodes x 8 fields a row
        const int* iv = ni + 4 * node;    // 32 nodes x 4 fields a row
        tri_first = iv[0];
        tri_count = iv[1];
        sib = iv[2];
        par = iv[3];
        want = enter && enters(fv, fv + 3, r);
      }
      const bool is_leaf = tri_count > 0;
      const bool at_leaf = walking && want && is_leaf;
      const unsigned leaves = __ballot_sync(FULL, at_leaf);
      if (leaves) leaf_tests(leaves, tri_first, tri_count, tris, r);
      if (walking) {
        const bool descend = want && !is_leaf;
        node = descend ? node + 1 : (sib >= 0 ? sib : par);
        enter = descend || sib >= 0;
        ++step;
        walking = node >= 0 && node < n_nodes && step < max_steps;
      }
    }
    if (has)
      pt::store_hit(r.best, r.bound, r.dx, r.dy, r.dz, i, t_out, nx_out,
                    ny_out, nz_out, mat_out);
  }
}

template <bool kSmem>
cudaError_t launch_walk(int device, size_t smem_bytes, cudaStream_t stream,
                        int n, const float* nodes_f, const int* nodes_i,
                        int n_nodes, const float* tris, int root,
                        const float* const* planes, float* const* outs,
                        int* mat_out, unsigned* counters, const int* list) {
  // the grid: as many blocks as the card holds at once (cached per device
  // and shared-memory size; a table's size changes only with the scene)
  struct Fit {
    int device = -1, sms = 0, per_sm = 0;
    size_t smem = 0;
  };
  static thread_local Fit fit;
  if (fit.device != device || fit.smem != smem_bytes) {
    Fit f;
    f.device = device;
    f.smem = smem_bytes;
    cudaError_t err = cudaDeviceGetAttribute(
        &f.sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &f.per_sm, packet_kernel_walk<kSmem>, THREADS, smem_bytes);
    if (err != cudaSuccess) return err;
    fit = f;
  }
  const int sms = fit.sms, per_sm = fit.per_sm;
  const long long need = (static_cast<long long>(n) + 31) / 32;
  const long long resident =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const int blocks = static_cast<int>(need < resident ? need : resident);
  packet_kernel_walk<kSmem><<<blocks, THREADS, smem_bytes, stream>>>(
      nodes_f, nodes_i, n_nodes, tris, root, planes[0], planes[1], planes[2],
      planes[3], planes[4], planes[5], planes[6], outs[0], outs[1], outs[2],
      outs[3], mat_out, counters, list);
  return cudaGetLastError();
}

}  // namespace

// scratch: n + 2 int32; [0] the list's length, [1] the walk's fetch counter,
// [2..] the list. smem_nodes: stage the node table in shared memory when it
// has at most this many nodes (48 bytes each).
extern "C" int pt_packet(int device, const void* nodes_f, const void* nodes_i,
                         int n_nodes, const void* tris, int root,
                         const void* ox, const void* oy, const void* oz,
                         const void* dx, const void* dy, const void* dz,
                         const void* act, const void* tb, void* t_out,
                         void* nx_out, void* ny_out, void* nz_out,
                         void* mat_out, void* scratch, int smem_nodes,
                         int n, void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  unsigned* counters = static_cast<unsigned*>(scratch);
  int* list = static_cast<int*>(scratch) + 2;
  err = cudaMemsetAsync(counters, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  packet_kernel_compact<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const int*>(act), f(dx), f(dy), f(dz), f(tb),
      static_cast<float*>(t_out), static_cast<float*>(nx_out),
      static_cast<float*>(ny_out), static_cast<float*>(nz_out),
      static_cast<int*>(mat_out), counters, list, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* planes[7] = {f(ox), f(oy), f(oz), f(dx), f(dy), f(dz), f(tb)};
  float* outs[4] = {static_cast<float*>(t_out), static_cast<float*>(nx_out),
                    static_cast<float*>(ny_out), static_cast<float*>(nz_out)};
  const bool stage = n_nodes <= smem_nodes;
  const size_t smem_bytes = stage ? 48 * static_cast<size_t>(n_nodes) : 0;
  err = stage ? launch_walk<true>(device, smem_bytes, s, n, f(nodes_f),
                                  static_cast<const int*>(nodes_i), n_nodes,
                                  f(tris), root, planes, outs,
                                  static_cast<int*>(mat_out), counters, list)
              : launch_walk<false>(device, 0, s, n, f(nodes_f),
                                   static_cast<const int*>(nodes_i), n_nodes,
                                   f(tris), root, planes, outs,
                                   static_cast<int*>(mat_out), counters,
                                   list);
  return static_cast<int>(err);
}
