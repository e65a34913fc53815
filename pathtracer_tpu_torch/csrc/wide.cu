// 8-wide BVH walk: the true closest hit under a per-ray bound over every
// mesh of the scene.
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
// The walk. The TPU kernels keep ONE stack per 128-ray packet in SMEM and
// test a popped node's 8 children against the whole packet as one (8, 128)
// tile. Here each ray has its own stack, in one of two disciplines:
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
// Both are one walk (walk<kMask, kCull>). Empty child slots hold NaN boxes
// and kind 0; the box test's min and max propagate NaN, as common.cuh slab
// does (a NaN parameter fails every comparison), and the entry t it pushes
// only meets `<` against the best t, where the sign of a zero does not
// count.
//
// What bounds it on an H100: issued instructions and the latency of each
// ray's chain of dependent steps, not bytes or FP32 operations. An active
// bounce-1 ray on the teapot makes ~4.4 node steps (35 box tests) and ~2.4
// eight-triangle groups; over the pool's 100,133 active lanes that is
// ~1.9e8 FP32 operations (0.003 ms of the card) and ~19 MB (0.0057 ms).
// The design this one replaced ran one thread per pool lane (647,168
// threads, most warps with one or two walks), tested the 8 children and the
// 8 or 16 triangles of a step one after another in that thread, read each
// child record 512 bytes from the next in the (8, 128) tables and kept a
// 1,184-byte stack in local memory: 0.224 device ms a call (push), 0.214
// (mask), ~39x the bound. This one takes 0.093 (push) and 0.103 (mask) on
// that pool (H100 80GB HBM3, 700 W): ~16x the bound. Clock counters in a
// throwaway build put a warp at ~55-73 steps for its ~32 rays, each step a
// few hundred issued instructions (the pool refill, the stack pop, the node
// step, the waiting leaves, the finish check), with a node step's 8 lanes
// used by 2.2 of the warp's 4 rays on average: the SM issues close to its
// limit, so what is left is fewer instructions a step and fuller steps.
//
// The design:
//   1. wide_compact_kernel, over the pool: an inactive lane (or every lane,
//      when the root is not a node of the table) writes its miss; the
//      active lanes of each warp append their indices to a device list
//      (common.cuh append_active). No host synchronization.
//   2. wide_push_kernel / wide_mask_kernel, persistent (a grid of the blocks
//      the card holds at once): 8 lanes walk one ray, so a warp walks 4.
//      The warp fetches `per` list entries by one atomicAdd (the list spread
//      over four fetches a warp, at most 32) into its pool in shared memory,
//      each entry's ray and inverse direction with it, and a segment whose
//      ray is done takes the pool's next entry, so the warps balance the
//      rays among themselves to the end.
//   3. A node step: lane c slab-tests child c (NaN-propagating min / max
//      instructions, so a NaN parameter fails every comparison as in
//      common.cuh slab), and one ballot gives the want mask the serial loop
//      built. Push: each wanted child's slot is its rank among the wanted in
//      push order, so the 8 lanes write their entries at once. Mask: lane 0
//      pushes the node's entry.
//   4. A leaf step: a popped leaf waits until LEAF_BATCH of the warp's rays
//      have one (or no ray has a node step left before its next leaf), so
//      the costly triangle step runs for several rays at once. Lane k tests
//      triangle k of both groups; the winner is the segment's arg-min of
//      (t bits, 8 * group + k) among hits strictly below the ray's best, by
//      three xor shuffles on each: exactly the triangle that the serial
//      strict-`<` loop over the groups keeps (a hit's t is positive, so its
//      bits order as the floats do). The winner's normal and material are
//      taken once, when the walk ends (common.cuh take_hit), so the bits
//      are the serial loop's.
//   5. Node records are scene.nodes8_c (scene/types.py pack_wide_nodes):
//      32 contiguous bytes a child, two 16-byte loads, so a node step's 8
//      lanes read 256 contiguous bytes through L1. Each ray's stack lives in
//      shared memory (push: 148 codes, and 148 entry t with the cull; mask:
//      21 entries).
// Measured and not kept (H100 80GB HBM3, 700 W; PERF.md): one ray a thread
// over the same list (1.5x slower), 4 lanes a ray, 256, 512 or 64 threads a
// block, the teapot's node table staged in shared memory (fewer blocks an
// SM: slower), leaf steps at once or only when every ray waits, an L1
// prefetch of a waiting leaf's triangles, and fewer registers by launch
// bounds (spills).
// Every shuffle and ballot runs on all 32 lanes: a segment without work
// stays in the warp's loop until the warp's last walk ends, and reads and
// writes of a ray's stack by its 8 lanes are ordered by __syncwarp.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int SEG = 8;                        // lanes that walk one ray
constexpr int RAYS = THREADS / SEG;           // rays a block walks at once
constexpr int MAX_DEPTH = 20;                 // scene/bvh8.py MAX_DEPTH
constexpr int STACK = 7 * MAX_DEPTH + 8;      // push stack
constexpr int MASK_STACK = MAX_DEPTH + 1;     // mask stack
constexpr int LEAF_TAG = 1 << 30;             // push leaf code: TAG + g*4 + n
constexpr int MAX_WIDE_GROUPS = 2;            // 8-tri groups per leaf
constexpr int GROUPS_PER_BLOCK = 6;           // tri groups per (8, 128) block
constexpr int KIND_LEAF = 2;
constexpr int REC = 2;                        // int4 a child record
constexpr int LEAF_BATCH = 2;                 // rays a leaf step waits for
constexpr int POOL = 11;                      // words a pool entry
constexpr int WIN = 4;                        // words a ray's winner
using pt::FULL;

// 32-bit words of a ray's stack in shared memory.
template <bool kMask, bool kCull>
__host__ __device__ constexpr int stack_words() {
  return kMask ? MASK_STACK : (kCull ? 2 * STACK : STACK);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Args {
  const int4* nodes;            // pack_wide_nodes: REC int4 a child slot
  int n_wide;
  const float* tris8;
  int n_groups;
  const int* root;
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tb;
  const int* act;
  float *t_out, *nx_out, *ny_out, *nz_out;
  int* mat_out;
  unsigned* counters;           // [0] the list's length, [1] fetched
  int* list;
};

// Triangle k of 8-triangle group g in the packed (8, 128) blocks of tris8;
// 16-byte aligned (the rows are 512 bytes, a group 80).
__device__ __forceinline__ const float* tri_record(const float* tris8, int g,
                                                   int k) {
  return tris8 + ((g / GROUPS_PER_BLOCK) * 8 + k) * pt::ROW +
         (g % GROUPS_PER_BLOCK) * pt::TRI_STRIDE;
}

// min / max that return NaN when either operand is NaN (PTX .NaN, sm_80+):
// the slab test of common.cuh slab in fewer instructions. It differs from
// slab only in the sign of a zero and in a NaN's payload, which no
// comparison sees, and the walk only compares t0 and t1.
__device__ __forceinline__ float min_nan(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// Entry and exit t of the box of a child record (lo = min xyz, max x; hi
// = max yz, code, kind | axis << 2).
__device__ __forceinline__ void slab(const int4& lo, const int4& hi,
                                     const Ray& r, float& t0, float& t1) {
  const float tnx = (__int_as_float(lo.x) - r.ox) * r.ix;
  const float tfx = (__int_as_float(lo.w) - r.ox) * r.ix;
  const float tny = (__int_as_float(lo.y) - r.oy) * r.iy;
  const float tfy = (__int_as_float(hi.x) - r.oy) * r.iy;
  const float tnz = (__int_as_float(lo.z) - r.oz) * r.iz;
  const float tfz = (__int_as_float(hi.y) - r.oz) * r.iz;
  t0 = max_nan(max_nan(min_nan(tnx, tfx), min_nan(tny, tfy)),
               min_nan(tnz, tfz));
  t1 = min_nan(min_nan(max_nan(tnx, tfx), max_nan(tny, tfy)),
               max_nan(tnz, tfz));
}

__global__ void __launch_bounds__(THREADS)
wide_compact_kernel(Args a, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int root = *a.root;
  const bool walk = i < n && a.act[i] > 0 && root >= 0 && root < a.n_wide;
  if (i < n && !walk) {
    a.t_out[i] = -1.0f;
    a.nx_out[i] = 0.0f;
    a.ny_out[i] = 0.0f;
    a.nz_out[i] = 0.0f;
    a.mat_out[i] = -1;
  }
  pt::append_active(walk, i, a.counters, a.list);
}

template <bool kMask, bool kCull>
__device__ __forceinline__ void walk(const Args& a) {
  extern __shared__ int4 smem[];
  constexpr int WORDS = stack_words<kMask, kCull>();
  const unsigned count = a.counters[0];  // written by wide_compact_kernel
  // list entries a warp fetches at a time: four fetches a warp, 1 to 32;
  // the blocks the list does not need exit at once
  const unsigned long long warps =
      static_cast<unsigned long long>(gridDim.x) * WARPS;
  const unsigned per = static_cast<unsigned>(
      min(32ULL, max(1ULL, (count + 4 * warps - 1) / (4 * warps))));
  if (static_cast<unsigned long long>(blockIdx.x) * WARPS * per >= count)
    return;
  const int4* __restrict__ nodes = a.nodes;
  const int lane = threadIdx.x & 31, c = lane & (SEG - 1);
  const int lead = lane & ~(SEG - 1);           // the segment's lane 0
  // shared memory: each ray's stack, each warp's pool of list entries
  // (word k of entry e at [k * 32 + e]), each ray's winning triangle
  int* stk = reinterpret_cast<int*>(smem) + (threadIdx.x / SEG) * WORDS;
  float* stk_t = reinterpret_cast<float*>(stk + STACK);   // kCull only
  float* pool = reinterpret_cast<float*>(smem) + RAYS * WORDS +
                (threadIdx.x / 32) * POOL * 32;
  int* win = reinterpret_cast<int*>(smem) + RAYS * WORDS +
             WARPS * POOL * 32 + (threadIdx.x / SEG) * WIN;
  const int root = *a.root;
  const int max_steps = 8 * a.n_wide + 1;

  // the segment's ray and walk, the same in its 8 lanes; `pending`: a
  // popped leaf (groups g0 .. g0 + ng - 1) waits for the warp's leaf step
  bool has = false, first = false, pending = false;
  int i = 0, sp = 0, step = 0, g0 = 0, ng = 0;
  Ray r{};
  float best_t = 0.0f;
  // the warp's pool: entries pool_next .. pool_n - 1 not taken yet
  int pool_n = 0, pool_next = 0;
  bool drained = false;

  for (;;) {
    // 1. segments without a ray take the pool's next entries, in order
    unsigned need = __ballot_sync(FULL, c == 0 && !has);
    while (need) {
      if (pool_next >= pool_n) {
        if (drained) break;
        unsigned base = 0;
        if (lane == 0) base = atomicAdd(a.counters + 1, per);
        base = __shfl_sync(FULL, base, 0);
        if (base >= count) {
          drained = true;
          break;
        }
        pool_n = static_cast<int>(min(per, count - base));
        pool_next = 0;
        __syncwarp();
        if (lane < pool_n) {
          const int e = a.list[base + lane];
          const float dx = a.dx[e], dy = a.dy[e], dz = a.dz[e];
          const float v[POOL] = {__int_as_float(e), a.ox[e], a.oy[e], a.oz[e],
                                 dx, dy, dz, 1.0f / dx, 1.0f / dy,
                                 1.0f / dz, a.tb[e]};
#pragma unroll
          for (int k = 0; k < POOL; ++k) pool[k * 32 + lane] = v[k];
        }
        __syncwarp();
      }
      const unsigned bit = 1u << lead;
      const int rank = __popc(need & (bit - 1));
      const int take = min(__popc(need), pool_n - pool_next);
      const bool got = (need & bit) && rank < take;
      if (got) {
        const float* e = pool + pool_next + rank;
        has = true;
        i = __float_as_int(e[0]);
        r.ox = e[32];
        r.oy = e[64];
        r.oz = e[96];
        r.dx = e[128];
        r.dy = e[160];
        r.dz = e[192];
        r.ix = e[224];
        r.iy = e[256];
        r.iz = e[288];
        best_t = e[320];
        step = 0;
        if (c == 0) win[0] = -1;
        if (kMask) {
          sp = 0;
          first = true;         // the root's slab test, not a step
        } else {
          sp = 1;
          if (c == 0) {
            stk[0] = root;
            if (kCull) stk_t[0] = -pt::FLT_MAX_F;
          }
        }
      }
      pool_next += take;
      need &= ~__ballot_sync(FULL, c == 0 && got);
    }
    if (!__any_sync(FULL, has)) break;

    // 2. a segment with no leaf waiting takes its next step from its stack
    __syncwarp();
    int node = -1, top = 0;     // node: the node to slab-test, if any
    bool rewrite = false;
    if (has && !pending) {
      if (kMask && first) {
        first = false;
        node = root;
      } else if (!kMask) {
        ++step;
        --sp;
        const int e = stk[sp];
        if (!kCull || stk_t[sp] < best_t) {
          if (e >= LEAF_TAG) {
            pending = true;
            g0 = (e - LEAF_TAG) >> 2;
            ng = (e - LEAF_TAG) & 3;
          } else if (e >= 0 && e < a.n_wide) {
            node = e;
          }
        }
      } else {
        ++step;
        const int e = stk[sp - 1];
        const unsigned mask = e & 0xFF;
        const int parent = (e >> 8) & 0x3FFFFF;
        // nearest remaining child: the lowest set bit when ascending slots
        // run near to far, else the highest
        const int ct = ((e >> 30) & 1) ? __ffs(mask) - 1 : 31 - __clz(mask);
        const unsigned rest = mask & ~(1u << ct);
        top = (e & ~0xFF) | static_cast<int>(rest);
        rewrite = rest != 0;
        if (!rest) --sp;
        const int4 rec = nodes[(parent * 8 + ct) * REC + 1];
        if ((rec.w & 3) == KIND_LEAF) {
          pending = true;
          g0 = (rec.z - LEAF_TAG) >> 2;
          ng = rec.z & 3;
        } else if (rec.z >= 0 && rec.z < a.n_wide) {
          node = rec.z;
        }
      }
    }
    __syncwarp();
    if (kMask && rewrite && c == 0) stk[sp - 1] = top;

    // 3. node steps: lane c tests child c
    if (__any_sync(FULL, node >= 0)) {
      bool want = false, near_first = false;
      float t0 = 0.0f;
      int code = 0;
      if (node >= 0) {
        const int4* rec = nodes + (node * 8 + c) * REC;
        const int4 lo = rec[0], hi = rec[1];
        float t1;
        slab(lo, hi, r, t0, t1);
        want = (hi.w & 3) != 0 && t0 <= t1 && t1 > 0.0f && t0 < best_t;
        const int axis = (hi.w >> 2) & 3;
        near_first = (axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz)) >= 0.0f;
        code = hi.z;
      }
      const unsigned bits = (__ballot_sync(FULL, want) >> lead) & 0xFFu;
      if (node >= 0) {
        if (!kMask) {
          // far to near, so the nearest wanted child ends on top
          const int pos = sp + (near_first ? __popc(bits >> (c + 1))
                                           : __popc(bits & ((1u << c) - 1)));
          if (want && pos < STACK) {
            stk[pos] = code;
            if (kCull) stk_t[pos] = t0;
          }
          sp = min(sp + __popc(bits), STACK);
        } else if (bits && sp < MASK_STACK) {
          if (c == 0)
            stk[sp] = (node << 8) | static_cast<int>(bits) |
                      (static_cast<int>(near_first) << 30);
          ++sp;
        }
      }
    }

    // 4. the waiting leaves, once LEAF_BATCH rays wait or no ray has a node
    // step left before its next leaf: lane k tests triangle k of each
    // group; the winner is the first of least t below the best over both
    // groups, by (t bits, 8 * group + k)
    const bool ready = !has || pending || sp == 0 || step >= max_steps;
    const unsigned waiting = __ballot_sync(FULL, c == 0 && pending);
    if (waiting &&
        (__popc(waiting) >= LEAF_BATCH || __all_sync(FULL, ready))) {
      unsigned t_bits = pt::NO_HIT;
      unsigned kk = 0;
      float u = 0.0f, v = 0.0f;
#pragma unroll
      for (int g = 0; g < MAX_WIDE_GROUPS; ++g) {
        const int gi = g0 + g;
        if (!(pending && (g == 0 || g < ng) && gi >= 0 && gi < a.n_groups))
          continue;
        const float* tv = tri_record(a.tris8, gi, c);
        const float4 p = *reinterpret_cast<const float4*>(tv);
        const float4 q = *reinterpret_cast<const float4*>(tv + 4);
        float t, tu, tw;
        if (pt::tri_hit(p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w, tv[8], r.ox,
                        r.oy, r.oz, r.dx, r.dy, r.dz, t, tu, tw) &&
            t < best_t && __float_as_uint(t) < t_bits) {
          t_bits = __float_as_uint(t);
          kk = static_cast<unsigned>(g * SEG + c);
          u = tu;
          v = tw;
        }
      }
      unsigned t_min = t_bits;
      for (int o = SEG / 2; o; o >>= 1)
        t_min = min(t_min, __shfl_xor_sync(FULL, t_min, o));
      unsigned k_min = t_bits == t_min ? kk : 16u;
      for (int o = SEG / 2; o; o >>= 1)
        k_min = min(k_min, __shfl_xor_sync(FULL, k_min, o));
      const int src = lead + static_cast<int>(k_min % SEG);
      const float u_k = __shfl_sync(FULL, u, src);
      const float v_k = __shfl_sync(FULL, v, src);
      if (pending && t_min != pt::NO_HIT) {
        best_t = __uint_as_float(t_min);
        if (c == 0) {
          win[0] = g0 + static_cast<int>(k_min / SEG);
          win[1] = static_cast<int>(k_min % SEG);
          win[2] = __float_as_int(u_k);
          win[3] = __float_as_int(v_k);
        }
      }
      pending = false;
    }

    // 5. a finished walk writes its lane's outputs: t = -1 where nothing
    // was hit, else the winner's normal normalized and faced toward the ray
    if (has && !pending && (sp == 0 || step >= max_steps)) {
      if (c == 0) {
        pt::Best best{best_t, 0.0f, 0.0f, 0.0f, -1};
        if (win[0] >= 0)
          pt::take_hit(tri_record(a.tris8, win[0], win[1]), best_t,
                       __int_as_float(win[2]), __int_as_float(win[3]), best);
        const float len2 =
            best.nx * best.nx + best.ny * best.ny + best.nz * best.nz;
        const float inv_len = 1.0f / sqrtf(pt::nan_max(len2, 1e-30f));
        const float fl =
            (r.dx * best.nx + r.dy * best.ny + r.dz * best.nz > 0.0f)
                ? -inv_len
                : inv_len;
        a.t_out[i] = best.mat < 0 ? -1.0f : best_t;
        a.nx_out[i] = best.nx * fl;
        a.ny_out[i] = best.ny * fl;
        a.nz_out[i] = best.nz * fl;
        a.mat_out[i] = best.mat;
      }
      has = false;
    }
  }
}

template <bool kCull>
__global__ void __launch_bounds__(THREADS) wide_push_kernel(Args a) {
  walk<false, kCull>(a);
}

__global__ void __launch_bounds__(THREADS) wide_mask_kernel(Args a) {
  walk<true, false>(a);
}

// Dynamic shared memory of a walk block: the stacks, the pools, the winners.
template <bool kMask, bool kCull>
constexpr size_t walk_smem() {
  return sizeof(int) *
         (RAYS * stack_words<kMask, kCull>() + WARPS * POOL * 32 + RAYS * WIN);
}

template <bool kMask, bool kCull>
cudaError_t launch_walk(int device, cudaStream_t stream, int n,
                        const Args& a) {
  const size_t smem = walk_smem<kMask, kCull>();
  const void* kernel =
      kMask ? reinterpret_cast<const void*>(wide_mask_kernel)
            : reinterpret_cast<const void*>(wide_push_kernel<kCull>);
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {   // the push stacks with their entry t
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // the grid: as many blocks as the card holds at once, or fewer for a
  // short pool
  int resident = 0;
  err = pt::resident_blocks(kernel, device, THREADS, smem, resident);
  if (err != cudaSuccess) return err;
  const long long need = (static_cast<long long>(n) + RAYS - 1) / RAYS;
  const int blocks = static_cast<int>(need < resident ? need : resident);
  if (kMask)
    wide_mask_kernel<<<blocks, THREADS, smem, stream>>>(a);
  else
    wide_push_kernel<kCull><<<blocks, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

int run(bool mask, bool cull, int device, const void* nodes, int n_wide,
        const void* tris8, int n_groups, const void* root, const void* ox,
        const void* oy, const void* oz, const void* dx, const void* dy,
        const void* dz, const void* act, const void* tb, void* t_out,
        void* nx_out, void* ny_out, void* nz_out, void* mat_out,
        void* scratch, int n, void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  Args a{static_cast<const int4*>(nodes), n_wide, f(tris8), n_groups,
         static_cast<const int*>(root), f(ox), f(oy), f(oz), f(dx), f(dy),
         f(dz), f(tb), static_cast<const int*>(act),
         static_cast<float*>(t_out), static_cast<float*>(nx_out),
         static_cast<float*>(ny_out), static_cast<float*>(nz_out),
         static_cast<int*>(mat_out), static_cast<unsigned*>(scratch),
         static_cast<int*>(scratch) + 2};
  err = cudaMemsetAsync(a.counters, 0, 2 * sizeof(unsigned), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  wide_compact_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(a, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mask)
    err = launch_walk<true, false>(device, s, n, a);
  else if (cull)
    err = launch_walk<false, true>(device, s, n, a);
  else
    err = launch_walk<false, false>(device, s, n, a);
  return static_cast<int>(err);
}

}  // namespace

// nodes: scene.nodes8_c (n_wide * 8 records of 32 bytes, 16-byte aligned);
// tris8 16-byte aligned; scratch: n + 2 int32, [0] the list's length, [1]
// the walk's fetch counter, [2..] the list.
extern "C" int pt_wide_push(int device, const void* nodes, int n_wide,
                            const void* tris8, int n_groups, const void* root,
                            const void* ox, const void* oy, const void* oz,
                            const void* dx, const void* dy, const void* dz,
                            const void* act, const void* tb, int cull,
                            void* t_out, void* nx_out, void* ny_out,
                            void* nz_out, void* mat_out, void* scratch, int n,
                            void* stream) {
  return run(false, cull != 0, device, nodes, n_wide, tris8, n_groups, root,
             ox, oy, oz, dx, dy, dz, act, tb, t_out, nx_out, ny_out, nz_out,
             mat_out, scratch, n, stream);
}

extern "C" int pt_wide_mask(int device, const void* nodes, int n_wide,
                            const void* tris8, int n_groups, const void* root,
                            const void* ox, const void* oy, const void* oz,
                            const void* dx, const void* dy, const void* dz,
                            const void* act, const void* tb, void* t_out,
                            void* nx_out, void* ny_out, void* nz_out,
                            void* mat_out, void* scratch, int n,
                            void* stream) {
  return run(true, false, device, nodes, n_wide, tris8, n_groups, root, ox,
             oy, oz, dx, dy, dz, act, tb, t_out, nx_out, ny_out, nz_out,
             mat_out, scratch, n, stream);
}

// Bytes of dynamic shared memory a walk block of pt_wide_mask (mask != 0)
// or pt_wide_push (with its cull when cull != 0) asks for.
extern "C" int pt_wide_smem(int mask, int cull) {
  return static_cast<int>(mask   ? walk_smem<true, false>()
                          : cull ? walk_smem<false, true>()
                                 : walk_smem<false, false>());
}
