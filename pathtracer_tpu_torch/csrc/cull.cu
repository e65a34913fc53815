// Treelet cull: per ray, the K nearest not-yet-enumerated wanted treelets.
//
// Replaces the TPU kernel `_cull_kernel` (pathtracer_tpu/ops/binned.py:290,
// launched at :839) for k_wants = K = 1..8. Per lane: among the treelets
// whose box the ray enters closer than `bound`, the K smallest (entry_t, id)
// strictly after (pt0, pid), in that order, in K output planes; the slots
// left over hold (TREELET_NONE, FLT_MAX), and all of them when the lane is
// not live. K = 1 feeds the pass-sequential pipeline, K > 1 the expansion
// and slot pipelines (binned.py:956-1049).
//
// What bounds it on an H100: the slab tests, about 25 FP32 operations (some
// 45 instructions) per (ray, treelet) and per (ray, super row); the tables
// are small (teapot: 89 treelets in 6 rows of 16, 3.3 KB with the super
// rows), and the bytes are the ten ray planes of the live lanes (40 bytes a
// ray in, 8 out on every lane). On the main path (teapot, binned) a call
// gets 641,024 pool lanes of which ~100,000 are live (pass 1), sorted to the
// head rows of every column, so the live work is ~16% of the pool; its
// bound is 0.0034 ms, by bytes. The design this one replaces took 0.0859 ms
// of device time there: one thread per pool lane, 2,504 blocks that each
// staged the tables before most of them found no live lane, a slab test of
// ten NaN-propagating min / max, and a super-row gate decided per thread.
// This one takes 0.0335-0.0341 ms against the old design's 0.0860-0.0870
// in the same calls (animal pass 1: 0.0939-0.0979 against 0.2280-0.2335),
// torch.profiler device time, H100 80GB HBM3 at 700.00 W: the live lanes'
// slab tests now set its time; chunks without a live lane cost ~0.004 ms
// in all.
//
// The design:
//   1. A grid of the blocks the card holds at once; each block loops over
//      chunks of the pool, a warp over 16 consecutive lanes, so the loads and
//      stores are coalesced. A warp whose lanes are all dead writes
//      (NONE, FLT_MAX) and moves on. A block stages the tables in shared
//      memory once, at its first chunk with a live lane (__syncthreads_or),
//      so blocks that meet only dead chunks never stage. Tables over
//      SMEM_MAX_ROWS rows are read through L1/L2 under the same design.
//   2. The sweep: two lanes a ray (SPLIT), each testing every other treelet
//      of a row, then the least (t0, id) of the pair by one shuffle; each
//      treelet record is two 16-byte shared loads, and the box test is
//      common.cuh slab_fast (NaN tested once, then plain fminf / fmaxf). The
//      winner's t0 is recomputed with common.cuh slab, so its bits, zero
//      sign included, are the plain version's. Two lanes a ray halve the
//      rows a warp sweeps for rays that do not want them; one (0.0387 ms)
//      and four (0.0391) were slower on the teapot's pass 1 in the same
//      call, and so was reading four chunks' liveness at once.
//   3. The super-row gate is warp-uniform: a warp runs a row's tests once
//      when any of its lanes enters the row's union box (__any_sync). A
//      lane that does not enter it finds no want in the row, since a
//      treelet's slab interval lies inside its super box's, in float
//      arithmetic too ((b - o) * inv is monotone in b): the gate only skips
//      work, and (id, t0) per lane is the plain version's.
//   4. K > 1 (a template argument, so the K = 1 kernel above is compiled as
//      it was): each lane keeps its K least (t0, id) in registers, sorted,
//      by the TPU kernel's bubble insertion (binned.py:398-416): a
//      candidate sinks through the slots, displacing each farther entry,
//      which sinks on. The ray's two lanes then merge their lists, each
//      inserting the other's K entries (the ids differ, so both get the K
//      least of the union), and the t0 of every slot is recomputed with
//      common.cuh slab, as for K = 1.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TREELETS_PER_FROW = 16;
constexpr int SMEM_MAX_ROWS = 80;  // 80 * (512 + 32) bytes < 48 KB
// lanes that share a ray: each tests every SPLIT-th treelet of a row
constexpr int SPLIT = 2;
constexpr int RAYS = 32 / SPLIT;         // rays a warp takes at a time
constexpr int CHUNK = THREADS / SPLIT;   // pool lanes a block takes at a time
constexpr int MAX_K = 8;                 // wants a lane may ask for

// The six box fields (lo xyz, hi xyz) of an 8-float record: two 16-byte
// loads from shared memory, or six cached loads from device memory.
template <bool kSmem>
__device__ __forceinline__ void box(const float* rec, float (&b)[6]) {
  if (kSmem) {
    const float4 p = reinterpret_cast<const float4*>(rec)[0];
    const float4 q = reinterpret_cast<const float4*>(rec)[1];
    b[0] = p.x; b[1] = p.y; b[2] = p.z; b[3] = p.w; b[4] = q.x; b[5] = q.y;
  } else {
    for (int c = 0; c < 6; ++c) b[c] = __ldg(rec + c);
  }
}

// (t0, id) precedes (st, sid) in the enumeration order
__device__ __forceinline__ bool before(float t0, int id, float st, int sid) {
  return t0 < st || (t0 == st && id < sid);
}

// Bubble-insert the candidate (t0, id) into the K sorted slots (st, sid):
// it sinks until it displaces a farther entry, which sinks on
// (binned.py:398-416).
template <int K>
__device__ __forceinline__ void insert(float t0, int id, float (&st)[K],
                                       int (&sid)[K]) {
#pragma unroll
  for (int s = 0; s < K; ++s) {
    if (before(t0, id, st[s], sid[s])) {
      const float pt = st[s];
      const int pi = sid[s];
      st[s] = t0;
      sid[s] = id;
      t0 = pt;
      id = pi;
    }
  }
}

template <bool kSmem, int K>
__global__ void __launch_bounds__(THREADS)
cull_kernel(const float* __restrict__ tre_f, const float* __restrict__ sup,
            int n_rows, const float* __restrict__ ox,
            const float* __restrict__ oy, const float* __restrict__ oz,
            const float* __restrict__ dx, const float* __restrict__ dy,
            const float* __restrict__ dz, const float* __restrict__ bound,
            const float* __restrict__ pt0, const int* __restrict__ pid,
            const int* __restrict__ live, int* __restrict__ out_id,
            float* __restrict__ out_t0, int n) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // record k of row r at tf[r * 128 + k * 8]; row r's union box at
  // sf[r * sstride]
  const float* tf = kSmem ? smem : tre_f;
  const float* sf = kSmem ? smem + n_rows * pt::ROW : sup;
  const int sstride = kSmem ? 8 : pt::ROW;
  const int lane = threadIdx.x & 31;
  const int sub = lane % SPLIT;  // this lane's treelets: k = sub (mod SPLIT)
  const int slot = (threadIdx.x / 32) * RAYS + lane / SPLIT;
  bool staged = false;
  for (long long base = static_cast<long long>(blockIdx.x) * CHUNK;
       base < n; base += static_cast<long long>(gridDim.x) * CHUNK) {
    const long long i = base + slot;
    const bool in = i < n;
    const bool write = in && sub == 0;
    const bool is_live = in && live[i] > 0;
    if (kSmem && !staged) {
      // block-uniform: stage at the first chunk with a live lane
      if (!__syncthreads_or(is_live)) {
        if (write) {
#pragma unroll
          for (int s = 0; s < K; ++s) {
            out_id[s * static_cast<long long>(n) + i] = pt::TREELET_NONE;
            out_t0[s * static_cast<long long>(n) + i] = pt::FLT_MAX_F;
          }
        }
        continue;
      }
      for (int k = threadIdx.x; k < n_rows * pt::ROW; k += THREADS)
        smem[k] = tre_f[k];
      for (int k = threadIdx.x; k < n_rows * 8; k += THREADS)
        smem[n_rows * pt::ROW + k] = sup[(k / 8) * pt::ROW + (k % 8)];
      __syncthreads();
      staged = true;
    }
    // slot s holds the s-th least (t0, id) found so far
    int best_id[K];
    float best_t0[K];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      best_id[s] = pt::TREELET_NONE;
      best_t0[s] = pt::FLT_MAX_F;
    }
    if (__any_sync(pt::FULL, is_live)) {
      const long long j = in ? i : 0;
      const float o_x = ox[j], o_y = oy[j], o_z = oz[j];
      const float ix = 1.0f / dx[j], iy = 1.0f / dy[j], iz = 1.0f / dz[j];
      // a lane that is not live wants nothing: no t0 is below -inf
      const float b = is_live ? bound[j] : __int_as_float(0xff800000);
      const float p_t0 = pt0[j];
      const int p_id = pid[j];
      for (int r = 0; r < n_rows; ++r) {
        float s[6], s0, s1;
        box<kSmem>(sf + r * sstride, s);
        const bool want_s =
            pt::slab_fast(s[0], s[1], s[2], s[3], s[4], s[5], o_x, o_y, o_z,
                          ix, iy, iz, s0, s1) &&
            s0 <= s1 && s1 > 0.0f && s0 < b;
        if (!__any_sync(pt::FULL, want_s)) continue;
        const float* row = tf + r * pt::ROW;
#pragma unroll
        for (int q = 0; q < TREELETS_PER_FROW / SPLIT; ++q) {
          const int k = q * SPLIT + sub;
          float e[6], t0, t1;
          box<kSmem>(row + 8 * k, e);
          const int tid = r * TREELETS_PER_FROW + k;
          const bool want =
              pt::slab_fast(e[0], e[1], e[2], e[3], e[4], e[5], o_x, o_y,
                            o_z, ix, iy, iz, t0, t1) &&
              t0 <= t1 && t1 > 0.0f && t0 < b;
          const bool after = t0 > p_t0 || (t0 == p_t0 && tid > p_id);
          if constexpr (K == 1) {
            const bool closer =
                t0 < best_t0[0] || (t0 == best_t0[0] && tid < best_id[0]);
            if (want && after && closer) {
              best_t0[0] = t0;
              best_id[0] = tid;
            }
          } else {
            if (want && after) insert<K>(t0, tid, best_t0, best_id);
          }
        }
      }
      if constexpr (K == 1) {
        // the least (t0, id) of the ray's SPLIT lanes (-0 == +0 here: the
        // winner's t0 is recomputed below)
#pragma unroll
        for (int off = 1; off < SPLIT; off *= 2) {
          const float o_t0 = __shfl_xor_sync(pt::FULL, best_t0[0], off);
          const int o_id = __shfl_xor_sync(pt::FULL, best_id[0], off);
          if (o_t0 < best_t0[0] ||
              (o_t0 == best_t0[0] && o_id < best_id[0])) {
            best_t0[0] = o_t0;
            best_id[0] = o_id;
          }
        }
      } else {
        // merge the ray's SPLIT lists: each lane inserts the other's
#pragma unroll
        for (int off = 1; off < SPLIT; off *= 2) {
          float o_t0[K];
          int o_id[K];
#pragma unroll
          for (int s = 0; s < K; ++s) {
            o_t0[s] = __shfl_xor_sync(pt::FULL, best_t0[s], off);
            o_id[s] = __shfl_xor_sync(pt::FULL, best_id[s], off);
          }
#pragma unroll
          for (int s = 0; s < K; ++s) insert<K>(o_t0[s], o_id[s], best_t0,
                                                best_id);
        }
      }
      if (write) {
        // the output t0 from the plain version's slab (its zero sign)
#pragma unroll
        for (int s = 0; s < K; ++s) {
          if (best_id[s] == pt::TREELET_NONE) continue;
          float e[6], t1;
          box<kSmem>(tf + (best_id[s] / TREELETS_PER_FROW) * pt::ROW +
                         8 * (best_id[s] % TREELETS_PER_FROW), e);
          pt::slab(e, e + 3, o_x, o_y, o_z, ix, iy, iz, best_t0[s], t1);
        }
      }
    }
    if (write) {
#pragma unroll
      for (int s = 0; s < K; ++s) {
        out_id[s * static_cast<long long>(n) + i] = best_id[s];
        out_t0[s * static_cast<long long>(n) + i] = best_t0[s];
      }
    }
  }
}

template <bool kSmem, int K>
cudaError_t launch(int device, cudaStream_t s, const float* tre_f,
                   const float* sup, int n_rows, const float* const* planes,
                   const int* pid, const int* live, int* out_id,
                   float* out_t0, int n) {
  const size_t smem =
      kSmem ? static_cast<size_t>(n_rows) * (pt::ROW + 8) * sizeof(float)
            : 0;
  int resident = 0;
  const cudaError_t err = pt::resident_blocks(
      reinterpret_cast<const void*>(cull_kernel<kSmem, K>), device, THREADS,
      smem, resident);
  if (err != cudaSuccess) return err;
  const long long need = (static_cast<long long>(n) + CHUNK - 1) / CHUNK;
  const int blocks = static_cast<int>(need < resident ? need : resident);
  cull_kernel<kSmem, K><<<blocks, THREADS, smem, s>>>(
      tre_f, sup, n_rows, planes[0], planes[1], planes[2], planes[3],
      planes[4], planes[5], planes[6], planes[7], pid, live, out_id, out_t0,
      n);
  return cudaGetLastError();
}

template <bool kSmem>
cudaError_t launch_k(int k, int device, cudaStream_t s, const float* tre_f,
                     const float* sup, int n_rows, const float* const* planes,
                     const int* pid, const int* live, int* out_id,
                     float* out_t0, int n) {
#define PT_CULL_K(K)                                                      \
  case K:                                                                 \
    return launch<kSmem, K>(device, s, tre_f, sup, n_rows, planes, pid,   \
                            live, out_id, out_t0, n);
  switch (k) {
    PT_CULL_K(1) PT_CULL_K(2) PT_CULL_K(3) PT_CULL_K(4)
    PT_CULL_K(5) PT_CULL_K(6) PT_CULL_K(7) PT_CULL_K(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef PT_CULL_K
}

}  // namespace

// out_id / out_t0: k planes of n lanes each, slot s at [s * n, s * n + n)
extern "C" int pt_cull(int device, const void* tre_f, const void* sup,
                       int n_rows, const void* ox, const void* oy,
                       const void* oz,
                       const void* dx, const void* dy, const void* dz,
                       const void* bound, const void* pt0, const void* pid,
                       const void* live, void* out_id, void* out_t0, int n,
                       int k, void* stream) {
  if (n <= 0) return 0;
  if (k < 1 || k > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const float* planes[8] = {f(ox), f(oy), f(oz), f(dx),
                            f(dy), f(dz), f(bound), f(pt0)};
  const int* ipid = static_cast<const int*>(pid);
  const int* ilive = static_cast<const int*>(live);
  int* oid = static_cast<int*>(out_id);
  float* ot0 = static_cast<float*>(out_t0);
  const cudaError_t err =
      n_rows <= SMEM_MAX_ROWS
          ? launch_k<true>(k, device, s, f(tre_f), f(sup), n_rows, planes,
                           ipid, ilive, oid, ot0, n)
          : launch_k<false>(k, device, s, f(tre_f), f(sup), n_rows, planes,
                            ipid, ilive, oid, ot0, n);
  return static_cast<int>(err);
}
