// Treelet stream: closest hit among the triangles of each lane's treelet.
//
// Replaces the TPU kernel `_stream_kernel` (pathtracer_tpu/ops/binned.py:446,
// launched at :868) in all four of its forms, template flags on one kernel:
// the default (normals out), `uv` (t, u, v and the triangle index out,
// binned.py:500-509,658-664), `defer` (a visit wanted by fewer than
// min_support lanes of its 2,048-lane block is skipped, and those lanes get
// inc = 1, binned.py:629-652) and `gate` (a chunk of 4 triangle rows is
// tested only where the ray enters its box closer than its best so far,
// binned.py:566-606). Per lane: the closest Moller-Trumbore hit strictly below
// `bound` among the triangle rows [row0, row0 + n_rows) of treelet `tid`
// (from treelet_i), with the raw interpolated normal normalized and faced
// toward the ray once at the end; a miss (t = -1, mat = -1) when nothing
// beats the bound or tid is TREELET_NONE. The TPU kernel also tests every
// lane of a 16x128 block against the other ids binned into that block, an
// artefact of SIMD blocks: those rows can only add correct candidate hits,
// and the binned pipeline's final result is the true closest hit either way
// (the cull enumerates every wanted treelet and the packet walk finishes
// the rest), so only the lane's own treelet is tested here.
//
// What bounds it on an H100: the Moller-Trumbore tests, about 55 FP32
// operations (some 86 instructions, with -fmad=false and an IEEE division)
// per (ray, triangle), up to tre_rows * 6 triangles a ray (96 on the
// teapot, 288 on animal); the triangle table (560 KB on the teapot, 4 MB on
// animal) stays in L2. On the main path (teapot, binned) a call gets 641,024
// pool lanes of which ~63,000 have a treelet (pass 1), sorted by treelet id
// to the head rows of every column (ops/binned.py _seg_sort); its bound is
// 0.0053 ms, by bytes. The design this one replaces took 0.0650 ms of
// device time there: one thread per pool lane, and each lane with a
// treelet tested its triangles one after another, each a chain of loads
// from L2. This one takes 0.0354-0.0359 ms against the old design's
// 0.0650-0.0654 in the same calls (animal pass 1: 0.1597-0.1668 against
// 0.2911-0.3523), torch.profiler device time, H100 80GB HBM3 at 700.00 W:
// the ~6 million tests' instructions, issued by the 24 warps an SM holds
// at 78 registers a thread, now set its time (capped at 64 registers, 32
// warps, it took 0.0367; a correctly rounded reciprocal in place of the
// division, 0.0362); chunks without a treelet cost ~0.005 ms in all.
//
// The design:
//   1. A grid of the blocks the card holds at once; each warp loops over
//      chunks of RAYS consecutive lanes. Lanes without a treelet write the
//      miss at once (common.cuh store_miss: it needs only the bound).
//   2. The treelet's triangles are tested across the warp: the rays of a
//      chunk that share a treelet id (__match_any_sync; the pool is sorted
//      by id, so a chunk holds few ids) are served together. The warp loads
//      BATCH rounds of 32 of the treelet's triangles into registers, three
//      a lane (k = lane, lane + 32, lane + 64: a whole teapot treelet), and
//      runs every ray of the group against them, one ray at a time,
//      broadcast by shuffles. The winner is the arg-min of (t, k) by two
//      warp reductions over the hits strictly below the ray's best so far
//      (common.cuh warp_winner), the serial strict-`<` loop's tie rule, with
//      batches taken in order of k. The ray's lane keeps the winning record
//      and barycentrics and reads its normal and material once, after the
//      chunk's last test (common.cuh take_hit: the serial loop's bits), so
//      no test waits for that read.
//   Measured on the teapot's pass 1, each against the one before in one
//   call (H100 80GB HBM3, 700.00 W): the warp-wide test with each ray's
//   triangles read from L1/L2 (the packet walk's leaf test) took 0.066-0.068
//   ms, no faster than the old design; holding them in registers 0.041 (32
//   lanes a chunk); 16 lanes a chunk 0.037; the deferred record read 0.036.
//   8 lanes a chunk (0.043) and reading four chunks' ids at once (0.038)
//   were slower.
//   3. The other forms. uv: the winner's index k in its treelet gives the
//      triangle index row0 * 6 + k of the JAX package's numbering (so
//      scene.tri_attrs[tri] is the winner's row); no normal is read.
//      defer: the TPU kernel counts a treelet's supporters as it visits the
//      distinct ids of its 16 x 128 block; here a lane serves only its own
//      treelet, so a first kernel sorts each block of 2,048 pool lanes' ids
//      in shared memory (cub::BlockRadixSort) and gives each lane the count
//      of its id by two binary searches; a lane with a treelet and a count
//      below min_support gets inc = 1 and no tests. gate: the treelet's
//      first 96 triangles are 4 chunks of 24, and so is each later batch;
//      for each ray, lanes 0-3 slab-test the batch's 4 chunk boxes
//      (scene.treelet_chunk) against the ray's best before the batch, and a
//      lane tests a triangle only if its chunk passed (a ray whose 4 chunks
//      all fail skips the batch). The test is the TPU kernel's, per ray and
//      at batch granularity: a skipped chunk's box is not entered below the
//      best, so it holds no closer hit and the result is the ungated one.
#include <cub/block/block_radix_sort.cuh>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// rounds of 32 triangles that the warp holds in registers at once: a
// teapot treelet (96 triangles) in one batch, an animal one (288) in three
constexpr int BATCH = 3;
constexpr int RAYS = 16;  // pool lanes a warp takes at a time
// the chunk gate: triangles a chunk (4 rows of 6), chunks a batch, chunk
// boxes a treelet's row of treelet_chunk
constexpr int CHUNK_TRIS = 4 * pt::TRIS_PER_ROW;
constexpr int GATE_CHUNKS = 32 * BATCH / CHUNK_TRIS;
constexpr int CHUNKS_PER_ROW = pt::ROW / 8;
static_assert(32 * BATCH % CHUNK_TRIS == 0, "a batch holds whole chunks");
static_assert(GATE_CHUNKS <= 32, "one gate lane a chunk");
// minority-want deferral: the lanes whose ids are counted together, the
// TPU kernel's block of 16 x 128 lanes
constexpr int SUPPORT_LANES = 2048;
constexpr int SUPPORT_ITEMS = SUPPORT_LANES / THREADS;

// inc[i] = 1 where lane i has a treelet that fewer than min_support lanes
// of its block of SUPPORT_LANES want, else 0. One block a block of lanes.
__global__ void __launch_bounds__(THREADS)
support_kernel(const int* __restrict__ tid, int n_treelets, int min_support,
               int* __restrict__ inc, int n) {
  using Sort = cub::BlockRadixSort<int, THREADS, SUPPORT_ITEMS>;
  __shared__ union {
    typename Sort::TempStorage sort;
    int keys[SUPPORT_LANES];
  } sh;
  const long long base = static_cast<long long>(blockIdx.x) * SUPPORT_LANES;
  int key[SUPPORT_ITEMS];
#pragma unroll
  for (int j = 0; j < SUPPORT_ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    key[j] = i < n ? tid[i] : 0x7fffffff;  // past the pool: no treelet's
  }
  Sort(sh.sort).Sort(key);
  __syncthreads();  // the sort's storage becomes the sorted keys
#pragma unroll
  for (int j = 0; j < SUPPORT_ITEMS; ++j)
    sh.keys[threadIdx.x * SUPPORT_ITEMS + j] = key[j];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SUPPORT_ITEMS; ++j) {
    const long long i = base + j * THREADS + threadIdx.x;
    if (i >= n) continue;
    const int g = tid[i];
    int deferred = 0;
    if (g >= 0 && g < n_treelets) {
      int lo = 0, hi = SUPPORT_LANES;  // first key >= g
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (sh.keys[mid] < g) lo = mid + 1; else hi = mid;
      }
      int lo2 = lo, hi2 = SUPPORT_LANES;  // first key > g
      while (lo2 < hi2) {
        const int mid = (lo2 + hi2) / 2;
        if (sh.keys[mid] <= g) lo2 = mid + 1; else hi2 = mid;
      }
      deferred = lo2 - lo < min_support;
    }
    inc[i] = deferred;
  }
}

template <bool kUV, bool kDefer, bool kGate>
__global__ void __launch_bounds__(THREADS)
stream_kernel(const int* __restrict__ tre_i, int n_treelets,
              const float* __restrict__ tris, int n_tri_rows, int max_rows,
              const float* __restrict__ chunk, const float* __restrict__ ox,
              const float* __restrict__ oy, const float* __restrict__ oz,
              const float* __restrict__ dx, const float* __restrict__ dy,
              const float* __restrict__ dz, const float* __restrict__ bound,
              const int* __restrict__ tid, const int* __restrict__ inc,
              float* __restrict__ t_out, float* __restrict__ nx_out,
              float* __restrict__ ny_out, float* __restrict__ nz_out,
              int* __restrict__ mat_out, int n) {
  using pt::FULL;
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * RAYS;
  for (long long base = warp * RAYS; base < n; base += stride) {
    const long long i = base + lane;
    const bool in = lane < RAYS && i < n;
    const int g = in ? tid[i] : -1;
    // a deferred lane tests nothing: it misses here and its inc sends it to
    // the exact fallback
    const bool has =
        in && g >= 0 && g < n_treelets && (!kDefer || inc[i] == 0);
    const float b = in ? bound[i] : 0.0f;
    if (in && !has)
      pt::store_miss(b, i, t_out, nx_out, ny_out, nz_out, mat_out);
    const unsigned work = __ballot_sync(FULL, has);
    if (!work) continue;
    float o_x = 0.0f, o_y = 0.0f, o_z = 0.0f;
    float d_x = 0.0f, d_y = 0.0f, d_z = 0.0f;
    float i_x = 0.0f, i_y = 0.0f, i_z = 0.0f;  // the gate's 1 / d
    if (has) {
      o_x = ox[i]; o_y = oy[i]; o_z = oz[i];
      d_x = dx[i]; d_y = dy[i]; d_z = dz[i];
      if (kGate) {
        i_x = 1.0f / d_x; i_y = 1.0f / d_y; i_z = 1.0f / d_z;
      }
    }
    pt::Best best{b, 0.0f, 0.0f, 0.0f, -1};
    // the ray's winner so far (record, barycentrics): its normal and
    // material are read once, after the chunk's last test, so no test
    // waits for them; uv keeps its triangle index instead
    const float* win = nullptr;
    float win_u = 0.0f, win_v = 0.0f;
    int win_tri = -1;
    // lanes of one treelet id; the lanes without work form groups that are
    // never taken
    const unsigned same = __match_any_sync(FULL, has ? g : -1);
    unsigned pending = work;
    while (pending) {
      const int leader = __ffs(pending) - 1;
      const unsigned rays = __shfl_sync(FULL, same, leader);
      pending &= ~rays;
      const int gl = __shfl_sync(FULL, g, leader);
      const int row0 = tre_i[4 * gl];
      const int count = pt::TRIS_PER_ROW * min(tre_i[4 * gl + 1], max_rows);
      const auto rec = [tris, row0, n_tri_rows](int k) {
        return tris +
               min(row0 + k / pt::TRIS_PER_ROW, n_tri_rows - 1) * pt::ROW +
               (k % pt::TRIS_PER_ROW) * pt::TRI_STRIDE;
      };
      const float* boxes = kGate ? chunk + static_cast<long long>(gl) *
                                               pt::ROW
                                 : nullptr;
      for (int k0 = 0; k0 < count; k0 += 32 * BATCH) {
        // this lane's triangles of the batch, k = k0 + lane + 32 m
        float tv[BATCH][9];
#pragma unroll
        for (int m = 0; m < BATCH; ++m) {
          const int k = k0 + lane + 32 * m;
          const float* p = rec(k < count ? k : 0);
#pragma unroll
          for (int c = 0; c < 9; ++c) tv[m][c] = p[c];
        }
        // every ray of the group against them, one after another
        unsigned left = rays;
        while (left) {
          const int src = __ffs(left) - 1;
          left &= left - 1;
          const float r_ox = __shfl_sync(FULL, o_x, src);
          const float r_oy = __shfl_sync(FULL, o_y, src);
          const float r_oz = __shfl_sync(FULL, o_z, src);
          const float r_dx = __shfl_sync(FULL, d_x, src);
          const float r_dy = __shfl_sync(FULL, d_y, src);
          const float r_dz = __shfl_sync(FULL, d_z, src);
          // the ray's best so far: its bound, or an earlier batch's hit
          float ct = __shfl_sync(FULL, best.t, src), cu = 0.0f, cv = 0.0f;
          int ck = -1;
          // the batch's chunks whose box the ray enters below its best
          unsigned open = ~0u;
          if (kGate) {
            const float r_ix = __shfl_sync(FULL, i_x, src);
            const float r_iy = __shfl_sync(FULL, i_y, src);
            const float r_iz = __shfl_sync(FULL, i_z, src);
            const int c = k0 / CHUNK_TRIS + lane;
            bool enters = false;
            if (lane < GATE_CHUNKS && c < CHUNKS_PER_ROW) {
              const float* bx = boxes + 8 * c;
              float t0, t1;
              enters = pt::slab_fast(__ldg(bx), __ldg(bx + 1), __ldg(bx + 2),
                                     __ldg(bx + 3), __ldg(bx + 4),
                                     __ldg(bx + 5), r_ox, r_oy, r_oz, r_ix,
                                     r_iy, r_iz, t0, t1) &&
                       t0 <= t1 && t1 > 0.0f && t0 < ct;
            }
            open = __ballot_sync(FULL, enters);
            if (!open) continue;  // warp-uniform
          }
#pragma unroll
          for (int m = 0; m < BATCH; ++m) {
            const int k = k0 + lane + 32 * m;
            float t, u, v;
            if (k < count && ((open >> ((lane + 32 * m) / CHUNK_TRIS)) & 1) &&
                pt::tri_hit(tv[m][0], tv[m][1], tv[m][2], tv[m][3], tv[m][4],
                            tv[m][5], tv[m][6], tv[m][7], tv[m][8], r_ox,
                            r_oy, r_oz, r_dx, r_dy, r_dz, t, u, v) &&
                t < ct) {
              ct = t;
              cu = u;
              cv = v;
              ck = k;
            }
          }
          float t, u, v;
          int k;
          if (pt::warp_winner(ct, ck, cu, cv, t, k, u, v) && lane == src) {
            best.t = t;
            win_u = u;
            win_v = v;
            if (kUV)
              win_tri = row0 * pt::TRIS_PER_ROW + k;
            else
              win = rec(k);
          }
        }
      }
    }
    if (!has) continue;
    if (kUV) {
      // (t, u, v, -, triangle index): the normal is rebuilt by the caller
      const bool missed = best.t >= b;
      t_out[i] = missed ? -1.0f : best.t;
      nx_out[i] = win_u;
      ny_out[i] = win_v;
      nz_out[i] = 0.0f;
      mat_out[i] = missed ? -1 : win_tri;
    } else {
      if (win) pt::take_hit(win, best.t, win_u, win_v, best);
      pt::store_hit(best, b, d_x, d_y, d_z, i, t_out, nx_out, ny_out, nz_out,
                    mat_out);
    }
  }
}

template <bool kUV, bool kDefer, bool kGate>
cudaError_t launch(int device, cudaStream_t s, const int* tre_i,
                   int n_treelets, const float* tris, int n_tri_rows,
                   int max_rows, const float* chunk,
                   const float* const* planes, const int* tid,
                   const int* inc, float* const* outs, int* mat_out, int n) {
  const void* kernel =
      reinterpret_cast<const void*>(stream_kernel<kUV, kDefer, kGate>);
  int resident = 0;
  const cudaError_t err =
      pt::resident_blocks(kernel, device, THREADS, 0, resident);
  if (err != cudaSuccess) return err;
  const long long need =
      (static_cast<long long>(n) + WARPS * RAYS - 1) / (WARPS * RAYS);
  const int blocks = static_cast<int>(need < resident ? need : resident);
  stream_kernel<kUV, kDefer, kGate><<<blocks, THREADS, 0, s>>>(
      tre_i, n_treelets, tris, n_tri_rows, max_rows, chunk, planes[0],
      planes[1], planes[2], planes[3], planes[4], planes[5], planes[6], tid,
      inc, outs[0], outs[1], outs[2], outs[3], mat_out, n);
  return cudaGetLastError();
}

}  // namespace

// chunk: scene.treelet_chunk, or null for no gate; uv != 0: the uv form;
// min_support > 1: the deferral, with its inc plane in inc_out (else null)
extern "C" int pt_stream(int device, const void* tre_i, int n_treelets,
                         const void* tris, int n_tri_rows, int max_rows,
                         const void* chunk, int uv, int min_support,
                         const void* ox,
                         const void* oy, const void* oz, const void* dx,
                         const void* dy, const void* dz, const void* bound,
                         const void* tid, void* t_out, void* nx_out,
                         void* ny_out, void* nz_out, void* mat_out,
                         void* inc_out, int n, void* stream) {
  if (n <= 0) return 0;
  const bool defer = min_support > 1;
  if (defer != (inc_out != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the library has its own CUDA runtime: select the tensors' device
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  const int* itid = static_cast<const int*>(tid);
  int* inc = static_cast<int*>(inc_out);
  if (defer) {
    const long long blocks =
        (static_cast<long long>(n) + SUPPORT_LANES - 1) / SUPPORT_LANES;
    support_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        itid, n_treelets, min_support, inc, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const float* planes[7] = {f(ox), f(oy), f(oz), f(dx), f(dy), f(dz),
                            f(bound)};
  float* const outs[4] = {static_cast<float*>(t_out),
                          static_cast<float*>(nx_out),
                          static_cast<float*>(ny_out),
                          static_cast<float*>(nz_out)};
  const int* ti = static_cast<const int*>(tre_i);
  int* mat = static_cast<int*>(mat_out);
  const int form = (uv ? 4 : 0) | (defer ? 2 : 0) | (chunk ? 1 : 0);
#define PT_STREAM_FORM(F)                                                 \
  case F:                                                                 \
    err = launch<(F & 4) != 0, (F & 2) != 0, (F & 1) != 0>(               \
        device, s, ti, n_treelets, f(tris), n_tri_rows, max_rows,         \
        f(chunk), planes, itid, inc, outs, mat, n);                       \
    break;
  switch (form) {
    PT_STREAM_FORM(0) PT_STREAM_FORM(1) PT_STREAM_FORM(2) PT_STREAM_FORM(3)
    PT_STREAM_FORM(4) PT_STREAM_FORM(5) PT_STREAM_FORM(6) PT_STREAM_FORM(7)
  }
#undef PT_STREAM_FORM
  return static_cast<int>(err);
}
