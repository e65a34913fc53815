// Treelet stream: closest hit among the triangles of each lane's treelet.
//
// Replaces the TPU kernel `_stream_kernel` (pathtracer_tpu/ops/binned.py:446,
// launched at :868) in its default form (normals out, no chunk gate, every
// visit served). Per lane: the closest Moller-Trumbore hit strictly below
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
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// rounds of 32 triangles that the warp holds in registers at once: a
// teapot treelet (96 triangles) in one batch, an animal one (288) in three
constexpr int BATCH = 3;
constexpr int RAYS = 16;  // pool lanes a warp takes at a time

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
  using pt::FULL;
  const int lane = threadIdx.x & 31;
  const long long warp =
      static_cast<long long>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const long long stride = static_cast<long long>(gridDim.x) * WARPS * RAYS;
  for (long long base = warp * RAYS; base < n; base += stride) {
    const long long i = base + lane;
    const bool in = lane < RAYS && i < n;
    const int g = in ? tid[i] : -1;
    const bool has = in && g >= 0 && g < n_treelets;
    const float b = in ? bound[i] : 0.0f;
    if (in && !has)
      pt::store_miss(b, i, t_out, nx_out, ny_out, nz_out, mat_out);
    const unsigned work = __ballot_sync(FULL, has);
    if (!work) continue;
    float o_x = 0.0f, o_y = 0.0f, o_z = 0.0f;
    float d_x = 0.0f, d_y = 0.0f, d_z = 0.0f;
    if (has) {
      o_x = ox[i]; o_y = oy[i]; o_z = oz[i];
      d_x = dx[i]; d_y = dy[i]; d_z = dz[i];
    }
    pt::Best best{b, 0.0f, 0.0f, 0.0f, -1};
    // the ray's winner so far (record, barycentrics): its normal and
    // material are read once, after the chunk's last test, so no test
    // waits for them
    const float* win = nullptr;
    float win_u = 0.0f, win_v = 0.0f;
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
#pragma unroll
          for (int m = 0; m < BATCH; ++m) {
            const int k = k0 + lane + 32 * m;
            float t, u, v;
            if (k < count &&
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
            win = rec(k);
            win_u = u;
            win_v = v;
          }
        }
      }
    }
    if (win) pt::take_hit(win, best.t, win_u, win_v, best);
    if (has)
      pt::store_hit(best, b, d_x, d_y, d_z, i, t_out, nx_out, ny_out, nz_out,
                    mat_out);
  }
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
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = pt::resident_blocks(reinterpret_cast<const void*>(stream_kernel),
                            device, THREADS, 0, resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long need =
      (static_cast<long long>(n) + WARPS * RAYS - 1) / (WARPS * RAYS);
  const int blocks = static_cast<int>(need < resident ? need : resident);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  stream_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tre_i), n_treelets, f(tris), n_tri_rows,
      max_rows, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz), f(bound),
      static_cast<const int*>(tid), static_cast<float*>(t_out),
      static_cast<float*>(nx_out), static_cast<float*>(ny_out),
      static_cast<float*>(nz_out), static_cast<int*>(mat_out), n);
  return static_cast<int>(cudaGetLastError());
}
