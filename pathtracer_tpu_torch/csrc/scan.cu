// Exclusive prefix sum of a 1-D int32 or float32 tensor of any length n >= 1.
//
// Replaces the TPU kernel `_scan_kernel` (pathtracer_tpu/ops/scan.py:67,
// launched from exclusive_scan at :103). int32 sums wrap modulo 2^32, as the
// JAX scan's do: they are added as uint32, so the result equals
// cumsum(x) - x bit for bit whatever the order of the additions.
//
// What the TPU design relies on, and why it does not carry over. The TPU
// kernel walks 32x128 tiles on a grid that runs in order on one core: each
// grid step scans its tile with a Hillis-Steele roll-and-add and carries the
// running total to the next step in SMEM. Blocks on Hopper run in no order
// on 132 SMs, so nothing carries from one block to the next.
//
// Design: reduce, then scan, in a fixed order (three launches, one call).
//   1. tile_totals: each block sums one 4096-element tile into scratch[b];
//   2. scan_totals: one block of 1024 threads turns scratch into the
//      exclusive scan of the tile totals, 1024 at a time with a carry;
//   3. scan_tiles: each block stages its tile in shared memory (coalesced),
//      each thread scans 16 consecutive elements in registers, warp shuffles
//      scan the thread totals and the 8 warp totals meet in shared memory;
//      the tile's offset from step 2 is added and the tile is written back.
// Every sum is taken in an order fixed by n alone, so a float32 result is
// the same from run to run. A decoupled look-back scan (one pass) sums the
// predecessors in an order set by timing, and its float32 output changes
// between runs.
//
// What bounds it on an H100: memory traffic. The least is 8 bytes an element
// (read 4, write 4), 1.5 us for 640,000 elements at 3.35 TB/s. This design
// reads the input twice (steps 1 and 3), 12 bytes an element, and pays three
// launches; at the main path's sizes (under a million elements) launch time
// dominates either way. A single pass with look-back and 16-byte loads is
// the way to the bound, for a later change.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 16;
constexpr int TILE = THREADS * ITEMS;  // 4096, the TPU kernel's 32x128 tile
constexpr int WARPS = THREADS / 32;
constexpr int TOTALS_THREADS = 1024;
constexpr unsigned FULL = 0xffffffffu;

// Shared-memory index with one pad word every 32: thread t reading its 16
// consecutive elements t*16 .. t*16+15 then hits 32 distinct banks.
__host__ __device__ constexpr int pad(int i) { return i + (i >> 5); }

template <typename A>
__device__ __forceinline__ A warp_inclusive(A v, int lane) {
  for (int k = 1; k < 32; k <<= 1) {
    const A u = __shfl_up_sync(FULL, v, k);
    if (lane >= k) v += u;
  }
  return v;
}

// Exclusive scan of one value per thread across a block of NT threads.
// Returns this thread's exclusive prefix; `total` gets the block's sum.
// `warp_tot` holds NT / 32 values of shared memory.
template <typename A, int NT>
__device__ __forceinline__ A block_exclusive(A v, A* warp_tot, A& total) {
  static_assert(NT % 32 == 0 && NT / 32 <= 32, "one warp scans the warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const A inc = warp_inclusive(v, lane);
  A exc = __shfl_up_sync(FULL, inc, 1);
  if (lane == 0) exc = A(0);
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    A w = lane < NT / 32 ? warp_tot[lane] : A(0);
    w = warp_inclusive(w, lane);
    if (lane < NT / 32) warp_tot[lane] = w;  // inclusive over warps
  }
  __syncthreads();
  total = warp_tot[NT / 32 - 1];
  const A before = warp == 0 ? A(0) : warp_tot[warp - 1];
  __syncthreads();  // the caller may reuse warp_tot
  return before + exc;
}

template <typename A>
__global__ void __launch_bounds__(THREADS)
tile_totals(const A* __restrict__ x, A* __restrict__ totals, long long n) {
  __shared__ A warp_tot[WARPS];
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  A s = A(0);
  for (int k = 0; k < ITEMS; ++k) {
    const long long i = base + k * THREADS + threadIdx.x;
    if (i < n) s += x[i];
  }
  A total;
  block_exclusive<A, THREADS>(s, warp_tot, total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

template <typename A>
__global__ void __launch_bounds__(TOTALS_THREADS)
scan_totals(A* __restrict__ totals, int n_tiles) {
  __shared__ A warp_tot[TOTALS_THREADS / 32];
  A carry = A(0);
  for (int c = 0; c < n_tiles; c += TOTALS_THREADS) {
    const int i = c + threadIdx.x;
    const A v = i < n_tiles ? totals[i] : A(0);
    A total;
    const A exc = block_exclusive<A, TOTALS_THREADS>(v, warp_tot, total);
    if (i < n_tiles) totals[i] = carry + exc;
    carry += total;
  }
}

template <typename A>
__global__ void __launch_bounds__(THREADS)
scan_tiles(const A* __restrict__ x, const A* __restrict__ offsets,
           A* __restrict__ out, long long n) {
  __shared__ A tile[pad(TILE)];
  __shared__ A warp_tot[WARPS];
  const long long base = static_cast<long long>(blockIdx.x) * TILE;
  for (int k = 0; k < ITEMS; ++k) {  // coalesced load, zero past the end
    const int j = k * THREADS + threadIdx.x;
    tile[pad(j)] = base + j < n ? x[base + j] : A(0);
  }
  __syncthreads();
  A v[ITEMS];
  A s = A(0);
  for (int j = 0; j < ITEMS; ++j) {  // serial exclusive scan of 16 elements
    const A e = tile[pad(threadIdx.x * ITEMS + j)];
    v[j] = s;
    s += e;
  }
  A total;
  const A start = offsets[blockIdx.x] +
                  block_exclusive<A, THREADS>(s, warp_tot, total);
  for (int j = 0; j < ITEMS; ++j)
    tile[pad(threadIdx.x * ITEMS + j)] = start + v[j];
  __syncthreads();
  for (int k = 0; k < ITEMS; ++k) {  // coalesced store
    const int j = k * THREADS + threadIdx.x;
    if (base + j < n) out[base + j] = tile[pad(j)];
  }
}

template <typename A>
cudaError_t run(const void* x, void* out, void* scratch, long long n,
                cudaStream_t stream) {
  const int n_tiles = static_cast<int>((n + TILE - 1) / TILE);
  const A* in = static_cast<const A*>(x);
  A* totals = static_cast<A*>(scratch);
  tile_totals<A><<<n_tiles, THREADS, 0, stream>>>(in, totals, n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_totals<A><<<1, TOTALS_THREADS, 0, stream>>>(totals, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tiles<A><<<n_tiles, THREADS, 0, stream>>>(in, totals,
                                                 static_cast<A*>(out), n);
  return cudaGetLastError();
}

}  // namespace

// x, out: n elements of int32 (is_float = 0) or float32 (is_float = 1);
// scratch: ceil(n / 4096) elements of the same type.
extern "C" int pt_scan(int device, const void* x, void* out, void* scratch,
                       int n, int is_float, void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = is_float ? run<float>(x, out, scratch, n, s)
                                   : run<unsigned>(x, out, scratch, n, s);
  return static_cast<int>(err);
}
