// Exclusive prefix sum of a 1-D int32 or float32 tensor of any length n >= 1.
//
// Replaces the TPU kernel `_scan_kernel` (pathtracer_tpu/ops/scan.py:67,
// launched from exclusive_scan at :103). int32 sums wrap modulo 2^32, as the
// JAX scan's do: they are added as uint32, so the result equals
// cumsum(x) - x bit for bit whatever the order of the additions.
//
// The TPU kernel walks 32x128 tiles on a grid that runs in order on one
// core, carrying the running total from one grid step to the next in SMEM.
// Blocks on Hopper run in no order on 132 SMs, so nothing carries over.
//
// What bounds it on an H100: memory, 8 bytes an element (read 4, write 4):
// 1.5 us for 640,000 elements and 40 us for 2^24 at 3.35 TB/s. Below about a
// million elements the launch itself costs more than the bytes.
//
// The design it replaces, and why that lost: reduce, then scan, in three
// launches (tile totals; one block scanning them; the tiles), with 4-byte
// loads. It read the input twice (12 bytes an element), paid three launches
// and a scratch allocation per call, and was slower than torch.cumsum
// (0.044-0.054 against 0.025-0.029 ms on the 640,000-lane mask; H100 80GB
// HBM3 at 700 W). It existed for one property, kept here: a float32 result
// that is the same bits from run to run, which a decoupled look-back that
// stops at a predecessor's inclusive prefix does not give (which
// predecessor has published when is a matter of timing).
//
// This design: one launch, one read, a look-back over aggregates in a fixed
// order. For int32 and float32 alike:
//   1. a block draws its tile id from a counter (atomicAdd), so every tile
//      before it has started and will publish: the look-back cannot wait on
//      a tile that is not running. The block that draws the last id resets
//      the counter; the next call on the stream starts after this one ends.
//   2. it loads its tile once, each warp a contiguous span with coalesced
//      16-byte loads, four elements a lane a group (scalar loads on the
//      ragged last tile, or throughout when the input is not 16-byte
//      aligned, as a slice x[1:] is); each group of four is scanned
//      serially, its 32 lanes with warp shuffles, the groups in order, and
//      the spans of the warps in shared memory;
//   3. it publishes its aggregate as one 64-bit word {epoch, value bits},
//      so no reader sees a flag without its value;
//   4. its exclusive prefix is the sum of ALL predecessor aggregates in an
//      order fixed by the tile index: thread t adds aggregates t, t + NT,
//      t + 2 NT, ... in turn (spinning until each carries this call's
//      epoch), then a fixed shuffle tree and the warp totals in order.
//      It never takes a predecessor's prefix, so timing cannot change a bit.
//      Its cost is O(tiles^2) reads from L2, which the tile size keeps small:
//      4,096 elements a tile up to 2^22 elements, 8,192 above (2^24 + 3:
//      2,049 tiles, 17 MB of L2 reads, against 128 MB of input and output);
//   5. it adds its prefix and stores the tile with 16-byte stores. Above
//      2^22 elements loads and stores are evict-first (.cs).
// A first version of this design, with ITEMS consecutive elements a thread
// (each 32-byte sector read by two strided 16-byte loads) and ld.acquire /
// st.release flags, took about twice as long at 2^24 + 3; coalesced spans
// and relaxed flag accesses brought it under torch.cumsum.
// The longest chain of dependent float adds into an output is about
// ITEMS / 4 + 13 (the aggregate) + tiles / NT + 10 (the prefix) + 2: 41 at
// 2^24 + 3, under the ~170 that chip_smoke.py's tolerance allows.
//
// Stale flags cannot match: the scratch (flags and counter) belongs to one
// (device, stream) and is zeroed when made; every call on it passes a new
// epoch, 1 .. 2^32 - 1, and the wrapper zeroes the flags again when the
// epoch wraps (ops/scan.py).
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr long long BIG_N = 1LL << 22;  // above: the 8,192-element tile

template <typename A>
__device__ __forceinline__ A from_bits(unsigned b);
template <>
__device__ __forceinline__ unsigned from_bits<unsigned>(unsigned b) {
  return b;
}
template <>
__device__ __forceinline__ float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}
__device__ __forceinline__ unsigned to_bits(unsigned v) { return v; }
__device__ __forceinline__ unsigned to_bits(float v) {
  return __float_as_uint(v);
}

// The flag word carries its own value, so relaxed single-copy-atomic 64-bit
// accesses suffice: no fence or acquire ordering is needed for a value that
// travels inside the word.
__device__ __forceinline__ void publish(unsigned long long* p,
                                        unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_flag(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

template <typename A>
__device__ __forceinline__ A warp_inclusive(A v, int lane) {
  for (int k = 1; k < 32; k <<= 1) {
    const A u = __shfl_up_sync(FULL, v, k);
    if (lane >= k) v += u;
  }
  return v;
}

template <typename A>
__device__ __forceinline__ A warp_sum(A v) {  // the sum lands in lane 0
  for (int k = 16; k > 0; k >>= 1) v += __shfl_down_sync(FULL, v, k);
  return v;
}

// Sum of the aggregates of tiles 0 .. tile - 1, in an order fixed by
// `tile` (see note 4); every thread gets it.
template <typename A, int NT>
__device__ __forceinline__ A look_back(const unsigned long long* flags,
                                       int tile, unsigned epoch, A* red) {
  constexpr int UNROLL = 4;  // loads in flight a thread
  A s = A(0);
  for (int k0 = 0; k0 < tile; k0 += UNROLL * NT) {
    unsigned long long f[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * NT + threadIdx.x;
      f[u] = k < tile ? load_flag(flags + k) : 0ULL;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int k = k0 + u * NT + threadIdx.x;
      if (k < tile) {
        while (static_cast<unsigned>(f[u] >> 32) != epoch)
          f[u] = load_flag(flags + k);
        s += from_bits<A>(static_cast<unsigned>(f[u]));
      }
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) red[warp] = s;
  __syncthreads();
  if (warp == 0) {
    A w = lane < NT / 32 ? red[lane] : A(0);
    w = warp_sum(w);
    if (lane == 0) red[0] = w;
  }
  __syncthreads();
  return red[0];
}

// Warp w of the block holds elements [seg, seg + 32 ITEMS) of the tile, and
// its lane l the groups of four at seg + 128 g + 4 l, g < ITEMS / 4: each
// 16-byte load and store of a warp covers 512 contiguous bytes.
// A tile's input and output, kStream: evict-first (.cs), for inputs far
// larger than the L2, where caching them only evicts the flags.
template <bool kStream>
__device__ __forceinline__ uint4 load4(const void* p) {
  return kStream ? __ldcs(static_cast<const uint4*>(p))
                 : *static_cast<const uint4*>(p);
}

template <bool kStream>
__device__ __forceinline__ void store4(void* p, uint4 v) {
  if (kStream)
    __stcs(static_cast<uint4*>(p), v);
  else
    *static_cast<uint4*>(p) = v;
}

template <typename A, int NT, int ITEMS, bool kVec, bool kStream>
__global__ void __launch_bounds__(NT)
scan_kernel(const A* __restrict__ x, A* __restrict__ out, long long n,
            int n_tiles, unsigned long long* __restrict__ flags,
            unsigned* __restrict__ counter, unsigned epoch) {
  static_assert(ITEMS % 4 == 0 && NT % 32 == 0 && NT <= 1024, "shape");
  constexpr int WARPS = NT / 32, GROUPS = ITEMS / 4;
  __shared__ A warp_tot[WARPS];
  __shared__ int tile_id;
  if (threadIdx.x == 0) {
    const int t = static_cast<int>(atomicAdd(counter, 1u));
    if (t == n_tiles - 1) atomicExch(counter, 0u);  // every id is drawn
    tile_id = t;
  }
  __syncthreads();
  const int tile = tile_id;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long seg = static_cast<long long>(tile) * NT * ITEMS +
                        static_cast<long long>(warp) * 32 * ITEMS + 4 * lane;
  A v[ITEMS];
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const long long i = seg + 128 * g;
    if (kVec && i + 4 <= n) {
      const uint4 w = load4<kStream>(x + i);
      v[4 * g] = from_bits<A>(w.x);
      v[4 * g + 1] = from_bits<A>(w.y);
      v[4 * g + 2] = from_bits<A>(w.z);
      v[4 * g + 3] = from_bits<A>(w.w);
    } else {  // the ragged end, or an input not 16-byte aligned
#pragma unroll
      for (int c = 0; c < 4; ++c) v[4 * g + c] = i + c < n ? x[i + c] : A(0);
    }
  }
  // each group of four serially, the lanes of a group by shuffles, the
  // groups in order: v becomes the exclusive scan of the warp's span
  A run = A(0);  // the span's sum before group g, the same on every lane
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    A s = A(0);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const A e = v[4 * g + c];
      v[4 * g + c] = s;
      s += e;
    }
    const A inc = warp_inclusive(s, lane);
    A exc = __shfl_up_sync(FULL, inc, 1);
    if (lane == 0) exc = A(0);
    const A start = run + exc;
#pragma unroll
    for (int c = 0; c < 4; ++c) v[4 * g + c] = start + v[4 * g + c];
    run += __shfl_sync(FULL, inc, 31);
  }
  // the warps' spans, scanned by warp 0
  if (lane == 0) warp_tot[warp] = run;
  __syncthreads();
  if (warp == 0) {
    A w = lane < WARPS ? warp_tot[lane] : A(0);
    w = warp_inclusive(w, lane);
    if (lane < WARPS) warp_tot[lane] = w;
  }
  __syncthreads();
  const A total = warp_tot[WARPS - 1];
  const A before = warp == 0 ? A(0) : warp_tot[warp - 1];
  __syncthreads();  // look_back reuses warp_tot
  if (threadIdx.x == 0)
    publish(flags + tile,
            (static_cast<unsigned long long>(epoch) << 32) | to_bits(total));
  const A base = look_back<A, NT>(flags, tile, epoch, warp_tot) + before;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const long long i = seg + 128 * g;
    if (kVec && i + 4 <= n) {
      store4<kStream>(out + i, make_uint4(to_bits(base + v[4 * g]),
                                          to_bits(base + v[4 * g + 1]),
                                          to_bits(base + v[4 * g + 2]),
                                          to_bits(base + v[4 * g + 3])));
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (i + c < n) out[i + c] = base + v[4 * g + c];
    }
  }
}

template <typename A, int NT, int ITEMS>
cudaError_t run(const void* x, void* out, unsigned long long* flags,
                unsigned* counter, long long n, long long capacity,
                unsigned epoch, cudaStream_t stream) {
  constexpr long long TILE = NT * ITEMS;
  const long long n_tiles = (n + TILE - 1) / TILE;
  if (n_tiles > capacity) return cudaErrorInvalidValue;
  const A* in = static_cast<const A*>(x);
  A* o = static_cast<A*>(out);
  const bool vec = (reinterpret_cast<unsigned long long>(x) % 16 == 0) &&
                   (reinterpret_cast<unsigned long long>(out) % 16 == 0);
  const int blocks = static_cast<int>(n_tiles);
  constexpr bool kStream = ITEMS == 32;  // the big-input configuration
  if (vec)
    scan_kernel<A, NT, ITEMS, true, kStream><<<blocks, NT, 0, stream>>>(
        in, o, n, blocks, flags, counter, epoch);
  else
    scan_kernel<A, NT, ITEMS, false, kStream><<<blocks, NT, 0, stream>>>(
        in, o, n, blocks, flags, counter, epoch);
  return cudaGetLastError();
}

template <typename A>
cudaError_t run_sized(const void* x, void* out, unsigned long long* flags,
                      unsigned* counter, long long n, long long capacity,
                      unsigned epoch, cudaStream_t stream) {
  return n > BIG_N
             ? run<A, 256, 32>(x, out, flags, counter, n, capacity, epoch,
                               stream)
             : run<A, 256, 16>(x, out, flags, counter, n, capacity, epoch,
                               stream);
}

}  // namespace

// x, out: n elements of int32 (is_float = 0) or float32 (is_float = 1);
// scratch: 1 + capacity 64-bit words, the tile counter (in word 0) and one
// flag a tile; epoch: this call's, never 0 and new on this scratch.
extern "C" int pt_scan(int device, const void* x, void* out, void* scratch,
                       long long capacity, int n, int is_float,
                       unsigned epoch, void* stream) {
  if (n <= 0) return 0;
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* counter = static_cast<unsigned*>(scratch);
  unsigned long long* flags = static_cast<unsigned long long*>(scratch) + 1;
  const cudaError_t err =
      is_float
          ? run_sized<float>(x, out, flags, counter, n, capacity, epoch, s)
          : run_sized<unsigned>(x, out, flags, counter, n, capacity, epoch,
                                s);
  return static_cast<int>(err);
}
