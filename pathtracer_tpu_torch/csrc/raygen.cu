// Raygen: the camera's draws, the AA jitter, the pinhole and thin-lens rays
// and the fresh path state of every lane of the pool, in one launch an
// iteration.
//
// Replaces the TPU kernel that XLA fused from the JAX package's raygen
// (pathtracer_tpu/engine/wavefront.py generate_paths, with
// pathtracer_tpu/ops/camera.py and ops/rng.py): the JAX package has no
// Pallas kernel here. The port's plain twin, ops/camera.py raygen_plain, is
// the pixel map's index math, the int64 PCG hash of the AA normals and the
// lens uniforms, Box-Muller, the pinhole direction, the concentric disk, the
// thin lens and the new state's fills: about 220 small elementwise kernels an
// iteration (260 with the tile map), each reading its operands from memory
// and writing its result back. This kernel is one launch an iteration.
//
// Bit for bit the plain twin's outputs on every lane:
//   - The pixel id is RenderSettings.pixel_map's of lane + pixel_offset: the
//     shard interleave's granule round-robin, then the tile map, in int64.
//   - The draws: the AA normals from depth -1's key, the lens uniforms from
//     depth -2's (pt::pixel_state, pt::hash_uniform), Box-Muller's
//     sqrtf(-2 * logf(max(u0, 1e-12))) times cosf / sinf of 2pi * u1, in
//     uint32 registers; the keys read on the device where they are tensors
//     (the compiled frame), else passed as values. With HASH off (the
//     threefry streams) the lane reads the four planes the engine drew.
//   - The camera, as ops/camera.py generate_camera_rays computes it: the
//     jitter clamp, view - right * sx - up * sy, normalize's
//     rsqrtf(max(|v|^2, 1e-30)), the focal point by IEEE division, the
//     concentric disk with its IEEE sy / sx, the lens origin and the
//     lens_radius > 0 select. The same operations on the same values in the
//     same order; logf, sqrtf, cosf, sinf and rsqrtf are what torch's
//     elementwise kernels call. The library is built with -fmad=false and
//     without fast math (common.cuh), so nothing is contracted.
//   - torch.clamp propagates NaN, so do pt::nan_max / nan_min here.
//   - The constants are the plain twin's Python doubles cast to float, as
//     torch casts a scalar operand to the tensor's float32 (2pi, pi / 4,
//     pi / 2, 0.005, 1e-6, 1e-12).
//   - The camera is read from device memory on every launch, never baked
//     into the launch: a captured graph draws the camera that its replay
//     finds (the interactive viewer writes it in place between frames).
//
// Template flags: JITTER, DOF (RenderSettings.jitter / dof), HASH (the fast
// RNG, else the threefry planes), TILE and INTERLEAVE (the pixel map's
// forms): one source adapts to each scene's settings.
//
// What bounds it on an H100: bytes. A lane reads nothing of its own with the
// hash (the camera, 17 floats, is one broadcast a warp) and writes its
// origin and direction (24 B), the throughput's one (4 B, shared by the
// three colour planes as in the plain twin), remaining_bounces (4 B) and its
// lane id (int64, 8 B): 40 B a lane, 25.6 MB for 640,000 lanes, 7.6 us at
// 3.35 TB/s; the threefry form reads 16 B more. The arithmetic is ~60
// integer operations a hash draw (four draws), a logf, a sqrtf, two
// sincos, two rsqrtf and a few dozen multiplies: of the same order as the
// stores on an H100. Design: one thread a lane, coalesced stores of the
// planes, no shared memory and no barrier; the camera's scalars read by
// every thread of a warp at one address through the read-only path.
#include <array>
#include <utility>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
// the plain twin's Python constants as torch casts them to float32
constexpr double PI_D = 3.1415926535897932384626422832795028841971;
constexpr float TWO_PI = static_cast<float>(2.0 * 3.141592653589793);
constexpr float PI_4 = static_cast<float>(PI_D / 4.0);
constexpr float PI_2 = static_cast<float>(PI_D / 2.0);
constexpr float JITTER_SIGMA = static_cast<float>(0.005);
constexpr float U_MIN = static_cast<float>(1e-12);
constexpr float EPS6 = static_cast<float>(1e-6);

using pt::add;
using pt::dot;
using pt::normalize;
using pt::scale;
using pt::sub;
using pt::V3;

struct CameraArgs {
  // CameraArrays: [3] vectors, [2] pixel_length, 0-d lens and focus
  const float* position;
  const float* view;
  const float* up;
  const float* right;
  const float* pixel_length;
  const float* lens_radius;
  const float* focal_distance;
  // the draws: depth -1's and -2's keys (on the device where set), or the
  // threefry planes (AA normals x, y; lens uniforms 1, 2)
  const long long* key_aa_dev;
  unsigned key_aa_host;
  const long long* key_lens_dev;
  unsigned key_lens_host;
  const float* planes[4];
  // the pixel map: image, the shard's first lane, the tile, the interleave
  int width;
  int height;
  long long offset;
  int tile_h;
  int tile_w;
  long long shards;
  long long n_local;
  long long granule;
  int trace_depth;
  // the outputs
  float* ox;
  float* oy;
  float* oz;
  float* dx;
  float* dy;
  float* dz;
  float* one;
  int* rb;
  long long* lane;
  int n;
};

__device__ __forceinline__ V3 load3(const float* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2)};
}

// torch.clamp(v, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return pt::nan_min(pt::nan_max(v, lo), hi);
}

// RenderSettings.pixel_map: lane -> pixel id
template <bool TILE, bool INTERLEAVE>
__device__ __forceinline__ long long pixel_of(const CameraArgs& a,
                                              long long lane) {
  if (INTERLEAVE) {
    const long long l = lane % a.n_local, s = lane / a.n_local;
    const long long q = l / a.granule, r = l % a.granule;
    lane = (q * a.shards + s) * a.granule + r;
  }
  if (!TILE) return lane;
  const long long tsz = static_cast<long long>(a.tile_h) * a.tile_w;
  const long long tiles_x = a.width / a.tile_w;
  const long long t = lane / tsz, r = lane % tsz;
  const long long py = (t / tiles_x) * a.tile_h + r / a.tile_w;
  const long long px = (t % tiles_x) * a.tile_w + r % a.tile_w;
  return py * a.width + px;
}

// ops/camera.py concentric_sample_disk, for the branch the lane takes
__device__ __forceinline__ void concentric_disk(float u1, float u2,
                                                float& lx, float& ly) {
  const float sx = 2.0f * u1 - 1.0f;
  const float sy = 2.0f * u2 - 1.0f;
  const bool use_x = fabsf(sx) > fabsf(sy);
  float r = use_x ? sx : sy;
  const float theta =
      use_x ? PI_4 * (sy / (sx == 0.0f ? 1.0f : sx))
            : PI_2 - PI_4 * (sx / (sy == 0.0f ? 1.0f : sy));
  if (sx == 0.0f && sy == 0.0f) r = 0.0f;
  lx = r * cosf(theta);
  ly = r * sinf(theta);
}

template <bool JITTER, bool DOF, bool HASH, bool TILE, bool INTERLEAVE>
__global__ void __launch_bounds__(THREADS) pt_camera_paths(
    const CameraArgs a) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const long long pixel = pixel_of<TILE, INTERLEAVE>(a, i + a.offset);
  const float x = static_cast<float>(pixel % a.width);
  const float y = static_cast<float>(pixel / a.width);

  float px = x, py = y;
  if (JITTER) {
    float n0, n1;
    if (HASH) {
      // ops/rng.py fast_normals_perlane: Box-Muller on draws 0 and 1
      const unsigned s = pt::pixel_state(
          pt::depth_key(a.key_aa_dev, a.key_aa_host), pixel);
      const float u0 = pt::hash_uniform(s, 0u);
      const float u1 = pt::hash_uniform(s, 1u);
      const float r = sqrtf(-2.0f * logf(pt::nan_max(u0, U_MIN)));
      const float theta = TWO_PI * u1;
      n0 = r * cosf(theta);
      n1 = r * sinf(theta);
    } else {
      n0 = a.planes[0][i];
      n1 = a.planes[1][i];
    }
    px = x + clamp(n0 * JITTER_SIGMA, -0.5f, 0.5f);
    py = y + clamp(n1 * JITTER_SIGMA, -0.5f, 0.5f);
  }

  const V3 view = load3(a.view);
  const V3 right = load3(a.right);
  const V3 up = load3(a.up);
  const V3 pos = load3(a.position);
  const float sx = __ldg(a.pixel_length) * (px - 0.5f * a.width);
  const float sy = __ldg(a.pixel_length + 1) * (py - 0.5f * a.height);
  V3 d = normalize(sub(sub(view, scale(right, sx)), scale(up, sy)));
  V3 o = pos;

  if (DOF) {
    float u1, u2;
    if (HASH) {
      const unsigned s = pt::pixel_state(
          pt::depth_key(a.key_lens_dev, a.key_lens_host), pixel);
      u1 = pt::hash_uniform(s, 0u);
      u2 = pt::hash_uniform(s, 1u);
    } else {
      u1 = a.planes[2][i];
      u2 = a.planes[3][i];
    }
    const float lens_radius = __ldg(a.lens_radius);
    if (lens_radius > 0.0f) {
      float denom = dot(d, view);
      if (fabsf(denom) < EPS6) denom = denom >= 0.0f ? EPS6 : -EPS6;
      const float t_focus = __ldg(a.focal_distance) / denom;
      const V3 p_focus = add(pos, scale(d, t_focus));
      float lx, ly;
      concentric_disk(u1, u2, lx, ly);
      lx = lx * lens_radius;
      ly = ly * lens_radius;
      o = add(add(pos, scale(right, lx)), scale(up, ly));
      d = normalize(sub(p_focus, o));
    }
  }

  a.ox[i] = o.x;
  a.oy[i] = o.y;
  a.oz[i] = o.z;
  a.dx[i] = d.x;
  a.dy[i] = d.y;
  a.dz[i] = d.z;
  a.one[i] = 1.0f;
  a.rb[i] = a.trace_depth;
  a.lane[i] = i;
}

using Kernel = void (*)(CameraArgs);

template <int F>
constexpr Kernel instance() {
  return pt_camera_paths<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0,
                         (F & 8) != 0, (F & 16) != 0>;
}

template <int... F>
constexpr std::array<Kernel, sizeof...(F)> instances(
    std::integer_sequence<int, F...>) {
  return {instance<F>()...};
}

}  // namespace

// flags: 1 jitter, 2 dof, 4 the hash draws (else threefry planes), 8 the
// tile map, 16 the shard interleave
extern "C" int pt_camera(int device, int flags, const void* position,
                         const void* view, const void* up, const void* right,
                         const void* pixel_length, const void* lens_radius,
                         const void* focal_distance, const void* key_aa_dev,
                         unsigned key_aa_host, const void* key_lens_dev,
                         unsigned key_lens_host, const void* p0,
                         const void* p1, const void* p2, const void* p3,
                         int width, int height, long long offset, int tile_h,
                         int tile_w, long long shards, long long n_local,
                         long long granule, int trace_depth, void* ox,
                         void* oy, void* oz, void* dx, void* dy, void* dz,
                         void* one, void* rb, void* lane, int n,
                         void* stream) {
  static const std::array<Kernel, 32> kernels =
      instances(std::make_integer_sequence<int, 32>{});
  if (n <= 0) return 0;
  if (flags < 0 || flags >= 32) return static_cast<int>(cudaErrorInvalidValue);
  // the library has its own CUDA runtime: select the tensors' device
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto w = [](void* p) { return static_cast<float*>(p); };
  auto k = [](const void* p) { return static_cast<const long long*>(p); };
  CameraArgs a{f(position), f(view), f(up), f(right), f(pixel_length),
               f(lens_radius), f(focal_distance), k(key_aa_dev), key_aa_host,
               k(key_lens_dev), key_lens_host, {f(p0), f(p1), f(p2), f(p3)},
               width, height, offset, tile_h, tile_w, shards, n_local,
               granule, trace_depth, w(ox), w(oy), w(oz), w(dx), w(dy), w(dz),
               w(one), static_cast<int*>(rb), static_cast<long long*>(lane),
               n};
  const int blocks = (n + THREADS - 1) / THREADS;
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kernels[flags]), dim3(blocks),
      dim3(THREADS), params, 0, static_cast<cudaStream_t>(stream)));
}
