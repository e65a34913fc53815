// Shade: the bounce's draws, material fetch and scatter for every lane of
// the pool, in one launch.
//
// Replaces the TPU kernel that XLA fused from the JAX package's draws and
// shade (pathtracer_tpu/ops/rng.py, pathtracer_tpu/ops/bsdf.py shade): the
// JAX package has no Pallas kernel here. The port's plain twin, ops/bsdf.py
// shade with its draws (ops/rng.py IterationRng.uniforms), is the int64 PCG
// hash of the 4-5 uniforms, gather_material, the scatter_ray select tree and
// the where chains on colour and remaining_bounces: some 250-500 small
// kernels a bounce, each reading its operands from memory and writing its
// result back. This kernel is one launch a bounce.
//
// Bit for bit the plain twin's outputs on every lane:
//   - The same operations on the same values in the same order: Vec3's dot
//     as x*x' + y*y' + z*z' left to right, cross with its one-hot operand's
//     zeros multiplied out, normalize's rsqrtf(max(|v|^2, 1e-30)) (torch.rsqrt
//     is rsqrtf), Schlick's pow5 as (m2*m2)*m, sqrtf, cosf and sinf (what
//     torch's elementwise kernels call), IEEE division. The library is built
//     with -fmad=false and without fast math (common.cuh), so nothing is
//     contracted.
//   - torch.clamp / maximum propagate NaN, so do pt::nan_max here.
//   - The select tree computes every branch for every lane and picks one;
//     here a lane computes the branch it takes, by the same operations, so
//     the picked value has the same bits. That includes the branch
//     probability surrogate's forward value, p / max(p, 1e-6), which is not
//     exactly 1 where p < 1e-6.
//   - The draws: the lane's state is pcg(key ^ pixel * 0xC2B2AE35) and draw
//     j is the top 24 bits of pcg(state + j * 0x9E3779B9) scaled by 2^-24,
//     in uint32 registers (ops/rng.py _pixel_mix, fast_uniforms_perlane). A
//     lane draws only the uniforms its branch reads. The key is the depth's
//     (IterationRng.depth_key): a host value, or read on the device, so a
//     captured graph draws each replay's iteration. With FAST off (the
//     threefry streams) the lane reads the planes the engine drew.
//   - The constants are the plain twin's Python doubles cast to float, as
//     torch casts a scalar operand to the tensor's float32.
//   - Lanes with remaining_bounces <= 0 on entry are copied through.
//
// Template flags: FAST (the hash, else uniform planes), GLOSSY and REFR (the
// scene's any_glossy / any_refractive: a material of a branch left out
// shades diffuse, as in the plain twin), RR (Russian roulette: a fifth
// uniform; rr_on says whether the bounce's depth reaches rr_start) and QUIRK
// (depth_quirk).
//
// What bounds it on an H100: bytes. A live lane reads origin, direction and
// colour (36 B), remaining_bounces, t and the material id (12 B), the normal
// (12 B) and its pixel id (8 B), and writes origin, direction, colour and
// remaining_bounces (40 B): 108 B a lane, 69 MB for 640,000 lanes, 20.6 us
// at 3.35 TB/s. The arithmetic (~60 integer operations a draw's hash, two
// sqrtf, a sincos, two rsqrtf and a few dozen multiplies on the diffuse
// branch) is of the same order. Design: one thread a lane, coalesced loads
// and stores of the planes, the material table (10 floats a material)
// staged in shared memory once a block, so lanes of divergent materials read
// it without memory traffic.
#include <array>
#include <utility>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAT_FIELDS = 10;  // colour 3, specular 3, reflective,
                                // refractive, ior, emittance
// the plain twin's Python constants as torch casts them to float32
constexpr float SCATTER_EPS = static_cast<float>(1e-3);
constexpr float TWO_PI = static_cast<float>(
    6.2831853071795864769252867665590057683943);
constexpr float SQRT_OF_ONE_THIRD = static_cast<float>(
    0.5773502691896257645091487805019574556476);
constexpr float LUMA_R = static_cast<float>(0.2126);
constexpr float LUMA_G = static_cast<float>(0.7152);
constexpr float LUMA_B = static_cast<float>(0.0722);
constexpr float ROUGH_BIAS = static_cast<float>(0.2);
constexpr float EPS6 = static_cast<float>(1e-6);
constexpr float TIR_LEN2 = static_cast<float>(1e-16);
constexpr float RR_MIN = static_cast<float>(0.05);

using pt::add;
using pt::dot;
using pt::mul;
using pt::normalize;
using pt::scale;
using pt::sub;
using pt::V3;

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
// ops/bsdf.py reflect
__device__ __forceinline__ V3 reflect(V3 d, V3 n) {
  return sub(d, scale(n, dot(d, n) * 2.0f));
}
__device__ __forceinline__ float luma(V3 c) {
  return c.x * LUMA_R + c.y * LUMA_G + c.z * LUMA_B;
}
// _branch_prob_surrogate's forward value for the taken branch
__device__ __forceinline__ float surrogate(bool took_first, float p) {
  if (took_first) return p / pt::nan_max(p, EPS6);
  return (1.0f - p) / pt::nan_max(1.0f - p, EPS6);
}

// The lane's uniforms: draw j of the hash state, or plane j.
template <bool FAST>
struct Draws {
  unsigned state;
  const float* const* planes;
  int lane;
  __device__ __forceinline__ float operator()(unsigned j) const {
    if (FAST) {
      return pt::hash_uniform(state, j);
    }
    return planes[j][lane];
  }
};

// ops/bsdf.py cosine_hemisphere
__device__ __forceinline__ V3 cosine_hemisphere(V3 n, float u1, float u2) {
  const float up = sqrtf(u1);
  const float over = sqrtf(pt::nan_max(1.0f - up * up, 0.0f));
  const float around = u2 * TWO_PI;
  const bool ax = fabsf(n.x) < SQRT_OF_ONE_THIRD;
  const bool ay = fabsf(n.y) < SQRT_OF_ONE_THIRD;
  const V3 not_normal{ax ? 1.0f : 0.0f, ax ? 0.0f : (ay ? 1.0f : 0.0f),
                      (ax || ay) ? 0.0f : 1.0f};
  const V3 p1 = normalize(cross(n, not_normal));
  const V3 p2 = normalize(cross(n, p1));
  return add(add(scale(n, up), scale(p1, cosf(around) * over)),
             scale(p2, sinf(around) * over));
}

struct ShadeArgs {
  // the material table, [M, 3] colour and specular, [M] the others
  const float* color;
  const float* specular;
  const float* reflective;
  const float* refractive;
  const float* ior;
  const float* emittance;
  int n_mats;
  // the lanes
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  const float* cx;
  const float* cy;
  const float* cz;
  const int* rb;
  const float* t;
  const float* nx;
  const float* ny;
  const float* nz;
  const int* mat;
  // the draws: the depth key (on the device where key_dev is set) and the
  // lanes' pixel ids, or the uniform planes
  const long long* key_dev;
  unsigned key_host;
  const long long* pixel;
  const float* planes[5];
  int rr_on;
  // the outputs
  float* o_ox;
  float* o_oy;
  float* o_oz;
  float* o_dx;
  float* o_dy;
  float* o_dz;
  float* o_cx;
  float* o_cy;
  float* o_cz;
  int* o_rb;
  int n;
};

template <bool FAST, bool GLOSSY, bool REFR, bool RR, bool QUIRK>
__global__ void __launch_bounds__(THREADS) pt_shade_lanes(const ShadeArgs a) {
  extern __shared__ float table[];
  const int m_count = a.n_mats;
  float* s_color = table;
  float* s_spec = table + 3 * m_count;
  float* s_refl = table + 6 * m_count;
  float* s_refr = table + 7 * m_count;
  float* s_ior = table + 8 * m_count;
  float* s_emit = table + 9 * m_count;
  for (int k = threadIdx.x; k < 3 * m_count; k += THREADS) {
    s_color[k] = a.color[k];
    s_spec[k] = a.specular[k];
  }
  for (int k = threadIdx.x; k < m_count; k += THREADS) {
    s_refl[k] = a.reflective[k];
    s_refr[k] = a.refractive[k];
    s_ior[k] = a.ior[k];
    s_emit[k] = a.emittance[k];
  }
  __syncthreads();
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;

  const V3 o{a.ox[i], a.oy[i], a.oz[i]};
  const V3 d{a.dx[i], a.dy[i], a.dz[i]};
  const V3 c{a.cx[i], a.cy[i], a.cz[i]};
  const int rb = a.rb[i];
  V3 new_o = o, new_d = d, new_c = c;
  int new_rb = rb;

  if (rb > 0) {
    const float t = a.t[i];
    const int mid = max(a.mat[i], 0);
    const float emit = s_emit[mid];
    const bool hit = t > 0.0f;
    const bool emissive = hit && emit > 0.0f;
    const V3 mcol{s_color[3 * mid], s_color[3 * mid + 1],
                  s_color[3 * mid + 2]};
    if (!hit) {
      new_c = {0.0f, 0.0f, 0.0f};  // background black
      new_rb = 0;
    } else if (emissive) {
      new_c = scale(mul(c, mcol), emit);
      new_rb = 0;
    } else {
      Draws<FAST> u{0u, a.planes, i};
      if (FAST) {
        u.state = pt::pixel_state(pt::depth_key(a.key_dev, a.key_host),
                                  a.pixel[i]);
      }
      const V3 n{a.nx[i], a.ny[i], a.nz[i]};
      const V3 spec{s_spec[3 * mid], s_spec[3 * mid + 1],
                    s_spec[3 * mid + 2]};
      const float refl = s_refl[mid];
      const float refr = s_refr[mid];
      const V3 hit_point = add(o, scale(d, t));
      V3 thr;
      if (REFR && refr != 0.0f) {
        const float cos_i0 = -dot(d, n);
        const bool entering = cos_i0 > 0.0f;
        const V3 r_n = scale(n, entering ? 1.0f : -1.0f);
        const float cos_i = fabsf(cos_i0);
        const float m_ior = s_ior[mid];
        const float ior = m_ior > 0.0f ? m_ior : 1.0f;
        const float ior_from = entering ? 1.0f : ior;
        const float ior_to = entering ? ior : 1.0f;
        const float eta = ior_from / ior_to;
        // fresnel_schlick
        float r0 = (ior_from - ior_to) / (ior_from + ior_to);
        r0 = r0 * r0;
        const float m = pt::nan_max(1.0f - cos_i, 0.0f);
        const float m2 = m * m;
        const float reflect_prob = r0 + (1.0f - r0) * (m2 * m2 * m);
        // refract: zero on total internal reflection
        const float cos_r = -dot(d, r_n);
        const float k = 1.0f - eta * eta * (1.0f - cos_r * cos_r);
        V3 refr_dir{0.0f, 0.0f, 0.0f};
        if (!(k < EPS6)) {
          const float coeff = eta * cos_r - sqrtf(k);
          refr_dir = add(scale(d, eta), scale(r_n, coeff));
        }
        const bool tir = dot(refr_dir, refr_dir) < TIR_LEN2;
        const bool do_reflect = tir || u(3) < reflect_prob;
        if (do_reflect) {
          new_d = normalize(reflect(d, r_n));
          new_o = add(hit_point, scale(r_n, SCATTER_EPS));
          thr = spec;
        } else {
          new_d = normalize(refr_dir);
          new_o = sub(hit_point, scale(r_n, SCATTER_EPS));
          thr = mcol;
        }
        thr = scale(thr, tir ? 1.0f : surrogate(do_reflect, reflect_prob));
      } else {
        new_o = add(hit_point, scale(n, SCATTER_EPS));
        if (GLOSSY && refl != 0.0f && refr == 0.0f) {
          const float roughness = 1.0f - refl;
          const float diffuse_luma = luma(mcol) * (roughness + ROUGH_BIAS);
          const float specular_luma = luma(spec) * (1.0f - roughness);
          const float p_diffuse =
              diffuse_luma / (diffuse_luma + specular_luma + EPS6);
          const bool take_diffuse = u(0) < p_diffuse;
          if (take_diffuse) {
            new_d = cosine_hemisphere(n, u(1), u(2));
            thr = mcol;
          } else {
            new_d = normalize(reflect(d, n));
            thr = spec;
          }
          thr = scale(thr, surrogate(take_diffuse, p_diffuse));
        } else {
          new_d = cosine_hemisphere(n, u(1), u(2));
          thr = mcol;
        }
      }
      new_c = mul(c, thr);
      new_rb = rb - 1;
      if (RR && a.rr_on) {
        // torch.clamp(maximum(x, maximum(y, z)), 0.05, 1): NaN stays NaN
        const float v = pt::nan_max(new_c.x, pt::nan_max(new_c.y, new_c.z));
        const float p = v != v ? v : fminf(fmaxf(v, RR_MIN), 1.0f);
        if (u(4) >= p) {
          new_rb = -2;
        } else {
          new_c = scale(new_c, 1.0f / p);
        }
      }
      if (!QUIRK && new_rb == 0) new_rb = -2;  // exhausted: dies unlit
    }
  }
  a.o_ox[i] = new_o.x;
  a.o_oy[i] = new_o.y;
  a.o_oz[i] = new_o.z;
  a.o_dx[i] = new_d.x;
  a.o_dy[i] = new_d.y;
  a.o_dz[i] = new_d.z;
  a.o_cx[i] = new_c.x;
  a.o_cy[i] = new_c.y;
  a.o_cz[i] = new_c.z;
  a.o_rb[i] = new_rb;
}

using Kernel = void (*)(ShadeArgs);

template <int F>
constexpr Kernel instance() {
  return pt_shade_lanes<(F & 1) != 0, (F & 2) != 0, (F & 4) != 0,
                        (F & 8) != 0, (F & 16) != 0>;
}

template <int... F>
constexpr std::array<Kernel, sizeof...(F)> instances(
    std::integer_sequence<int, F...>) {
  return {instance<F>()...};
}

}  // namespace

// flags: 1 the hash draws (else uniform planes), 2 any_glossy,
// 4 any_refractive, 8 Russian roulette, 16 depth_quirk
extern "C" int pt_shade(int device, int flags, const void* color,
                        const void* specular, const void* reflective,
                        const void* refractive, const void* ior,
                        const void* emittance, int n_mats, const void* ox,
                        const void* oy, const void* oz, const void* dx,
                        const void* dy, const void* dz, const void* cx,
                        const void* cy, const void* cz, const void* rb,
                        const void* t, const void* nx, const void* ny,
                        const void* nz, const void* mat, const void* key_dev,
                        unsigned key_host, const void* pixel, const void* u0,
                        const void* u1, const void* u2, const void* u3,
                        const void* u4, int rr_on, void* o_ox, void* o_oy,
                        void* o_oz, void* o_dx, void* o_dy, void* o_dz,
                        void* o_cx, void* o_cy, void* o_cz, void* o_rb, int n,
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
  ShadeArgs a{f(color), f(specular), f(reflective), f(refractive), f(ior),
              f(emittance), n_mats, f(ox), f(oy), f(oz), f(dx), f(dy), f(dz),
              f(cx), f(cy), f(cz), static_cast<const int*>(rb), f(t), f(nx),
              f(ny), f(nz), static_cast<const int*>(mat),
              static_cast<const long long*>(key_dev), key_host,
              static_cast<const long long*>(pixel),
              {f(u0), f(u1), f(u2), f(u3), f(u4)}, rr_on, w(o_ox), w(o_oy),
              w(o_oz), w(o_dx), w(o_dy), w(o_dz), w(o_cx), w(o_cy), w(o_cz),
              static_cast<int*>(o_rb), n};
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = sizeof(float) * MAT_FIELDS * n_mats;
  void* params[] = {&a};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kernels[flags]), dim3(blocks),
      dim3(THREADS), params, smem, static_cast<cudaStream_t>(stream)));
}
