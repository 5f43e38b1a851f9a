// Path trace of a sphere scene on Hopper (sm_90a): one thread per pixel.
//
// Replaces the TPU kernel
//   ray_tracing_extended_tpu/kernels/megakernel.py::_render_kernel
// for sphere-only scenes with exactly spp samples per pixel. It computes
// what that kernel computes: per pixel and frame, the PCG stream seeded
// pix + frame * 719393, the thin-lens camera ray (4 draws), the bounce loop
// (closest sphere hit, checker / invisible-light flags, the specular-lottery
// scatter with the dielectric extension, 7 draws, and Russian roulette,
// 1 draw; the environment light on a miss), the mean over spp, and the fold
// into a running average with weight 1 / (f32(frame) + 1). It also counts
// each pixel's live path segments and, on request, the live paths per
// bounce index. The arithmetic follows the plain PyTorch version
// (ops/*.py) operation for operation; built with -fmad=false, no multiply
// and add fuse, so the two differ only where the sphere test's form does
// (this kernel tests in the direct o - c form, as the TPU kernel does) and
// where the device's transcendentals round differently.
//
// What bounds it on this card: FP32 ALU throughput of the brute-force
// sphere scan, about pixels x spp x ~1.7 segments x spheres pair tests
// (RTIOW at 1080p, 16 spp: ~2.7e10 tests a frame), plus warp divergence
// between long and short paths in one warp.
// What this first version does about it: nothing yet beyond keeping the
// sphere table in shared memory, loaded once per block and read as
// warp-wide broadcasts. No culling, no BVH, no path regeneration.
//
// C interface, loaded with ctypes (kernels/megakernel.py):
//   rtx_render_spheres(...) launches on the given stream and returns
//   cudaGetLastError(); rtx_error_string(code) names an error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 8;

// params layout (f32, kParams):
//   0-2 camera position   3-11 camera rotation, row-major (columns are
//   right, up, forward)   12 plane_w  13 plane_h  14 focus distance
//   15 defocus disc radius  16 diverge disc radius  17 environment on
//   18-20 ground  21-23 horizon  24-26 zenith  27 sun focus
//   28 sun intensity  29-31 sun direction
constexpr int kParams = 32;
// sphere table row: cx, cy, cz, r^2, r
constexpr int kSph = 5;
// material table row: colour 0-2, emission colour 3-5, specular colour
// 6-8, emission strength 9, smoothness 10, specular probability 11,
// ior 12, flag 13, pad 14-15
constexpr int kMat = 16;

constexpr int kFlagChecker = 1;
constexpr int kFlagInvisibleLight = 2;
constexpr int kFlagDielectric = 3;

// f32(1) / f32(2^32 - 1): the f32 literal rounds to 2^32, as in HLSL.
constexpr float kInvU32Max = 1.0f / 4294967296.0f;
constexpr uint32_t kFrameSeedStride = 719393u;

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 add(Vec3 a, Vec3 b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Vec3 sub(Vec3 a, Vec3 b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Vec3 scale(Vec3 a, float s) {
  return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ float dot(Vec3 a, Vec3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ Vec3 normalize(Vec3 v) {
  return scale(v, rsqrtf(dot(v, v)));
}
// HLSL reflect: i - (2 dot(i, n)) n
__device__ __forceinline__ Vec3 reflect(Vec3 i, Vec3 n) {
  return sub(i, scale(n, 2.0f * dot(i, n)));
}
// HLSL lerp: a + t (b - a)
__device__ __forceinline__ Vec3 lerp(Vec3 a, Vec3 b, float t) {
  return add(a, scale(sub(b, a), t));
}
__device__ __forceinline__ Vec3 mul(Vec3 a, Vec3 b) {
  return {a.x * b.x, a.y * b.y, a.z * b.z};
}

// ---- PCG (RayTracing.shader:193-230) ----

__device__ __forceinline__ uint32_t next_random(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  const uint32_t shift = (state >> 28) + 4u;
  const uint32_t r = ((state >> shift) ^ state) * 277803737u;
  return (r >> 22) ^ r;
}

// u32 -> f32 rounds to nearest, like XLA's and PyTorch's conversions.
__device__ __forceinline__ float random_value(uint32_t& state) {
  return __uint2float_rn(next_random(state)) * kInvU32Max;
}

// Box-Muller, cos branch; log(0) = -inf is kept, as in the reference.
__device__ __forceinline__ float random_normal(uint32_t& state) {
  const float r1 = random_value(state);
  const float r2 = random_value(state);
  const float theta = (2.0f * 3.1415926f) * r1;
  const float rho = sqrtf(-2.0f * logf(r2));
  return rho * cosf(theta);
}

__device__ __forceinline__ Vec3 random_direction(uint32_t& state) {
  const float x = random_normal(state);
  const float y = random_normal(state);
  const float z = random_normal(state);
  const float inv = rsqrtf(x * x + y * y + z * z);
  return {x * inv, y * inv, z * inv};
}

// Uniform point in the unit disc, scaled by `radius_scale`.
__device__ __forceinline__ void random_point_in_circle(
    uint32_t& state, float radius_scale, float& cx, float& cy) {
  const float r1 = random_value(state);
  const float angle = r1 * 2.0f * 3.1415f;
  const float r2 = random_value(state);
  const float radius = sqrtf(r2);
  cx = cosf(angle) * radius * radius_scale;
  cy = sinf(angle) * radius * radius_scale;
}

// ---- environment (RayTracing.shader:238-251) ----

__device__ __forceinline__ float smoothstep01(float t) {
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  return t * t * (3.0f - 2.0f * t);
}

__device__ Vec3 environment(const float* p, Vec3 d) {
  const float sky_t = powf(smoothstep01((d.y - 0.0f) / 0.4f), 0.35f);
  const float ground_t = smoothstep01((d.y - (-0.01f)) / 0.01f);
  const Vec3 ground = {p[18], p[19], p[20]};
  const Vec3 horizon = {p[21], p[22], p[23]};
  const Vec3 zenith = {p[24], p[25], p[26]};
  const Vec3 sun_dir = {p[29], p[30], p[31]};
  const Vec3 sky = lerp(horizon, zenith, sky_t);
  const float sun = powf(fmaxf(dot(d, sun_dir), 0.0f), p[27]) * p[28];
  Vec3 c = lerp(ground, sky, ground_t);
  const float sun_on = sun * (ground_t >= 1.0f ? 1.0f : 0.0f);
  c = {c.x + sun_on, c.y + sun_on, c.z + sun_on};
  return scale(c, p[17]);
}

// RTIOW dielectric direction (ops/materials.py _refract_dir).
__device__ Vec3 refract_dir(Vec3 d, Vec3 n, float ior, float u_fresnel) {
  const bool entering = dot(d, n) < 0.0f;
  const Vec3 ne = entering ? n : Vec3{-n.x, -n.y, -n.z};
  const float eta = entering ? 1.0f / ior : ior;
  const float cos_t = fminf(-dot(d, ne), 1.0f);
  const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
  const bool cannot_refract = eta * sin_t > 1.0f;
  float r0 = (1.0f - eta) / (1.0f + eta);
  r0 = r0 * r0;
  const float schlick = r0 + (1.0f - r0) * powf(1.0f - cos_t, 5.0f);
  if (cannot_refract || schlick > u_fresnel) return reflect(d, ne);
  const Vec3 r_perp = scale(add(d, scale(ne, cos_t)), eta);
  const float k = fmaxf(1.0f - dot(r_perp, r_perp), 0.0f);
  return sub(r_perp, scale(ne, sqrtf(k)));
}

// One camera sample's path (ops/trace.py). Returns its incoming light.
__device__ Vec3 trace_path(const float* p, const float* sph, const int* sph_mat,
                           int n_sph, const float* __restrict__ mats,
                           int max_bounce, uint32_t& state, Vec3 o, Vec3 d,
                           int& segs, int* s_hist) {
  Vec3 incoming = {0.0f, 0.0f, 0.0f};
  Vec3 colour = {1.0f, 1.0f, 1.0f};
  for (int bounce = 0; bounce <= max_bounce; ++bounce) {
    ++segs;
    if (s_hist != nullptr) atomicAdd(&s_hist[bounce], 1);

    // closest hit: a strictly nearer root wins, so the first sphere wins
    // a tie; disc < 0, t < 0 and padding spheres (r <= 0) never hit
    float best_t = __int_as_float(0x7f800000);
    int best = -1;
    for (int i = 0; i < n_sph; ++i) {
      const float* s = sph + kSph * i;
      const Vec3 oc = {o.x - s[0], o.y - s[1], o.z - s[2]};
      const float b = dot(oc, d);
      const float cc = dot(oc, oc) - s[3];
      const float disc = b * b - cc;
      if (disc >= 0.0f && s[4] > 0.0f) {
        const float t = -b - sqrtf(disc);
        if (t >= 0.0f && t < best_t) {
          best_t = t;
          best = i;
        }
      }
    }
    if (best < 0) {
      incoming = add(incoming, mul(environment(p, d), colour));
      break;
    }

    const float* s = sph + kSph * best;
    const Vec3 point = add(o, scale(d, best_t));
    const Vec3 normal = normalize(sub(point, Vec3{s[0], s[1], s[2]}));
    const float* m = mats + kMat * sph_mat[best];
    const int flag = static_cast<int>(__ldg(m + 13));

    if (flag == kFlagInvisibleLight && bounce == 0) {
      o = add(point, scale(d, 0.001f));  // camera rays pass through
      continue;
    }

    Vec3 base = {__ldg(m + 0), __ldg(m + 1), __ldg(m + 2)};
    if (flag == kFlagChecker) {
      const float fx = floorf(point.x);
      const float fz = floorf(point.z);
      const float cx = fx - 2.0f * floorf(fx / 2.0f);
      const float cz = fz - 2.0f * floorf(fz / 2.0f);
      if (cx != cz) base = {__ldg(m + 3), __ldg(m + 4), __ldg(m + 5)};
    }

    // scatter (RayTracing.shader:325-330): 1 lottery draw + 6 direction
    const float u_spec = random_value(state);
    float is_spec = (__ldg(m + 11) >= u_spec) ? 1.0f : 0.0f;
    const Vec3 unit = random_direction(state);
    const Vec3 diffuse = normalize(add(normal, unit));
    const Vec3 specular = reflect(d, normal);
    const Vec3 surface = normalize(lerp(diffuse, specular, __ldg(m + 10) * is_spec));
    Vec3 new_d, new_o;
    if (flag == kFlagDielectric) {
      new_d = refract_dir(d, normal, __ldg(m + 12), u_spec);
      new_o = add(point, scale(new_d, 1e-4f));
      is_spec = 0.0f;  // dielectrics are tinted by colour only
    } else {
      new_d = surface;
      new_o = add(point, Vec3{0.0f, 0.0f, 0.0f});
    }

    // emission and throughput (RayTracing.shader:333-335)
    const Vec3 em = scale(Vec3{__ldg(m + 3), __ldg(m + 4), __ldg(m + 5)}, __ldg(m + 9));
    incoming = add(incoming, mul(em, colour));
    const Vec3 spec_c = {__ldg(m + 6), __ldg(m + 7), __ldg(m + 8)};
    const Vec3 col_hit = mul(colour, lerp(base, spec_c, is_spec));

    // Russian roulette (RayTracing.shader:337-342)
    const float prob = fmaxf(fmaxf(col_hit.x, col_hit.y), col_hit.z);
    const float u_rr = random_value(state);
    if (!(u_rr < prob)) break;
    colour = scale(col_hit, 1.0f / fmaxf(prob, 1e-30f));
    o = new_o;
    d = new_d;
  }
  return incoming;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
render_spheres_kernel(const float* __restrict__ sph_in,
                      const int* __restrict__ sph_mat_in, int n_sph,
                      const float* __restrict__ mats,
                      const float* __restrict__ params_in, int width,
                      int height, int spp, int max_bounce, uint32_t frame0,
                      int n_frames, const float* __restrict__ accum_in,
                      int clamp_accum, float* __restrict__ out,
                      int* __restrict__ segs_out, int* __restrict__ hist) {
  extern __shared__ float smem[];
  float* p = smem;
  float* sph = p + kParams;
  int* sph_mat = reinterpret_cast<int*>(sph + kSph * n_sph);
  int* s_hist = sph_mat + n_sph;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < kParams; i += n_threads) p[i] = params_in[i];
  for (int i = tid; i < kSph * n_sph; i += n_threads) sph[i] = sph_in[i];
  for (int i = tid; i < n_sph; i += n_threads) sph_mat[i] = sph_mat_in[i];
  for (int i = tid; i <= max_bounce; i += n_threads) s_hist[i] = 0;
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x < width && y < height) {
    const int pix = y * width + x;
    const Vec3 pos = {p[0], p[1], p[2]};
    const Vec3 right = {p[3], p[6], p[9]};
    const Vec3 up = {p[4], p[7], p[10]};

    // focus point: position + rotation @ (lx, ly, focus)
    const float u = (static_cast<float>(x) + 0.5f) / static_cast<float>(width);
    const float v = (static_cast<float>(y) + 0.5f) / static_cast<float>(height);
    const float lx = (u - 0.5f) * p[12];
    const float ly = (v - 0.5f) * p[13];
    const float focus = p[14];
    const Vec3 fp = {
        p[0] + (lx * p[3] + ly * p[4] + focus * p[5]),
        p[1] + (lx * p[6] + ly * p[7] + focus * p[8]),
        p[2] + (lx * p[9] + ly * p[10] + focus * p[11]),
    };

    int segs = 0;
    Vec3 acc = {0.0f, 0.0f, 0.0f};
    if (accum_in != nullptr) {
      acc = {accum_in[3 * pix], accum_in[3 * pix + 1], accum_in[3 * pix + 2]};
    }
    for (int k = 0; k < n_frames; ++k) {
      const uint32_t frame = frame0 + static_cast<uint32_t>(k);
      uint32_t state = static_cast<uint32_t>(pix) + frame * kFrameSeedStride;
      Vec3 total = {0.0f, 0.0f, 0.0f};
      for (int sample = 0; sample < spp; ++sample) {
        // raygen (RayTracing.shader:377-382): defocus disc on the origin,
        // diverge disc on the target
        float cx, cy, jx, jy;
        random_point_in_circle(state, p[15], cx, cy);
        const Vec3 origin = add(add(pos, scale(right, cx)), scale(up, cy));
        random_point_in_circle(state, p[16], jx, jy);
        const Vec3 target = add(add(fp, scale(right, jx)), scale(up, jy));
        const Vec3 dir = normalize(sub(target, origin));
        total = add(total, trace_path(p, sph, sph_mat, n_sph, mats, max_bounce,
                                      state, origin, dir, segs,
                                      hist != nullptr ? s_hist : nullptr));
      }
      const float n = static_cast<float>(spp);
      const Vec3 mean = {total.x / n, total.y / n, total.z / n};
      if (accum_in == nullptr) {
        acc = mean;
      } else {
        // ops/accumulate.py: prev (1 - w) + cur w, w = 1 / (frame + 1)
        const float w = 1.0f / (__uint2float_rn(frame) + 1.0f);
        const float keep = 1.0f - w;
        acc = {acc.x * keep + mean.x * w, acc.y * keep + mean.y * w,
               acc.z * keep + mean.z * w};
        if (clamp_accum) {
          acc = {fminf(fmaxf(acc.x, 0.0f), 1.0f), fminf(fmaxf(acc.y, 0.0f), 1.0f),
                 fminf(fmaxf(acc.z, 0.0f), 1.0f)};
        }
      }
    }
    out[3 * pix] = acc.x;
    out[3 * pix + 1] = acc.y;
    out[3 * pix + 2] = acc.z;
    segs_out[pix] = segs;
  }

  if (hist != nullptr) {
    __syncthreads();
    for (int i = tid; i <= max_bounce; i += n_threads) {
      if (s_hist[i] != 0) atomicAdd(&hist[i], s_hist[i]);
    }
  }
}

}  // namespace

extern "C" size_t rtx_shared_bytes(int n_sph, int max_bounce) {
  return sizeof(float) * (kParams + (kSph + 1) * static_cast<size_t>(n_sph) +
                          static_cast<size_t>(max_bounce) + 1);
}

extern "C" int rtx_render_spheres(
    const void* sph, const void* sph_mat, int n_sph, const void* mats,
    const void* params, int width, int height, int spp, int max_bounce,
    unsigned int frame0, int n_frames, const void* accum_in, int clamp_accum,
    void* out, void* segs, void* hist, void* stream) {
  const size_t smem = rtx_shared_bytes(n_sph, max_bounce);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        render_spheres_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((width + kBlockX - 1) / kBlockX,
                  (height + kBlockY - 1) / kBlockY);
  render_spheres_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sph), static_cast<const int*>(sph_mat), n_sph,
      static_cast<const float*>(mats), static_cast<const float*>(params), width,
      height, spp, max_bounce, frame0, n_frames,
      static_cast<const float*>(accum_in), clamp_accum,
      static_cast<float*>(out), static_cast<int*>(segs),
      static_cast<int*>(hist));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
