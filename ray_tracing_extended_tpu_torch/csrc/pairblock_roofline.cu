// The sphere pair-test block probe on Hopper (sm_90a): the isolated
// ceiling of the path-trace kernel's hot loop, without traversal, shading
// or occupancy effects of the real kernel.
//
// Replaces the TPU kernel tools/pairblock_roofline.py::_make_kernel (its
// measure's pallas_call, :286), one template instantiation per variant. It
// computes what that kernel computes: every program of the grid tests the
// same RS = 8 rows of 128 rays (the TPU kernel's ray index map is (0, 0))
// against the logical (NCL = 16, SUB = 32, 8) cluster table: per outer step
// `it` and visit v, cluster c's 32 spheres (centre in columns 0-2, r^2 in
// column 4) get the ray-sphere test tq = -b - sqrt(b^2 - cc), and the
// running best keeps the minimum of the wide encode (bits(tq) & ~2047) |
// idx over the hits (tq >= 0), idx = (c << 5) | sub. The variants:
//   full, nosqrt (sqrt replaced by * 0.5), noenc (plain tq), nomin (each
//   visit's block minimum stored, no running minimum), twophase (the
//   sqrt-free front test: -b where b^2 >= cc and b < 0): c = (it 7 + g 3 +
//   v) % NCL for row g;
//   multisub f (f = 2, 4): clusters fused f at a time, VISITS / f visits of
//   f SUB spheres, c = (it 7 + g 3 + v) % (NCL / f), idx = (c << 5) | sub
//   with sub up to f SUB - 1;
//   multirow: c = (it 7 + v) % NCL for every row, idx = (c << 5) | k.
// The multisub and multirow table layouts were TPU layouts; here each
// variant reads one table and reproduces its visit order and encode.
// Built with -fmad=false and IEEE sqrtf, so the kernel and its plain
// version agree bit for bit.
//
// What bounds it on this card: instruction issue, one warp instruction a
// clock on each of an SM's four schedulers, nearer than the FP32 rate. A
// pair test is about 40 SASS instructions in the inner loop (chip_smoke.py
// prints each instantiation's mix from cuobjdump -sass): the 16 counted
// FP32 adds and multiplies, 8 more FP32 (compares, the root's refinement,
// -b - root, the minimum), one MUFU.RSQ, one LDS.128, the integer encode
// and about 8 branch instructions (the guard, IEEE sqrtf's range check and
// the reconvergence around them). A warp with no lane at disc >= 0 skips
// the 17-18 behind the guard, and no argument of these inputs takes the
// slow-path call, so a warp issues about 32 a test. The MUFU rate (16 a
// clock an SM) and shared-memory bandwidth are not reached.
// What the design does about the three costs of a straightforward port:
// - The root only where disc = b^2 - cc >= 0, as in the path-trace
//   kernel. IEEE sqrtf sends an argument outside the normal range, a
//   negative one among them, to a slow-path subroutine; unguarded, every
//   pair with disc < 0 (96% on the probe's inputs) would take that call. The
//   guard is exact: sqrtf(disc < 0) is NaN, the hit test fails, and the
//   pair is +inf either way; -0.0 >= 0 holds, so that case takes the same
//   root.
// - One 16-byte row a sphere, float4 (cx, cy, cz, r^2), staged in shared
//   memory (8 KB): one broadcast LDS.128 a pair test instead of two loads.
// - Enough warps: a ray's outer steps are split over kSplit threads of one
//   block (thread s runs steps s, s + kSplit, ...), which merge their
//   partial minima in shared memory. fminf over the encoded values (finite
//   or +inf) does not depend on the order, so the output is the sequential
//   loop's; for nomin the thread that ran the last step gives the result,
//   and every thread keeps its volatile store a visit (the TPU kernel's
//   scratch store), or the compiler would delete every visit but the last.
// The shapes are the TPU tool's and stay.
//
// C interface, loaded with ctypes (tools/pairblock_roofline.py):
//   rtx_pairblock(variant, rays, cols, out, steps, grid, stream) launches on
//   the given stream and returns cudaGetLastError(); rtx_error_string(code)
//   names an error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kSub = 32;
constexpr int kRows = 8;  // RS
constexpr int kClusters = 16;  // NCL
constexpr int kVisits = 8;
constexpr int kCol = 8;  // floats a sphere row of the input table
constexpr int kSpheres = kClusters * kSub;
constexpr int kWiden = ~2047;
// Threads a ray: a block is one (program, row), its 128 lanes kSplit times
// (1,024 threads; at 32 registers or fewer, ptxas -v, two blocks and 64
// warps an SM). The sphere loops are unrolled 32 pairs a pass: 128 (all of
// multisub4's) made the code too long.
constexpr int kSplit = 8;
constexpr int kThreads = kLanes * kSplit;

// The order of tools/pairblock_roofline.py VARIANTS.
enum Variant : int {
  kFull = 0,
  kNoSqrt = 1,
  kNoEnc = 2,
  kNoMin = 3,
  kTwoPhase = 4,
  kMultiSub2 = 5,
  kMultiSub4 = 6,
  kMultiRow = 7,
};

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// One pair test of the ray (o, d) against the sphere row q = (cx, cy, cz,
// r^2): its encoded value, +inf on a miss.
template <Variant kV>
__device__ __forceinline__ float pair(float4 q, float ox, float oy, float oz,
                                      float dx, float dy, float dz, int idx) {
  const float ocx = ox - q.x;
  const float ocy = oy - q.y;
  const float ocz = oz - q.z;
  const float b = ocx * dx + ocy * dy + ocz * dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - q.w;
  const float disc = b * b - cc;
  if constexpr (kV == kTwoPhase) {
    return (disc >= 0.0f && b < 0.0f) ? -b : inf();
  }
  if constexpr (kV == kNoSqrt) {
    const float tq = -b - disc * 0.5f;
    return tq >= 0.0f ? __int_as_float((__float_as_int(tq) & kWiden) | idx)
                      : inf();
  }
  float out = inf();
  if (disc >= 0.0f) {
    const float tq = -b - sqrtf(disc);
    if (tq >= 0.0f) {
      out = kV == kNoEnc ? tq
                         : __int_as_float((__float_as_int(tq) & kWiden) | idx);
    }
  }
  return out;
}

template <Variant kV>
__global__ void __launch_bounds__(kThreads)
pairblock(const float* __restrict__ rays, const float* __restrict__ cols_in,
          float* __restrict__ out, int steps) {
  __shared__ float4 table[kSpheres];
  __shared__ float part[kSplit][kLanes];
  __shared__ volatile float sink[kThreads];
  for (int i = threadIdx.x; i < kSpheres; i += kThreads) {
    const float* row = cols_in + i * kCol;
    table[i] = make_float4(row[0], row[1], row[2], row[4]);
  }
  __syncthreads();

  const int lane = threadIdx.x % kLanes;
  const int s = threadIdx.x / kLanes;  // warp-uniform
  const int g = blockIdx.x % kRows;
  const float ox = rays[(0 * kRows + g) * kLanes + lane];
  const float oy = rays[(1 * kRows + g) * kLanes + lane];
  const float oz = rays[(2 * kRows + g) * kLanes + lane];
  const float dx = rays[(3 * kRows + g) * kLanes + lane];
  const float dy = rays[(4 * kRows + g) * kLanes + lane];
  const float dz = rays[(5 * kRows + g) * kLanes + lane];

  float best = inf();
  for (int it = s; it < steps; it += kSplit) {
    if constexpr (kV == kMultiRow) {
      for (int v = 0; v < kVisits; ++v) {
        const int c = (it * 7 + v) % kClusters;
#pragma unroll 32
        for (int k = 0; k < kSub; ++k) {
          best = fminf(pair<kV>(table[c * kSub + k], ox, oy, oz, dx, dy, dz,
                                (c << 5) | k),
                       best);
        }
      }
    } else {
      constexpr int kFuse =
          kV == kMultiSub2 ? 2 : (kV == kMultiSub4 ? 4 : 1);
      for (int v = 0; v < kVisits / kFuse; ++v) {
        const int c = (it * 7 + g * 3 + v) % (kClusters / kFuse);
        float visit_min = inf();
#pragma unroll 32
        for (int k = 0; k < kFuse * kSub; ++k) {
          visit_min = fminf(visit_min,
                            pair<kV>(table[c * kFuse * kSub + k], ox, oy, oz,
                                     dx, dy, dz, (c << 5) | k));
        }
        if constexpr (kV == kNoMin) {
          sink[threadIdx.x] = visit_min;
          best = visit_min;
        } else {
          best = fminf(visit_min, best);
        }
      }
    }
  }

  // Merge the kSplit partial results of each ray, in a fixed order.
  part[s][lane] = best;
  __syncthreads();
  if (s == 0) {
    float r;
    if constexpr (kV == kNoMin) {
      r = steps > 0 ? part[(steps - 1) % kSplit][lane] : inf();
    } else {
      r = part[0][lane];
      for (int k = 1; k < kSplit; ++k) r = fminf(r, part[k][lane]);
    }
    out[blockIdx.x * kLanes + lane] = r;
  }
}

using KernelFn = void (*)(const float*, const float*, float*, int);

KernelFn kernel_of(int variant) {
  switch (variant) {
    case kFull: return pairblock<kFull>;
    case kNoSqrt: return pairblock<kNoSqrt>;
    case kNoEnc: return pairblock<kNoEnc>;
    case kNoMin: return pairblock<kNoMin>;
    case kTwoPhase: return pairblock<kTwoPhase>;
    case kMultiSub2: return pairblock<kMultiSub2>;
    case kMultiSub4: return pairblock<kMultiSub4>;
    case kMultiRow: return pairblock<kMultiRow>;
    default: return nullptr;
  }
}

}  // namespace

// rays (6 RS, 128) f32: origins x, y, z then directions x, y, z, RS rows
// each; cols the logical (NCL, SUB, 8) f32 table; out (grid RS, 128) f32.
extern "C" int rtx_pairblock(int variant, const void* rays, const void* cols,
                             void* out, int steps, int grid, void* stream) {
  const KernelFn kernel = kernel_of(variant);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<grid * kRows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(cols),
      static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
