// The sphere pair-test block probe on Hopper (sm_90a): the isolated
// ceiling of the path-trace kernel's hot loop, without traversal, shading
// or occupancy effects of the real kernel.
//
// Replaces the TPU kernel tools/pairblock_roofline.py::_make_kernel (its
// measure's pallas_call), one template instantiation per variant. It
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
// variant reads the logical table and reproduces its visit order and
// encode. Built with -fmad=false and IEEE sqrtf, so the kernel and its
// plain version agree bit for bit.
//
// One thread a (program, row, lane) ray: 64 x 8 x 128 = 65,536 threads in
// blocks of 128, one block a (program, row). The table (16 KB) is staged
// in shared memory; a warp reads one sphere's values at a time, a
// broadcast. The running best lives in a register. nomin keeps one live
// volatile shared-memory store a visit (the TPU kernel's scratch store),
// or the compiler would delete every visit but the last.
//
// What bounds it on this card: FP32 issue (16 adds and multiplies, a
// sqrt, compares and the integer encode a pair test); 65,536 threads are
// about 15.5 warps an SM, too few to hide the sqrt's latency. The shapes
// are the TPU tool's and stay.
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
constexpr int kCol = 8;  // floats a sphere row of the table
constexpr int kWiden = ~2047;

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

// One pair test of the ray (o, d) against the sphere at `q`: its encoded
// value, +inf on a miss.
template <Variant kV>
__device__ __forceinline__ float pair(const float* q, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      int idx) {
  const float ocx = ox - q[0];
  const float ocy = oy - q[1];
  const float ocz = oz - q[2];
  const float b = ocx * dx + ocy * dy + ocz * dz;
  const float cc = ocx * ocx + ocy * ocy + ocz * ocz - q[4];
  if constexpr (kV == kTwoPhase) {
    const float disc = b * b - cc;
    return (disc >= 0.0f && b < 0.0f) ? -b : inf();
  }
  float tq;
  if constexpr (kV == kNoSqrt) {
    tq = -b - (b * b - cc) * 0.5f;
  } else {
    tq = -b - sqrtf(b * b - cc);
  }
  if constexpr (kV == kNoEnc) return tq >= 0.0f ? tq : inf();
  return tq >= 0.0f ? __int_as_float((__float_as_int(tq) & kWiden) | idx)
                    : inf();
}

template <Variant kV>
__global__ void __launch_bounds__(kLanes)
pairblock(const float* __restrict__ rays, const float* __restrict__ cols_in,
          float* __restrict__ out, int steps) {
  __shared__ float cols[kClusters * kSub * kCol];
  __shared__ volatile float sink[kLanes];
  for (int i = threadIdx.x; i < kClusters * kSub * kCol; i += kLanes) {
    cols[i] = cols_in[i];
  }
  __syncthreads();

  const int lane = threadIdx.x;
  const int g = blockIdx.x % kRows;
  const float ox = rays[(0 * kRows + g) * kLanes + lane];
  const float oy = rays[(1 * kRows + g) * kLanes + lane];
  const float oz = rays[(2 * kRows + g) * kLanes + lane];
  const float dx = rays[(3 * kRows + g) * kLanes + lane];
  const float dy = rays[(4 * kRows + g) * kLanes + lane];
  const float dz = rays[(5 * kRows + g) * kLanes + lane];

  float best = inf();
  for (int it = 0; it < steps; ++it) {
    if constexpr (kV == kMultiRow) {
      for (int v = 0; v < kVisits; ++v) {
        const int c = (it * 7 + v) % kClusters;
        for (int k = 0; k < kSub; ++k) {
          best = fminf(pair<kV>(cols + (c * kSub + k) * kCol, ox, oy, oz, dx,
                                dy, dz, (c << 5) | k),
                       best);
        }
      }
    } else {
      constexpr int kFuse =
          kV == kMultiSub2 ? 2 : (kV == kMultiSub4 ? 4 : 1);
      for (int v = 0; v < kVisits / kFuse; ++v) {
        const int c = (it * 7 + g * 3 + v) % (kClusters / kFuse);
        float visit_min = inf();
        for (int s = 0; s < kFuse * kSub; ++s) {
          visit_min = fminf(
              visit_min, pair<kV>(cols + (c * kFuse * kSub + s) * kCol, ox, oy,
                                  oz, dx, dy, dz, (c << 5) | s));
        }
        if constexpr (kV == kNoMin) {
          sink[lane] = visit_min;
          best = visit_min;
        } else {
          best = fminf(visit_min, best);
        }
      }
    }
  }
  out[blockIdx.x * kLanes + lane] = best;
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
  kernel<<<grid * kRows, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rays), static_cast<const float*>(cols),
      static_cast<float*>(out), steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
