// The FP32 issue-rate probe on Hopper (sm_90a): one thread per output
// element.
//
// Replaces the TPU kernel tools/vpu_roofline.py::_kernel (its measure's
// pallas_call). It computes what that kernel computes: for every element
// of the (grid * 32, 128) f32 output, eight independent accumulators start
// at lane * s_k + 1 (lane = the element's column, s_k = f32(0.001 (k + 1)),
// the rounding JAX's weak typing gives the Python scalar), run n_steps
// steps of a = max(a * 0.9999, 0.125), and are summed in order,
// acc0 + acc1 + ... + acc7. Every operation is an IEEE f32 multiply, max
// or add (built with -fmad=false), so the kernel, its plain PyTorch
// version and the TPU kernel run in interpret mode agree bit for bit.
//
// What bounds it on this card: FP32 instruction issue, two operations per
// accumulator a step (a multiply and a max; no FMA to fold them into) on
// 132 SMs x 128 lanes. What this version does about it: eight independent
// chains per thread keep each SM's pipes fed past the operations' latency,
// and the max keeps the chain non-affine, so no compiler can fold the loop
// into a closed form. It reads nothing and writes 4 bytes per 2^18
// operations at the default shape.
//
// C interface, loaded with ctypes (tools/vpu_roofline.py):
//   rtx_vpu_chain(out, n, n_steps, stream) launches on the given stream and
//   returns cudaGetLastError(); rtx_error_string(code) names an error.

#include <cuda_runtime.h>

namespace {

constexpr int kAcc = 8;
constexpr int kLanes = 128;
constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
vpu_chain(float* __restrict__ out, int n, int n_steps) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  // the Python doubles 0.9999 and 0.001 (k + 1), rounded to f32
  const float m = static_cast<float>(0.9999);
  const float c = 0.125f;
  const float base = static_cast<float>(idx % kLanes);
  float acc[kAcc];
#pragma unroll
  for (int k = 0; k < kAcc; ++k) {
    acc[k] = base * static_cast<float>(0.001 * (k + 1)) + 1.0f;
  }
  for (int i = 0; i < n_steps; ++i) {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) acc[k] = fmaxf(acc[k] * m, c);
  }
  float sum = acc[0];
#pragma unroll
  for (int k = 1; k < kAcc; ++k) sum = sum + acc[k];
  out[idx] = sum;
}

}  // namespace

extern "C" int rtx_vpu_chain(void* out, int n, int n_steps, void* stream) {
  vpu_chain<<<(n + kBlock - 1) / kBlock, kBlock, 0,
              static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), n,
                                                   n_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rtx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
