// Candidate roundings of the wave's shading ops, for
// notes/probe_torch_wave_rounding.py: each 3-wide sum in three orders, each
// cross-product component with and without a fused multiply-add, and the
// libdevice functions the shading calls.  Built -fmad=false.
#include <cuda_runtime.h>
#include <math.h>

__global__ void cand_kernel(int n, const float* a, const float* b,
                            const float* x, float* sums, float* cross,
                            float* fns) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = a + 3 * i;
  const float* q = b + 3 * i;
  const float s0 = p[0] * p[0], s1 = p[1] * p[1], s2 = p[2] * p[2];
  sums[3 * i + 0] = (s0 + s1) + s2;
  sums[3 * i + 1] = (s0 + s2) + s1;
  sums[3 * i + 2] = s0 + (s1 + s2);
  // component 0 of cross(p, q): p1 q2 - p2 q1
  cross[3 * i + 0] = __fmaf_rn(p[1], q[2], -(p[2] * q[1]));
  cross[3 * i + 1] = __fmaf_rn(-p[2], q[1], p[1] * q[2]);
  cross[3 * i + 2] = p[1] * q[2] - p[2] * q[1];
  const float v = x[i];
  fns[8 * i + 0] = sinf(v);
  fns[8 * i + 1] = cosf(v);
  fns[8 * i + 2] = expf(-v);
  fns[8 * i + 3] = acosf(v * 0.25f - 0.5f);
  fns[8 * i + 4] = powf(v, 1.5f);
  fns[8 * i + 5] = powf(v * 0.3f, 5.0f);
  fns[8 * i + 6] = sqrtf(v);
  fns[8 * i + 7] = 1.0f / v;
}

extern "C" int cand_launch(int n, const float* a, const float* b,
                           const float* x, float* sums, float* cross,
                           float* fns) {
  cand_kernel<<<(n + 255) / 256, 256>>>(n, a, b, x, sums, cross, fns);
  return static_cast<int>(cudaGetLastError());
}
