// Kernel A1: one Adam step over one of the inverse renderer's fields with
// the clip to [0, 1] fused in, one launch a field.
//
// It has no Pallas twin: the JAX package leaves the update to optax under
// XLA (brickmap_tpu/diff/optim.py: optax.adam, apply_updates, clip).  The
// plain version is brickmap_tpu_torch/ops/adam.py::adam_update_plain; the
// kernel rounds every operation as that torch code does (-fmad=false, IEEE
// sqrt and division) and equals it bit for bit.
//
// Per element, with the scalars taken on the host in double and rounded to
// float (b1, c1 = 1 - b1, b2, c2 = 1 - b2, eps, step_size = -lr / (1 -
// b1^t) and sqrt_bc2 = sqrt(1 - b2^t)):
//   m = m*b1 + c1*g;  v = v*b2 + (c2*g)*g;
//   d = sqrt(v) / sqrt_bc2 + eps;  p = p + step_size*(m/d);
//   p = p < 0 ? 0 : (p > 1 ? 1 : p)   (a NaN stays NaN, as torch.clamp_).
//
// What bounds it: bytes.  p, g, m and v are read once and p, m and v
// written once, 28 bytes an element and nothing else: no temporary, no
// second pass for the clip.  The inverse benchmark's fields (378,208,256
// voxels of occupancy and three albedo channels) are 42.4 GB a step, 12.6
// ms at 3.35 TB/s, against ~80 bytes an element for torch.optim.Adam's
// foreach passes and the clamp.  Each thread moves 16-byte words with the
// streaming cache hints (__ldcs/__stcs, evict first: the fields stream
// through the 50 MB L2 once); the resident blocks walk the words with a
// grid-stride loop and keep four independent 16-byte loads a thread in
// flight.  The last n % 4 elements, and every element of a field with a
// pointer off a 16-byte boundary, take a scalar grid-stride loop after the
// words.  At 85-86% of the bound on an H100 it runs at the HBM's practical
// rate for 4 reads to 3 writes: 128 to 512 threads a block, two or four
// words a thread and plain loads and stores all measured within 1% of this
// build (PERF.md section 6, kernel A1).
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/adam.py, which checks
// dtypes, devices, shapes and contiguity.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The step's scalars.
struct Scalars {
  float b1, c1, b2, c2, eps, step_size, sqrt_bc2;
};

#ifdef __CUDA_ARCH__
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
#else
inline float div_rn(float a, float b) { return a / b; }
inline float sqrt_rn(float a) { return sqrtf(a); }
#endif

// One element's update, in the plain version's order of operations.
__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const Scalars& s) {
  m = m * s.b1 + s.c1 * g;
  v = v * s.b2 + (s.c2 * g) * g;
  const float d = div_rn(sqrt_rn(v), s.sqrt_bc2) + s.eps;
  const float q = p + s.step_size * div_rn(m, d);
  p = q < 0.f ? 0.f : (q > 1.f ? 1.f : q);
}

// `words` 16-byte words of p, g, m and v, then the elements past them up to
// n, each by a grid-stride loop.
__global__ void __launch_bounds__(kThreads)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, long long n,
            long long words, const Scalars s) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (long long i = first; i < words; i += stride) {
    float4 pw = __ldcs(p4 + i);
    const float4 gw = __ldcs(g4 + i);
    float4 mw = __ldcs(m4 + i);
    float4 vw = __ldcs(v4 + i);
    update(pw.x, gw.x, mw.x, vw.x, s);
    update(pw.y, gw.y, mw.y, vw.y, s);
    update(pw.z, gw.z, mw.z, vw.z, s);
    update(pw.w, gw.w, mw.w, vw.w, s);
    __stcs(m4 + i, mw);
    __stcs(v4 + i, vw);
    __stcs(p4 + i, pw);
  }
  for (long long i = 4 * words + first; i < n; i += stride) {
    float pe = p[i], me = m[i], ve = v[i];
    update(pe, g[i], me, ve, s);
    m[i] = me;
    v[i] = ve;
    p[i] = pe;
  }
}

bool aligned16(const void* a) {
  return reinterpret_cast<unsigned long long>(a) % 16 == 0;
}

}  // namespace

// One launch over one field: its four arrays of n floats, the step's two
// bias-corrected scalars and the betas and eps.  The grid is the blocks
// resident at once (SMs x blocks an SM), fewer where the work needs fewer.
// Returns cudaGetLastError().
extern "C" int adam_launch(void* p, const void* g, void* m, void* v,
                           long long n, float step_size, float sqrt_bc2,
                           float b1, float c1, float b2, float c2, float eps,
                           void* stream) {
  static int resident[64] = {};
  const long long words =
      aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v) ? n / 4
                                                                   : 0;
  const long long work = words + (n - 4 * words);
  if (work > 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess) {
      return static_cast<int>(cudaGetLastError());
    }
    int& slot = resident[dev & 63];
    if (slot == 0) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel,
                                                    kThreads, 0);
      slot = sms * per_sm > 1 ? sms * per_sm : 1;
    }
    const long long need = (work + kThreads - 1) / kThreads;
    const int blocks = static_cast<int>(need < slot ? need : slot);
    const Scalars s{b1, c1, b2, c2, eps, step_size, sqrt_bc2};
    adam_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float*>(p), static_cast<const float*>(g),
        static_cast<float*>(m), static_cast<float*>(v), n, words, s);
  }
  return static_cast<int>(cudaGetLastError());
}
