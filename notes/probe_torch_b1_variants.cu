// Probe builds of kernel B1 (notes/probe_torch_b1.py): the shipped kernel of
// brickmap_tpu_torch/csrc/brick.cu, included whole, launched at a chosen
// number of blocks an SM, and a candidate it was measured against and not
// shipped: 4 consecutive rays a thread, with three 16-byte loads of origins
// and three of directions and one uchar4 / float4 / int4 store each of hit,
// t and axis (the last n % 4 rays one at a time; arrays 16-byte aligned).
//
// Built by the probe with the port's nvcc flags and -I csrc:
//   variant_launch(..., rays_per_thread 1 or 4, blocks_per_sm, stream)
// blocks_per_sm = 0 takes the occupancy calculator's count.

#include "brick.cu"

namespace {

struct Rays4 {
  float o[12], d[12];  // ray k's origin at o[3k..3k+2], direction at d[..]
};

// Group g's 4 rays: 16-byte loads for a whole group, else one ray at a time
// (rays past n repeat ray n - 1; they are traced and not stored).
__device__ __forceinline__ Rays4 load_rays4(const float* __restrict__ origins,
                                            const float* __restrict__ dirs,
                                            int g, int n) {
  Rays4 v;
  if (4 * g + 4 <= n) {
    const float4* o4 = reinterpret_cast<const float4*>(origins) + 3 * g;
    const float4* d4 = reinterpret_cast<const float4*>(dirs) + 3 * g;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 a = __ldg(o4 + j), b = __ldg(d4 + j);
      v.o[4 * j] = a.x; v.o[4 * j + 1] = a.y; v.o[4 * j + 2] = a.z;
      v.o[4 * j + 3] = a.w;
      v.d[4 * j] = b.x; v.d[4 * j + 1] = b.y; v.d[4 * j + 2] = b.z;
      v.d[4 * j + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = min(4 * g + k, n - 1);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        v.o[3 * k + j] = __ldg(origins + 3 * i + j);
        v.d[3 * k + j] = __ldg(dirs + 3 * i + j);
      }
    }
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    brick4_kernel(const int* __restrict__ words,
                  const float* __restrict__ origins,
                  const float* __restrict__ dirs, int n,
                  unsigned char* __restrict__ hit, float* __restrict__ t_out,
                  int* __restrict__ axis_out) {
  build_tables(words);
  const int groups = (n + 3) / 4;
  const int step = gridDim.x * kThreads;
  for (int g = ((threadIdx.x >> 5) * gridDim.x + blockIdx.x) * 32 +
               (threadIdx.x & 31);
       g < groups; g += step) {
    const Rays4 v = load_rays4(origins, dirs, g, n);
    Hit r[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      r[k] = trace_ray(v.o[3 * k], v.o[3 * k + 1], v.o[3 * k + 2],
                       v.d[3 * k], v.d[3 * k + 1], v.d[3 * k + 2]);
    if (4 * g + 4 <= n) {
      reinterpret_cast<uchar4*>(hit)[g] =
          make_uchar4(r[0].hit, r[1].hit, r[2].hit, r[3].hit);
      reinterpret_cast<float4*>(t_out)[g] =
          make_float4(r[0].t, r[1].t, r[2].t, r[3].t);
      reinterpret_cast<int4*>(axis_out)[g] =
          make_int4(r[0].axis, r[1].axis, r[2].axis, r[3].axis);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * g + k;
        if (i < n) {
          hit[i] = r[k].hit;
          t_out[i] = r[k].t;
          axis_out[i] = r[k].axis;
        }
      }
    }
  }
}

template <typename K>
int blocks_for(K kernel, int work_items, int blocks_per_sm) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (blocks_per_sm > 0 && blocks_per_sm < per_sm) per_sm = blocks_per_sm;
  const int need = (work_items + kThreads - 1) / kThreads;
  return sms * per_sm < need ? sms * per_sm : need;
}

}  // namespace

extern "C" int variant_launch(const int* words, const float* origins,
                              const float* dirs, int n, unsigned char* hit,
                              float* t, int* axis, int rays_per_thread,
                              int blocks_per_sm, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rays_per_thread == 4)
      brick4_kernel<<<blocks_for(brick4_kernel, (n + 3) / 4, blocks_per_sm),
                      kThreads, 0, s>>>(words, origins, dirs, n, hit, t,
                                        axis);
    else
      brick_kernel<<<blocks_for(brick_kernel, n, blocks_per_sm), kThreads, 0,
                     s>>>(words, origins, dirs, n, hit, t, axis);
  }
  return static_cast<int>(cudaGetLastError());
}
