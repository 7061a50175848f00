// Variants of kernel B4b (brickmap_tpu_torch/csrc/extract.cu) for
// notes/probe_torch_b4b_order.py: the same function, the same contract
// (dfield4[slots[r]*512 + lin[r, j]] += (dvals[r, f*nvox + j])_f for every
// valid entry), with more memory accesses in flight per thread.
//
// * batch<N>: each thread takes N entries a block's width apart (loads
//   coalesced), loads all N lin/slot words, then the valid entries'
//   cotangents, then issues the N atomics.
// * lin4: each thread takes 4 consecutive entries, its lin words as one
//   16-byte load (entries 4t..4t+3; the launcher needs Cs*nvox % 4 == 0).
// * segment-major (b4_segment_major_launch): B4f or B4b with the rows taken
//   as Cs / K rays of K segments each and walked segment by segment
//   (thread t takes row (q % C) * K + q / C, q = t / nvox), so that
//   neighbouring threads take neighbouring rays' same segment.
//
// Built by the probe with the port's nvcc flags; plain C launchers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBrickVoxels = 512;

__device__ __forceinline__ long long voxel(int l, int s, int pool) {
  if (l < 0 || l >= kBrickVoxels || s < 0 || s >= pool) return -1;
  return static_cast<long long>(s) * kBrickVoxels + l;
}

template <int N>
__global__ void __launch_bounds__(kThreads)
batch_kernel(int total, int nvox, int pool, float4* __restrict__ dfield4,
             const int* __restrict__ slots, const int* __restrict__ lin,
             const float* __restrict__ dvals) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kThreads * N + threadIdx.x;
  long long v[N];
  int row[N], col[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const long long e = base + static_cast<long long>(i) * kThreads;
    v[i] = -1;
    if (e < total) {
      row[i] = static_cast<int>(e) / nvox;
      col[i] = static_cast<int>(e) - row[i] * nvox;
      v[i] = voxel(__ldg(lin + e), __ldg(slots + row[i]), pool);
    }
  }
  float4 d[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (v[i] >= 0) {
      const float* p = dvals + static_cast<long long>(row[i]) * 4 * nvox +
                       col[i];
      d[i] = make_float4(__ldg(p), __ldg(p + nvox), __ldg(p + 2 * nvox),
                         __ldg(p + 3 * nvox));
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (v[i] >= 0) atomicAdd(dfield4 + v[i], d[i]);
  }
}

__global__ void __launch_bounds__(kThreads)
lin4_kernel(int total, int nvox, int pool, float4* __restrict__ dfield4,
            const int* __restrict__ slots, const int* __restrict__ lin,
            const float* __restrict__ dvals) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (4 * t >= total) return;
  const int4 l4 = __ldg(reinterpret_cast<const int4*>(lin) + t);
  const int ls[4] = {l4.x, l4.y, l4.z, l4.w};
  long long v[4];
  int row[4], col[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = static_cast<int>(4 * t) + i;
    row[i] = e / nvox;
    col[i] = e - row[i] * nvox;
    v[i] = voxel(ls[i], __ldg(slots + row[i]), pool);
  }
  float4 d[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (v[i] >= 0) {
      const float* p = dvals + static_cast<long long>(row[i]) * 4 * nvox +
                       col[i];
      d[i] = make_float4(__ldg(p), __ldg(p + nvox), __ldg(p + 2 * nvox),
                         __ldg(p + 3 * nvox));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (v[i] >= 0) atomicAdd(dfield4 + v[i], d[i]);
  }
}

template <bool kForward>
__global__ void __launch_bounds__(kThreads)
segment_major_kernel(int total, int nvox, int pool, int k, float4* field4,
                     const int* __restrict__ slots,
                     const int* __restrict__ lin, float* vals) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int q = static_cast<int>(t) / nvox;
  const int j = static_cast<int>(t) - q * nvox;
  const int rays = total / nvox / k;
  const int r = (q % rays) * k + q / rays;
  const long long v = voxel(__ldg(lin + static_cast<long long>(r) * nvox + j),
                            __ldg(slots + r), pool);
  float* p = vals + static_cast<long long>(r) * 4 * nvox + j;
  if (kForward) {
    const float4 x = v >= 0 ? __ldg(field4 + v) : make_float4(0.f, 0.f, 0.f,
                                                             0.f);
    p[0] = x.x;
    p[nvox] = x.y;
    p[2 * nvox] = x.z;
    p[3 * nvox] = x.w;
  } else if (v >= 0) {
    atomicAdd(field4 + v, make_float4(p[0], p[nvox], p[2 * nvox],
                                      p[3 * nvox]));
  }
}

int grid_of(long long items) {
  return static_cast<int>((items + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int b4_segment_major_launch(int forward, int k, int cs, int nvox,
                                       int pool, void* field4,
                                       const int* slots, const int* lin,
                                       float* vals, void* stream) {
  const int total = cs * nvox;
  if (total <= 0 || k <= 0 || cs % k != 0) return -1;
  auto st = static_cast<cudaStream_t>(stream);
  auto f4 = static_cast<float4*>(field4);
  if (forward) {
    segment_major_kernel<true><<<grid_of(total), kThreads, 0, st>>>(
        total, nvox, pool, k, f4, slots, lin, vals);
  } else {
    segment_major_kernel<false><<<grid_of(total), kThreads, 0, st>>>(
        total, nvox, pool, k, f4, slots, lin, vals);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int b4b_variant_launch(int variant, int cs, int nvox, int pool,
                                  void* dfield4, const int* slots,
                                  const int* lin, const float* dvals,
                                  void* stream) {
  const int total = cs * nvox;
  auto st = static_cast<cudaStream_t>(stream);
  auto f4 = static_cast<float4*>(dfield4);
  if (total <= 0) return 0;
  switch (variant) {
    case 2:
      batch_kernel<2><<<grid_of((total + 1) / 2), kThreads, 0, st>>>(
          total, nvox, pool, f4, slots, lin, dvals);
      break;
    case 4:
      batch_kernel<4><<<grid_of((total + 3) / 4), kThreads, 0, st>>>(
          total, nvox, pool, f4, slots, lin, dvals);
      break;
    case 40:
      if (total % 4 != 0) return -1;
      lin4_kernel<<<grid_of(total / 4), kThreads, 0, st>>>(
          total, nvox, pool, f4, slots, lin, dvals);
      break;
    default:
      return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
