// Kernel B2's postponed-descend build (notes/probe_torch_b2_postpone.cu,
// its defaults) with its counting hook set:
// for each round of top steps the lanes that took one, and for each
// warp-wide descend the steps of every lane and of the longest, summed over
// the launch.  notes/probe_torch_b2.py builds it with the port's nvcc flags
// and reads the sums with probe_b2_counts: lanes a top step = sum / rounds,
// lanes a descend step = lane steps / warp steps.  Runs only on the card
// (warp reductions).

#include <cuda_runtime.h>

__device__ unsigned long long probe_b2_sums[4];

// Lane 0 adds the warp's sum and largest value of `v` to counter pair
// `kind`, for a round where some lane counted.
__device__ __forceinline__ void probe_b2_count(int kind, int v) {
  const unsigned int sum = __reduce_add_sync(0xffffffffu,
                                             static_cast<unsigned int>(v));
  const unsigned int most = __reduce_max_sync(0xffffffffu,
                                              static_cast<unsigned int>(v));
  if (threadIdx.x % 32 == 0 && most > 0) {
    atomicAdd(&probe_b2_sums[2 * kind], sum);
    atomicAdd(&probe_b2_sums[2 * kind + 1], most);
  }
}

#define BM_B2_COUNT(kind, v) probe_b2_count((kind), (v))
#include "probe_torch_b2_postpone.cu"

// The four sums (top-step lanes, rounds, descend lane steps, warp steps)
// into `out`, then zeroed for the next launch.
extern "C" int probe_b2_counts(unsigned long long* out) {
  cudaDeviceSynchronize();
  cudaMemcpyFromSymbol(out, probe_b2_sums, sizeof(probe_b2_sums));
  const unsigned long long zero[4] = {0, 0, 0, 0};
  cudaMemcpyToSymbol(probe_b2_sums, zero, sizeof(zero));
  return static_cast<int>(cudaGetLastError());
}
