// Host shim: builds a kernel source of this directory with g++ so that its
// logic runs on the CPU, driven through the same ctypes signature as the
// nvcc build, and can be held against the plain torch version before any
// time on the card.  tests/test_torch_traverse_host.py rehearses kernel B2
// (traverse.cu) this way:
//
//   1. drop the line `#include <cuda_runtime.h>`, and turn every launch
//      `k<<<g, t, s, st>>>(args);` into `launch_(g, t, s, st, [&] {
//      k(args); });` (a regex);
//   2. g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC
//          -include host_shim.h -I <this directory> <the result>
//
// (no FMA contraction: every float operation rounds as the nvcc build's,
// which is -fmad=false, and the plain version's do).
//
// A launch runs its blocks on a few host threads, and a block's threads one
// after another.  That is exact for kernels whose threads share nothing
// (B2: `__shared__` becomes thread_local storage, so each host thread has
// its own copy and a CUDA thread its own slot of it) and have no
// __syncthreads or warp intrinsics; anything else does not compile here
// (the wave kernels, csrc/wave.cu, keep their block reduction under
// __CUDA_ARCH__ and add with a plain atomic in this build, which
// tests/test_torch_wave_host.py rehearses the same way).
#pragma once

#include <math.h>

#include <algorithm>
#include <atomic>
#include <cstddef>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static thread_local
#define __restrict__ __restrict

struct uint3 {
  unsigned int x, y, z;
};
struct dim3 {
  unsigned int x, y, z;
  dim3(unsigned int a = 1, unsigned int b = 1, unsigned int c = 1)
      : x(a), y(b), z(c) {}
};
struct int4 {
  int x, y, z, w;
};

inline thread_local uint3 threadIdx{0, 0, 0};
inline thread_local uint3 blockIdx{0, 0, 0};
inline thread_local dim3 blockDim;
inline thread_local dim3 gridDim;

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

using std::max;
using std::min;

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }

inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}

// The launch: grid.x blocks of block.x threads (1-D, as the port's kernels
// launch), on at most 4 host threads.
template <class F>
inline void launch_(dim3 grid, dim3 block, std::size_t, cudaStream_t,
                    F&& body) {
  std::atomic<unsigned int> next{0};
  auto worker = [&] {
    gridDim = grid;
    blockDim = block;
    for (unsigned int b; (b = next++) < grid.x;) {
      blockIdx = {b, 0, 0};
      for (unsigned int t = 0; t < block.x; ++t) {
        threadIdx = {t, 0, 0};
        body();
      }
    }
  };
  const unsigned int n = std::max(
      1u, std::min(4u, std::thread::hardware_concurrency()));
  std::vector<std::thread> pool;
  for (unsigned int k = 0; k < n; ++k) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}
