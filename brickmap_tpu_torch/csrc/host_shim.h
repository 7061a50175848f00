// Host shim: builds a kernel source of this directory with g++ so that its
// logic runs on the CPU, driven through the same ctypes signature as the
// nvcc build, and can be held against the plain torch version before any
// time on the card.  tests/_host_build.py prepares a source for it:
//
//   1. drop the line `#include <cuda_runtime.h>`; turn every launch
//      `k<<<g, t, s, st>>>(args);` into `launch_(g, t, s, st, [&] {
//      k(args); });` and every `extern __shared__ [__align__(n)] T name[];`
//      into a pointer to the launch's dynamic shared memory (regexes);
//   2. g++ -std=c++20 -O1 -ffp-contract=off -shared -fPIC
//          -include host_shim.h -I <this directory> <the result>
//
// (no FMA contraction: every float operation rounds as the nvcc build's,
// which is -fmad=false, and the plain version's do).
//
// A launch runs its blocks one after another, and a block's threads at
// once: one host thread per CUDA thread.  `__shared__` storage is static,
// so the threads of the running block share it; `__syncthreads()` is a
// barrier of the block's threads and `__syncwarp()` one of the 32 threads
// of the caller's warp (fewer in a block's last, partial warp), and a
// block's threads all meet once more after the kernel body, before the
// next block takes the shared storage.  As on the card, every thread of a
// block (of a warp) must reach each `__syncthreads()` (`__syncwarp()`): a
// kernel that returns early above one leaves the barrier's phases out of
// step.  The warp intrinsics `__ballot_sync`, `__shfl_sync`,
// `__shfl_up_sync` and `__reduce_add_sync` are exchanges through a 32-slot
// array of the warp between two passes of its barrier: every lane of the
// warp must reach the same call (a divergent call deadlocks, as a check).
// `atomicAdd` on `int` and `unsigned long long` is `std::atomic_ref`,
// `__threadfence` a sequentially consistent fence, `__trap` an abort.  The
// occupancy calculator and the SM count describe a small card (2 SMs, 2
// blocks of any kernel on each), so that a grid sized to the resident
// blocks is smaller than the work and its blocks loop.  Inline PTX
// (`cp.async`, acquire loads and release stores) sits under
// `__CUDA_ARCH__` with a plain C twin in the kernel source.  Blocks run
// one after another, so a block never waits on a later one: a kernel whose
// blocks take their work from an atomic cursor, in order, finds every
// earlier block's result published.
#pragma once

#include <math.h>
#include <string.h>

#include <algorithm>
#include <atomic>
#include <barrier>
#include <cstddef>
#include <cstdlib>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
#define __restrict__ __restrict

struct uint3 {
  unsigned int x, y, z;
};
struct dim3 {
  unsigned int x, y, z;
  dim3(unsigned int a = 1, unsigned int b = 1, unsigned int c = 1)
      : x(a), y(b), z(c) {}
};
struct int2 {
  int x, y;
};
struct int4 {
  int x, y, z, w;
};
struct alignas(16) uint4 {
  unsigned int x, y, z, w;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}

inline thread_local uint3 threadIdx{0, 0, 0};
inline thread_local uint3 blockIdx{0, 0, 0};
inline thread_local dim3 blockDim;
inline thread_local dim3 gridDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// A small card: 2 SMs, 2 blocks of any kernel resident on an SM.
template <class F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, F, int, std::size_t) {
  *blocks = 2;
  return cudaSuccess;
}
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 2;
  return cudaSuccess;
}

using std::max;
using std::min;

template <class T>
inline T __ldg(const T* p) {
  return *p;
}

inline float __fmaf_rn(float a, float b, float c) { return fmaf(a, b, c); }
inline int __popc(unsigned int v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
[[noreturn]] inline void __trap() { std::abort(); }
inline void __threadfence() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}

// The running block's barriers, its warp's exchange slots, and the
// launch's dynamic shared memory.
inline thread_local std::barrier<>* block_barrier_ = nullptr;
inline thread_local std::barrier<>* warp_barrier_ = nullptr;
inline thread_local unsigned long long* warp_slots_ = nullptr;
inline thread_local unsigned int warp_lanes_ = 32;
inline unsigned char* dynamic_shared_ = nullptr;

inline void __syncthreads() { block_barrier_->arrive_and_wait(); }
inline void __syncwarp(unsigned int = 0xffffffffu) {
  warp_barrier_->arrive_and_wait();
}

// One exchange of the caller's warp: each lane puts `v` in its slot, the
// warp meets, `f(slots, lane, lanes)` reads them, and the warp meets again
// so that the slots are free for the next exchange.
template <class T, class F>
inline auto warp_exchange_(T v, F f) {
  static_assert(sizeof(T) <= sizeof(unsigned long long));
  const unsigned int lane = threadIdx.x % 32;
  unsigned long long word = 0;
  memcpy(&word, &v, sizeof(T));
  warp_slots_[lane] = word;
  warp_barrier_->arrive_and_wait();
  const auto r = f(warp_slots_, lane, warp_lanes_);
  warp_barrier_->arrive_and_wait();
  return r;
}

template <class T>
inline T slot_as_(unsigned long long word) {
  T v;
  memcpy(&v, &word, sizeof(T));
  return v;
}

inline unsigned int __ballot_sync(unsigned int, int pred) {
  return warp_exchange_(pred != 0 ? 1 : 0, [](const unsigned long long* s,
                                              unsigned int, unsigned int n) {
    unsigned int bits = 0u;
    for (unsigned int k = 0; k < n; ++k) bits |= (s[k] != 0u ? 1u : 0u) << k;
    return bits;
  });
}

template <class T>
inline T __shfl_sync(unsigned int, T v, int src, int = 32) {
  return warp_exchange_(v, [src](const unsigned long long* s, unsigned int,
                                 unsigned int) {
    return slot_as_<T>(s[src & 31]);
  });
}

template <class T>
inline T __shfl_up_sync(unsigned int, T v, unsigned int delta, int = 32) {
  return warp_exchange_(v, [delta](const unsigned long long* s,
                                   unsigned int lane, unsigned int) {
    return slot_as_<T>(s[lane >= delta ? lane - delta : lane]);
  });
}

template <class T>
inline T __reduce_add_sync(unsigned int, T v) {
  return warp_exchange_(v, [](const unsigned long long* s, unsigned int,
                              unsigned int n) {
    T sum = 0;
    for (unsigned int k = 0; k < n; ++k) sum += slot_as_<T>(s[k]);
    return sum;
  });
}

// The launch: grid.x blocks of block.x threads (1-D, as the port's kernels
// launch), one block at a time, its threads on as many host threads.
template <class F>
inline void launch_(dim3 grid, dim3 block, std::size_t shared_bytes,
                    cudaStream_t, F&& body) {
  const unsigned int nt = block.x;
  std::vector<std::max_align_t> shared(
      (shared_bytes + sizeof(std::max_align_t) - 1) /
      sizeof(std::max_align_t) + 1);
  dynamic_shared_ = reinterpret_cast<unsigned char*>(shared.data());
  std::barrier<> block_bar(nt);
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (unsigned int w = 0; w * 32 < nt; ++w) {
    warp_bars.push_back(
        std::make_unique<std::barrier<>>(std::min(32u, nt - w * 32)));
  }
  std::vector<unsigned long long> slots(warp_bars.size() * 32);
  auto worker = [&](unsigned int t) {
    gridDim = grid;
    blockDim = block;
    threadIdx = {t, 0, 0};
    block_barrier_ = &block_bar;
    warp_barrier_ = warp_bars[t / 32].get();
    warp_slots_ = slots.data() + (t / 32) * 32;
    warp_lanes_ = std::min(32u, nt - (t / 32) * 32);
    for (unsigned int b = 0; b < grid.x; ++b) {
      blockIdx = {b, 0, 0};
      body();
      block_bar.arrive_and_wait();
    }
  };
  std::vector<std::thread> pool;
  for (unsigned int t = 0; t < nt; ++t) pool.emplace_back(worker, t);
  for (auto& th : pool) th.join();
  dynamic_shared_ = nullptr;
}
