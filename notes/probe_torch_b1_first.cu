// Kernel B1: 8x8x8 brick DDA, one CUDA thread per ray.
//
// Replaces the TPU kernel brickmap_tpu/pallas/brick.py::_brick_kernel (:48),
// launched by intersect_brick_tiles (:138) and wrapped by trace_single_brick
// (:173).  Every ray is traced against the same brick's 16 occupancy words
// with the reference's intersect_brick (voxel.cuh:79-133) for at most 22
// steps (3*8 - 2, the most cells a ray can visit in a brick).
//
// What bounds it on an H100: the DDA's dependent arithmetic.  A ray reads 24
// bytes (origin, direction) and writes 9 (hit, t, axis); the 64
// bytes of the brick are shared by all rays and stay in L1.  The TPU kernel
// kept the words in vector registers and ran a fixed 22-step loop with lane
// masks; here each thread stops at its own hit or exit, and the 16 words are
// staged once per block in shared memory.
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/brick.py.

#include <cuda_runtime.h>

#include "dda.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 22;

__global__ void brick_kernel(const int* __restrict__ words,
                             const float* __restrict__ origins,
                             const float* __restrict__ dirs, int n,
                             unsigned char* __restrict__ hit,
                             float* __restrict__ t_out,
                             int* __restrict__ axis_out) {
  __shared__ unsigned int w[16];
  if (threadIdx.x < 16) w[threadIdx.x] = static_cast<unsigned int>(words[threadIdx.x]);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const bm::Axis ax = bm::make_axis(dirs[3 * i + 0]);
  const bm::Axis ay = bm::make_axis(dirs[3 * i + 1]);
  const bm::Axis az = bm::make_axis(dirs[3 * i + 2]);
  // Out-of-range local cells read bit 0 of word 0, as the TPU kernel does.
  const unsigned int* ws = w;
  auto occ = [ws](int x, int y, int z) {
    int lin = x + y * 8 + z * 64;
    lin = (lin >= 0 && lin < 512) ? lin : 0;
    return ((ws[lin >> 5] >> (lin & 31)) & 1u) != 0u;
  };
  int budget = kMaxSteps;
  float t = 0.0f;
  int axis = -1;
  const int r = bm::sub_dda<8>(origins[3 * i + 0], origins[3 * i + 1],
                               origins[3 * i + 2], ax, ay, az, occ, budget,
                               t, axis);
  hit[i] = r == 1;
  t_out[i] = r == 1 ? t : 0.0f;
  axis_out[i] = r == 1 ? axis : -1;
}

}  // namespace

extern "C" int brick_launch(const int* words, const float* origins,
                            const float* dirs, int n, unsigned char* hit,
                            float* t, int* axis, void* stream) {
  if (n > 0) {
    const int blocks = (n + kThreads - 1) / kThreads;
    brick_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        words, origins, dirs, n, hit, t, axis);
  }
  return static_cast<int>(cudaGetLastError());
}
