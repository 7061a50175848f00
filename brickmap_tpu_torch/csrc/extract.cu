// Kernels B4f and B4b: the brick-row replay's reads of the visited voxels
// straight from the pool fields, and the atomic scatter-add of their
// cotangents back into the field gradient.
//
// Replace the TPU kernels brickmap_tpu/pallas/extract.py::_fwd_kernel (:35)
// and ::_bwd_kernel (:55), paired by extract_rows_pallas (:79), together
// with the row gather before the first (jnp.take of one [4*512] row per
// segment, brickmap_tpu/diff/sparse.py:512) and the row scatter-add after
// the second (.at[slots].add, :531).  The TPU needed whole 8 KB rows to fill
// its VMEM tiles; here a segment touches only the ~8 voxels it visits.
//
// The fields are voxel-interleaved, field4 [P*512, 4] f32 (occupancy, then
// RGB albedo): a voxel's four values are one 16-byte aligned float4.
// slots [Cs] i32 names each segment's pool row, lin [Cs, nvox] i32 the brick
// voxels it visits; entry (r, j) is valid when 0 <= lin[r, j] < 512 and
// 0 <= slots[r] < P.
//
// B4f (extract_fwd_kernel): vals[r, f*nvox + j] = field4[slots[r]*512 +
// lin[r, j], f], 0 for invalid entries.  One thread per (r, j), coalesced
// over j; one read-only 16-byte load per valid voxel, one 32-byte sector
// where the row layout (values 2 KB apart) took four.  Bound: bytes,
// 4 Cs (slots) + 4 Cs nvox (lin) + 16 n_valid (values) + 16 Cs nvox (vals).
//
// B4b (extract_bwd_kernel): dfield4[slots[r]*512 + lin[r, j]] +=
// (dvals[r, f*nvox + j])_f for every valid (r, j), in place.  One thread per
// (r, j) and one vector atomic per valid voxel, atomicAdd(float4*, float4):
// global memory only, compute capability 9.x, declared in the CUDA
// toolkit's crt/sm_90_rt.h (12.9 builds it).  The read-modify-writes
// resolve in the 50 MB L2; no zeroed row is written and no separate
// index_add_ reads one back.  The sum order is
// the atomics', not ascending j, so results match the plain version up to
// the rounding of the order.  Bound: bytes, 4 Cs + 4 Cs nvox + 16 Cs nvox
// (dvals) + 32 n_valid (read-modify-write).
//
// Neither kernel has a matrix product or a regular tile: tensor cores,
// wgmma and TMA do not apply to these irregular 16-byte accesses.
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/extract.py, which checks
// shapes, types, contiguity and alignment and keeps Cs * nvox < 2^31.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBrickVoxels = 512;

// This thread's entry e = r * nvox + j, or -1 past the last one.  The
// index is formed in 64 bits: in the last block of a launch near 2^31
// entries a 32-bit one would wrap to a negative number below `total`.
__device__ __forceinline__ int entry(int total) {
  const long long e =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  return e < total ? static_cast<int>(e) : -1;
}

// The field row of entry e, or -1 where it is invalid.
__device__ __forceinline__ long long voxel_of(int e, int r, int pool,
                                              const int* __restrict__ slots,
                                              const int* __restrict__ lin) {
  const int l = __ldg(lin + e);
  const int s = __ldg(slots + r);
  if (l < 0 || l >= kBrickVoxels || s < 0 || s >= pool) return -1;
  return static_cast<long long>(s) * kBrickVoxels + l;
}

__global__ void __launch_bounds__(kThreads)
extract_fwd_kernel(int total, int nvox, int pool,
                   const float4* __restrict__ field4,
                   const int* __restrict__ slots, const int* __restrict__ lin,
                   float* __restrict__ vals) {
  const int e = entry(total);
  if (e < 0) return;
  const int r = e / nvox;
  const int j = e - r * nvox;
  const long long v = voxel_of(e, r, pool, slots, lin);
  const float4 x = v >= 0 ? __ldg(field4 + v) : make_float4(0.f, 0.f, 0.f, 0.f);
  float* out = vals + static_cast<long long>(r) * 4 * nvox + j;
  out[0] = x.x;
  out[nvox] = x.y;
  out[2 * nvox] = x.z;
  out[3 * nvox] = x.w;
}

__global__ void __launch_bounds__(kThreads)
extract_bwd_kernel(int total, int nvox, int pool, float4* __restrict__ dfield4,
                   const int* __restrict__ slots, const int* __restrict__ lin,
                   const float* __restrict__ dvals) {
  const int e = entry(total);
  if (e < 0) return;
  const int r = e / nvox;
  const int j = e - r * nvox;
  const long long v = voxel_of(e, r, pool, slots, lin);
  if (v < 0) return;
  const float* d = dvals + static_cast<long long>(r) * 4 * nvox + j;
  atomicAdd(dfield4 + v, make_float4(d[0], d[nvox], d[2 * nvox], d[3 * nvox]));
}

int blocks_for(int total) {
  return static_cast<int>((static_cast<long long>(total) + kThreads - 1) /
                          kThreads);
}

}  // namespace

extern "C" int extract_fwd_launch(int cs, int nvox, int pool,
                                  const void* field4, const int* slots,
                                  const int* lin, float* vals, void* stream) {
  const int total = cs * nvox;
  if (total > 0) {
    extract_fwd_kernel<<<blocks_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        total, nvox, pool, static_cast<const float4*>(field4), slots, lin,
        vals);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int extract_bwd_launch(int cs, int nvox, int pool, void* dfield4,
                                  const int* slots, const int* lin,
                                  const float* dvals, void* stream) {
  const int total = cs * nvox;
  if (total > 0) {
    extract_bwd_kernel<<<blocks_for(total), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        total, nvox, pool, static_cast<float4*>(dfield4), slots, lin, dvals);
  }
  return static_cast<int>(cudaGetLastError());
}
