// Kernels B4f and B4b: visited-voxel extraction for the brick-row replay of
// the sparse differentiable renderer, and its transpose.
//
// Replace the TPU kernels brickmap_tpu/pallas/extract.py::_fwd_kernel (:35)
// and ::_bwd_kernel (:55), paired by extract_rows_pallas (:79).  A field row
// is 4*nv floats wide (column f*nv + v: occupancy, then RGB albedo, of brick
// voxel v); lin [Cs, nvox] names the voxels a segment visits.
//
// B4f (extract_fwd_kernel): vals[r, f*nvox + j] = rows[r, f*nv + lin[r, j]],
// or 0 where lin[r, j] lies outside [0, nv).  The TPU kernel streamed whole
// 2048-float rows through VMEM and ran one compare-select reduction per
// visited voxel; here one thread per (row, j) reads the 4 values lin names
// and nothing else of the row.  Bound: bytes, 4*nvox + 3*4*nvox*4 per row
// (lin, the values read, the values written).
//
// B4b (extract_bwd_kernel): drows[r, f*nv + v] = sum over j with lin[r, j] == v
// of dvals[r, f*nvox + j], in ascending j, and 0 for voxels no j names.  One
// block per row: lin and dvals go to shared memory, each thread owns voxels
// v = tid, tid + blockDim, ... and sums its matches in registers, so every
// float of the row is written once, without atomics, in the plain version's
// order (bit-equal to it).  Bound: bytes, dominated by writing the whole
// 4*nv-float row.
//
// Built by brickmap_tpu_torch/kernels/build.py (nvcc, sm_90a, -fmad=false);
// bound with ctypes by brickmap_tpu_torch/kernels/extract.py.

#include <cuda_runtime.h>

namespace {

constexpr int kFwdThreads = 256;
constexpr int kBwdThreads = 128;

__global__ void __launch_bounds__(kFwdThreads)
extract_fwd_kernel(int cs, int nv, int nvox, const float* __restrict__ rows,
                   const int* __restrict__ lin, float* __restrict__ vals) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (e >= static_cast<long long>(cs) * nvox) return;
  const long long r = e / nvox;
  const int j = static_cast<int>(e - r * nvox);
  const int l = lin[e];
  const bool valid = l >= 0 && l < nv;
  const float* row = rows + r * 4 * nv;
  float* out = vals + r * 4 * nvox + j;
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    out[f * nvox] = valid ? row[f * nv + l] : 0.0f;
  }
}

__global__ void __launch_bounds__(kBwdThreads)
extract_bwd_kernel(int nv, int nvox, const int* __restrict__ lin,
                   const float* __restrict__ dvals,
                   float* __restrict__ drows) {
  extern __shared__ int smem[];
  int* s_lin = smem;                                     // [nvox]
  float* s_dv = reinterpret_cast<float*>(smem + nvox);   // [4 * nvox]
  const long long r = blockIdx.x;
  for (int t = threadIdx.x; t < nvox; t += blockDim.x) {
    s_lin[t] = lin[r * nvox + t];
  }
  for (int t = threadIdx.x; t < 4 * nvox; t += blockDim.x) {
    s_dv[t] = dvals[r * 4 * nvox + t];
  }
  __syncthreads();
  float* out = drows + r * 4 * nv;
  for (int v = threadIdx.x; v < nv; v += blockDim.x) {
    float acc0 = 0.0f, acc1 = 0.0f, acc2 = 0.0f, acc3 = 0.0f;
    for (int j = 0; j < nvox; ++j) {
      if (s_lin[j] == v) {
        acc0 = acc0 + s_dv[j];
        acc1 = acc1 + s_dv[nvox + j];
        acc2 = acc2 + s_dv[2 * nvox + j];
        acc3 = acc3 + s_dv[3 * nvox + j];
      }
    }
    out[v] = acc0;
    out[nv + v] = acc1;
    out[2 * nv + v] = acc2;
    out[3 * nv + v] = acc3;
  }
}

}  // namespace

extern "C" int extract_fwd_launch(int cs, int nv, int nvox, const float* rows,
                                  const int* lin, float* vals, void* stream) {
  const long long total = static_cast<long long>(cs) * nvox;
  if (total > 0) {
    const int blocks =
        static_cast<int>((total + kFwdThreads - 1) / kFwdThreads);
    extract_fwd_kernel<<<blocks, kFwdThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(cs, nv, nvox,
                                                              rows, lin, vals);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int extract_bwd_launch(int cs, int nv, int nvox, const int* lin,
                                  const float* dvals, float* drows,
                                  void* stream) {
  if (cs > 0) {
    const size_t shared = static_cast<size_t>(5 * nvox) * sizeof(int);
    extract_bwd_kernel<<<cs, kBwdThreads, shared,
                         static_cast<cudaStream_t>(stream)>>>(nv, nvox, lin,
                                                              dvals, drows);
  }
  return static_cast<int>(cudaGetLastError());
}
