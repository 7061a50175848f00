// Kernel W2 as brickmap_tpu_torch/csrc/wave.cu had it before its redesign,
// kept verbatim (kernel and launcher, renamed) as the baseline that
// notes/probe_torch_w2.py times the redesign against: a thread a row of
// the capacity, each past the count returning at once, its [*, 3] outputs
// stored as three 4-byte words a thread.  The world-box clip it calls
// (clip_ray, with Box and Clip) is wave.cu's, unchanged by the redesign,
// so the library includes wave.cu and adds wave_gather_clip_pr14_launch
// with wave_gather_clip_launch's signature.  Built by the probe with the
// port's nvcc flags and -I brickmap_tpu_torch/csrc.

#include "wave.cu"

namespace {

// The rays at rows lanes[k], k < *count (W0's compaction), clipped to the
// world box.
__global__ void __launch_bounds__(kThreads)
gather_clip_pr14_kernel(const int* __restrict__ count,
                        const float* __restrict__ rays_o,
                        const float* __restrict__ rays_d,
                        const int* __restrict__ lanes, int* __restrict__ pos,
                        Box box, float* __restrict__ clipped,
                        float* __restrict__ dirs,
                        float* __restrict__ entry_normal,
                        float* __restrict__ tminn_out,
                        unsigned char* __restrict__ ok) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= *count) return;
  const int lane = lanes[k];
  if (pos != nullptr) pos[lane] = k;
  const float o[3] = {rays_o[3 * lane], rays_o[3 * lane + 1],
                      rays_o[3 * lane + 2]};
  const float d[3] = {rays_d[3 * lane], rays_d[3 * lane + 1],
                      rays_d[3 * lane + 2]};
  const Clip c = clip_ray(box, o, d);
  for (int a = 0; a < 3; ++a) {
    clipped[3 * k + a] = c.o[a];
    dirs[3 * k + a] = d[a];
    entry_normal[3 * k + a] = c.en[a];
  }
  tminn_out[k] = c.tmin;
  ok[k] = c.ok;
}

}  // namespace

extern "C" int wave_gather_clip_pr14_launch(
    int cap, const int* count, const float* rays_o, const float* rays_d,
    const int* lanes, int* pos, float hi_x, float hi_y,
    float hi_z, float center_x, float center_y, float center_z,
    float scale_xy, float eps, float* clipped, float* dirs,
    float* entry_normal, float* tminn, unsigned char* ok, void* stream) {
  const Box box{{hi_x, hi_y, hi_z}, {center_x, center_y, center_z}, scale_xy,
                eps};
  if (cap > 0) {
    gather_clip_pr14_kernel<<<(cap + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        count, rays_o, rays_d, lanes, pos, box, clipped, dirs,
        entry_normal, tminn, ok);
  }
  return static_cast<int>(cudaGetLastError());
}
