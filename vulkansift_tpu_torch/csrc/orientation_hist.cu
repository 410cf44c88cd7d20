// Raw 36-bin orientation histogram per live keypoint.
//
// Replaces: vulkansift_tpu/ops/pallas_backhalf.py::orientation_hist_tpu
// (and its 2-keypoints-per-step twin orientation_hist_tpu_packed, which
// computes the same function); plain version:
// ops/orientation.py::raw_histograms.
//
// Per keypoint: the box of radius floor(3*1.5*sigma) around (cx, cy) in
// its sampled gaussian layer (a base offset, width and height per
// keypoint, straight from the per-octave stacks), central-difference
// gradients, magnitude * exp(-d^2 / (2*(1.5 sigma)^2)), bin
// floor(atan2f(gy, gx) mod 2pi * 36/2pi). Gradient stencils outside the
// image are excluded. Expressions follow the plain version's order;
// --fmad=false keeps their rounding.
//
// The launch covers the static capacity; each block reads the live count
// from device memory and returns early past it (the counterpart of the
// TPU's dynamic grid). Rows past the count are left as the caller
// allocated them (zeros).
//
// Bound on the H100: memory for the window reads at small windows,
// otherwise the per-pixel special functions (atan2f, expf, sqrtf); one
// block of 128 threads per keypoint keeps every SM busy with ~15k live
// keypoints. Determinism: each thread accumulates its own pixels, in a
// fixed order, into its own row of a per-block shared-memory histogram
// (no float atomics); thread b < 36 then sums bin b over the 128 rows in
// thread order. The result does not change from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 128
#define NBINS 36
#define ROW 37  // padded row stride of the per-thread histograms

__global__ void __launch_bounds__(THREADS)
orientation_hist_kernel(const float* __restrict__ flat,
                        const long long* __restrict__ base,
                        const float* __restrict__ rec,
                        const int* __restrict__ count,
                        float* __restrict__ hist, int max_radius) {
  __shared__ float part[THREADS * ROW];
  const int kp = blockIdx.x;
  if (kp >= *count) return;
  const float* r = rec + (size_t)kp * 8;
  const float sx = r[0], sy = r[1], sig = r[2];
  const int cx = (int)r[3], cy = (int)r[4], w = (int)r[5], h = (int)r[6];
  const float* img = flat + base[kp];
  const float TWO_PI = (float)(2.0 * 3.141592653589793);
  const float BIN_SCALE = (float)(36.0 / (2.0 * 3.141592653589793));

  for (int b = 0; b < NBINS; ++b) part[threadIdx.x * ROW + b] = 0.0f;

  const float slam = 1.5f * sig;
  const float br = floorf(3.0f * slam);
  const float expf_scale = -1.0f / ((2.0f * slam) * slam);
  const float fx = sx - (float)cx;
  const float fy = sy - (float)cy;
  int rad = (int)br;
  if (rad > max_radius) rad = max_radius;
  if (rad < 0) rad = -1;  // empty box
  const int edge = 2 * rad + 1;
  const int npix = edge > 0 ? edge * edge : 0;

  float* mine = part + threadIdx.x * ROW;
  for (int p = threadIdx.x; p < npix; p += THREADS) {
    const int dy = p / edge - rad, dx = p % edge - rad;
    const int px = cx + dx, py = cy + dy;
    if (px < 1 || px >= w - 1 || py < 1 || py >= h - 1) continue;
    const float* q = img + (size_t)py * w + px;
    const float gx = 0.5f * (q[1] - q[-1]);
    const float gy = 0.5f * (q[w] - q[-w]);
    const float sdx = (float)dx - fx;
    const float sdy = (float)dy - fy;
    const float sqrdist = sdx * sdx + sdy * sdy;
    const float mag = expf(sqrdist * expf_scale) * sqrtf(gx * gx + gy * gy);
    float theta = atan2f(gy, gx);
    if (theta < 0.0f) theta = theta + TWO_PI;
    int bin = (int)floorf(theta * BIN_SCALE);
    bin = bin < 0 ? 0 : (bin > NBINS - 1 ? NBINS - 1 : bin);
    mine[bin] = mine[bin] + mag;
  }
  __syncthreads();

  if (threadIdx.x < NBINS) {
    float acc = 0.0f;
    for (int t = 0; t < THREADS; ++t) acc = acc + part[t * ROW + threadIdx.x];
    hist[(size_t)kp * NBINS + threadIdx.x] = acc;
  }
}

extern "C" int vks_orientation_hist(const void* flat, const void* base,
                                    const void* rec, const void* count,
                                    void* hist, int capacity, int max_radius,
                                    void* stream) {
  if (capacity < 0 || max_radius < 0) return (int)cudaErrorInvalidValue;
  if (capacity == 0) return (int)cudaGetLastError();
  orientation_hist_kernel<<<capacity, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)flat, (const long long*)base, (const float*)rec,
      (const int*)count, (float*)hist, max_radius);
  return (int)cudaGetLastError();
}
