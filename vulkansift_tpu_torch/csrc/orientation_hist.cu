// Raw 36-bin orientation histogram per live keypoint.
//
// Replaces: vulkansift_tpu/ops/pallas_backhalf.py::orientation_hist_tpu
// (and its 2-keypoints-per-step twin orientation_hist_tpu_packed, which
// computes the same function); plain version:
// ops/orientation.py::raw_histograms.
//
// Per keypoint: the box of radius min(floor(3*1.5*sigma), max_radius)
// around (cx, cy) in its sampled gaussian layer (a base offset, width and
// height per keypoint, straight from the per-octave stacks),
// central-difference gradients, magnitude * exp(-d^2 / (2*(1.5 sigma)^2)),
// bin floor(atan2f(gy, gx) mod 2pi * 36/2pi). Gradient stencils outside
// the image are excluded. Expressions follow the plain version's order;
// --fmad=false keeps their rounding, so each term rounds as the plain
// version's does and only the order of the sum differs.
//
// Bound on the H100: the instructions a cell issues (~140 in the SASS
// loop, a static count; over half of them atan2f, expf and sqrtf) more
// than the window bytes, which are mostly L1/L2 hits. Design:
//  * a persistent grid sized to the card (SMs x 10 blocks of 4 warps,
//    fewer for a small capacity), not to the capacity. One warp owns one
//    keypoint at a time and takes keypoints g, g + G, ... up to the live
//    count read on the device (warp g = warp * gridDim + block, so a
//    count past G spreads its extra keypoints over every SM). Ten blocks
//    an SM hold ~5300 warps, one keypoint each at a 1536x1024 frame;
//  * the grid also writes zeros to the rows past the count (each warp once
//    its keypoints are done), so the caller allocates the output without a
//    fill;
//  * the box is clipped once per keypoint to the cells whose stencil lies
//    inside the layer, and its ew x eh cells are numbered in raster order;
//    lane l takes the numbers l, l + 32, ..., carrying its offset and its
//    (dx, dy) as exact floats (one reciprocal per keypoint, no division
//    per cell), so neighbouring lanes read neighbouring pixels and every
//    lane of a step but the last has a cell, whatever the radius (no fixed
//    cap: radius 28 at one scale an octave);
//  * each lane adds its cells, in its fixed order, into its own column of
//    the warp's 36-bin x 32-lane float histogram in shared memory (one bank
//    a lane: no conflicts, no atomics). The warp then sums each bin's 32
//    columns in a fixed order: lane l reads bin l's column j ^ l at step j
//    (32 banks at every step) into four chains, and 8 lanes each share
//    bins 32..35 and combine by a butterfly; the reads clear the columns
//    for the next keypoint. No float atomics and no order that depends on
//    the schedule: two launches give the same bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 4
#define THREADS (WARPS * 32)
#define BLOCKS_PER_SM 10
#define NBINS 36
#define FULL 0xffffffffu

// The warp's histogram: bin b of lane l at part[(b * WARPS + warp) * 32 + l].

// Sums and clears the warp's 36 x 32 columns; writes the keypoint's row.
__device__ __forceinline__ void reduce_row(float* part, int warp, int lane,
                                           float* out) {
  const int ia = (lane * WARPS + warp) * 32 + lane;
  float acc[4];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float x = part[ia ^ j];
    part[ia ^ j] = 0.0f;
    acc[j & 3] = j < 4 ? x : acc[j & 3] + x;
  }
  out[lane] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
  // Bins 32..35: lane l sums columns 4 g .. 4 g + 3 (g = l >> 2) of bin
  // 32 + (l & 3), read in the order (l & 3) ^ i; the 8 lanes of a bin then
  // combine by a butterfly (the same bits on all 8: addition commutes).
  const int m = lane & 3, g = lane >> 2;
  const int ib = ((32 + m) * WARPS + warp) * 32 + 4 * g + m;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float x = part[ib ^ i];
    part[ib ^ i] = 0.0f;
    s = i == 0 ? x : s + x;
  }
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) s = s + __shfl_xor_sync(FULL, s, o);
  if (g == 0) out[32 + m] = s;
}

// This lane's cells of the keypoint's window, added into its column col
// (bin b at col[b * WARPS * 32]).
__device__ __forceinline__ void add_window(const float* __restrict__ flat,
                                           long long base, const float* r,
                                           int max_radius, float* col,
                                           int lane) {
  const float TWO_PI = (float)(2.0 * 3.141592653589793);
  const float BIN_SCALE = (float)(36.0 / (2.0 * 3.141592653589793));
  const float sx = r[0], sy = r[1], sig = r[2];
  const int cx = (int)r[3], cy = (int)r[4], w = (int)r[5], h = (int)r[6];
  const float slam = 1.5f * sig;
  const float br = floorf(3.0f * slam);
  const float expf_scale = -1.0f / ((2.0f * slam) * slam);
  const float fx = sx - (float)cx;
  const float fy = sy - (float)cy;
  // -1 (empty) for a negative or NaN radius.
  const int rad = !(br >= 0.0f) ? -1
                  : (br > (float)max_radius ? max_radius : (int)br);
  // The box clipped to the cells whose gradient stencil lies inside the
  // layer: offsets [x0, x0 + ew) x [y0, y0 + eh) from (cx, cy).
  const int x0 = max(-rad, 1 - cx), y0 = max(-rad, 1 - cy);
  const int ew = min(rad, w - 2 - cx) - x0 + 1;
  const int eh = min(rad, h - 2 - cy) - y0 + 1;
  if (ew <= 0 || eh <= 0) return;
  // Cell number k = row * ew + c lies at in-layer offset row * w + c from
  // the box's first cell. floor(k / ew) for k <= 32 from a rounded
  // reciprocal is exact: (k + 0.5) / ew lies at least 1 / 65 of itself
  // from an integer.
  const float rcp = __frcp_rn((float)ew);
  const int rstep = (int)(32.5f * rcp), cstep = 32 - rstep * ew;
  const int row = (int)(((float)lane + 0.5f) * rcp), c = lane - row * ew;
  const float* img = flat + base + (long long)(cy + y0) * w + (cx + x0);
  int off = row * w + c;
  const int ostep = rstep * w + cstep, owrap = w - ew;
  float dx = (float)(x0 + c), dy = (float)(y0 + row);
  const float fcstep = (float)cstep, frstep = (float)rstep;
  const float few = (float)ew;
  const float xend = (float)(x0 + ew), yend = (float)(y0 + eh);
  while (dy < yend) {
    const float gx = 0.5f * (img[off + 1] - img[off - 1]);
    const float gy = 0.5f * (img[off + w] - img[off - w]);
    const float sdx = dx - fx;
    const float sdy = dy - fy;
    const float sqrdist = sdx * sdx + sdy * sdy;
    const float mag = expf(sqrdist * expf_scale) * sqrtf(gx * gx + gy * gy);
    float theta = atan2f(gy, gx);
    if (theta < 0.0f) theta = theta + TWO_PI;
    int bin = (int)floorf(theta * BIN_SCALE);
    bin = bin < 0 ? 0 : (bin > NBINS - 1 ? NBINS - 1 : bin);
    col[bin * (WARPS * 32)] = col[bin * (WARPS * 32)] + mag;
    off += ostep;
    dx = dx + fcstep;
    dy = dy + frstep;
    if (dx >= xend) {
      dx = dx - few;
      dy = dy + 1.0f;
      off += owrap;
    }
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
orientation_hist_kernel(const float* __restrict__ flat,
                        const long long* __restrict__ base,
                        const float* __restrict__ rec,
                        const int* __restrict__ count,
                        float* __restrict__ hist, int capacity,
                        int max_radius) {
  __shared__ float part[NBINS * WARPS * 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* col = part + warp * 32 + lane;
#pragma unroll
  for (int b = 0; b < NBINS; ++b) col[b * (WARPS * 32)] = 0.0f;
  const int n = max(min(*count, capacity), 0);
  const int nwarps = gridDim.x * WARPS;
  for (int kp = warp * gridDim.x + blockIdx.x; kp < n; kp += nwarps) {
    add_window(flat, base[kp], rec + (size_t)kp * 8, max_radius, col, lane);
    __syncwarp();
    reduce_row(part, warp, lane, hist + (size_t)kp * NBINS);
    __syncwarp();
  }
  // Rows [n, capacity), written after the keypoints so that warps whose
  // windows end early do it: 9 float4 a row (144 bytes; 16-byte aligned).
  float4* dead = reinterpret_cast<float4*>(hist + (size_t)n * NBINS);
  const size_t ndead = (size_t)(capacity - n) * (NBINS / 4);
  for (size_t i = (size_t)blockIdx.x * THREADS + threadIdx.x; i < ndead;
       i += (size_t)gridDim.x * THREADS)
    dead[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// hist: capacity x 36 floats, 16-byte aligned; every row is written (rows
// past the count as zeros), so the caller need not fill it
// (ops/backhalf.py _launch_orientation_hist).
extern "C" int vks_orientation_hist(const void* flat, const void* base,
                                    const void* rec, const void* count,
                                    void* hist, int capacity, int max_radius,
                                    void* stream) {
  if (capacity < 0 || max_radius < 0 || ((uintptr_t)hist & 15))
    return (int)cudaErrorInvalidValue;
  if (capacity == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int blocks = min(sms * BLOCKS_PER_SM, (capacity + WARPS - 1) / WARPS);
  orientation_hist_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)flat, (const long long*)base, (const float*)rec,
      (const int*)count, (float*)hist, capacity, max_radius);
  return (int)cudaGetLastError();
}
