// Raw 128-bin SIFT descriptor per live (keypoint, orientation) pair.
//
// Replaces: vulkansift_tpu/ops/pallas_backhalf.py::descriptor_tpu and
// descriptor_tpu_packed (the same function at window edges 89 and 49/63);
// one kernel here serves every window size, the radius being read per
// pair. Plain version: ops/descriptor.py::raw_descriptors.
//
// Per pair: the box of radius floor(sqrt(2)*3*sigma*(4+1)/2 + 0.5) around
// (cx, cy) in the sampled gaussian layer (a base offset, width and height
// per pair, straight from the per-octave stacks); central-difference
// gradients; the offset rotated by the orientation in units of
// lambda = 3*sigma; weight exp(-(ox^2+oy^2)/8) * |g|; trilinear hat
// weights into 4x4 cells x 8 orientation bins, UBC or VLFeat direction.
// Normalisation and the u8 quantisation stay in PyTorch. The TPU kernel
// accumulated the 128 bins as a bf16 matrix product; here they accumulate
// in f32.
//
// The launch covers the static capacity; each block reads the live pair
// count from device memory and returns early past it.
//
// Bound on the H100: the per-pixel arithmetic (atan2f, expf, sqrtf,
// sincos per pair and ~8 weighted shared-memory updates per pixel) more
// than the window bytes, which are mostly L2 hits. One block of 64
// threads per pair. Determinism: each thread accumulates its own pixels,
// in a fixed order, into its own padded 128-bin row in shared memory (no
// float atomics); thread t then sums bins t and t+64 over the 64 rows in
// thread order.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 64
#define NBINS 128
#define ROW 129  // padded row stride of the per-thread histograms

__device__ __forceinline__ float mod_pos(float a, float b) {
  // Python-style remainder with b > 0 (torch.remainder, jnp.mod).
  float m = fmodf(a, b);
  if (m != 0.0f && (m < 0.0f)) m = m + b;
  return m;
}

__global__ void __launch_bounds__(THREADS)
descriptor_kernel(const float* __restrict__ flat,
                  const long long* __restrict__ base,
                  const float* __restrict__ rec,
                  const int* __restrict__ count, float* __restrict__ desc,
                  int max_radius, int vlfeat) {
  __shared__ float part[THREADS * ROW];
  const int pr = blockIdx.x;
  if (pr >= *count) return;
  const float* r = rec + (size_t)pr * 8;
  const float sx = r[0], sy = r[1], sig = r[2];
  const int cx = (int)r[3], cy = (int)r[4], w = (int)r[5], h = (int)r[6];
  const float ori = r[7];
  const float* img = flat + base[pr];
  const float TWO_PI = (float)(2.0 * 3.141592653589793);
  const float BIN_SCALE = (float)(8.0 / (2.0 * 3.141592653589793));
  const float SQRT2 = (float)1.4142135623730951;

  float* mine = part + threadIdx.x * ROW;
  for (int b = 0; b < NBINS; ++b) mine[b] = 0.0f;

  const float slam = 3.0f * sig;
  const float radius = ((SQRT2 * slam) * 5.0f) * 0.5f;
  const float ir = floorf(radius + 0.5f);
  const float fx = sx - (float)cx;
  const float fy = sy - (float)cy;
  const float inv_lambda = 1.0f / slam;
  const float kcos = cosf(ori) * inv_lambda;
  const float ksin = sinf(ori) * inv_lambda;
  int rad = (int)ir;
  if (rad > max_radius) rad = max_radius;
  if (rad < 0) rad = -1;
  const int edge = 2 * rad + 1;
  const int npix = edge > 0 ? edge * edge : 0;

  for (int p = threadIdx.x; p < npix; p += THREADS) {
    const int dy = p / edge - rad, dx = p % edge - rad;
    const int px = cx + dx, py = cy + dy;
    if (px < 1 || px >= w - 1 || py < 1 || py >= h - 1) continue;
    const float* q = img + (size_t)py * w + px;
    const float gx = 0.5f * (q[1] - q[-1]);
    const float gy = 0.5f * (q[w] - q[-w]);
    const float sdx = (float)dx - fx;
    const float sdy = (float)dy - fy;
    const float ox = kcos * sdx + ksin * sdy;
    const float oy = kcos * sdy - ksin * sdx;
    const float mag =
        expf(-0.125f * (ox * ox + oy * oy)) * sqrtf(gx * gx + gy * gy);
    float theta = atan2f(gy, gx);
    if (theta < 0.0f) theta = theta + TWO_PI;
    const float rel = mod_pos(theta - ori, TWO_PI);
    const float fbin =
        vlfeat ? rel * BIN_SCALE : mod_pos(-rel, TWO_PI) * BIN_SCALE;
    const float ty = (oy + 2.0f) - 0.5f;
    const float tx = (ox + 2.0f) - 0.5f;
    const int y0 = (int)floorf(ty), x0 = (int)floorf(tx);
    const int o0 = (int)floorf(fbin);
    for (int iy = y0; iy <= y0 + 1; ++iy) {
      if (iy < 0 || iy > 3) continue;
      const float wy = fmaxf(0.0f, 1.0f - fabsf((float)iy - ty));
      for (int ix = x0; ix <= x0 + 1; ++ix) {
        if (ix < 0 || ix > 3) continue;
        const float wx = fmaxf(0.0f, 1.0f - fabsf((float)ix - tx));
        for (int io = o0; io <= o0 + 1; ++io) {
          const int o = ((io % 8) + 8) % 8;
          const float od = fabsf((float)o - fbin);
          const float wo = fmaxf(0.0f, 1.0f - fminf(od, 8.0f - od));
          const int bin = iy * 32 + ix * 8 + o;
          mine[bin] = mine[bin] + wy * ((wx * wo) * mag);
        }
      }
    }
  }
  __syncthreads();

  for (int b = threadIdx.x; b < NBINS; b += THREADS) {
    float acc = 0.0f;
    for (int t = 0; t < THREADS; ++t) acc = acc + part[t * ROW + b];
    desc[(size_t)pr * NBINS + b] = acc;
  }
}

extern "C" int vks_descriptor(const void* flat, const void* base,
                              const void* rec, const void* count, void* desc,
                              int capacity, int max_radius, int vlfeat,
                              void* stream) {
  if (capacity < 0 || max_radius < 0) return (int)cudaErrorInvalidValue;
  if (capacity == 0) return (int)cudaGetLastError();
  descriptor_kernel<<<capacity, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)flat, (const long long*)base, (const float*)rec,
      (const int*)count, (float*)desc, max_radius, vlfeat);
  return (int)cudaGetLastError();
}
