// Separable gaussian blur of one f32 layer, H pass then V pass, with the
// difference-of-gaussians layer y - x written in the same pass.
//
// Replaces: vulkansift_tpu/ops/pallas_blur.py::blur_dog_tpu (the TPU's fused
// blur + DoG kernel); plain version: ops/blur.py::blur_dog_plain.
//
// Semantics: symmetric (MIRRORED_REPEAT) borders, x[-1-m] = x[m] and
// x[n+m] = x[n-1-m], and the plain version's accumulation order exactly:
// acc = x[i]*t0, then acc = acc + (x[i-j] + x[i+j])*tj for j = 1..k. The
// H-pass result is stored as f32 before the V pass. Built with
// --fmad=false, so every product and sum rounds as in the plain version.
//
// Bound on the H100: memory. Each layer is read once and y (and dog)
// written once: 8-12 bytes per pixel against 2*(1+3k)+1 = 79 flops at
// k = 13, under the card's f32 balance of ~20 flops per byte (67 TFLOP/s
// over 3.35 TB/s). Design: one 64x32 output tile
// per block; the tile and its +-k halo (rows mirrored at the image border)
// are staged in shared memory, the H pass writes a (32+2k)x64 f32 buffer in
// shared memory and the V pass reads it, so each input pixel comes from
// device memory once per tile (halo re-reads hit L2) and nothing
// intermediate goes back to device memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define VKS_MAX_K 19  // half-kernel taps <= MAX_GAUSSIAN_KERNEL_SIZE = 20
#define TILE_W 64
#define TILE_H 32
#define THREADS 256

struct Taps {
  float t[VKS_MAX_K + 1];
};

__device__ __forceinline__ int reflect_index(int i, int n) {
  // Symmetric reflection with period 2n (numpy's "symmetric" padding).
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

__global__ void __launch_bounds__(THREADS)
blur_dog_kernel(const float* __restrict__ x, float* __restrict__ y,
                float* __restrict__ dog, Taps taps, int k, int H, int W) {
  extern __shared__ float smem[];
  const int iw = TILE_W + 2 * k;
  const int ih = TILE_H + 2 * k;
  float* in = smem;            // ih x iw input tile with halo
  float* hb = smem + ih * iw;  // ih x TILE_W horizontal-pass result
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;

  for (int i = threadIdx.x; i < ih * iw; i += THREADS) {
    const int r = i / iw, c = i - r * iw;
    const int gy = reflect_index(y0 - k + r, H);
    const int gx = reflect_index(x0 - k + c, W);
    in[i] = x[(size_t)gy * W + gx];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < ih * TILE_W; i += THREADS) {
    const int r = i / TILE_W, c = i - r * TILE_W;
    const float* p = in + r * iw + c + k;
    float acc = p[0] * taps.t[0];
    for (int j = 1; j <= k; ++j) acc = acc + (p[-j] + p[j]) * taps.t[j];
    hb[i] = acc;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, c = i - r * TILE_W;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
    const float* p = hb + (r + k) * TILE_W + c;
    float acc = p[0] * taps.t[0];
    for (int j = 1; j <= k; ++j)
      acc = acc + (p[-j * TILE_W] + p[j * TILE_W]) * taps.t[j];
    const size_t o = (size_t)gy * W + gx;
    y[o] = acc;
    if (dog != nullptr) dog[o] = acc - in[(r + k) * iw + c + k];
  }
}

extern "C" int vks_blur_dog(const void* x, void* y, void* dog,
                            const float* taps_host, int ntaps, int H, int W,
                            void* stream) {
  if (ntaps < 1 || ntaps > VKS_MAX_K + 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int j = 0; j < VKS_MAX_K + 1; ++j)
    taps.t[j] = j < ntaps ? taps_host[j] : 0.0f;
  const int k = ntaps - 1;
  const size_t smem =
      sizeof(float) * ((TILE_H + 2 * k) * (TILE_W + 2 * k) +
                       (TILE_H + 2 * k) * TILE_W);
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  blur_dog_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, (float*)dog, taps, k, H, W);
  return (int)cudaGetLastError();
}
