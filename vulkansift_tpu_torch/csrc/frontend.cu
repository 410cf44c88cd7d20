// Dense keypoint frontend for one octave's DoG stack: per interior cell
// the strict 26-neighbour extremum test with the |v| > 0.8*threshold
// pre-filter (candidate bit 128) and the Newton walk code 0..107, plus the
// per-(layer, row) candidate counts.
//
// Replaces: vulkansift_tpu/ops/pallas_frontend.py::frontend_tpu; plain
// version: ops/extract.py::dense_frontend. Output layout (both):
// code[s-1][y-1][x-1], u8 (S, H-2, W-2); counts[s-1][y-1], i32 (S, H-2),
// zeroed by the caller.
//
// The walk code evaluates extract._walk_classify's expressions in the same
// order; with --fmad=false every operation rounds as in the plain version,
// so codes and candidates are bit-exact.
//
// Bound on the H100: memory. Each cell reads its (S+2) DoG layers once
// (4*(S+2) bytes) and writes S code bytes, against ~130 flops per centre
// cell, under the card's f32 balance once the 27 neighbours come from
// shared memory. Design: one thread per interior (y, x) column, 32x8
// threads per block; the block stages its (S+2) x 10 x 34 halo tile in
// shared memory once and loops over the centre layers. Each warp is one
// row segment: a ballot counts its candidates and one integer atomicAdd
// per warp adds them to the row count (integer sums do not depend on the
// order).

#include <cuda_runtime.h>
#include <stdint.h>

#define BX 32
#define BY 8
#define MAX_LAYERS 16

__global__ void __launch_bounds__(BX * BY)
frontend_kernel(const float* __restrict__ dog, uint8_t* __restrict__ code,
                int* __restrict__ counts, int ns, int H, int W,
                float thr08) {
  extern __shared__ float tile[];  // ns x (BY+2) x (BX+2)
  const int TW = BX + 2, TH = BY + 2;
  const int x0 = blockIdx.x * BX;  // interior cells x0+1 .. x0+BX
  const int y0 = blockIdx.y * BY;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * BX + tx;
  const size_t plane = (size_t)H * W;

  for (int i = tid; i < ns * TH * TW; i += BX * BY) {
    const int l = i / (TH * TW);
    const int r = (i / TW) % TH;
    const int c = i % TW;
    const int gy = min(y0 + r, H - 1);
    const int gx = min(x0 + c, W - 1);
    tile[i] = dog[l * plane + (size_t)gy * W + gx];
  }
  __syncthreads();

  const int y = y0 + ty + 1, x = x0 + tx + 1;
  const bool inside = (y <= H - 2) && (x <= W - 2);
  const int h2 = H - 2, w2 = W - 2;

  for (int s = 1; s <= ns - 2; ++s) {
#define N(a, b, c) tile[((s - 1 + (a)) * TH + ty + (b)) * TW + tx + (c)]
    const float n000 = N(0, 0, 0), n001 = N(0, 0, 1), n002 = N(0, 0, 2);
    const float n010 = N(0, 1, 0), n011 = N(0, 1, 1), n012 = N(0, 1, 2);
    const float n020 = N(0, 2, 0), n021 = N(0, 2, 1), n022 = N(0, 2, 2);
    const float n100 = N(1, 0, 0), n101 = N(1, 0, 1), n102 = N(1, 0, 2);
    const float n110 = N(1, 1, 0), n111 = N(1, 1, 1), n112 = N(1, 1, 2);
    const float n120 = N(1, 2, 0), n121 = N(1, 2, 1), n122 = N(1, 2, 2);
    const float n200 = N(2, 0, 0), n201 = N(2, 0, 1), n202 = N(2, 0, 2);
    const float n210 = N(2, 1, 0), n211 = N(2, 1, 1), n212 = N(2, 1, 2);
    const float n220 = N(2, 2, 0), n221 = N(2, 2, 1), n222 = N(2, 2, 2);
#undef N
    // Strict 26-neighbour extremum (max/min are exact in any order).
    float mx = n000, mn = n000;
    const float nbs[25] = {n001, n002, n010, n011, n012, n020, n021, n022,
                           n100, n101, n102, n110, n112, n120, n121, n122,
                           n200, n201, n202, n210, n211, n212, n220, n221,
                           n222};
#pragma unroll
    for (int i = 0; i < 25; ++i) {
      mx = fmaxf(mx, nbs[i]);
      mn = fminf(mn, nbs[i]);
    }
    const float ctr = n111;
    const bool cand =
        inside && (fabsf(ctr) > thr08) && ((ctr > mx) || (ctr < mn));

    // Walk code: extract._walk_classify, same expressions, same order.
    const float g_s = 0.5f * (n211 - n011);
    const float g_x = 0.5f * (n112 - n110);
    const float g_y = 0.5f * (n121 - n101);
    const float h11 = (n211 + n011) - 2.0f * ctr;
    const float h22 = (n112 + n110) - 2.0f * ctr;
    const float h33 = (n121 + n101) - 2.0f * ctr;
    const float h12 = 0.25f * (((n212 - n210) - n012) + n010);
    const float h13 = 0.25f * (((n221 - n201) - n021) + n001);
    const float h23 = 0.25f * (((n122 - n120) - n102) + n100);
    const float m11 = h22 * h33 - h23 * h23;
    const float m12 = h12 * h33 - h13 * h23;
    const float m13 = h12 * h23 - h13 * h22;
    const float det = (h11 * m11 - h12 * m12) + h13 * m13;
    const bool singular = det == 0.0f;
    const float num_s = ((-g_s) * m11 + g_x * m12) - g_y * m13;
    const float num_x =
        (g_s * m12 - g_x * (h11 * h33 - h13 * h13)) +
        g_y * (h11 * h23 - h13 * h12);
    const float num_y =
        ((-g_s) * m13 + g_x * (h11 * h23 - h12 * h13)) -
        g_y * (h11 * h22 - h12 * h12);
    const float thr = 0.6f * fabsf(det);
    const bool neg = det < 0.0f;
    const float ns_ = neg ? -num_s : num_s;
    const float nx_ = neg ? -num_x : num_x;
    const float ny_ = neg ? -num_y : num_y;
    const int cs = ns_ >= thr ? 2 : (ns_ <= -thr ? 0 : 1);
    const int cx = nx_ >= thr ? 2 : (nx_ <= -thr ? 0 : 1);
    const int cy = ny_ >= thr ? 2 : (ny_ <= -thr ? 0 : 1);
    const int conv = (cs == 1) && (cx == 1) && (cy == 1);
    const int c = cs + 3 * cx + 9 * cy + 27 * conv + 54 * (int)singular +
                  128 * (int)cand;
    if (inside)
      code[((size_t)(s - 1) * h2 + (y - 1)) * w2 + (x - 1)] = (uint8_t)c;

    const unsigned bal = __ballot_sync(0xffffffffu, cand);
    if (tx == 0 && bal != 0u)
      atomicAdd(&counts[(s - 1) * h2 + (y - 1)], __popc(bal));
  }
}

extern "C" int vks_frontend(const void* dog, void* code, void* counts,
                            int ns, int H, int W, float thr08, void* stream) {
  if (ns < 3 || ns > MAX_LAYERS || H < 3 || W < 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ns * (BY + 2) * (BX + 2);
  dim3 grid((W - 2 + BX - 1) / BX, (H - 2 + BY - 1) / BY);
  dim3 block(BX, BY);
  frontend_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const float*)dog, (uint8_t*)code, (int*)counts, ns, H, W, thr08);
  return (int)cudaGetLastError();
}
