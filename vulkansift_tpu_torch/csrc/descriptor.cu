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
// as fixed-point integers (below).
//
// Bound on the H100: the per-pixel arithmetic (atan2, sqrt and ~8
// weighted histogram updates per pixel) more than the window bytes, which
// are mostly L1/L2 hits. Design:
//  * a persistent grid sized to the card (SMs x 10 blocks of 4 warps, fewer
//    for a small capacity), not to the capacity: each block takes the next
//    pair from a work counter until the live count, so radii from 4 to 44
//    px balance; one block owns one pair, so the result does not depend on
//    the schedule. Rows past the count are left as the caller zeroed them;
//  * per pair, 128-bin histograms of int32 fixed-point values in shared
//    memory (one per warp, each in 4 interleaved copies by lane, to spread
//    same-bin updates over banks), updated by integer shared-memory
//    atomics: integer addition does not depend on the order, so two
//    launches give the same bytes. The scale is set per pair from gmax,
//    the pair's largest gradient magnitude (a first pass over the
//    window's pixels): 2^k is the largest power of two with
//    2^k * gmax <= L, L = (2^31 - 1) / edge^2. A contribution is at most
//    gmax (its weights are at most 1), is rounded to the nearest multiple
//    of 2^-k and is capped at L, so a bin (at most one contribution per
//    pixel) cannot overflow, and each contribution is off by at most
//    gmax / L (gmax * 2^-18 at the 89-pixel window): the same share of the
//    pair's gradients at any contrast;
//  * per-pair work out of the pixel loop: the gaussian weight factors
//    along the rotation-invariant sdx^2 + sdy^2 into two tables of 2r+1
//    values, and each window row's span of columns that can reach the
//    rotated 4x4 grid (about half the window) is solved once;
//  * the block walks only the pixels inside the spans, numbered in
//    raster order (coalesced reads of q[+-1] and q[+-w]), twice: once for
//    gmax, once to add. Thread t takes the numbers t, t + 128, ...: a
//    prefix sum of the span lengths gives the row of its first number by
//    binary search, and each later number's row by stepping forward from
//    the last, so every lane of a step has a pixel;
//  * held to a u8 tolerance, this kernel alone is built with fused
//    multiply-adds and uses fast intrinsics: __sincosf and __expf per pair,
//    x * rsqrt(x) for |g|, and a polynomial atan2 (1e-5 rad).

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 4
#define THREADS (WARPS * 32)
#define BLOCKS_PER_SM 10
#define NBINS 128
#define COPIES 4  // histogram copies per warp, by lane % 4
#define HPITCH 5  // ints per bin in a warp's histogram (odd: spreads banks)

struct Pair {
  const float* img;
  int w, h, cx, cy, rad, edge;
  float fx, fy, kcos, ksin, ori;
  float scale;  // 2^k, set once the pair's gmax is known
  int qmax;     // L
};

// The setup of one pair from its record (sx, sy, sigma, cx, cy, w, h,
// angle) and base offset.
__device__ __forceinline__ Pair make_pair(const float* r, long long base,
                                          const float* flat, int max_radius) {
  const float SQRT2 = (float)1.4142135623730951;
  Pair P;
  const float sx = r[0], sy = r[1], sig = r[2];
  P.cx = (int)r[3];
  P.cy = (int)r[4];
  P.w = (int)r[5];
  P.h = (int)r[6];
  P.ori = r[7];
  P.img = flat + base;
  const float slam = 3.0f * sig;
  const float radius = ((SQRT2 * slam) * 5.0f) * 0.5f;
  const float ir = floorf(radius + 0.5f);
  P.fx = sx - (float)P.cx;
  P.fy = sy - (float)P.cy;
  const float inv_lambda = 1.0f / slam;
  float sn, cs;
  __sincosf(P.ori, &sn, &cs);
  P.kcos = cs * inv_lambda;
  P.ksin = sn * inv_lambda;
  P.rad = !(ir >= 0.0f) ? -1 : (ir > (float)max_radius ? max_radius
                                                         : (int)ir);
  P.edge = 2 * P.rad + 1;
  // The fixed-point cap L = (2^31-1)/npix (see the header).
  const int npix = P.rad >= 0 ? P.edge * P.edge : 0;
  P.qmax = npix > 0 ? 0x7fffffff / npix : 0x7fffffff;
  P.scale = 1.0f;
  return P;
}

// The gradient magnitude of the pixel at window row iy_, column ix_: the
// same expression in the gmax pass and in add_pixel.
__device__ __forceinline__ float grad_mag(const Pair& P, int iy_, int ix_,
                                          float* gx, float* gy) {
  const float* q =
      P.img + (size_t)(P.cy + iy_ - P.rad) * P.w + (P.cx + ix_ - P.rad);
  *gx = 0.5f * (q[1] - q[-1]);
  *gy = 0.5f * (q[P.w] - q[-P.w]);
  const float g2 = *gx * *gx + *gy * *gy;
  return g2 > 0.0f ? g2 * rsqrtf(g2) : 0.0f;
}

// 2^k, the largest power of two with 2^k * gmax <= qmax (k within
// [-100, 100]; 1 for a flat window).
__device__ __forceinline__ float fixed_scale(float gmax, int qmax) {
  int k = 0;
  if (gmax > 0.0f) {
    const float q = (float)qmax / gmax;
    k = min(max((__float_as_int(q) >> 23) - 127, -100), 100);
  }
  return __int_as_float((127 + k) << 23);
}

// atan2(y, x) in [0, 2pi): the octant's atan(t), t = min/max in [0, 1], by
// the minimax polynomial of Abramowitz and Stegun 4.4.49 (|error| <= 1e-5
// rad, 1.3e-5 of an orientation bin), then the octant's reflections.
__device__ __forceinline__ float atan2_0_2pi(float y, float x) {
  const float PI = 3.14159265358979f;
  const float ax = fabsf(x), ay = fabsf(y);
  const float mx = fmaxf(ax, ay), mn = fminf(ax, ay);
  const float t = mx > 0.0f ? __fdividef(mn, mx) : 0.0f;
  const float z = t * t;
  float p = ((((0.0208351f * z - 0.0851330f) * z + 0.1801410f) * z -
              0.3302995f) * z + 0.9998660f) * t;
  if (ay > ax) p = 0.5f * PI - p;
  if (x < 0.0f) p = PI - p;
  if (y < 0.0f) p = 2.0f * PI - p;
  return p;
}

// The 2 x 2 x 2 trilinear updates of one pixel (window row iy_, column
// ix_) into the warp's histogram copy.
__device__ __forceinline__ void add_pixel(const Pair& P, int iy_, int ix_,
                                          const float* ex, const float* ey,
                                          int* hist, int vlfeat) {
  const float TWO_PI = (float)(2.0 * 3.141592653589793);
  const float BIN_SCALE = (float)(8.0 / (2.0 * 3.141592653589793));
  float gx, gy;
  const float mag = (ex[ix_] * ey[iy_]) * grad_mag(P, iy_, ix_, &gx, &gy);
  const float sdx = (float)(ix_ - P.rad) - P.fx;
  const float sdy = (float)(iy_ - P.rad) - P.fy;
  const float ox = P.kcos * sdx + P.ksin * sdy;
  const float oy = P.kcos * sdy - P.ksin * sdx;
  // theta and the orientation both lie in [0, 2pi]: one correction each
  // way is the remainder.
  float rel = atan2_0_2pi(gy, gx) - P.ori;
  if (rel < 0.0f) rel = rel + TWO_PI;
  if (rel >= TWO_PI) rel = rel - TWO_PI;
  if (!vlfeat && rel > 0.0f) rel = TWO_PI - rel;
  const float fbin = rel * BIN_SCALE;
  const float ty = (oy + 2.0f) - 0.5f;
  const float tx = (ox + 2.0f) - 0.5f;
  const float fy0 = floorf(ty), fx0 = floorf(tx), fo0 = floorf(fbin);
  const int y0 = (int)fy0, x0 = (int)fx0, o0 = (int)fo0;
  const float wy1 = ty - fy0, wx1 = tx - fx0, wo1 = fbin - fo0;
  const int b0 = (o0 & 7) * HPITCH, b1 = ((o0 + 1) & 7) * HPITCH;
  const float ms = mag * P.scale;  // exact: P.scale is a power of two
  const float m0 = (1.0f - wo1) * ms, m1 = wo1 * ms;
  // Cell (y0 + a, x0 + b) lies a*32 + b*8 bins past cell (y0, x0).
  const int cell = (y0 * 32 + x0 * 8) * HPITCH;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const float wy = a ? wy1 : 1.0f - wy1;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float wx = b ? wx1 : 1.0f - wx1;
      if ((unsigned)(y0 + a) < 4u && (unsigned)(x0 + b) < 4u) {
        int* c = hist + cell + (a * 32 + b * 8) * HPITCH;
        const float w = wy * wx;
        atomicAdd(c + b0, min(__float2int_rn(w * m0), P.qmax));
        atomicAdd(c + b1, min(__float2int_rn(w * m1), P.qmax));
      }
    }
  }
}

// The row of pixel number k (k < pre[edge]): the last r with pre[r] <= k.
__device__ __forceinline__ int first_row(const int* pre, int edge, int k) {
  int lo = 0, hi = edge;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= k) lo = mid; else hi = mid;
  }
  return lo;
}

// The window columns [lo, hi] of row r (dy = r - rad) that can contribute:
// inside the layer's border and, with a pixel to spare, where both rotated
// coordinates lie in (-2.5, 2.5) lambda (the support of the 4 x 4 cells'
// hat weights). A superset is harmless: add_pixel gives a pixel outside
// the support no weight.
__device__ __forceinline__ void row_span(const Pair& P, int r, int* lo,
                                         int* hi) {
  const int dy = r - P.rad;
  int a = max(-P.rad, 1 - P.cx), b = min(P.rad, P.w - 2 - P.cx);
  if (P.cy + dy < 1 || P.cy + dy > P.h - 2) b = a - 1;
  const float sdy = (float)dy - P.fy;
  // ox = kcos*sdx + ksin*sdy, oy = kcos*sdy - ksin*sdx, sdx = dx - fx.
  float l = -1e30f, u = 1e30f;
  const float c[2] = {P.kcos, -P.ksin};
  const float o[2] = {P.ksin * sdy, P.kcos * sdy};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (fabsf(c[i]) > 1e-20f) {
      const float ic = __fdividef(1.0f, c[i]);
      const float e0 = (-2.5f - o[i]) * ic, e1 = (2.5f - o[i]) * ic;
      l = fmaxf(l, fminf(e0, e1));
      u = fminf(u, fmaxf(e0, e1));
    } else if (!(fabsf(o[i]) < 2.5f + 1e-3f)) {
      u = -1e30f;
    }
  }
  if (l <= u) {
    a = max(a, (int)fmaxf(floorf(l + P.fx) - 1.0f, -1e9f));
    b = min(b, (int)fminf(ceilf(u + P.fx) + 1.0f, 1e9f));
  } else {
    b = a - 1;
  }
  *lo = a + P.rad;
  *hi = b + P.rad;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
descriptor_kernel(const float* __restrict__ flat,
                  const long long* __restrict__ base,
                  const float* __restrict__ rec,
                  const int* __restrict__ count, float* __restrict__ desc,
                  int* __restrict__ work, int capacity, int max_radius,
                  int vlfeat) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int table = 2 * max_radius + 1;
  // Per warp: its histogram (4 copies of 128 bins, HPITCH ints a bin); per
  // block: the two gaussian tables, the row spans and their prefix sums.
  int* hist = smem + warp * (NBINS * HPITCH);
  float* ex = reinterpret_cast<float*>(smem + WARPS * (NBINS * HPITCH));
  float* ey = ex + table;
  int* span_lo = reinterpret_cast<int*>(ey + table);
  int* span_hi = span_lo + table;
  int* pre = span_hi + table;
  const int n = min(*count, capacity);

  __shared__ int s_pair;
  __shared__ float s_gmax[WARPS];
  for (;;) {
    if (tid == 0) s_pair = atomicAdd(work, 1);
    __syncthreads();  // also: the last pair's histograms have been read
    const int pr = s_pair;
    if (pr >= n) break;

    Pair P = make_pair(rec + (size_t)pr * 8, base[pr], flat, max_radius);
    // exp(-(ox^2 + oy^2)/8) = exp(-k2 sdx^2/8) exp(-k2 sdy^2/8), since the
    // rotation keeps sdx^2 + sdy^2.
    const float k2 = P.kcos * P.kcos + P.ksin * P.ksin;

    for (int i = lane; i < NBINS * HPITCH; i += 32) hist[i] = 0;
    for (int i = tid; i < P.edge; i += THREADS) {
      const float sdx = (float)(i - P.rad) - P.fx;
      const float sdy = (float)(i - P.rad) - P.fy;
      ex[i] = __expf(-0.125f * (k2 * (sdx * sdx)));
      ey[i] = __expf(-0.125f * (k2 * (sdy * sdy)));
      row_span(P, i, span_lo + i, span_hi + i);
    }
    __syncthreads();

    // Exclusive prefix of the rows' span lengths (warp 0).
    if (warp == 0) {
      int run = 0;
      for (int r0 = 0; r0 < P.edge; r0 += 32) {
        const int rr = r0 + lane;
        const int len = rr < P.edge ? max(0, span_hi[rr] - span_lo[rr] + 1) : 0;
        int x = len;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(0xffffffffu, x, o);
          if (lane >= o) x += y;
        }
        if (rr < P.edge) pre[rr] = run + x - len;
        run += __shfl_sync(0xffffffffu, x, 31);
      }
      if (lane == 0 && P.edge > 0) pre[P.edge] = run;
    }
    __syncthreads();
    const int total = P.edge > 0 ? pre[P.edge] : 0;
    const int row0 = first_row(pre, P.edge, tid);

    // gmax over the pixels the walk will add; max is exact in any order.
    float gm = 0.0f;
    int row = row0;
#pragma unroll 4
    for (int k = tid; k < total; k += THREADS) {
      while (pre[row + 1] <= k) ++row;
      float gx, gy;
      gm = fmaxf(gm, grad_mag(P, row, span_lo[row] + (k - pre[row]), &gx,
                              &gy));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      gm = fmaxf(gm, __shfl_xor_sync(0xffffffffu, gm, o));
    if (lane == 0) s_gmax[warp] = gm;
    __syncthreads();
    float gmax = s_gmax[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) gmax = fmaxf(gmax, s_gmax[w]);
    P.scale = fixed_scale(gmax, P.qmax);

    int* mine = hist + (lane & (COPIES - 1));
    row = row0;
    for (int k = tid; k < total; k += THREADS) {
      while (pre[row + 1] <= k) ++row;
      add_pixel(P, row, span_lo[row] + (k - pre[row]), ex, ey, mine, vlfeat);
    }
    __syncthreads();

    // Bin b: the sum of its WARPS x COPIES integer copies (integer: the
    // order does not matter).
    const float inv = 1.0f / P.scale;  // exact: a power of two
    for (int b = tid; b < NBINS; b += THREADS) {
      int acc = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
#pragma unroll
        for (int c = 0; c < COPIES; ++c)
          acc += smem[w * (NBINS * HPITCH) + b * HPITCH + c];
      desc[(size_t)pr * NBINS + b] = (float)acc * inv;
    }
  }
}

// desc: capacity x 128 floats, zeroed by the caller, followed in the same
// allocation by the int32 work counter, zero (ops/backhalf.py
// _launch_descriptor makes it).
extern "C" int vks_descriptor(const void* flat, const void* base,
                              const void* rec, const void* count, void* desc,
                              int capacity, int max_radius, int vlfeat,
                              void* stream) {
  if (capacity < 0 || max_radius < 0 || max_radius > 0x3fff)
    return (int)cudaErrorInvalidValue;
  if (capacity == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sizeof(int) * (WARPS * (NBINS * HPITCH) +
                                     5 * (2 * max_radius + 1) + 1);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(descriptor_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = min(sms * BLOCKS_PER_SM, capacity);
  descriptor_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)flat, (const long long*)base, (const float*)rec,
      (const int*)count, (float*)desc,
      (int*)((float*)desc + (size_t)capacity * NBINS), capacity, max_radius,
      vlfeat);
  return (int)cudaGetLastError();
}
