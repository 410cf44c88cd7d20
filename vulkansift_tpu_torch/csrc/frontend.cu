// Dense keypoint frontend for one octave's DoG stack: per interior cell
// the strict 26-neighbour extremum test with the |v| > 0.8*threshold
// pre-filter (candidate bit 128) and the Newton walk code 0..107, plus the
// per-(layer, row) candidate counts.
//
// Replaces: vulkansift_tpu/ops/pallas_frontend.py::frontend_tpu; plain
// version: ops/extract.py::dense_frontend. Output layout (both):
// code[s-1][y-1][x-1], u8 (S, H-2, W-2); counts[s-1][y-1], i32 (S, H-2),
// zeroed by the caller. Any number of DoG layers ns >= 3.
//
// The walk code evaluates extract._walk_classify's expressions in the same
// order; with --fmad=false every operation rounds as in the plain version,
// so codes and candidates are bit-exact. Max and min are exact in any
// order, so the extremum test shares partial results between cells.
//
// Bound on the H100: each cell reads its (S+2) DoG layers once (4*(S+2)
// bytes) and writes S code bytes, against ~147 f32 operations per centre
// cell, each its own instruction under --fmad=false: at octave 0 the
// instruction issue (~0.08 ms) is about twice the bytes' time. Design:
//  * a block (8 thread rows of 16 lanes, 5 blocks an SM) owns a 64 x 16
//    tile of interior cells and marches the centre layer s = 1..S through
//    a rolling ring of four (16+2) x 68 planes in shared memory: cp.async
//    brings plane s+2 while layer s is computed, so shared memory does not
//    grow with the number of layers. A stack with too few tiles to fill
//    the card (the small octaves) takes 64 x 8 tiles and gives each layer
//    its own block instead;
//  * interior tiles copy aligned 16-byte vectors; only tiles whose 68
//    staged columns or 18 rows cross the layer's edge (or unaligned
//    layers) copy 4-byte words from clamped indices;
//  * a thread computes 4 adjacent cells in each of 2 rows, from a register
//    window of 3 planes x 3 rows x 6 values that moves down a row at a
//    time (two 16-byte shared loads per plane and row: 3 loads per cell
//    where a window per cell needs 27); the extremum test shares each
//    column's 9-value (and centre-less 8-value) max and min between the
//    cells that see that column, and a thread none of whose 4 centres
//    passes the |v| > 0.8*threshold pre-filter skips it;
//  * a half-warp is one 64-cell row segment: 4 ballots count its
//    candidates (one integer atomicAdd per segment and row; integer sums
//    do not depend on the order), and its 64 code bytes go out as aligned
//    32-bit words, realigned across lanes by a shuffle, with byte stores
//    only on the segment's two ends (code rows are W-2 bytes, not 4-byte
//    aligned).

#include <cuda_runtime.h>
#include <stdint.h>

#define CPT 4                 // cells per thread along x
#define LX 16                 // threads along x
#define TX (CPT * LX)         // 64 interior cells per tile row
#define TR 8                  // thread rows
#define THREADS (LX * TR)
#define PW (TX + 4)           // staged columns and row pitch (68 floats)
// A tile is TX x TR*RT cells (RT rows per thread row); RT is a template
// parameter: 2 for large stacks, 1 for small ones.
template <int RT>
struct Tile {
  static constexpr int TY = TR * RT;       // tile rows
  static constexpr int TH = TY + 2;        // staged rows
  static constexpr int PLANE = TH * PW;    // floats per staged plane
};
// Blocks an SM must hold: caps the registers at 96 a thread.
#define MIN_BLOCKS (65536 / (THREADS * 96))

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes16) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

// Stage one plane of the stack (staged rows y0.., columns x0..) into dst.
template <int TH>
__device__ __forceinline__ void stage(float* dst, const float* src, int y0,
                                      int x0, int H, int W, bool interior,
                                      int tid) {
  if (interior) {
    constexpr int Q = PW / 4;
    const float* s0 = src + (size_t)y0 * W + x0;
#pragma unroll
    for (int i = tid; i < TH * Q; i += THREADS) {
      const int r = i / Q, q = i - r * Q;
      cp_async(dst + r * PW + 4 * q, s0 + (size_t)r * W + 4 * q, 1);
    }
  } else {
    for (int i = tid; i < TH * PW; i += THREADS) {
      const int r = i / PW, c = i - r * PW;
      const int gy = min(y0 + r, H - 1), gx = min(x0 + c, W - 1);
      cp_async(dst + i, src + (size_t)gy * W + gx, 0);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Store byte b of `word` at p[b] for the b with 0 <= lo + b < n; one
// 32-bit store when all four are in (p is 4-byte aligned).
__device__ __forceinline__ void store_word(uint8_t* p, uint32_t word, int lo,
                                           int n) {
  if (lo >= 0 && lo + 4 <= n) {
    *reinterpret_cast<uint32_t*>(p) = word;
    return;
  }
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (lo + b >= 0 && lo + b < n) p[b] = (uint8_t)(word >> (8 * b));
}

// One row of one centre layer: thread j computes cells x0+1+4j ..
// x0+4+4j of the row from v, adds its half-warp's candidates to
// *count_row and stores the codes of its row segment, which starts at seg
// (cell x0+1); nvalid of the segment's 64 cells lie inside the layer, and
// none when !row_in. v[a][b][m]: plane s-1+a, row y-1+b, column x0+4j+m.
__device__ __forceinline__ void row_cells(const float (&v)[3][3][6], int j,
                                          int lane, bool row_in, int nvalid,
                                          float thr08, uint8_t* seg,
                                          int* count_row) {
  // The candidate test needs |centre| > thr08: a thread whose 4 centres
  // all fail it skips the extremum (its cells are no candidates either
  // way). Column extrema: all 9 values of a column, and for the centre
  // columns 1..4 the 8 without the centre cell.
  bool cand[CPT];
  bool any = false;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    cand[k] = false;
    any = any || fabsf(v[1][1][k + 1]) > thr08;
  }
  if (any) {
    float cmax[6], cmin[6], emax[4], emin[4];
#pragma unroll
    for (int m = 0; m < 6; ++m) {
      float mx = v[0][0][m], mn = v[0][0][m];
#pragma unroll
      for (int q = 1; q < 9; ++q) {
        if (q == 4) continue;
        mx = fmaxf(mx, v[q / 3][q % 3][m]);
        mn = fminf(mn, v[q / 3][q % 3][m]);
      }
      if (m >= 1 && m <= 4) {
        emax[m - 1] = mx;
        emin[m - 1] = mn;
      }
      cmax[m] = fmaxf(mx, v[1][1][m]);
      cmin[m] = fminf(mn, v[1][1][m]);
    }
    // Strict 26-neighbour extremum.
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const float ctr = v[1][1][k + 1];
      const float mx = fmaxf(fmaxf(cmax[k], cmax[k + 2]), emax[k]);
      const float mn = fminf(fminf(cmin[k], cmin[k + 2]), emin[k]);
      cand[k] = row_in && (CPT * j + k < nvalid) && (fabsf(ctr) > thr08) &&
                ((ctr > mx) || (ctr < mn));
    }
  }

  uint32_t packed = 0;
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
#define N(a, b, c) v[a][b][k + (c)]
    const float n001 = N(0, 0, 1);
    const float n010 = N(0, 1, 0), n011 = N(0, 1, 1), n012 = N(0, 1, 2);
    const float n021 = N(0, 2, 1);
    const float n100 = N(1, 0, 0), n101 = N(1, 0, 1), n102 = N(1, 0, 2);
    const float n110 = N(1, 1, 0), n111 = N(1, 1, 1), n112 = N(1, 1, 2);
    const float n120 = N(1, 2, 0), n121 = N(1, 2, 1), n122 = N(1, 2, 2);
    const float n201 = N(2, 0, 1);
    const float n210 = N(2, 1, 0), n211 = N(2, 1, 1), n212 = N(2, 1, 2);
    const float n221 = N(2, 2, 1);
#undef N
    const float ctr = n111;
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
                  128 * (int)cand[k];
    packed |= (uint32_t)c << (8 * k);
  }

  // Row counts: a half-warp is one row segment.
  unsigned n_cand = 0;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    n_cand += __popc(__ballot_sync(0xffffffffu, cand[k]) &
                     (0xffffu << (lane & 16)));
  if ((lane & 15) == 0 && n_cand != 0u)
    atomicAdd(count_row, (int)n_cand);

  // Codes: the segment's bytes start at seg (cell x0+1); word j of the
  // aligned run from seg - m takes its low m bytes from lane j-1.
  const uint32_t prev = __shfl_up_sync(0xffffffffu, packed, 1);
  if (row_in) {
    const int m = (int)((uintptr_t)seg & 3);
    uint8_t* base = seg - m;
    const uint32_t word =
        m ? (packed << (8 * m)) | (prev >> (32 - 8 * m)) : packed;
    store_word(base + CPT * j, word, CPT * j - m, nvalid);
    if (j == LX - 1 && m)
      store_word(base + TX, packed >> (32 - 8 * m), TX - m, nvalid);
  }
}

#define RING 4  // staged planes: three in use, one in flight

// Loads staged row `row` of the three planes into v[.][b][.].
__device__ __forceinline__ void load_row(float (&v)[3][3][6],
                                         const float* const planes[3],
                                         int row, int b, int j) {
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float* rp = planes[a] + row * PW + CPT * j;
    const float4 lo = *reinterpret_cast<const float4*>(rp);
    const float4 hi = *reinterpret_cast<const float4*>(rp + 4);
    v[a][b][0] = lo.x;
    v[a][b][1] = lo.y;
    v[a][b][2] = lo.z;
    v[a][b][3] = lo.w;
    v[a][b][4] = hi.x;
    v[a][b][5] = hi.y;
  }
}

template <int RT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
frontend_kernel(const float* __restrict__ dog, uint8_t* __restrict__ code,
                int* __restrict__ counts, int ns, int H, int W, float thr08,
                int aligned, int lpb) {
  using T = Tile<RT>;
  __shared__ __align__(16) float ring[RING * T::PLANE];
  const int tid = threadIdx.x;
  const int j = tid % LX, tr = tid / LX;
  const size_t plane = (size_t)H * W;
  const int h2 = H - 2, w2 = W - 2;
  const int x0 = blockIdx.x * TX;    // interior cells x0+1 .. x0+TX
  const int y0 = blockIdx.y * T::TY;  // interior rows y0+1 .. y0+TY
  const bool interior = aligned && x0 + PW <= W && y0 + T::TH <= H;
  const int nvalid = min(TX, w2 - x0);

  // This block's centre layers: s0 .. s1 (blockIdx.z's lpb of them).
  const int s0 = 1 + blockIdx.z * lpb, s1 = min(ns - 2, s0 + lpb - 1);
  for (int l = s0 - 1; l <= s0 + 1; ++l)
    stage<T::TH>(ring + (l % RING) * T::PLANE, dog + (size_t)l * plane, y0,
                 x0, H, W, interior, tid);
  for (int s = s0; s <= s1; ++s) {
    // Plane s+2 goes into the slot of plane s-2, free since the barrier
    // that closed layer s-1; past the last plane an empty group keeps the
    // count of groups in flight.
    if (s + 2 <= s1 + 1)
      stage<T::TH>(ring + ((s + 2) % RING) * T::PLANE,
                   dog + (size_t)(s + 2) * plane, y0, x0, H, W, interior,
                   tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const float* const planes[3] = {ring + ((s - 1) % RING) * T::PLANE,
                                    ring + (s % RING) * T::PLANE,
                                    ring + ((s + 1) % RING) * T::PLANE};
    // Thread row tr computes tile rows tr*RT .. tr*RT + RT-1, moving the
    // 3-row register window down one staged row at a time.
    float v[3][3][6];
    load_row(v, planes, tr * RT, 0, j);
    load_row(v, planes, tr * RT + 1, 1, j);
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (r > 0) {
#pragma unroll
        for (int a = 0; a < 3; ++a)
#pragma unroll
          for (int m = 0; m < 6; ++m) {
            v[a][0][m] = v[a][1][m];
            v[a][1][m] = v[a][2][m];
          }
      }
      load_row(v, planes, tr * RT + r + 2, 2, j);
      const int y = y0 + tr * RT + r + 1;
      const int row = (s - 1) * h2 + (y - 1);
      row_cells(v, j, tid & 31, y <= H - 2, nvalid, thr08,
                code + (size_t)row * w2 + x0, counts + row);
    }
    __syncthreads();
  }
}

extern "C" int vks_frontend(const void* dog, void* code, void* counts,
                            int ns, int H, int W, float thr08, void* stream) {
  if (ns < 3 || H < 3 || W < 3 || (long long)H * W > 0x7fffffffLL ||
      (long long)(ns - 2) * (H - 2) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int aligned = ((uintptr_t)dog % 16 == 0) && (W % 4 == 0);
  // A stack with fewer 64 x 16 tiles than the card holds blocks at once
  // (the small octaves) takes 64 x 8 tiles and gives each centre layer its
  // own block, so that its layers run side by side; a larger one marches
  // each tile through all of them.
  const long long tiles2 = (long long)((W - 2 + TX - 1) / TX) *
                           ((H - 2 + Tile<2>::TY - 1) / Tile<2>::TY);
  cudaStream_t st = (cudaStream_t)stream;
  if (tiles2 >= (long long)sms * MIN_BLOCKS) {
    dim3 grid((W - 2 + TX - 1) / TX, (H - 2 + Tile<2>::TY - 1) / Tile<2>::TY);
    frontend_kernel<2><<<grid, THREADS, 0, st>>>(
        (const float*)dog, (uint8_t*)code, (int*)counts, ns, H, W, thr08,
        aligned, ns - 2);
  } else {
    dim3 grid((W - 2 + TX - 1) / TX, (H - 2 + Tile<1>::TY - 1) / Tile<1>::TY,
              ns - 2);
    if (grid.z > 65535) return (int)cudaErrorInvalidValue;
    frontend_kernel<1><<<grid, THREADS, 0, st>>>(
        (const float*)dog, (uint8_t*)code, (int*)counts, ns, H, W, thr08,
        aligned, 1);
  }
  return (int)cudaGetLastError();
}
