// Brute-force 2-NN of u8 descriptors: for every A row r < count_a, the
// smallest and second-smallest d2 = sum((a - b)^2) over the B rows
// c < count_b, ties to the smaller c.
//
// Replaces: vulkansift_tpu/ops/pallas_match.py::match_2nn_tiles (kernel
// body _make_kernel_t) and its row-major twin _match_2nn_tiles_rowmajor,
// which compute the same function; plain version: ops/match.py::top2_plain.
//
// Output: int32 d2_1, i1, d2_2, i2 per A row. "No neighbour" is
// d2 = 2^23 - 1 with index 0: the second slot when count_b < 2, both when
// count_b == 0, and every row r >= count_a.
//
// Exactness: everything is integer. __dp4a multiplies packed u8 words
// (unsigned x unsigned) and accumulates in 32 bits; a 128-byte dot product
// is at most 8,323,200 < 2^23, so d2 = |a|^2 + |b|^2 - 2 a.b is exact. The
// TPU kernel's biased-int32 keys and f32 clamps exist because Mosaic cannot
// cast f32 to u32; they have no counterpart here.
//
// Design. A block owns 32 A rows (one per lane, each row as 32 u32 words in
// registers) and splits the live B rows into WARPS contiguous slices, one
// per warp. The slices follow the live count_b read from device memory,
// so every warp has work whatever the count; the launch covers the static
// capacity and blocks wholly past count_a only write the marker. Each warp
// stages 32 B rows of its slice (4 KB) in its own shared memory, computes
// their |b|^2, and scans the columns in increasing order with the
// reference's strict-< two-slot update (Get2NearestNeighbors.comp:85-95):
// all lanes read the same B word at once, a broadcast. Staged rows past the
// slice's end are zeros with |b|^2 = 2^28, so their d2 exceeds the marker
// and they never win; rows of B at or past count_b are never read. The
// warps' results then merge in slice order with the associative (d2,
// index) lexicographic merge (ops/match.py::merge_top2), which is exact
// because each slice's scan is already the lexicographic top-2 of its
// columns.
//
// Bound on the H100: operations. Each (A row, B row) pair costs 32 dp4a;
// at 16384 x 16384 that is 8.6 G dp4a, about half a millisecond at the
// SIMT dp4a rate, while the tensor cores' int8 rate would take the same
// products in ~0.035 ms. Moving the dot products to mma/wgmma on u8 is the
// later step; this kernel keeps the simple ordered scan, with four columns
// in flight per step for instruction-level parallelism.

#include <cuda_runtime.h>
#include <stdint.h>

#define WARPS 8            // B slices per block, one per warp
#define ROWS 32            // A rows per block (one per lane)
#define TILE 32            // B rows staged per warp step
#define WORDS 32           // u32 words per 128-byte descriptor
#define D2_INVALID ((1 << 23) - 1)
#define PAD_BSQ (1 << 28)  // |b|^2 of a staged row past the slice's end

__device__ __forceinline__ bool lex_lt(int da, int ia, int db, int ib) {
  return da < db || (da == db && ia < ib);
}

// (d1, i1, d2, i2) <- merge with (e1, j1, e2, j2); both sorted pairs.
__device__ __forceinline__ void merge_top2(int& d1, int& i1, int& d2,
                                           int& i2, int e1, int j1, int e2,
                                           int j2) {
  const bool take = lex_lt(e1, j1, d1, i1);
  const int nd1 = take ? e1 : d1, ni1 = take ? j1 : i1;
  const int ld = take ? d1 : e1, li = take ? i1 : j1;
  const int wd = take ? e2 : d2, wi = take ? j2 : i2;
  const bool tl = lex_lt(ld, li, wd, wi);
  d2 = tl ? ld : wd;
  i2 = tl ? li : wi;
  d1 = nd1;
  i1 = ni1;
}

__device__ __forceinline__ void scan_update(int d, int col, int& d1,
                                            int& i1, int& d2, int& i2) {
  if (d < d1) {
    d2 = d1;  // the old best becomes the second before it is replaced
    i2 = i1;
    d1 = d;
    i1 = col;
  } else if (d < d2) {
    d2 = d;
    i2 = col;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
match_2nn_kernel(const uint4* __restrict__ a4, const int* __restrict__ count_a,
                 const uint4* __restrict__ b4, const int* __restrict__ count_b,
                 int* __restrict__ out_d1, int* __restrict__ out_i1,
                 int* __restrict__ out_d2, int* __restrict__ out_i2, int na,
                 int nb) {
  __shared__ __align__(16) unsigned tile[WARPS][TILE * WORDS];
  __shared__ int tile_sq[WARPS][TILE];
  __shared__ int part[WARPS][4][ROWS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * ROWS;
  const int row = row0 + lane;
  const int ca = min(max(*count_a, 0), na);
  const int cb = min(max(*count_b, 0), nb);

  if (row0 >= ca) {  // the whole block is past the live A rows
    if (warp == 0 && row < na) {
      out_d1[row] = D2_INVALID;
      out_i1[row] = 0;
      out_d2[row] = D2_INVALID;
      out_i2[row] = 0;
    }
    return;
  }

  // This lane's A row in registers (zeros past the capacity).
  unsigned a[WORDS];
#pragma unroll
  for (int k = 0; k < WORDS / 4; ++k) {
    const uint4 v = row < na ? a4[(size_t)row * 8 + k] : make_uint4(0, 0, 0, 0);
    a[4 * k] = v.x;
    a[4 * k + 1] = v.y;
    a[4 * k + 2] = v.z;
    a[4 * k + 3] = v.w;
  }
  unsigned asq_u = 0;
#pragma unroll
  for (int k = 0; k < WORDS; ++k) asq_u = __dp4a(a[k], a[k], asq_u);
  const int asq = (int)asq_u;

  // This warp's slice of the live B rows, a multiple of TILE long.
  const int chunk = ((cb + WARPS - 1) / WARPS + TILE - 1) / TILE * TILE;
  const int begin = min(warp * chunk, cb);
  const int end = min(begin + chunk, cb);

  int d1 = D2_INVALID, i1 = 0, d2 = D2_INVALID, i2 = 0;
  unsigned* const tw = tile[warp];
  const uint4* const tw4 = reinterpret_cast<const uint4*>(tw);
  int* const tsq = tile_sq[warp];

  for (int t0 = begin; t0 < end; t0 += TILE) {
    // Stage TILE rows: 512 contiguous bytes per warp load (coalesced).
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int idx = lane + 32 * k;  // uint4 index inside the tile
      const int r = t0 + idx / 8;
      const uint4 v = r < end ? b4[(size_t)r * 8 + idx % 8]
                              : make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(tw)[idx] = v;
    }
    __syncwarp();
    // |b|^2 of staged row `lane`; the rotated word order keeps the 32 lanes
    // on 32 different banks.
    {
      unsigned s = 0;
#pragma unroll
      for (int k = 0; k < WORDS; ++k) {
        const unsigned w = tw[lane * WORDS + ((k + lane) & (WORDS - 1))];
        s = __dp4a(w, w, s);
      }
      tsq[lane] = t0 + lane < end ? (int)s : PAD_BSQ;
    }
    __syncwarp();

    for (int c = 0; c < TILE; c += 4) {
      unsigned s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
      for (int k = 0; k < WORDS / 4; ++k) {
        const uint4 b0 = tw4[(c + 0) * 8 + k];
        const uint4 b1 = tw4[(c + 1) * 8 + k];
        const uint4 b2 = tw4[(c + 2) * 8 + k];
        const uint4 b3 = tw4[(c + 3) * 8 + k];
        s0 = __dp4a(a[4 * k], b0.x, s0);
        s1 = __dp4a(a[4 * k], b1.x, s1);
        s2 = __dp4a(a[4 * k], b2.x, s2);
        s3 = __dp4a(a[4 * k], b3.x, s3);
        s0 = __dp4a(a[4 * k + 1], b0.y, s0);
        s1 = __dp4a(a[4 * k + 1], b1.y, s1);
        s2 = __dp4a(a[4 * k + 1], b2.y, s2);
        s3 = __dp4a(a[4 * k + 1], b3.y, s3);
        s0 = __dp4a(a[4 * k + 2], b0.z, s0);
        s1 = __dp4a(a[4 * k + 2], b1.z, s1);
        s2 = __dp4a(a[4 * k + 2], b2.z, s2);
        s3 = __dp4a(a[4 * k + 2], b3.z, s3);
        s0 = __dp4a(a[4 * k + 3], b0.w, s0);
        s1 = __dp4a(a[4 * k + 3], b1.w, s1);
        s2 = __dp4a(a[4 * k + 3], b2.w, s2);
        s3 = __dp4a(a[4 * k + 3], b3.w, s3);
      }
      // In column order: the scan's result depends on it for ties.
      scan_update(asq + tsq[c + 0] - 2 * (int)s0, t0 + c + 0, d1, i1, d2, i2);
      scan_update(asq + tsq[c + 1] - 2 * (int)s1, t0 + c + 1, d1, i1, d2, i2);
      scan_update(asq + tsq[c + 2] - 2 * (int)s2, t0 + c + 2, d1, i1, d2, i2);
      scan_update(asq + tsq[c + 3] - 2 * (int)s3, t0 + c + 3, d1, i1, d2, i2);
    }
    __syncwarp();  // the next stage overwrites the tile
  }

  part[warp][0][lane] = d1;
  part[warp][1][lane] = i1;
  part[warp][2][lane] = d2;
  part[warp][3][lane] = i2;
  __syncthreads();
  if (warp != 0 || row >= na) return;
  if (row >= ca) {
    d1 = D2_INVALID;
    i1 = 0;
    d2 = D2_INVALID;
    i2 = 0;
  } else {
    for (int w = 1; w < WARPS; ++w)
      merge_top2(d1, i1, d2, i2, part[w][0][lane], part[w][1][lane],
                 part[w][2][lane], part[w][3][lane]);
  }
  out_d1[row] = d1;
  out_i1[row] = i1;
  out_d2[row] = d2;
  out_i2[row] = i2;
}

extern "C" int vks_match_2nn(const void* desc_a, const void* count_a,
                             const void* desc_b, const void* count_b,
                             void* d1, void* i1, void* d2, void* i2, int na,
                             int nb, void* stream) {
  if (na < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  if (na == 0) return (int)cudaGetLastError();
  const int blocks = (na + ROWS - 1) / ROWS;
  match_2nn_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const uint4*)desc_a, (const int*)count_a, (const uint4*)desc_b,
      (const int*)count_b, (int*)d1, (int*)i1, (int*)d2, (int*)i2, na, nb);
  return (int)cudaGetLastError();
}
