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
// Exactness: everything is integer. The dot products run on the tensor
// cores as mma.sync m16n8k32 u8 x u8 with int32 accumulation; a 128-byte
// dot product is at most 8,323,200 < 2^23, so d2 = |a|^2 + |b|^2 - 2 a.b is
// exact. The TPU kernel's biased-int32 keys and f32 clamps exist because
// Mosaic cannot cast f32 to u32; they have no counterpart here.
//
// Bound on the H100: operations, 2 * 128 u8 products per (A row, B row)
// pair at the int8 tensor-core rate. Design:
//  * Grid (SLICES, A tiles). A block owns A_TILE rows, 32 per warp, held in
//    registers as mma A fragments for the whole run; the SLICES blocks of
//    one A tile form a thread-block cluster, and each scans one contiguous
//    slice of the live B rows (the live count_b is read on the device, so
//    every block has work whatever the count, and small counts still fill
//    the card).
//  * B streams through shared memory in B_TILE-row stages, double
//    buffered with cp.async; 16-byte chunks are XOR-swizzled so that the
//    fragment loads (one 16-byte load per lane for 32 bytes of k) hit no
//    bank twice. The k order inside a fragment is a permutation of the 128
//    bytes, the same for A and B, which leaves every dot product unchanged.
//  * |b|^2 of each stage comes from dp4a on the staged rows; staged rows
//    past the slice's end are zeros with |b|^2 = 2^28, so they never beat
//    the marker, and rows of B at or past count_b are never read.
//  * Epilogue in t-space: t = |b|^2 - 2 a.b (one multiply-add) orders a
//    row's columns as d2 = |a|^2 + t does. Each lane keeps a top-2 for
//    each of its four rows and visits its columns in increasing order with
//    the reference's strict-< two-slot update (Get2NearestNeighbors.comp:
//    85-95); a pair of columns is first tested against the row's second
//    distance, so the update runs only when one of them can enter. This
//    update, not the products, sets the kernel's pace (PERF.md).
//  * Merge: the four lanes of a quad (same rows, other columns) merge by
//    shuffles, and the SLICES blocks of a cluster through distributed
//    shared memory after cluster.sync(), each block merging A_TILE /
//    SLICES rows over the slices in order, with the associative (d2,
//    index) lexicographic merge (ops/match.py::merge_top2). Each partial is
//    the lexicographic top-2 of its columns, so the result equals the
//    ordered scan whatever the tiling. No second pass over device memory.
//  * Blocks wholly past count_a write the marker and return.
// ops/match.py::KERNEL_GEOMETRY mirrors A_TILE, B_TILE and SLICES; change
// both together (tests/test_torch_match.py parses the #defines).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define A_TILE 128         // A rows per block (32 per warp)
#define B_TILE 64          // B rows per shared-memory stage
#define SLICES 8           // blocks per A tile (one cluster), one B slice each
#define THREADS A_TILE     // 4 warps
#define D2_INVALID ((1 << 23) - 1)
#define PAD_BSQ (1 << 28)  // |b|^2 of a staged row past the slice's end

static_assert(THREADS == 2 * B_TILE, "two threads per staged row for |b|^2");
static_assert(A_TILE % SLICES == 0, "the cluster merge splits the A tile");

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

// D += A (16x32 u8, row) * B (32x8 u8, col), int32 accumulation.
__device__ __forceinline__ void mma_u8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__global__ void __cluster_dims__(SLICES, 1, 1) __launch_bounds__(THREADS)
match_2nn_kernel(const uint4* __restrict__ a4, const int* __restrict__ count_a,
                 const uint4* __restrict__ b4, const int* __restrict__ count_b,
                 int* __restrict__ out_d1, int* __restrict__ out_i1,
                 int* __restrict__ out_d2, int* __restrict__ out_i2, int na,
                 int nb) {
  // One stage: B_TILE rows of 8 chunks; chunk c of row r sits at
  // c ^ ((r & 1) << 2).
  __shared__ __align__(16) uint4 tile[2][B_TILE * 8];
  __shared__ __align__(8) int tile_sq[2][B_TILE];
  __shared__ int part[A_TILE][4];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * A_TILE;
  const int ca = min(max(*count_a, 0), na);
  const int cb = min(max(*count_b, 0), nb);
  if (row0 >= ca) {  // the whole A tile is past the live rows
    if (blockIdx.x == 0) {
      const int r = row0 + tid;
      if (r < na) {
        out_d1[r] = D2_INVALID;
        out_i1[r] = 0;
        out_d2[r] = D2_INVALID;
        out_i2[r] = 0;
      }
    }
    return;  // every block of the cluster returns here
  }

  cg::cluster_group cluster = cg::this_cluster();
  const int slice = (int)cluster.block_rank();
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;

  // A fragments of this warp's two 16-row m-tiles, for the four k-steps.
  // k-step ks = 2q + h takes words q*16 + tig*4 + 2h (+1) of each row:
  // register 0/2 row gid, 1/3 row gid + 8 (the PTX m16n8k32 layout).
  unsigned af[2][4][4];
  int asq[4];  // |a|^2 of rows (mt, half) = warp*32 + mt*16 + half*8 + gid
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + warp * 32 + mt * 16 + half * 8 + gid;
      const uint4 z = make_uint4(0, 0, 0, 0);
      const uint4 v0 = r < na ? a4[(size_t)r * 8 + tig] : z;
      const uint4 v1 = r < na ? a4[(size_t)r * 8 + 4 + tig] : z;
      af[mt][0][half] = v0.x;
      af[mt][0][half + 2] = v0.y;
      af[mt][1][half] = v0.z;
      af[mt][1][half + 2] = v0.w;
      af[mt][2][half] = v1.x;
      af[mt][2][half + 2] = v1.y;
      af[mt][3][half] = v1.z;
      af[mt][3][half + 2] = v1.w;
      unsigned s = __dp4a(v0.x, v0.x, 0u);
      s = __dp4a(v0.y, v0.y, s);
      s = __dp4a(v0.z, v0.z, s);
      s = __dp4a(v0.w, v0.w, s);
      s = __dp4a(v1.x, v1.x, s);
      s = __dp4a(v1.y, v1.y, s);
      s = __dp4a(v1.z, v1.z, s);
      s = __dp4a(v1.w, v1.w, s);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      asq[mt * 2 + half] = (int)s;
    }
  }

  // Top-2 per row in t-space (t = d2 - |a|^2); the marker is D2_INVALID.
  int bd[4], bi[4], sd[4], si[4];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    bd[rr] = sd[rr] = D2_INVALID - asq[rr];
    bi[rr] = si[rr] = 0;
  }

  // This block's slice of the live B rows, a multiple of B_TILE long.
  const int chunk =
      ((cb + SLICES - 1) / SLICES + B_TILE - 1) / B_TILE * B_TILE;
  const int begin = min(slice * chunk, cb);
  const int end = min(begin + chunk, cb);
  const int ntiles = (end - begin + B_TILE - 1) / B_TILE;

  auto stage = [&](int t, int buf) {
    const int base = begin + t * B_TILE;
#pragma unroll
    for (int i = tid; i < B_TILE * 8; i += THREADS) {
      const int r = i >> 3, c = i & 7;
      const bool live = base + r < end;
      cp_async16(&tile[buf][r * 8 + (c ^ ((r & 1) << 2))],
                 live ? &b4[(size_t)(base + r) * 8 + c] : b4, live ? 16 : 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  if (ntiles > 0) stage(0, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    const int base = begin + t * B_TILE;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // stage t is in; stage t - 1 is no longer read
    if (t + 1 < ntiles) stage(t + 1, buf ^ 1);
    {
      // |b|^2: two threads per staged row, four chunks each, rotated so
      // that the lanes of a quarter-warp read different banks.
      const int r = tid >> 1, hf = tid & 1;
      unsigned s = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint4 w = tile[buf][r * 8 + hf * 4 + ((j + (r >> 1)) & 3)];
        s = __dp4a(w.x, w.x, s);
        s = __dp4a(w.y, w.y, s);
        s = __dp4a(w.z, w.z, s);
        s = __dp4a(w.w, w.w, s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      if (hf == 0) tile_sq[buf][r] = base + r < end ? (int)s : PAD_BSQ;
    }
    __syncthreads();

    const uint4* tb = tile[buf];
    const int swz = (gid & 1) << 2;  // row nt*8 + gid has parity gid
#pragma unroll
    for (int nt = 0; nt < B_TILE / 8; ++nt) {
      const int br = nt * 8 + gid;
      const uint4 w0 = tb[br * 8 + (tig ^ swz)];
      const uint4 w1 = tb[br * 8 + ((4 + tig) ^ swz)];
      int acc[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0;
        mma_u8(acc[mt], af[mt][0], w0.x, w0.y);
        mma_u8(acc[mt], af[mt][1], w0.z, w0.w);
        mma_u8(acc[mt], af[mt][2], w1.x, w1.y);
        mma_u8(acc[mt], af[mt][3], w1.z, w1.w);
      }
      const int2 q = *reinterpret_cast<const int2*>(
          &tile_sq[buf][nt * 8 + 2 * tig]);
      const int col = base + nt * 8 + 2 * tig;
      // Accumulator j of an m-tile: row gid + 8*(j >> 1), column
      // 2*tig + (j & 1).
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = mt * 2 + half;
          const int t0 = q.x - 2 * acc[mt][2 * half];
          const int t1 = q.y - 2 * acc[mt][2 * half + 1];
          if (min(t0, t1) < sd[rr]) {
            scan_update(t0, col, bd[rr], bi[rr], sd[rr], si[rr]);
            scan_update(t1, col + 1, bd[rr], bi[rr], sd[rr], si[rr]);
          }
        }
      }
    }
  }

  // Quad merge (same rows, other columns), then this slice's partials in
  // d2-space into shared memory.
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const int e1 = __shfl_xor_sync(0xffffffffu, bd[rr], off);
      const int j1 = __shfl_xor_sync(0xffffffffu, bi[rr], off);
      const int e2 = __shfl_xor_sync(0xffffffffu, sd[rr], off);
      const int j2 = __shfl_xor_sync(0xffffffffu, si[rr], off);
      merge_top2(bd[rr], bi[rr], sd[rr], si[rr], e1, j1, e2, j2);
    }
    if (tig == 0) {
      const int lr = warp * 32 + (rr >> 1) * 16 + (rr & 1) * 8 + gid;
      part[lr][0] = bd[rr] + asq[rr];
      part[lr][1] = bi[rr];
      part[lr][2] = sd[rr] + asq[rr];
      part[lr][3] = si[rr];
    }
  }

  // Slices merge through distributed shared memory: block `slice` of the
  // cluster merges rows [slice * PER, (slice + 1) * PER) over every slice,
  // in slice order.
  cluster.sync();
  constexpr int PER = A_TILE / SLICES;
  if (tid < PER) {
    const int lr = slice * PER + tid;
    const int r = row0 + lr;
    int d1 = D2_INVALID, i1 = 0, d2 = D2_INVALID, i2 = 0;
#pragma unroll
    for (int s = 0; s < SLICES; ++s) {
      const int* p = cluster.map_shared_rank(&part[lr][0], s);
      merge_top2(d1, i1, d2, i2, p[0], p[1], p[2], p[3]);
    }
    if (r < na) {
      const bool live = r < ca;
      out_d1[r] = live ? d1 : D2_INVALID;
      out_i1[r] = live ? i1 : 0;
      out_d2[r] = live ? d2 : D2_INVALID;
      out_i2[r] = live ? i2 : 0;
    }
  }
  cluster.sync();  // keep this block's partials alive until all are read
}

extern "C" int vks_match_2nn(const void* desc_a, const void* count_a,
                             const void* desc_b, const void* count_b,
                             void* d1, void* i1, void* d2, void* i2, int na,
                             int nb, void* stream) {
  if (na < 0 || nb < 0 || (na + A_TILE - 1) / A_TILE > 65535)
    return (int)cudaErrorInvalidValue;
  if (na == 0) return (int)cudaGetLastError();
  dim3 grid(SLICES, (na + A_TILE - 1) / A_TILE);
  match_2nn_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)desc_a, (const int*)count_a, (const uint4*)desc_b,
      (const int*)count_b, (int*)d1, (int*)i1, (int*)d2, (int*)i2, na, nb);
  return (int)cudaGetLastError();
}
