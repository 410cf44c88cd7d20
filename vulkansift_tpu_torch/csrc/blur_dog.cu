// Separable gaussian blur of one f32 layer, H pass then V pass, with the
// difference-of-gaussians layer y - x written in the same pass.
//
// Replaces: vulkansift_tpu/ops/pallas_blur.py::blur_dog_tpu (the TPU's fused
// blur + DoG kernel); plain version: ops/blur.py::blur_dog_plain.
//
// Semantics: symmetric borders with period 2n (numpy's "symmetric"
// padding), x[-1-m] = x[m] and x[n+m] = x[n-1-m], also for layers smaller
// than the half-kernel; the plain version's accumulation order exactly:
// acc = x[i]*t0, then acc = acc + (x[i-j] + x[i+j])*tj for j = 1..k. The
// H-pass result is stored as f32 before the V pass. Built with
// --fmad=false, so every product and sum rounds as in the plain version.
//
// Bound on the H100: memory, with the arithmetic close behind. Each layer is
// read once and y (and dog) written once: 8-12 bytes per pixel, against
// 2*(1+3k) f32 operations (80 at k = 13), about 0.6 of the bytes' time at
// the card's f32 rate, and the kernel cannot fuse a multiply-add. So the
// design cuts instructions as well as bytes:
//  * the kernel is a template on k (a switch in vks_blur_dog), so the tap
//    loops unroll, the taps are immediate operands and the windows live in
//    registers;
//  * a block owns a 128 x 32 output tile and stages its (32 + 2k) x
//    (128 + 2kp) input (kp = k rounded up to 4) in shared memory with
//    cp.async, every copy in flight at once. Interior tiles copy aligned
//    16-byte vectors with no index arithmetic; only tiles whose halo
//    crosses the border (decided once per block) gather through a per-row
//    and per-column source index computed once into shared memory, with the
//    period-2n reflection. Rows and columns past the layer's edge are
//    neither staged nor computed;
//  * H pass, a walk along a row: a thread makes 16 adjacent outputs from a
//    register window of 16 + 2kp inputs read as 16-byte words (3 loads per
//    output at k = 13, where a window per output would need 27), and
//    consecutive lanes take consecutive rows (odd 16-byte row pitches, so
//    no bank is hit twice). The (32 + 2k) x 128 result stays in shared
//    memory;
//  * V pass, a walk down a column: a thread makes 16 outputs from a
//    register window of 16 + 2k H-pass rows, and writes y and dog
//    coalesced; short walks keep small layers' few columns on many threads.
// Tile height: 64 rows would recompute less of the halo in the H pass
// (2k/64 against 2k/32), but measured over a frame's 36 layers the 32-row
// tile wins (more blocks in flight, three per SM up to k = 16, and shorter
// chains in the small octaves); see PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#define VKS_MAX_K 19   // half-kernel taps <= MAX_GAUSSIAN_KERNEL_SIZE = 20
#define TILE_W 128     // output columns per block
#define TILE_H 32      // output rows per block
#define THREADS 256
#define SEG 16         // outputs of one H-pass walk along a row
#define V_ROWS 16      // outputs of one V-pass walk down a column

struct Taps {
  float t[VKS_MAX_K + 1];
};

template <int K>
struct Geometry {
  static constexpr int KP = (K + 3) / 4 * 4;        // column halo
  static constexpr int ROWS = TILE_H + 2 * K;       // staged rows
  // Staged row pitch in floats: 16-byte aligned, and an odd number of
  // 16-byte words, so that lanes on consecutive rows hit other banks.
  static constexpr int PITCH = TILE_W + 2 * KP + 4;
  static constexpr int HPITCH = TILE_W + 4;         // H-pass row pitch
  static constexpr int WIN = SEG + 2 * KP;          // H-pass window
  static constexpr int SMEM =
      4 * (ROWS * PITCH + ROWS * HPITCH + ROWS + PITCH);
};

__device__ __forceinline__ int reflect_index(int i, int n) {
  // Symmetric reflection with period 2n (numpy's "symmetric" padding).
  const int p = 2 * n;
  int m = i % p;
  if (m < 0) m += p;
  return m < n ? m : p - 1 - m;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes16) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(src));
}

template <int K>
__global__ void __launch_bounds__(THREADS)
blur_dog_kernel(const float* __restrict__ x, float* __restrict__ y,
                float* __restrict__ dog, const Taps taps, int H, int W,
                int aligned) {
  using G = Geometry<K>;
  constexpr int KP = G::KP;
  extern __shared__ __align__(16) float smem[];
  float* in = smem;                                // ROWS x PITCH input
  float* hb = in + G::ROWS * G::PITCH;             // ROWS x HPITCH H pass
  int* row_off = reinterpret_cast<int*>(hb + G::ROWS * G::HPITCH);
  int* col_idx = row_off + G::ROWS;
  const int x0 = blockIdx.x * TILE_W;
  const int y0 = blockIdx.y * TILE_H;
  const int tid = threadIdx.x;
  // Only the part of the tile inside the layer is computed: staged rows
  // and H-pass walks past it feed no stored output.
  const int out_rows = min(TILE_H, H - y0);
  const int rows = out_rows + 2 * K;
  const int segs = (min(TILE_W, W - x0) + SEG - 1) / SEG;
  const int cols = segs * SEG + 2 * KP;

  // Stage the input with every copy in flight at once (cp.async).
  const bool interior = aligned && x0 >= KP && x0 + TILE_W + KP <= W &&
                        y0 >= K && y0 + TILE_H + K <= H;
  if (interior) {
    constexpr int Q = (TILE_W + 2 * KP) / 4;
    const float* src = x + (size_t)(y0 - K) * W + (x0 - KP);
#pragma unroll 8
    for (int i = tid; i < G::ROWS * Q; i += THREADS) {
      const int r = i / Q, q = i - r * Q;
      cp_async(in + r * G::PITCH + 4 * q, src + (size_t)r * W + 4 * q, 1);
    }
  } else {
    for (int i = tid; i < rows; i += THREADS)
      row_off[i] = reflect_index(y0 - K + i, H) * W;
    for (int i = tid; i < cols; i += THREADS)
      col_idx[i] = reflect_index(x0 - KP + i, W);
    __syncthreads();
    // A warp per staged row, lanes along it: a lane's source columns are
    // the same on every row, so they are read from the table once.
    constexpr int LANE_COLS = (TILE_W + 2 * KP + 31) / 32;
    int src_col[LANE_COLS];
#pragma unroll
    for (int m = 0; m < LANE_COLS; ++m) {
      const int c = (tid & 31) + 32 * m;
      src_col[m] = c < cols ? col_idx[c] : -1;
    }
    for (int r = tid >> 5; r < rows; r += THREADS / 32) {
      const float* src = x + row_off[r];
      float* dst = in + r * G::PITCH + (tid & 31);
#pragma unroll
      for (int m = 0; m < LANE_COLS; ++m)
        if (src_col[m] >= 0) cp_async(dst + 32 * m, src + src_col[m], 0);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  // H pass: one walk = SEG outputs of one staged row from a register
  // window of SEG + 2*KP inputs (16-byte loads); consecutive lanes take
  // consecutive rows. Window element w[m] is staged column seg*SEG + m,
  // and output seg*SEG + u sits at w[u + KP].
  for (int i = tid; i < rows * segs; i += THREADS) {
    const int seg = i / rows, r = i - seg * rows;
    const float4* src =
        reinterpret_cast<const float4*>(in + r * G::PITCH + seg * SEG);
    float w[G::WIN];
#pragma unroll
    for (int m = 0; m < G::WIN / 4; ++m) {
      const float4 v = src[m];
      w[4 * m] = v.x;
      w[4 * m + 1] = v.y;
      w[4 * m + 2] = v.z;
      w[4 * m + 3] = v.w;
    }
    float4* dst = reinterpret_cast<float4*>(hb + r * G::HPITCH + seg * SEG);
#pragma unroll
    for (int u4 = 0; u4 < SEG / 4; ++u4) {
      float o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = 4 * u4 + e;
        float acc = w[u + KP] * taps.t[0];
#pragma unroll
        for (int j = 1; j <= K; ++j)
          acc = acc + (w[u + KP - j] + w[u + KP + j]) * taps.t[j];
        o[e] = acc;
      }
      dst[u4] = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();

  // V pass: one walk = V_ROWS outputs down column c from a register window
  // of V_ROWS + 2K H-pass rows; output row p is centred on H-pass row
  // p + K. Consecutive lanes take consecutive columns.
  const int c = tid % TILE_W;
  const int gx = x0 + c;
  if (gx >= W) return;
  for (int p0 = (tid / TILE_W) * V_ROWS; p0 < out_rows;
       p0 += (THREADS / TILE_W) * V_ROWS) {
    float w[V_ROWS + 2 * K];
#pragma unroll
    for (int m = 0; m < V_ROWS + 2 * K; ++m)
      w[m] = hb[(p0 + m) * G::HPITCH + c];
#pragma unroll
    for (int p = 0; p < V_ROWS; ++p) {
      float acc = w[p + K] * taps.t[0];
#pragma unroll
      for (int j = 1; j <= K; ++j)
        acc = acc + (w[p + K - j] + w[p + K + j]) * taps.t[j];
      if (p0 + p < out_rows) {
        const size_t o = (size_t)(y0 + p0 + p) * W + gx;
        y[o] = acc;
        if (dog != nullptr)
          dog[o] = acc - in[(p0 + p + K) * G::PITCH + c + KP];
      }
    }
  }
}

template <int K>
static int launch(const float* x, float* y, float* dog, const Taps& taps,
                  int H, int W, cudaStream_t stream) {
  using G = Geometry<K>;
  // Above 48 KB a block's dynamic shared memory must be allowed per kernel
  // and per device (the caller makes the tensor's device current); remember
  // the devices already set. The mask is atomic, since callers on several
  // threads may launch at once; two of them may both set the attribute,
  // which is harmless.
  static std::atomic<unsigned long long> ready{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(ready.load(std::memory_order_acquire) & bit)) {
    e = cudaFuncSetAttribute(blur_dog_kernel<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready.fetch_or(bit, std::memory_order_release);
  }
  const int aligned = ((uintptr_t)x % 16 == 0) && (W % 4 == 0);
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  blur_dog_kernel<K><<<grid, THREADS, G::SMEM, stream>>>(x, y, dog, taps, H,
                                                         W, aligned);
  return (int)cudaGetLastError();
}

extern "C" int vks_blur_dog(const void* x, void* y, void* dog,
                            const float* taps_host, int ntaps, int H, int W,
                            void* stream) {
  if (ntaps < 1 || ntaps > VKS_MAX_K + 1 || H < 1 || W < 1 ||
      (long long)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  Taps taps;
  for (int j = 0; j < VKS_MAX_K + 1; ++j)
    taps.t[j] = j < ntaps ? taps_host[j] : 0.0f;
  const float* xs = (const float*)x;
  float* ys = (float*)y;
  float* ds = (float*)dog;
  cudaStream_t s = (cudaStream_t)stream;
  switch (ntaps - 1) {
#define VKS_CASE(k) \
  case k:           \
    return launch<k>(xs, ys, ds, taps, H, W, s);
    VKS_CASE(0) VKS_CASE(1) VKS_CASE(2) VKS_CASE(3) VKS_CASE(4)
    VKS_CASE(5) VKS_CASE(6) VKS_CASE(7) VKS_CASE(8) VKS_CASE(9)
    VKS_CASE(10) VKS_CASE(11) VKS_CASE(12) VKS_CASE(13) VKS_CASE(14)
    VKS_CASE(15) VKS_CASE(16) VKS_CASE(17) VKS_CASE(18) VKS_CASE(19)
#undef VKS_CASE
  }
  return (int)cudaErrorInvalidValue;
}
