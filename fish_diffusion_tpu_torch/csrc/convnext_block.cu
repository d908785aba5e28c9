// K10: the ConvNeXt block's depthwise dilated conv7 with its pre-add,
// padding mask and LayerNorm, in one pass.
//
// Replaces fish_diffusion_tpu/models/convnext.py:47 DepthwiseConv7 (the
// conv as 7 shifted broadcast multiplies for the TPU's vector unit, with a
// lax.switch over static shifts), together with what ConvNeXtBlock (:105)
// does right before it (the step and condition projections added, the
// padding rows zeroed) and right after it (nn.LayerNorm, eps 1e-6):
//
//   y[t, c]   = mask[t] ? 0 : (x[t, c] + step[c]) + cond[t, c],
//               0 outside [0, T)
//   h[t, c]   = b[c] + sum_{j < 7} k[j, c] y[t + (j - 3) d, c]
//   out[t, c] = (h[t, c] - mean_t) / sqrt(var_t + eps) * scale[c] + bias[c]
//
// with mean_t and the biased var_t over the C channels of row t. The mask
// applies to each tap's source row, so taps that cross into padding read 0.
//
// Bound on an H100: bytes. x and cond are read and out written once, 12
// bytes an element, against 24 float operations an element (2 for the
// pre-add, 14 for the taps and the bias, 8 for the norm): at B=4 x 1024
// frames x 512 channels, 25.2 MB, 7.5 us at 3.35 TB/s.
// Design: a block owns ROWS rows of one residue class t = r + i * d of one
// batch item (a tile of i), and all C channels. A tap of a row in class r
// lies in class r too, so the block's window is ROWS + 6 rows of its class
// whatever the dilation: a halo of 6 rows, not of 6 d. First, which of the
// window's source rows are live (inside [0, T), not padding) goes to
// shared memory. Phase 1, threads over channels: a thread loads its
// channel's window into registers with unconditional loads (a dead row
// reads its nearest row of the class and counts as 0), so that all its
// loads are in flight at once, adds and masks each source row as it lands,
// and writes its ROWS conv outputs into shared memory (a ROWS x C tile).
// Phase 2: the mean, then the variance about it (two passes, so that a row
// of constant h has variance 0 and gives the ln bias, not NaN), each row's
// sum taken by THREADS / ROWS threads over interleaved channels and their
// partial sums added in a fixed order: no atomics and no warp intrinsics
// (the same code runs in the host emulation of the tests), reruns
// bit-equal. Phase 3, threads over channels: normalise and write the
// tile's rows. At most 128 registers, two blocks an SM. Any T and
// dilation; C up to what the tile leaves of shared memory (3614).
// (A first version that branched on each source row's mask before loading
// it kept each thread's loads waiting on one another and was markedly
// slower; staging the window in shared memory with float4 loads of all
// threads was no faster at the main path's shapes.)

//
// Training. The backward replaces XLA's derivative of the same
// DepthwiseConv7 and LayerNorm. Given go = dL/dout, with n = (h - mean_t)
// r_t (r_t = 1 / sqrt(var_t + eps)) and g = go * scale:
//
//   norm (per row):  dh = r_t (g - mean_C(g) - n mean_C(g n))
//   columns:         dscale = sum go n, dbias = sum go, db = sum dh,
//                    dk[j] = sum_t dh[t] y[t + (j - 3) d]
//   taps:            dy[t] = live(t) ? sum_j k[j] dh[t - (j - 3) d] : 0
//                    (dh 0 outside [0, T); live: inside [0, T), not padding)
//   inputs:          dx = dcond = dy, dstep = sum_t dy
//
// The mask applies to the source row only: the forward computes h at a
// padded row from its live neighbours, so dh there flows back to them.
//
//   depthwise_conv7_norm_backward_rows (kernel A): the forward's tile and
//     its own phase 1 and 2 (conv_tile, row_stats: h and the statistics as
//     the forward computes them), then go and n in shared memory, the two
//     row means, dh written to [B, T, C] and over go in the tile, and the
//     tile's column partials of dscale, dbias, db and dk (10 x C floats),
//     dk from dh in the tile and the window reloaded (load_window).
//   depthwise_conv7_backward_taps (kernel B): the same tiling; a thread
//     loads dh over its channel's window (the 6-row halo of the class),
//     applies the 7 taps transposed, zeroes padded rows and writes dy, and
//     the tile's column sums of dy (C floats, for dstep).
//
// The partials are one slot per tile (a tile past its class's rows writes
// zeros), added by the wrapper in an order fixed by the shapes: no
// atomics, reruns bit-equal. Rows past n_rows of a ragged tile add nothing:
// their go, n and dh are 0. Bound: bytes. Kernel A reads x, cond and go
// and writes dh (16 bytes an element), kernel B reads dh and writes dy (8);
// ~50 float operations an element. Kernel A keeps two ROWS x C tiles in
// shared memory (64 KB at C = 512): C up to 1798. (A first kernel A that
// loaded go row by row behind each row's bound check was markedly slower
// at a training step's shape; one that issued the window's reload before
// forming dh gained little for more spills: not kept.)

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 16;                 // rows of a class per block
constexpr int SPLIT = THREADS / ROWS;    // threads per row in the reductions
constexpr int TAPS = 7;
constexpr int HALF = TAPS / 2;
constexpr int WINDOW = ROWS + 2 * HALF;  // a tile's rows with their halo
constexpr int SMEM_LIMIT = 232448;
constexpr int PARTS = 3 + TAPS;          // kernel A's partials a tile: dscale, dbias, db, dk

// A block's place: batch item b, residue class r, rows i0 .. i0 + n_rows
// of the class (t = r + i d), n_r rows in the class.
struct Tile {
  int b, r, n_r, i0, n_rows;
  size_t row0;  // b * T
  size_t index; // the block's slot among the grid's tiles
};

__device__ __forceinline__ Tile tile_of(int T, int d) {
  Tile p;
  p.b = blockIdx.z;
  p.r = blockIdx.y;
  p.n_r = (T - p.r + d - 1) / d;
  p.i0 = blockIdx.x * ROWS;
  p.n_rows = p.n_r - p.i0 < ROWS ? p.n_r - p.i0 : ROWS;
  p.row0 = (size_t)p.b * T;
  const int gx = ((T + d - 1) / d + ROWS - 1) / ROWS, gy = d < T ? d : T;  // grid_of's
  p.index = ((size_t)p.b * gy + p.r) * gx + blockIdx.x;
  return p;
}

// which of the window's source rows hold data: inside [0, T), not padding
__device__ __forceinline__ void mark_live(unsigned char* live, const unsigned char* mask,
                                          const Tile& p, int d) {
  if (threadIdx.x < WINDOW) {
    const int i = p.i0 - HALF + (int)threadIdx.x;
    bool ok = i >= 0 && i < p.n_r;
    if (ok && mask != nullptr) ok = !mask[p.row0 + p.r + (size_t)i * d];
    live[threadIdx.x] = ok;
  }
}

// channel c's pre-added, masked window y[WINDOW]. The loads are
// unconditional (a row outside [0, T) reads its nearest row of the class,
// then counts as 0), so a thread has its whole window in flight at once
__device__ __forceinline__ void load_window(float* y, const float* __restrict__ x, float s,
                                            const float* __restrict__ cond,
                                            const unsigned char* live, const Tile& p, int d,
                                            int C, int c) {
#pragma unroll
  for (int j = 0; j < WINDOW; ++j) {
    const int i = p.i0 - HALF + j;
    const int ic = i < 0 ? 0 : (i < p.n_r ? i : p.n_r - 1);
    const size_t o = (p.row0 + p.r + (size_t)ic * d) * C + c;
    const float v = (x[o] + s) + cond[o];
    y[j] = live[j] ? v : 0.f;
  }
}

// phase 1: the conv of each channel over the tile into h [ROWS][C], from a
// register window
__device__ __forceinline__ void conv_tile(float* h, const float* __restrict__ x,
                                          const float* __restrict__ step,
                                          const float* __restrict__ cond,
                                          const float* __restrict__ k,
                                          const float* __restrict__ bias,
                                          const unsigned char* live, const Tile& p, int d,
                                          int C) {
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float y[WINDOW];
    load_window(y, x, step[(size_t)p.b * C + c], cond, live, p, d, C, c);
    float kc[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) kc[j] = k[(size_t)j * C + c];
    const float bc = bias[c];
#pragma unroll
    for (int l = 0; l < ROWS; ++l) {
      float acc = bc;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) acc += kc[j] * y[l + j];
      h[(size_t)l * C + c] = acc;
    }
  }
}

// the sum over C of each row of a [ROWS][C] tile (of a * b with b), taken
// by SPLIT threads over interleaved channels and added in a fixed order;
// the caller has synchronised after writing the tile. Row l's sum lands in
// out[l]; ends synchronised
__device__ __forceinline__ void row_sums(const float* a, const float* b, const float* w,
                                         float* part, float* out, int C) {
  const int l = threadIdx.x / SPLIT, p = threadIdx.x % SPLIT;
  const float* al = a + (size_t)l * C;
  const float* bl = b == nullptr ? nullptr : b + (size_t)l * C;
  float acc = 0.f;
  for (int c = p; c < C; c += SPLIT) {
    float v = al[c];
    if (w != nullptr) v *= w[c];
    if (bl != nullptr) v *= bl[c];
    acc += v;
  }
  part[threadIdx.x] = acc;
  __syncthreads();
  if (p == 0) {
    float sum = 0.f;
    for (int q = 0; q < SPLIT; ++q) sum += part[l * SPLIT + q];
    out[l] = sum;
  }
  __syncthreads();
}

// phase 2: mean and 1 / std of each row into stat[0 .. ROWS) and
// stat[ROWS .. 2 ROWS): the mean, then the variance about it (two passes,
// so that a row of constant h has variance 0). Rows past n_rows hold the
// conv of zeros: computed, never written out. Ends synchronised
__device__ __forceinline__ void row_stats(const float* h, float* part, float* stat, int C,
                                          float eps) {
  const int l = threadIdx.x / SPLIT, p = threadIdx.x % SPLIT;
  const float* hl = h + (size_t)l * C;
  float acc = 0.f;
  for (int c = p; c < C; c += SPLIT) acc += hl[c];
  part[threadIdx.x] = acc;
  __syncthreads();
  if (p == 0) {
    float sum = 0.f;
    for (int q = 0; q < SPLIT; ++q) sum += part[l * SPLIT + q];
    stat[l] = sum / (float)C;
  }
  __syncthreads();
  const float mean = stat[l];
  acc = 0.f;
  for (int c = p; c < C; c += SPLIT) {
    const float e = hl[c] - mean;
    acc += e * e;
  }
  part[threadIdx.x] = acc;  // the first sums were read before the barrier above
  __syncthreads();
  if (p == 0) {
    float sum = 0.f;
    for (int q = 0; q < SPLIT; ++q) sum += part[l * SPLIT + q];
    stat[ROWS + l] = 1.f / sqrtf(sum / (float)C + eps);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2)
dwconv7_norm_kernel(const float* __restrict__ x, const float* __restrict__ step,
                    const float* __restrict__ cond, const unsigned char* __restrict__ mask,
                    const float* __restrict__ k, const float* __restrict__ bias,
                    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                    float* __restrict__ out, int T, int C, int d, float eps) {
  extern __shared__ float smem[];
  float* h = smem;                      // [ROWS][C] conv outputs of the tile
  float* part = h + (size_t)ROWS * C;   // [THREADS] partial sums
  float* stat = part + THREADS;         // [ROWS] means, then [ROWS] 1 / std
  const Tile p = tile_of(T, d);
  if (p.i0 >= p.n_r) return;            // the whole block, before any barrier

  __shared__ unsigned char live[WINDOW];
  mark_live(live, mask, p, d);
  __syncthreads();
  conv_tile(h, x, step, cond, k, bias, live, p, d, C);
  __syncthreads();
  row_stats(h, part, stat, C, eps);

  // phase 3: normalise and write the tile's rows
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float w = ln_w[c], lb = ln_b[c];
    for (int m = 0; m < p.n_rows; ++m) {
      const size_t t = p.r + (size_t)(p.i0 + m) * d;
      out[(p.row0 + t) * C + c] = (h[(size_t)m * C + c] - stat[m]) * stat[ROWS + m] * w + lb;
    }
  }
}

// kernel A: dh and the tile's column partials [PARTS][C] (see the top)
__global__ void __launch_bounds__(THREADS, 2)
dwconv7_norm_backward_rows_kernel(const float* __restrict__ go, const float* __restrict__ x,
                                  const float* __restrict__ step,
                                  const float* __restrict__ cond,
                                  const unsigned char* __restrict__ mask,
                                  const float* __restrict__ k, const float* __restrict__ bias,
                                  const float* __restrict__ ln_w, float* __restrict__ dh,
                                  float* __restrict__ partials, int T, int C, int d,
                                  float eps) {
  extern __shared__ float smem[];
  float* h = smem;                       // [ROWS][C]: h, then n
  float* g = h + (size_t)ROWS * C;       // [ROWS][C]: go
  float* part = g + (size_t)ROWS * C;    // [THREADS] partial sums
  float* stat = part + THREADS;          // [4][ROWS]: mean, 1 / std, mean(g), mean(g n)
  const Tile p = tile_of(T, d);
  float* out = partials + p.index * PARTS * C;
  if (p.i0 >= p.n_r) {                   // a tile past its class's rows adds nothing
    for (int c = threadIdx.x; c < PARTS * C; c += THREADS) out[c] = 0.f;
    return;
  }

  __shared__ unsigned char live[WINDOW];
  mark_live(live, mask, p, d);
  __syncthreads();
  conv_tile(h, x, step, cond, k, bias, live, p, d, C);
  __syncthreads();
  row_stats(h, part, stat, C, eps);

  // phase 3: n over h and go beside it; rows past n_rows hold 0. The loads
  // of go are unconditional (a row past n_rows reads the tile's last row),
  // so a thread has all of them in flight at once
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float gv[ROWS];
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const int mc = m < p.n_rows ? m : p.n_rows - 1;
      gv[m] = go[(p.row0 + p.r + (size_t)(p.i0 + mc) * d) * C + c];
    }
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const size_t o = (size_t)m * C + c;
      const bool in = m < p.n_rows;
      g[o] = in ? gv[m] : 0.f;
      h[o] = in ? (h[o] - stat[m]) * stat[ROWS + m] : 0.f;
    }
  }
  __syncthreads();

  // phase 4: each row's mean over C of go * scale and of go * scale * n
  row_sums(g, nullptr, ln_w, part, stat + 2 * ROWS, C);
  row_sums(g, h, ln_w, part, stat + 3 * ROWS, C);
  if (threadIdx.x < 2 * ROWS) stat[2 * ROWS + threadIdx.x] /= (float)C;
  __syncthreads();

  // phase 5: dh for the tile's rows (to device memory, and over go in the
  // tile: each thread reads and writes its own channels only), and the
  // tile's column partials, dk from dh in the tile and the window reloaded
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float w = ln_w[c];
    float dw = 0.f, dlb = 0.f, db = 0.f;
    for (int m = 0; m < p.n_rows; ++m) {
      const size_t o = (size_t)m * C + c;
      const float gv = g[o], n = h[o];
      const float v = stat[ROWS + m] * ((gv * w - stat[2 * ROWS + m]) - n * stat[3 * ROWS + m]);
      dw += gv * n;
      dlb += gv;
      db += v;
      g[o] = v;
      dh[(p.row0 + p.r + (size_t)(p.i0 + m) * d) * C + c] = v;
    }
    for (int m = p.n_rows; m < ROWS; ++m) g[(size_t)m * C + c] = 0.f;
    out[c] = dw;
    out[(size_t)C + c] = dlb;
    out[(size_t)2 * C + c] = db;
    float y[WINDOW];
    load_window(y, x, step[(size_t)p.b * C + c], cond, live, p, d, C, c);
    float dk[TAPS] = {};
#pragma unroll
    for (int m = 0; m < ROWS; ++m) {
      const float v = g[(size_t)m * C + c];
#pragma unroll
      for (int j = 0; j < TAPS; ++j) dk[j] += v * y[m + j];
    }
#pragma unroll
    for (int j = 0; j < TAPS; ++j) out[(size_t)(3 + j) * C + c] = dk[j];
  }
}

// kernel B: dy and the tile's column sums of dy [C] (see the top)
__global__ void __launch_bounds__(THREADS, 2)
dwconv7_backward_taps_kernel(const float* __restrict__ dh,
                             const unsigned char* __restrict__ mask,
                             const float* __restrict__ k, float* __restrict__ dy,
                             float* __restrict__ partials, int T, int C, int d) {
  const Tile p = tile_of(T, d);
  float* out = partials + p.index * C;
  if (p.i0 >= p.n_r) {
    for (int c = threadIdx.x; c < C; c += THREADS) out[c] = 0.f;
    return;
  }
  // inside: the window rows of dh inside [0, T); keep: the tile's rows that
  // are live sources (inside [0, T), not padding)
  __shared__ unsigned char inside[WINDOW], keep[ROWS];
  if (threadIdx.x < WINDOW) {
    const int i = p.i0 - HALF + (int)threadIdx.x;
    inside[threadIdx.x] = i >= 0 && i < p.n_r;
  } else if (threadIdx.x < WINDOW + ROWS) {
    const int m = (int)threadIdx.x - WINDOW, i = p.i0 + m;
    bool ok = m < p.n_rows;
    if (ok && mask != nullptr) ok = !mask[p.row0 + p.r + (size_t)i * d];
    keep[m] = ok;
  }
  __syncthreads();

  // offsets inside one item fit 32 bits (the C entry checks T * C)
  const float* item = dh + (p.row0 + p.r) * C;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float w[WINDOW];
#pragma unroll
    for (int j = 0; j < WINDOW; ++j) {
      const int i = p.i0 - HALF + j;
      const int ic = i < 0 ? 0 : (i < p.n_r ? i : p.n_r - 1);
      const float v = item[ic * d * C + c];
      w[j] = inside[j] ? v : 0.f;
    }
    float kc[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) kc[j] = k[(size_t)j * C + c];
    float sum = 0.f;
#pragma unroll
    for (int l = 0; l < ROWS; ++l) {
      // row l's output reads h at rows l + 3 - j' (j' = j - 3): window l + 6 - j
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) acc += kc[j] * w[l + 2 * HALF - j];
      acc = keep[l] ? acc : 0.f;
      if (l < p.n_rows) dy[(p.row0 + p.r + (size_t)(p.i0 + l) * d) * C + c] = acc;
      sum += acc;
    }
    out[c] = sum;
  }
}

dim3 grid_of(int B, int T, int d) {
  const int class_rows = (T + d - 1) / d;  // class 0 has the most rows
  return dim3((class_rows + ROWS - 1) / ROWS, d < T ? d : T, B);
}

template <class K>
int set_smem(K kernel, size_t smem) {
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

}  // namespace

// x, cond, out [B, T, C]; step [B, C]; mask [B, T] bytes (nonzero at
// padding) or null; k [7, C]; b, ln_w, ln_b [C]. All float32 and contiguous
// (the Python wrapper checks). Returns the cudaError_t of the launch.
extern "C" int depthwise_conv7_norm(const void* x, const void* step, const void* cond,
                                    const void* mask, const void* k, const void* b,
                                    const void* ln_w, const void* ln_b, void* out, int B,
                                    int T, int C, int d, float eps, void* stream) {
  if (B < 1 || T < 1 || C < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)ROWS * C + THREADS + 2 * ROWS);
  const int e = set_smem(dwconv7_norm_kernel, smem);
  if (e != 0) return e;
  const dim3 grid = grid_of(B, T, d);
  dwconv7_norm_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)step, (const float*)cond, (const unsigned char*)mask,
      (const float*)k, (const float*)b, (const float*)ln_w, (const float*)ln_b,
      (float*)out, T, C, d, eps);
  return (int)cudaGetLastError();
}

// The backward's tiles per batch item (both kernels): the partial-sum
// buffers hold B times this many slots.
extern "C" int depthwise_conv7_backward_tiles(int T, int d) {
  if (T < 1 || d < 1) return 0;
  const dim3 g = grid_of(1, T, d);
  return (int)(g.x * g.y);
}

// Kernel A. go, x, cond, dh [B, T, C]; step [B, C]; mask as above; k [7,
// C]; b, ln_w [C]; partials [B * tiles][10][C]: per tile the column sums of
// go n, go, dh and dk[0..6]. Returns the cudaError_t of the launch.
extern "C" int depthwise_conv7_norm_backward_rows(
    const void* go, const void* x, const void* step, const void* cond, const void* mask,
    const void* k, const void* b, const void* ln_w, void* dh, void* partials, int B, int T,
    int C, int d, float eps, void* stream) {
  if (B < 1 || T < 1 || C < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * ROWS * C + THREADS + 4 * ROWS);
  const int e = set_smem(dwconv7_norm_backward_rows_kernel, smem);
  if (e != 0) return e;
  const dim3 grid = grid_of(B, T, d);
  dwconv7_norm_backward_rows_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)go, (const float*)x, (const float*)step, (const float*)cond,
      (const unsigned char*)mask, (const float*)k, (const float*)b, (const float*)ln_w,
      (float*)dh, (float*)partials, T, C, d, eps);
  return (int)cudaGetLastError();
}

// Kernel B. dh, dy [B, T, C]; mask as above; k [7, C]; partials [B * tiles]
// [C]: per tile the column sums of dy. Returns the cudaError_t of the launch.
extern "C" int depthwise_conv7_backward_taps(const void* dh, const void* mask, const void* k,
                                             void* dy, void* partials, int B, int T, int C,
                                             int d, void* stream) {
  if (B < 1 || T < 1 || C < 1 || d < 1 || (long long)T * C > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const dim3 grid = grid_of(B, T, d);
  dwconv7_backward_taps_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dh, (const unsigned char*)mask, (const float*)k, (float*)dy,
      (float*)partials, T, C, d);
  return (int)cudaGetLastError();
}
