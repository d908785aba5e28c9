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

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 16;                 // rows of a class per block
constexpr int SPLIT = THREADS / ROWS;    // threads per row in the reductions
constexpr int TAPS = 7;
constexpr int HALF = TAPS / 2;
constexpr int SMEM_LIMIT = 232448;

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
  const int b = blockIdx.z, r = blockIdx.y;
  const int n_r = (T - r + d - 1) / d;  // rows of class r: t = r + i * d < T
  const int i0 = blockIdx.x * ROWS;
  if (i0 >= n_r) return;                // the whole block, before any barrier
  const int n_rows = n_r - i0 < ROWS ? n_r - i0 : ROWS;
  const size_t row0 = (size_t)b * T;

  // which of the window's source rows hold data: inside [0, T), not padding
  __shared__ unsigned char live[ROWS + 2 * HALF];
  if (threadIdx.x < ROWS + 2 * HALF) {
    const int i = i0 - HALF + (int)threadIdx.x;
    bool ok = i >= 0 && i < n_r;
    if (ok && mask != nullptr) ok = !mask[row0 + r + (size_t)i * d];
    live[threadIdx.x] = ok;
  }
  __syncthreads();

  // phase 1: the conv of each channel over the tile, from a register window.
  // The loads are unconditional (a row outside [0, T) reads its nearest
  // row of the class, then counts as 0), so a thread has its whole window
  // in flight at once
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float s = step[(size_t)b * C + c];
    float y[ROWS + 2 * HALF];
#pragma unroll
    for (int j = 0; j < ROWS + 2 * HALF; ++j) {
      const int i = i0 - HALF + j;
      const int ic = i < 0 ? 0 : (i < n_r ? i : n_r - 1);
      const size_t o = (row0 + r + (size_t)ic * d) * C + c;
      const float v = (x[o] + s) + cond[o];
      y[j] = live[j] ? v : 0.f;
    }
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
  __syncthreads();

  // phase 2: mean and variance of each row (rows past n_rows hold the conv
  // of zeros: computed, never written out)
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

  // phase 3: normalise and write the tile's rows
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float w = ln_w[c], lb = ln_b[c];
    for (int m = 0; m < n_rows; ++m) {
      const size_t t = r + (size_t)(i0 + m) * d;
      out[(row0 + t) * C + c] = (h[(size_t)m * C + c] - stat[m]) * stat[ROWS + m] * w + lb;
    }
  }
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
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const int e = (int)cudaFuncSetAttribute(
        dwconv7_norm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != 0) return e;
  }
  const int class_rows = (T + d - 1) / d;  // class 0 has the most rows
  dim3 grid((class_rows + ROWS - 1) / ROWS, d < T ? d : T, B);
  dwconv7_norm_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)step, (const float*)cond, (const unsigned char*)mask,
      (const float*)k, (const float*)b, (const float*)ln_w, (const float*)ln_b,
      (float*)out, T, C, d, eps);
  return (int)cudaGetLastError();
}
