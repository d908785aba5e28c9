// K6 2-D: the multi-resolution discriminator's 2-D convolutions over
// [B, frames, F, C] (NHWC), their input gradient and their weight gradient.
//
// Replaces fish_diffusion_tpu/ops/blocked_conv.py:blocked_apply_2d (called
// from models/discriminators.py:DiscriminatorR._call_blocked), which folded
// 4 frequency bins into the channels so that the 32-wide convs filled the
// TPU's 128-lane matrix unit. The fold is not carried over: this is the
// plain 2-D convolution it computed (kernel (3, 9) or (3, 3), stride 1 in
// time and 1 or 2 in frequency, channels 1 -> 32 -> ... -> 32 -> 1).
//
//   conv2d(transposed = 0), stride (SH, SW), zero padding (PH, PW):
//     out[b, h, w, o] = bias[o] + sum_{kh, kw, c} W[kh, kw, c, o]
//                                  * x[b, h*SH + kh - PH, w*SW + kw - PW, c]
//   conv2d(transposed = 1), torch conv_transpose2d semantics:
//     out[b, h, w, o] = bias[o] + sum_{kh, kw, c : (h + PH - kh) % SH == 0,
//                                               (w + PW - kw) % SW == 0}
//                       W[kh, kw, c, o] * x[b, (h + PH - kh) / SH, (w + PW - kw) / SW, c]
//   W is packed [KH, KW, C_in, C_out]; bias may be null. The transposed mode
//   is a strided conv's input gradient (x = the output's gradient, W
//   re-packed by the wrapper, KH and KW padded with zero taps to multiples
//   of the strides); a stride-1 conv's input gradient is the direct mode
//   with flipped taps and swapped channels.
//   conv2d_wgrad: dW[kh, kw, c, o] = sum_{b, h, w} x[b, h*SH + kh - PH,
//     w*SW + kw - PW, c] * g[b, h, w, o], out of range reading 0.
//
// Bound on an H100: arithmetic. One MRD forward over a batch of 16 x 32768
// samples is ~0.38 TFLOP of float32, layer 1 alone ~62 GFLOP. Design: K4's
// (csrc/conv1d.cu) in two dimensions. One block per (tile of output
// positions x tile of output channels x batch row); the tile is tile_h
// rows by tile_w columns (tile_w from 8 to 128, chosen by the host to waste
// the fewest columns at the right edge). It stages the input window of the
// tile, halo included, for 8 input channels at a time (1 for the
// single-channel spectrogram, so that layer 0's 27 taps are not padded to
// 8 channels), and those channels' taps, in shared memory, and keeps an
// 8 x 4 (position x channel) register tile per thread with float32
// accumulation: 32 FMAs for every 9 shared-memory loads. C_out = 1
// (conv_post, and layer 0's input gradient) takes a tile of 1024
// positions x 1 channel. The transposed mode runs one output residue class
// (h mod SH, w mod SW) per block, as K4's and K6's transposed modes do.
// The weight gradient (conv2d_wgrad) is wgrad.cuh's, the same core as
// conv1d_wgrad.cu's: the 2-D problem is the 1-D one per input row, with
// the lines (b, h) and the KH tap rows as a second tap axis. Its bound is
// float32 operations too (378 GFLOP for one MRD pass at 16 x 32768
// samples, 92% in the stride-(1, 2) 32 -> 32 layers: 5.77 ms at 67
// TFLOP/s). A block owns one or all three tap rows and stages, per strip
// of output columns of one line, the input rows' window (halo included)
// and the gradient's strip through a cp.async ring; a thread keeps 3 taps
// x 4 input channels x 8 output channels (layer 0's single input channel:
// 9 taps x 8; conv_post's single output channel: 3 taps x 4). Partial
// tiles over chunks of the B x H' x W' reduction are added in chunk order
// (no atomics). Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W):
// one MRD pass 10.67 ms, 54% of the bound, layers 1-3 at 36-40 TFLOP/s
// (the first version, an im2col row gathered from global memory per tap,
// 49.31 ms; cuDNN 20.29).

#include <cuda_runtime.h>

#include "wgrad.cuh"

namespace {

constexpr int THREADS = 256;

struct Conv2dArgs {
  int B, H_in, W_in, H_out, W_out, C_in, C_out, KH, KW, SH, SW, PH, PW;
  int tile_w;  // output columns per tile; tile_h = positions per block / tile_w
};

// taps per output along each axis: all of them, or (transposed) the K / S
// taps of one residue class
__host__ __device__ inline int taps_h(const Conv2dArgs& p, bool transposed) {
  return transposed ? p.KH / p.SH : p.KH;
}
__host__ __device__ inline int taps_w(const Conv2dArgs& p, bool transposed) {
  return transposed ? p.KW / p.SW : p.KW;
}
// the input window a tile of th x tw outputs reads
__host__ __device__ inline int window_rows(const Conv2dArgs& p, bool transposed,
                                           int th) {
  return transposed ? th + taps_h(p, true) - 1 : (th - 1) * p.SH + p.KH;
}
__host__ __device__ inline int window_cols(const Conv2dArgs& p, bool transposed,
                                           int tw) {
  return transposed ? tw + taps_w(p, true) - 1 : (tw - 1) * p.SW + p.KW;
}
// outputs per residue class along an axis (transposed), or all of them
__host__ __device__ inline int class_len(int n_out, int s, int pad,
                                         bool transposed) {
  return transposed ? (n_out - 1 + pad) / s + 1 : n_out;
}

template <int N>
__device__ __forceinline__ void load_smem(const float* q, float* v) {
  if constexpr (N == 4) {
    const float4 f = *reinterpret_cast<const float4*>(q);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = q[i];
  }
}

template <int BCO, int TM, int TN, int BCI, bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS) conv2d_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, Conv2dArgs p) {
  extern __shared__ float smem[];
  constexpr int TX = BCO / TN;  // threads along out-channels
  constexpr int TY = THREADS / TX;  // threads along positions
  constexpr int BP = TY * TM;   // positions per block
  constexpr int XS = BCI == 1 ? 1 : BCI + 1;  // window stride; +1 spreads banks

  const int tw = p.tile_w;
  const int th = BP / tw;
  const int nw = class_len(p.W_out, p.SW, p.PW, TRANSPOSED);
  const int tiles_w = (nw + tw - 1) / tw;
  const int h0 = (blockIdx.x / tiles_w) * th;  // first output row (or u)
  const int w0 = (blockIdx.x % tiles_w) * tw;  // first output column (or v)
  const int o0 = blockIdx.y * BCO;
  const int classes = TRANSPOSED ? p.SH * p.SW : 1;
  const int b = blockIdx.z / classes;
  const int rh = TRANSPOSED ? (blockIdx.z % classes) / p.SW : 0;
  const int rw = TRANSPOSED ? (blockIdx.z % classes) % p.SW : 0;
  const int qh_n = taps_h(p, TRANSPOSED);
  const int qw_n = taps_w(p, TRANSPOSED);
  const int taps = qh_n * qw_n;
  const int rows = window_rows(p, TRANSPOSED, th);
  const int cols = window_cols(p, TRANSPOSED, tw);
  const int lo_h = TRANSPOSED ? h0 - (qh_n - 1) : h0 * p.SH - p.PH;
  const int lo_w = TRANSPOSED ? w0 - (qw_n - 1) : w0 * p.SW - p.PW;

  float* xs = smem;                                  // [rows][cols][XS]
  float* ws = smem + ((rows * cols * XS + 3) & ~3);  // [taps][BCI][BCO]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  // window offset of each of the thread's positions (tap 0, channel 0)
  int off[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int pos = ty + i * TY;
    const int ph = pos / tw, pw = pos % tw;
    off[i] = TRANSPOSED ? (ph * cols + pw) * XS
                        : (ph * p.SH * cols + pw * p.SW) * XS;
  }

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const float* xb = x + (size_t)b * p.H_in * p.W_in * p.C_in;

  for (int c0 = 0; c0 < p.C_in; c0 += BCI) {
    for (int idx = tid; idx < rows * cols * BCI; idx += THREADS) {
      const int c = idx % BCI;
      const int rc = idx / BCI;
      const int gr = lo_h + rc / cols;
      const int gc = lo_w + rc % cols;
      xs[rc * XS + c] =
          (gr >= 0 && gr < p.H_in && gc >= 0 && gc < p.W_in && c0 + c < p.C_in)
              ? xb[((size_t)gr * p.W_in + gc) * p.C_in + c0 + c]
              : 0.f;
    }
    for (int idx = tid; idx < taps * BCI * BCO; idx += THREADS) {
      const int o = idx % BCO;
      const int c = (idx / BCO) % BCI;
      const int q = idx / (BCO * BCI);
      const int kh = TRANSPOSED ? rh + (q / qw_n) * p.SH : q / qw_n;
      const int kw = TRANSPOSED ? rw + (q % qw_n) * p.SW : q % qw_n;
      ws[idx] = (c0 + c < p.C_in && o0 + o < p.C_out)
                    ? w[(((size_t)kh * p.KW + kw) * p.C_in + c0 + c) * p.C_out +
                        o0 + o]
                    : 0.f;
    }
    __syncthreads();

    for (int q = 0; q < taps; ++q) {
      const int qh = q / qw_n, qw = q % qw_n;
      // window offset of this tap, less that of tap 0
      const int toff = TRANSPOSED
                           ? ((qh_n - 1 - qh) * cols + (qw_n - 1 - qw)) * XS
                           : (qh * cols + qw) * XS;
#pragma unroll
      for (int c = 0; c < BCI; ++c) {
        float bv[TN];
        load_smem<TN>(&ws[(q * BCI + c) * BCO + tx * TN], bv);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = xs[off[i] + toff + c];
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a * bv[j];
        }
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * p.H_out * p.W_out * p.C_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int pos = ty + i * TY;
    const int u = h0 + pos / tw, v = w0 + pos % tw;
    const int h = TRANSPOSED ? u * p.SH + rh - p.PH : u;
    const int ww = TRANSPOSED ? v * p.SW + rw - p.PW : v;
    if (h < 0 || h >= p.H_out || ww < 0 || ww >= p.W_out) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o >= p.C_out) continue;
      ob[((size_t)h * p.W_out + ww) * p.C_out + o] =
          acc[i][j] + (bias ? bias[o] : 0.f);
    }
  }
}

template <int BCO, int TM, int TN, int BCI, bool TRANSPOSED>
int launch_tile(const float* x, const float* w, const float* bias, float* out,
                Conv2dArgs p, cudaStream_t stream) {
  constexpr int BP = (THREADS / (BCO / TN)) * TM;
  const int nh = class_len(p.H_out, p.SH, p.PH, TRANSPOSED);
  const int nw = class_len(p.W_out, p.SW, p.PW, TRANSPOSED);
  // the tile's width: the fewest columns computed past the right edge,
  // the wider tile on a tie
  int best = 0;
  for (int tw = 8; tw <= 128 && tw <= BP; tw *= 2) {
    const int waste = (nw + tw - 1) / tw * tw;
    if (best == 0 || waste <= (nw + best - 1) / best * best) best = tw;
  }
  p.tile_w = best;
  const int th = BP / best;
  const int rows = window_rows(p, TRANSPOSED, th);
  const int cols = window_cols(p, TRANSPOSED, best);
  constexpr int XS = BCI == 1 ? 1 : BCI + 1;
  const int taps = taps_h(p, TRANSPOSED) * taps_w(p, TRANSPOSED);
  const size_t smem =
      sizeof(float) * (((rows * cols * XS + 3) & ~3) + taps * BCI * BCO);
  auto kernel = conv2d_kernel<BCO, TM, TN, BCI, TRANSPOSED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = ((nh + th - 1) / th) * ((nw + best - 1) / best);
  dim3 grid(tiles, (p.C_out + BCO - 1) / BCO,
            TRANSPOSED ? p.B * p.SH * p.SW : p.B);
  kernel<<<grid, THREADS, smem, stream>>>(x, w, bias, out, p);
  return (int)cudaGetLastError();
}

template <int BCI, bool TRANSPOSED>
int dispatch(const float* x, const float* w, const float* bias, float* out,
             const Conv2dArgs& p, cudaStream_t stream) {
  if (p.C_out > 1)
    return launch_tile<32, 8, 4, BCI, TRANSPOSED>(x, w, bias, out, p, stream);
  return launch_tile<1, 4, 1, BCI, TRANSPOSED>(x, w, bias, out, p, stream);
}

}  // namespace

// x [B, H_in, W_in, C_in], w [KH, KW, C_in, C_out], bias [C_out] or null,
// out [B, H_out, W_out, C_out]; float32, contiguous (the Python wrapper
// checks). For transposed = 1 the wrapper guarantees KH % SH == 0 and
// KW % SW == 0. Returns the cudaError_t of the launch.
extern "C" int conv2d(int transposed, const void* x, const void* w,
                      const void* bias, void* out, int B, int H_in, int W_in,
                      int H_out, int W_out, int C_in, int C_out, int KH, int KW,
                      int SH, int SW, int PH, int PW, void* stream) {
  Conv2dArgs p{B,  H_in, W_in, H_out, W_out, C_in, C_out, KH,
               KW, SH,   SW,   PH,    PW,    0};
  const float* xp = (const float*)x;
  const float* wp = (const float*)w;
  const float* bp = (const float*)bias;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (transposed) return dispatch<8, true>(xp, wp, bp, op, p, s);
  if (C_in == 1) return dispatch<1, false>(xp, wp, bp, op, p, s);
  return dispatch<8, false>(xp, wp, bp, op, p, s);
}

namespace {

wgrad::Args args_2d(int B, int H_in, int W_in, int H_out, int W_out, int C_in,
                    int C_out, int KH, int KW, int SH, int SW, int PH, int PW) {
  return wgrad::Args{B,     H_in,  H_out, KH, SH, PH,  W_in, W_out, C_in, C_out,
                     KW,    SW,    1,     PW, 1,  0.f, 0.f,  0,     0};
}

}  // namespace

// The number of reduction chunks conv2d_wgrad plans for these shapes
// (enough blocks to fill the card once); the wrapper sizes the partial
// buffer [splits, KH, KW, C_in, C_out] from it. Negative: a CUDA error.
extern "C" int conv2d_wgrad_splits(int B, int H_in, int W_in, int H_out,
                                   int W_out, int C_in, int C_out, int KH,
                                   int KW, int SH, int SW, int PH, int PW) {
  return wgrad::splits_for(args_2d(B, H_in, W_in, H_out, W_out, C_in, C_out,
                                   KH, KW, SH, SW, PH, PW));
}

// x [B, H_in, W_in, C_in], g [B, H_out, W_out, C_out], part [splits, KH,
// KW, C_in, C_out] (scratch; any splits >= 1), out [KH, KW, C_in, C_out];
// float32, contiguous. Returns the cudaError_t of the launches.
extern "C" int conv2d_wgrad(const void* x, const void* g, void* part, void* out,
                            int B, int H_in, int W_in, int H_out, int W_out,
                            int C_in, int C_out, int KH, int KW, int SH, int SW,
                            int PH, int PW, int splits, void* stream) {
  return wgrad::run((const float*)x, (const float*)g, (float*)part, (float*)out,
                    args_2d(B, H_in, W_in, H_out, W_out, C_in, C_out, KH, KW,
                            SH, SW, PH, PW),
                    splits, (cudaStream_t)stream);
}
