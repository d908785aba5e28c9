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
// samples is ~0.38 TFLOP of float32, layer 1 alone ~62 GFLOP. The direct
// mode (the forward and the stride-1 layers' input gradients) is
// conv_fwd.cuh's kernel, the one K4 (conv1d.cu) runs: the 2-D problem is
// the 1-D one per line (b, h), with the KH tap rows as a second tap axis.
// A block owns LH lines x TW columns (the tile that computes the fewest
// positions at W' = 513, 257, 129, 65, 33) x 32 output channels; it stages
// the tile's input window, halo included (the (LH - 1) * SH + KH input
// rows), and the chunk's weights for all 27 taps, 4 to 16 input channels
// a chunk, through a ring of cp.async stages; a thread keeps 8 positions x
// 8 output channels (layer 0's single input channel: one channel a window
// read; C_out = 1: 8 positions x 1). Measured (chip_smoke.py; NVIDIA H100
// 80GB HBM3, 700 W): one pass's forward and stride-1 input gradients at
// B=16 x 32768 samples 18.16 ms, 35% of the float32 bound, layers 1-3's
// forward at 21-31 TFLOP/s (the first version, K4's synchronous 8-channel
// staging with an 8 x 4 register tile, 24.71 ms; cuDNN 21.37).
// The transposed mode (a strided layer's input gradient) keeps that first
// design: one output residue class (h mod SH, w mod SW) per block, the
// class's taps a stride-1 correlation.
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
#include <cuda_bf16.h>

#include "conv_fwd.cuh"
#include "wgrad.cuh"

namespace {

constexpr int THREADS = 256;

struct Conv2dArgs {
  int B, H_in, W_in, H_out, W_out, C_in, C_out, KH, KW, SH, SW, PH, PW;
  int tile_w;  // output columns per tile; tile_h = positions per block / tile_w
};

// The transposed mode (a strided conv's input gradient): one output
// residue class (h mod SH, w mod SW) per block, the class's KH / SH x
// KW / SW taps; per class the outputs (u, v) at h = u * SH + rh - PH,
// w = v * SW + rw - PW read x[u - qh, v - qw] * W[rh + qh * SH, rw + qw * SW].
__host__ __device__ inline int taps_h(const Conv2dArgs& p) { return p.KH / p.SH; }
__host__ __device__ inline int taps_w(const Conv2dArgs& p) { return p.KW / p.SW; }
// outputs per residue class along an axis
__host__ __device__ inline int class_len(int n_out, int s, int pad) {
  return (n_out - 1 + pad) / s + 1;
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

// A block stages the input window of its tile (th x tw outputs of one
// class, halo included) for 8 input channels at a time and those
// channels' taps in shared memory, and keeps an 8 x 4 (position x channel)
// register tile per thread (C_out = 1: 4 positions x 1 channel).
template <int BCO, int TM, int TN>
__global__ void __launch_bounds__(THREADS) conv2d_transposed_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, Conv2dArgs p) {
  extern __shared__ float smem[];
  constexpr int BCI = 8;
  constexpr int TX = BCO / TN;  // threads along out-channels
  constexpr int TY = THREADS / TX;  // threads along positions
  constexpr int BP = TY * TM;   // positions per block
  constexpr int XS = BCI + 1;   // window stride; +1 spreads banks

  const int tw = p.tile_w;
  const int th = BP / tw;
  const int nw = class_len(p.W_out, p.SW, p.PW);
  const int tiles_w = (nw + tw - 1) / tw;
  const int h0 = (blockIdx.x / tiles_w) * th;  // first u
  const int w0 = (blockIdx.x % tiles_w) * tw;  // first v
  const int o0 = blockIdx.y * BCO;
  const int classes = p.SH * p.SW;
  const int b = blockIdx.z / classes;
  const int rh = (blockIdx.z % classes) / p.SW;
  const int rw = (blockIdx.z % classes) % p.SW;
  const int qh_n = taps_h(p);
  const int qw_n = taps_w(p);
  const int taps = qh_n * qw_n;
  const int rows = th + qh_n - 1;
  const int cols = tw + qw_n - 1;
  const int lo_h = h0 - (qh_n - 1);
  const int lo_w = w0 - (qw_n - 1);

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
    off[i] = ((pos / tw) * cols + pos % tw) * XS;
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
      const int kh = rh + (q / qw_n) * p.SH;
      const int kw = rw + (q % qw_n) * p.SW;
      ws[idx] = (c0 + c < p.C_in && o0 + o < p.C_out)
                    ? w[(((size_t)kh * p.KW + kw) * p.C_in + c0 + c) * p.C_out +
                        o0 + o]
                    : 0.f;
    }
    __syncthreads();

    for (int q = 0; q < taps; ++q) {
      const int qh = q / qw_n, qw = q % qw_n;
      // window offset of this tap, less that of tap 0
      const int toff = ((qh_n - 1 - qh) * cols + (qw_n - 1 - qw)) * XS;
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
    const int h = u * p.SH + rh - p.PH;
    const int ww = v * p.SW + rw - p.PW;
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

template <int BCO, int TM, int TN>
int launch_transposed(const float* x, const float* w, const float* bias, float* out,
                      Conv2dArgs p, cudaStream_t stream) {
  constexpr int BP = (THREADS / (BCO / TN)) * TM;
  const int nh = class_len(p.H_out, p.SH, p.PH);
  const int nw = class_len(p.W_out, p.SW, p.PW);
  // the tile's width: the fewest columns computed past the right edge,
  // the wider tile on a tie
  int best = 0;
  for (int tw = 8; tw <= 128 && tw <= BP; tw *= 2) {
    const int waste = (nw + tw - 1) / tw * tw;
    if (best == 0 || waste <= (nw + best - 1) / best * best) best = tw;
  }
  p.tile_w = best;
  const int th = BP / best;
  const int rows = th + taps_h(p) - 1;
  const int cols = best + taps_w(p) - 1;
  constexpr int XS = 8 + 1;
  const int taps = taps_h(p) * taps_w(p);
  const size_t smem =
      sizeof(float) * (((rows * cols * XS + 3) & ~3) + taps * 8 * BCO);
  auto kernel = conv2d_transposed_kernel<BCO, TM, TN>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = ((nh + th - 1) / th) * ((nw + best - 1) / best);
  dim3 grid(tiles, (p.C_out + BCO - 1) / BCO, p.B * p.SH * p.SW);
  kernel<<<grid, THREADS, smem, stream>>>(x, w, bias, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H_in, W_in, C_in], w [KH, KW, C_in, C_out], bias [C_out] or null,
// out [B, H_out, W_out, C_out]; float32, contiguous (the Python wrapper
// checks). The direct mode (transposed = 0) is conv_fwd.cuh's kernel; for
// transposed = 1 the wrapper guarantees KH % SH == 0 and KW % SW == 0.
// Returns the cudaError_t of the launch.
extern "C" int conv2d(int transposed, const void* x, const void* w,
                      const void* bias, void* out, int B, int H_in, int W_in,
                      int H_out, int W_out, int C_in, int C_out, int KH, int KW,
                      int SH, int SW, int PH, int PW, void* stream) {
  const float* xp = (const float*)x;
  const float* wp = (const float*)w;
  const float* bp = (const float*)bias;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (!transposed) {
    convf::Args p{};
    p.B = B, p.H_in = H_in, p.H_out = H_out, p.KH = KH, p.SH = SH, p.PH = PH;
    p.T_in = W_in, p.T_out = W_out, p.C_in = C_in, p.C_out = C_out;
    p.K = KW, p.S = SW, p.D = 1, p.P = PW, p.KW = KW;
    p.flip = 0, p.classes = 1, p.pad_t = 0;
    return convf::run<float>(xp, wp, bp, nullptr, op, p, s);
  }
  Conv2dArgs p{B,  H_in, W_in, H_out, W_out, C_in, C_out, KH,
               KW, SH,   SW,   PH,    PW,    0};
  if (C_out > 1) return launch_transposed<32, 8, 4>(xp, wp, bp, op, p, s);
  return launch_transposed<1, 4, 1>(xp, wp, bp, op, p, s);
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
