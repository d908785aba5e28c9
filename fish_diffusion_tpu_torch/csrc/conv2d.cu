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
// The transposed mode (the stride-(1, 2) layers' input gradients, stride 1
// in time as in every MRD layer and in blocked_apply_2d) runs the same
// core: one residue class w mod 2 a block, a stride-1 correlation over the
// class's 5 taps (KW padded to 10 by the wrapper) and the 3 tap rows
// reversed. Measured (chip_smoke.py, as above): one pass's 9 launches
// 14.14 ms, 37% of the float32 bound (the first version, one residue
// class per block with K4's synchronous 8-channel staging and an 8 x 4
// register tile, 18.61 ms; cuDNN's conv2d_input 48.07).
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

// x [B, H_in, W_in, C_in], w [KH, KW, C_in, C_out], bias [C_out] or null,
// out [B, H_out, W_out, C_out]; float32, contiguous (the Python wrapper
// checks). Both modes run conv_fwd.cuh's kernel. transposed = 1 takes
// stride 1 in H (every MRD layer's) and KW % SW == 0 (the wrapper pads KW
// with zero taps); other strides return cudaErrorInvalidValue and launch
// nothing. Returns the cudaError_t of the launch.
extern "C" int conv2d(int transposed, const void* x, const void* w,
                      const void* bias, void* out, int B, int H_in, int W_in,
                      int H_out, int W_out, int C_in, int C_out, int KH, int KW,
                      int SH, int SW, int PH, int PW, void* stream) {
  convf::Args p{};
  p.B = B, p.H_in = H_in, p.H_out = H_out, p.KH = KH, p.SH = SH, p.PH = PH;
  p.T_in = W_in, p.T_out = W_out, p.C_in = C_in, p.C_out = C_out, p.KW = KW;
  p.groups = 1;
  if (transposed) {
    if (SH != 1 || KW % SW) return (int)cudaErrorInvalidValue;
    // rows: a correlation with the tap rows reversed, at padding KH - 1 -
    // PH; columns: K4's transposed mode, one residue class w mod SW a block
    // over its KW / SW taps (conv_fwd.cuh)
    p.PH = KH - 1 - PH;
    p.K = KW / SW, p.S = 1, p.D = 1, p.P = KW / SW - 1;
    p.flip = 1, p.classes = SW, p.pad_t = PW;
  } else {
    p.K = KW, p.S = SW, p.D = 1, p.P = PW;
    p.flip = 0, p.classes = 1, p.pad_t = 0;
  }
  return convf::run<float>((const float*)x, (const float*)w, (const float*)bias, nullptr,
                           (float*)out, p, (cudaStream_t)stream);
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
