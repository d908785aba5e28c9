// K4: the NSF-HiFiGAN and RefineGAN trunks' 1-D convolutions, channels-last
// [B, T, C].
//
// Replaces fish_diffusion_tpu/ops/blocked_conv.py:blocked_apply (with
// scatter_blocked_kernel), the space-to-depth GEMM that
// models/vocoders/nsf_hifigan.py:BlockedConv1d, ResBlock1 and
// NsfHifiGANGenerator.__call__ use to fill the TPU's 128-lane matrix unit at
// 16-64 channels. The blocked layout is not carried over.
//
//   conv1d_forward(transposed = 0): a direct convolution with stride,
//     dilation and symmetric zero padding,
//       out[b, t, o] = bias[o] + sum_{k, c} W[k, c, o] * act(x[b, t*s + k*d - p, c])
//   conv1d_forward(transposed = 1): torch ConvTranspose1d semantics,
//       out[b, t, o] = bias[o] + sum_{k, c : (t + p - k) % s == 0}
//                                W[k, c, o] * act(x[b, (t + p - k) / s, c])
//   act is leaky-relu(slope) when has_slope, else the identity; the
//   epilogue adds bias, an optional residual [B, T_out, C_out] and an
//   optional tanh. W is packed [K, C_in, C_out]. The wrappers also run the
//   convs' input gradients through it (a stride-1 conv's is a conv with
//   flipped taps and swapped channels, a strided conv's the transposed
//   mode, a transposed conv's a strided conv).
//
// Bound on an H100: float32 operations at the wide levels (C = 128-512;
// one NSF-HiFiGAN pass at B=4 x 1024 frames is ~2.6 TFLOP, 39 ms at 67
// TFLOP/s), memory and shared memory at the narrow ones (C = 16-32, up to
// 2.1 M positions a conv at B=4). The kernel is conv_fwd.cuh's (a staged
// input window and the chunk's weights for every tap through a cp.async
// ring, 8 positions x 8 output channels a thread, plans that fill the
// card, one fixed-order float32 sum per output); the transposed mode runs
// one output residue class per block as a stride-1 correlation over the
// class's K / s taps. dtype 1 (bfloat16, on no path of the port) runs the
// same kernel with its operands converted to float32 as they land.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): one NSF-HiFiGAN
// pass at B=4 x 1024 frames 90.6 ms, 45% of its float32 bound (conv_pre
// 0.14 ms; the levels at C = 256 / 128 / 64 / 32 / 16 18.4 / 36.4 / 18.8 /
// 10.3 / 6.7 ms, 30.5-21.0 TFLOP/s); the first version, a synchronous
// 8-channel staging with an 8 x 4 register tile, 117.5 ms; cuDNN's
// convolution alone 89.2, without the fused activation, residual and
// tanh. A training step's K4 launches (forward and input gradients):
// NSF-HiFiGAN's 203 48.1 ms (cuDNN alone 47.2), RefineGAN's 205 96.8 ms
// (88.1).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_fwd.cuh"

namespace {

template <typename T>
int conv1d(int transposed, const void* x, const void* w, const void* bias,
           const void* res, void* out, int B, int T_in, int T_out, int C_in,
           int C_out, int K, int stride, int dil, int pad, float slope,
           int has_slope, int do_tanh, cudaStream_t stream) {
  convf::Args p =
      convf::line_args(transposed, B, T_in, T_out, C_in, C_out, K, stride, dil, pad, 1);
  p.slope = slope, p.has_slope = has_slope, p.do_tanh = do_tanh;
  return convf::run<T>((const T*)x, (const T*)w, (const T*)bias, (const T*)res, (T*)out, p,
                       stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. res may be null. For transposed = 1 the
// Python wrapper guarantees K % stride == 0. Returns the cudaError_t.
extern "C" int conv1d_forward(int dtype, int transposed, const void* x,
                              const void* w, const void* bias,
                              const void* res, void* out, int B, int T_in,
                              int T_out, int C_in, int C_out, int K,
                              int stride, int dil, int pad, float slope,
                              int has_slope, int do_tanh, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return conv1d<float>(transposed, x, w, bias, res, out, B, T_in, T_out, C_in, C_out, K,
                         stride, dil, pad, slope, has_slope, do_tanh, s);
  return conv1d<__nv_bfloat16>(transposed, x, w, bias, res, out, B, T_in, T_out, C_in, C_out,
                               K, stride, dil, pad, slope, has_slope, do_tanh, s);
}
