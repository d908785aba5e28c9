// K6: the multi-scale discriminator's grouped 1-D convolutions (k = 41),
// channels-last [B, T, C], and their input gradient.
//
// Replaces fish_diffusion_tpu/ops/blocked_conv.py:blocked_apply_grouped,
// which folded s_in time steps into each group's channels so that the
// per-group contraction (C_in / groups = 8-64) filled the TPU's 128-lane
// matrix unit. The fold is not carried over: this is the plain grouped conv
// the fold computed, on MultiScaleDiscriminator layers 1, 2 and 5
// (models/discriminators.py:258).
//
//   grouped_conv1d(transposed = 0), stride s, padding p, group g = o / CO_g:
//     out[b, t, o] = bias[o] + sum_{k, i < CI_g} W[k, i, o] * x[b, t*s + k - p, g*CI_g + i]
//   grouped_conv1d(transposed = 1), torch conv_transpose1d semantics:
//     out[b, t, o] = bias[o] + sum_{k, i : (t + p - k) % s == 0}
//                              W[k, i, o] * x[b, (t + p - k) / s, g*CI_g + i]
//   W is packed [K, CI_g, C_out]; bias may be null. The transposed mode is
//   the conv's input gradient (x = the output's gradient, W re-packed by
//   the wrapper, K padded with zero taps to a multiple of the stride).
//
// Bound on an H100: float32 operations (layer 1 of scale 0 alone is 88
// GFLOP at B = 16 x 32768 samples; a train step's 63 launches over the
// three scales ~0.80 TFLOP, 12 ms at 67 TFLOP/s). The kernel is
// conv_fwd.cuh's, the one K4 and K6 2-D run, with the group as an offset:
// a block's output-channel tile lies in one group (BO divides CO_g: 8 to
// 64 channels, a single output-channel lane at CO_g = 8), and its chunks
// walk only that group's CI_g input channels. The block stages its tile's
// input window, halo included, and the chunk's weights for all 41 taps
// (21 a residue class in the stride-2 transposed mode) through a ring of
// cp.async stages; a thread keeps 8 positions x 8 output channels, or
// 4 x 4 where the plan's time model finds the problem too small for it.
// Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): a train step's 63
// launches 65.78 ms, 43% of their float32 bound (the first version, a
// synchronous 8-channel staging with an 8 x 4 register tile, 72.08 ms;
// cuDNN's grouped conv and conv1d_input 165.9); scale 0's forward and
// input gradient of the three layers 9.40 ms (10.80).

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "conv_fwd.cuh"

// x [B, T_in, C_in], w [K, C_in / groups, C_out], bias [C_out] or null,
// out [B, T_out, C_out], float32 and contiguous. The Python wrapper
// guarantees C_in / groups and C_out / groups multiples of 8 and, for
// transposed = 1, K % stride == 0. Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for groups that do not split the channels so).
extern "C" int grouped_conv1d(int transposed, const void* x, const void* w,
                              const void* bias, void* out, int B, int T_in,
                              int T_out, int C_in, int C_out, int K,
                              int stride, int pad, int groups, void* stream) {
  if (transposed && K % stride) return (int)cudaErrorInvalidValue;
  const convf::Args p =
      convf::line_args(transposed, B, T_in, T_out, C_in, C_out, K, stride, 1, pad, groups);
  return convf::run<float>((const float*)x, (const float*)w, (const float*)bias, nullptr,
                           (float*)out, p, (cudaStream_t)stream);
}
