// The weight gradient of the port's 1-D convolutions: K4 (the NSF-HiFiGAN
// and RefineGAN generators' direct and transposed convs) and K6 (the MSD's
// grouped convs).
//
// Replaces what XLA derives on the TPU for the weight of
// fish_diffusion_tpu/ops/blocked_conv.py:blocked_apply (K4) and
// blocked_apply_grouped (K6): the autodiff of their blocked GEMMs.
//
//   dW[k, i, j] = sum_{b, t < T_b} act_a(A[b, t * s + k * d - p, g * CA_g + i])
//                                * act_b(Bm[b, t, g * CB_g + j])
//
// for group g = j / CB_g, out [K, CA_g, CB] (the packed weight layout of
// K4 and K6), positions of A outside [0, T_a) read as 0. act is
// leaky-relu(slope) where its flag is set, else the identity. A direct
// conv's weight gradient takes A = its input x and Bm = the output's
// gradient dy; a transposed conv's takes A = dy (gathered with the conv's
// stride and padding) and Bm = x, which gives [K, C_out, C_in].
//
// Bound on an H100: float32 operations (2 * B * T_b * K * CA_g * CB FLOP;
// 88 GFLOP for the MSD's k = 41, 128 -> 128 layer at 16 x 32768 samples)
// over the SIMT units' 67 TFLOP/s. The design is wgrad.cuh's, with one
// spatial axis: a block stages the window of A that a strip of 32-64
// positions reads for its taps (stride and dilation in the offsets, the
// activation applied as it lands) and the strip of Bm, through a ring of
// cp.async stages; a thread keeps 3 or 2 taps x 4 input channels x 8
// output channels in registers; groups are tiles of their own. Measured
// (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): the NSF-HiFiGAN step's 8
// tracked shapes 5.98 ms, 52% of the bound (the first version, an im2col
// row gathered from global memory for every tap, 16.09; cuDNN 13.21), C =
// 16 at 0.145 ms (cuDNN 0.300); the weight gradients of a generator
// backward 24.2 ms for NSF-HiFiGAN's 102 (cuDNN 45.3), 47.6 for
// RefineGAN's 104 (cuDNN 119.8).

#include <cuda_runtime.h>

#include "wgrad.cuh"

namespace {

wgrad::Args args_1d(int B, int T_a, int T_b, int CA, int CB, int K, int stride,
                    int dil, int pad, int groups, float slope_a, int act_a,
                    float slope_b, int act_b) {
  return wgrad::Args{B,   1,      1,       1,       1,     0,     T_a,
                     T_b, CA,     CB,      K,       stride, dil,  pad,
                     groups, slope_a, slope_b, act_a, act_b};
}

}  // namespace

// The number of reduction chunks conv1d_wgrad plans for these shapes
// (enough blocks to fill the card once); the wrapper sizes the partial
// buffer [splits, K, CA / groups, CB] from it. Negative: a CUDA error.
extern "C" int conv1d_wgrad_splits(int B, int T_a, int T_b, int CA, int CB,
                                   int K, int stride, int dil, int pad,
                                   int groups) {
  return wgrad::splits_for(args_1d(B, T_a, T_b, CA, CB, K, stride, dil, pad,
                                   groups, 0.f, 0, 0.f, 0));
}

// a [B, T_a, CA], bm [B, T_b, CB], part [splits, K, CA / groups, CB]
// (scratch; any splits >= 1), out [K, CA / groups, CB]; float32,
// contiguous (the Python wrapper checks). Returns the cudaError_t of the
// launches.
extern "C" int conv1d_wgrad(const void* a, const void* bm, void* part,
                            void* out, int B, int T_a, int T_b, int CA,
                            int CB, int K, int stride, int dil, int pad,
                            int groups, float slope_a, int act_a,
                            float slope_b, int act_b, int splits,
                            void* stream) {
  return wgrad::run((const float*)a, (const float*)bm, (float*)part,
                    (float*)out,
                    args_1d(B, T_a, T_b, CA, CB, K, stride, dil, pad, groups,
                            slope_a, act_a, slope_b, act_b),
                    splits, (cudaStream_t)stream);
}
