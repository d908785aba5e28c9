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
// Bound on an H100: arithmetic (layer 1 of scale 0 alone is 88 GFLOP at
// B = 16 x 32768 samples). Design: K4's (csrc/conv1d.cu). One block per
// (time tile x out-channel tile x batch row); an out-channel tile lies in
// one group, so the block stages the input window of its time tile, halo
// included, for 8 of its group's input channels at a time, and those
// channels' 41 taps, in shared memory, and keeps an 8 x 4 (time x channel)
// register tile per thread with float32 accumulation. The tile's width
// follows the group's output width (64, 32, 16 or 8), its length grows as
// it narrows, so every block keeps 256 threads busy. The transposed mode
// runs one output residue class per block, as K4's transposed conv does.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BCI = 8;       // input channels per shared-memory stage
constexpr int XS = BCI + 1;  // window row stride; +1 spreads banks

struct GConvArgs {
  int B, T_in, T_out, C_in, C_out, K, stride, pad, groups;
};

__host__ __device__ inline int window_rows(const GConvArgs& p, bool transposed,
                                           int BT) {
  return transposed ? BT + p.K / p.stride - 1 : (BT - 1) * p.stride + p.K;
}

template <int BT, int BCO, int TM, int TN, bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS) grouped_conv1d_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, GConvArgs p) {
  extern __shared__ float smem[];
  constexpr int TX = BCO / TN;  // threads along out-channels
  constexpr int TY = BT / TM;   // threads along time
  static_assert(TX * TY == THREADS, "tile must use all threads");

  const int CI_g = p.C_in / p.groups;
  const int CO_g = p.C_out / p.groups;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * BT;  // first output row, or first u of the class
  const int o0 = blockIdx.y * BCO;
  const int g = o0 / CO_g;
  const int b = TRANSPOSED ? blockIdx.z / p.stride : blockIdx.z;
  const int rr = TRANSPOSED ? blockIdx.z % p.stride : 0;
  const int taps = TRANSPOSED ? p.K / p.stride : p.K;

  const int lo = TRANSPOSED ? t0 - (taps - 1) : t0 * p.stride - p.pad;
  const int rows = window_rows(p, TRANSPOSED, BT);
  float* xs = smem;                           // [rows][XS]
  float* ws = smem + ((rows * XS + 3) & ~3);  // [taps][BCI][BCO]

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const float* xb = x + (size_t)b * p.T_in * p.C_in + (size_t)g * CI_g;

  for (int c0 = 0; c0 < CI_g; c0 += BCI) {
    for (int idx = tid; idx < rows * BCI; idx += THREADS) {
      const int r = idx / BCI;
      const int c = idx % BCI;
      const int gr = lo + r;
      xs[r * XS + c] = (gr >= 0 && gr < p.T_in && c0 + c < CI_g)
                           ? xb[(size_t)gr * p.C_in + c0 + c]
                           : 0.f;
    }
    for (int idx = tid; idx < taps * BCI * BCO; idx += THREADS) {
      const int o = idx % BCO;
      const int c = (idx / BCO) % BCI;
      const int q = idx / (BCO * BCI);
      const int k = TRANSPOSED ? rr + q * p.stride : q;
      ws[idx] = (c0 + c < CI_g)
                    ? w[((size_t)k * CI_g + c0 + c) * p.C_out + o0 + o]
                    : 0.f;
    }
    __syncthreads();

    for (int q = 0; q < taps; ++q) {
      // window row of output i for this tap, less the row of output 0
      const int roff = TRANSPOSED ? taps - 1 - q : q;
      const int rstep = TRANSPOSED ? 1 : p.stride;
#pragma unroll
      for (int c = 0; c < BCI; ++c) {
        float bv[TN];
        const float4 f4 =
            *reinterpret_cast<const float4*>(&ws[(q * BCI + c) * BCO + tx * TN]);
        bv[0] = f4.x; bv[1] = f4.y; bv[2] = f4.z; bv[3] = f4.w;
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = xs[((ty + i * TY) * rstep + roff) * XS + c];
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += a * bv[j];
        }
      }
    }
    __syncthreads();
  }

  float* ob = out + (size_t)b * p.T_out * p.C_out;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = t0 + ty + i * TY;
    const int t = TRANSPOSED ? p.stride * s + rr - p.pad : s;
    if (t < 0 || t >= p.T_out) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      ob[(size_t)t * p.C_out + o] = acc[i][j] + (bias ? bias[o] : 0.f);
    }
  }
}

template <int BT, int BCO, bool TRANSPOSED>
int launch_tile(const float* x, const float* w, const float* bias, float* out,
                const GConvArgs& p, cudaStream_t stream) {
  constexpr int TM = 8, TN = 4;
  const int rows = window_rows(p, TRANSPOSED, BT);
  const int taps = TRANSPOSED ? p.K / p.stride : p.K;
  const size_t smem = sizeof(float) * (((rows * XS + 3) & ~3) + taps * BCI * BCO);
  auto kernel = grouped_conv1d_kernel<BT, BCO, TM, TN, TRANSPOSED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // the transposed conv: one grid row per residue class, u in [0, n)
  const int n = TRANSPOSED ? (p.T_out - 1 + p.pad) / p.stride + 1 : p.T_out;
  dim3 grid((n + BT - 1) / BT, p.C_out / BCO,
            TRANSPOSED ? p.B * p.stride : p.B);
  kernel<<<grid, THREADS, smem, stream>>>(x, w, bias, out, p);
  return (int)cudaGetLastError();
}

template <bool TRANSPOSED>
int dispatch(const float* x, const float* w, const float* bias, float* out,
             const GConvArgs& p, cudaStream_t stream) {
  const int co_g = p.C_out / p.groups;
  if (co_g % 64 == 0)
    return launch_tile<128, 64, TRANSPOSED>(x, w, bias, out, p, stream);
  if (co_g % 32 == 0)
    return launch_tile<256, 32, TRANSPOSED>(x, w, bias, out, p, stream);
  if (co_g % 16 == 0)
    return launch_tile<512, 16, TRANSPOSED>(x, w, bias, out, p, stream);
  return launch_tile<1024, 8, TRANSPOSED>(x, w, bias, out, p, stream);
}

}  // namespace

// x [B, T_in, C_in], w [K, C_in / groups, C_out], bias [C_out] or null,
// out [B, T_out, C_out], float32 and contiguous. The Python wrapper
// guarantees C_in / groups and C_out / groups multiples of 8 and, for
// transposed = 1, K % stride == 0. Returns the cudaError_t of the launch.
extern "C" int grouped_conv1d(int transposed, const void* x, const void* w,
                              const void* bias, void* out, int B, int T_in,
                              int T_out, int C_in, int C_out, int K,
                              int stride, int pad, int groups, void* stream) {
  GConvArgs p{B, T_in, T_out, C_in, C_out, K, stride, pad, groups};
  const float* xp = (const float*)x;
  const float* wp = (const float*)w;
  const float* bp = (const float*)bias;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (transposed) return dispatch<true>(xp, wp, bp, op, p, s);
  return dispatch<false>(xp, wp, bp, op, p, s);
}
