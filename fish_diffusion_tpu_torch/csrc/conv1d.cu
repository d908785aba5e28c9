// K4: the NSF-HiFiGAN trunk's 1-D convolutions, channels-last [B, T, C].
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
//   optional tanh. W is packed [K, C_in, C_out].
//
// Bound on an H100: arithmetic at the wide levels (C = 128-512), shared
// memory and occupancy at the narrow ones (C = 16-32), where the output
// tile is only as wide as C_out. Design: one block per (time tile x
// out-channel tile). It stages the input window of the tile, halo included,
// and the weights of a chunk of 8 input channels in shared memory
// (activation applied once, as the window is loaded), and keeps an 8 x 4
// (time x channel) register tile per thread with float32 accumulation: 32
// FMAs for every 9 shared-memory loads. The tile's width follows C_out
// (64, 32, 16 or 1), and its length grows as it narrows, so that every
// block keeps 256 threads busy. The transposed conv runs one output
// residue class t = u * s + r - pad per block: its outputs all read the
// same K / u taps k = r + q * u, at input rows s - q, so it is a stride-1
// correlation with one weight load per tap and channel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr int THREADS = 256;

struct ConvArgs {
  int B, T_in, T_out, C_in, C_out, K, stride, dil, pad;
  float slope;
  int has_slope, do_tanh;
};

// Input rows a tile of BT outputs reads: the direct conv's window, or (for
// the transposed conv) BT residue-class rows plus the K / stride - 1 earlier
// rows the taps reach back to.
__host__ __device__ inline int window_rows(const ConvArgs& p, bool transposed,
                                           int BT) {
  return transposed ? BT + p.K / p.stride - 1
                    : (BT - 1) * p.stride + (p.K - 1) * p.dil + 1;
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

// BCI input channels per shared-memory stage: 8, or 1 for the
// single-channel noise convs.
template <typename T, int BT, int BCO, int TM, int TN, int BCI,
          bool TRANSPOSED>
__global__ void __launch_bounds__(THREADS) conv1d_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, const T* __restrict__ res,
    T* __restrict__ out, ConvArgs p) {
  extern __shared__ float smem[];
  constexpr int TX = BCO / TN;  // threads along out-channels
  constexpr int TY = BT / TM;   // threads along time
  constexpr int XS = BCI == 1 ? 1 : BCI + 1;  // window row stride; +1 spreads banks
  static_assert(TX * TY == THREADS, "tile must use all threads");

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int t0 = blockIdx.x * BT;  // first output row, or first s of the class
  const int o0 = blockIdx.y * BCO;
  const int b = TRANSPOSED ? blockIdx.z / p.stride : blockIdx.z;
  const int rr = TRANSPOSED ? blockIdx.z % p.stride : 0;
  const int taps = TRANSPOSED ? p.K / p.stride : p.K;

  const int lo = TRANSPOSED ? t0 - (taps - 1) : t0 * p.stride - p.pad;
  const int rows = window_rows(p, TRANSPOSED, BT);
  float* xs = smem;                               // [rows][XS]
  float* ws = smem + ((rows * XS + 3) & ~3);      // [taps][BCI][BCO]

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const T* xb = x + (size_t)b * p.T_in * p.C_in;

  for (int c0 = 0; c0 < p.C_in; c0 += BCI) {
    for (int idx = tid; idx < rows * BCI; idx += THREADS) {
      const int r = idx / BCI;
      const int c = idx % BCI;
      const int gr = lo + r;
      float v = 0.f;
      if (gr >= 0 && gr < p.T_in && c0 + c < p.C_in) {
        v = to_f(xb[(size_t)gr * p.C_in + c0 + c]);
        if (p.has_slope && v < 0.f) v *= p.slope;
      }
      xs[r * XS + c] = v;
    }
    for (int idx = tid; idx < taps * BCI * BCO; idx += THREADS) {
      const int o = idx % BCO;
      const int c = (idx / BCO) % BCI;
      const int q = idx / (BCO * BCI);
      const int k = TRANSPOSED ? rr + q * p.stride : q;
      float v = 0.f;
      if (c0 + c < p.C_in && o0 + o < p.C_out)
        v = to_f(w[((size_t)k * p.C_in + c0 + c) * p.C_out + o0 + o]);
      ws[idx] = v;
    }
    __syncthreads();

    for (int q = 0; q < taps; ++q) {
      // window row of output i for this tap, less the row of output 0
      const int roff = TRANSPOSED ? taps - 1 - q : q * p.dil;
      const int rstep = TRANSPOSED ? 1 : p.stride;
#pragma unroll
      for (int c = 0; c < BCI; ++c) {
        float bv[TN];
        load_smem<TN>(&ws[(q * BCI + c) * BCO + tx * TN], bv);
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

  T* ob = out + (size_t)b * p.T_out * p.C_out;
  const T* rb = res ? res + (size_t)b * p.T_out * p.C_out : nullptr;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = t0 + ty + i * TY;
    const int t = TRANSPOSED ? p.stride * s + rr - p.pad : s;
    if (t < 0 || t >= p.T_out) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o >= p.C_out) continue;
      const size_t idx = (size_t)t * p.C_out + o;
      float v = acc[i][j] + to_f(bias[o]);
      if (rb) v += to_f(rb[idx]);
      if (p.do_tanh) v = tanhf(v);
      ob[idx] = from_f<T>(v);
    }
  }
}

template <typename T, int BT, int BCO, int TM, int TN, int BCI,
          bool TRANSPOSED>
int launch_tile(const void* x, const void* w, const void* bias,
                const void* res, void* out, const ConvArgs& p,
                cudaStream_t stream) {
  constexpr int XS = BCI == 1 ? 1 : BCI + 1;
  const int rows = window_rows(p, TRANSPOSED, BT);
  const int taps = TRANSPOSED ? p.K / p.stride : p.K;
  const size_t smem =
      sizeof(float) * (((rows * XS + 3) & ~3) + taps * BCI * BCO);
  auto kernel = conv1d_kernel<T, BT, BCO, TM, TN, BCI, TRANSPOSED>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // the transposed conv: one grid row per residue class, s in [0, S)
  const int n = TRANSPOSED ? (p.T_out - 1 + p.pad) / p.stride + 1 : p.T_out;
  dim3 grid((n + BT - 1) / BT, (p.C_out + BCO - 1) / BCO,
            TRANSPOSED ? p.B * p.stride : p.B);
  kernel<<<grid, THREADS, smem, stream>>>((const T*)x, (const T*)w,
                                          (const T*)bias, (const T*)res,
                                          (T*)out, p);
  return (int)cudaGetLastError();
}

template <typename T, int BCI, bool TRANSPOSED>
int dispatch(const void* x, const void* w, const void* bias, const void* res,
             void* out, const ConvArgs& p, cudaStream_t stream) {
  if (p.C_out >= 64)
    return launch_tile<T, 128, 64, 8, 4, BCI, TRANSPOSED>(x, w, bias, res, out,
                                                          p, stream);
  if (p.C_out >= 32)
    return launch_tile<T, 256, 32, 8, 4, BCI, TRANSPOSED>(x, w, bias, res, out,
                                                          p, stream);
  if (p.C_out > 1)
    return launch_tile<T, 512, 16, 8, 4, BCI, TRANSPOSED>(x, w, bias, res, out,
                                                          p, stream);
  return launch_tile<T, 1024, 1, 4, 1, BCI, TRANSPOSED>(x, w, bias, res, out,
                                                        p, stream);
}

template <typename T>
int dispatch_conv(int transposed, const void* x, const void* w,
                  const void* bias, const void* res, void* out,
                  const ConvArgs& p, cudaStream_t stream) {
  if (transposed) return dispatch<T, 8, true>(x, w, bias, res, out, p, stream);
  if (p.C_in == 1)
    return dispatch<T, 1, false>(x, w, bias, res, out, p, stream);
  return dispatch<T, 8, false>(x, w, bias, res, out, p, stream);
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
  ConvArgs p{B,    T_in, T_out, C_in,  C_out,     K,      stride,
             dil,  pad,  slope, has_slope, do_tanh};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_conv<float>(transposed, x, w, bias, res, out, p, s);
  return dispatch_conv<__nv_bfloat16>(transposed, x, w, bias, res, out, p, s);
}
