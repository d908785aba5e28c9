// K1: one WaveNet residual block as two tiled GEMM kernels with fused
// prologues and epilogues, channels-last [B, T, C].
//
// Replaces fish_diffusion_tpu/models/wavenet.py:ResidualBlock.__call__ with
// models/common.py:DilatedConvK3 (the k=3 dilated conv as three shifted
// matmuls), which the TPU package once ran as the Pallas kernel
// ops/pallas_wavenet.py:fused_residual_block (commit d064196).
//
//   wavenet_gate: y = x + step[b] (zero outside [0, T)),
//                 z = [y[t-d] | y[t] | y[t+d]] @ W_conv + b_conv + cond,
//                 g = sigmoid(z[:, :R]) * tanh(z[:, R:])            -> g [B, T, R]
//   wavenet_out:  o = g @ W_out + b_out,
//                 x' = (x + o[:, :R]) / sqrt(2), skip' = skip + o[:, R:]
//
// Bound on an H100: arithmetic. At B=4, T=1024, C=R=512 the two products
// are 12.9 and 4.3 GFLOP per block and read ~12 MB, far above the card's
// balance point. Design: shared-memory tiles with register blocking and
// float32 accumulation; the next stage is loaded into registers (16-byte
// loads) while the current one is multiplied. The three taps are one
// K = 3C product whose A tile is gathered from y at t + (tap - 1) * d with
// a zero-filled halo, so no shifted copy of y is ever written. Each thread
// owns matching gate and filter (or residual and skip) columns, so the
// gate and the residual update happen in registers and z never reaches
// device memory. A short request has few rows (M = B * T = 256 for one 3 s
// segment), so the tile shrinks with M until the launch has a thread block
// for every SM. The element type is a template: float32 (the configs) and
// bfloat16.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

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

constexpr int BK = 16;       // depth of one shared-memory stage
constexpr int THREADS = 256; // 16 x 16 threads

// N consecutive elements as floats; 16-byte loads where the type and the
// count allow (the wrapper guarantees 16-byte aligned tensors, and every
// row offset used below is a multiple of N).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&v)[N]) {
  if constexpr (std::is_same_v<T, float> && N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(p[i]);
  }
}

template <int N>
__device__ __forceinline__ void load_smem(const float* p, float* v) {
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = p[i];
  }
}

// A block computes BM rows (b, t) x BNH column pairs (BNH gate + BNH filter
// columns); each thread TM rows x (TNH + TNH) columns. K is a multiple of
// BK and C of the per-thread run, so a run never crosses a tap.
// MODE 0 (gate): A[m, k] = y[b, t + (k / C - 1) * d, k % C], K = 3C.
// MODE 1 (out):  A[m, k] = g[m, k], K = R.
template <typename T, int MODE, int BM, int BNH, int TM, int TNH>
__global__ void __launch_bounds__(THREADS) block_gemm(
    const T* __restrict__ a_src,   // MODE 0: x [M, C]; MODE 1: g [M, R]
    const T* __restrict__ step,    // MODE 0: [B, C]
    const T* __restrict__ w,       // [K, 2R], row-major
    const T* __restrict__ bias,    // [2R]
    const T* __restrict__ cond,    // MODE 0: [M, 2R]
    const T* __restrict__ x_in,    // MODE 1: [M, R]
    const T* __restrict__ skip_in, // MODE 1: [M, R]
    T* __restrict__ out0,          // MODE 0: g [M, R]; MODE 1: x' [M, R]
    T* __restrict__ out1,          // MODE 1: skip' [M, R]
    int M, int T_len, int C, int R, int K, int d) {
  static_assert((BM / TM) * (BNH / TNH) == THREADS, "16 x 16 threads");
  constexpr int A_PER = BM * BK / THREADS;       // A elements per thread
  constexpr int B_PER = 2 * BNH * BK / THREADS;  // B elements per thread
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][2 * BNH];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BNH;
  const int tx = tid % 16;
  const int ty = tid / 16;

  // A stage: each thread loads A_PER consecutive k of one row
  const int a_row = tid / (BK / A_PER);
  const int a_k = (tid % (BK / A_PER)) * A_PER;
  const int a_m = m0 + a_row;
  const bool a_ok = a_m < M;
  const int a_b = a_ok ? a_m / T_len : 0;
  const int a_t = a_ok ? a_m - a_b * T_len : 0;

  // B stage: each thread loads B_PER consecutive paired columns of one k
  const int b_k = tid / 16;
  const int b_n = (tid % 16) * B_PER;
  const int b_col = b_n < BNH ? j0 + b_n : R + j0 + (b_n - BNH);

  // the next stage, held in registers while the current one is multiplied
  float a_next[A_PER], b_next[B_PER];
  auto fetch = [&](int k0) {
    const int k = k0 + a_k;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) a_next[i] = 0.f;
    if (a_ok) {
      if (MODE == 0) {
        const int tap = k / C;
        const int c = k - tap * C;
        const int ts = a_t + (tap - 1) * d;
        if (ts >= 0 && ts < T_len) {
          float sv[A_PER];
          load_row<T, A_PER>(a_src + ((size_t)a_b * T_len + ts) * C + c, a_next);
          load_row<T, A_PER>(step + (size_t)a_b * C + c, sv);
#pragma unroll
          for (int i = 0; i < A_PER; ++i) a_next[i] += sv[i];
        }
      } else {
        load_row<T, A_PER>(a_src + (size_t)a_m * K + k, a_next);
      }
    }
    load_row<T, B_PER>(w + (size_t)(k0 + b_k) * (2 * R) + b_col, b_next);
  };

  float acc[TM][2 * TNH];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * TNH; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[a_k + i][a_row] = a_next[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) Bs[b_k][b_n + i] = b_next[i];
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[2 * TNH];
      load_smem<TM / 2>(&As[kk][ty * (TM / 2)], a);
      load_smem<TM / 2>(&As[kk][BM / 2 + ty * (TM / 2)], a + TM / 2);
      load_smem<TNH>(&Bs[kk][tx * TNH], bv);
      load_smem<TNH>(&Bs[kk][BNH + tx * TNH], bv + TNH);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 2 * TNH; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i < TM / 2 ? ty * (TM / 2) + i
                               : BM / 2 + ty * (TM / 2) + (i - TM / 2);
    const int m = m0 + row;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TNH; ++j) {
      const int col = j0 + tx * TNH + j;
      float z0 = acc[i][j] + to_f(bias[col]);
      float z1 = acc[i][TNH + j] + to_f(bias[R + col]);
      const size_t o = (size_t)m * R + col;
      if (MODE == 0) {
        z0 += to_f(cond[(size_t)m * 2 * R + col]);
        z1 += to_f(cond[(size_t)m * 2 * R + R + col]);
        const float gate = 1.f / (1.f + expf(-z0));
        out0[o] = from_f<T>(gate * tanhf(z1));
      } else {
        out0[o] = from_f<T>((to_f(x_in[o]) + z0) * 0.70710678118654752f);
        out1[o] = from_f<T>(to_f(skip_in[o]) + z1);
      }
    }
  }
}

template <typename T, int MODE, int BM, int BNH, int TM, int TNH>
int launch_tile(const void* a_src, const void* step, const void* w,
                const void* bias, const void* cond, const void* x_in,
                const void* skip_in, void* out0, void* out1, int M,
                int T_len, int C, int R, int d, cudaStream_t stream) {
  const int K = MODE == 0 ? 3 * C : R;
  dim3 grid((M + BM - 1) / BM, R / BNH);
  block_gemm<T, MODE, BM, BNH, TM, TNH><<<grid, THREADS, 0, stream>>>(
      (const T*)a_src, (const T*)step, (const T*)w, (const T*)bias,
      (const T*)cond, (const T*)x_in, (const T*)skip_in, (T*)out0, (T*)out1,
      M, T_len, C, R, K, d);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// The largest tile whose grid still has a block for every SM.
template <typename T, int MODE>
int launch(const void* a_src, const void* step, const void* w,
           const void* bias, const void* cond, const void* x_in,
           const void* skip_in, void* out0, void* out1, int B, int T_len,
           int C, int R, int d, void* stream) {
  const int M = B * T_len;
  const int sms = sm_count();
  cudaStream_t s = (cudaStream_t)stream;
  if (((M + 127) / 128) * (R / 64) >= sms)
    return launch_tile<T, MODE, 128, 64, 8, 4>(a_src, step, w, bias, cond, x_in,
                                               skip_in, out0, out1, M, T_len,
                                               C, R, d, s);
  if (((M + 63) / 64) * (R / 32) >= sms)
    return launch_tile<T, MODE, 64, 32, 4, 2>(a_src, step, w, bias, cond, x_in,
                                              skip_in, out0, out1, M, T_len, C,
                                              R, d, s);
  return launch_tile<T, MODE, 32, 32, 2, 2>(a_src, step, w, bias, cond, x_in,
                                            skip_in, out0, out1, M, T_len, C,
                                            R, d, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The Python wrapper checks R % 64 == 0
// and 16-byte aligned tensors. Returns the cudaError_t of the launch.
extern "C" int wavenet_gate(int dtype, const void* x, const void* step,
                            const void* w_conv, const void* b_conv,
                            const void* cond, void* g, int B, int T_len,
                            int C, int R, int d, void* stream) {
  if (dtype == 0)
    return launch<float, 0>(x, step, w_conv, b_conv, cond, nullptr, nullptr,
                            g, nullptr, B, T_len, C, R, d, stream);
  return launch<__nv_bfloat16, 0>(x, step, w_conv, b_conv, cond, nullptr,
                                  nullptr, g, nullptr, B, T_len, C, R, d,
                                  stream);
}

extern "C" int wavenet_out(int dtype, const void* g, const void* w_out,
                           const void* b_out, const void* x_in,
                           const void* skip_in, void* x_out, void* skip_out,
                           int B, int T_len, int R, void* stream) {
  if (dtype == 0)
    return launch<float, 1>(g, nullptr, w_out, b_out, nullptr, x_in, skip_in,
                            x_out, skip_out, B, T_len, R, R, 0, stream);
  return launch<__nv_bfloat16, 1>(g, nullptr, w_out, b_out, nullptr, x_in,
                                  skip_in, x_out, skip_out, B, T_len, R, R, 0,
                                  stream);
}
