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
//
// Training (float32). wavenet_gate_train is the same kernel with the
// pre-activation z [B, T, 2R] written beside g (a template flag: serving's
// wavenet_gate runs the instance it always ran). The backward replaces
// XLA's derivative of the same ResidualBlock.__call__ and DilatedConvK3,
// given dx' and dskip', with do = [dx' / sqrt(2) | dskip']:
//
//   wavenet_gate_backward:  dg = do @ W_out^T,
//                           dz = [dg tanh(z_f) s (1 - s) | dg s (1 - tanh^2 z_f)],
//                           s = sigmoid(z_a)                   -> dz [B, T, 2R]
//   wavenet_input_backward: dy[t] = dz[t+d] W_l^T + dz[t] W_c^T + dz[t-d] W_r^T
//                           (zero outside [0, T)), dx = dx' / sqrt(2) + dy,
//                           and per tile of rows the column sums of dy,
//                           which the wrapper adds in a fixed order (ds[b])
//
// The weight gradients go through conv1d_wgrad (csrc/wgrad.cuh): dW_conv is
// conv1d_wgrad(y, dz, K = 3, dilation = d, padding = d), which is this
// file's packed [3R, 2R] layout, and dW_out one K = 1 call on g and do. Bound:
// arithmetic, as the forward (at B = 20, T = 512, R = 512 the two products
// are 10.7 and 32.2 GFLOP a block). Design: the forward's tiles, with both
// operands read along K. The A tile is gathered in the prologue: from dx'
// (scaled by 1 / sqrt(2)) and dskip' for the gate's backward, with no
// concatenated copy of do, and from dz at t + (1 - tap) d with a zero halo for the
// input's backward, so no shifted copy is written. The weights are read
// transposed, rows of W_out or of W_conv's tap blocks, 16-byte loads along
// K. A block's rows lie in one batch item (tiles of BM time steps), so its
// column sums of dy are one item's partial sum of ds; they are reduced over
// the block's threads in a fixed order in shared memory, with no atomics,
// so a rerun gives the same bits.

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
template <typename T, int MODE, int BM, int BNH, int TM, int TNH, bool SAVE_Z = false>
__global__ void __launch_bounds__(THREADS) block_gemm(
    const T* __restrict__ a_src,   // MODE 0: x [M, C]; MODE 1: g [M, R]
    const T* __restrict__ step,    // MODE 0: [B, C]
    const T* __restrict__ w,       // [K, 2R], row-major
    const T* __restrict__ bias,    // [2R]
    const T* __restrict__ cond,    // MODE 0: [M, 2R]
    const T* __restrict__ x_in,    // MODE 1: [M, R]
    const T* __restrict__ skip_in, // MODE 1: [M, R]
    T* __restrict__ out0,          // MODE 0: g [M, R]; MODE 1: x' [M, R]
    T* __restrict__ out1,          // MODE 1: skip' [M, R]; SAVE_Z: z [M, 2R]
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
        if constexpr (SAVE_Z) {
          out1[(size_t)m * 2 * R + col] = from_f<T>(z0);
          out1[(size_t)m * 2 * R + R + col] = from_f<T>(z1);
        }
        const float gate = 1.f / (1.f + expf(-z0));
        out0[o] = from_f<T>(gate * tanhf(z1));
      } else {
        out0[o] = from_f<T>((to_f(x_in[o]) + z0) * 0.70710678118654752f);
        out1[o] = from_f<T>(to_f(skip_in[o]) + z1);
      }
    }
  }
}

template <typename T, int MODE, int BM, int BNH, int TM, int TNH, bool SAVE_Z>
int launch_tile(const void* a_src, const void* step, const void* w,
                const void* bias, const void* cond, const void* x_in,
                const void* skip_in, void* out0, void* out1, int M,
                int T_len, int C, int R, int d, cudaStream_t stream) {
  const int K = MODE == 0 ? 3 * C : R;
  dim3 grid((M + BM - 1) / BM, R / BNH);
  block_gemm<T, MODE, BM, BNH, TM, TNH, SAVE_Z><<<grid, THREADS, 0, stream>>>(
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
template <typename T, int MODE, bool SAVE_Z = false>
int launch(const void* a_src, const void* step, const void* w,
           const void* bias, const void* cond, const void* x_in,
           const void* skip_in, void* out0, void* out1, int B, int T_len,
           int C, int R, int d, void* stream) {
  const int M = B * T_len;
  const int sms = sm_count();
  cudaStream_t s = (cudaStream_t)stream;
  if (((M + 127) / 128) * (R / 64) >= sms)
    return launch_tile<T, MODE, 128, 64, 8, 4, SAVE_Z>(a_src, step, w, bias, cond, x_in,
                                               skip_in, out0, out1, M, T_len,
                                               C, R, d, s);
  if (((M + 63) / 64) * (R / 32) >= sms)
    return launch_tile<T, MODE, 64, 32, 4, 2, SAVE_Z>(a_src, step, w, bias, cond, x_in,
                                              skip_in, out0, out1, M, T_len, C,
                                              R, d, s);
  return launch_tile<T, MODE, 32, 32, 2, 2, SAVE_Z>(a_src, step, w, bias, cond, x_in,
                                            skip_in, out0, out1, M, T_len, C,
                                            R, d, s);
}

// The backward's products, float32: C[m, n] = sum_k A[m, k] Bt[n, k] over
// the rows m of one batch item (a block takes BM consecutive time steps of
// item b = blockIdx.x / tiles) and N = R columns; both tiles are loaded
// along K (16-byte loads) and stored K-major in shared memory.
// MODE 0 (gate backward): A = [dx' / sqrt 2 | dskip'] (K = 2R), Bt = W_out
//   [R, 2R]; epilogue dz from z.
// MODE 1 (input backward): A[m, k] = dz[b, t + (1 - k / 2R) d, k % 2R]
//   (zero outside [0, T); K = 6R), Bt[n, tap * 2R + c] = W_conv[tap R + n, c];
//   epilogue dx = dx' / sqrt 2 + dy and the tile's column sums of dy.
// A thread owns TM rows (two runs of TM / 2, BM / 2 apart) x TN columns (two
// runs of TN / 2, BN / 2 apart), so its shared-memory reads are 16-byte
// runs on distinct banks across a quarter-warp.
template <int MODE, int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS) bwd_gemm(
    const float* __restrict__ a0,  // MODE 0: dx' [M, R]; MODE 1: dz [M, 2R]
    const float* __restrict__ a1,  // MODE 0: dskip' [M, R]; MODE 1: dx' [M, R]
    const float* __restrict__ w,   // MODE 0: W_out [R, 2R]; MODE 1: W_conv [3R, 2R]
    const float* __restrict__ z,   // MODE 0: z [M, 2R]
    float* __restrict__ out,       // MODE 0: dz [M, 2R]; MODE 1: dx [M, R]
    float* __restrict__ part,      // MODE 1: [B, tiles, R] column sums of dy
    int T_len, int R, int d, int tiles) {
  static_assert((BM / TM) * (BN / TN) == THREADS, "16 x 16 threads");
  constexpr int A_PER = BM * BK / THREADS;
  constexpr int B_PER = BN * BK / THREADS;
  constexpr float RSQRT2 = 0.70710678118654752f;
  const int K = MODE == 0 ? 2 * R : 6 * R;
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ float red[MODE == 1 ? THREADS / 16 : 1][MODE == 1 ? BN : 1];

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const int a_row = tid / (BK / A_PER);
  const int a_k = (tid % (BK / A_PER)) * A_PER;
  const int a_t = t0 + a_row;
  const bool a_ok = a_t < T_len;
  const int b_row = tid / (BK / B_PER);
  const int b_k = (tid % (BK / B_PER)) * B_PER;
  const int b_n = n0 + b_row;

  float a_next[A_PER], b_next[B_PER];
  auto fetch = [&](int k0) {
    const int k = k0 + a_k;
#pragma unroll
    for (int i = 0; i < A_PER; ++i) a_next[i] = 0.f;
    if (MODE == 0) {
      if (a_ok) {
        const size_t row = (size_t)b * T_len + a_t;
        if (k < R) {
          load_row<float, A_PER>(a0 + row * R + k, a_next);
#pragma unroll
          for (int i = 0; i < A_PER; ++i) a_next[i] *= RSQRT2;
        } else {
          load_row<float, A_PER>(a1 + row * R + (k - R), a_next);
        }
      }
      load_row<float, B_PER>(w + (size_t)b_n * (2 * R) + k0 + b_k, b_next);
    } else {
      const int tap = k0 / (2 * R);
      const int c0 = k0 - tap * 2 * R;
      const int ts = a_t + (1 - tap) * d;
      if (a_ok && ts >= 0 && ts < T_len)
        load_row<float, A_PER>(a0 + ((size_t)b * T_len + ts) * (2 * R) + c0 + a_k, a_next);
      load_row<float, B_PER>(w + ((size_t)tap * R + b_n) * (2 * R) + c0 + b_k, b_next);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[a_k + i][a_row] = a_next[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) Bs[b_k + i][b_row] = b_next[i];
    __syncthreads();
    if (k0 + BK < K) fetch(k0 + BK);

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
      load_smem<TM / 2>(&As[kk][ty * (TM / 2)], a);
      load_smem<TM / 2>(&As[kk][BM / 2 + ty * (TM / 2)], a + TM / 2);
      load_smem<TN / 2>(&Bs[kk][tx * (TN / 2)], bv);
      load_smem<TN / 2>(&Bs[kk][BN / 2 + tx * (TN / 2)], bv + TN / 2);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

  float colsum[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) colsum[j] = 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = i < TM / 2 ? ty * (TM / 2) + i
                               : BM / 2 + ty * (TM / 2) + (i - TM / 2);
    const int t = t0 + row;
    if (t >= T_len) continue;
    const size_t m = (size_t)b * T_len + t;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + (j < TN / 2 ? tx * (TN / 2) + j
                                     : BN / 2 + tx * (TN / 2) + (j - TN / 2));
      if (MODE == 0) {
        const float s = 1.f / (1.f + expf(-z[m * 2 * R + n]));
        const float tf = tanhf(z[m * 2 * R + R + n]);
        out[m * 2 * R + n] = acc[i][j] * tf * s * (1.f - s);
        out[m * 2 * R + R + n] = acc[i][j] * s * (1.f - tf * tf);
      } else {
        out[m * R + n] = a1[m * R + n] * RSQRT2 + acc[i][j];
        colsum[j] += acc[i][j];
      }
    }
  }
  if (MODE == 1) {
#pragma unroll
    for (int j = 0; j < TN; ++j)
      red[ty][j < TN / 2 ? tx * (TN / 2) + j : BN / 2 + tx * (TN / 2) + (j - TN / 2)] =
          colsum[j];
    __syncthreads();
    for (int c = tid; c < BN; c += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < THREADS / 16; ++r) sum += red[r][c];
      part[((size_t)b * tiles + (t0 / BM)) * R + n0 + c] = sum;
    }
  }
}

template <int MODE, int BM, int BN, int TM, int TN>
int launch_bwd_tile(const float* a0, const float* a1, const float* w, const float* z,
                    float* out, float* part, int B, int T_len, int R, int d,
                    cudaStream_t stream) {
  const int tiles = (T_len + BM - 1) / BM;
  dim3 grid(B * tiles, R / BN);
  bwd_gemm<MODE, BM, BN, TM, TN><<<grid, THREADS, 0, stream>>>(a0, a1, w, z, out, part,
                                                               T_len, R, d, tiles);
  return (int)cudaGetLastError();
}

// The backward's tile: 128 x 128 (8 x 8 a thread) when R allows it and the
// grid has a block for every SM, else 128 x 64 under the same rule, else
// 64 x 64. Returns BM (the rows of a tile, which size the partial sums).
int bwd_rows(int B, int T_len, int R, int& BN) {
  const int sms = sm_count();
  const int t128 = (T_len + 127) / 128;
  if (R % 128 == 0 && B * t128 * (R / 128) >= sms) { BN = 128; return 128; }
  if (B * t128 * (R / 64) >= sms) { BN = 64; return 128; }
  BN = 64;
  return 64;
}

template <int MODE>
int launch_bwd(const float* a0, const float* a1, const float* w, const float* z,
               float* out, float* part, int B, int T_len, int R, int d, void* stream) {
  int BN;
  const int BM = bwd_rows(B, T_len, R, BN);
  cudaStream_t s = (cudaStream_t)stream;
  if (BM == 128 && BN == 128)
    return launch_bwd_tile<MODE, 128, 128, 8, 8>(a0, a1, w, z, out, part, B, T_len, R, d, s);
  if (BM == 128)
    return launch_bwd_tile<MODE, 128, 64, 8, 4>(a0, a1, w, z, out, part, B, T_len, R, d, s);
  return launch_bwd_tile<MODE, 64, 64, 4, 4>(a0, a1, w, z, out, part, B, T_len, R, d, s);
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

// K1's training forward (float32): wavenet_gate that also writes the
// pre-activation z [B, T, 2R] (bias and conditioner added), which the
// backward reads.
extern "C" int wavenet_gate_train(const void* x, const void* step, const void* w_conv,
                                  const void* b_conv, const void* cond, void* g, void* z,
                                  int B, int T_len, int R, int d, void* stream) {
  return launch<float, 0, true>(x, step, w_conv, b_conv, cond, nullptr, nullptr, g, z, B,
                                T_len, R, R, d, stream);
}

// The rows of the backward's tiles for these shapes: ``part`` of
// wavenet_input_backward is [B, ceil(T / rows), R].
extern "C" int wavenet_backward_rows(int B, int T_len, int R) {
  int BN;
  return bwd_rows(B, T_len, R, BN);
}

// dz [B, T, 2R] from dx', dskip' [B, T, R], W_out [R, 2R] and z [B, T, 2R].
extern "C" int wavenet_gate_backward(const void* dx_out, const void* dskip_out,
                                     const void* w_out, const void* z, void* dz, int B,
                                     int T_len, int R, void* stream) {
  return launch_bwd<0>((const float*)dx_out, (const float*)dskip_out, (const float*)w_out,
                       (const float*)z, (float*)dz, nullptr, B, T_len, R, 0, stream);
}

// dx [B, T, R] and part [B, ceil(T / rows), R] (each tile's column sums of
// dy) from dz [B, T, 2R], dx' [B, T, R] and W_conv [3R, 2R].
extern "C" int wavenet_input_backward(const void* dz, const void* dx_out, const void* w_conv,
                                      void* dx, void* part, int B, int T_len, int R, int d,
                                      void* stream) {
  return launch_bwd<1>((const float*)dz, (const float*)dx_out, (const float*)w_conv,
                       nullptr, (float*)dx, (float*)part, B, T_len, R, d, stream);
}
