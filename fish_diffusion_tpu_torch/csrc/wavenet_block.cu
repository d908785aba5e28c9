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
// balance point. The three taps are one K = 3C product whose A tile is
// gathered from y at t + (tap - 1) * d with a zero-filled halo, so no
// shifted copy of y is ever written. Each thread owns matching gate and
// filter (or residual and skip) columns, so the gate and the residual
// update happen in registers and z never reaches device memory. float32
// (the configs) runs on the tensor cores through 3xTF32 wgmma (the k1f
// namespace below: the weights split once by the wrapper, each A element
// split once by the block that loads it; two tile plans chosen from M =
// B * T, which is 256 for one 3 s segment). bfloat16 runs block_gemm, a
// SIMT kernel: shared-memory tiles with register blocking and float32
// accumulation, the next stage loaded into registers while the current one
// is multiplied, its tile shrunk with M until the launch has a block for
// every SM (no config selects bfloat16).
//
// Training (float32). wavenet_gate_train is the same kernel with the
// pre-activation z [B, T, 2R] written beside g (a template flag: the same
// plan and products as serving's wavenet_gate). The backward replaces
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
//   wavenet_weight_grad:    dW_conv[tap R + i, n] = sum_{b,t} y[b, t + (tap - 1) d, i] dz[b, t, n]
//                           (y = x + step[b], zero outside [0, T)) and
//                           dW_out = g^T do, both in one launch
//
// Bound: arithmetic, as the forward (at B = 20, T = 512, R = 512 the gate
// backward's product is 10.7 GFLOP a block, the input backward's 32.2,
// dW_conv 32.2 and dW_out 10.7). The gate backward runs on the forward's
// 3xTF32 wgmma core (the k1f namespace: the same stage loop, ``products``),
// its A tile gathered stage by stage from dx' (scaled by 1 / sqrt(2) in
// registers) and dskip', with no concatenated copy of do, and W_out split
// once a prepare() call as stored (it is K-major for dg = do W_out^T); its
// epilogue reads z and writes dz as float2 pairs. The weights' splits are
// one launch a prepare() call (the wsplit namespace). The input backward
// and the weight gradients run on the 3xTF32 mma.sync core (tf32x3.cuh,
// the k1x3 namespace below): the input backward gathers its A tile from dz
// at t + (1 - tap) d with a zero halo, so no shifted copy is written; a
// block's rows lie in one batch item, so its column sums of dy are one
// item's partial sum of ds, reduced over the block in a fixed order in
// shared memory. The weight gradients gather y at t + (tap - 1) d and do
// from dx' and dskip' the same way, split the B T rows into chunks (128
// output tiles of the two products are fewer than the card's SMs) and add
// the chunks' partial tiles in chunk order. No atomics anywhere, so a rerun
// gives the same bits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "async_copy.cuh"
#include "tf32x3.cuh"

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

// The largest tile whose grid still has a block for every SM.
template <typename T, int MODE>
int launch(const void* a_src, const void* step, const void* w,
           const void* bias, const void* cond, const void* x_in,
           const void* skip_in, void* out0, void* out1, int B, int T_len,
           int C, int R, int d, void* stream) {
  const int M = B * T_len;
  const int sms = acopy::sm_count();
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

// K1's input backward and weight gradients on the 3xTF32 tensor-core core
// (tf32x3.cuh). Both are 128 x 128 output tiles over 8 warps (2 x 4, a
// warp 64 x 32: 4 x 4 m16n8k8 products a step), fed by a ring of STAGES
// shared-memory stages of TK reduction steps each, filled by 16-byte
// cp.async copies (zeros outside the operands, so halos and ragged edges
// need no branch in the products). 110 KB (input backward) and 104 KB
// (weight gradient) of shared memory and at most 128 registers a thread
// keep two blocks on an SM.
namespace k1x3 {

constexpr int TM = 128, TN = 128, TK = 32, STAGES = 3;
constexpr int WARPS_N = 4;            // warps along N; 2 along M
constexpr int MI = 4, NJ = 4;         // m16 x n8 products of a warp's tile
constexpr int WM = 16 * MI, WN = 8 * NJ;
constexpr int LDK = TK + 4;           // K-major tiles: rows of TK + 4
constexpr int LDR = TM + 8;           // reduction-major tiles: rows of TM + 8
constexpr float RSQRT2 = 0.70710678118654752f;
constexpr int IB_SMEM = STAGES * (TM + TN) * LDK * 4;
constexpr int WG_SMEM = STAGES * TK * 2 * LDR * 4;
static_assert((TM / WM) * (TN / WN) * 32 == THREADS, "8 warps");

// The input backward: dy = A W' over M = B T rows (a block takes TM time
// steps of item b = blockIdx.x / tiles) and N = R columns, K = 6R, with
// A[m, k] = dz[b, t + (1 - tap) d, c] (zero outside [0, T)) and W'[k, n] =
// W_conv[tap R + n, c], k = tap 2R + c; both tiles K-major, rows of LDK
// floats (tf32x3.cuh's K-major layout: ldmatrix, conflict-free). Epilogue: dx = dx' / sqrt 2 + dy, and the tile's column sums of dy
// (the lanes' rows, then the 16 rows of partials in order through shared
// memory) as part[b, tile, n].
__global__ void __launch_bounds__(THREADS, 2) input_backward_kernel(
    const float* __restrict__ dz,      // [B, T, 2R]
    const float* __restrict__ dx_out,  // [B, T, R]
    const float* __restrict__ w,       // W_conv [3R, 2R]
    float* __restrict__ dx,            // [B, T, R]
    float* __restrict__ part,          // [B, tiles, R]
    int T_len, int R, int d, int tiles) {
  extern __shared__ __align__(16) float k1x3_smem[];
  float* As = k1x3_smem;                       // [STAGES][TM][LDK]
  float* Bs = k1x3_smem + STAGES * TM * LDK;   // [STAGES][TN][LDK]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x - b * tiles;
  const int t0 = tile * TM;
  const int n0 = blockIdx.y * TN;
  const int two_r = 2 * R;
  const int nk = 6 * R / TK;
  // this thread's copies: rows cr + 32 i of both tiles, 4 floats at cc
  const int cr = tid >> 3, cc = (tid & 7) * 4;

  auto load = [&](int slot, int kt) {
    const int k0 = kt * TK;
    const int tap = k0 / two_r;
    const int c = k0 - tap * two_r + cc;
    float* as = As + slot * TM * LDK;
    float* bs = Bs + slot * TN * LDK;
#pragma unroll
    for (int i = 0; i < TM / 32; ++i) {
      const int r = cr + 32 * i;
      const int t = t0 + r, ts = t + (1 - tap) * d;
      const bool ok = t < T_len && ts >= 0 && ts < T_len;
      acopy::copy16(as + r * LDK + cc, ok ? dz + ((size_t)b * T_len + ts) * two_r + c : dz, ok);
      const int n = n0 + r;
      acopy::copy16(bs + r * LDK + cc, n < R ? w + ((size_t)tap * R + n) * two_r + c : w,
                    n < R);
    }
  };

  float acc[MI][NJ][4] = {};
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    acopy::copy_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    acopy::copy_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    acopy::copy_commit();
    const int slot = kt % STAGES;
    tf32x3::warp_stage_kmajor<MI, NJ, TK, LDK>(acc, As + (slot * TM + wm) * LDK,
                                               Bs + (slot * TN + wn) * LDK, lane);
  }
  acopy::copy_wait<0>();
  __syncthreads();

  const int g = lane >> 2, c = lane & 3;
  float colsum[NJ][2] = {};
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm + i * 16 + g + 8 * h;
      if (t >= T_len) continue;
      const size_t m = (size_t)b * T_len + t;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = n0 + wn + j * 8 + 2 * c;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        colsum[j][0] += v0;
        colsum[j][1] += v1;
        if (n < R) {
          const float2 o = *reinterpret_cast<const float2*>(dx_out + m * R + n);
          *reinterpret_cast<float2*>(dx + m * R + n) =
              make_float2(o.x * RSQRT2 + v0, o.y * RSQRT2 + v1);
        }
      }
    }
  // the column sums: [2 x 8 (warp row, g)][TN] partials, added in order
  float* red = k1x3_smem;
  const int rrow = (warp / WARPS_N) * 8 + g;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) red[rrow * TN + wn + j * 8 + 2 * c + h] = colsum[j][h];
  __syncthreads();
  if (tid < TN && n0 + tid < R) {
    float sum = 0.f;
    for (int r = 0; r < (TM / WM) * 8; ++r) sum += red[r * TN + tid];
    part[((size_t)b * tiles + tile) * R + n0 + tid] = sum;
  }
}

// The weight gradients, one launch for both products, over the B T rows
// (the reduction), cut into chunks of rows_per rows (a multiple of TK;
// blockIdx.y is the chunk):
//   conv tiles: dW_conv[tap R + i, n] = sum_rows y[b, t + (tap - 1) d, i] dz[b, t, n]
//               (y zero outside [0, T)), M = 3R, N = 2R;
//   out tiles:  dW_out[i, n] = sum_rows g[b, t, i] do[b, t, n], M = R, N = 2R,
//               do = [dx' / sqrt 2 | dskip'] gathered from dx' and dskip'
//               (the 1 / sqrt 2 applied to the partial sums).
// Every operand is [rows, C], so both tiles are reduction-major: TK rows of
// LDR floats (tf32x3.cuh's reduction-major layout: a warp's m16 tiles read
// with their rows interleaved, its n8 tile pairs with their columns
// interleaved, which the epilogue undoes). A row's time step advances with
// the chunk, so a chunk may cross batch items. Each block writes its
// partial tile, part[chunk, row, n] (rows 0..3R-1 dW_conv, 3R..4R-1
// dW_out); weight_grad_sum adds the chunks in order.
__global__ void __launch_bounds__(THREADS, 2) weight_grad_kernel(
    const float* __restrict__ y,          // x + step[b], [B, T, R]
    const float* __restrict__ dz,         // [B, T, 2R]
    const float* __restrict__ g_act,      // g [B, T, R]
    const float* __restrict__ dx_out,     // [B, T, R]
    const float* __restrict__ dskip_out,  // [B, T, R]
    float* __restrict__ part,             // [chunks, 4R, 2R]
    int M, int T_len, int R, int d, int conv_tiles, int tiles_n, int rows_per) {
  extern __shared__ __align__(16) float k1x3_smem[];
  float* As = k1x3_smem;                     // [STAGES][TK][LDR]
  float* Bs = k1x3_smem + STAGES * TK * LDR; // [STAGES][TK][LDR]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool out = (int)blockIdx.x >= conv_tiles;
  const int tile = out ? blockIdx.x - conv_tiles : blockIdx.x;
  const int m0 = (tile / tiles_n) * TM, n0 = (tile % tiles_n) * TN;
  const int rows_m = out ? R : 3 * R;
  const int two_r = 2 * R;
  const int r0 = blockIdx.y * rows_per;
  const int r1 = r0 + rows_per < M ? r0 + rows_per : M;
  const int nk = r1 > r0 ? (r1 - r0 + TK - 1) / TK : 0;

  // this thread's copies: reduction rows kr + 8 i of both tiles, 4 floats at
  // column cc, from a_src and b_src a row apart by R and b_stride floats; a
  // conv tile's A row is the row shifted by (tap - 1) d, live where the
  // row's time step t does not leave [0, T) (t advances with the stage)
  const int kr = tid >> 5, cc = (tid & 31) * 4;
  const int m = m0 + cc, n = n0 + cc;
  const int tap = out ? 1 : m / R;
  const int shift = (tap - 1) * d;
  const bool m_ok = m < rows_m, n_ok = n < two_r;
  const float* a_src = out ? g_act + m : y + (m - tap * R);
  const float* b_src = !out ? dz + n : n < R ? dx_out + n : dskip_out + (n - R);
  const int b_stride = out ? R : two_r;
  const int tk_mod = TK % T_len;
  int t_of[TK / 8];
#pragma unroll
  for (int i = 0; i < TK / 8; ++i) t_of[i] = (r0 + kr + 8 * i) % T_len;

  auto load = [&](int slot, int kt) {
    float* as = As + slot * TK * LDR;
    float* bs = Bs + slot * TK * LDR;
#pragma unroll
    for (int i = 0; i < TK / 8; ++i) {
      const int r = kr + 8 * i;
      const int row = r0 + kt * TK + r;
      const int ts = t_of[i] + shift;
      const bool row_ok = row < r1;
      const bool a_ok = row_ok && m_ok && ts >= 0 && ts < T_len;
      acopy::copy16(as + r * LDR + cc, a_ok ? a_src + (size_t)(row + shift) * R : y, a_ok);
      const bool b_ok = row_ok && n_ok;
      acopy::copy16(bs + r * LDR + cc, b_ok ? b_src + (size_t)row * b_stride : dz, b_ok);
      t_of[i] += tk_mod;
      if (t_of[i] >= T_len) t_of[i] -= T_len;
    }
  };

  float acc[MI][NJ][4] = {};
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    acopy::copy_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    acopy::copy_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    acopy::copy_commit();
    const int slot = kt % STAGES;
    tf32x3::warp_stage_rmajor<MI, NJ, TK, LDR>(acc, As + slot * TK * LDR + wm,
                                               Bs + slot * TK * LDR + wn, lane);
  }
  acopy::copy_wait<0>();

  // the interleave undone: acc[i][j][e] is row 16 i + 2 g + e / 2 and,
  // for the n8 tile pair p = j / 2, column 16 p + 4 c + 2 (e % 2) + j % 2,
  // so tiles 2p and 2p + 1 give a column pair
  const int g = lane >> 2, c = lane & 3;
  const size_t base = ((size_t)blockIdx.y * 4 * R + (out ? 3 * R : 0)) * two_r;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mr = m0 + wm + i * 16 + 2 * g + h;
      if (mr >= rows_m) continue;
#pragma unroll
      for (int j = 0; j < NJ; j += 2)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int nc = n0 + wn + 8 * j + 4 * c + 2 * q;
          if (nc >= two_r) continue;
          const float scale = out && nc < R ? RSQRT2 : 1.f;
          *reinterpret_cast<float2*>(part + base + (size_t)mr * two_r + nc) = make_float2(
              acc[i][j][2 * h + q] * scale, acc[i][j + 1][2 * h + q] * scale);
        }
    }
}

// dW_conv and dW_out: the chunks' partials added in chunk order, 4 floats a
// thread.
__global__ void __launch_bounds__(THREADS) weight_grad_sum(
    const float* __restrict__ part, float* __restrict__ dw_conv, float* __restrict__ dw_out,
    int R, int chunks) {
  const size_t per_chunk = (size_t)8 * R * R, conv = (size_t)6 * R * R;
  const size_t q = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (q >= per_chunk) return;
  float4 sum = *reinterpret_cast<const float4*>(part + q);
  for (int s = 1; s < chunks; ++s) {
    const float4 v = *reinterpret_cast<const float4*>(part + s * per_chunk + q);
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  }
  *reinterpret_cast<float4*>(q < conv ? dw_conv + q : dw_out + (q - conv)) = sum;
}

using acopy::cdiv;

// The shared-memory limit, set before every launch (as wgrad.cuh does: a
// plan over 48 KB set once ran up to 14% slower on an H100).
template <class K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

int weight_grad_tiles(int R, int& conv_tiles, int& tiles_n) {
  tiles_n = cdiv(2 * R, TN);
  conv_tiles = cdiv(3 * R, TM) * tiles_n;
  return conv_tiles + cdiv(R, TM) * tiles_n;
}

// The chunks of the weight gradient's reduction: as many as fill the card
// once with the tiles of both products (two blocks an SM: 2 chunks of 5120
// rows at B = 20, T = 512, R = 512, 256 blocks on 132 SMs), at least one
// stage of rows each.
int weight_grad_chunks(int B, int T_len, int R) {
  static int per_sm = 0;
  if (per_sm == 0) {
    int err = set_smem(weight_grad_kernel, WG_SMEM);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, weight_grad_kernel,
                                                               THREADS, (size_t)WG_SMEM);
    if (err || per_sm < 1) per_sm = 1;
  }
  int conv_tiles, tiles_n;
  const int tiles = weight_grad_tiles(R, conv_tiles, tiles_n);
  const int stages = cdiv(B * T_len, TK);
  const int s = per_sm * acopy::sm_count() / tiles;
  return s < 1 ? 1 : s < stages ? s : stages;
}

int launch_input_backward(const float* dz, const float* dx_out, const float* w, float* dx,
                          float* part, int B, int T_len, int R, int d, void* stream) {
  int err = set_smem(input_backward_kernel, IB_SMEM);
  if (err) return err;
  const int tiles = cdiv(T_len, TM);
  const dim3 grid(B * tiles, cdiv(R, TN));
  input_backward_kernel<<<grid, THREADS, IB_SMEM, (cudaStream_t)stream>>>(
      dz, dx_out, w, dx, part, T_len, R, d, tiles);
  return (int)cudaGetLastError();
}

int launch_weight_grad(const float* y, const float* dz, const float* g, const float* dx_out,
                       const float* dskip_out, float* part, float* dw_conv, float* dw_out,
                       int B, int T_len, int R, int d, int chunks, void* stream) {
  int err = set_smem(weight_grad_kernel, WG_SMEM);
  if (err) return err;
  int conv_tiles, tiles_n;
  const int tiles = weight_grad_tiles(R, conv_tiles, tiles_n);
  const int M = B * T_len;
  const int rows_per = cdiv(cdiv(M, TK), chunks) * TK;
  const dim3 grid(tiles, chunks);
  cudaStream_t s = (cudaStream_t)stream;
  weight_grad_kernel<<<grid, THREADS, WG_SMEM, s>>>(y, dz, g, dx_out, dskip_out, part, M,
                                                    T_len, R, d, conv_tiles, tiles_n,
                                                    rows_per);
  err = (int)cudaGetLastError();
  if (err) return err;
  const int sum_blocks = cdiv(2 * R * R, THREADS);  // 8 R^2 floats, 4 a thread
  weight_grad_sum<<<sum_blocks, THREADS, 0, s>>>(part, dw_conv, dw_out, R, chunks);
  return (int)cudaGetLastError();
}

}  // namespace k1x3

// K1's forward on the tensor cores: the gate (serving and training) and the
// output product in float32 through 3xTF32 wgmma (tf32x3.cuh, tf32x3::wg).
// A block is WGS warpgroups of 64 rows (m) each x BN columns (n), over
// stages of TK reduction steps in a ring of STAGES shared-memory slots,
// filled by 16-byte cp.async copies with zero-fill (the halo of the dilated
// taps and the ragged rows need no branch in the products; cp.async rather
// than TMA because an M tile may cross batch items, which a box over
// [B, T, C] would split into several copies). A slot holds
// three tiles of TK = 32 floats a row in tf32x3.cuh's 128-byte swizzled
// layout (8 threads copy a row's 128 bytes, coalesced, into 8 different
// bank groups):
//   A: the rows' operand (x at the tap's rows, or g) as it lands;
//   B big, B small: the weights' rows (output columns), split once per
//   prepare() call by the wrapper and kept K-major in device memory ([2][2R]
//   [K]: w's transpose, big then small).
// Each warp loads its 16 rows of a k8 step from A into registers and splits
// them there (wgmma with A from registers), while the k8 step before it
// runs, so no element is split twice and the split costs no shared-memory
// traffic; shared memory feeds B, which the block's warpgroups share.
// The block's BN columns are BN / 2 gate (or residual) columns j0.. and the
// matching BN / 2 filter (or skip) columns R + j0..: a thread's accumulator
// holds both of a pair, so the gate and the residual update stay in
// registers (z reaches device memory only when the training instance
// writes it).
//
// The gate's y = x + step[b] enters by linearity: the products read x, and
// the epilogue adds step[b] W_tap (for the taps whose row lies inside [0,
// T)), which step_taps computes first into a [B][3][2R] scratch (float32
// sums over C in order; the same launch).
//
// Sums: the tensor cores truncate a sum to its own magnitude (tf32x3.cuh's mma3), so
// each stage's TK-deep product (three wgmma a k8 step) is summed on them
// from zero and then added to the float32 accumulator. A stage rather than
// one k8 step: on an H100 its largest error against a float64 product
// stays below the float32 SIMT kernel's at the same inputs, which
// chip_smoke.py checks and prints (PERF.md). A warpgroup waits for
// its own wgmma before it reads the sum (a read of a sum whose wgmma may be
// in flight makes ptxas serialize every wgmma); the other warpgroup or
// block on the SM keeps the tensor cores busy meanwhile. What bounds the
// tiles is the L2 traffic of B (big and small, all of K, for every BM
// rows), so the large plan shares B between two warpgroups. No atomics: a
// rerun gives the same bits, and the training instance (SAVE_Z) runs the
// same plan as serving.
namespace k1f {

constexpr int TK = 32;              // reduction depth of a stage
constexpr int KC = TK / 4;          // 16-byte chunks of a stage's row
constexpr float RSQRT2 = 0.70710678118654752f;
static_assert(TK == 32, "a row of a stage is the 128 bytes of a swizzle atom");

template <int WGS, int BN, int STAGES>
struct Plan {
  static constexpr int THREADS = 128 * WGS;
  static constexpr int BM = 64 * WGS, N = BN, NSTAGES = STAGES;
  static constexpr int NACC = BN / 2;  // a thread's elements of its warpgroup's 64 x BN sum
  static constexpr int A_TILE = BM * TK, B_TILE = BN * TK;  // floats, 1024-byte multiples
  static constexpr int SLOT = A_TILE + 2 * B_TILE;
  static constexpr int SMEM = STAGES * SLOT * 4 + 1024;     // + the base's alignment
  // two blocks an SM where their shared memory fits (at most 128 registers
  // a thread), else one
  static constexpr int MIN_BLOCKS = 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static constexpr int A_CHUNKS = A_TILE / 4 / THREADS;      // 16-byte copies a thread
  static constexpr int B_CHUNKS = B_TILE / 4 / THREADS;
  static_assert(A_CHUNKS * 4 * THREADS == A_TILE && B_CHUNKS * 4 * THREADS == B_TILE, "");
  static_assert(STAGES >= 3, "a slot is refilled while the next stage runs");
};

// The float offset of chunk q (q / 8 the row, q % 8 the 16-byte chunk) in a
// swizzled tile.
__device__ __forceinline__ int chunk_at(int q) { return tf32x3::wg::swizzled(q >> 3, q & 7); }

// The products of a plan: a thread's NACC elements of its warpgroup's 64 x
// BN sum over nk stages, into acc from zero. ``load(slot, kt)`` issues the
// copies of stage kt into a slot of the ring at ``smem`` (A's BM rows, then
// B big and B small, BN rows each, all swizzled); stage kt's A elements are
// multiplied by ``a_scale(kt)`` in registers before their split.
template <class P, class Load, class Scale>
__device__ __forceinline__ void products(float (&acc)[P::NACC], float* smem, int nk,
                                         Load&& load, Scale&& a_scale) {
  const int tid = threadIdx.x, wg = tid >> 7;
  constexpr int STAGES = P::NSTAGES;
  float t[P::NACC];
#pragma unroll
  for (int i = 0; i < P::NACC; ++i) acc[i] = 0.f;

  // the prologue: STAGES - 1 stages in flight
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    acopy::copy_commit();
  }
  acopy::copy_wait<STAGES - 2>();
  tf32x3::wg::fence_shared();
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const float* slot = smem + (kt % STAGES) * P::SLOT;
    const float* sa = slot + wg * 64 * TK;  // the warpgroup's 64 rows
    const float* sb = slot + P::A_TILE;
    const float scale = a_scale(kt);
    // the stage's product into t from zero, each k8 step's A fragment
    // loaded and split while the step before it runs
    tf32x3::FragA fa[TK / 8];
    tf32x3::wg::fence_regs(t);
#pragma unroll
    for (int ks = 0; ks < TK / 8; ++ks) {
      tf32x3::wg::load_a(fa[ks], sa, ks, tid, scale);
      tf32x3::wg::fence();
      const float* bb = sb + ks * 8;   // 32 bytes a k8 step
      tf32x3::wg::mma_rs<P::N>(t, fa[ks], true, bb, ks == 0 ? 0 : 1);
      tf32x3::wg::mma_rs<P::N>(t, fa[ks], false, bb + P::B_TILE, 1);
      tf32x3::wg::mma_rs<P::N>(t, fa[ks], false, bb, 1);
    }
    tf32x3::wg::commit();
    // meanwhile: the copies STAGES - 1 stages ahead into the slot of the
    // stage before (every thread was past its products at the last barrier)
    if (kt + STAGES - 1 < nk) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    acopy::copy_commit();
    tf32x3::wg::wait<0>();
    tf32x3::wg::fence_regs(t);
#pragma unroll
    for (int ks = 0; ks < TK / 8; ++ks) tf32x3::wg::fence_frag(fa[ks]);
#pragma unroll
    for (int i = 0; i < P::NACC; ++i) acc[i] += t[i];
    // the next stage landed (this thread's copies), visible to the block
    // and to the tensor cores
    acopy::copy_wait<STAGES - 2>();
    tf32x3::wg::fence_shared();
    __syncthreads();
  }
  acopy::copy_wait<0>();
}

// taps[b][tap][n] = sum_c step[b, c] W_conv[tap C + c, n]: a block takes 32
// columns of one tap (a lane a column) for up to 8 items (blockIdx.z's);
// its 8 warps take C / 8 values of c each, in order, and their partial sums
// are added in warp order through shared memory.
__global__ void __launch_bounds__(256) step_taps(const float* __restrict__ step,
                                                 const float* __restrict__ w,
                                                 float* __restrict__ taps, int B, int C, int R) {
  __shared__ float part[8][8][32];  // [warp][item][column]
  const int tap = blockIdx.x, b0 = blockIdx.z * 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, n = blockIdx.y * 32 + lane;
  const int per = C / 8, c0 = warp * per;
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
  for (int c = c0; c < c0 + per; ++c) {
    const float wv = w[(size_t)(tap * C + c) * 2 * R + n];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (b0 + i < B) acc[i] += step[(size_t)(b0 + i) * C + c] * wv;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) part[warp][i][lane] = acc[i];
  __syncthreads();
  const int i = warp;  // item b0 + i, column n: the 8 warps' sums in order
  if (b0 + i < B) {
    float sum = part[0][i][lane];
    for (int v = 1; v < 8; ++v) sum += part[v][i][lane];
    taps[((size_t)(b0 + i) * 3 + tap) * 2 * R + n] = sum;
  }
}

// MODE 0 (gate): A[m, k] = x[b, t + (tap - 1) d, c], k = tap C + c, K = 3C
//   (zero outside [0, T)); z = A W_conv + sum of the live taps' step[b]
//   W_tap + b_conv + cond, g = sigmoid(z_a) tanh(z_f) -> out0 = g [M, R]
//   (SAVE_Z: out1 = z [M, 2R]).
// MODE 1 (out): A = g [M, R], K = R; o = A W_out + b_out ->
//   out0 = x' = (x + o_r) / sqrt 2, out1 = skip' = skip + o_s.
template <int MODE, int WGS, int BN, int STAGES, bool SAVE_Z>
__global__ void __launch_bounds__(128 * WGS, (Plan<WGS, BN, STAGES>::MIN_BLOCKS)) fwd_kernel(
    const float* __restrict__ a_src,   // MODE 0: x [M, C]; MODE 1: g [M, R]
    const float* __restrict__ taps,    // MODE 0: step_taps' [B][3][2R]
    const float* __restrict__ w,       // split weights [2][2R][K]
    const float* __restrict__ bias,    // [2R]
    const float* __restrict__ cond,    // MODE 0: [M, 2R]
    const float* __restrict__ x_in,    // MODE 1: [M, R]
    const float* __restrict__ skip_in, // MODE 1: [M, R]
    float* __restrict__ out0, float* __restrict__ out1, int M, int T_len, int C, int R,
    int K, int d) {
  using P = Plan<WGS, BN, STAGES>;
  extern __shared__ __align__(16) float k1f_smem[];
  float* smem = tf32x3::wg::align1024(k1f_smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * P::BM, j0 = blockIdx.y * (BN / 2);
  const size_t half = (size_t)2 * R * K;  // floats of the big (or small) weights
  // this thread's copies: q = tid + THREADS i is row q / 8, 16-byte chunk
  // q % 8 (the same for every i)
  const int kc = tid & (KC - 1);
  int a_m[P::A_CHUNKS], a_b[P::A_CHUNKS], a_t[P::A_CHUNKS];
#pragma unroll
  for (int i = 0; i < P::A_CHUNKS; ++i) {
    a_m[i] = m0 + ((tid + P::THREADS * i) >> 3);
    a_b[i] = a_m[i] < M ? a_m[i] / T_len : 0;
    a_t[i] = a_m[i] - a_b[i] * T_len;
  }
  auto load = [&](int slot, int kt) {
    const int k0 = kt * TK;
    float* sa = smem + slot * P::SLOT;
    float* sb = sa + P::A_TILE;
    if (MODE == 0) {
      const int tap = k0 / C, c = k0 - tap * C + kc * 4, shift = (tap - 1) * d;
#pragma unroll
      for (int i = 0; i < P::A_CHUNKS; ++i) {
        const int ts = a_t[i] + shift;
        const bool ok = a_m[i] < M && ts >= 0 && ts < T_len;
        acopy::copy16(sa + chunk_at(tid + P::THREADS * i),
                      ok ? a_src + ((size_t)a_b[i] * T_len + ts) * C + c : a_src, ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < P::A_CHUNKS; ++i) {
        const bool ok = a_m[i] < M;
        acopy::copy16(sa + chunk_at(tid + P::THREADS * i),
                      ok ? a_src + (size_t)a_m[i] * K + k0 + kc * 4 : a_src, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < P::B_CHUNKS; ++i) {
      const int q = tid + P::THREADS * i, n = q >> 3;
      const int col = (n < BN / 2 ? 0 : R - BN / 2) + j0 + n;
      const float* src = w + (size_t)col * K + k0 + kc * 4;
      acopy::copy16(sb + chunk_at(q), src, true);
      acopy::copy16(sb + P::B_TILE + chunk_at(q), src + half, true);
    }
  };
  float acc[P::NACC];
  products<P>(acc, smem, K / TK, load, [](int) { return 1.f; });

  // epilogue: d[4 j + 2 h + e] is row 16 warp + g + 8 h, column 8 j + 2 c +
  // e; n8 tiles j < BN / 16 are gate (residual) columns j0 + 8 j + ..., j +
  // BN / 16 the matching filter (skip) columns
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int row0 = m0 + 64 * wg + 16 * ((tid >> 5) & 3) + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
    const int b = m / T_len, tt = m - b * T_len;
    const bool live0 = tt - d >= 0, live2 = tt + d < T_len;  // taps 0 and 2
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const int col = j0 + 8 * j + 2 * c;
      const int e0 = 4 * j + 2 * h, e1 = 4 * (j + BN / 16) + 2 * h;
      const float2 b0 = *reinterpret_cast<const float2*>(bias + col);
      const float2 b1 = *reinterpret_cast<const float2*>(bias + R + col);
      float2 z0 = make_float2(acc[e0], acc[e0 + 1]);
      float2 z1 = make_float2(acc[e1], acc[e1 + 1]);
      const size_t o = (size_t)m * R + col;
      if (MODE == 0) {
        const float* tp = taps + (size_t)b * 6 * R + col;  // [tap][2R] of item b
#pragma unroll
        for (int tap = 0; tap < 3; ++tap) {
          if ((tap == 0 && !live0) || (tap == 2 && !live2)) continue;
          const float2 s0 = *reinterpret_cast<const float2*>(tp + tap * 2 * R);
          const float2 s1 = *reinterpret_cast<const float2*>(tp + tap * 2 * R + R);
          z0.x += s0.x, z0.y += s0.y, z1.x += s1.x, z1.y += s1.y;
        }
      }
      z0.x += b0.x, z0.y += b0.y, z1.x += b1.x, z1.y += b1.y;
      if (MODE == 0) {
        const size_t zr = (size_t)m * 2 * R + col;
        const float2 c0 = *reinterpret_cast<const float2*>(cond + zr);
        const float2 c1 = *reinterpret_cast<const float2*>(cond + zr + R);
        z0.x += c0.x, z0.y += c0.y, z1.x += c1.x, z1.y += c1.y;
        if constexpr (SAVE_Z) {
          *reinterpret_cast<float2*>(out1 + zr) = z0;
          *reinterpret_cast<float2*>(out1 + zr + R) = z1;
        }
        *reinterpret_cast<float2*>(out0 + o) =
            make_float2(1.f / (1.f + expf(-z0.x)) * tanhf(z1.x),
                        1.f / (1.f + expf(-z0.y)) * tanhf(z1.y));
      } else {
        const float2 xv = *reinterpret_cast<const float2*>(x_in + o);
        const float2 sv = *reinterpret_cast<const float2*>(skip_in + o);
        *reinterpret_cast<float2*>(out0 + o) =
            make_float2((xv.x + z0.x) * RSQRT2, (xv.y + z0.y) * RSQRT2);
        *reinterpret_cast<float2*>(out1 + o) = make_float2(sv.x + z1.x, sv.y + z1.y);
      }
    }
  }
}

template <int MODE, int WGS, int BN, int STAGES, bool SAVE_Z>
int launch_plan(const float* a_src, const float* taps, const float* w, const float* bias,
                const float* cond, const float* x_in, const float* skip_in, float* out0,
                float* out1, int M, int T_len, int C, int R, int d, cudaStream_t s) {
  using P = Plan<WGS, BN, STAGES>;
  const auto kernel = fwd_kernel<MODE, WGS, BN, STAGES, SAVE_Z>;
  const int err = k1x3::set_smem(kernel, P::SMEM);
  if (err) return err;
  const int K = MODE == 0 ? 3 * C : R;
  const dim3 grid = dim3(acopy::cdiv(M, P::BM), 2 * R / BN);
  kernel<<<grid, P::THREADS, P::SMEM, s>>>(a_src, taps, w, bias, cond, x_in, skip_in, out0,
                                           out1, M, T_len, C, R, K, d);
  return (int)cudaGetLastError();
}

// The plans on the tensor cores: 1 = one warpgroup, 64 x 64 tiles, 4 stages
// (97 KB, two blocks an SM); 2 = two warpgroups sharing B, 128 x 128 tiles,
// 4 stages (193 KB, one block an SM). The rule from M: 128 x 128 where its
// grid has a block for at least every second SM, else 64 x 64 (measured on
// an H100 at M = 256 to 10240, PERF.md: 64 x 64 faster up to M =
// 1024, 128 x 128 from M = 1536 on; a one-warpgroup 64 x 128 plan was
// never the fastest, and the float32 SIMT kernel block_gemm was slower
// than both at every M, so no SIMT range stays).
int plan_for(int M, int R) {
  return acopy::cdiv(M, 128) * (2 * R / 128) * 2 >= acopy::sm_count() ? 2 : 1;
}

// The gate (MODE 0) first writes step_taps' scratch ``taps`` [B][3][2R].
template <int MODE, bool SAVE_Z>
int launch(const float* a_src, const float* step, const float* w_plain, const float* w,
           float* taps, const float* bias, const float* cond, const float* x_in,
           const float* skip_in, float* out0, float* out1, int B, int T_len, int C, int R,
           int d, void* stream) {
  const int M = B * T_len;
  cudaStream_t s = (cudaStream_t)stream;
  if (w == nullptr || (MODE == 0 && taps == nullptr) || C != R || R % 64)
    return (int)cudaErrorInvalidValue;
  if (MODE == 0) {
    const dim3 grid = dim3(3, 2 * R / 32, acopy::cdiv(B, 8));
    step_taps<<<grid, 256, 0, s>>>(step, w_plain, taps, B, C, R);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (plan_for(M, R) == 1)
    return launch_plan<MODE, 1, 64, 4, SAVE_Z>(a_src, taps, w, bias, cond, x_in, skip_in, out0,
                                               out1, M, T_len, C, R, d, s);
  return launch_plan<MODE, 2, 128, 4, SAVE_Z>(a_src, taps, w, bias, cond, x_in, skip_in, out0,
                                              out1, M, T_len, C, R, d, s);
}

// The gate backward on the same products: dg = do W_out^T over the M = B T
// rows (flat: nothing here depends on the item) and N = R columns, K = 2R,
// with do = [dx' / sqrt 2 | dskip'] gathered stage by stage (TK divides R,
// so a stage lies in dx' or in dskip'; the 1 / sqrt 2 is applied to A's
// elements in registers before their split, the plain version's float32
// product) and B = W_out's rows as stored ([R][2R] is K-major already:
// the wrapper's split is of W_out itself, [2][R][2R], not of its transpose,
// which the forward's out_split holds). The block's BN columns are n0 ..
// n0 + BN - 1; the epilogue reads z[m, n], z[m, n + 1] and z[m, R + n], z[m,
// R + n + 1] as float2 for a thread's column pair and writes both halves of
// dz [M, 2R].
template <int WGS, int BN, int STAGES>
__global__ void __launch_bounds__(128 * WGS, (Plan<WGS, BN, STAGES>::MIN_BLOCKS))
    gate_bwd_kernel(const float* __restrict__ dx_out,     // [M, R]
                    const float* __restrict__ dskip_out,  // [M, R]
                    const float* __restrict__ w,          // W_out split [2][R][2R]
                    const float* __restrict__ z,          // [M, 2R]
                    float* __restrict__ dz,               // [M, 2R]
                    int M, int R) {
  using P = Plan<WGS, BN, STAGES>;
  extern __shared__ __align__(16) float k1f_smem[];
  float* smem = tf32x3::wg::align1024(k1f_smem);
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.x * P::BM, n0 = blockIdx.y * BN;
  const int K = 2 * R;
  const size_t half = (size_t)R * K;  // floats of the big (or small) weights
  const int kc = tid & (KC - 1);
  auto load = [&](int slot, int kt) {
    const int k0 = kt * TK;
    float* sa = smem + slot * P::SLOT;
    float* sb = sa + P::A_TILE;
    const float* a = (k0 < R ? dx_out + k0 : dskip_out + (k0 - R)) + kc * 4;
#pragma unroll
    for (int i = 0; i < P::A_CHUNKS; ++i) {
      const int q = tid + P::THREADS * i, m = m0 + (q >> 3);
      acopy::copy16(sa + chunk_at(q), m < M ? a + (size_t)m * R : a, m < M);
    }
#pragma unroll
    for (int i = 0; i < P::B_CHUNKS; ++i) {
      const int q = tid + P::THREADS * i;
      const float* src = w + (size_t)(n0 + (q >> 3)) * K + k0 + kc * 4;
      acopy::copy16(sb + chunk_at(q), src, true);
      acopy::copy16(sb + P::B_TILE + chunk_at(q), src + half, true);
    }
  };
  float acc[P::NACC];
  products<P>(acc, smem, K / TK, load, [R](int kt) { return kt * TK < R ? RSQRT2 : 1.f; });

  // epilogue: acc[4 j + 2 h + e] is dg at row 16 warp + g + 8 h, column n0
  // + 8 j + 2 c + e
  const int lane = tid & 31, g = lane >> 2, c = lane & 3;
  const int row0 = m0 + 64 * wg + 16 * ((tid >> 5) & 3) + g;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row0 + 8 * h;
    if (m >= M) continue;
    const float* zr = z + (size_t)m * 2 * R;
    float* dr = dz + (size_t)m * 2 * R;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * c, e = 4 * j + 2 * h;
      const float2 za = *reinterpret_cast<const float2*>(zr + n);
      const float2 zf = *reinterpret_cast<const float2*>(zr + R + n);
      const float dg[2] = {acc[e], acc[e + 1]};
      const float zs[2] = {za.x, za.y}, zt[2] = {zf.x, zf.y};
      float da[2], df[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float sg = 1.f / (1.f + expf(-zs[q])), tf = tanhf(zt[q]);
        da[q] = dg[q] * tf * sg * (1.f - sg);
        df[q] = dg[q] * sg * (1.f - tf * tf);
      }
      *reinterpret_cast<float2*>(dr + n) = make_float2(da[0], da[1]);
      *reinterpret_cast<float2*>(dr + R + n) = make_float2(df[0], df[1]);
    }
  }
}

template <int WGS, int BN, int STAGES>
int launch_gate_bwd_plan(const float* dx_out, const float* dskip_out, const float* w,
                         const float* z, float* dz, int M, int R, cudaStream_t s) {
  using P = Plan<WGS, BN, STAGES>;
  if (R % BN) return (int)cudaErrorInvalidValue;
  const auto kernel = gate_bwd_kernel<WGS, BN, STAGES>;
  const int err = k1x3::set_smem(kernel, P::SMEM);
  if (err) return err;
  const dim3 grid = dim3(acopy::cdiv(M, P::BM), R / BN);
  kernel<<<grid, P::THREADS, P::SMEM, s>>>(dx_out, dskip_out, w, z, dz, M, R);
  return (int)cudaGetLastError();
}

// The gate backward's plans: 1 = one warpgroup, 64 x 64 tiles, 4 stages
// (two blocks an SM); 2 = two warpgroups sharing B, 128 x 128 tiles, 4
// stages (one block an SM); 3 = two warpgroups sharing B, 128 x 64 tiles,
// 3 stages (two blocks an SM, so one block's epilogue overlaps the other's
// products). The rule from M and R, in 128 x 64 tiles (PERF.md, measured
// on an H100 at R = 512: 128 x 64 fastest at M = 10240, 64 x 64 at 5120
// and 1024, 128 x 128 at 2560): 128 x 64 where its grid fills the card's
// slots of two blocks an SM at least twice; 128 x 128 where R allows it
// and its grid is one wave of one block an SM, at least half full; else
// 64 x 64.
int gate_bwd_plan_for(int M, int R) {
  const int sms = acopy::sm_count(), tiles = acopy::cdiv(M, 128) * (R / 64);
  if (tiles >= 4 * sms) return 3;
  return R % 128 == 0 && tiles >= sms && tiles < 2 * sms ? 2 : 1;
}

int launch_gate_bwd(const float* dx_out, const float* dskip_out, const float* w,
                    const float* z, float* dz, int B, int T_len, int R, void* stream) {
  const int M = B * T_len;
  cudaStream_t s = (cudaStream_t)stream;
  if (w == nullptr || R % 64) return (int)cudaErrorInvalidValue;
  switch (gate_bwd_plan_for(M, R)) {
    case 1: return launch_gate_bwd_plan<1, 64, 4>(dx_out, dskip_out, w, z, dz, M, R, s);
    case 2: return launch_gate_bwd_plan<2, 128, 4>(dx_out, dskip_out, w, z, dz, M, R, s);
    default: return launch_gate_bwd_plan<2, 64, 3>(dx_out, dskip_out, w, z, dz, M, R, s);
  }
}

}  // namespace k1f

// The weights' TF32 split for the 3xTF32 wgmma kernels (k1f): big =
// rna(x) and small = rna(x - big) of every element (tf32x3::split), the
// bits of models/wavenet.py's tf32_split. It replaces no TPU kernel: the
// 3xTF32 design needs it, once a prepare() call, for every block's
// weights. A weight w [rows][cols] is written as [2][cols][rows] (its
// transpose, K-major for the forward, where w is [K][N]), as
// [2][rows][cols] (itself, the gate backward's W_out), or both from one
// read. One launch splits a table of up to MAX weights (a prepare() call's
// 40): a block takes a 32 x 32 tile of one weight (the table's first tiles
// hold its weight's start, so a block finds its weight in the table),
// reads it coalesced, writes it as stored straight from registers and
// transposed through shared memory, both coalesced. Bound on an H100:
// bytes, each weight read once and its planes written (~590 MB a training
// step's 40 weights at R = 512, W_out in both layouts).
namespace wsplit {

constexpr int MAX = 64, TILE = 32;

struct Table {
  const float* src[MAX];
  float* dst_t[MAX];  // [2][cols][rows], or null
  float* dst_n[MAX];  // [2][rows][cols], or null
  int rows[MAX], cols[MAX];
  int tile0[MAX + 1];  // weight i's tiles are tile0[i] .. tile0[i + 1] - 1
  int n;
};

__global__ void __launch_bounds__(256) split_kernel(const Table tab) {
  __shared__ float big[TILE][TILE + 1], small[TILE][TILE + 1];
  int i = 0;
  while (i + 1 < tab.n && tab.tile0[i + 1] <= (int)blockIdx.x) ++i;
  const int rows = tab.rows[i], cols = tab.cols[i];
  const int t = blockIdx.x - tab.tile0[i], tiles_c = acopy::cdiv(cols, TILE);
  const int r0 = (t / tiles_c) * TILE, c0 = (t % tiles_c) * TILE;
  const float* src = tab.src[i];
  float *dst_t = tab.dst_t[i], *dst_n = tab.dst_n[i];
  const size_t plane = (size_t)rows * cols;
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;  // 32 x 8 threads
  for (int k = ty; k < TILE; k += 8) {
    const int r = r0 + k, c = c0 + tx;
    if (r >= rows || c >= cols) continue;
    const size_t o = (size_t)r * cols + c;
    float b, sm;
    tf32x3::split(src[o], b, sm);
    big[k][tx] = b;
    small[k][tx] = sm;
    if (dst_n) {
      dst_n[o] = b;
      dst_n[plane + o] = sm;
    }
  }
  if (!dst_t) return;  // the same for the whole block
  __syncthreads();
  for (int k = ty; k < TILE; k += 8) {
    const int c = c0 + k, r = r0 + tx;
    if (r >= rows || c >= cols) continue;
    const size_t o = (size_t)c * rows + r;
    dst_t[o] = big[tx][k];
    dst_t[plane + o] = small[tx][k];
  }
}

int launch(const void* const* src, void* const* dst_t, void* const* dst_n, const int* rows,
           const int* cols, int n, void* stream) {
  if (n < 1 || n > MAX) return (int)cudaErrorInvalidValue;
  Table tab;
  tab.n = n;
  tab.tile0[0] = 0;
  for (int i = 0; i < n; ++i) {
    if (!dst_t[i] && !dst_n[i]) return (int)cudaErrorInvalidValue;
    tab.src[i] = (const float*)src[i];
    tab.dst_t[i] = (float*)dst_t[i];
    tab.dst_n[i] = (float*)dst_n[i];
    tab.rows[i] = rows[i];
    tab.cols[i] = cols[i];
    tab.tile0[i + 1] = tab.tile0[i] + acopy::cdiv(rows[i], TILE) * acopy::cdiv(cols[i], TILE);
  }
  const dim3 grid = dim3(tab.tile0[n]);
  split_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(tab);
  return (int)cudaGetLastError();
}

}  // namespace wsplit

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The Python wrapper checks R % 64 == 0
// and 16-byte aligned tensors. float32 runs the tensor cores, in the plan
// that k1f::plan_for picks from M, on w_split, the weights split by the
// wrapper ([2][2R][K]: w's transpose, big and small), the gate with
// ``taps`` [B][3][2R] as scratch; bfloat16 runs block_gemm on w_conv /
// w_out (w_split and taps unused). Returns the cudaError_t of the launch.
extern "C" int wavenet_gate(int dtype, const void* x, const void* step,
                            const void* w_conv, const void* w_split, void* taps,
                            const void* b_conv, const void* cond, void* g, int B, int T_len,
                            int C, int R, int d, void* stream) {
  if (dtype == 0)
    return k1f::launch<0, false>((const float*)x, (const float*)step,
                                 (const float*)w_conv, (const float*)w_split, (float*)taps,
                                 (const float*)b_conv, (const float*)cond, nullptr, nullptr,
                                 (float*)g, nullptr, B, T_len, C, R, d, stream);
  return launch<__nv_bfloat16, 0>(x, step, w_conv, b_conv, cond, nullptr,
                                  nullptr, g, nullptr, B, T_len, C, R, d,
                                  stream);
}

extern "C" int wavenet_out(int dtype, const void* g, const void* w_out, const void* w_split,
                           const void* b_out, const void* x_in,
                           const void* skip_in, void* x_out, void* skip_out,
                           int B, int T_len, int R, void* stream) {
  if (dtype == 0)
    return k1f::launch<1, false>((const float*)g, nullptr, (const float*)w_out,
                                 (const float*)w_split, nullptr, (const float*)b_out, nullptr,
                                 (const float*)x_in, (const float*)skip_in, (float*)x_out,
                                 (float*)skip_out, B, T_len, R, R, 0, stream);
  return launch<__nv_bfloat16, 1>(g, nullptr, w_out, b_out, nullptr, x_in,
                                  skip_in, x_out, skip_out, B, T_len, R, R, 0,
                                  stream);
}

// K1's training forward (float32): wavenet_gate that also writes the
// pre-activation z [B, T, 2R] (bias and conditioner added), which the
// backward reads; the same plan as serving's for the same shapes.
extern "C" int wavenet_gate_train(const void* x, const void* step, const void* w_conv,
                                  const void* w_split, void* taps, const void* b_conv,
                                  const void* cond, void* g, void* z, int B, int T_len, int R,
                                  int d, void* stream) {
  return k1f::launch<0, true>((const float*)x, (const float*)step, (const float*)w_conv,
                              (const float*)w_split, (float*)taps, (const float*)b_conv,
                              (const float*)cond, nullptr, nullptr, (float*)g, (float*)z, B,
                              T_len, R, R, d, stream);
}

// The plan the rule picks for B T rows (wavenet_gate's and wavenet_out's).
extern "C" int wavenet_forward_plan(int B, int T_len, int R) {
  return k1f::plan_for(B * T_len, R);
}

// The rows of the input backward's tiles: ``part`` of
// wavenet_input_backward is [B, ceil(T / rows), R].
extern "C" int wavenet_backward_rows(int B, int T_len, int R) { return k1x3::TM; }

// dz [B, T, 2R] from dx', dskip' [B, T, R], w_split (W_out [R, 2R] split:
// [2][R][2R], big and small, not transposed) and z [B, T, 2R], on the
// 3xTF32 wgmma core in the plan k1f::gate_bwd_plan_for picks.
extern "C" int wavenet_gate_backward(const void* dx_out, const void* dskip_out,
                                     const void* w_split, const void* z, void* dz, int B,
                                     int T_len, int R, void* stream) {
  return k1f::launch_gate_bwd((const float*)dx_out, (const float*)dskip_out,
                              (const float*)w_split, (const float*)z, (float*)dz, B, T_len, R,
                              stream);
}

// The plan the rule picks for wavenet_gate_backward at B T rows.
extern "C" int wavenet_gate_backward_plan(int B, int T_len, int R) {
  return k1f::gate_bwd_plan_for(B * T_len, R);
}

// The TF32 split of n <= 64 float32 weights in one launch: weight i, src[i]
// [rows[i]][cols[i]], into dst_t[i] [2][cols[i]][rows[i]] and dst_n[i]
// [2][rows[i]][cols[i]], big then small, either null but not both.
extern "C" int wavenet_weight_split(const void* const* src, void* const* dst_t,
                                    void* const* dst_n, const int* rows, const int* cols, int n,
                                    void* stream) {
  return wsplit::launch(src, dst_t, dst_n, rows, cols, n, stream);
}

// dx [B, T, R] and part [B, ceil(T / rows), R] (each tile's column sums of
// dy) from dz [B, T, 2R], dx' [B, T, R] and W_conv [3R, 2R].
extern "C" int wavenet_input_backward(const void* dz, const void* dx_out, const void* w_conv,
                                      void* dx, void* part, int B, int T_len, int R, int d,
                                      void* stream) {
  return k1x3::launch_input_backward((const float*)dz, (const float*)dx_out,
                                     (const float*)w_conv, (float*)dx, (float*)part, B, T_len,
                                     R, d, stream);
}

// The chunks of wavenet_weight_grad's reduction: its ``part`` is
// [chunks, 4R, 2R].
extern "C" int wavenet_weight_grad_chunks(int B, int T_len, int R) {
  return k1x3::weight_grad_chunks(B, T_len, R);
}

// dW_conv [3R, 2R] and dW_out [R, 2R] from y = x + step[b], dz [B, T, 2R],
// g, dx', dskip' [B, T, R]; part [chunks, 4R, 2R] is scratch.
extern "C" int wavenet_weight_grad(const void* y, const void* dz, const void* g,
                                   const void* dx_out, const void* dskip_out, void* part,
                                   void* dw_conv, void* dw_out, int B, int T_len, int R, int d,
                                   int chunks, void* stream) {
  return k1x3::launch_weight_grad((const float*)y, (const float*)dz, (const float*)g,
                                  (const float*)dx_out, (const float*)dskip_out, (float*)part,
                                  (float*)dw_conv, (float*)dw_out, B, T_len, R, d, chunks,
                                  stream);
}
