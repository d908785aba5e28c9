// K5: the STFT magnitude as one tiled SIMT product whose A tile is gathered
// straight from the signal, and its backward (stft_backward, at the end).
//
// The forward replaces fish_diffusion_tpu/ops/mel.py:_stft_conv / _stft_conv_fwd, which
// stacked hop-sized blocks of the signal into a frame matrix so that the
// windowed DFT became one dense product on the TPU's matrix unit.
//
//   out[b, k, f] = sqrt(re^2 + im^2 + 1e-9),
//   re = sum_n y[b, f * hop + n] * basis[n, k],
//   im = sum_n y[b, f * hop + n] * basis[n, bins + k],   n < n_fft
//
// with y the reflect-padded signal [B, T_pad] and basis the windowed DFT
// [n_fft, 2 * bins] (cos columns, then -sin columns), built on the host.
//
// Bound on an H100: arithmetic. At B = 4 x 1024 frames and n_fft = 2048 the
// product is 2 * 4096 * 2048 * 2050 = 34.4 GFLOP against ~42 MB of traffic,
// far above the card's balance point; float32 on the SIMT units (no TF32:
// the log10 after the 1e-5 clamp amplifies relative error in quiet bins).
// Design: K1's tiling (shared-memory stages, register blocking, the next
// stage prefetched into registers). Row m = (b, f) of A is read at
// y[b, f * hop + n], so no frame matrix is ever written; frames overlap
// n_fft / hop times and those rereads come from cache. Each thread owns
// bin k and column bins + k, so the magnitude forms in the epilogue and
// the complex spectrum never reaches device memory. n_fft, hop and the bin
// count are runtime integers (key shifts give n_fft = 2299 and other sizes
// that are not powers of two); reads past n_fft, past the signal's end and
// past the last bin are masked. The tile shrinks with the row count, as in
// K1, so that a short segment still gives every SM a block.

#include <cuda_runtime.h>

namespace {

constexpr int BK = 16;        // depth of one shared-memory stage
constexpr float EPS = 1e-9f;  // inside the magnitude's square root
constexpr int THREADS = 256;  // 16 x 16 threads

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

// A block computes BM frames x BNH bins (BNH cos + BNH sin columns); each
// thread TM frames x (TNH + TNH) columns.
template <int BM, int BNH, int TM, int TNH>
__global__ void __launch_bounds__(THREADS) stft_tile(
    const float* __restrict__ y,      // [B, T_pad]
    const float* __restrict__ basis,  // [n_fft, 2 * bins]
    float* __restrict__ out,          // [B, bins, F]
    float* __restrict__ phasor,       // [B, 2 * bins, F] or null
    int T_pad, int n_fft, int hop, int bins, int F, int M) {
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

  // A stage: each thread loads A_PER consecutive samples of one frame
  const int a_row = tid / (BK / A_PER);
  const int a_k = (tid % (BK / A_PER)) * A_PER;
  const int a_m = m0 + a_row;
  const int a_b = a_m < M ? a_m / F : 0;
  const int a_f = a_m < M ? a_m - a_b * F : 0;
  const float* a_src = y + (size_t)a_b * T_pad + (size_t)a_f * hop;
  // samples n < a_lim of this frame exist (0 for a row past the last)
  const int a_avail = T_pad - a_f * hop;
  const int a_lim = a_m >= M ? 0 : (a_avail < n_fft ? a_avail : n_fft);

  // B stage: each thread loads B_PER consecutive columns of one basis row;
  // columns [0, BNH) of the tile are cos bins, [BNH, 2 BNH) the sin bins
  const int b_k = tid / 16;
  const int b_n = (tid % 16) * B_PER;
  const int b_bin = j0 + (b_n < BNH ? b_n : b_n - BNH);
  const int b_off = b_n < BNH ? 0 : bins;

  float a_next[A_PER], b_next[B_PER];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int n = k0 + a_k + i;
      a_next[i] = n < a_lim ? a_src[n] : 0.f;
    }
    const int n = k0 + b_k;
    const float* row = basis + (size_t)n * (2 * bins) + b_off;
#pragma unroll
    for (int i = 0; i < B_PER; ++i)
      b_next[i] = (n < n_fft && b_bin + i < bins) ? row[b_bin + i] : 0.f;
  };

  float acc[TM][2 * TNH];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 2 * TNH; ++j) acc[i][j] = 0.f;

  fetch(0);
  for (int k0 = 0; k0 < n_fft; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) As[a_k + i][a_row] = a_next[i];
#pragma unroll
    for (int i = 0; i < B_PER; ++i) Bs[b_k][b_n + i] = b_next[i];
    __syncthreads();
    if (k0 + BK < n_fft) fetch(k0 + BK);

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
    const int b = m / F;
    const int f = m - b * F;
#pragma unroll
    for (int j = 0; j < TNH; ++j) {
      const int bin = j0 + tx * TNH + j;
      if (bin >= bins) continue;
      const float re = acc[i][j];
      const float im = acc[i][TNH + j];
      const float mag = sqrtf(re * re + im * im + EPS);
      out[((size_t)b * bins + bin) * F + f] = mag;
      if (phasor) {  // training: d mag / d (re, im), for stft_backward
        phasor[((size_t)b * 2 * bins + bin) * F + f] = re / mag;
        phasor[((size_t)b * 2 * bins + bins + bin) * F + f] = im / mag;
      }
    }
  }
}

template <int BM, int BNH, int TM, int TNH>
int launch_tile(const float* y, const float* basis, float* out, float* phasor,
                int B, int T_pad, int n_fft, int hop, int bins, int F,
                cudaStream_t stream) {
  const int M = B * F;
  dim3 grid((M + BM - 1) / BM, (bins + BNH - 1) / BNH);
  stft_tile<BM, BNH, TM, TNH><<<grid, THREADS, 0, stream>>>(
      y, basis, out, phasor, T_pad, n_fft, hop, bins, F, M);
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

// The rows of the tile for M = B * F frames: the largest tile whose grid
// still has a block for every SM.
int tile_rows(int M, int bins) {
  const int sms = sm_count();
  if (((M + 127) / 128) * ((bins + 63) / 64) >= sms) return 128;
  if (((M + 63) / 64) * ((bins + 31) / 32) >= sms) return 64;
  return 32;
}

}  // namespace

// The tile stft_magnitude launches for M frames and bins bins, by its rows:
// 128 (128 frames x 64 bins), 64 (64 x 32) or 32 (32 x 32).
extern "C" int stft_tile(int M, int bins) { return tile_rows(M, bins); }

// y [B, T_pad], basis [n_fft, 2 * bins], out [B, bins, F] with
// F = (T_pad - n_fft) / hop + 1, all float32 and contiguous (the Python
// wrapper checks). phasor [B, 2 * bins, F] receives re / mag and im / mag
// when training needs the backward; it is null when serving. Returns the
// cudaError_t of the launch.
extern "C" int stft_magnitude(const void* y, const void* basis, void* out,
                              void* phasor, int B, int T_pad, int n_fft,
                              int hop, int bins, int F, void* stream) {
  const float* yp = (const float*)y;
  const float* bp = (const float*)basis;
  float* op = (float*)out;
  float* pp = (float*)phasor;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile_rows(B * F, bins)) {
    case 128:
      return launch_tile<128, 64, 8, 4>(yp, bp, op, pp, B, T_pad, n_fft, hop,
                                        bins, F, s);
    case 64:
      return launch_tile<64, 32, 4, 2>(yp, bp, op, pp, B, T_pad, n_fft, hop,
                                       bins, F, s);
    default:
      return launch_tile<32, 32, 2, 2>(yp, bp, op, pp, B, T_pad, n_fft, hop,
                                       bins, F, s);
  }
}

// ---------------------------------------------------------------------------
// K5 backward: stft_backward
//
// Replaces fish_diffusion_tpu/ops/mel.py:_stft_conv_bwd (the hand VJP, a
// DFT-transpose GEMM into a [B, F, n_fft] frame gradient, then an
// overlap-add of ceil(n_fft / hop) shifted adds).
//
//   grad_y[b, j * hop + r] = sum_{i < k_ov} sum_{c < 2 bins}
//                            gs[b, c, j - i] * basis[i * hop + r, c]
//
// with k_ov = ceil(n_fft / hop) and gs the spectrum's gradient, formed as
// A is loaded from the magnitude's gradient g [B, bins, F] and the phasor
// the forward kept: gs[b, k, f] = g[b, k, f] * re / mag,
// gs[b, bins + k, f] = g[b, k, f] * im / mag.
//
// Bound on an H100: arithmetic, like the forward (the same dense DFT
// product, 2 * B * T_pad * 2 bins * k_ov operations). Design: the mirror
// of the forward's gathered-A product. Rows are output hop-blocks (b, j),
// columns the r < hop samples of a block, and the reduction runs over
// (i, c) with frame f = j - i masked to [0, F) and basis rows past n_fft
// masked. Every output sample is one thread's sum: no atomics, no frame
// gradient in device memory, and the result does not depend on the
// schedule. The frame overlap the JAX VJP added in k_ov passes is the
// i-loop of the reduction.
// ---------------------------------------------------------------------------

namespace {

constexpr int BWD_BM = 64, BWD_BN = 64, BWD_TM = 4, BWD_TN = 4;
constexpr int BWD_BNS = BWD_BN + 4;  // B tile row stride: spreads the stores

__global__ void __launch_bounds__(THREADS) stft_bwd_tile(
    const float* __restrict__ g,       // [B, bins, F]
    const float* __restrict__ phasor,  // [B, 2 * bins, F]
    const float* __restrict__ basis,   // [n_fft, 2 * bins]
    float* __restrict__ grad,          // [B, T_pad]
    int T_pad, int n_fft, int hop, int bins, int F, int NB, int k_ov,
    int M) {
  constexpr int TX = BWD_BN / BWD_TN;  // 16 threads along samples
  __shared__ __align__(16) float As[BK][BWD_BM];
  __shared__ __align__(16) float Bs[BK][BWD_BNS];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int m0 = blockIdx.x * BWD_BM;
  const int r0 = blockIdx.y * BWD_BN;
  const int C2 = 2 * bins;
  const int KR = k_ov * C2;

  // A: each thread one row (b, j), BK / 4 consecutive (i, c); neighbouring
  // threads read neighbouring frames
  const int a_row = tid % BWD_BM;
  const int a_k = (tid / BWD_BM) * (BK * BWD_BM / THREADS);
  const int a_m = m0 + a_row;
  const int a_b = a_m < M ? a_m / NB : 0;
  const int a_j = a_m < M ? a_m - a_b * NB : -(1 << 30);  // masks every f
  const float* g_b = g + (size_t)a_b * bins * F;
  const float* p_b = phasor + (size_t)a_b * C2 * F;
  // B: each thread one sample column, BK / 4 consecutive (i, c); the 16
  // threads of a column read 16 neighbouring basis entries
  const int b_k = (tid % (BK / 4)) * 4;
  const int b_col = tid / (BK / 4);

  float acc[BWD_TM][BWD_TN];
#pragma unroll
  for (int i = 0; i < BWD_TM; ++i)
#pragma unroll
    for (int j = 0; j < BWD_TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < KR; k0 += BK) {
#pragma unroll
    for (int e = 0; e < BK * BWD_BM / THREADS; ++e) {
      const int kk = k0 + a_k + e;
      const int i = kk / C2;
      const int c = kk - i * C2;
      const int f = a_j - i;
      float v = 0.f;
      if (kk < KR && f >= 0 && f < F) {
        const int bin = c < bins ? c : c - bins;
        v = g_b[(size_t)bin * F + f] * p_b[(size_t)c * F + f];
      }
      As[a_k + e][a_row] = v;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kk = k0 + b_k + e;
      const int i = kk / C2;
      const int c = kk - i * C2;
      const int r = r0 + b_col;
      const int n = i * hop + r;
      Bs[b_k + e][b_col] = (kk < KR && r < hop && n < n_fft)
                               ? basis[(size_t)n * C2 + c]
                               : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[BWD_TM], bv[BWD_TN];
      load_smem<BWD_TM>(&As[kk][ty * BWD_TM], a);
      load_smem<BWD_TN>(&Bs[kk][tx * BWD_TN], bv);
#pragma unroll
      for (int i = 0; i < BWD_TM; ++i)
#pragma unroll
        for (int j = 0; j < BWD_TN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < BWD_TM; ++i) {
    const int m = m0 + ty * BWD_TM + i;
    if (m >= M) continue;
    const int b = m / NB;
    const int j = m - b * NB;
#pragma unroll
    for (int jj = 0; jj < BWD_TN; ++jj) {
      const int r = r0 + tx * BWD_TN + jj;
      const long t = (long)j * hop + r;
      if (r < hop && t < T_pad) grad[(size_t)b * T_pad + t] = acc[i][jj];
    }
  }
}

}  // namespace

// g [B, bins, F] (the magnitude's gradient), phasor [B, 2 * bins, F] (from
// the forward), basis [n_fft, 2 * bins], grad [B, T_pad]: every sample is
// written, those no frame reads with 0. All float32 and contiguous (the
// Python wrapper checks). Returns the cudaError_t of the launch.
extern "C" int stft_backward(const void* g, const void* phasor,
                             const void* basis, void* grad, int B, int T_pad,
                             int n_fft, int hop, int bins, int F,
                             void* stream) {
  const int NB = (T_pad + hop - 1) / hop;
  const int k_ov = (n_fft + hop - 1) / hop;
  const int M = B * NB;
  dim3 grid((M + BWD_BM - 1) / BWD_BM, (hop + BWD_BN - 1) / BWD_BN);
  stft_bwd_tile<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)phasor, (const float*)basis,
      (float*)grad, T_pad, n_fft, hop, bins, F, NB, k_ov, M);
  return (int)cudaGetLastError();
}
