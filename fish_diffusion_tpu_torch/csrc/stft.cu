// K5 (forward): the STFT magnitude as one tiled SIMT product whose A tile
// is gathered straight from the signal.
//
// Replaces fish_diffusion_tpu/ops/mel.py:_stft_conv / _stft_conv_fwd, which
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
      out[((size_t)b * bins + bin) * F + f] = sqrtf(re * re + im * im + EPS);
    }
  }
}

template <int BM, int BNH, int TM, int TNH>
int launch_tile(const float* y, const float* basis, float* out, int B,
                int T_pad, int n_fft, int hop, int bins, int F,
                cudaStream_t stream) {
  const int M = B * F;
  dim3 grid((M + BM - 1) / BM, (bins + BNH - 1) / BNH);
  stft_tile<BM, BNH, TM, TNH><<<grid, THREADS, 0, stream>>>(
      y, basis, out, T_pad, n_fft, hop, bins, F, M);
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
// wrapper checks). Returns the cudaError_t of the launch.
extern "C" int stft_magnitude(const void* y, const void* basis, void* out,
                              int B, int T_pad, int n_fft, int hop, int bins,
                              int F, void* stream) {
  const float* yp = (const float*)y;
  const float* bp = (const float*)basis;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile_rows(B * F, bins)) {
    case 128:
      return launch_tile<128, 64, 8, 4>(yp, bp, op, B, T_pad, n_fft, hop,
                                        bins, F, s);
    case 64:
      return launch_tile<64, 32, 4, 2>(yp, bp, op, B, T_pad, n_fft, hop, bins,
                                       F, s);
    default:
      return launch_tile<32, 32, 2, 2>(yp, bp, op, B, T_pad, n_fft, hop, bins,
                                       F, s);
  }
}
