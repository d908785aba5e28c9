// K5: the STFT magnitude (stft_magnitude) and its backward (stft_backward)
// as FFTs in shared memory, and, where the FFT does not fit there, as
// four-step FFTs through device memory (any n_fft up to 2^21).
//
// The forward replaces fish_diffusion_tpu/ops/mel.py:_stft_conv /
// _stft_conv_fwd, which stacked hop-sized blocks of the signal into a frame
// matrix so that the windowed DFT became one dense product on the TPU's
// matrix unit:
//
//   out[b, k, f] = sqrt(re^2 + im^2 + 1e-9),  re + i im = X_f[k],
//   X_f[k] = sum_{n < N} w[n] y[b, f * hop + n] e^{-2 pi i k n / N},  k < bins
//
// with y the reflect-padded signal [B, T_pad], w the periodic Hann window of
// win_length centred in N = n_fft zeros and bins = N / 2 + 1. The backward
// replaces _stft_conv_bwd, the hand VJP: for g = dL/d out,
//
//   G_k = g_k X_k / sqrt(|X_k|^2 + 1e-9)
//   d frame_f[n] = w[n] Re sum_{k < bins} G_k e^{+2 pi i k n / N}
//   grad_y[b, t] = sum_f d frame_f[t - f * hop]   (the frames covering t)
//
// because d|X_k| / d x_n = w_n (re_k cos + (-im_k)(-sin)) / |X_k| =
// w_n Re(X_k e^{+i theta}) / |X_k|, theta = 2 pi k n / N. The real part of
// that half-spectrum sum is the inverse DFT of a Hermitian spectrum H:
// H_0 = Re G_0, H_{N/2} = Re G_{N/2} for even N (e^{i pi n} is real), and
// H_k = G_k / 2, H_{N-k} = conj(G_k) / 2 otherwise, so that each pair sums
// to Re(G_k e^{i theta}). The inverse runs on the forward core:
// IDFT(Q) = conj(DFT(conj Q)), unnormalised.
//
// The FFT core (fft_core.cuh, shared with istft.cu). A power-of-two N
// runs as a Stockham auto-sort FFT of L = N points in shared memory:
// radix-8 passes (radix 4 or 2 for the last bits), each thread loading
// its butterflies' inputs into registers, all threads meeting at
// __syncthreads, then writing the outputs in place, so one buffer serves
// (a pass is read whole before it is written). Any other N runs by
// Bluestein's chirp-z transform on the next power of two L >= 2N - 1,
// with nk = (n^2 + k^2 - (k - n)^2) / 2:
//
//   X[k] = c_k sum_n (x_n c_n) conj(c_{k - n}),  c_m = e^{-i pi m^2 / N}
//
// a circular convolution of length L: the FFT of the chirped, zero-padded
// input, times the filter spectrum FFT(conj c) / L, then the inverse FFT
// as conj(FFT(conj .)), then the output chirp. So one power-of-two core
// covers every N (key shifts give 2299 = 11 * 11 * 19, 1933 and 3251
// prime). Two real frames go through one complex transform, as its real
// and imaginary parts (z = x_f + i x_{f+1}), and are separated by conjugate
// symmetry: X_f[k] = (Z[k] + conj Z[N-k]) / 2, X_{f+1}[k] = (Z[k] - conj
// Z[N-k]) / 2i; an odd last frame pairs with zeros. The backward packs its
// two Hermitian spectra the same way (Q = H_f + i H_{f+1}): the real and
// imaginary parts of the inverse are the two frames' gradients. The FFT's
// rounding error scales with its whole input, so each frame of a pair goes
// in divided by a power of two above its own peak (|w y| forward, |G| for
// the inverse; exact) and comes out multiplied back: a quiet frame packed
// beside a loud one keeps its own relative accuracy.
//
// Precision. The forward runs in float32 (stft_magnitude) or, for
// training, in float64 (stft_magnitude_f64: the same kernel on double
// elements). The backward runs in float64: G needs the direction of X_k,
// and where |X_k| is 1e-6 of its frame's peak (training spectra span that)
// a float32 FFT's absolute error, ~1e-7 of the frame's norm, turns it by
// ~0.1 rad; g is largest exactly there under a log-mel loss. In float32
// any FFT (and the dense product) is then ~1e-4 of the gradient's scale
// off the exact function; in float64 the kernel is exact to the output's
// float32 rounding. The same error in a forward magnitude is a few percent
// of such a bin, which a log-mel loss's 1 / mel turns into gradient errors
// of 1e-3 of their scale and more: a training step's spectra are
// therefore exact in both directions. In float64 the shared memory
// doubles, so Bluestein sizes stop at L = 8192 (n_fft 4096).
//
// Lengths that do not fit in shared memory (the exact float64 transforms of
// L > 8192, so Bluestein above n_fft 4096; the float32 forward of a power
// of two above 8192) take the split path (stft_magnitude_split,
// stft_backward_split): the FFT of L = L1 L2 points as the four-step
// algorithm through a scratch buffer [pairs, L] in device memory. Transform
// A (natural order in): each of the L2 columns (stride L2) an L1-point FFT,
// times W_L^(n2 k1), then each row an L2-point FFT, which leaves X[k1 + L1
// k2] at k1 L2 + k2. Transform B takes that order in and gives the natural
// order out: each row an L2-point FFT times W_L^(n1 m2), then each column
// an L1-point FFT. A power of two runs A and reads X[k] at (k mod L1) L2 +
// k / L1; Bluestein runs A, the pointwise product with the filter spectrum
// (indexed by the element each position holds), then B. Each column or
// row is one block running the shared-memory Stockham core on its L1 or L2
// <= 2048 points, with that length's twiddles (every L2-th or L1-th entry
// of the L-point table) staged in shared memory. The loads, the spectra's
// split into magnitudes, the backward's spectrum gradient and its frames
// are one block per pair of frames, as in the shared-memory kernels, with
// the same scales; the overlap-add is the same gather.
//
// Tables built on the host in float64 (ops/mel.py _fft_tables), cast to
// float32 for the forward: the padded window (float32 values, as the plain
// version's basis uses), the twiddles e^{-2 pi i t / L}, and for Bluestein
// the chirp (its exponent reduced mod 2N in integers) and the filter
// spectrum with 1 / L folded in. No sine is computed on the card.
//
// Bound on an H100: at B = 4 x 1024 frames of n_fft 2048 the function needs
// ~0.5 GFLOP (2.5 N log2 N a frame) against ~25 MB of traffic: bytes, a few
// microseconds. Design: a block takes a run of FR consecutive frames
// (FR/2 pairs, one after another) and stages the run's magnitudes in
// shared memory, [bins][FR + 1] (a pad column keeps a warp's writes of
// consecutive bins on distinct banks), so that the stores run along f (the
// output is [B, bins, F]); the backward stages g the same way. The first
// radix-8 pass runs on the values as they arrive from device memory.
// Shared memory above 48 KB is dynamic; the buffer index is skewed by one
// element in eight (pad), which keeps the radix-8 passes' strided writes
// off common banks. The overlap-add of the backward is a gather in frame
// order over a [B, F, N] scratch (each output sample sums the
// <= ceil(N / hop) frames covering it, in increasing f), as K5 istft does:
// no atomics, so the result does not depend on the schedule. Only plain C++
// over threadIdx / blockIdx / blockDim, shared memory and __syncthreads,
// so tests/test_torch_csrc_emulated.py runs this file on the host.

#include <cuda_runtime.h>
#include "fft_core.cuh"

namespace {

constexpr double EPS = 1e-9;      // inside the magnitude's square root

// Frames f and f + 1 (zeros when second is false), windowed, as the real
// and imaginary parts of the transform's input, each divided by a power of
// two above its own peak (returned in scale). Chirped and zero-padded to L
// for Bluestein. The FFT's first radix-8 pass (p = 1: no twiddles) runs on
// the values as they arrive from device memory; returns the sub-transform
// length the FFT goes on from (1 when L < 8).
template <int V, class T>
__device__ __forceinline__ int load_pair(cplx<T>* buf, cplx<T>* red,
                                         const float* __restrict__ yb, int f, int hop,
                                         bool second, int N, int L,
                                         const float* __restrict__ window,
                                         const cplx<T>* __restrict__ chirp, cplx<T>& scale) {
  const float* y0 = yb + (size_t)f * hop;
  const float* y1 = y0 + hop;
  const int R = L < 8 ? 1 : 8;
  const int nb = L / R;
  T a[V / 8][8], c[V / 8][8];
  cplx<T> m = {0, 0};
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int n = j + r * nb;
      const bool in = j < nb && r < R && n < N;
      const T w = in ? (T)window[n] : (T)0;
      a[i][r] = in ? w * (T)y0[n] : (T)0;
      c[i][r] = in && second ? w * (T)y1[n] : (T)0;
      m = {tmax(m.x, tabs(a[i][r])), tmax(m.y, tabs(c[i][r]))};
    }
  }
  m = block_max(m, red);
  cplx<T> inv;
  pow2_above(m.x, scale.x, inv.x);
  pow2_above(m.y, scale.y, inv.y);
#pragma unroll
  for (int i = 0; i < V / 8; ++i) {
    const int j = threadIdx.x + i * blockDim.x;
    if (j < nb) {
      cplx<T> v[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        v[r] = {a[i][r] * inv.x, c[i][r] * inv.y};
        if (chirp && r < R && j + r * nb < N) v[r] = cmul(v[r], chirp[j + r * nb]);
      }
      if (R == 8) {
        butterfly<8>(v);
#pragma unroll
        for (int r = 0; r < 8; ++r) buf[pad(8 * j + r)] = v[r];
      } else {
        buf[pad(j)] = v[0];
      }
    }
  }
  __syncthreads();
  return R;
}

// The two frames' spectra at bin k from the packed transform, times their
// scales (load_pair).
template <class T>
__device__ __forceinline__ void split(const cplx<T>* buf, int k, int N,
                                      const cplx<T>* __restrict__ chirp, cplx<T> scale,
                                      cplx<T>& xf, cplx<T>& xg) {
  const cplx<T> zk = spectrum(buf, k, chirp);
  const cplx<T> zm = spectrum(buf, k == 0 ? 0 : N - k, chirp);
  const T hf = (T)0.5 * scale.x, hg = (T)0.5 * scale.y;
  xf = {hf * (zk.x + zm.x), hf * (zk.y - zm.y)};
  xg = {hg * (zk.y + zm.y), hg * (zm.x - zk.x)};
}

// The spectrum's gradients G = g X / sqrt(|X|^2 + 1e-9) of the two frames at
// bin k, g from the staged run (column fi, and fi + 1 when second).
template <class T>
__device__ __forceinline__ void spectrum_grad(const cplx<T>* buf, const float* stage, int k,
                                              int FR, int fi, bool second, int N,
                                              const cplx<T>* __restrict__ chirp,
                                              cplx<T> scale, cplx<T>& gf, cplx<T>& gg) {
  cplx<T> xf, xg;
  split(buf, k, N, chirp, scale, xf, xg);
  const T eps = (T)EPS;
  gf = cscale(xf, (T)stage[k * (FR + 1) + fi] / tsqrt(xf.x * xf.x + xf.y * xf.y + eps));
  gg = second ? cscale(xg, (T)stage[k * (FR + 1) + fi + 1]
                               / tsqrt(xg.x * xg.x + xg.y * xg.y + eps))
              : cplx<T>{0, 0};
}

// The kernels' register budgets: a thread holds V values in an FFT pass
// (blockDim.x = L / V threads, at least 64). Up to L = 2048, V = 8 and 3
// blocks of 256 threads a SM (<= 85 registers); L = 4096 and 8192,
// V = 16 and up to 128 registers for 512 threads; L = 16384 (the forward's
// Bluestein above n_fft 4096, off every path), V = 16 and 1024 threads
// (<= 64 registers).
constexpr int SMALL_T = 256;
constexpr int MID_T = 512;
constexpr int LARGE_T = 1024;

struct Geometry {
  int L, bins, FR, threads, smem;
};

// Shared memory: the buffer [buf_size(L)] and the reduction's [threads +
// 32] complex values of elem bytes, then the run's staging [bins][FR + 1]
// floats. Frames per block: 4 (two pairs), or 2 where the staging of 4
// does not fit; smem > MAX_SMEM when not even 2 do.
Geometry geometry(int n_fft, int L, int elem) {
  Geometry g;
  g.L = L;
  g.bins = n_fft / 2 + 1;
  g.threads = L <= 8 * SMALL_T ? (L / 8 < 64 ? 64 : L / 8) : L / 16;
  const int fixed = (buf_size(L) + g.threads + 32) * elem;
  g.FR = 4;
  while (g.FR > 2 && fixed + g.bins * (g.FR + 1) * (int)sizeof(float) > MAX_SMEM) g.FR /= 2;
  g.smem = fixed + g.bins * (g.FR + 1) * (int)sizeof(float);
  return g;
}

template <class T, int MAXT, int MINB, int V>
__global__ void __launch_bounds__(MAXT, MINB) stft_fwd_kernel(
    const float* __restrict__ y,       // [B, T_pad]
    const float* __restrict__ window,  // [N]
    const cplx<T>* __restrict__ tw,    // [L]
    const cplx<T>* __restrict__ chirp, // [N] or null (power of two)
    const cplx<T>* __restrict__ filt,  // [L] or null
    float* __restrict__ out,           // [B, bins, F]
    int T_pad, int N, int L, int hop, int F, int FR) {
  extern __shared__ float smem[];
  cplx<T>* buf = reinterpret_cast<cplx<T>*>(smem);
  cplx<T>* red = buf + buf_size(L);
  float* stage = reinterpret_cast<float*>(red + blockDim.x + 32);  // [bins][FR + 1]
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FR;
  const int nv = F - f0 < FR ? F - f0 : FR;
  const int bins = N / 2 + 1;
  const float* yb = y + (size_t)b * T_pad;

  for (int fi = 0; fi < nv; fi += 2) {
    const bool second = fi + 1 < nv;
    cplx<T> scale;
    const int p0 = load_pair<V>(buf, red, yb, f0 + fi, hop, second, N, L, window, chirp,
                                scale);
    transform<V>(buf, L, tw, filt, p0);
    for (int k = threadIdx.x; k < bins; k += blockDim.x) {
      cplx<T> xf, xg;
      split(buf, k, N, chirp, scale, xf, xg);
      stage[k * (FR + 1) + fi] = (float)tsqrt(xf.x * xf.x + xf.y * xf.y + (T)EPS);
      if (second)
        stage[k * (FR + 1) + fi + 1] = (float)tsqrt(xg.x * xg.x + xg.y * xg.y + (T)EPS);
    }
    __syncthreads();  // buf is read whole before the next pair loads
  }
  float* ob = out + (size_t)b * bins * F + f0;
  for (int e = threadIdx.x; e < bins * nv; e += blockDim.x) {
    const int k = e / nv, i = e - k * nv;
    ob[(size_t)k * F + i] = stage[k * (FR + 1) + i];
  }
}

template <int MAXT, int MINB, int V>
__global__ void __launch_bounds__(MAXT, MINB) stft_bwd_kernel(
    const float* __restrict__ g,       // [B, bins, F]
    const float* __restrict__ y,       // [B, T_pad]
    const float* __restrict__ window,  // [N]
    const cd* __restrict__ tw, const cd* __restrict__ chirp,
    const cd* __restrict__ filt,       // float64 tables
    float* __restrict__ frames,        // [B, F, N]: each frame's gradient
    int T_pad, int N, int L, int hop, int F, int FR) {
  extern __shared__ float smem[];
  cd* buf = reinterpret_cast<cd*>(smem);
  cd* red = buf + buf_size(L);
  float* stage = reinterpret_cast<float*>(red + blockDim.x + 32);  // g, [bins][FR + 1]
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FR;
  const int nv = F - f0 < FR ? F - f0 : FR;
  const int bins = N / 2 + 1;
  const float* yb = y + (size_t)b * T_pad;

  const float* gb = g + (size_t)b * bins * F + f0;
  for (int e = threadIdx.x; e < bins * nv; e += blockDim.x) {
    const int k = e / nv, i = e - k * nv;
    stage[k * (FR + 1) + i] = gb[(size_t)k * F + i];
  }
  for (int fi = 0; fi < nv; fi += 2) {
    const bool second = fi + 1 < nv;
    cd scale;
    const int p0 = load_pair<V>(buf, red, yb, f0 + fi, hop, second, N, L, window, chirp,
                                scale);
    transform<V>(buf, L, tw, filt, p0);
    // each frame's G peak, for the packed inverse's scales
    cd m = {0, 0};
    for (int k = threadIdx.x; k < bins; k += blockDim.x) {
      cd gf, gg;
      spectrum_grad(buf, stage, k, FR, fi, second, N, chirp, scale, gf, gg);
      m = {tmax(m.x, tmax(tabs(gf.x), tabs(gf.y))), tmax(m.y, tmax(tabs(gg.x), tabs(gg.y)))};
    }
    m = block_max(m, red);
    cd gs, inv;
    pow2_above(m.x, gs.x, inv.x);
    pow2_above(m.y, gs.y, inv.y);
    // conj(Q), Q = H_f / gs.x + i H_{f+1} / gs.y; each thread reads and
    // writes only slots k and N - k
    for (int k = threadIdx.x; k < bins; k += blockDim.x) {
      cd gf, gg;
      spectrum_grad(buf, stage, k, FR, fi, second, N, chirp, scale, gf, gg);
      gf = cscale(gf, inv.x);
      gg = cscale(gg, inv.y);
      if (k == 0 || 2 * k == N) {
        cd q = {gf.x, -gg.x};
        if (chirp) q = cmul(q, chirp[k]);
        buf[pad(k)] = q;
      } else {
        cd q = {0.5 * (gf.x - gg.y), -0.5 * (gf.y + gg.x)};
        cd qm = {0.5 * (gf.x + gg.y), 0.5 * (gf.y - gg.x)};
        if (chirp) {
          q = cmul(q, chirp[k]);
          qm = cmul(qm, chirp[N - k]);
        }
        buf[pad(k)] = q;
        buf[pad(N - k)] = qm;
      }
    }
    for (int n = N + threadIdx.x; n < L; n += blockDim.x) buf[pad(n)] = {0, 0};
    __syncthreads();
    transform<V>(buf, L, tw, filt);
    float* out0 = frames + ((size_t)b * F + f0 + fi) * N;
    for (int n = threadIdx.x; n < N; n += blockDim.x) {
      const cd r = spectrum(buf, n, chirp);
      const double w = window[n];
      out0[n] = (float)(w * gs.x * r.x);
      if (second) out0[N + n] = (float)(-w * gs.y * r.y);
    }
    __syncthreads();
  }
}

constexpr int OLA_THREADS = 256;

// grad[b, t] = sum over the frames f covering t, in increasing f, of
// frames[b, f, t - f * hop]; 0 where no frame reads t.
__global__ void __launch_bounds__(OLA_THREADS) overlap_add(
    const float* __restrict__ frames, float* __restrict__ grad, int T_pad,
    int N, int hop, int F) {
  const int b = blockIdx.y;
  const int t = blockIdx.x * OLA_THREADS + threadIdx.x;
  if (t >= T_pad) return;
  const int f_lo = t >= N ? (t - N) / hop + 1 : 0;
  const int f_hi = t / hop < F - 1 ? t / hop : F - 1;
  const float* fb = frames + (size_t)b * F * N;
  float acc = 0.f;
  for (int f = f_lo; f <= f_hi; ++f) acc += fb[(size_t)f * N + (t - f * hop)];
  grad[(size_t)b * T_pad + t] = acc;
}


template <class T, int MAXT, int MINB, int V>
void launch_forward(const Geometry& geo, dim3 grid, cudaStream_t s, const float* y,
                    const float* window, const cplx<T>* tw, const cplx<T>* chirp,
                    const cplx<T>* filt, float* out, int T_pad, int N, int hop, int F) {
  static bool done = false;
  allow_smem(stft_fwd_kernel<T, MAXT, MINB, V>, done);
  stft_fwd_kernel<T, MAXT, MINB, V><<<grid, geo.threads, geo.smem, s>>>(
      y, window, tw, chirp, filt, out, T_pad, N, geo.L, hop, F, geo.FR);
}

template <int MAXT, int MINB, int V>
void launch_backward(const Geometry& geo, dim3 grid, cudaStream_t s, const float* g,
                     const float* y, const float* window, const cd* tw,
                     const cd* chirp, const cd* filt, float* frames, int T_pad,
                     int N, int hop, int F) {
  static bool done = false;
  allow_smem(stft_bwd_kernel<MAXT, MINB, V>, done);
  stft_bwd_kernel<MAXT, MINB, V><<<grid, geo.threads, geo.smem, s>>>(
      g, y, window, tw, chirp, filt, frames, T_pad, N, geo.L, hop, F, geo.FR);
}

bool valid(int n_fft, int L) {
  return n_fft >= 1 && L <= MAX_L && L >= n_fft && (L & (L - 1)) == 0
         && (L == n_fft || L >= 2 * n_fft - 1);
}


// Frames f and f + 1 of pair (blockIdx.x, batch item blockIdx.y), windowed,
// each divided by a power of two above its own peak (scales), chirped for
// Bluestein, zero-padded to L, into the pair's buffer in natural order.
template <class T>
__global__ void __launch_bounds__(SPLIT_T) split_load(
    const float* __restrict__ y, const float* __restrict__ window,
    const cplx<T>* __restrict__ chirp, cplx<T>* __restrict__ work,
    cplx<T>* __restrict__ scales, int T_pad, int N, int L, int hop, int F) {
  __shared__ cplx<T> red[SPLIT_T + 32];
  const int pairs = (F + 1) / 2;
  const int f = 2 * blockIdx.x;
  const bool second = f + 1 < F;
  const size_t pi = (size_t)blockIdx.y * pairs + blockIdx.x;
  const float* y0 = y + (size_t)blockIdx.y * T_pad + (size_t)f * hop;
  const float* y1 = y0 + hop;
  cplx<T> m = {0, 0};
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const T w = (T)window[n];
    m = {tmax(m.x, tabs(w * (T)y0[n])), second ? tmax(m.y, tabs(w * (T)y1[n])) : m.y};
  }
  m = block_max(m, red);
  cplx<T> scale, inv;
  pow2_above(m.x, scale.x, inv.x);
  pow2_above(m.y, scale.y, inv.y);
  if (threadIdx.x == 0) scales[pi] = scale;
  cplx<T>* buf = work + pi * L;
  for (int n = threadIdx.x; n < L; n += blockDim.x) {
    cplx<T> v = {0, 0};
    if (n < N) {
      const T w = (T)window[n];
      v = {w * (T)y0[n] * inv.x, second ? w * (T)y1[n] * inv.y : (T)0};
      if (chirp) v = cmul(v, chirp[n]);
    }
    buf[n] = v;
  }
}

// The two frames' spectra at bin k of pair pi, times their scales.
template <class T>
__device__ __forceinline__ void split_split(const cplx<T>* buf, int k, int N,
                                            const cplx<T>* __restrict__ chirp, int L1, int L2,
                                            cplx<T> scale, cplx<T>& xf, cplx<T>& xg) {
  const cplx<T> zk = split_spectrum(buf, k, chirp, L1, L2);
  const cplx<T> zm = split_spectrum(buf, k == 0 ? 0 : N - k, chirp, L1, L2);
  const T hf = (T)0.5 * scale.x, hg = (T)0.5 * scale.y;
  xf = {hf * (zk.x + zm.x), hf * (zk.y - zm.y)};
  xg = {hg * (zk.y + zm.y), hg * (zm.x - zk.x)};
}

template <class T>
__global__ void __launch_bounds__(SPLIT_T) split_magnitude(
    const cplx<T>* __restrict__ work, const cplx<T>* __restrict__ chirp,
    const cplx<T>* __restrict__ scales, float* __restrict__ out, int N, int L1, int L2,
    int F) {
  const int pairs = (F + 1) / 2;
  const int f = 2 * blockIdx.x;
  const bool second = f + 1 < F;
  const size_t pi = (size_t)blockIdx.y * pairs + blockIdx.x;
  const int bins = N / 2 + 1;
  const cplx<T>* buf = work + pi * ((size_t)L1 * L2);
  float* ob = out + (size_t)blockIdx.y * bins * F + f;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    cplx<T> xf, xg;
    split_split(buf, k, N, chirp, L1, L2, scales[pi], xf, xg);
    ob[(size_t)k * F] = (float)tsqrt(xf.x * xf.x + xf.y * xf.y + (T)EPS);
    if (second) ob[(size_t)k * F + 1] = (float)tsqrt(xg.x * xg.x + xg.y * xg.y + (T)EPS);
  }
}

// The spectrum gradients G = g X / |X| of pair pi's two frames at bin k.
__device__ __forceinline__ void split_grad(const cd* buf, const float* __restrict__ g, int k,
                                           int N, const cd* __restrict__ chirp, int L1, int L2,
                                           cd scale, size_t gi, int F, bool second, cd& gf,
                                           cd& gg) {
  cd xf, xg;
  split_split(buf, k, N, chirp, L1, L2, scale, xf, xg);
  gf = cscale(xf, (double)g[gi + (size_t)k * F] / tsqrt(xf.x * xf.x + xf.y * xf.y + EPS));
  gg = second ? cscale(xg, (double)g[gi + (size_t)k * F + 1]
                               / tsqrt(xg.x * xg.x + xg.y * xg.y + EPS))
              : cd{0, 0};
}

// The backward's inverse input: conj(Q), Q = H_f / gs.x + i H_{f+1} / gs.y
// (the Hermitian spectra of the two frames' gradients, each scaled to its
// own peak), chirped for Bluestein, zero-padded, into work2 in natural order.
__global__ void __launch_bounds__(SPLIT_T) split_grad_spectrum(
    const cd* __restrict__ work, const float* __restrict__ g, const cd* __restrict__ chirp,
    const cd* __restrict__ scales, cd* __restrict__ work2, cd* __restrict__ gscales, int N,
    int L1, int L2, int F) {
  __shared__ cd red[SPLIT_T + 32];
  const int pairs = (F + 1) / 2;
  const int f = 2 * blockIdx.x;
  const bool second = f + 1 < F;
  const size_t pi = (size_t)blockIdx.y * pairs + blockIdx.x;
  const int bins = N / 2 + 1;
  const int L = L1 * L2;
  const cd* buf = work + pi * L;
  const size_t gi = (size_t)blockIdx.y * bins * F + f;
  const cd scale = scales[pi];
  cd m = {0, 0};
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    cd gf, gg;
    split_grad(buf, g, k, N, chirp, L1, L2, scale, gi, F, second, gf, gg);
    m = {tmax(m.x, tmax(tabs(gf.x), tabs(gf.y))), tmax(m.y, tmax(tabs(gg.x), tabs(gg.y)))};
  }
  m = block_max(m, red);
  cd gs, inv;
  pow2_above(m.x, gs.x, inv.x);
  pow2_above(m.y, gs.y, inv.y);
  if (threadIdx.x == 0) gscales[pi] = gs;
  cd* out = work2 + pi * L;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    cd gf, gg;
    split_grad(buf, g, k, N, chirp, L1, L2, scale, gi, F, second, gf, gg);
    gf = cscale(gf, inv.x);
    gg = cscale(gg, inv.y);
    if (k == 0 || 2 * k == N) {
      cd q = {gf.x, -gg.x};
      if (chirp) q = cmul(q, chirp[k]);
      out[k] = q;
    } else {
      cd q = {0.5 * (gf.x - gg.y), -0.5 * (gf.y + gg.x)};
      cd qm = {0.5 * (gf.x + gg.y), 0.5 * (gf.y - gg.x)};
      if (chirp) {
        q = cmul(q, chirp[k]);
        qm = cmul(qm, chirp[N - k]);
      }
      out[k] = q;
      out[N - k] = qm;
    }
  }
  for (int n = N + threadIdx.x; n < L; n += blockDim.x) out[n] = {0, 0};
}

// Each frame's gradient w[n] gs Re / -Im of the inverse, into frames
// [B, F, N].
__global__ void __launch_bounds__(SPLIT_T) split_frames(
    const cd* __restrict__ work2, const cd* __restrict__ chirp,
    const float* __restrict__ window, const cd* __restrict__ gscales,
    float* __restrict__ frames, int N, int L1, int L2, int F) {
  const int pairs = (F + 1) / 2;
  const int f = 2 * blockIdx.x;
  const bool second = f + 1 < F;
  const size_t pi = (size_t)blockIdx.y * pairs + blockIdx.x;
  const cd* buf = work2 + pi * ((size_t)L1 * L2);
  const cd gs = gscales[pi];
  float* out0 = frames + ((size_t)blockIdx.y * F + f) * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const cd r = split_spectrum(buf, n, chirp, L1, L2);
    const double w = window[n];
    out0[n] = (float)(w * gs.x * r.x);
    if (second) out0[N + n] = (float)(-w * gs.y * r.y);
  }
}


bool split_valid(int n_fft, int L, int L1) {
  return n_fft >= 1 && L >= n_fft && (L & (L - 1)) == 0 && L <= MAX_L_SPLIT
         && (L == n_fft || L >= 2 * n_fft - 1) && L1 >= 1 && (L1 & (L1 - 1)) == 0
         && L % L1 == 0 && L1 <= MAX_SUB && L / L1 <= MAX_SUB;
}

template <class T>
int split_forward(const float* y, const float* window, const cplx<T>* tw,
                  const cplx<T>* chirp, const cplx<T>* filt, cplx<T>* work, cplx<T>* scales,
                  float* out, int B, int T_pad, int N, int L, int L1, int hop, int F,
                  cudaStream_t s) {
  const int pairs = (F + 1) / 2;
  const dim3 grid(pairs, B);
  split_load<T><<<grid, SPLIT_T, 0, s>>>(y, window, chirp, work, scales, T_pad, N, L, hop, F);
  const int err = split_transform<T>(work, tw, filt, pairs * B, L1, L / L1, s);
  if (err != 0) return err;
  split_magnitude<T><<<grid, SPLIT_T, 0, s>>>(work, chirp, scales, out, N, L1, L / L1, F);
  return (int)cudaGetLastError();
}

}  // namespace

// y [B, T_pad]; window [n_fft]; twiddle [L] complex; chirp [n_fft] and filt
// [L] complex, or both null when L == n_fft (a power of two), all float32;
// out [B, n_fft / 2 + 1, F] with F = (T_pad - n_fft) / hop + 1. Contiguous
// (the Python wrapper checks). Returns the cudaError_t of the launch, or
// cudaErrorInvalidValue for an L the kernel does not take.
extern "C" int stft_magnitude(const void* y, const void* window,
                              const void* twiddle, const void* chirp,
                              const void* filt, void* out, int B, int T_pad,
                              int n_fft, int L, int hop, int F, void* stream) {
  const Geometry geo = geometry(n_fft, L, (int)sizeof(cf));
  if (!valid(n_fft, L) || geo.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + geo.FR - 1) / geo.FR, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* yp = (const float*)y;
  const float* wp = (const float*)window;
  const cf* tp = (const cf*)twiddle;
  const cf* cp = (const cf*)chirp;
  const cf* fp = (const cf*)filt;
  float* op = (float*)out;
  if (L <= 8 * SMALL_T)
    launch_forward<float, SMALL_T, 3, 8>(geo, grid, s, yp, wp, tp, cp, fp, op, T_pad, n_fft, hop, F);
  else if (L <= 16 * MID_T)
    launch_forward<float, MID_T, 1, 16>(geo, grid, s, yp, wp, tp, cp, fp, op, T_pad, n_fft, hop, F);
  else
    launch_forward<float, LARGE_T, 1, 16>(geo, grid, s, yp, wp, tp, cp, fp, op, T_pad, n_fft, hop, F);
  return (int)cudaGetLastError();
}

// stft_magnitude in float64 (exact to the output's float32 rounding): the
// same arguments, but twiddle, chirp and filt float64 and L at most 8192
// (n_fft a power of two up to 8192, any other up to 4096), as for
// stft_backward.
extern "C" int stft_magnitude_f64(const void* y, const void* window,
                                  const void* twiddle, const void* chirp,
                                  const void* filt, void* out, int B, int T_pad,
                                  int n_fft, int L, int hop, int F, void* stream) {
  const Geometry geo = geometry(n_fft, L, (int)sizeof(cd));
  if (!valid(n_fft, L) || L > 16 * MID_T || geo.smem > MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((F + geo.FR - 1) / geo.FR, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* yp = (const float*)y;
  const float* wp = (const float*)window;
  const cd* tp = (const cd*)twiddle;
  const cd* cp = (const cd*)chirp;
  const cd* fp = (const cd*)filt;
  float* op = (float*)out;
  if (L <= 8 * SMALL_T)
    launch_forward<double, SMALL_T, 3, 8>(geo, grid, s, yp, wp, tp, cp, fp, op, T_pad, n_fft,
                                          hop, F);
  else
    launch_forward<double, MID_T, 1, 16>(geo, grid, s, yp, wp, tp, cp, fp, op, T_pad, n_fft,
                                         hop, F);
  return (int)cudaGetLastError();
}

// g [B, n_fft / 2 + 1, F] (the magnitude's gradient), y [B, T_pad] (the
// forward's signal), window [n_fft] float32, the other tables as for
// stft_magnitude but float64, frames [B, F, n_fft] (scratch), grad
// [B, T_pad]: every sample is written, those no frame reads with 0. Two
// launches: the frames' gradients, then their overlap-add. Returns the
// cudaError_t of the launches, or cudaErrorInvalidValue for an L the
// kernel does not take (a float64 buffer of L = 16384 does not fit).
extern "C" int stft_backward(const void* g, const void* y, const void* window,
                             const void* twiddle, const void* chirp,
                             const void* filt, void* frames, void* grad, int B,
                             int T_pad, int n_fft, int L, int hop, int F,
                             void* stream) {
  const Geometry geo = geometry(n_fft, L, (int)sizeof(cd));
  if (!valid(n_fft, L) || geo.smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const dim3 grid((F + geo.FR - 1) / geo.FR, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* gp = (const float*)g;
  const float* yp = (const float*)y;
  const float* wp = (const float*)window;
  const cd* tp = (const cd*)twiddle;
  const cd* cp = (const cd*)chirp;
  const cd* fp = (const cd*)filt;
  float* fr = (float*)frames;
  if (L <= 8 * SMALL_T)
    launch_backward<SMALL_T, 3, 8>(geo, grid, s, gp, yp, wp, tp, cp, fp, fr, T_pad, n_fft,
                                   hop, F);
  else
    launch_backward<MID_T, 1, 16>(geo, grid, s, gp, yp, wp, tp, cp, fp, fr, T_pad, n_fft,
                                  hop, F);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid2((T_pad + OLA_THREADS - 1) / OLA_THREADS, B);
  overlap_add<<<grid2, OLA_THREADS, 0, s>>>(fr, (float*)grad, T_pad, n_fft,
                                            hop, F);
  return (int)cudaGetLastError();
}

// 1 when stft_magnitude (elem 8: float32 tables), stft_magnitude_f64 and
// stft_backward (elem 16) take (n_fft, L) in shared memory, else 0: then
// the *_split entries do.
extern "C" int stft_fits_shared(int n_fft, int L, int elem) {
  const Geometry geo = geometry(n_fft, L, elem);
  return valid(n_fft, L) && geo.smem <= MAX_SMEM && (elem == (int)sizeof(cf) || L <= 16 * MID_T);
}

// stft_magnitude (double = 0: float32 tables) or stft_magnitude_f64
// (double = 1: float64 tables) on the split path, L = L1 x (L / L1), both
// at most 2048. work [B, (F + 1) / 2, L] and scales [B, (F + 1) / 2]
// complex of the tables' type are scratch. Returns the cudaError_t of the
// launches, or cudaErrorInvalidValue for a split the kernels do not take.
extern "C" int stft_magnitude_split(const void* y, const void* window, const void* twiddle,
                                    const void* chirp, const void* filt, void* work,
                                    void* scales, void* out, int B, int T_pad, int n_fft,
                                    int L, int L1, int hop, int F, int is_double,
                                    void* stream) {
  if (!split_valid(n_fft, L, L1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_double)
    return split_forward<double>((const float*)y, (const float*)window, (const cd*)twiddle,
                                 (const cd*)chirp, (const cd*)filt, (cd*)work, (cd*)scales,
                                 (float*)out, B, T_pad, n_fft, L, L1, hop, F, s);
  return split_forward<float>((const float*)y, (const float*)window, (const cf*)twiddle,
                              (const cf*)chirp, (const cf*)filt, (cf*)work, (cf*)scales,
                              (float*)out, B, T_pad, n_fft, L, L1, hop, F, s);
}

// stft_backward on the split path (float64 tables): work and work2
// [B, (F + 1) / 2, L], scales and gscales [B, (F + 1) / 2] complex float64
// are scratch; frames and grad as for stft_backward.
extern "C" int stft_backward_split(const void* g, const void* y, const void* window,
                                   const void* twiddle, const void* chirp, const void* filt,
                                   void* work, void* work2, void* scales, void* gscales,
                                   void* frames, void* grad, int B, int T_pad, int n_fft,
                                   int L, int L1, int hop, int F, void* stream) {
  if (!split_valid(n_fft, L, L1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int pairs = (F + 1) / 2;
  const int L2 = L / L1;
  const cd* tw = (const cd*)twiddle;
  const cd* cp = (const cd*)chirp;
  const cd* fp = (const cd*)filt;
  cd* w1 = (cd*)work;
  cd* w2 = (cd*)work2;
  const dim3 grid(pairs, B);
  split_load<double><<<grid, SPLIT_T, 0, s>>>((const float*)y, (const float*)window, cp, w1,
                                              (cd*)scales, T_pad, n_fft, L, hop, F);
  int err = split_transform<double>(w1, tw, fp, pairs * B, L1, L2, s);
  if (err != 0) return err;
  split_grad_spectrum<<<grid, SPLIT_T, 0, s>>>(w1, (const float*)g, cp, (const cd*)scales, w2,
                                               (cd*)gscales, n_fft, L1, L2, F);
  err = split_transform<double>(w2, tw, fp, pairs * B, L1, L2, s);
  if (err != 0) return err;
  split_frames<<<grid, SPLIT_T, 0, s>>>(w2, cp, (const float*)window, (const cd*)gscales,
                                        (float*)frames, n_fft, L1, L2, F);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const dim3 grid2((T_pad + OLA_THREADS - 1) / OLA_THREADS, B);
  overlap_add<<<grid2, OLA_THREADS, 0, s>>>((const float*)frames, (float*)grad, T_pad, n_fft,
                                            hop, F);
  return (int)cudaGetLastError();
}
