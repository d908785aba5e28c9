// K5 istft: the inverse STFT by windowed overlap-add, as a gather.
//
// Replaces fish_diffusion_tpu/ops/mel.py:istft, which took jnp.fft.irfft of
// every frame, multiplied it by the window and scatter-added the frames at
// frame * hop before dividing by the window-square envelope.
//
//   frame[b, f, n] = (1 / n_fft) sum_k c_k (re[b, k, f] basis[k, n]
//                                           + im[b, k, f] basis[bins + k, n])
//   y[b, t] = (sum_{f : 0 <= t - f * hop < n_fft} frame[b, f, t - f * hop])
//             / env[t],                                      k < bins
//
// with basis the windowed DFT [2 * bins, n_fft] of K5's forward (cos * w
// rows, then -sin * w rows: the transpose of the forward's operand), c_k = 2
// but for bin 0 and, for an even n_fft, the Nyquist bin (whose imaginary
// parts irfft ignores: their sin rows are 0), env the window-square
// envelope max(sum_f w[t - f * hop]^2, 1e-11), built and cached on the host,
// and the output trimmed by n_fft / 2 at each end when centred (offset).
//
// Bound on an H100: bytes at the iSTFTNet shapes (n_fft 16, hop 8: 36
// products per output sample against 18 spectrum values read per 8
// samples); arithmetic at n_fft 2048 (8200 products per sample).
// Design: one thread per output sample. It sums the <= ceil(n_fft / hop)
// frames that cover its sample in frame order, so the overlap-add needs
// no atomics and its order is fixed. Neighbouring threads read
// neighbouring basis entries (one row of the basis per bin) and, mostly,
// the same spectrum values (a warp spans 32 / hop + 1 frames), which the
// cache broadcasts. The frames never reach device memory. Any n_fft, hop
// and frame count work (runtime integers).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
istft_gather(const float* __restrict__ re, const float* __restrict__ im,
             const float* __restrict__ basis, const float* __restrict__ env,
             float* __restrict__ out, int F, int n_fft, int hop, int bins,
             int L, int offset) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= L) return;
  const int t = i + offset;
  const int f_lo = t >= n_fft ? (t - n_fft) / hop + 1 : 0;
  const int f_hi = t / hop < F ? t / hop : F - 1;
  const float* re_b = re + (size_t)b * bins * F;
  const float* im_b = im + (size_t)b * bins * F;
  const float inv_n = 1.f / (float)n_fft;
  float acc = 0.f;
  for (int f = f_lo; f <= f_hi; ++f) {
    const int n = t - f * hop;
    float s = 0.f;
    for (int k = 0; k < bins; ++k) {
      const float c = (k == 0 || 2 * k == n_fft) ? 1.f : 2.f;
      const float v = re_b[(size_t)k * F + f] * basis[(size_t)k * n_fft + n]
                      + im_b[(size_t)k * F + f] * basis[(size_t)(bins + k) * n_fft + n];
      s += c * v;
    }
    acc += s * inv_n;
  }
  out[(size_t)b * L + i] = acc / env[t];
}

}  // namespace

// re, im [B, bins, F]; basis [2 * bins, n_fft]; env [n_fft + hop * (F - 1)];
// out [B, L] with L the samples kept after the trim (offset = n_fft / 2 when
// centred, else 0). All float32 and contiguous (the Python wrapper checks).
// Returns the cudaError_t of the launch.
extern "C" int istft(const void* re, const void* im, const void* basis,
                     const void* env, void* out, int B, int F, int n_fft,
                     int hop, int bins, int L, int offset, void* stream) {
  dim3 grid((L + THREADS - 1) / THREADS, B);
  istft_gather<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)re, (const float*)im, (const float*)basis,
      (const float*)env, (float*)out, F, n_fft, hop, bins, L, offset);
  return (int)cudaGetLastError();
}
