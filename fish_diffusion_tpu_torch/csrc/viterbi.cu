// K8 (candidate decoder): praat's path finder over per-frame pitch
// candidates, the max-product Viterbi recursion with a backtrack.
//
// Replaces fish_diffusion_tpu/extractors/pitch.py:_viterbi_candidates (its
// two lax.scan passes, forward and reverse), which Harvest runs on every
// segment (extractors/world.py:_harvest_finalize).
//
// States per frame: K voiced candidates (freqs, strengths) and one unvoiced
// state (frequency 0, strength unvoiced[t]). With S = K + 1,
//   delta_0[j] = strength_0[j],
//   delta_t[j] = max_i (delta_{t-1}[i] - cost(f_{t-1}[i], f_t[j])) + strength_t[j],
//   cost = 0.35 |log2 f - log2 f'| between two voiced states, 0.14 at a
//   voicing flip, 0 between two unvoiced states;
// the path ends at the first argmax of delta_{T-1} and follows the
// backpointers. f0 is the frequency of the state on the path.
//
// Bound on an H100: latency. The recursion is a chain of T - 1 dependent
// steps of S x S compares (T <= 2600 frames at 30 s, S = 5 for Harvest);
// bytes (9 floats in, 2 words out per frame) and operations are
// negligible. Design: one block per item, one thread per next state, the
// scores and the previous frame's log2 frequencies in shared memory, one
// __syncthreads pair per frame; the next frame's inputs are loaded while
// the current one is reduced. Previous states are scanned in order and a
// score replaces the best only when strictly greater, so ties resolve to
// the first index, as jnp.argmax and torch.max do. The arithmetic uses
// __fsub_rn / __fmul_rn / __fadd_rn so that no step is contracted into an
// FMA: the kernel then rounds exactly as the plain PyTorch version and the
// paths agree bit for bit. Backpointers go to a scratch buffer
// [B, T - 1, S] that the wrapper allocates; thread 0 backtracks.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // one warp; S <= 32 states

__global__ void __launch_bounds__(THREADS) viterbi_kernel(
    const float* __restrict__ freqs,      // [B, T, K]
    const float* __restrict__ strengths,  // [B, T, K]
    const float* __restrict__ unvoiced,   // [B, T]
    int* __restrict__ backptr,            // [B, T - 1, K + 1] scratch
    int* __restrict__ path,               // [B, T]
    float* __restrict__ f0,               // [B, T]
    int T, int K) {
  __shared__ float delta[THREADS];
  __shared__ float lp_prev[THREADS];
  __shared__ int voiced_prev[THREADS];

  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int S = K + 1;
  const bool active = j < S;
  const float* fr = freqs + (size_t)b * T * K;
  const float* st = strengths + (size_t)b * T * K;
  const float* uv = unvoiced + (size_t)b * T;
  int* bp = backptr + (size_t)b * (T - 1) * S;

  // state j of frame t: (frequency, strength)
  auto load = [&](int t, float& f, float& s) {
    if (j < K) {
      f = fr[(size_t)t * K + j];
      s = st[(size_t)t * K + j];
    } else {
      f = 0.f;
      s = uv[t];
    }
  };

  float f_next = 0.f, s_next = 0.f;
  if (active) {
    float f, s;
    load(0, f, s);
    delta[j] = s;
    lp_prev[j] = log2f(fmaxf(f, 1e-6f));
    voiced_prev[j] = f > 0.f;
    if (T > 1) load(1, f_next, s_next);
  }
  __syncthreads();

  for (int t = 1; t < T; ++t) {
    const float fn = f_next, sn = s_next;
    float best = 0.f, lpn = 0.f;
    int vn = 0;
    if (active) {
      if (t + 1 < T) load(t + 1, f_next, s_next);
      lpn = log2f(fmaxf(fn, 1e-6f));
      vn = fn > 0.f;
      int arg = 0;
      for (int i = 0; i < S; ++i) {
        const int vp = voiced_prev[i];
        float cost = 0.f;
        if (vp && vn)
          cost = __fmul_rn(0.35f, fabsf(__fsub_rn(lp_prev[i], lpn)));
        else if (vp != vn)
          cost = 0.14f;
        const float score = __fsub_rn(delta[i], cost);
        if (i == 0 || score > best) {
          best = score;
          arg = i;
        }
      }
      bp[(size_t)(t - 1) * S + j] = arg;
    }
    __syncthreads();
    if (active) {
      delta[j] = __fadd_rn(best, sn);
      lp_prev[j] = lpn;
      voiced_prev[j] = vn;
    }
    __syncthreads();
  }

  if (j == 0) {
    int state = 0;
    for (int i = 1; i < S; ++i)
      if (delta[i] > delta[state]) state = i;
    for (int t = T - 1;; --t) {
      path[(size_t)b * T + t] = state;
      f0[(size_t)b * T + t] = state < K ? fr[(size_t)t * K + state] : 0.f;
      if (t == 0) break;
      state = bp[(size_t)(t - 1) * S + state];
    }
  }
}

}  // namespace

// freqs, strengths [B, T, K], unvoiced [B, T] float32; backptr scratch
// [B, T - 1, K + 1] int32; path [B, T] int32 and f0 [B, T] float32 out.
// The Python wrapper checks K + 1 <= 32 and contiguity. Returns the
// cudaError_t of the launch.
extern "C" int viterbi_candidates(const void* freqs, const void* strengths,
                                  const void* unvoiced, void* backptr,
                                  void* path, void* f0, int B, int T, int K,
                                  void* stream) {
  viterbi_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)freqs, (const float*)strengths, (const float*)unvoiced,
      (int*)backptr, (int*)path, (float*)f0, T, K);
  return (int)cudaGetLastError();
}
