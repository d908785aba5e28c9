// K8 (dense decoder): the max-product Viterbi recursion over a dense
// [S, S] log-transition matrix, with a backtrack.
//
// Replaces fish_diffusion_tpu/extractors/pitch.py:_pyin_viterbi (pYIN:
// S = 2 x 215 pitch bins, voiced and unvoiced) and
// fish_diffusion_tpu/extractors/crepe.py:_viterbi_path (CREPE: S = 360
// pitch bins), each two lax.scan passes, forward and reverse. Given
// delta_0 [S] (the wrappers form it: obs_0 for pYIN, -log(S) + obs_0 for
// CREPE),
//   delta_t[j] = max_i (delta_{t-1}[i] + A[i, j]) + obs_t[j],
// the path ends at the first argmax of delta_{T-1} and follows the
// backpointers. The matrix stays dense: its off-band entries are
// log(1e-30) (pYIN) or log(1e-12) (CREPE), not -inf, so the maximum may
// legally come from any previous state. -inf observations (CREPE's masked
// bins) pass through.
//
// Bound on an H100: one item is a chain of T - 1 dependent frames of S^2
// adds and compares; 2 T S^2 operations over one SM's share of the
// float32 rate (67 TFLOP/s / 132) is ~0.75 ms for pYIN's 1025 x 430. In
// practice the matrix (0.5-0.74 MB, too large for one SM's shared memory)
// is read again from L2 every frame, so the chain runs at one SM's L2
// bandwidth if enough loads are in flight. Design: one block per item;
// ``lanes`` (S rounded up to a warp) threads per part, one per next state
// j, and ``parts`` parts (as many as fit in 1024 threads, at most 8) that
// each scan a contiguous range of previous states; each thread issues
// BATCH independent loads of its column of A (coalesced over j) before it
// reduces them, so that ~900 threads keep ~16 loads each in flight. Part 0
// merges the parts in order. delta is double-buffered in shared memory.
// Within a part previous states are scanned in order and a score replaces
// the best only when strictly greater, and the merge takes a later part
// only when strictly greater: ties take the first index, as jnp.argmax
// and torch.max do. The adds use __fadd_rn so that nvcc cannot contract
// them, and the kernel rounds exactly as the plain PyTorch version: the
// paths agree bit for bit. Backpointers (int16) go to a scratch buffer
// [B, T - 1, S] that the wrapper allocates. The final argmax is a
// shared-memory tree reduction with lowest-index ties; thread 0
// backtracks.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_STATES = 512;
constexpr int MAX_THREADS = 1024;
constexpr int MAX_PARTS = 8;
constexpr int BATCH = 16;

__global__ void __launch_bounds__(MAX_THREADS) viterbi_dense_kernel(
    const float* __restrict__ delta0,   // [B, S]
    const float* __restrict__ log_obs,  // [B, T, S]
    const float* __restrict__ log_A,    // [S, S], A[i, j]: from i to j
    short* __restrict__ backptr,        // [B, T - 1, S] scratch
    int* __restrict__ path,             // [B, T]
    int T, int S, int lanes, int parts) {
  __shared__ float delta[2][MAX_STATES];
  __shared__ float red_v[MAX_THREADS];
  __shared__ int red_i[MAX_THREADS];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int n_threads = lanes * parts;
  const int j = tid % lanes;
  const int part = tid / lanes;
  const bool active = j < S;
  const int chunk = (S + parts - 1) / parts;
  const int i_begin = part * chunk;
  const int i_end = i_begin + chunk < S ? i_begin + chunk : S;
  const float* obs = log_obs + (size_t)b * T * S;
  short* bp = backptr + (size_t)b * (T - 1) * S;

  float obs_next = 0.f;
  if (active && part == 0) {
    delta[0][j] = delta0[(size_t)b * S + j];
    if (T > 1) obs_next = obs[(size_t)S + j];
  }
  __syncthreads();

  int cur = 0;
  for (int t = 1; t < T; ++t) {
    const float* prev = delta[cur];
    if (active && i_begin < i_end) {
      float best = __fadd_rn(prev[i_begin], log_A[(size_t)i_begin * S + j]);
      int arg = i_begin;
      int i = i_begin + 1;
      for (; i + BATCH <= i_end; i += BATCH) {
        float a[BATCH];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) a[k] = log_A[(size_t)(i + k) * S + j];
#pragma unroll
        for (int k = 0; k < BATCH; ++k) {
          const float score = __fadd_rn(prev[i + k], a[k]);
          if (score > best) {
            best = score;
            arg = i + k;
          }
        }
      }
      for (; i < i_end; ++i) {
        const float score = __fadd_rn(prev[i], log_A[(size_t)i * S + j]);
        if (score > best) {
          best = score;
          arg = i;
        }
      }
      red_v[tid] = best;
      red_i[tid] = arg;
    }
    __syncthreads();
    if (active && part == 0) {
      const float o = obs_next;
      if (t + 1 < T) obs_next = obs[(size_t)(t + 1) * S + j];
      float best = red_v[j];
      int arg = red_i[j];
      for (int p = 1; p < parts; ++p) {
        if (p * chunk >= S) break;
        const float v = red_v[p * lanes + j];
        if (v > best) {
          best = v;
          arg = red_i[p * lanes + j];
        }
      }
      delta[cur ^ 1][j] = __fadd_rn(best, o);
      bp[(size_t)(t - 1) * S + j] = (short)arg;
    }
    cur ^= 1;
    __syncthreads();
  }

  // first argmax of delta_{T-1}: the larger value wins, the lower index on
  // a tie (the slots past S hold -inf and larger indices)
  for (int k = tid; k < MAX_THREADS; k += n_threads) {
    red_v[k] = k < S ? delta[cur][k] : -INFINITY;
    red_i[k] = k;
  }
  __syncthreads();
  for (int half = MAX_THREADS / 2; half > 0; half /= 2) {
    for (int k = tid; k < half; k += n_threads) {
      const float v = red_v[k + half];
      const int i = red_i[k + half];
      if (v > red_v[k] || (v == red_v[k] && i < red_i[k])) {
        red_v[k] = v;
        red_i[k] = i;
      }
    }
    __syncthreads();
  }

  if (tid == 0) {
    int state = red_i[0];
    for (int t = T - 1;; --t) {
      path[(size_t)b * T + t] = state;
      if (t == 0) break;
      state = bp[(size_t)(t - 1) * S + state];
    }
  }
}

}  // namespace

// delta0 [B, S], log_obs [B, T, S], log_A [S, S] float32; backptr scratch
// [B, T - 1, S] int16; path [B, T] int32 out. The Python wrapper checks
// 1 <= S <= 512, T >= 1 and contiguity. Returns the cudaError_t of the
// launch.
extern "C" int viterbi_dense(const void* delta0, const void* log_obs,
                             const void* log_A, void* backptr, void* path,
                             int B, int T, int S, void* stream) {
  const int lanes = (S + 31) / 32 * 32;
  int parts = MAX_THREADS / lanes;
  if (parts > MAX_PARTS) parts = MAX_PARTS;
  viterbi_dense_kernel<<<B, lanes * parts, 0, (cudaStream_t)stream>>>(
      (const float*)delta0, (const float*)log_obs, (const float*)log_A,
      (short*)backptr, (int*)path, T, S, lanes, parts);
  return (int)cudaGetLastError();
}
