// K7: monotonic alignment (GlowTTS / VITS maximum path), forward DP and
// backtrack in one kernel.
//
// Replaces fish_diffusion_tpu/ops/monotonic_align.py:maximum_path, a
// lax.scan over mel frames whose carry is the cumulative row, then a
// reverse scan for the backtrack:
//
//   v[0, x] = value[0, x] + (x == 0 ? 0 : -1e9)
//   v[y, x] = value[y, x] + max(v[y-1, x-1], v[y-1, x]),  v[y-1, -1] = -1e9
//
// then from (t_y - 1, t_x - 1) down to row 0: mark the cell, and move one
// text position left iff index != 0 and (index == y or v[y-1, index] <
// v[y-1, index-1]). The path is 0 elsewhere (rows >= t_y, columns >= t_x).
//
// Bound on an H100: neither bytes nor operations (~50 MB and ~20 M
// operations at B = 32, T_y = 1000, T_x = 200, 15 us), but the chain of
// t_y dependent rows of an item, then its t_y dependent backtrack steps.
// Design: one block per item, threads over text positions (each thread
// owns x = threadIdx.x + j * 256, so any T_x works). The row lives in
// shared memory, double buffered, one barrier per row; each thread holds
// the next row's values of its first four positions in registers, loaded
// before the barrier, so the row's global load is off the chain. Each
// cell stores one decision byte, same < left, instead of its cumulative
// value; after the last row one thread walks the backtrack over those
// bytes (written by the block, so read back from L1 / L2). The update is
// the JAX row update in float32 in the same order (one add, one max; no
// product, so nothing to contract), with the same -1e9, and the
// comparison is the same strict <: paths are bit-equal to the JAX op.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PREFETCH = 4;  // positions per thread whose next value is prefetched
constexpr float NEG = -1e9f;

// one cell of row y from row y - 1 (cur): the JAX update, and the
// backtrack's decision byte
__device__ __forceinline__ void update(const float* cur, float* nxt, unsigned char* drow,
                                       int x, float value) {
  const float same = cur[x];
  const float left = x > 0 ? cur[x - 1] : NEG;
  nxt[x] = __fadd_rn(value, fmaxf(left, same));
  drow[x] = same < left;
}

__global__ void __launch_bounds__(THREADS)
maximum_path_kernel(const float* __restrict__ value, const int* __restrict__ t_ys,
                    const int* __restrict__ t_xs, unsigned char* __restrict__ dec,
                    int* __restrict__ path, int T_y, int T_x) {
  extern __shared__ float smem[];  // two rows [2][T_x]
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t cells = (size_t)T_y * T_x;
  const float* val = value + (size_t)b * cells;
  unsigned char* d = dec + (size_t)b * cells;
  int* p = path + (size_t)b * cells;
  const int t_y = t_ys[b], t_x = t_xs[b];  // in [0, T] (the wrapper clamps)

  for (size_t i = tid; i < cells; i += THREADS) p[i] = 0;
  float* cur = smem;
  float* nxt = smem + T_x;
  for (int x = tid; x < T_x; x += THREADS) cur[x] = __fadd_rn(val[x], x == 0 ? 0.f : NEG);
  float ahead[PREFETCH];
#pragma unroll
  for (int j = 0; j < PREFETCH; ++j) {
    const int x = tid + j * THREADS;
    ahead[j] = (t_y > 1 && x < T_x) ? val[(size_t)T_x + x] : 0.f;
  }
  __syncthreads();

  for (int y = 1; y < t_y; ++y) {
    const float* row = val + (size_t)y * T_x;
    unsigned char* drow = d + (size_t)y * T_x;
    float here[PREFETCH];
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) here[j] = ahead[j];
    if (y + 1 < t_y) {
#pragma unroll
      for (int j = 0; j < PREFETCH; ++j) {
        const int x = tid + j * THREADS;
        if (x < T_x) ahead[j] = row[T_x + x];
      }
    }
#pragma unroll
    for (int j = 0; j < PREFETCH; ++j) {
      const int x = tid + j * THREADS;
      if (x < T_x) update(cur, nxt, drow, x, here[j]);
    }
    for (int x = tid + PREFETCH * THREADS; x < T_x; x += THREADS)
      update(cur, nxt, drow, x, row[x]);
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }

  if (tid == 0 && t_y > 0 && t_x > 0) {
    int index = t_x - 1;
    for (int y = t_y - 1; y >= 0; --y) {
      p[(size_t)y * T_x + index] = 1;
      if (y > 0 && index != 0 && (index == y || d[(size_t)y * T_x + index])) --index;
    }
  }
}

}  // namespace

// value [B, T_y, T_x] float32, t_ys / t_xs [B] int32 in [0, T_y] and
// [0, T_x], dec [B, T_y, T_x] uint8 scratch, path [B, T_y, T_x] int32
// (written whole). Contiguous, on
// one device (the Python wrapper checks). Returns the cudaError_t of the
// launch.
extern "C" int maximum_path(const void* value, const void* t_ys, const void* t_xs,
                            void* dec, void* path, int B, int T_y, int T_x,
                            void* stream) {
  const size_t smem = 2 * (size_t)T_x * sizeof(float);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        maximum_path_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != 0) return err;
  }
  maximum_path_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)value, (const int*)t_ys, (const int*)t_xs, (unsigned char*)dec,
      (int*)path, T_y, T_x);
  return (int)cudaGetLastError();
}
