// Helpers shared by the staged-window kernels (wgrad.cuh, conv_fwd.cuh):
// cp.async copies into shared memory, vector loads from it, the card's SM
// count. Include after <cuda_runtime.h>. The PTX sits behind
// `#if defined(__CUDA_ARCH__)` with a plain-copy branch, so a host build of
// the sources (the CPU tests' emulation) runs the same code with the
// copies done at once.

#ifndef FDT_ASYNC_COPY_CUH
#define FDT_ASYNC_COPY_CUH

namespace acopy {
namespace {  // internal linkage: each library keeps its own statics

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// 16 bytes (ok) or zeros (!ok) into shared memory
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
#else
  for (int i = 0; i < 4; ++i) dst[i] = ok ? src[i] : 0.f;
#endif
}

// 4 bytes (ok) or a zero (!ok) into shared memory
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
#else
  *dst = ok ? *src : 0.f;
#endif
}

__device__ __forceinline__ void copy_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// N floats from shared memory, as float4 loads where N is a multiple of 4
template <int N>
__device__ __forceinline__ void load_vec(const float* q, float* v) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 f = *reinterpret_cast<const float4*>(q + i);
      v[i] = f.x, v[i + 1] = f.y, v[i + 2] = f.z, v[i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = q[i];
  }
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace
}  // namespace acopy

#endif  // FDT_ASYNC_COPY_CUH
