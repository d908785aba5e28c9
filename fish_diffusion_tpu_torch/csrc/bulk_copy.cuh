// Helpers shared by the kernels that stage by TMA (viterbi.cu,
// monotonic_align.cu, nsf_source.cu, istft.cu): mbarriers, 1-D bulk copies
// by the Tensor Memory Accelerator (cp.async.bulk) between device memory
// and shared memory, and the card's SM count. Include after
// <cuda_runtime.h>.
//
// The PTX sits behind `#if defined(__CUDA_ARCH__)`. The host branch (the
// CPU tests' emulation, one std::thread a CUDA thread) copies at once with
// memcpy (cp.async by a plain copy) and keeps an mbarrier as a word of
// shared memory updated with atomics: bits 0-31 the arrivals still
// pending, 32-47 the arrivals a phase expects, 48-63 the phase. A copy
// there lands before its issuer arrives, so the host barrier counts no
// bytes.

#ifndef FDT_BULK_COPY_CUH
#define FDT_BULK_COPY_CUH

#include <stdint.h>
#include <atomic>

#if !defined(__CUDA_ARCH__)
#include <sched.h>
#include <string.h>
#endif

namespace bulk {
namespace {  // internal linkage: each library keeps its own copy

typedef unsigned long long bar_t;

__host__ __device__ __forceinline__ unsigned smem_addr(const void* p) {
#if defined(__CUDA_ARCH__)
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
#else
  (void)p;
  return 0;
#endif
}

// one thread: a barrier whose phases complete after `count` arrivals
__host__ __device__ __forceinline__ void init(bar_t* bar, int count) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
#else
  __atomic_store_n(bar, (bar_t)count << 32 | (bar_t)count, __ATOMIC_RELEASE);
#endif
}

// after the initialising thread's inits, before the block barrier that
// publishes them (to the copy engine too)
__host__ __device__ __forceinline__ void fence_init() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

__host__ __device__ __forceinline__ void arrive(bar_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
#else
  bar_t s = __atomic_load_n(bar, __ATOMIC_RELAXED);
  for (;;) {
    const bar_t expected = s >> 32 & 0xffff;
    const bar_t next = (s & 0xffffffffull) > 1
                           ? s - 1
                           : ((s >> 48) + 1) << 48 | expected << 32 | expected;
    if (__atomic_compare_exchange_n(bar, &s, next, true, __ATOMIC_ACQ_REL, __ATOMIC_RELAXED))
      return;
  }
#endif
}

// until the phase of this parity has completed (every waiting thread)
__host__ __device__ __forceinline__ void wait(bar_t* bar, int parity) {
#if defined(__CUDA_ARCH__)
  const unsigned a = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
#else
  while ((int)(__atomic_load_n(bar, __ATOMIC_ACQUIRE) >> 48 & 1) == parity) sched_yield();
#endif
}

// A phase filled by bulk copies, issued by one thread in this order:
// expect(bar, bytes) (on the card its arrival, awaiting `bytes`), the
// copies, then landed(bar) (on the host its arrival: the copies are done).
// A phase that stages ranges with edges (stage_edges) counts one arrival
// more: edges_landed(bar), after the edges' copies.
__host__ __device__ __forceinline__ void expect(bar_t* bar, unsigned bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
#else
  (void)bar, (void)bytes;
#endif
}

__host__ __device__ __forceinline__ void landed(bar_t* bar) {
#if !defined(__CUDA_ARCH__)
  arrive(bar);
#else
  (void)bar;
#endif
}

// device memory -> shared memory; 16-byte aligned addresses, bytes a
// multiple of 16
__host__ __device__ __forceinline__ void load(void* dst, const void* src, unsigned bytes,
                                              bar_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
#else
  (void)bar;
  memcpy(dst, src, bytes);
#endif
}

// one thread: a phase of bar that is one bulk copy of `bytes`
__host__ __device__ __forceinline__ void fetch(void* dst, const void* src, unsigned bytes,
                                               bar_t* bar) {
  expect(bar, bytes);
  load(dst, src, bytes, bar);
  landed(bar);
}

// Every thread that wrote shared memory a bulk store will read, before the
// warp or block barrier after which one thread issues it
__host__ __device__ __forceinline__ void fence_shared() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

// shared memory -> device memory, one bulk group a call (same alignment)
__host__ __device__ __forceinline__ void store(void* dst, const void* src, unsigned bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
#else
  memcpy(dst, src, bytes);
#endif
}

// until at most N of this thread's bulk stores still read shared memory
template <int N>
__host__ __device__ __forceinline__ void stores_read() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
#endif
}

// until this thread's bulk stores are done, and visible to its bulk loads
__host__ __device__ __forceinline__ void stores_done() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
#endif
}

// A range of n floats (or 32-bit words) at src, staged so that element e
// lands at dst[lead(src) + e] (dst 16-byte aligned): the bulk copy moves
// its 16-byte aligned middle, 4-byte cp.async copies the rest (at most 3
// words each side). lead(src) in [0, 3] keeps dst's alignment equal to
// src's.
__host__ __device__ __forceinline__ int lead(const void* src) {
  return (int)((uintptr_t)src / 4 % 4);
}

struct Span {
  int head;  // words before the aligned middle
  int mid;   // words in it, a multiple of 4
};

__host__ __device__ __forceinline__ Span span_of(const void* src, int n) {
  int head = (4 - lead(src)) & 3;
  head = head < n ? head : n;
  return Span{head, (n - head) & ~3};
}

// the words outside the middle, by this thread's 4-byte cp.async copies
template <class T>
__host__ __device__ __forceinline__ void stage_edges(T* dst, const T* src, int n) {
  static_assert(sizeof(T) == 4, "32-bit words");
  const Span s = span_of(src, n);
  T* d = dst + lead(src);
  auto copy = [&](int e) {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(d + e)),
                 "l"(src + e) : "memory");
#else
    d[e] = src[e];
#endif
  };
  for (int e = 0; e < s.head; ++e) copy(e);
  for (int e = s.head + s.mid; e < n; ++e) copy(e);
}

// an arrival on bar once this thread's cp.async copies have landed
__host__ __device__ __forceinline__ void edges_landed(bar_t* bar) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
#else
  arrive(bar);
#endif
}

template <class T>
__host__ __device__ __forceinline__ unsigned stage_bytes(const T* src, int n) {
  return 4u * (unsigned)span_of(src, n).mid;
}

template <class T>
__host__ __device__ __forceinline__ void stage_middle(T* dst, const T* src, int n, bar_t* bar) {
  const Span s = span_of(src, n);
  if (s.mid > 0) load(dst + lead(src) + s.head, src + s.head, 4u * (unsigned)s.mid, bar);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

// the current device's SM count, queried once a device (up to 64 devices;
// threads that race store the same value)
inline int sm_count() {
  static std::atomic<int> cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev >= 0 && dev < 64 ? cached[dev].load(std::memory_order_relaxed) : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev >= 0 && dev < 64) cached[dev].store(n, std::memory_order_relaxed);
  }
  return n;
}

}  // namespace
}  // namespace bulk

#endif  // FDT_BULK_COPY_CUH
