// K8 (dense decoder): the max-product Viterbi recursion over a dense
// [S, S] log-transition matrix, with a backtrack, on a thread-block
// cluster that holds the matrix on chip for the whole launch.
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
// adds and compares (2 T S^2 operations: 0.75 ms for pYIN's 1025 x 430 at
// one SM's share of the float32 rate). The matrix (0.52-0.74 MB) fits no
// SM: read from L2 every frame by one block, it ran at ~50 GB/s.
//
// Design: one cluster of C blocks per item (neighbouring SMs that reach
// each other's shared memory). Block r owns the destination states j in
// [r W, r W + W), W = ceil(S / C) rounded up to 4; each of its threads owns
// one j and a part of K consecutive previous states i (P parts a column,
// in P neighbouring lanes) and keeps its K entries of A in registers for
// the whole launch, so a frame reads no matrix: delta_{t-1} comes as
// float4 broadcasts from shared memory. A part takes each group of 4
// states' maximum (fmaxf), keeps the first group that is strictly greater
// and then the first state of that group that reaches it (a second look
// through a copy of the block's slice of A in shared memory): the first
// state of the part's maximum, with that state's score, in ~2.75
// instructions a pair instead of 4 and a chain of K / 4 dependent
// compares. The P parts of a column meet in a warp butterfly that keeps the
// larger score and, on a tie, the lower state: ties take the first state,
// as jnp.argmax and torch.max do. The adds are __fadd_rn (nvcc cannot
// contract them), so the paths equal the plain PyTorch version's bit for
// bit.
//
// The exchange: a warp holds 4 whole columns (P = 8); each of its first C
// lanes sends the 4 new values delta_t[j] = best + obs_t[j] as one 16-byte
// st.async into the next delta buffer of one block of the cluster (all of
// them, its own included), which counts the bytes on that block's
// mbarrier of the buffer (expect_tx: 16 bytes a group of 4 states below
// S). A block's next frame waits on its own mbarrier (every thread of a
// live warp, try_wait with acquire at cluster scope): no cluster barrier and no
// release of global stores per frame. delta is double-buffered: a block
// sends into a buffer only after it has received every column of the
// frame before, i.e. after every live warp of every block has finished
// reading that buffer. Only the warps that own a live column wait on the
// mbarriers (warp 0 among them: its thread 0 arrives with each phase's
// expect_tx); the others read no buffer and skip the frame's waits. So
// every waiter stays within one phase of its mbarrier: the buffer's next
// phase needs the waiter's own send of the frame after, and every block
// owns a column (C = ceil(S / W)), so no block's buffer is sent a phase
// ahead of the waits of its own live warps. Lane 0
// writes the warp's 4 int16 backpointers (8 bytes) to a global scratch
// buffer [B, T - 1, Sp] (Sp = S rounded up to 8, 16-byte rows), and each
// column's next observation is loaded after the send, before the wait.
// After the last frame every block waits for its last values (none may
// exit while stores to it are in flight) and one cluster barrier publishes
// the backpointers; block 0 then takes the first argmax of delta_{T-1},
// which every block holds whole (a butterfly with lowest-index ties), and
// one thread backtracks while the block stages the backpointers from L2
// into shared memory with cp.async, one chunk of rows ahead of the walk.
//
// Each block asks for 200 KB of dynamic shared memory (the slice of A,
// the backtrack's stage), so no two blocks of a cluster share an SM. The
// plan (plan_for: W from 16 blocks, a non-portable cluster size, and 8
// lanes a column) was chosen by measuring others once at the pitch path's
// shapes (8 blocks, 4 lanes, A in shared memory: PERF.md); the C entry
// returns the error of the launch, or of the query that finds the cluster
// cannot be scheduled (cudaOccupancyMaxActiveClusters, asked once per
// device and plan). What holds it: the chain of T - 1
// exchanges (the chain floor: viterbi_dense_chain, the same launch with an
// empty frame body, ~0.37 us a frame) and each frame's scan, butterfly
// and gather, latency-bound at 7-14 warps an SM.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include <map>
#include <mutex>
#include <tuple>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_STATES = 512;
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_BYTES = 200 * 1024;
constexpr int MAX_CLUSTER = 16;  // the most an H100 schedules (non-portable)
constexpr int P = 8;             // lanes a column
constexpr int MAX_K = (MAX_STATES / P + 3) / 4 * 4;
constexpr unsigned FULL = 0xffffffffu;
// a warp holds 32 / P = 4 columns: one 16-byte send carries them
static_assert(32 / P == 4, "parts");

// a part's slots in a delta buffer: K states, padded to an odd number of
// 16-byte groups, so that the float4 loads of a warp's parts (K states
// apart) fall in distinct banks
__host__ __device__ constexpr int part_stride(int K) { return (K / 4) % 2 ? K : K + 4; }

struct Plan {
  int C, K, W, threads;
};

// The rule: the columns of 16 blocks (each block then scans 1 / 16 of the
// pairs), in whole groups of 4; as many blocks as own a column
Plan plan_for(int S) {
  Plan p{};
  p.K = acopy::cdiv(acopy::cdiv(S, P), 4) * 4;
  p.W = acopy::cdiv(acopy::cdiv(S, MAX_CLUSTER), 4) * 4;
  p.C = acopy::cdiv(S, p.W);
  p.threads = acopy::cdiv(p.W * P, 32) * 32;
  return p;
}

// a stored state's slot in a delta buffer
template <int K>
__device__ __forceinline__ int slot(int i) {
  return i / K * part_stride(K) + i % K;
}

// (v, i) replaces (best, arg) if larger, or equal at a lower state
__device__ __forceinline__ void take_first(float& best, int& arg, float v, int i) {
  if (v > best || (v == best && i < arg)) {
    best = v;
    arg = i;
  }
}

// The frame's exchange. On the card a warp's 4 new values go by one
// st.async into block r's buffer and count their 16 bytes on that block's
// mbarrier of the buffer; a block's frame waits on its own mbarrier
// (expect_tx: 16 bytes a group of 4 states below S). The host build (the
// CPU tests' emulation) stores through map_shared_rank and meets at the
// cluster barrier at the end of each frame instead.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
#if defined(__CUDA_ARCH__)
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
#else
  return 0;
#endif
}

__device__ __forceinline__ void send4(const cg::cluster_group& cluster, float* slot,
                                      unsigned long long* bar, int r, float4 v) {
#if defined(__CUDA_ARCH__)
  unsigned remote_slot, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_slot) : "r"(smem_u32(slot)), "r"(r));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote_bar) : "r"(smem_u32(bar)), "r"(r));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" :: "r"(remote_slot), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
      "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(remote_bar) : "memory");
#else
  (void)bar;
  *reinterpret_cast<float4*>(cluster.map_shared_rank(slot, r)) = v;
#endif
}

// one thread a block: this phase of the buffer's mbarrier awaits `bytes`
__device__ __forceinline__ void expect_bytes(unsigned long long* bar, int bytes) {
#if defined(__CUDA_ARCH__)
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
#endif
}

// the buffer's values of this phase have all landed (every thread of a
// live warp waits: acquire, cluster scope)
__device__ __forceinline__ void wait_values(unsigned long long* bar, int parity) {
#if defined(__CUDA_ARCH__)
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
#endif
}

__device__ __forceinline__ void end_of_frame(const cg::cluster_group& cluster) {
#if !defined(__CUDA_ARCH__)
  cluster.sync();
#endif
}

// WORK = false: the chain floor, the same launch with the frame's scan and
// butterfly left out (the gather, the exchange and the backpointers stay)
template <int K, bool WORK>
__global__ void __launch_bounds__(K > 32 ? MAX_THREADS / 2 : MAX_THREADS) viterbi_cluster(
    const float* __restrict__ delta0,   // [B, S]
    const float* __restrict__ log_obs,  // [B, T, S]
    const float* __restrict__ log_A,    // [S, S], A[i, j]: from i to j
    short* __restrict__ backptr,        // [B, T - 1, Sp] scratch
    int* __restrict__ path,             // [B, T]
    int T, int S, int C, int W) {
  constexpr int KS = part_stride(K);
  constexpr int SP = P * KS;  // floats a delta buffer
  constexpr int AS = P * K;   // floats a column of A's slice
  extern __shared__ __align__(16) float smem[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem);  // [2]
  float* dbuf = smem + 4;                                    // [2][SP]
  float* red_v = dbuf + 2 * SP;                              // [32]
  int* red_i = reinterpret_cast<int*>(red_v + 32);           // [32]
  float* a_sh = red_v + 64;                                  // [W][AS]
  short* stage = reinterpret_cast<short*>(a_sh + (size_t)W * AS);  // [2][CH][Sp]

  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;
  const int jj = tid / P, p = tid % P;
  const int j = rank * W + jj;
  const bool live = jj < W && j < S;
  // the warp's 4 columns from j0; a warp with no live column scans nothing
  // and waits on no mbarrier (the header: every waiter within one phase)
  const int jj0 = (tid & ~31) / P, j0 = rank * W + jj0;
  const bool warp_live = jj0 < W && j0 < S;
  const int i0 = p * K;
  const int Sp = (S + 7) / 8 * 8;
  const float* obs = log_obs + (size_t)b * T * S;
  short* bp = backptr + (size_t)b * (T - 1) * Sp;

  // this thread's entries of A, in registers and in the block's slice (for
  // the winning group's second look); -inf past the last state and for
  // idle threads: such a score never wins
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    a[k] = live && i0 + k < S ? log_A[(size_t)(i0 + k) * S + j] : -INFINITY;
    if (jj < W) a_sh[jj * AS + i0 + k] = a[k];
  }
  // delta_0 into buffer 0; the slots of states past S read as 0 (their A
  // is -inf)
  for (int q = tid; q < 2 * SP; q += nthreads) {
    const int s = q % SP, k = s % KS, i = s / KS * K + k;
    dbuf[q] = q < SP && k < K && i < S ? delta0[(size_t)b * S + i] : 0.f;
  }
  if (tid == 0) {
#if defined(__CUDA_ARCH__)
    for (int q = 0; q < 2; ++q)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(smem_u32(bars + q)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
  }
  // every block has started, holds delta_0 and its mbarriers before any
  // remote store
  cluster.sync();

  // a phase's bytes: every group of 4 columns that starts below S, 16 each
  const int phase_bytes = acopy::cdiv(S, 4) * 16;
  float o = live && T > 1 ? obs[(size_t)S + j] : 0.f;
  int cur = 0, parity = 0;  // bit q: the phase parity of buffer q's mbarrier
  for (int t = 1; t < T; ++t) {
    if (t > 1) {  // delta_{t-1}, sent by every block in frame t - 1
      if (warp_live) wait_values(bars + cur, (parity >> cur) & 1);
      parity ^= 1 << cur;
    }
    // the other buffer's previous phase ended in frame t - 1 (or it has none)
    if (tid == 0) expect_bytes(bars + (cur ^ 1), phase_bytes);
    float best = -INFINITY;
    int arg = 0;
    if (WORK && warp_live) {
      // groups of 4 previous states: each group's maximum, the first group
      // that is strictly greater, then the first of its states that reaches
      // it (the value of that state: the same bits as a scan in order)
      const float* prev = dbuf + cur * SP + p * KS;
      float best2[2] = {-INFINITY, -INFINITY};  // even and odd groups: two chains
      int g2[2] = {0, 4};
#pragma unroll
      for (int q = 0; q < K; q += 4) {
        const float4 d = *reinterpret_cast<const float4*>(prev + q);
        const float m = fmaxf(fmaxf(__fadd_rn(d.x, a[q]), __fadd_rn(d.y, a[q + 1])),
                              fmaxf(__fadd_rn(d.z, a[q + 2]), __fadd_rn(d.w, a[q + 3])));
        if (m > best2[q / 4 % 2]) {
          best2[q / 4 % 2] = m;
          g2[q / 4 % 2] = q;
        }
      }
      best = best2[0];
      int g = g2[0];
      take_first(best, g, best2[1], g2[1]);
      const float4 d = *reinterpret_cast<const float4*>(prev + g);
      const float4 f = *reinterpret_cast<const float4*>(a_sh + jj * AS + i0 + g);
      const float s0 = __fadd_rn(d.x, f.x), s1 = __fadd_rn(d.y, f.y),
                  s2 = __fadd_rn(d.z, f.z), s3 = __fadd_rn(d.w, f.w);
      const int u = s0 == best ? 0 : s1 == best ? 1 : s2 == best ? 2 : 3;
      best = u == 0 ? s0 : u == 1 ? s1 : u == 2 ? s2 : s3;
      arg = i0 + g + u;
      // the column's parts, in neighbouring lanes
#pragma unroll
      for (int m = 1; m < P; m <<= 1) {
        const float ov = __shfl_xor_sync(FULL, best, m);
        const int oi = __shfl_xor_sync(FULL, arg, m);
        take_first(best, arg, ov, oi);
      }
    }
    const float next = __fadd_rn(best, o);
    if (warp_live) {
      // the warp's group of 4 columns (lanes c P to c P + P - 1 hold
      // column c): lane r < C sends it to block r, 16 bytes; then lane 0
      // writes its 4 backpointers, 8 bytes
      const float4 v = make_float4(__shfl_sync(FULL, next, 0), __shfl_sync(FULL, next, P),
                                   __shfl_sync(FULL, next, 2 * P),
                                   __shfl_sync(FULL, next, 3 * P));
      if (lane < C) send4(cluster, dbuf + (cur ^ 1) * SP + slot<K>(j0), bars + (cur ^ 1), lane, v);
      const int a0 = __shfl_sync(FULL, arg, 0), a1 = __shfl_sync(FULL, arg, P),
                a2 = __shfl_sync(FULL, arg, 2 * P), a3 = __shfl_sync(FULL, arg, 3 * P);
      if (lane == 0) {
        const unsigned lo = (unsigned)(unsigned short)a0 | (unsigned)a1 << 16;
        const unsigned hi = (unsigned)(unsigned short)a2 | (unsigned)a3 << 16;
        *reinterpret_cast<uint2*>(bp + (size_t)(t - 1) * Sp + j0) = make_uint2(lo, hi);
      }
    }
    if (live && t + 1 < T) o = obs[(size_t)(t + 1) * S + j];
    end_of_frame(cluster);
    cur ^= 1;
  }
  // delta_{T-1} has landed in every block (no block leaves while values
  // may still be on their way to it), and every block's backpointers are
  // visible to block 0
  if (T > 1 && warp_live) wait_values(bars + cur, (parity >> cur) & 1);
  cluster.sync();

  // every block holds delta_{T-1}; block 0 decodes
  if (rank != 0) return;
  const float* fin = dbuf + cur * SP;
  float best = -INFINITY;
  int arg = S;
  for (int i = tid; i < S; i += nthreads) take_first(best, arg, fin[slot<K>(i)], i);
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const float ov = __shfl_xor_sync(FULL, best, m);
    const int oi = __shfl_xor_sync(FULL, arg, m);
    take_first(best, arg, ov, oi);
  }
  if (tid % 32 == 0) {
    red_v[tid / 32] = best;
    red_i[tid / 32] = arg;
  }
  __syncthreads();
  int state = 0;
  if (tid == 0) {
    for (int w = 1; w < nthreads / 32; ++w) take_first(best, arg, red_v[w], red_i[w]);
    state = arg;
    path[(size_t)b * T + T - 1] = state;
  }

  // the backtrack: chunks of CH rows, from the last, each staged by every
  // thread (cp.async, 16 bytes a copy) while thread 0 walks the one before
  const int rows = T - 1;
  const int stage_bytes = SMEM_BYTES - (int)(reinterpret_cast<char*>(stage) -
                                             reinterpret_cast<char*>(smem));
  const int CH = stage_bytes / (2 * Sp * (int)sizeof(short));
  const int chunks = acopy::cdiv(rows, CH);
  auto load = [&](int c) {
    const int hi = rows - c * CH, lo = hi - CH > 0 ? hi - CH : 0;
    const float* src = reinterpret_cast<const float*>(bp + (size_t)lo * Sp);
    float* dst = reinterpret_cast<float*>(stage + (size_t)(c % 2) * CH * Sp);
    for (int q = tid; q < (hi - lo) * Sp / 8; q += nthreads)
      acopy::copy16(dst + 4 * q, src + 4 * q, true);
    acopy::copy_commit();
  };
  if (chunks > 0) load(0);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      load(c + 1);
      acopy::copy_wait<1>();
    } else {
      acopy::copy_wait<0>();
    }
    __syncthreads();  // chunk c has landed
    if (tid == 0) {
      const short* rows_c = stage + (size_t)(c % 2) * CH * Sp;
      const int hi = rows - c * CH, lo = hi - CH > 0 ? hi - CH : 0;
      for (int r = hi - 1; r >= lo; --r) {
        state = rows_c[(size_t)(r - lo) * Sp + state];
        path[(size_t)b * T + r] = state;
      }
    }
    __syncthreads();  // its buffer is free for chunk c + 2
  }
}

// the smallest dynamic shared memory the block's layout needs besides the
// backtrack's stage (two rows)
int layout_bytes(const Plan& pl, int K, int S) {
  const int SP = P * part_stride(K);
  const int Sp = (S + 7) / 8 * 8;
  return (4 + 2 * SP + 64 + pl.W * P * K) * 4 + 4 * Sp;
}

template <int K, bool WORK>
int launch_plan(const Plan& pl, const void* delta0, const void* log_obs, const void* log_A,
                void* backptr, void* path, int B, int T, int S, cudaStream_t stream,
                int* clusters) {
  const auto kernel = viterbi_cluster<K, WORK>;
  if (layout_bytes(pl, K, S) > SMEM_BYTES) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       SMEM_BYTES);
  if (e == cudaSuccess && pl.C > 8)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * pl.C);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = SMEM_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the clusters the card holds at once, queried once per instance, device
  // and plan (the query costs the host more than a launch)
  static std::mutex guard;
  static std::map<std::tuple<int, int, int>, int> held;
  int device = 0, n = 0;
  e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  {
    const std::lock_guard<std::mutex> lock(guard);
    const auto key = std::make_tuple(device, pl.threads, pl.C);
    const auto it = held.find(key);
    if (it != held.end()) {
      n = it->second;
    } else {
      e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      held[key] = n;
    }
  }
  if (clusters) {
    *clusters = n;
    return 0;
  }
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;  // the cluster cannot be scheduled
  e = cudaLaunchKernelEx(&cfg, kernel, (const float*)delta0, (const float*)log_obs,
                         (const float*)log_A, (short*)backptr, (int*)path, T, S, pl.C,
                         pl.W);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the kernel instance of the plan's K (a multiple of 4 up to MAX_K)
template <bool WORK, int K = 4>
int launch(const Plan& pl, const void* delta0, const void* log_obs, const void* log_A,
           void* backptr, void* path, int B, int T, int S, cudaStream_t stream,
           int* clusters = nullptr) {
  if constexpr (K > MAX_K) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (pl.K != K)
      return launch<WORK, K + 4>(pl, delta0, log_obs, log_A, backptr, path, B, T, S, stream,
                                 clusters);
    return launch_plan<K, WORK>(pl, delta0, log_obs, log_A, backptr, path, B, T, S, stream,
                                clusters);
  }
}

// the clusters of this plan the card holds at once (< 1: none), or -error
int clusters_of(const Plan& pl, int S) {
  int n = 0;
  const int e = launch<true>(pl, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 1, S,
                             nullptr, &n);
  return e == 0 ? n : -e;
}

}  // namespace

// delta0 [B, S], log_obs [B, T, S], log_A [S, S] float32; backptr scratch
// [B, T - 1, Sp] int16 (Sp = S rounded up to a multiple of 8); path [B, T]
// int32 out. The Python wrapper checks 1 <= S <= 512, T >= 1 and
// contiguity. Returns the cudaError_t of the launch, or of the query that
// finds the cluster cannot be scheduled.
extern "C" int viterbi_dense(const void* delta0, const void* log_obs, const void* log_A,
                             void* backptr, void* path, int B, int T, int S, void* stream) {
  if (S < 1 || S > MAX_STATES) return (int)cudaErrorInvalidValue;
  return launch<true>(plan_for(S), delta0, log_obs, log_A, backptr, path, B, T, S,
                      (cudaStream_t)stream);
}

// The chain floor: the same launch with an empty frame body (the
// exchange, the backpointers and the barrier only). Its path is not a
// decode.
extern "C" int viterbi_dense_chain(const void* delta0, const void* log_obs, const void* log_A,
                                   void* backptr, void* path, int B, int T, int S,
                                   void* stream) {
  if (S < 1 || S > MAX_STATES) return (int)cudaErrorInvalidValue;
  return launch<false>(plan_for(S), delta0, log_obs, log_A, backptr, path, B, T, S,
                       (cudaStream_t)stream);
}

// The plan for S states: what = 0 blocks a cluster (C), 1 lanes a column
// (P), 2 previous states a lane (K), 3 threads a block, 4 the clusters the
// card can hold at once (cudaOccupancyMaxActiveClusters); -1 for another S.
extern "C" int viterbi_dense_plan(int S, int what) {
  if (S < 1 || S > MAX_STATES) return -1;
  const Plan pl = plan_for(S);
  switch (what) {
    case 0: return pl.C;
    case 1: return P;
    case 2: return pl.K;
    case 3: return pl.threads;
    case 4: return clusters_of(pl, S);
    default: return -1;
  }
}
