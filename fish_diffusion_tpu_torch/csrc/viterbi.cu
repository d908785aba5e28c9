// K8 (candidate decoder): praat's path finder over per-frame pitch
// candidates, the max-product Viterbi recursion with a backtrack.
//
// Replaces fish_diffusion_tpu/extractors/pitch.py:_viterbi_candidates (its
// two lax.scan passes, forward and reverse), which Harvest runs on every
// segment (extractors/world.py:_harvest_finalize) and ParselMouth on every
// segment (extractors/pitch.py AutocorrPitchExtractor).
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
// frames (T ~ 2600 at a segment's 30 s, S = 5 for Harvest and ParselMouth);
// bytes (9 floats in, 2 words out a frame) and operations are negligible.
//
// Design: one block an item, and nothing of a frame's chain leaves the SM.
// Warps 1-3 are producers: one of their threads stages the inputs of F
// frames (a chunk, and the frame before it) into a ring of shared memory by
// TMA bulk copies on an mbarrier, a few chunks ahead; the producers turn
// each chunk into log2 frequencies, then into the S x S costs of each of
// its frames and the strengths, rounded as the plain version rounds them
// (log2f, __fsub_rn, __fmul_rn), into a ring of two cost slots. Warp 0 runs
// the chain with no block barrier: lane j owns state j, takes delta_{t-1}
// of every state by S __shfl_sync, subtracts its column of costs and takes
// the maximum by a tree of fmaxf (depth ceil(log2 S)); the first state of
// that maximum comes from the same tree, the right half winning only when
// strictly greater, which picks what a scan in order with a strict > picks
// as long as no score is NaN (the callers' inputs are finite; -inf and +inf
// strengths give no NaN unless a +inf and a -inf meet in one sum). S up to
// 8 is compiled exactly; 9-16 and 17-32 as 16 or 32 states, the extra ones
// scoring -inf (they never win, and lose every tie). The chain waits on a
// chunk's costs by an mbarrier and frees the slot by another, once a chunk.
// Each frame's backpointers are one byte a state in shared memory. After
// the last frame the lanes take the first argmax by a butterfly; then the
// rows [1, T) split into 32 segments, one a lane: each lane walks its
// segment back from every state at once, lane 0 chains the segments' exits
// from the last, and each lane walks its segment again from its entry,
// writing the path (three passes of T / 32 dependent steps, not one of T).
// Every warp then writes f0. The adds are __fadd_rn / __fsub_rn, so the
// path equals the plain PyTorch version's bit for bit.
//
// Sizes (plan_for): F from 128 frames down while a cost slot exceeds 40 KB
// (K = 31: 8 frames). Where every chunk's backpointers do not fit beside
// the rings, the plan streams them: a ring of 4 chunks, each stored to a
// device scratch buffer by a bulk copy once full, and loaded back by bulk
// copies, a chunk ahead of lane 0's walk. viterbi_candidates_chain, for
// measurements, launches the same kernel with the FLOOR body: each frame's
// exchange, subtract, tree and add on costs held in registers, without the
// cost loads, the first state, the backpointers and the backtrack (the
// chain floor).

#include <cuda_runtime.h>
#include <math.h>

#include "bulk_copy.cuh"

namespace {

constexpr int THREADS = 128;  // warp 0: the chain; warps 1-3: the producers
constexpr int PRODUCERS = THREADS - 32;
constexpr int NI = 3;  // input slots
constexpr int NC = 2;  // cost slots
constexpr int NB_STREAMED = 4;
constexpr int COST_SLOT_MAX = 40 * 1024;
constexpr unsigned FULL = 0xffffffffu;
// the card's dynamic shared memory a block (a host build may set less, so
// that small sizes reach the streamed plan)
#ifndef SMEM_MAX
#define SMEM_MAX 232448
#endif
// in_full [NI], cost_full [NC], cost_empty [NC], the producers', the
// backtrack's [2]
constexpr int BARS = NI + 2 * NC + 3;

enum Variant { RULE = 0, FLOOR = 1 };

struct Plan {
  int F;         // frames a chunk, a power of two
  int RS;        // floats a cost row: the S costs into a state, its strength, to 4
  int in_fr;     // words a staged freqs (or strengths) region
  int in_words;  // words an input slot: freqs, strengths, unvoiced
  int CB;        // bytes of a chunk's backpointers (F S, to 16)
  int NB;        // chunks of backpointers in shared memory
  int streamed;
  int off_in, off_lp, off_cost, off_map, off_bp, smem;  // bytes
};

Plan layout(int T, int K, int F, int streamed) {
  const int S = K + 1, C = bulk::cdiv(T, F);
  Plan p{};
  p.F = F;
  p.RS = (S + 4) / 4 * 4;
  p.in_fr = ((F + 1) * K + 3 + 3) / 4 * 4;
  p.in_words = 2 * p.in_fr + (F + 1 + 3 + 3) / 4 * 4;
  p.CB = bulk::round16(F * S);
  p.streamed = streamed;
  p.NB = streamed ? NB_STREAMED : C;
  int off = bulk::round16(BARS * 8);
  p.off_in = off;
  off += NI * p.in_words * 4;
  p.off_lp = off;
  off += bulk::round16(2 * (F + 1) * S * 4);
  p.off_cost = off;
  off += NC * F * S * p.RS * 4;
  p.off_map = off;  // the backtrack's segments: [32][32] exits, [32] entries
  off += bulk::round16(32 * 32 + 32);
  p.off_bp = off;
  p.smem = off + p.NB * p.CB;
  return p;
}

// F from the cost slot's size; every chunk's backpointers on chip if they
// fit, else streamed; smaller chunks only where neither fits. smem = -1:
// nothing fits in SMEM_MAX bytes.
Plan plan_for(int T, int K) {
  const int S = K + 1, RS = (S + 4) / 4 * 4;
  int F = 128;
  while (F > 8 && F * S * RS * 4 > COST_SLOT_MAX) F /= 2;
  for (; F >= 8; F /= 2)
    for (int streamed = 0; streamed < 2; ++streamed) {
      const Plan p = layout(T, K, F, streamed);
      if (p.smem <= SMEM_MAX) return p;
    }
  Plan none{};
  none.smem = -1;
  return none;
}

// the maximum of s[LO, HI) and its first index: a tree whose right half
// wins only when strictly greater (s holds no NaN)
template <int LO, int HI>
__device__ __forceinline__ void first_max(const float* s, float& v, int& i) {
  if constexpr (HI - LO == 1) {
    v = s[LO];
    i = LO;
  } else {
    constexpr int MID = LO + (HI - LO + 1) / 2;
    float lv, rv;
    int li, ri;
    first_max<LO, MID>(s, lv, li);
    first_max<MID, HI>(s, rv, ri);
    v = fmaxf(lv, rv);
    i = rv > lv ? ri : li;
  }
}

template <int LO, int HI>
__device__ __forceinline__ float max_of(const float* s) {
  if constexpr (HI - LO == 1) {
    return s[LO];
  } else {
    constexpr int MID = LO + (HI - LO + 1) / 2;
    return fmaxf(max_of<LO, MID>(s), max_of<MID, HI>(s));
  }
}

// The producers (threads 32-127). Chunk c covers frames [c F, c F + F);
// its input slot holds frames [lo, hi), lo = max(c F - 1, 0), so that the
// chunk's first frame has the frame before it.
__device__ void produce(const Plan& p, const float* fr, const float* st, const float* uv,
                        unsigned char* smem, bulk::bar_t* in_full, bulk::bar_t* cost_full,
                        bulk::bar_t* cost_empty, bulk::bar_t* prod, int T, int K, int S) {
  const int pt = threadIdx.x - 32;
  const int F = p.F, C = bulk::cdiv(T, F);
  float* in = reinterpret_cast<float*>(smem + p.off_in);
  float* lp = reinterpret_cast<float*>(smem + p.off_lp);
  float* cost = reinterpret_cast<float*>(smem + p.off_cost);

  auto issue = [&](int c) {  // one thread
    const int lo = c * F > 0 ? c * F - 1 : 0, hi = c * F + F < T ? c * F + F : T;
    const int n = hi - lo, slot = c % NI;
    float* dst = in + slot * p.in_words;
    const float *sf = fr + (size_t)lo * K, *ss = st + (size_t)lo * K, *su = uv + lo;
    bulk::stage_edges(dst, sf, n * K);
    bulk::stage_edges(dst + p.in_fr, ss, n * K);
    bulk::stage_edges(dst + 2 * p.in_fr, su, n);
    bulk::expect(in_full + slot, bulk::stage_bytes(sf, n * K) + bulk::stage_bytes(ss, n * K) +
                                     bulk::stage_bytes(su, n));
    bulk::stage_middle(dst, sf, n * K, in_full + slot);
    bulk::stage_middle(dst + p.in_fr, ss, n * K, in_full + slot);
    bulk::stage_middle(dst + 2 * p.in_fr, su, n, in_full + slot);
    bulk::edges_landed(in_full + slot);
    bulk::landed(in_full + slot);
  };
  if (pt == 0)
    for (int c = 0; c < NI && c < C; ++c) issue(c);

  for (int c = 0; c < C; ++c) {
    const int t0 = c * F, lo = t0 > 0 ? t0 - 1 : 0;
    const int nf = t0 + F < T ? F : T - t0, n = t0 + nf - lo;
    const int slot = c % NI;
    bulk::wait(in_full + slot, (c / NI) & 1);
    const float* src = in + slot * p.in_words;
    const float* sf = src + bulk::lead(fr + (size_t)lo * K);
    const float* ss = src + p.in_fr + bulk::lead(st + (size_t)lo * K);
    const float* su = src + 2 * p.in_fr + bulk::lead(uv + lo);
    // log2 f of every state of the slot's frames, -inf where unvoiced
    float* lpb = lp + (c & 1) * (F + 1) * S;
    for (int q = pt; q < n * S; q += PRODUCERS) {
      const int i = q / S, j = q % S;
      const float f = j < K ? sf[i * K + j] : 0.f;
      lpb[q] = f > 0.f ? log2f(fmaxf(f, 1e-6f)) : -INFINITY;
    }
    bulk::arrive(prod);
    bulk::wait(prod, c & 1);
    // the chunk's cost rows: row (f, j) holds cost(i -> j) for every i,
    // then strength_t[j]
    if (c >= NC) bulk::wait(cost_empty + c % NC, (c / NC - 1) & 1);
    float* cs = cost + (c % NC) * F * S * p.RS;
    for (int q = pt; q < nf * S; q += PRODUCERS) {
      const int f = q / S, j = q % S, t = t0 + f, i = t - lo;
      float* row = cs + q * p.RS;  // 16-byte aligned: RS is a multiple of 4
      if (t > 0) {
        const float ln = lpb[i * S + j];
        const bool vn = ln > -INFINITY;
        const float* prev = lpb + (i - 1) * S;
        // 4 states at a time: the loads, then the costs, then one 16-byte
        // store (past S it writes the row's padding, and the strength's
        // slot, written after)
        for (int k = 0; k < S; k += 4) {
          float x[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) x[u] = k + u < S ? prev[k + u] : -INFINITY;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool vp = x[u] > -INFINITY;
            x[u] = vp && vn ? __fmul_rn(0.35f, fabsf(__fsub_rn(x[u], ln))) : vp != vn ? 0.14f : 0.f;
          }
          *reinterpret_cast<float4*>(row + k) = make_float4(x[0], x[1], x[2], x[3]);
        }
      }
      row[S] = j < K ? ss[i * K + j] : su[i];
    }
    bulk::arrive(cost_full + c % NC);
    if (pt == 0 && c + NI < C) {  // every producer is done with the input slot
      bulk::wait(cost_full + c % NC, (c / NC) & 1);
      issue(c + NI);
    }
  }
}

// NS: the states (2-8), or 16 / 32 for S up to that many (the states past
// S score -inf: they never win, and lose every tie)
template <int NS, int V>
__global__ void __launch_bounds__(THREADS) viterbi_kernel(
    const float* __restrict__ freqs,      // [B, T, K]
    const float* __restrict__ strengths,  // [B, T, K]
    const float* __restrict__ unvoiced,   // [B, T]
    unsigned char* __restrict__ scratch,  // [B, chunks, CB] where streamed
    int* __restrict__ path,               // [B, T]
    float* __restrict__ f0,               // [B, T]
    int T, int K, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bulk::bar_t* in_full = reinterpret_cast<bulk::bar_t*>(smem);
  bulk::bar_t* cost_full = in_full + NI;
  bulk::bar_t* cost_empty = cost_full + NC;
  bulk::bar_t* prod = cost_empty + NC;
  bulk::bar_t* bt = prod + 1;
  const float* cost = reinterpret_cast<const float*>(smem + p.off_cost);
  unsigned char* bp = smem + p.off_bp;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  constexpr bool EXACT = NS <= 8;
  constexpr int RSN = (NS + 4) / 4 * 4;  // floats of a cost row loaded
  const int S = EXACT ? NS : K + 1;
  const int F = p.F, C = bulk::cdiv(T, F), RS = EXACT ? RSN : p.RS;
  const float* fr = freqs + (size_t)b * T * K;
  const float* st = strengths + (size_t)b * T * K;
  const float* uv = unvoiced + (size_t)b * T;
  int* pa = path + (size_t)b * T;
  unsigned char* scr = scratch + (size_t)b * C * p.CB;

  if (tid == 0) {
    for (int q = 0; q < NI; ++q) bulk::init(in_full + q, 2);  // the bytes, the edges
    for (int q = 0; q < NC; ++q) {
      bulk::init(cost_full + q, PRODUCERS);
      bulk::init(cost_empty + q, 1);
    }
    bulk::init(prod, PRODUCERS);
    bulk::init(bt, 1);
    bulk::init(bt + 1, 1);
    bulk::fence_init();
  }
  __syncthreads();

  if (tid >= 32) {
    produce(p, fr, st, uv, smem, in_full, cost_full, cost_empty, prod, T, K, S);
  } else {
    // the chain: lane j holds delta[j]
    const int jj = lane < S ? lane : S - 1;
    float d = 0.f;
    float hold[RSN];  // FLOOR: a cost row in registers
    for (int c = 0; c < C; ++c) {
      const int slot = c % NC;
      bulk::wait(cost_full + slot, (c / NC) & 1);
      const float* cs = cost + slot * F * S * RS;
      const int nf = c * F + F < T ? F : T - c * F;
      unsigned char* bpc = bp + (p.streamed ? c % p.NB : c) * p.CB;
      if (p.streamed && c >= p.NB) {  // the slot's last store has read it
        if (lane == 0) bulk::stores_read<NB_STREAMED - 1>();
        __syncwarp();
      }
      int f = 0;
      if (c == 0) {  // delta_0: frame 0's strengths
        d = cs[jj * RS + S];
        if constexpr (V == FLOOR) {
          const float* row = cs + ((T > 1 ? S : 0) + jj) * RS;
#pragma unroll
          for (int k = 0; k < RSN; ++k) hold[k] = row[k];
        }
        f = 1;
      }
      for (; f < nf; ++f) {
        const float* row = cs + (f * S + jj) * RS;
        if constexpr (V == RULE) {
          // the row and the strength (past the row where S < NS: masked)
          float r[RSN];
#pragma unroll
          for (int k = 0; k < RSN; k += 4) {
            const float4 q = *reinterpret_cast<const float4*>(row + k);
            r[k] = q.x, r[k + 1] = q.y, r[k + 2] = q.z, r[k + 3] = q.w;
          }
          float sc[NS];  // every lane's delta by a shuffle, masked after (no branch)
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const float di = __shfl_sync(FULL, d, i);
            sc[i] = EXACT || i < S ? __fsub_rn(di, r[i]) : -INFINITY;
          }
          float best;
          int arg;
          first_max<0, NS>(sc, best, arg);
          d = __fadd_rn(best, EXACT ? r[NS] : row[S]);
          if (lane < S) bpc[f * S + lane] = (unsigned char)arg;
        } else {  // FLOOR
          float sc[NS];
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const float di = __shfl_sync(FULL, d, i);
            sc[i] = EXACT || i < S ? __fsub_rn(di, hold[i]) : -INFINITY;
          }
          d = __fadd_rn(max_of<0, NS>(sc), hold[NS]);
        }
      }
      __syncwarp();
      if (lane == 0) bulk::arrive(cost_empty + slot);
      if (V != FLOOR && p.streamed) {  // the chunk's backpointers to the scratch
        bulk::fence_shared();
        __syncwarp();
        if (lane == 0) bulk::store(scr + (size_t)c * p.CB, bpc, p.CB);
      }
    }
    if constexpr (V == FLOOR) {
      if (lane == 0) f0[(size_t)b * T] = d;  // keeps the chain
    } else {
      // the first argmax of delta_{T-1}: a butterfly, lower state on ties
      float v = lane < S ? d : -INFINITY;
      int state = lane;
#pragma unroll
      for (int m = 1; m < 32; m <<= 1) {
        const float ov = __shfl_xor_sync(FULL, v, m);
        const int oi = __shfl_xor_sync(FULL, state, m);
        if (ov > v || (ov == v && oi < state)) {
          v = ov;
          state = oi;
        }
      }
      if (lane == 0) pa[T - 1] = state;
      if (!p.streamed) {
        // every chunk on chip: the rows [1, T) in 32 segments, one a lane
        // (the header), G states' walks at once
        unsigned char* map = smem + p.off_map;
        constexpr int G = EXACT ? NS : 8;
        const int L = bulk::cdiv(T - 1, 32), lo = 1 + lane * L;
        const int hi = lo + L < T ? lo + L : T;
        for (int s0 = 0; s0 < S; s0 += G) {
          int at[G];
#pragma unroll
          for (int g = 0; g < G; ++g) at[g] = s0 + g < S ? s0 + g : 0;
          for (int t = hi - 1; t >= lo; --t) {
            const unsigned char* row = bp + (t / F) * p.CB + (t % F) * S;
#pragma unroll
            for (int g = 0; g < G; ++g) at[g] = row[at[g]];
          }
#pragma unroll
          for (int g = 0; g < G; ++g)
            if (s0 + g < S) map[lane * 32 + s0 + g] = (unsigned char)at[g];
        }
        __syncwarp();
        if (lane == 0)
          for (int l = 31; l >= 0; --l) {
            map[1024 + l] = (unsigned char)state;
            state = map[l * 32 + state];
          }
        __syncwarp();
        int at = map[1024 + lane];
        for (int t = hi - 1; t >= lo; --t) {
          at = bp[(t / F) * p.CB + (t % F) * S + at];
          pa[t - 1] = at;
        }
      } else if (lane == 0) {
        bulk::stores_done();
        // streamed: chunk by chunk from the last, each loaded into slot
        // c % 2 of the ring while the walk reads the one after it
        int parity = 0;  // bit s: the next phase of slot s's barrier
        auto fetch = [&](int c) {
          bulk::fetch(bp + (c & 1) * p.CB, scr + (size_t)c * p.CB, p.CB, bt + (c & 1));
        };
        fetch(C - 1);
        for (int c = C - 1; c >= 0; --c) {
          if (c > 0) fetch(c - 1);
          bulk::wait(bt + (c & 1), parity >> (c & 1) & 1);
          parity ^= 1 << (c & 1);
          const unsigned char* rows = bp + (c & 1) * p.CB;
          const int lo = c * F > 0 ? c * F : 1;
          for (int t = (c * F + F < T ? c * F + F : T) - 1; t >= lo; --t) {
            state = rows[(t - c * F) * S + state];
            pa[t - 1] = state;
          }
        }
      }
    }
  }
  __syncthreads();
  if constexpr (V != FLOOR) {
    for (int t = tid; t < T; t += THREADS) {
      const int s = pa[t];
      f0[(size_t)b * T + t] = s < K ? fr[(size_t)t * K + s] : 0.f;
    }
  }
}

template <int NS, int V>
int launch(const float* freqs, const float* strengths, const float* unvoiced,
           unsigned char* scratch, int* path, float* f0, int B, int T, int K, const Plan& p,
           cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        viterbi_kernel<NS, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != 0) return err;
  }
  viterbi_kernel<NS, V><<<B, THREADS, p.smem, stream>>>(freqs, strengths, unvoiced, scratch,
                                                        path, f0, T, K, p);
  return (int)cudaGetLastError();
}

// the instance for S states: exact to 8, then 16 or 32
template <int V, int NS = 2>
int dispatch(int S, const float* freqs, const float* strengths, const float* unvoiced,
             unsigned char* scratch, int* path, float* f0, int B, int T, int K, const Plan& p,
             cudaStream_t stream) {
  if constexpr (NS > 32) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (S <= NS)
      return launch<NS, V>(freqs, strengths, unvoiced, scratch, path, f0, B, T, K, p, stream);
    return dispatch<V, NS < 8 ? NS + 1 : 2 * NS>(S, freqs, strengths, unvoiced, scratch, path,
                                                f0, B, T, K, p, stream);
  }
}

template <int V>
int run(const void* freqs, const void* strengths, const void* unvoiced, void* scratch,
        void* path, void* f0, int B, int T, int K, void* stream) {
  if (T < 1 || K < 1 || K > 31) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(T, K);
  if (p.smem < 0) return (int)cudaErrorInvalidValue;
  return dispatch<V>(K + 1, (const float*)freqs, (const float*)strengths,
                     (const float*)unvoiced, (unsigned char*)scratch, (int*)path, (float*)f0,
                     B, T, K, p, (cudaStream_t)stream);
}

}  // namespace

// The plan for T frames of K candidates: field 0 streamed (0 or 1), 1
// frames a chunk, 2 scratch bytes an item (0 unless streamed), 3 dynamic
// shared memory; -1 where nothing fits.
extern "C" int viterbi_candidates_plan(int T, int K, int field) {
  if (T < 1 || K < 1 || K > 31) return -1;
  const Plan p = plan_for(T, K);
  if (p.smem < 0) return -1;
  switch (field) {
    case 0: return p.streamed;
    case 1: return p.F;
    case 2: return p.streamed ? bulk::cdiv(T, p.F) * p.CB : 0;
    case 3: return p.smem;
    default: return -1;
  }
}

// freqs, strengths [B, T, K], unvoiced [B, T] float32; scratch: B x the
// plan's bytes an item (unused unless streamed); path [B, T] int32 and f0
// [B, T] float32 out. The Python wrapper checks shapes and contiguity.
// Returns the cudaError_t of the launch.
extern "C" int viterbi_candidates(const void* freqs, const void* strengths,
                                  const void* unvoiced, void* scratch, void* path, void* f0,
                                  int B, int T, int K, void* stream) {
  return run<RULE>(freqs, strengths, unvoiced, scratch, path, f0, B, T, K, stream);
}

// The same launch with the FLOOR body (the chain floor of a measurement):
// path is not written, f0[b, 0] holds a word of the last frame's scores.
extern "C" int viterbi_candidates_chain(const void* freqs, const void* strengths,
                                        const void* unvoiced, void* scratch, void* path,
                                        void* f0, int B, int T, int K, void* stream) {
  return run<FLOOR>(freqs, strengths, unvoiced, scratch, path, f0, B, T, K, stream);
}
