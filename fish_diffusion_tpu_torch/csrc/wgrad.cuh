// The weight gradient of the port's 1-D and 2-D convolutions, shared by
// conv1d_wgrad.cu (K4's direct and transposed convs, K6's grouped convs)
// and conv2d.cu (K6 2-D). Include after <cuda_runtime.h>.
//
// One problem covers both. The reduction runs over lines and positions t
// along a line; tap (kh, k) of a line reads the A line of input row kh at
// position t * S + k * D - P:
//
//   dW[kh, k, i, g * CB_g + j] = sum_{line, t} act_a(A[row(line, kh), t * S + k * D - P, g * CA_g + i])
//                                              * act_b(Bm[line, t, g * CB_g + j])
//
// 1-D: the lines are the batch rows and KH = 1. 2-D: the lines are (b, h)
// over B x H_out, and row(line, kh) = input row h * SH + kh - PH of item b
// (rows outside [0, H_in) read 0, as do positions outside [0, T_a)).
// out is [KH, K, CA_g, CB] (1-D: [K, CA_g, CB]; 2-D: [KH, KW, C_in, C_out]).
//
// Bound on an H100: float32 operations on the SIMT units (67 TFLOP/s),
// since each input element is used K * KH * CB_g times. Design:
// - A block owns an output tile: KHB tap rows x NTGW groups of QK adjacent
//   taps x BC input channels x BO output channels of one group. Its
//   threads are (tap group, position lane, input-channel lane, output-
//   channel lane); each holds QK x QC x QO accumulators and, per position,
//   reads QC floats of the window for each of its QK taps and QO floats of
//   Bm: 96 FMAs for 20 shared-memory words in the main tile (3 x 4 x 8).
// - The reduction is cut into units, a line's strip of TW positions. For a
//   unit the block stages in shared memory the input window the strip
//   reads for its taps, halo included (KHB rows x (TW - 1) * S + (KWB - 1)
//   * D + 1 columns x BC channels), and the strip of Bm (TW x BO). Every
//   tap reads the window at its offset, so an input element crosses from
//   L2 once per block and unit, not once per tap.
// - The units stream through a ring of STAGES buffers filled by cp.async
//   (16 bytes where the channels allow, zero-filled outside the input), so
//   the next units' copies overlap this one's FMAs; one barrier per unit.
//   The leaky-ReLU flags are applied in place by the thread that copied
//   each element, before the barrier.
// - A block takes a contiguous chunk of the units and writes its partial
//   tile; a second kernel adds the chunks' partials in chunk order. With
//   position lanes (PL > 1) a block first adds its lanes' sums in lane
//   order through shared memory. Every order is fixed by the plan, so two
//   launches on the same inputs give the same bits (no atomics).
// - The plan (plan_for, make_plan, prepare) fills the card once, never more:
//   splits round down to whole waves of blocks, and the strip narrows
//   while its ring would cost a block per SM. Its rules were set by A/Bs
//   on an H100 at the training shapes (PERF.md §6). A problem is planned
//   once (cached_plan); a launch only turns the 16-byte copies off where
//   a or bm is not 16-byte aligned (a view at an offset). Measured there
//   (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): one MRD pass 10.67
//   ms, 54% of its float32 bound (the first version, an im2col gather per
//   tap from global memory, 49.31; cuDNN 20.29); the 8 tracked 1-D shapes
//   of the NSF-HiFiGAN step 5.98 ms, 52% (16.09; cuDNN 13.21).

#include <array>
#include <cstdint>
#include <map>
#include <mutex>

#include "async_copy.cuh"

namespace wgrad {

using namespace acopy;

constexpr int STAGES = 3;
constexpr int MAX_THREADS = 256;

struct Args {
  int B, H_in, H_out, KH, SH, PH;  // 1-D: H_in = H_out = KH = SH = 1, PH = 0
  int T_a, T_b, CA, CB, K, S, D, P, groups;
  float slope_a, slope_b;
  int act_a, act_b;
};

// The tiling of one problem: a function of its shapes and of the card (its
// SM count, the kernel's occupancy), the same for every launch.
struct Plan {
  int variant;                    // the thread tile, see plan_for
  int WC, WO, NTGW, KHB, PL, TW;  // lanes and tap groups; positions per unit
  int c_tiles, o_tiles, kw_blocks, kh_blocks, tiles;
  int strips, units, splits, chunk, slots;  // slots: blocks the card holds
  int threads, cols, x_floats, g_stride, stage_floats, smem_bytes;
  int vec_a, vec_b;  // 16-byte copies of A / Bm (the channels allow them)
};

// The block's tile and the unit geometry, shared by the staging code.
struct Tile {
  int g, c0, o0, kw0, kh0, BC, BO, CA_g, CB_g;
};

// Start the copies of unit u into ring slot `slot`: the window (rows x cols
// x BC channels) and the strip (TW x BO). Each thread copies the chunks
// idx = tid, tid + threads, ...; `activate` walks the same chunks.
__device__ __forceinline__ void stage_unit(const float* __restrict__ a,
                                           const float* __restrict__ bm,
                                           float* slot, int u, const Args& p,
                                           const Plan& q, const Tile& t) {
  const int line = u / q.strips, s = u - line * q.strips;
  const int b = line / p.H_out, h = line - b * p.H_out;
  const int col_lo = s * q.TW * p.S - p.P + t.kw0 * p.D;
  const int tid = threadIdx.x, nt = blockDim.x;
  // the window: chunk idx is (row r, column c, channels cc..cc+va); when
  // the threads cover whole columns, a thread keeps its channels and walks
  // the columns without dividing
  const int va = q.vec_a ? 4 : 1;
  const int per_col = t.BC / va;
  const int nx = q.KHB * q.cols * per_col;
  const size_t chan = (size_t)t.g * t.CA_g + t.c0;
  auto copy_x = [&](int idx, int r, int c, int cc) {
    const int row = h * p.SH + t.kh0 + r - p.PH;
    const int col = col_lo + c;
    const bool in = t.kh0 + r < p.KH && row >= 0 && row < p.H_in && col >= 0 &&
                    col < p.T_a && t.c0 + cc < t.CA_g;
    const float* src =
        in ? a + (((size_t)b * p.H_in + row) * p.T_a + col) * p.CA + chan + cc : a;
    if (va == 4) {
      copy16(slot + idx * 4, src, in);
    } else {
      copy4(slot + idx, src, in);
    }
  };
  if (nt % per_col == 0) {
    const int cc = (tid % per_col) * va, step = nt / per_col;
    int c = tid / per_col, r = c / q.cols;
    c -= r * q.cols;
    for (int idx = tid; idx < nx; idx += nt) {
      copy_x(idx, r, c, cc);
      for (c += step; c >= q.cols; c -= q.cols) ++r;
    }
  } else {
    for (int idx = tid; idx < nx; idx += nt) {
      const int rc = idx / per_col;
      copy_x(idx, rc / q.cols, rc % q.cols, (idx % per_col) * va);
    }
  }
  // the strip of Bm: chunk idx is (position pp, channels oo..oo+vb)
  float* gs = slot + q.x_floats;
  const int vb = q.vec_b ? 4 : 1;
  const int per_pos = t.BO / vb;
  const int ng = q.TW * per_pos;
  auto copy_g = [&](int pp, int oo) {
    const int tt = s * q.TW + pp;
    const bool ok = tt < p.T_b && t.o0 + oo < t.CB_g;
    const float* src =
        ok ? bm + ((size_t)line * p.T_b + tt) * p.CB + t.g * t.CB_g + t.o0 + oo : bm;
    if (vb == 4) {
      copy16(gs + pp * q.g_stride + oo, src, ok);
    } else {
      copy4(gs + pp * q.g_stride + oo, src, ok);
    }
  };
  if (nt % per_pos == 0) {
    const int oo = (tid % per_pos) * vb, step = nt / per_pos;
    for (int pp = tid / per_pos; pp < q.TW; pp += step) copy_g(pp, oo);
  } else {
    for (int idx = tid; idx < ng; idx += nt) copy_g(idx / per_pos, (idx % per_pos) * vb);
  }
}

// leaky-ReLU in place on the chunks this thread copied into `slot`
__device__ __forceinline__ void activate(float* slot, const Args& p,
                                         const Plan& q, const Tile& t) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (p.act_a) {
    const int n = q.KHB * q.cols * t.BC;  // the chunks are contiguous
    const int va = q.vec_a ? 4 : 1;
    for (int idx = tid; idx < n / va; idx += nt)
      for (int i = 0; i < va; ++i) {
        float& v = slot[idx * va + i];
        v = v < 0.f ? v * p.slope_a : v;
      }
  }
  if (p.act_b) {
    float* gs = slot + q.x_floats;
    const int vb = q.vec_b ? 4 : 1;
    const int per_pos = t.BO / vb;
    for (int idx = tid; idx < q.TW * per_pos; idx += nt)
      for (int i = 0; i < vb; ++i) {
        float& v = gs[(idx / per_pos) * q.g_stride + (idx % per_pos) * vb + i];
        v = v < 0.f ? v * p.slope_b : v;
      }
  }
}

// The partial sums of one chunk of units for one output tile. part is
// [splits, KH * K * CA_g * CB] in out's layout.
template <int QK, int QC, int QO>
__global__ void __launch_bounds__(MAX_THREADS) partial_kernel(
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ part, Args p, Plan q) {
  extern __shared__ __align__(16) float wgrad_smem[];
  float* smem = wgrad_smem;
  const int tid = threadIdx.x;
  const int ol = tid % q.WO;
  const int cl = (tid / q.WO) % q.WC;
  const int pl = (tid / (q.WO * q.WC)) % q.PL;
  const int tg = tid / (q.WO * q.WC * q.PL);
  const int tr = tg / q.NTGW, tw = tg % q.NTGW;

  Tile t;
  int bi = blockIdx.x;
  const int ot = bi % q.o_tiles;
  bi /= q.o_tiles;
  const int ct = bi % q.c_tiles;
  bi /= q.c_tiles;
  const int kwb = bi % q.kw_blocks;
  bi /= q.kw_blocks;
  const int khb = bi % q.kh_blocks;
  t.g = bi / q.kh_blocks;
  t.CA_g = p.CA / p.groups;
  t.CB_g = p.CB / p.groups;
  t.BC = q.WC * QC;
  t.BO = q.WO * QO;
  t.c0 = ct * t.BC;
  t.o0 = ot * t.BO;
  t.kw0 = kwb * q.NTGW * QK;
  t.kh0 = khb * q.KHB;

  const int u_lo = blockIdx.y * q.chunk;
  const int n = (u_lo + q.chunk < q.units ? u_lo + q.chunk : q.units) - u_lo;

  float acc[QK][QC][QO];
#pragma unroll
  for (int j = 0; j < QK; ++j)
#pragma unroll
    for (int c = 0; c < QC; ++c)
#pragma unroll
      for (int o = 0; o < QO; ++o) acc[j][c][o] = 0.f;

  // the thread's first window word (its tap row and first tap, position 0)
  // and strip word, relative to a slot
  const int x_off = (tr * q.cols + tw * QK * p.D) * t.BC + cl * QC;
  const int g_off = q.x_floats + ol * QO;
  const int x_step = p.S * t.BC;    // one position along the window
  const int tap_step = p.D * t.BC;  // one tap along the window

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) stage_unit(a, bm, smem + s * q.stage_floats, u_lo + s, p, q, t);
    copy_commit();
  }
  for (int it = 0; it < n; ++it) {
    float* slot = smem + (it % STAGES) * q.stage_floats;
    copy_wait<STAGES - 2>();
    if (p.act_a | p.act_b) activate(slot, p, q, t);
    __syncthreads();
    if (it + STAGES - 1 < n)
      stage_unit(a, bm, smem + ((it + STAGES - 1) % STAGES) * q.stage_floats,
                 u_lo + it + STAGES - 1, p, q, t);
    copy_commit();

    const float* xs = slot + x_off + pl * x_step;
    const float* gs = slot + g_off + pl * q.g_stride;
#pragma unroll 2
    for (int pp = pl; pp < q.TW; pp += q.PL) {
      float gv[QO];
      load_vec<QO>(gs, gv);
#pragma unroll
      for (int j = 0; j < QK; ++j) {
        float xv[QC];
        load_vec<QC>(xs + j * tap_step, xv);
#pragma unroll
        for (int c = 0; c < QC; ++c)
#pragma unroll
          for (int o = 0; o < QO; ++o) acc[j][c][o] += xv[c] * gv[o];
      }
      xs += q.PL * x_step;
      gs += q.PL * q.g_stride;
    }
  }
  copy_wait<0>();

  // position lanes: lane 0 adds the others' sums, in lane order, one tap
  // at a time through shared memory
  if (q.PL > 1) {
    const int lanes = q.WO * q.WC;
    const int nt = blockDim.x;
#pragma unroll
    for (int j = 0; j < QK; ++j) {
      __syncthreads();
#pragma unroll
      for (int c = 0; c < QC; ++c)
#pragma unroll
        for (int o = 0; o < QO; ++o) smem[(c * QO + o) * nt + tid] = acc[j][c][o];
      __syncthreads();
      if (pl == 0) {
#pragma unroll
        for (int c = 0; c < QC; ++c)
#pragma unroll
          for (int o = 0; o < QO; ++o)
            for (int k = 1; k < q.PL; ++k)
              acc[j][c][o] += smem[(c * QO + o) * nt + tid + k * lanes];
      }
    }
    if (pl != 0) return;
  }

  const int kh = t.kh0 + tr;
  if (kh >= p.KH) return;
  float* out = part + (size_t)blockIdx.y * p.KH * p.K * t.CA_g * p.CB;
#pragma unroll
  for (int j = 0; j < QK; ++j) {
    const int k = t.kw0 + tw * QK + j;
    if (k >= p.K) continue;
#pragma unroll
    for (int c = 0; c < QC; ++c) {
      const int i = t.c0 + cl * QC + c;
      if (i >= t.CA_g) continue;
      float* row = out + (((size_t)kh * p.K + k) * t.CA_g + i) * p.CB +
                   t.g * t.CB_g;
#pragma unroll
      for (int o = 0; o < QO; ++o) {
        const int jj = t.o0 + ol * QO + o;
        if (jj < t.CB_g) row[jj] = acc[j][c][o];
      }
    }
  }
}

// out[idx] = sum over splits, in order, of the partials
__global__ void __launch_bounds__(MAX_THREADS)
    reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                  int n, int splits) {
  const int idx = blockIdx.x * MAX_THREADS + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + idx];
  out[idx] = s;
}

// --- planning (host) ---

// tw_max: the widest strip to consider (prepare narrows it while the ring
// costs blocks per SM)
template <int QK, int QC, int QO>
Plan make_plan(const Args& p, int tw_max) {
  Plan q{};
  const int CA_g = p.CA / p.groups, CB_g = p.CB / p.groups;
  q.WO = cdiv(CB_g, QO) < 4 ? cdiv(CB_g, QO) : 4;
  q.WC = cdiv(CA_g, QC) < 8 ? cdiv(CA_g, QC) : 8;
  const int lanes = q.WO * q.WC;
  // tap groups along a row, split over the fewest blocks of at most
  // MAX_THREADS threads that waste the fewest groups
  const int groups_w = cdiv(p.K, QK);
  const int most = MAX_THREADS / lanes > 1 ? MAX_THREADS / lanes : 1;
  q.kw_blocks = cdiv(groups_w, most);
  for (int kwb = q.kw_blocks, waste = 1 << 30; kwb <= groups_w && waste; ++kwb)
    if (kwb * cdiv(groups_w, kwb) - groups_w < waste) {
      waste = kwb * cdiv(groups_w, kwb) - groups_w;
      q.kw_blocks = kwb;
    }
  q.NTGW = cdiv(groups_w, q.kw_blocks);
  q.KHB = 1;  // as many tap rows as fit, a divisor of KH
  for (int d = p.KH; d > 1; --d)
    if (p.KH % d == 0 && d * q.NTGW <= most) {
      q.KHB = d;
      break;
    }
  q.kh_blocks = p.KH / q.KHB;
  q.c_tiles = cdiv(CA_g, q.WC * QC);
  q.o_tiles = cdiv(CB_g, q.WO * QO);
  q.tiles = p.groups * q.kh_blocks * q.kw_blocks * q.c_tiles * q.o_tiles;
  const int threads0 = q.KHB * q.NTGW * lanes;
  // position lanes: at least 64 threads a block; a block of one warp or
  // less also takes enough lanes that its strips (up to 32 positions a
  // lane) are twice the window's halo. On an H100 at the training shapes
  // more lanes than that lose: the larger ring takes blocks off the SM.
  q.PL = 1;
  while (q.PL < 8 && threads0 * q.PL < 64) q.PL *= 2;
  const int halo = (q.NTGW * QK - 1) * p.D;
  bool for_halo = false;
  if (threads0 <= 32)
    while (q.PL < 8 && q.PL * 32 * p.S < 2 * halo && threads0 * q.PL * 2 <= MAX_THREADS) {
      q.PL *= 2;
      for_halo = true;
    }
  q.threads = threads0 * q.PL;
  // positions per unit: the multiple of PL in [lo, 2 lo] that computes the
  // fewest positions past the end of a line (the larger on a tie); lo is
  // 32, at least 8 positions a lane, 16 where the halo set the lanes
  int lo = 32;
  if (8 * q.PL > lo) lo = 8 * q.PL;
  if (for_halo && 16 * q.PL > lo) lo = 16 * q.PL;
  int hi = 2 * lo < tw_max ? 2 * lo : tw_max / q.PL * q.PL;
  if (hi < q.PL) hi = q.PL;
  if (lo > hi) lo = hi / 2 / q.PL * q.PL > q.PL ? hi / 2 / q.PL * q.PL : q.PL;
  q.TW = 0;
  for (int tw = hi; tw >= lo; tw -= q.PL)
    if (q.TW == 0 || cdiv(p.T_b, tw) * tw < cdiv(p.T_b, q.TW) * q.TW) q.TW = tw;
  const int BC = q.WC * QC, BO = q.WO * QO;
  q.vec_a = QC % 4 == 0 && p.CA % 4 == 0 && CA_g % 4 == 0;
  q.vec_b = BO % 4 == 0 && p.CB % 4 == 0 && CB_g % 4 == 0;
  q.g_stride = q.PL > 1 && BO % 4 == 0 ? BO + 4 : BO;  // +4 spreads the lanes' rows
  for (;;) {
    q.cols = (q.TW - 1) * p.S + (q.NTGW * QK - 1) * p.D + 1;
    q.x_floats = (q.KHB * q.cols * BC + 3) & ~3;
    q.stage_floats = q.x_floats + ((q.TW * q.g_stride + 3) & ~3);
    if (STAGES * q.stage_floats * 4 <= 96 * 1024 || q.TW <= 4 || q.TW <= q.PL)
      break;
    q.TW /= 2;
  }
  const int ring = STAGES * q.stage_floats;
  const int red = q.PL > 1 ? q.threads * QC * QO : 0;
  q.smem_bytes = 4 * (ring > red ? ring : red);
  q.strips = cdiv(p.T_b, q.TW);
  q.units = p.B * p.H_out * q.strips;
  return q;
}

// Serialises planning and launching (ctypes drops the GIL during a call):
// the plan cache and each kernel's shared-memory limit are shared.
std::mutex& lock() {
  static std::mutex mu;
  return mu;
}

// The kernel's dynamic shared-memory limit, set before every planning step
// and every launch of a plan over 48 KB. It only grows, so every plan made
// before still launches. Set once and not again, the MRD's 53 KB plans ran
// up to 14% slower on an H100 (the same plans; a preferred carveout of all
// shared memory did not help; PERF.md §6).
template <int QK, int QC, int QO>
int smem_limit(int bytes) {
  static int limit = 48 * 1024;
  if (bytes <= 48 * 1024) return 0;
  if (bytes > limit) limit = bytes;
  return (int)cudaFuncSetAttribute(partial_kernel<QK, QC, QO>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
}

template <int QK, int QC, int QO>
int prepare(const Args& p, int variant, Plan* q) {
  auto kernel = partial_kernel<QK, QC, QO>;
  // the blocks an SM holds by registers and threads alone; the strip
  // narrows until its ring costs none of them (or reaches 16 positions)
  int per_sm = 0, by_regs = 0;
  for (int tw_max = 1 << 20;; tw_max = q->TW - q->PL) {
    *q = make_plan<QK, QC, QO>(p, tw_max);
    q->variant = variant;
    int err = smem_limit<QK, QC, QO>(q->smem_bytes);
    if (!err && by_regs == 0)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&by_regs, kernel,
                                                               q->threads, 0);
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, q->threads, q->smem_bytes);
    if (err) return err;
    if (per_sm >= by_regs || q->TW <= 16 || q->TW <= q->PL) break;
  }
  // as many blocks as fill the card once, never more (a few blocks past a
  // full wave would run as a second wave), each chunk at least 4 units
  q->slots = (per_sm < 1 ? 1 : per_sm) * sm_count();
  const long want = q->slots / q->tiles;
  const long most = cdiv(q->units, 4);
  const long s = want < most ? want : most;
  q->splits = (int)(s < 1 ? 1 : s);
  return 0;
}

// The thread tile (taps x input channels x output channels a thread):
// 1 a single input channel (MRD layer 0, the noise convs), 2 a single
// output channel (conv_post), else 0 (3 taps, 167 registers on sm_90a) or
// 3 (2 taps, 128 registers): 2 taps where they waste fewer taps, or where
// 3-tap groups span several blocks (the MSD's k = 41) and the 2-tap plan
// fills at least 90% of the card's block slots; it then packs two blocks
// of 224 threads on an SM where the 3-tap tile fits one.
int plan_for(const Args& p, Plan* q) {
  if (p.CB / p.groups == 1) return prepare<3, 4, 1>(p, 2, q);
  if (p.CA / p.groups == 1) return prepare<9, 1, 8>(p, 1, q);
  if (cdiv(p.K, 2) * 2 < cdiv(p.K, 3) * 3) return prepare<2, 4, 8>(p, 3, q);
  int err = prepare<3, 4, 8>(p, 0, q);
  if (err || q->kw_blocks == 1) return err;
  Plan two;
  err = prepare<2, 4, 8>(p, 3, &two);
  if (!err && 10L * two.tiles * two.splits >= 9L * two.slots) *q = two;
  return err;
}

template <int QK, int QC, int QO>
int launch_partial(const float* a, const float* bm, float* part, const Args& p,
                   const Plan& q, cudaStream_t stream) {
  auto kernel = partial_kernel<QK, QC, QO>;
  const int err = smem_limit<QK, QC, QO>(q.smem_bytes);
  if (err) return err;
  dim3 grid(q.tiles, q.splits);
  kernel<<<grid, q.threads, q.smem_bytes, stream>>>(a, bm, part, p, q);
  return (int)cudaGetLastError();
}

// plan_for once per problem (the shapes; not the slopes): planning asks the
// occupancy API for each strip it tries, and a training step calls these
// kernels 100-200 times on a few dozen shapes. The caller holds lock().
int cached_plan(const Args& p, Plan* q) {
  static std::map<std::array<int, 15>, Plan> plans;
  const std::array<int, 15> key{p.B,   p.H_in, p.H_out, p.KH, p.SH,
                                p.PH,  p.T_a,  p.T_b,   p.CA, p.CB,
                                p.K,   p.S,    p.D,     p.P,  p.groups};
  auto it = plans.find(key);
  if (it == plans.end()) {
    Plan fresh;
    const int err = plan_for(p, &fresh);
    if (err) return err;
    it = plans.emplace(key, fresh).first;
  }
  *q = it->second;
  return 0;
}

// The planned number of splits, which sizes the wrapper's partial buffer.
int splits_for(const Args& p) {
  std::lock_guard<std::mutex> hold(lock());
  Plan q;
  const int err = cached_plan(p, &q);
  return err ? -err : q.splits;
}

// Both passes with the caller's `splits` (any value >= 1): part is
// [splits, KH * K * CA_g * CB] (scratch, unused when splits == 1).
int run(const float* a, const float* bm, float* part, float* out,
        const Args& p, int splits, cudaStream_t stream) {
  std::lock_guard<std::mutex> hold(lock());
  Plan q;
  int err = cached_plan(p, &q);
  if (err) return err;
  // a 16-byte cp.async needs a 16-byte-aligned source; the plan's offsets
  // keep the alignment of a and bm, which a view at an offset may lack
  // (the window's layout is the same with 4-byte copies)
  if (reinterpret_cast<uintptr_t>(a) % 16) q.vec_a = 0;
  if (reinterpret_cast<uintptr_t>(bm) % 16) q.vec_b = 0;
  q.splits = splits;
  q.chunk = cdiv(q.units, splits);
  float* dst = splits == 1 ? out : part;
  switch (q.variant) {
    case 1:
      err = launch_partial<9, 1, 8>(a, bm, dst, p, q, stream);
      break;
    case 2:
      err = launch_partial<3, 4, 1>(a, bm, dst, p, q, stream);
      break;
    case 3:
      err = launch_partial<2, 4, 8>(a, bm, dst, p, q, stream);
      break;
    default:
      err = launch_partial<3, 4, 8>(a, bm, dst, p, q, stream);
  }
  if (err || splits == 1) return err;
  const int n = p.KH * p.K * (p.CA / p.groups) * p.CB;
  const int blocks = cdiv(n, MAX_THREADS);
  reduce_kernel<<<blocks, MAX_THREADS, 0, stream>>>(part, out, n, splits);
  return (int)cudaGetLastError();
}

}  // namespace wgrad
