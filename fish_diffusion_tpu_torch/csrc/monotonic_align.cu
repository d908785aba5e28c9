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
//
// Design: one block an item; the rows never leave the SM. Warp 0 runs the
// DP: lane l owns a strip of W consecutive columns, x = l W + k (W odd, so
// that a row's loads fall in distinct banks), and keeps the strip's row in
// registers; it sends its last column to the next lane by one
// __shfl_up_sync a row as soon as that column is updated, and the next lane
// takes it for its first column a row later, so a whole row hides the
// exchange; each row's values are loaded a row ahead. The update is the JAX
// row update in float32 in the same order (one add, one max; nothing to
// contract), with the same -1e9, and the decision is the same strict
// same < left: paths are bit-equal to the JAX op. One lane of warp 1
// stages the rows of values into a ring of 4 slots of shared memory by TMA
// bulk copies on mbarriers (R rows a slot, 16 KB: tens of rows in flight);
// the DP waits on a slot's mbarrier and frees it by another, once a slot.
// Each row's decisions are the strip's W bits, one store a lane a row (a
// byte for W <= 7) into shared memory; after the last row lane 0 walks
// them from shared memory into the rows' indices (branch-free, each step
// loading the row below's words for both columns it may leave at before
// it decides). The path is written by warps that would idle: warps 2-7
// write every row's zeros in 16-byte stores while the DP runs (a write
// pass after the backtrack added its whole time to the chain's), and after
// the backtrack every thread writes the rows' ones.
//
// Sizes (plan_for): W from T_x (up to 63 columns a lane: T_x <= 2016);
// where the decisions of every row do not fit beside the ring and the
// rows' indices, the plan streams them: a ring of 4 chunks of 4 KB, each
// stored to a device scratch buffer by a bulk copy once full and loaded
// back by bulk copies, a chunk ahead of the walk. Each row's index is a
// 2-byte word of shared memory beside the rings, which caps T_y (between
// about 75,000 and 108,000 rows, by T_x). maximum_path_chain, for
// measurements, launches the same kernel with the FLOOR body: each row's
// exchange, maximum and add on a value held in a register, without the
// loads, the decisions, the backtrack and the path (the chain floor).

#include <cuda_runtime.h>

#include <type_traits>

#include "bulk_copy.cuh"

namespace {

constexpr int THREADS = 256;  // warp 0: the DP; warp 1: the copies; 2-7: the zeros
constexpr int NV = 4;         // value slots
constexpr int ND = 4;         // decision chunks in the streamed ring
constexpr int VALUE_SLOT = 16 * 1024;
constexpr int DEC_CHUNK = 4 * 1024;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e9f;
// the card's dynamic shared memory a block (a host build may set less, so
// that small sizes reach the streamed plan)
#ifndef SMEM_MAX
#define SMEM_MAX 232448
#endif
constexpr int BARS = 2 * NV + 2;  // full [NV], empty [NV], the backtrack's [2]

enum Variant { RULE = 0, FLOOR = 1 };

// the strip widths compiled: every odd width to 15, then steps of 4 and 8
constexpr int WIDTHS[] = {1, 3, 5, 7, 9, 11, 13, 15, 19, 23, 27, 31, 39, 47, 55, 63};

// a lane's decisions of a row: W bits in a byte, a half, a word or two
template <int W>
using Bits = std::conditional_t<
    (W <= 8), unsigned char,
    std::conditional_t<(W <= 16), unsigned short,
                       std::conditional_t<(W <= 32), unsigned, unsigned long long>>>;

struct Plan {
  int W;           // columns a lane
  int U;           // bytes of a lane's decisions a row
  int R;           // rows a value slot
  int slot_words;  // words a value slot
  int RD, rd_log;  // rows a decision chunk, a power of two, and its log2
  int streamed;
  int off_idx, off_val, off_dec, smem;  // bytes
};

Plan layout(int T_y, int T_x, int W, int streamed) {
  Plan p{};
  p.W = W;
  p.U = W <= 8 ? 1 : W <= 16 ? 2 : W <= 32 ? 4 : 8;
  const int row_bytes = 32 * p.U;
  p.R = VALUE_SLOT / (4 * T_x);
  p.R = p.R < 1 ? 1 : p.R > 64 ? 64 : p.R;
  // a slot: R rows, the lead (<= 3 words), and the columns past T_x that
  // the last row's strips read (32 W - T_x: their values are never used)
  p.slot_words = (p.R * T_x + 3 + 32 * W - T_x + 3) / 4 * 4;
  p.RD = DEC_CHUNK / row_bytes;
  for (p.rd_log = 0; 1 << p.rd_log < p.RD;) ++p.rd_log;
  p.streamed = streamed;
  int off = bulk::round16(BARS * 8);
  p.off_idx = off;
  off += bulk::round16(2 * T_y);
  p.off_val = off;
  off += NV * p.slot_words * 4;
  p.off_dec = off;
  p.smem = off + (streamed ? ND * DEC_CHUNK : T_y * row_bytes);
  return p;
}

// every row's decisions on chip if they fit in SMEM_MAX bytes, else
// streamed; smem = -1: T_x past 2016, or not even the streamed plan fits
Plan plan_for(int T_y, int T_x) {
  Plan none{};
  none.smem = -1;
  const int need = bulk::cdiv(T_x, 32);
  int W = 0;
  for (int w : WIDTHS)
    if (W == 0 && w >= need) W = w;
  if (W == 0 || T_y < 1) return none;
  for (int streamed = 0; streamed < 2; ++streamed) {
    const Plan p = layout(T_y, T_x, W, streamed);
    if (p.smem <= SMEM_MAX) return p;
  }
  return none;
}

template <int W, int V>
__global__ void __launch_bounds__(THREADS)
maximum_path_kernel(const float* __restrict__ value, const int* __restrict__ t_ys,
                    const int* __restrict__ t_xs, unsigned char* __restrict__ scratch,
                    int* __restrict__ path, int T_y, int T_x, Plan p) {
  using B = Bits<W>;
  extern __shared__ __align__(16) unsigned char smem[];
  bulk::bar_t* full = reinterpret_cast<bulk::bar_t*>(smem);
  bulk::bar_t* empty = full + NV;
  bulk::bar_t* bt = empty + NV;
  short* idx = reinterpret_cast<short*>(smem + p.off_idx);
  float* vals = reinterpret_cast<float*>(smem + p.off_val);
  unsigned char* dec = smem + p.off_dec;

  const int b = blockIdx.x, tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const size_t cells = (size_t)T_y * T_x;
  const float* val = value + (size_t)b * cells;
  int* out = path + (size_t)b * cells;
  const int ty = t_ys[b], tx = t_xs[b];  // clamped to [0, T], as the wrapper clamps
  const int t_y = ty < 0 ? 0 : ty > T_y ? T_y : ty, t_x = tx < 0 ? 0 : tx > T_x ? T_x : tx;
  const int rows = t_x > 0 ? t_y : 0;      // the DP's rows
  const int C = bulk::cdiv(rows, p.R);
  const int row_bytes = 32 * (int)sizeof(B);
  unsigned char* scr = scratch + (size_t)b * bulk::cdiv(T_y, p.RD) * p.RD * row_bytes;

  if (tid == 0) {
    for (int q = 0; q < NV; ++q) {
      bulk::init(full + q, 2);  // the bytes, the edges
      bulk::init(empty + q, 1);
    }
    bulk::init(bt, 1);
    bulk::init(bt + 1, 1);
    bulk::fence_init();
  }
  __syncthreads();

  if (warp == 1 && lane == 0) {  // the copies: slot c % NV holds rows [c R, c R + R)
    for (int c = 0; c < C; ++c) {
      const int slot = c % NV;
      if (c >= NV) bulk::wait(empty + slot, (c / NV - 1) & 1);
      const int n = ((c + 1) * p.R < rows ? p.R : rows - c * p.R) * T_x;
      const float* src = val + (size_t)c * p.R * T_x;
      float* dst = vals + slot * p.slot_words;
      bulk::stage_edges(dst, src, n);
      bulk::expect(full + slot, bulk::stage_bytes(src, n));
      bulk::stage_middle(dst, src, n, full + slot);
      bulk::edges_landed(full + slot);
      bulk::landed(full + slot);
    }
  } else if (V == RULE && warp >= 2) {
    // the path's zeros, every row, in 16-byte stores while warp 0 runs the
    // DP (the ones follow the backtrack)
    for (int y = warp - 2; y < T_y; y += THREADS / 32 - 2) {
      int* o = out + (size_t)y * T_x;
      const bulk::Span s = bulk::span_of(o, T_x);
      for (int x = lane; x < s.head; x += 32) o[x] = 0;
      int4* mid = reinterpret_cast<int4*>(o + s.head);
      for (int q = lane; q < s.mid / 4; q += 32) mid[q] = make_int4(0, 0, 0, 0);
      for (int x = s.head + s.mid + lane; x < T_x; x += 32) o[x] = 0;
    }
  } else if (warp == 0 && rows > 0) {
    const int x0 = lane * W;
    // the plan's fields the rows read, in registers
    const int R = p.R, slot_words = p.slot_words, streamed = p.streamed;
    const int RD = p.RD, rd_log = p.rd_log;
    float v[W];        // the strip of the row before
    float a[W], n[W];  // this row's values, the next row's (columns past
                       // T_x read the slot's padding: they reach no column
                       // below T_x)
    float left_in = NEG, hold = 0.f;
    auto load = [&](const float* row, float* dst) {
#pragma unroll
      for (int k = 0; k < W; ++k) dst[k] = row[x0 + k];
    };
    for (int c = 0; c < C; ++c) {
      const int slot = c % NV;
      bulk::wait(full + slot, (c / NV) & 1);
      const float* rv = vals + slot * slot_words + bulk::lead(val + (size_t)c * R * T_x);
      const int nr = (c + 1) * R < rows ? R : rows - c * R;
      int r = 0;
      if (c == 0) {  // row 0, pinned to x = 0
        load(rv, a);
#pragma unroll
        for (int k = 0; k < W; ++k) v[k] = __fadd_rn(a[k], x0 + k == 0 ? 0.f : NEG);
        hold = v[0];
        left_in = __shfl_up_sync(FULL, v[W - 1], 1);
        left_in = lane == 0 ? NEG : left_in;
        r = 1;
      }
      // one row from its values a, loading the slot's next row (or this one
      // again, at the slot's end) into nx: the strip from its last column,
      // whose value goes to the next lane at once (for the next row); the
      // first column takes the value the row before sent
      auto row = [&](int r, const float* a, float* nx) {
        const int y = c * R + r;
        if constexpr (V == RULE) load(rv + (r + 1 < nr ? r + 1 : r) * T_x, nx);
        B bits = 0;
        float sent = 0.f;
#pragma unroll
        for (int k = W - 1; k >= 0; --k) {
          const float left = k > 0 ? v[k - 1] : left_in, same = v[k];
          if constexpr (V == RULE) {
            bits |= (B)(same < left) << k;
            v[k] = __fadd_rn(a[k], fmaxf(left, same));
          } else {
            v[k] = __fadd_rn(hold, fmaxf(left, same));
          }
          if (k == W - 1) sent = __shfl_up_sync(FULL, v[k], 1);
        }
        left_in = lane == 0 ? NEG : sent;
        if constexpr (V == RULE) {
          B* drow;
          if (streamed) {
            const int cd = y >> rd_log, rr = y & (RD - 1);
            if (rr == 0 && cd >= ND) {  // the slot's last store has read it
              if (lane == 0) bulk::stores_read<ND - 1>();
              __syncwarp();
            }
            drow = reinterpret_cast<B*>(dec + (cd % ND) * DEC_CHUNK) + rr * 32;
          } else {
            drow = reinterpret_cast<B*>(dec) + (size_t)y * 32;
          }
          drow[lane] = bits;
          if (streamed && ((y & (RD - 1)) == RD - 1 || y == rows - 1)) {
            bulk::fence_shared();
            __syncwarp();
            const int cd = y >> rd_log;
            if (lane == 0)
              bulk::store(scr + (size_t)cd * DEC_CHUNK, dec + (cd % ND) * DEC_CHUNK, DEC_CHUNK);
          }
        }
      };
      if constexpr (V == RULE) load(rv + (r < nr ? r : 0) * T_x, n);
      for (; r + 1 < nr; r += 2) {  // two rows, the value buffers in turn
        row(r, n, a);
        row(r + 1, a, n);
      }
      if (r < nr) row(r, n, a);
      __syncwarp();
      if (lane == 0) bulk::arrive(empty + slot);
    }
    if constexpr (V == FLOOR) {
      if (lane == 0) out[0] = __float_as_int(v[0]) ^ __float_as_int(v[W - 1]);
    } else if (lane == 0) {
      // the backtrack: decision chunk by chunk from the last (on chip, one
      // chunk of every row); streamed, each loaded into slot cd % 2 of the
      // ring while the walk reads the one after it. Each step loads the
      // words of the row below for both columns the step may leave it at,
      // before it decides, and then picks one.
      const int CH = streamed ? RD : rows;  // rows a decision chunk
      const int chunks = bulk::cdiv(rows, CH);
      int index = t_x - 1, li = index / W, k = index % W, parity = 0;
      auto fetch = [&](int cd) {
        bulk::fetch(dec + (cd & 1) * DEC_CHUNK, scr + (size_t)cd * DEC_CHUNK, DEC_CHUNK,
                    bt + (cd & 1));
      };
      if (streamed) {
        bulk::stores_done();
        fetch(chunks - 1);
      }
      // one step: row y's decision at the index, from its word w
      auto step = [&](int y, B w) {
        const int move = (index != 0) & ((index == y) | (int)(w >> k & 1));
        const int wrap = move & (k == 0);
        index -= move;
        k = wrap ? W - 1 : k - move;
        li -= wrap;
        return wrap;
      };
      for (int cd = chunks - 1; cd >= 0; --cd) {
        const B* d = reinterpret_cast<const B*>(dec);
        if (streamed) {
          if (cd > 0) fetch(cd - 1);
          bulk::wait(bt + (cd & 1), parity >> (cd & 1) & 1);
          parity ^= 1 << (cd & 1);
          d = reinterpret_cast<const B*>(dec + (cd & 1) * DEC_CHUNK);
        }
        // d[(y - lo) * 32 + l]: lane l's decisions of row y; rows above lo
        // load the row below's words for both lanes the step may leave at
        const int lo = cd * CH, hi = (cd + 1) * CH < rows ? (cd + 1) * CH : rows;
        const int last = lo > 1 ? lo : 1;  // the lowest row that decides
        B w = hi - 1 >= last ? d[(size_t)(hi - 1 - lo) * 32 + li] : 0;
        for (int y = hi - 1; y > last; --y) {
          idx[y] = (short)index;
          const B* dn = d + (size_t)(y - 1 - lo) * 32;
          const B same = dn[li], left = dn[li > 0 ? li - 1 : 0];
          w = step(y, w) ? left : same;
        }
        if (hi - 1 >= last) {
          idx[last] = (short)index;
          step(last, w);
        }
      }
      idx[0] = (short)index;
    }
  }
  __syncthreads();
  if constexpr (V == RULE) {  // the ones, one a row of the path
    for (int y = tid; y < rows; y += THREADS) out[(size_t)y * T_x + idx[y]] = 1;
  }
}

template <int W, int V>
int launch(const float* value, const int* t_ys, const int* t_xs, unsigned char* scratch,
           int* path, int B, int T_y, int T_x, const Plan& p, cudaStream_t stream) {
  if (p.smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        maximum_path_kernel<W, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
    if (err != 0) return err;
  }
  maximum_path_kernel<W, V><<<B, THREADS, p.smem, stream>>>(value, t_ys, t_xs, scratch, path,
                                                            T_y, T_x, p);
  return (int)cudaGetLastError();
}

template <int V, int I = 0>
int dispatch(const float* value, const int* t_ys, const int* t_xs, unsigned char* scratch,
             int* path, int B, int T_y, int T_x, const Plan& p, cudaStream_t stream) {
  if constexpr (I == sizeof(WIDTHS) / sizeof(WIDTHS[0])) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (p.W == WIDTHS[I])
      return launch<WIDTHS[I], V>(value, t_ys, t_xs, scratch, path, B, T_y, T_x, p, stream);
    return dispatch<V, I + 1>(value, t_ys, t_xs, scratch, path, B, T_y, T_x, p, stream);
  }
}

template <int V>
int run(const void* value, const void* t_ys, const void* t_xs, void* scratch, void* path,
        int B, int T_y, int T_x, void* stream) {
  if (T_y < 1 || T_x < 1) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(T_y, T_x);
  if (p.smem < 0) return (int)cudaErrorInvalidValue;
  return dispatch<V>((const float*)value, (const int*)t_ys, (const int*)t_xs,
                     (unsigned char*)scratch, (int*)path, B, T_y, T_x, p, (cudaStream_t)stream);
}

}  // namespace

// The plan for [T_y, T_x]: field 0 streamed (0 or 1), 1 columns a lane, 2
// rows a value slot, 3 scratch bytes an item (0 unless streamed), 4 dynamic
// shared memory; -1 where the kernel refuses the size (T_x past 2016, or
// the rows' indices and the rings past shared memory).
extern "C" int maximum_path_plan(int T_y, int T_x, int field) {
  if (T_y < 1 || T_x < 1) return -1;
  const Plan p = plan_for(T_y, T_x);
  if (p.smem < 0) return -1;
  switch (field) {
    case 0: return p.streamed;
    case 1: return p.W;
    case 2: return p.R;
    case 3: return p.streamed ? bulk::cdiv(T_y, p.RD) * DEC_CHUNK : 0;
    case 4: return p.smem;
    default: return -1;
  }
}

// value [B, T_y, T_x] float32, t_ys / t_xs [B] int32 in [0, T_y] and
// [0, T_x], scratch: B x the plan's bytes an item (unused unless
// streamed), path [B, T_y, T_x] int32 (written whole). Contiguous, on one
// device (the Python wrapper checks). Returns the cudaError_t of the
// launch.
extern "C" int maximum_path(const void* value, const void* t_ys, const void* t_xs,
                            void* scratch, void* path, int B, int T_y, int T_x, void* stream) {
  return run<RULE>(value, t_ys, t_xs, scratch, path, B, T_y, T_x, stream);
}

// The same launch with the FLOOR body (the chain floor of a measurement):
// the path is not written but for path[b, 0, 0], a word of the last row.
extern "C" int maximum_path_chain(const void* value, const void* t_ys, const void* t_xs,
                                  void* scratch, void* path, int B, int T_y, int T_x,
                                  void* stream) {
  return run<FLOOR>(value, t_ys, t_xs, scratch, path, B, T_y, T_x, stream);
}
