// K10: the ConvNeXt block's depthwise dilated conv7 with its pre-add,
// padding mask and LayerNorm, in one pass.
//
// Replaces fish_diffusion_tpu/models/convnext.py:47 DepthwiseConv7 (the
// conv as 7 shifted broadcast multiplies for the TPU's vector unit, with a
// lax.switch over static shifts), together with what ConvNeXtBlock (:105)
// does right before it (the step and condition projections added, the
// padding rows zeroed) and right after it (nn.LayerNorm, eps 1e-6):
//
//   y[t, c]   = mask[t] ? 0 : (x[t, c] + step[c]) + cond[t, c],
//               0 outside [0, T)
//   h[t, c]   = b[c] + sum_{j < 7} k[j, c] y[t + (j - 3) d, c]
//   out[t, c] = (h[t, c] - mean_t) / sqrt(var_t + eps) * scale[c] + bias[c]
//
// with mean_t and the biased var_t over the C channels of row t. The mask
// applies to each tap's source row, so taps that cross into padding read 0.
//
// Bound on an H100: bytes. x and cond are read and out written once, 12
// bytes an element, against 24 float operations an element (2 for the
// pre-add, 14 for the taps and the bias, 8 for the norm): at B=4 x 1024
// frames x 512 channels, 25.2 MB, 7.5 us at 3.35 TB/s.
// Design: a block owns ROWS rows of one residue class t = r + i * d of one
// batch item (a tile of i), and all C channels. A tap of a row in class r
// lies in class r too, so the block's window is ROWS + 6 rows of its class
// whatever the dilation: a halo of 6 rows, not of 6 d. First, which of the
// window's source rows are live (inside [0, T), not padding) goes to
// shared memory. Phase 1, threads over channels: a thread loads its
// channel's window into registers with unconditional loads (a dead row
// reads its nearest row of the class and counts as 0), so that all its
// loads are in flight at once, adds and masks each source row as it lands,
// and writes its ROWS conv outputs into shared memory (a ROWS x C tile).
// Phase 2: the mean, then the variance about it (two passes, so that a row
// of constant h has variance 0 and gives the ln bias, not NaN), each row's
// sum taken by THREADS / ROWS threads over interleaved channels and their
// partial sums added in a fixed order: no atomics and no warp intrinsics
// (the same code runs in the host emulation of the tests), reruns
// bit-equal. Phase 3, threads over channels: normalise and write the
// tile's rows. At most 128 registers, two blocks an SM. Any T and
// dilation; C up to what the tile leaves of shared memory (3614).
// (A first version that branched on each source row's mask before loading
// it kept each thread's loads waiting on one another and was markedly
// slower; staging the window in shared memory with float4 loads of all
// threads was no faster at the main path's shapes.)

//
// Training. The backward replaces XLA's derivative of the same
// DepthwiseConv7 and LayerNorm. Given go = dL/dout, with n = (h - mean_t)
// r_t (r_t = 1 / sqrt(var_t + eps)) and g = go * scale:
//
//   norm (per row):  dh = r_t (g - mean_C(g) - n mean_C(g n))
//   columns:         dscale = sum go n, dbias = sum go, db = sum dh,
//                    dk[j] = sum_t dh[t] y[t + (j - 3) d]
//   taps:            dy[t] = live(t) ? sum_j k[j] dh[t - (j - 3) d] : 0
//                    (dh 0 outside [0, T); live: inside [0, T), not padding)
//   inputs:          dx = dcond = dy, dstep = sum_t dy
//
// The mask applies to the source row only: the forward computes h at a
// padded row from its live neighbours, so dh there flows back to them.
//
// depthwise_conv7_norm_backward: one kernel, dh kept on chip, then a small
// kernel that adds the blocks' column sums. Bound: bytes. go, x and cond
// are read and dy written once (16 bytes an element); ~62 float operations
// an element. At B=20 x 512 frames x 512 channels, 84 MB, 25.0 us at 3.35
// TB/s. (The two kernels it replaces wrote dh [B, T, C] and read it back
// with its halo, and wrote 10 x C partials every 16 rows, added by a
// PyTorch reduction: 126 MB and more.)
// Design: a block owns a segment of L consecutive rows i of one residue
// class r of one item (t = r + i d) and all C channels, CPT neighbouring
// channels a thread. It walks the segment in chunks of CHUNK rows of h,
// from 3 rows before the segment to 3 after (the halo that dy needs). The
// next chunk's rows of x, cond and go fly into a stage of the thread's own
// in shared memory (cp.async, 8-byte pairs of channels where C is even)
// while this one computes: the pre-added, masked y into a register window
// that rolls from chunk to chunk (x and cond read once, plus the segment's
// halo), h from the window, the two block sums of the LayerNorm (sum h and
// sum g, then sum (h - mean)^2 and sum g (h - mean): two passes, so that a
// row of constant h has variance 0), dh in registers, the column sums of
// the rows the segment owns (dk from the same window), and dy of the rows
// whose 7 taps of dh are known, from a ring of the last 6 rows of dh. dh
// never leaves the SM; only the halo's 6 rows of it are computed twice, by
// the neighbouring segments. A block sum is a warp reduce-scatter of the
// chunk's 2 CHUNK values with shuffles (each lane ends with one value's
// warp sum), the warps' sums added in warp order through shared memory by
// one thread a row, which also forms the row's statistics: no atomics,
// reruns bit-equal (the host emulation of the tests runs the shuffles as
// exchanges through a shared array). A block keeps its column sums (dk[7],
// db, dscale, dbias and its item's dstep) in registers and writes them
// once, 11 x C floats, to its slot; dwconv7_backward_sum_kernel adds the
// slots in slot order. The plan (plan_of): CPT and CHUNK from C, L from
// the number of segments a class that covers the card's block slots in
// the fewest rounds of chunks. At 2 channels a thread and 7 rows a chunk a
// thread holds 128 registers, two blocks an SM. (A first version that
// loaded each chunk into registers, with a float division per row and
// channel, ran at 22-31% of the bound: PERF.md.)

#include <cuda_runtime.h>

#include "async_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 16;                 // rows of a class per block
constexpr int SPLIT = THREADS / ROWS;    // threads per row in the reductions
constexpr int TAPS = 7;
constexpr int HALF = TAPS / 2;
constexpr int WINDOW = ROWS + 2 * HALF;  // a tile's rows with their halo
constexpr int SMEM_LIMIT = 232448;

// A block's place: batch item b, residue class r, rows i0 .. i0 + n_rows
// of the class (t = r + i d), n_r rows in the class.
struct Tile {
  int b, r, n_r, i0, n_rows;
  size_t row0;  // b * T
};

__device__ __forceinline__ Tile tile_of(int T, int d) {
  Tile p;
  p.b = blockIdx.z;
  p.r = blockIdx.y;
  p.n_r = (T - p.r + d - 1) / d;
  p.i0 = blockIdx.x * ROWS;
  p.n_rows = p.n_r - p.i0 < ROWS ? p.n_r - p.i0 : ROWS;
  p.row0 = (size_t)p.b * T;
  return p;
}

// which of the window's source rows hold data: inside [0, T), not padding
__device__ __forceinline__ void mark_live(unsigned char* live, const unsigned char* mask,
                                          const Tile& p, int d) {
  if (threadIdx.x < WINDOW) {
    const int i = p.i0 - HALF + (int)threadIdx.x;
    bool ok = i >= 0 && i < p.n_r;
    if (ok && mask != nullptr) ok = !mask[p.row0 + p.r + (size_t)i * d];
    live[threadIdx.x] = ok;
  }
}

// channel c's pre-added, masked window y[WINDOW]. The loads are
// unconditional (a row outside [0, T) reads its nearest row of the class,
// then counts as 0), so a thread has its whole window in flight at once
__device__ __forceinline__ void load_window(float* y, const float* __restrict__ x, float s,
                                            const float* __restrict__ cond,
                                            const unsigned char* live, const Tile& p, int d,
                                            int C, int c) {
#pragma unroll
  for (int j = 0; j < WINDOW; ++j) {
    const int i = p.i0 - HALF + j;
    const int ic = i < 0 ? 0 : (i < p.n_r ? i : p.n_r - 1);
    const size_t o = (p.row0 + p.r + (size_t)ic * d) * C + c;
    const float v = (x[o] + s) + cond[o];
    y[j] = live[j] ? v : 0.f;
  }
}

// phase 1: the conv of each channel over the tile into h [ROWS][C], from a
// register window
__device__ __forceinline__ void conv_tile(float* h, const float* __restrict__ x,
                                          const float* __restrict__ step,
                                          const float* __restrict__ cond,
                                          const float* __restrict__ k,
                                          const float* __restrict__ bias,
                                          const unsigned char* live, const Tile& p, int d,
                                          int C) {
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float y[WINDOW];
    load_window(y, x, step[(size_t)p.b * C + c], cond, live, p, d, C, c);
    float kc[TAPS];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) kc[j] = k[(size_t)j * C + c];
    const float bc = bias[c];
#pragma unroll
    for (int l = 0; l < ROWS; ++l) {
      float acc = bc;
#pragma unroll
      for (int j = 0; j < TAPS; ++j) acc += kc[j] * y[l + j];
      h[(size_t)l * C + c] = acc;
    }
  }
}

// phase 2: mean and 1 / std of each row into stat[0 .. ROWS) and
// stat[ROWS .. 2 ROWS): the mean, then the variance about it (two passes,
// so that a row of constant h has variance 0). Rows past n_rows hold the
// conv of zeros: computed, never written out. Ends synchronised
__device__ __forceinline__ void row_stats(const float* h, float* part, float* stat, int C,
                                          float eps) {
  const int l = threadIdx.x / SPLIT, p = threadIdx.x % SPLIT;
  const float* hl = h + (size_t)l * C;
  float acc = 0.f;
  for (int c = p; c < C; c += SPLIT) acc += hl[c];
  part[threadIdx.x] = acc;
  __syncthreads();
  if (p == 0) {
    float sum = 0.f;
    for (int q = 0; q < SPLIT; ++q) sum += part[l * SPLIT + q];
    stat[l] = sum / (float)C;
  }
  __syncthreads();
  const float mean = stat[l];
  acc = 0.f;
  for (int c = p; c < C; c += SPLIT) {
    const float e = hl[c] - mean;
    acc += e * e;
  }
  part[threadIdx.x] = acc;  // the first sums were read before the barrier above
  __syncthreads();
  if (p == 0) {
    float sum = 0.f;
    for (int q = 0; q < SPLIT; ++q) sum += part[l * SPLIT + q];
    stat[ROWS + l] = 1.f / sqrtf(sum / (float)C + eps);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 2)
dwconv7_norm_kernel(const float* __restrict__ x, const float* __restrict__ step,
                    const float* __restrict__ cond, const unsigned char* __restrict__ mask,
                    const float* __restrict__ k, const float* __restrict__ bias,
                    const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                    float* __restrict__ out, int T, int C, int d, float eps) {
  extern __shared__ float smem[];
  float* h = smem;                      // [ROWS][C] conv outputs of the tile
  float* part = h + (size_t)ROWS * C;   // [THREADS] partial sums
  float* stat = part + THREADS;         // [ROWS] means, then [ROWS] 1 / std
  const Tile p = tile_of(T, d);
  if (p.i0 >= p.n_r) return;            // the whole block, before any barrier

  __shared__ unsigned char live[WINDOW];
  mark_live(live, mask, p, d);
  __syncthreads();
  conv_tile(h, x, step, cond, k, bias, live, p, d, C);
  __syncthreads();
  row_stats(h, part, stat, C, eps);

  // phase 3: normalise and write the tile's rows
  for (int c = threadIdx.x; c < C; c += THREADS) {
    const float w = ln_w[c], lb = ln_b[c];
    for (int m = 0; m < p.n_rows; ++m) {
      const size_t t = p.r + (size_t)(p.i0 + m) * d;
      out[(p.row0 + t) * C + c] = (h[(size_t)m * C + c] - stat[m]) * stat[ROWS + m] * w + lb;
    }
  }
}

// ---- K10's backward (see the top) ----

constexpr int FIELDS = 4 + TAPS;  // a block's slot: dk[0..6], db, dscale, dbias, dstep
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;

__device__ __forceinline__ float shfl_xor(float v, int lane_mask) {
  return __shfl_xor_sync(0xffffffffu, v, lane_mask);
}

// A warp's reduce-scatter of N values (a power of two up to 32): at each
// step a lane keeps one half of its values, sends the other half to its
// partner and adds what comes back. Afterwards v[0] of lane l holds the
// warp's sum of value l / (32 / N), added in an order fixed by the lanes.
template <int N, int OFF>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  if constexpr (OFF >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + shfl_xor(send, OFF);
      }
      reduce_scatter<H, OFF / 2>(v, lane);
    } else {
      v[0] += shfl_xor(v[0], OFF);
      reduce_scatter<1, OFF / 2>(v, lane);
    }
  }
}

// The block's sums of the rows' two values in each thread's v (row m's at
// m and H + m, of N): the warps' sums (reduce_scatter) through red
// [MAX_WARPS][N], added in warp order by the thread of row m, which
// writes finish(sum m, sum H + m) to out[m] and out[H + m]. Every thread
// of the block calls it; ends synchronised
template <int N, int H, class F>
__device__ __forceinline__ void block_sums(float* v, float* red, float* out, F finish) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  reduce_scatter<N, 16>(v, lane);
  constexpr int PER = 32 / N;
  if (lane % PER == 0) red[warp * N + lane / PER] = v[0];
  __syncthreads();
  if ((int)threadIdx.x < H) {
    const int warps = (int)(blockDim.x >> 5), m = (int)threadIdx.x;
    float lo = 0.f, hi = 0.f;
    for (int w = 0; w < warps; ++w) {
      lo += red[w * N + m];
      hi += red[w * N + H + m];
    }
    finish(lo, hi, out[m], out[H + m]);
  }
  __syncthreads();
}

// The block's segment: rows i0 .. i1 of class r of item b, and the offset
// of the class's row 0 in the [B * T] rows
struct Segment {
  int b, r, n_r, i0, i1;
  size_t base;
};

__device__ __forceinline__ Segment segment_of(int T, int d, int S, int L) {
  const int classes = d < T ? d : T;
  Segment g;
  const int blk = (int)blockIdx.x;
  g.b = blk / (S * classes);
  g.r = (blk / S) % classes;
  g.n_r = (T - g.r + d - 1) / d;
  g.i0 = (blk % S) * L;
  g.i1 = g.i0 + L < g.n_r ? g.i0 + L : g.n_r;
  g.base = (size_t)g.b * T + g.r;
  return g;
}

// A backward thread's stage in shared memory: two chunks of its channels'
// rows, x and cond of the new y rows and go of the h rows, [2][3][CHUNK]
// [CPT], its length 2 more than a multiple of 4 floats, so that the 16
// lanes of a half warp reading one 8-byte pair of their own stages hit 16
// pairs of banks
template <int CPT, int CHUNK>
__host__ __device__ constexpr int stage_floats() {
  return (2 * 3 * CPT * CHUNK) % 4 == 0 ? 2 * 3 * CPT * CHUNK + 2 : 2 * 3 * CPT * CHUNK;
}

// 8 bytes (ok) or zeros (!ok) into shared memory, asynchronously
__device__ __forceinline__ void copy8(float* dst, const float* src, bool ok) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 8 : 0));
#else
  dst[0] = ok ? src[0] : 0.f;
  dst[1] = ok ? src[1] : 0.f;
#endif
}

template <int CPT, int CHUNK>
size_t backward_smem(int threads) {
  return sizeof(float) * (size_t)threads * stage_floats<CPT, CHUNK>();
}

// go, x, cond, dy [B, T, C]; step [B, C]; mask [B, T] or null; k [7, C];
// bias, ln_w [C]; slots [gridDim.x][FIELDS][C]
template <int CPT, int CHUNK>
__global__ void __launch_bounds__(MAX_THREADS, 1)
dwconv7_norm_backward_kernel(const float* __restrict__ go, const float* __restrict__ x,
                             const float* __restrict__ step, const float* __restrict__ cond,
                             const unsigned char* __restrict__ mask,
                             const float* __restrict__ k, const float* __restrict__ bias,
                             const float* __restrict__ ln_w, float* __restrict__ dy,
                             float* __restrict__ slots, int T, int C, int d, int S, int L,
                             float eps) {
  constexpr int WIN = CHUNK + 2 * HALF;        // y rows a - 3 .. a + CHUNK + 2 of a chunk
  constexpr int N = 2 * CHUNK <= 16 ? 16 : 32;  // values of a block sum (2 CHUNK, padded)
  static_assert(CHUNK >= 2 * HALF && 2 * CHUNK <= 32 && WIN <= 32, "CHUNK");
  static_assert(CPT % 2 == 0, "CPT: channels in pairs");
  extern __shared__ float stage[];              // [threads][stage_floats]
  __shared__ float red[2][MAX_WARPS * N];
  __shared__ float tot[2][N];

  const Segment g = segment_of(T, d, S, L);
  float* slot = slots + (size_t)blockIdx.x * FIELDS * C;
  if (g.i0 >= g.n_r) {  // a segment past its class's rows adds nothing
    for (int c = threadIdx.x; c < FIELDS * C; c += blockDim.x) slot[c] = 0.f;
    return;
  }
  // a thread reads back only what it copied into its own stage: no
  // barrier around the copies. Its channels are CPT neighbours, moved in
  // 8-byte pairs where C is even (pairs), else one by one
  constexpr int PER = 3 * CPT * CHUNK;  // a chunk's floats in a stage
  float* const mine = stage + (size_t)threadIdx.x * stage_floats<CPT, CHUNK>();
  const bool pairs = C % 2 == 0;
  auto at = [](int array, int m, int q) { return (array * CHUNK + m) * CPT + q; };

  int ch[CPT];
  bool on[CPT];
  float kc[CPT][TAPS], bc[CPT], wc[CPT], sc[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    const int c = (int)threadIdx.x * CPT + q;
    on[q] = c < C;
    // a channel past C reads channel C - 2 + (q & 1) (pairs) or C - 1 and adds nothing
    ch[q] = on[q] ? c : (pairs ? C - 2 + (q & 1) : C - 1);
#pragma unroll
    for (int j = 0; j < TAPS; ++j) kc[q][j] = k[(size_t)j * C + ch[q]];
    bc[q] = bias[ch[q]];
    wc[q] = ln_w[ch[q]];
    sc[q] = step[(size_t)g.b * C + ch[q]];
  }

  // the class's row 0 in each tensor; offsets inside an item fit 32 bits
  // (the C entry checks T C)
  const size_t cls = g.base * C;
  const float *xc = x + cls, *cc = cond + cls, *gc = go + cls;
  float* const dyc = dy + cls;
  const unsigned char* mc = mask == nullptr ? nullptr : mask + g.base;
  // class row i clamped into the class
  auto clamp = [&](int i) { return i < 0 ? 0 : (i < g.n_r ? i : g.n_r - 1); };
  // chunk a's rows into stage buf: x and cond of y rows a + 3 .. a + CHUNK
  // + 2, go of rows a .. a + CHUNK - 1 (0 outside the class: so is dh);
  // one group of asynchronous copies. The y rows' mask bytes go to mb, read
  // a chunk later (live_bits), so that their loads are in flight meanwhile
  auto stage_chunk = [&](int buf, int a, int* mb) {
    float* st = mine + buf * PER;
#pragma unroll
    for (int m = 0; m < CHUNK; ++m) {
      const int iy = clamp(a + HALF + m) * d, ig = a + m;
      const int oy = iy * C, og = clamp(ig) * d * C;
      const bool in = ig >= 0 && ig < g.n_r;
      if (pairs) {
#pragma unroll
        for (int q = 0; q < CPT; q += 2) {
          copy8(st + at(0, m, q), xc + oy + ch[q], true);
          copy8(st + at(1, m, q), cc + oy + ch[q], true);
          copy8(st + at(2, m, q), gc + og + ch[q], in);
        }
      } else {
#pragma unroll
        for (int q = 0; q < CPT; ++q) {
          acopy::copy4(st + at(0, m, q), xc + oy + ch[q], true);
          acopy::copy4(st + at(1, m, q), cc + oy + ch[q], true);
          acopy::copy4(st + at(2, m, q), gc + og + ch[q], in);
        }
      }
      mb[m] = mc == nullptr ? 0 : mc[iy];
    }
    acopy::copy_commit();
  };
  // the live bits (inside the class, not padding) of chunk a's y rows
  auto live_bits = [&](int a, const int* mb) {
    unsigned bits = 0;
#pragma unroll
    for (int m = 0; m < CHUNK; ++m) {
      const int iy = a + HALF + m;
      bits |= (unsigned)(iy >= 0 && iy < g.n_r && !mb[m]) << m;
    }
    return bits;
  };

  // the window y[WIN] of class rows a - 3 .., live bit p for window row p;
  // the ring of dh for rows a - 6 .. a - 1; the segment's column sums
  float yw[CPT][WIN], dr[CPT][2 * HALF];
  float dk[CPT][TAPS], db[CPT], dw[CPT], dlb[CPT], dst[CPT];
#pragma unroll
  for (int q = 0; q < CPT; ++q) {
#pragma unroll
    for (int j = 0; j < TAPS; ++j) dk[q][j] = 0.f;
    db[q] = dw[q] = dlb[q] = dst[q] = 0.f;
#pragma unroll
    for (int p = 0; p < 2 * HALF; ++p) dr[q][p] = 0.f;
  }

  // chunk a: h and dh of rows a .. a + CHUNK - 1, dy of rows a - 3 ..
  // a + CHUNK - 4; from 3 rows before the segment until dy reaches its
  // end. The next chunk's copies fly while this one computes
  int a = g.i0 - HALF, buf = 0, mb[CHUNK];
  stage_chunk(0, a, mb);
  unsigned next = live_bits(a, mb), live = 0;
  // the first window's 6 rows, i0 - 6 .. i0 - 1, loaded directly
#pragma unroll
  for (int p = 0; p < 2 * HALF; ++p) {
    const int i = g.i0 - 2 * HALF + p;
    const int ic = clamp(i) * d, o = ic * C;
    const bool ok = i >= 0 && i < g.n_r && (mc == nullptr || !mc[ic]);
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const float v = (xc[o + ch[q]] + sc[q]) + cc[o + ch[q]];
      yw[q][p] = ok ? v : 0.f;
    }
    live |= (unsigned)ok << p;
  }

  for (; a - HALF < g.i1; a += CHUNK, buf ^= 1) {
    live |= next << (2 * HALF);
    const bool more = a + CHUNK - HALF < g.i1;
    if (more) {
      stage_chunk(buf ^ 1, a + CHUNK, mb);
      acopy::copy_wait<1>();
    } else {
      acopy::copy_wait<0>();
    }
    const float* st = mine + buf * PER;

    // go of row m, channel q, from the stage
    auto go_at = [&](int m, int q) { return st[at(2, m, q)]; };

    // y, h, and the first block sums: sum h, sum g
    float hv[CPT][CHUNK];
#pragma unroll
    for (int m = 0; m < CHUNK; ++m) {
#pragma unroll
      for (int q = 0; q < CPT; q += 2) {
        const float2 xv = *reinterpret_cast<const float2*>(st + at(0, m, q));
        const float2 cv = *reinterpret_cast<const float2*>(st + at(1, m, q));
        const bool ok = (live >> (2 * HALF + m)) & 1u;
        yw[q][2 * HALF + m] = ok ? (xv.x + sc[q]) + cv.x : 0.f;
        yw[q + 1][2 * HALF + m] = ok ? (xv.y + sc[q + 1]) + cv.y : 0.f;
      }
    }
    float part[N];
#pragma unroll
    for (int v = 0; v < N; ++v) part[v] = 0.f;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
#pragma unroll
      for (int m = 0; m < CHUNK; ++m) {
        float acc = bc[q];
#pragma unroll
        for (int j = 0; j < TAPS; ++j) acc += kc[q][j] * yw[q][m + j];
        hv[q][m] = acc;
        part[m] += on[q] ? acc : 0.f;
        part[CHUNK + m] += on[q] ? go_at(m, q) * wc[q] : 0.f;
      }
    }
    // the means of h and of g
    block_sums<N, CHUNK>(part, red[0], tot[0], [&](float sh, float sg, float& mean, float& mg) {
      mean = sh / (float)C;
      mg = sg / (float)C;
    });

    // h - mean, and the second: sum (h - mean)^2, sum g (h - mean)
#pragma unroll
    for (int v = 0; v < N; ++v) part[v] = 0.f;
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
#pragma unroll
      for (int m = 0; m < CHUNK; ++m) {
        const float e = hv[q][m] - tot[0][m];
        hv[q][m] = e;
        part[m] += on[q] ? e * e : 0.f;
        part[CHUNK + m] += on[q] ? go_at(m, q) * wc[q] * e : 0.f;
      }
    }
    // 1 / std, and the mean of g n = r g (h - mean)
    block_sums<N, CHUNK>(part, red[1], tot[1], [&](float se, float sge, float& rs, float& mgn) {
      rs = 1.f / sqrtf(se / (float)C + eps);
      mgn = rs * sge / (float)C;
    });

    // dh, and the column sums of the rows the segment owns
#pragma unroll
    for (int m = 0; m < CHUNK; ++m) {
      const float rs = tot[1][m], mg = tot[0][CHUNK + m], mgn = tot[1][CHUNK + m];
      const bool own = a + m >= g.i0 && a + m < g.i1;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const float gg = go_at(m, q);
        const float n = hv[q][m] * rs;
        const float v = rs * ((gg * wc[q] - mg) - n * mgn);
        hv[q][m] = v;
        if (own) {
          dw[q] += gg * n;
          dlb[q] += gg;
          db[q] += v;
#pragma unroll
          for (int j = 0; j < TAPS; ++j) dk[q][j] += v * yw[q][m + j];
        }
      }
    }

    // dy of rows a - 3 + m: dh of rows a - 6 + m .. a + m, the ring then
    // the chunk (taps transposed)
#pragma unroll
    for (int m = 0; m < CHUNK; ++m) {
      const int i = a - HALF + m;
      if (i < g.i0 || i >= g.i1) continue;
      const bool keep = (live >> m) & 1u;
      const int o = i * d * C;
      float out[CPT];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        float acc = 0.f;
#pragma unroll
        for (int j = 0; j < TAPS; ++j) {
          const int e = m + 2 * HALF - j;
          acc += kc[q][j] * (e < 2 * HALF ? dr[q][e] : hv[q][e - 2 * HALF]);
        }
        out[q] = keep ? acc : 0.f;
        dst[q] += out[q];
      }
#pragma unroll
      for (int q = 0; q < CPT; q += 2) {
        if (pairs && on[q]) {
          *reinterpret_cast<float2*>(dyc + o + ch[q]) = make_float2(out[q], out[q + 1]);
        } else if (!pairs) {
          if (on[q]) dyc[o + ch[q]] = out[q];
          if (on[q + 1]) dyc[o + ch[q + 1]] = out[q + 1];
        }
      }
    }

    if (more) next = live_bits(a + CHUNK, mb);
    // roll the window and the ring on by CHUNK rows
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
#pragma unroll
      for (int p = 0; p < 2 * HALF; ++p) {
        yw[q][p] = yw[q][p + CHUNK];
        dr[q][p] = hv[q][CHUNK - 2 * HALF + p];
      }
    }
    live = (live >> CHUNK) & ((1u << (2 * HALF)) - 1u);
  }

#pragma unroll
  for (int q = 0; q < CPT; ++q) {
    if (!on[q]) continue;
    float* out = slot + ch[q];
#pragma unroll
    for (int j = 0; j < TAPS; ++j) out[(size_t)j * C] = dk[q][j];
    out[(size_t)TAPS * C] = db[q];
    out[(size_t)(TAPS + 1) * C] = dw[q];
    out[(size_t)(TAPS + 2) * C] = dlb[q];
    out[(size_t)(TAPS + 3) * C] = dst[q];
  }
}

// The slots' sums in an order fixed by the shapes: grads [10 + B][C] =
// dk[0..6], db, dscale, dbias over every slot, then dstep of item b over
// its per_item slots. A block: 32 channels of one output row; its 32 warps
// take the slots interleaved, 8 loads in flight a thread into 8 sums,
// added in order, then the warps' sums in warp order
constexpr int SUM_WARPS = 32, SUM_LANES = 8;

__global__ void __launch_bounds__(SUM_WARPS * 32)
dwconv7_backward_sum_kernel(const float* __restrict__ slots, float* __restrict__ grads,
                            int n_slots, int per_item, int C) {
  __shared__ float part[SUM_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = (int)blockIdx.x * 32 + lane, row = (int)blockIdx.y;
  const int field = row < FIELDS - 1 ? row : FIELDS - 1;
  const int n0 = row < FIELDS - 1 ? 0 : (row - (FIELDS - 1)) * per_item;
  const int n1 = row < FIELDS - 1 ? n_slots : n0 + per_item;
  float acc[SUM_LANES] = {};
  if (c < C) {
    const float* col = slots + (size_t)field * C + c;
    const size_t step = (size_t)FIELDS * C;
    for (int n = n0 + warp; n < n1; n += SUM_WARPS * SUM_LANES) {
#pragma unroll
      for (int u = 0; u < SUM_LANES; ++u) {
        const int m = n + u * SUM_WARPS;
        if (m < n1) acc[u] += col[(size_t)m * step];
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int u = 0; u < SUM_LANES; ++u) sum += acc[u];
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < C) {
    float total = 0.f;
    for (int w = 0; w < SUM_WARPS; ++w) total += part[w][lane];
    grads[(size_t)row * C + c] = total;
  }
}

dim3 grid_of(int B, int T, int d) {
  const int class_rows = (T + d - 1) / d;  // class 0 has the most rows
  return dim3((class_rows + ROWS - 1) / ROWS, d < T ? d : T, B);
}

template <class K>
int set_smem(K kernel, size_t smem) {
  if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  return 0;
}

}  // namespace

// x, cond, out [B, T, C]; step [B, C]; mask [B, T] bytes (nonzero at
// padding) or null; k [7, C]; b, ln_w, ln_b [C]. All float32 and contiguous
// (the Python wrapper checks). Returns the cudaError_t of the launch.
extern "C" int depthwise_conv7_norm(const void* x, const void* step, const void* cond,
                                    const void* mask, const void* k, const void* b,
                                    const void* ln_w, const void* ln_b, void* out, int B,
                                    int T, int C, int d, float eps, void* stream) {
  if (B < 1 || T < 1 || C < 1 || d < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)ROWS * C + THREADS + 2 * ROWS);
  const int e = set_smem(dwconv7_norm_kernel, smem);
  if (e != 0) return e;
  const dim3 grid = grid_of(B, T, d);
  dwconv7_norm_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)step, (const float*)cond, (const unsigned char*)mask,
      (const float*)k, (const float*)b, (const float*)ln_w, (const float*)ln_b,
      (float*)out, T, C, d, eps);
  return (int)cudaGetLastError();
}

namespace {

// K10's backward plan: CPT channels a thread, CHUNK rows a chunk, the
// threads of a block, S segments of L rows a class (blocks = B classes S).
struct Plan {
  int cpt, chunk, threads, S, L;
};

template <int CPT_, int CHUNK_>
struct Instance {
  static constexpr int CPT = CPT_, CHUNK = CHUNK_;
};

// f(Instance<CPT, CHUNK>) for the plan's kernel: CPT 2 up to 1024
// channels, 4 past them, CHUNK 7 (PERF.md: the plans timed at a training
// step's shape)
template <class F>
int with_instance(int C, F f) {
  return C <= 2 * MAX_THREADS ? f(Instance<2, 7>{}) : f(Instance<4, 7>{});
}

// the kernel's shared memory set for its threads, and its blocks an SM
template <int CPT, int CHUNK>
int prepare(int threads, int& per_sm) {
  const size_t smem = backward_smem<CPT, CHUNK>(threads);
  int err = set_smem(dwconv7_norm_backward_kernel<CPT, CHUNK>, smem);
  if (err) return err;
  static int known[MAX_THREADS / 32 + 1] = {};
  int& n = known[threads / 32];
  if (n == 0) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, dwconv7_norm_backward_kernel<CPT, CHUNK>, threads, smem);
    if (err || n < 1) n = 1;
  }
  per_sm = n;
  return 0;
}

// The segments of a class: the fewest rounds of chunks over the card's
// block slots (waves x chunks a segment, the halo's 6 rows included), the
// fewest blocks among equals
void segments(int B, int T, int d, int slots_on_card, Plan& p) {
  const int classes = d < T ? d : T, rows = (T + d - 1) / d;  // class 0 has the most rows
  long long best = -1;
  for (int S = 1; S <= rows && S <= 4096; ++S) {
    const int L = (rows + S - 1) / S;
    if ((S - 1) * L >= rows) continue;  // the last segment would be empty: a smaller S has this L
    const long long blocks = (long long)B * classes * S;
    const long long waves = (blocks + slots_on_card - 1) / slots_on_card;
    const long long cost = waves * ((L + 2 * HALF + p.chunk - 1) / p.chunk);
    if (best < 0 || cost < best) {
      best = cost;
      p.S = S;
      p.L = L;
    }
  }
}

// threads for the channels in whole warps, the segments from the card's
// SMs and the kernel's blocks an SM
int plan_of(int B, int T, int C, int d, Plan& p) {
  if (B < 1 || T < 1 || C < 1 || d < 1 || (long long)T * C > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  return with_instance(C, [&](auto inst) {
    using I = decltype(inst);
    p.cpt = I::CPT;
    p.chunk = I::CHUNK;
    p.threads = ((C + p.cpt - 1) / p.cpt + 31) / 32 * 32;
    if (p.threads > MAX_THREADS) return (int)cudaErrorInvalidValue;
    int per_sm = 1;
    const int err = prepare<I::CPT, I::CHUNK>(p.threads, per_sm);
    if (err) return err;
    segments(B, T, d, per_sm * acopy::sm_count(), p);
    return 0;
  });
}

template <int CPT, int CHUNK>
int launch_backward(const Plan& p, int blocks, const float* go, const float* x,
                    const float* step, const float* cond, const unsigned char* mask,
                    const float* k, const float* b, const float* ln_w, float* dy, float* slots,
                    int T, int C, int d, float eps, cudaStream_t stream) {
  const size_t smem = backward_smem<CPT, CHUNK>(p.threads);
  dwconv7_norm_backward_kernel<CPT, CHUNK><<<blocks, p.threads, smem, stream>>>(
      go, x, step, cond, mask, k, b, ln_w, dy, slots, T, C, d, p.S, p.L, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// The slots K10's backward writes: its blocks, B * classes * segments
// (slots [blocks][11][C] floats). 0 for shapes it does not take.
extern "C" int depthwise_conv7_norm_backward_slots(int B, int T, int C, int d) {
  Plan p;
  if (plan_of(B, T, C, d, p)) return 0;
  return B * (d < T ? d : T) * p.S;
}

// K10's backward. go, x, cond, dy [B, T, C]; step [B, C]; mask [B, T]
// bytes (nonzero at padding) or null; k [7, C]; b, ln_w [C]; slots
// [depthwise_conv7_norm_backward_slots][11][C], scratch; grads [10 + B][C]:
// dk[0..6], db, dln_scale, dln_bias, then dstep [B][C]. All float32 and
// contiguous (the Python wrapper checks). Launches the backward kernel and
// the slots' sum; returns the first cudaError_t.
extern "C" int depthwise_conv7_norm_backward(const void* go, const void* x, const void* step,
                                             const void* cond, const void* mask, const void* k,
                                             const void* b, const void* ln_w, void* dy,
                                             void* slots, void* grads, int B, int T, int C,
                                             int d, float eps, void* stream) {
  Plan p;
  int err = plan_of(B, T, C, d, p);
  if (err) return err;
  const int classes = d < T ? d : T, blocks = B * classes * p.S;
  cudaStream_t s = (cudaStream_t)stream;
  const float *go_ = (const float*)go, *x_ = (const float*)x, *step_ = (const float*)step,
              *cond_ = (const float*)cond, *k_ = (const float*)k, *b_ = (const float*)b,
              *w_ = (const float*)ln_w;
  const unsigned char* m_ = (const unsigned char*)mask;
  float *dy_ = (float*)dy, *slots_ = (float*)slots;
  err = with_instance(C, [&](auto inst) {
    using I = decltype(inst);
    return launch_backward<I::CPT, I::CHUNK>(p, blocks, go_, x_, step_, cond_, m_, k_, b_, w_,
                                             dy_, slots_, T, C, d, eps, s);
  });
  if (err) return err;
  const dim3 grid = dim3((C + 31) / 32, FIELDS - 1 + B);
  dwconv7_backward_sum_kernel<<<grid, SUM_WARPS * 32, 0, s>>>(slots_, (float*)grads, blocks,
                                                              classes * p.S, C);
  return (int)cudaGetLastError();
}
