// The forward convolutions of the port and their input gradients, shared
// by conv1d.cu (K4: the NSF-HiFiGAN / RefineGAN trunk's direct and
// transposed 1-D convs), conv2d.cu (K6 2-D: the MRD's 2-D convs, the
// stride-1 layers' input gradients in the direct mode, the stride-(1, 2)
// layers' in the transposed mode) and grouped_conv1d.cu (K6: the MSD's
// grouped k = 41 convs and their input gradients). Include after
// <cuda_runtime.h> and <cuda_bf16.h>.
//
// Replaces fish_diffusion_tpu/ops/blocked_conv.py:blocked_apply (K4),
// blocked_apply_2d (K6 2-D) and blocked_apply_grouped (K6), the
// space-to-depth GEMMs that filled the TPU's 128-lane matrix unit at 8-64
// channels a group. One problem covers all three:
// the lines are (b, h) over B x H_out (1-D: H = KH = 1, the lines are the
// batch rows), and output position u of a line reads, for tap row kh and
// tap q, input row h * SH + kh - PH at column u * S + q * D - P:
//
//   out[b, h, t(u), o] = bias[o] (+ res[b, h, t(u), o])
//       + sum_{kh, q, c} W[kh, kw(q), c, o] * act(x[b, h*SH + kh - PH, u*S + q*D - P, c])
//
// then tanh where asked; act is leaky-relu(slope) where has_slope, else the
// identity; inputs outside the tensor read 0. W is packed [KH, KW, C_in,
// C_out]. The direct conv has t(u) = u and kw(q) = q. The transposed conv
// (torch ConvTranspose semantics, KW a multiple of the stride s along the
// line, stride 1 across lines) runs one output residue class r per block:
// its outputs t = u * s + r - pad all read the K / s taps kw = r + q' * s
// at input columns u - q', so it is a stride-1 correlation with P = K / s
// - 1 and the taps taken in reverse (kw(q) = r + (K / s - 1 - q) * s); the
// u of a class start where t >= 0, so that every class has its own whole
// strips (the classes are ragged at odd widths). Across lines (2-D) it is
// a correlation with the tap rows reversed (weight row KH - 1 - kh) at
// padding KH - 1 - PH. Grouped (groups > 1, W packed [KW, C_in / groups,
// C_out]): output o reads only group o / (C_out / groups)'s input
// channels; a block's output tile lies in one group (BO divides C_out /
// groups, one 8-channel lane at 8) and its chunks walk that group's
// channels.
//
// Bound on an H100: float32 operations on the SIMT units (67 TFLOP/s) at
// the wide levels (one NSF-HiFiGAN pass at B=4 x 1024 frames: ~2.6 TFLOP,
// 80% of it at C = 128-256; one MRD pass ~0.4 TFLOP, 92% of it in the
// stride-(1, 2) 32 -> 32 layers, and as much again in their input
// gradients; a vocoder training step's 63 MSD launches ~1.9 TFLOP), memory
// at the narrow ones (C = 16, up to 2.1 M positions a conv at B=4). Design, the weight gradient's
// (wgrad.cuh) turned around, with the reduction over input channels and
// taps:
// - A block owns LH lines x TW positions x BO output channels. Its threads
//   are WO output-channel lanes x L position lanes a line x LH lines; a
//   thread keeps QP = 8 positions of one line (c0 + i * L: neighbouring
//   lanes read neighbouring window rows) x QO = 8 output channels (two
//   float4 columns BO / 2 apart, so the lanes read distinct banks).
// - The reduction walks chunks of BC input channels (16, 8 or 4) over all
//   taps. For a chunk the block stages in shared memory the input window
//   its tile reads, halo included (rows x cols x BC channels, channels
//   last), and the chunk's weights for every tap ([KH * K][BC][BO]). The
//   chunks stream through a ring of 3 (or 2) cp.async stages (16 bytes
//   where the channels and the source's alignment allow, 4 elsewhere:
//   C_in = 1, widths no multiple of 4, views at an offset; zero-filled
//   outside the input), so the next chunks' copies overlap this one's
//   FMAs; one barrier per chunk. The input leaky-ReLU is applied in place
//   by the thread that copied each element, before the barrier (zero stays
//   zero). A thread keeps its channel and walks the window by adds, with
//   no division per staged element.
// - Per tap and 4 input channels a thread reads one float4 of the window
//   for each of its positions and two float4 of weights for each channel:
//   256 FMAs for 16 shared-memory loads, the weights broadcast across the
//   position lanes of a warp.
// - Variants: C_in = 1 (MRD layer 0, the noise convs) reads the window one
//   channel at a time; C_out = 1 (conv_post, MRD layer 0's input
//   gradient) keeps 8 positions x 1 channel; a problem too small to keep
//   the SMs busy with 8 x 8 tiles (a B=1 request, conv_pre at 128 -> 512)
//   takes 4 x 4 tiles at four blocks an SM, four times the threads.
// - The plan (tile, lanes, lines, strip width, BC, ring depth) is a
//   function of the shapes and the card: a block of at least 3/4 of 256
//   threads first (small blocks with a large ring left an SM a few warps),
//   then the most channels a chunk and the deepest ring that fit (where
//   the weights of every tap fill a stage, as at k = 41, a 2-stage ring
//   that holds a larger block: MSD layer 1 at scale 0 in 256-thread blocks
//   in place of 192); the tile
//   that launches the fewest warps (the 2-D tile spans several short lines
//   at W' = 513 ... 33); while the grid would not fill the card once,
//   smaller blocks and the 4 x 4 tile are weighed by a model of their time
//   (FMAs and staged floats over a rate that grows with the warps resident
//   on an SM). A problem is planned once a process; the kernel's
//   shared-memory limit is set again before every launch of a plan over 48
//   KB (wgrad.cuh, PERF.md §6).
// - No split of the reduction: each output is one thread's float32 sum in
//   a fixed order (chunks, tap rows, taps, channels), so two launches give
//   the same bits.
// - bfloat16 (conv1d_forward's dtype 1, on no path of the port): the same
//   kernel, its window and weights staged by plain loads converted to
//   float32 as they land (activation applied there), float32 sums,
//   rounded once on the store.
// What holds it at ~45% of the float32 rate: not the shared-memory
// traffic (A/Bs on an H100 moved it from 0.56 to 1.5 bytes a FMA and the
// rate stayed), not the clock (at its maximum under load); a build without
// restaging ran somewhat faster, so most of it is the FMA loop's own issue
// (PERF.md §6). Measured (chip_smoke.py; NVIDIA H100 80GB HBM3, 700 W): 30-31
// TFLOP/s at NSF-HiFiGAN's wide levels, one B=4 vocoder pass 90.6 ms
// against the first version's 117.5, one MRD pass of conv2d 18.16 ms
// against 24.71, its transposed mode 14.14 ms against 18.61, a vocoder
// training step's 63 grouped launches 65.78 ms against 72.08 (conv1d.cu,
// conv2d.cu, grouped_conv1d.cu).

#ifndef FDT_CONV_FWD_CUH
#define FDT_CONV_FWD_CUH

#include <array>
#include <cstdint>
#include <map>
#include <mutex>
#include <type_traits>

#include "async_copy.cuh"

// Internal linkage: the plan cache and the shared-memory limits are
// statics of inline and template functions, which the linker would
// otherwise unify across every library that includes this header (GNU
// unique symbols), so that conv1d.cu's and conv2d.cu's libraries, or two
// builds of one, would share plans made for another build's kernels.
namespace convf {
namespace {

using namespace acopy;

constexpr int MAX_THREADS = 256;
constexpr int SMEM_SM = 220 * 1024;  // the shared memory an SM's blocks share, less reserve

struct Args {
  int B, H_in, H_out, KH, SH, PH;  // 1-D: H_in = H_out = KH = SH = 1, PH = 0
  int T_in, T_out, C_in, C_out;    // columns of an input / output line
  int K, S, D, P, KW;              // taps along a line; the packed weight's KW
  int flip, classes, pad_t;        // transposed: 1, the stride along a line, its padding
  int groups;                      // 1, or the grouped conv's groups
  float slope;
  int has_slope, do_tanh;
};

// the input channels of a group (the packed weight's channel axis)
__host__ __device__ inline int group_in(const Args& p) { return p.C_in / p.groups; }

// A 1-D problem (K4, K6 grouped): x [B, T_in, C_in], w [K, C_in / groups,
// C_out]; the direct conv (stride, dilation, padding), or the transposed one
// (torch ConvTranspose1d semantics, K a multiple of the stride): class r's
// outputs t = u * s + r - pad read x[u - q'] * W[r + q' * s].
inline Args line_args(int transposed, int B, int T_in, int T_out, int C_in, int C_out, int K,
                      int stride, int dil, int pad, int groups) {
  Args p{};
  p.B = B, p.H_in = p.H_out = p.KH = p.SH = 1, p.PH = 0;
  p.T_in = T_in, p.T_out = T_out, p.C_in = C_in, p.C_out = C_out, p.KW = K;
  p.groups = groups;
  if (transposed) {
    p.K = K / stride, p.S = 1, p.D = 1, p.P = K / stride - 1;
    p.flip = 1, p.classes = stride, p.pad_t = pad;
  } else {
    p.K = K, p.S = stride, p.D = dil, p.P = pad;
    p.flip = 0, p.classes = 1, p.pad_t = 0;
  }
  return p;
}

// The tiling of one problem: a function of its shapes and of the card.
struct Plan {
  int variant;                   // the thread tile, see plan_for
  int WO, threads, BO, BC, XS;   // output-channel lanes; channels a chunk, window stride
  int L;                         // position lanes a line
  int TW, LH, strips, line_tiles, o_tiles, blocks;
  int rows, cols, x_floats, w_floats, stage_floats, stages, chunks, smem_bytes;
  int vec_x, vec_w, vec_o;       // 16-byte copies of x / w, float4 stores
  double cost;                   // the planner's modelled time (arbitrary units)
};

template <typename T>
__device__ __forceinline__ float to_f(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v) {
  if constexpr (std::is_same<T, float>::value) {
    return v;
  } else {
    return __float2bfloat16(v);
  }
}

// the first output position of a residue class (transposed: where t >= 0)
__host__ __device__ inline int class_start(const Args& p, int cls) {
  return p.flip && cls < p.pad_t ? cdiv(p.pad_t - cls, p.classes) : 0;
}

// the output positions of a class's line (direct: T_out)
__host__ __device__ inline int class_len(const Args& p, int cls) {
  if (!p.flip) return p.T_out;
  const int last = p.T_out - 1 + p.pad_t - cls;
  const int end = last >= 0 ? last / p.classes + 1 : 0;
  return end > class_start(p, cls) ? end - class_start(p, cls) : 0;
}

// The block's tile, decoded once.
struct Tile {
  int b, cls, o0, g, h0, u0, c0, kw0, kw_step;
};

// Walk the elements (r, c, v) of an R x C x V grid that this thread owns:
// idx = tid, tid + nt, ... over r * C * V + c * V + v, calling fn(r, c, v).
// When nt is a multiple of V the thread keeps its v and steps r and c by
// adds (no division per element).
template <class F>
__device__ __forceinline__ void walk(int R, int C, int V, F fn) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = R * C * V;
  if (nt % V == 0) {
    const int v = tid % V, step = nt / V;
    int c = tid / V, r = c / C;
    c -= r * C;
    for (int idx = tid; idx < n; idx += nt) {
      fn(r, c, v);
      for (c += step; c >= C; c -= C) ++r;
    }
  } else {
    for (int idx = tid; idx < n; idx += nt) {
      const int rc = idx / V;
      fn(rc / C, rc % C, idx % V);
    }
  }
}

// Stage chunk c0 of the tile into ring slot `slot`: the window (rows x
// cols x BC channels at stride XS) and the weights ([KH * K][BC][BO]).
// Float32 by cp.async; bfloat16 by plain loads converted as they land,
// with the activation applied there.
template <typename T, int CV>
__device__ __forceinline__ void stage(const T* __restrict__ x,
                                      const T* __restrict__ w, float* slot,
                                      const Args& p, const Plan& q,
                                      const Tile& t) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int row_lo = t.h0 * p.SH - p.PH;
  const int col_lo = t.u0 * p.S - p.P;
  const int ci = group_in(p);
  const T* xb = x + (size_t)t.b * p.H_in * p.T_in * p.C_in + t.g * ci + t.c0;
  const int va = CV == 4 && q.vec_x && F32 ? 4 : 1;
  walk(q.rows, q.cols, q.BC / va, [&](int r, int c, int v) {
    const int gr = row_lo + r, gc = col_lo + c, ch = v * va;
    const bool in = gr >= 0 && gr < p.H_in && gc >= 0 && gc < p.T_in && t.c0 + ch < ci;
    const T* src = in ? xb + ((size_t)gr * p.T_in + gc) * p.C_in + ch : x;
    float* dst = slot + (r * q.cols + c) * q.XS + ch;
    if constexpr (F32) {
      if (va == 4) {
        copy16(dst, src, in);
      } else {
        copy4(dst, src, in);
      }
    } else {
      float f = in ? to_f(*src) : 0.f;
      *dst = p.has_slope && f < 0.f ? f * p.slope : f;
    }
  });
  // the weights: row (kh, q, c) of BO channels; a thread walks its rows
  // keeping q and kh beside the row index. The transposed conv takes the
  // tap rows in reverse too (a correlation over rows h + kh - (KH - 1 - PH)
  // with weight row KH - 1 - kh)
  float* ws = slot + q.x_floats;
  const int vb = q.vec_w && F32 ? 4 : 1;
  const int per_row = q.BO / vb;
  auto copy_w = [&](int kh, int qq, int c, int o) {
    const int kw = t.kw0 + qq * t.kw_step;
    const int khw = p.flip ? p.KH - 1 - kh : kh;
    const bool ok = t.c0 + c < ci && t.o0 + o < p.C_out;
    const T* src =
        ok ? w + (((size_t)khw * p.KW + kw) * ci + t.c0 + c) * p.C_out + t.o0 + o : w;
    float* dst = ws + ((kh * p.K + qq) * q.BC + c) * q.BO + o;
    if constexpr (F32) {
      if (vb == 4) {
        copy16(dst, src, ok);
      } else {
        copy4(dst, src, ok);
      }
    } else {
      *dst = ok ? to_f(*src) : 0.f;
    }
  };
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_rows = p.KH * p.K * q.BC;
  if (nt % per_row == 0) {
    const int o = (tid % per_row) * vb, step = nt / per_row;
    int c = tid / per_row, qq = c / q.BC, kh = 0;
    c -= qq * q.BC;
    kh = qq / p.K;
    qq -= kh * p.K;
    for (int row = tid / per_row; row < n_rows; row += step) {
      copy_w(kh, qq, c, o);
      for (c += step; c >= q.BC; c -= q.BC)
        if (++qq == p.K) qq = 0, ++kh;
    }
  } else {
    for (int idx = tid; idx < n_rows * per_row; idx += nt) {
      const int row = idx / per_row, c = row % q.BC, tap = row / q.BC;
      copy_w(tap / p.K, tap % p.K, c, (idx % per_row) * vb);
    }
  }
}

// leaky-ReLU in place on the window elements this thread copied (float32;
// the walk is stage's)
template <int CV>
__device__ __forceinline__ void activate(float* slot, const Args& p, const Plan& q) {
  const int va = CV == 4 && q.vec_x ? 4 : 1;
  walk(q.rows, q.cols, q.BC / va, [&](int r, int c, int v) {
    float* e = slot + (r * q.cols + c) * q.XS + v * va;
    for (int i = 0; i < va; ++i) e[i] = e[i] < 0.f ? e[i] * p.slope : e[i];
  });
}

// QP positions x QO output channels a thread (QO = 8, 4 or 1), CV input
// channels a window read (4, or 1 for C_in = 1).
template <typename T, int QP, int QO, int CV, int MINB>
__global__ void __launch_bounds__(MAX_THREADS, MINB) fwd_kernel(
    const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ bias,
    const T* __restrict__ res, T* __restrict__ out, Args p, Plan q) {
  extern __shared__ __align__(16) float convf_smem[];
  float* smem = convf_smem;
  const int tid = threadIdx.x;
  const int ol = tid % q.WO, pl = tid / q.WO;

  Tile t;
  int bi = blockIdx.x;
  const int ot = bi % q.o_tiles;
  bi /= q.o_tiles;
  const int st = bi % q.strips;
  bi /= q.strips;
  const int lt = bi % q.line_tiles;
  bi /= q.line_tiles;
  t.cls = bi % p.classes;
  t.b = bi / p.classes;
  t.o0 = ot * q.BO;
  t.g = t.o0 / (p.C_out / p.groups);  // a tile lies in one group
  t.h0 = lt * q.LH;
  t.u0 = class_start(p, t.cls) + st * q.TW;
  t.kw0 = p.flip ? t.cls + (p.K - 1) * p.classes : 0;
  t.kw_step = p.flip ? -p.classes : 1;

  // the thread's positions: line l of the tile, columns c0 + i * L (the
  // lanes of a line read neighbouring window rows)
  const int l = pl / q.L, c0 = pl - l * q.L;
  int xo[QP];
#pragma unroll
  for (int i = 0; i < QP; ++i) xo[i] = (l * p.SH * q.cols + (c0 + i * q.L) * p.S) * q.XS;

  float acc[QP][QO];
#pragma unroll
  for (int i = 0; i < QP; ++i)
#pragma unroll
    for (int j = 0; j < QO; ++j) acc[i][j] = 0.f;

  const int n = q.chunks;
  const int ahead = q.stages - 1;
  for (int s = 0; s < ahead; ++s) {
    if (s < n) {
      t.c0 = s * q.BC;
      stage<T, CV>(x, w, smem + s * q.stage_floats, p, q, t);
    }
    copy_commit();
  }
  // the thread's first weight word of a tap's channel row
  const int w_off = q.x_floats + (QO > 1 ? ol * 4 : 0);
  for (int it = 0; it < n; ++it) {
    float* slot = smem + (it % q.stages) * q.stage_floats;
    if (q.stages == 3) {
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    if constexpr (std::is_same<T, float>::value) {
      if (p.has_slope) activate<CV>(slot, p, q);
    }
    __syncthreads();
    if (it + ahead < n) {
      t.c0 = (it + ahead) * q.BC;
      stage<T, CV>(x, w, smem + ((it + ahead) % q.stages) * q.stage_floats, p, q, t);
    }
    copy_commit();

    // per tap (kh, qq) and CV channels: one window read a position, the
    // weights of each channel for the thread's QO outputs
    for (int kh = 0; kh < p.KH; ++kh) {
      for (int qq = 0; qq < p.K; ++qq) {
        const float* xs = slot + (kh * q.cols + qq * p.D) * q.XS;
        const float* ws = slot + w_off + (kh * p.K + qq) * q.BC * q.BO;
        for (int g = 0; g < q.BC; g += CV) {
          float xv[QP][CV];
#pragma unroll
          for (int i = 0; i < QP; ++i) load_vec<CV>(xs + xo[i] + g, xv[i]);
          if constexpr (QO > 1) {
#pragma unroll
            for (int c = 0; c < CV; ++c) {
              float wv[QO];
              load_vec<4>(ws + (g + c) * q.BO, wv);
              if constexpr (QO == 8) load_vec<4>(ws + (g + c) * q.BO + q.BO / 2, wv + 4);
#pragma unroll
              for (int i = 0; i < QP; ++i)
#pragma unroll
                for (int j = 0; j < QO; ++j) acc[i][j] += xv[i][c] * wv[j];
            }
          } else {
            float wv[CV];
            load_vec<CV>(ws + g, wv);  // BO = 1: the CV channels' weights
#pragma unroll
            for (int c = 0; c < CV; ++c)
#pragma unroll
              for (int i = 0; i < QP; ++i) acc[i][0] += xv[i][c] * wv[c];
          }
        }
      }
    }
  }
  copy_wait<0>();

  // the epilogue: bias, residual, tanh; columns ol * 4 (and BO / 2 + ol * 4)
  const int h = t.h0 + l;
#pragma unroll
  for (int i = 0; i < QP; ++i) {
    const int u = t.u0 + c0 + i * q.L;
    const int tt = p.flip ? u * p.classes + t.cls - p.pad_t : u;
    if (h >= p.H_out || tt < 0 || tt >= p.T_out) continue;
    const size_t row = (((size_t)t.b * p.H_out + h) * p.T_out + tt) * p.C_out;
#pragma unroll
    for (int half = 0; half < (QO == 8 ? 2 : 1); ++half) {
      const int o = t.o0 + (QO > 1 ? half * (q.BO / 2) + ol * 4 : 0);
      constexpr int NJ = QO > 1 ? 4 : 1;
      float v[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) v[j] = acc[i][half * 4 + j];
      if constexpr (NJ == 4 && std::is_same<T, float>::value) {
        if (q.vec_o && o < p.C_out) {  // C_out % 4 == 0: the 4 columns are in
          const float4 bv = bias ? *reinterpret_cast<const float4*>(bias + o)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
          v[0] += bv.x, v[1] += bv.y, v[2] += bv.z, v[3] += bv.w;
          if (res) {
            const float4 rv = *reinterpret_cast<const float4*>(res + row + o);
            v[0] += rv.x, v[1] += rv.y, v[2] += rv.z, v[3] += rv.w;
          }
          if (p.do_tanh)
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = tanhf(v[j]);
          *reinterpret_cast<float4*>(out + row + o) = make_float4(v[0], v[1], v[2], v[3]);
          continue;
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        if (o + j >= p.C_out) continue;
        float s = v[j] + (bias ? to_f(bias[o + j]) : 0.f);
        if (res) s += to_f(res[row + o + j]);
        if (p.do_tanh) s = tanhf(s);
        out[row + o + j] = from_f<T>(s);
      }
    }
  }
}

// --- planning (host) ---

// The tile for at most `lanes_max` position lanes and at least
// `min_threads` threads, BC channels a chunk and a ring of `stages`: L lanes
// a line (TW = L * QP columns), LH lines; the one that launches the fewest
// warps over the problem (a tenth of the window's halo beside it), the
// larger block on a tie. False if no tile fits SMEM_SM / MINB.
template <int QP, int QO, int CV, int MINB>
bool geometry(const Args& p, int lanes_max, int min_threads, int BC, int stages, Plan* q) {
  q->BC = BC;
  q->XS = CV == 1 ? 1 : BC;
  q->chunks = cdiv(group_in(p), BC);
  q->stages = stages;
  int n_max = 1;
  for (int c = 0; c < p.classes; ++c) n_max = n_max > class_len(p, c) ? n_max : class_len(p, c);
  q->w_floats = (p.KH * p.K * BC * q->BO + 3) & ~3;
  const int slots = stages < q->chunks ? stages : q->chunks;
  double best = -1;
  for (int L = 1; L <= lanes_max; ++L) {
    const int tw = L * QP;
    if (L > 1 && tw - QP >= n_max) break;  // wider than a line
    const int strips = cdiv(n_max, tw);
    const int cols = (tw - 1) * p.S + (p.K - 1) * p.D + 1;
    for (int lh = 1; lh * L <= lanes_max && lh <= p.H_out; ++lh) {
      const int rows = (lh - 1) * p.SH + p.KH;
      const int x_floats = (rows * cols * q->XS + 3) & ~3;
      const int bytes = 4 * slots * (x_floats + q->w_floats);
      if (bytes > SMEM_SM / MINB) break;
      const int threads = q->WO * lh * L;
      if (threads < min_threads) continue;
      const double warps = (double)cdiv(p.H_out, lh) * strips * cdiv(threads, 32);
      const double halo = (double)rows * cols / ((double)lh * tw * p.S);
      const double cost = warps * (1.0 + 0.1 * (halo - 1.0));
      if (best >= 0 && (cost > best || (cost == best && threads <= q->threads))) continue;
      best = cost;
      q->L = L;
      q->LH = lh;
      q->TW = tw;
      q->threads = threads;
      q->strips = strips;
      q->line_tiles = cdiv(p.H_out, lh);
      q->rows = rows;
      q->cols = cols;
      q->x_floats = x_floats;
      q->smem_bytes = bytes;
    }
  }
  if (best < 0) return false;
  q->stage_floats = q->x_floats + q->w_floats;
  q->blocks = p.B * p.classes * q->line_tiles * q->strips * q->o_tiles;
  return true;
}

// Serialises planning and launching (ctypes drops the GIL during a call):
// the plan cache and each kernel's shared-memory limit are shared.
inline std::mutex& lock() {
  static std::mutex mu;
  return mu;
}

// The kernel's dynamic shared-memory limit, set before every planning
// step and every launch of a plan over 48 KB; it only grows, so every plan
// made before still launches (set once and not again, wgrad.cuh's 53 KB
// plans ran up to 14% slower on an H100: PERF.md §6).
template <typename T, int QP, int QO, int CV, int MINB>
int smem_limit(int bytes) {
  static int limit = 48 * 1024;
  if (bytes <= 48 * 1024) return 0;
  if (bytes > limit) limit = bytes;
  return (int)cudaFuncSetAttribute(fwd_kernel<T, QP, QO, CV, MINB>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
}

// The plan for one thread tile: up to 256 threads with the most channels
// a chunk (16, 8, 4) and the deepest ring (3, 2) that fit MINB blocks an
// SM, a block of at least 3/4 of the threads the lanes allow first (small
// blocks with a large ring leave an SM a few warps); while the grid would
// not fill the card once, the position lanes halve; the plan of least
// modelled time is kept (q->cost: a smaller block fills more SMs, but its
// weights for every tap do not shrink, so it stages more a FMA).
template <typename T, int QP, int QO, int CV, int MINB>
int prepare(const Args& p, int variant, Plan* q) {
  *q = Plan{};
  q->variant = variant;
  const int wo_max = QO == 1 ? 1 : 64 / QO;  // at most 64 output channels a block
  q->WO = cdiv(p.C_out, QO) < wo_max ? cdiv(p.C_out, QO) : wo_max;
  if (p.groups > 1)  // BO divides a group's C_out / groups (a multiple of QO)
    while ((p.C_out / p.groups / QO) % q->WO) --q->WO;
  q->BO = q->WO * QO;
  q->o_tiles = cdiv(p.C_out, q->BO);
  const int c4 = cdiv(group_in(p), 4) * 4;
  const int bc_max = CV == 1 ? 1 : (c4 < 16 ? c4 : 16);
  Plan best{};
  double best_cost = -1;
  for (int lanes = MAX_THREADS / q->WO; lanes >= 1; lanes /= 2) {
    const int most = q->WO * lanes;
    bool fit = false;
    for (int min_threads : {most * 3 / 4, 0}) {
      for (int bc = bc_max; !fit; bc = bc > 8 ? 8 : 4) {
        for (int stages = 3; stages >= 2 && !fit; --stages)
          fit = geometry<QP, QO, CV, MINB>(p, lanes, min_threads, bc, stages, q);
        // where the weights for every tap, not the window, fill a stage (k
        // = 41), a shallower ring if it holds a larger block
        Plan two = *q;
        if (fit && q->stages == 3 && q->w_floats >= q->x_floats &&
            geometry<QP, QO, CV, MINB>(p, lanes, min_threads, bc, 2, &two) &&
            two.threads > q->threads)
          *q = two;
        if (bc <= 4) break;
      }
      if (fit) break;
    }
    if (!fit) continue;
    int err = smem_limit<T, QP, QO, CV, MINB>(q->smem_bytes);
    int per_sm = 0;
    if (!err)
      err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fwd_kernel<T, QP, QO, CV, MINB>, q->threads, q->smem_bytes);
    if (err) return err;
    // the time model: a block costs its FMAs and, at 64 FMAs a float, the
    // floats it stages (a weight of 1, 4, 16, 32, 64 A/B'd on an H100: 64
    // the fastest at B=1, equal at B=4); an SM runs its resident blocks at
    // a rate that grows with their warps up to 16 (the 8 x 8 tile's two
    // blocks; QO = 4 tiles at 3/4 of it), over ceil(blocks / slots) waves
    const int sms = sm_count();
    const long per = per_sm < 1 ? 1 : per_sm;
    const long resident = q->blocks < per * sms ? cdiv(q->blocks, sms) : per;
    const double warps = (double)resident * cdiv(q->threads, 32);
    const double fmas = (double)q->threads * QP * QO * p.KH * p.K * q->chunks * q->BC;
    const double copies = (double)q->chunks * (q->x_floats + q->w_floats);
    const double rate = (QO >= 8 ? 1.0 : 0.75) * (warps < 16 ? warps : 16) / 16;
    q->cost = (double)cdiv(q->blocks, (int)(per * sms)) * resident * (fmas + 64 * copies) / rate;
    if (best_cost < 0 || q->cost < best_cost) {
      best = *q;
      best_cost = q->cost;
    }
    if (q->blocks >= per * sms) break;
  }
  *q = best;
  q->cost = best_cost;  // < 0: no block of this tile fits
  return 0;
}

// The thread tiles (QP, QO, CV, blocks an SM): variant 2 a single output
// channel (C_out = 1: conv_post, MRD layer 0's input gradient), 1 a single
// input channel (MRD layer 0, the noise convs; one channel a window read),
// else 0 (8 x 8), or 3 (4 x 4 at four blocks an SM: a quarter of the
// outputs a thread) where the planner's model finds it faster: a problem
// too small for 8 x 8 to keep the SMs busy (a B=1 request, conv_pre).
// Chosen by A/Bs on an H100 (PERF.md §6): 8 x 8 at two 256-thread blocks
// an SM beat 8 x 4 and 4 x 8 at three, 4 x 4 at four, 12 x 8 at one, and a
// slide of the window through registers on the B=4 pass; the plan's model
// rates 4 x 4 at 3/4 of 8 x 8 (slower where both fill the card).
#define CONVF_V0 8, 8, 4, 2
#define CONVF_V1 8, 8, 1, 2
#define CONVF_V2 8, 1, 4, 2
#define CONVF_V3 4, 4, 4, 4
template <typename T>
int plan_for(const Args& p, Plan* q) {
  int err = p.C_out == 1  ? prepare<T, CONVF_V2>(p, 2, q)
            : p.C_in == 1 ? prepare<T, CONVF_V1>(p, 1, q)
                          : prepare<T, CONVF_V0>(p, 0, q);
  if (err) return err;
  if (q->cost < 0) return (int)cudaErrorInvalidValue;
  if (p.C_out == 1 || p.C_in == 1) return 0;
  // the small tile where it models faster (a problem that leaves SMs idle;
  // at k = 41 and 64 output channels its weights do not fit four blocks)
  Plan small;
  err = prepare<T, CONVF_V3>(p, 3, &small);
  if (err) return err;
  if (small.cost >= 0 && small.cost < q->cost) *q = small;
  return 0;
}

// plan_for once per problem (the shapes; not the slope or the flags). The
// caller holds lock().
template <typename T>
int cached_plan(const Args& p, Plan* q) {
  static std::map<std::array<int, 19>, Plan> plans;
  const std::array<int, 19> key{p.B,  p.H_in, p.H_out, p.KH, p.SH,   p.PH,      p.T_in,
                                p.T_out, p.C_in, p.C_out, p.K, p.S, p.D,       p.P,
                                p.KW, p.flip, p.classes, p.pad_t, p.groups};
  auto it = plans.find(key);
  if (it == plans.end()) {
    Plan fresh;
    const int err = plan_for<T>(p, &fresh);
    if (err) return err;
    it = plans.emplace(key, fresh).first;
  }
  *q = it->second;
  return 0;
}

template <typename T, int QP, int QO, int CV, int MINB>
int launch(const T* x, const T* w, const T* bias, const T* res, T* out,
           const Args& p, const Plan& q, cudaStream_t stream) {
  const int err = smem_limit<T, QP, QO, CV, MINB>(q.smem_bytes);
  if (err) return err;
  fwd_kernel<T, QP, QO, CV, MINB><<<q.blocks, q.threads, q.smem_bytes, stream>>>(
      x, w, bias, res, out, p, q);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// One launch. bias and res may be null. A 16-byte cp.async needs a
// 16-byte-aligned source and a float4 store an aligned destination: a
// view at an offset takes 4-byte copies into the same window layout and
// scalar stores, with the same sums.
template <typename T>
int run(const T* x, const T* w, const T* bias, const T* res, T* out, const Args& p,
        cudaStream_t stream) {
  // a group's output channels are whole 8-channel tiles
  if (p.groups < 1 || p.C_in % p.groups || p.C_out % p.groups ||
      (p.groups > 1 && (p.C_out / p.groups) % 8))
    return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(lock());
  Plan q;
  int err = cached_plan<T>(p, &q);
  if (err) return err;
  q.vec_x = p.C_in % 4 == 0 && group_in(p) % 4 == 0 && aligned16(x);
  q.vec_w = p.C_out % 4 == 0 && q.BO % 4 == 0 && aligned16(w);
  q.vec_o = p.C_out % 4 == 0 && aligned16(out) && (!res || aligned16(res)) &&
            (!bias || aligned16(bias));
  switch (q.variant) {
    case 1:
      return launch<T, CONVF_V1>(x, w, bias, res, out, p, q, stream);
    case 2:
      return launch<T, CONVF_V2>(x, w, bias, res, out, p, q, stream);
    case 3:
      return launch<T, CONVF_V3>(x, w, bias, res, out, p, q, stream);
    default:
      return launch<T, CONVF_V0>(x, w, bias, res, out, p, q, stream);
  }
}

}  // namespace
}  // namespace convf

#endif  // FDT_CONV_FWD_CUH
