// K5 istft: the inverse STFT by windowed overlap-add, in three plans.
//
// Replaces fish_diffusion_tpu/ops/mel.py:istft, which took jnp.fft.irfft of
// every frame, multiplied it by the window and scatter-added the frames at
// frame * hop before dividing by the window-square envelope:
//
//   frame[b, f, n] = w[n] irfft(re[b, :, f] + i im[b, :, f])[n],  n < N
//   y[b, t] = (sum_{f : 0 <= t - f * hop < N} frame[b, f, t - f * hop])
//             / env[t]
//
// with N = n_fft, bins = N / 2 + 1, w the periodic Hann window of
// win_length centred in N zeros, env the window-square envelope
// max(sum_f w[t - f * hop]^2, 1e-11) (built and cached on the host), and the
// output trimmed by N / 2 at each end when centred (offset). irfft reads
// neither the imaginary part of bin 0 nor, for an even N, the Nyquist
// bin's: every plan drops them, as the plain version does.
//
// Every plan sums the frames covering a sample in increasing f (a gather:
// no atomics, so the result does not depend on the schedule) and divides by
// env[t]. istft_plan(n_fft, hop, F) gives the rule:
//
// (a) DIRECT, n_fft 16 and 32 (iSTFTNet's 16), any hop. A block walks
//     tiles of FB frames of one item (FB + halo <= 512 frames computed,
//     halo = ceil(N / hop) - 1 frames before the first), the next two
//     tiles' re and im rows [bins][FB + halo] staged by one lane a row of
//     warp 0 with TMA bulk copies (csrc/bulk_copy.cuh; the rows lie F floats
//     apart, so their unaligned edges go by cp.async). A thread computes one
//     frame's inverse DFT in registers, compiled for its size: the twiddles
//     are a quarter wave in registers indexed at compile time, so a frame
//     costs 2 bins loads from shared memory and ~N bins products; the
//     windowed frames go to shared memory, then each output sample sums its
//     covering frames and, in the same order, their window squares (the
//     envelope, equal to the host's table, which this plan does not read).
//     The frames never reach device memory.
// (b) FFT, up to what the float32 shared-memory core holds (L <= 16384 and
//     the staged spectra beside it: n_fft a power of two up to 8192, others
//     by Bluestein on L >= 2N - 1). A block takes CF = 4 frames (2 where
//     that does not fit); their spectra are staged coalesced along f into
//     shared memory [bins][CF + 1], and each pair of frames goes through
//     one complex inverse transform: Q = H_f + i H_{f+1} (H the Hermitian
//     extension of a frame's spectrum, each frame divided by a power of two
//     above its own peak, so that a quiet frame keeps its own accuracy; an
//     odd last frame pairs with zeros), IDFT(Q) = conj(DFT(conj Q)) / N on
//     fft_core.cuh's Stockham core (Bluestein for other N). The windowed
//     frames go to a [B, F, N] scratch and a second launch gathers them.
//     (A variant that also transformed the halo's frames and overlap-added
//     in shared memory, so that no frame reached device memory, ran slower
//     at n_fft 2048 and 2299 and was not kept.)
// (c) SPLIT, past shared memory: the same packed inverse as four-step FFTs
//     through device memory (fft_core.cuh split_transform) in float64 (the
//     float64 tables), frames [B, F, N] in device memory, then the gather.
//
// Bound on an H100: bytes at iSTFTNet's shape (n_fft 16, hop 8: 18
// spectrum values read per 8 samples written), and at n_fft 2048 too (an
// FFT needs 2.5 N log2 N operations a frame, ~5 operations a byte). The
// direct plan reads each byte once; its shared-memory traffic is the
// staged rows once and the frames twice. The FFT plan is bound by the
// core's barriers (a pass is one round of loads, a barrier, stores and a
// barrier) and writes and reads the frames once through the scratch
// (mostly in L2). Only plain C++ over threadIdx / blockIdx / blockDim,
// shared memory, __syncthreads and bulk_copy.cuh, so
// tests/test_torch_csrc_emulated.py runs this file on the host.

#include <cuda_runtime.h>
#include "bulk_copy.cuh"
#include "fft_core.cuh"

namespace {

enum { DIRECT = 0, FFT = 1, SPLIT = 2 };

// The shared memory a block of the direct and FFT plans may take: an H100
// block's. tests/test_torch_csrc_emulated.py builds the file with less, so
// that small sizes reach the split path; chip_istft_plans.py builds it with
// less than the direct plan takes, so that n_fft 16 and 32 take the FFT
// plan, to time the rule's threshold.
#ifndef SMEM_MAX
#define SMEM_MAX MAX_SMEM
#endif

constexpr int DIRECT_T = 512;
constexpr int CF_MAX = 4;  // frames the FFT plan stages at a time
constexpr int OLA_T = 256;

// The direct plan, for n_fft 16 and 32 (NT, a template argument): a tile is
// FB frames of one item and their samples, FB + halo <= DIRECT_T frames
// computed, one a thread; a block walks tiles blockIdx.x, + n_blocks, ...
// with the next two tiles' rows in flight. Shared memory: the two slots'
// barriers, the rows' leads [2][2 bins], the window's squares [NT], the
// slots [2][2 bins][RS] and the frames [DIRECT_T][NT + 4] (the pad puts a
// warp's 16-byte stores of neighbouring frames on distinct banks).
struct Direct {
  int bins, halo, FB, RS, tiles_a_item, hop_shift, off_lead, off_wsq, off_rows, off_frames,
      smem;
};

__host__ __device__ inline Direct direct_geometry(int N, int hop, int F) {
  Direct d;
  d.bins = N / 2 + 1;
  d.halo = (N - 1) / hop;
  d.FB = DIRECT_T - d.halo > 8 ? DIRECT_T - d.halo : 8;
  d.tiles_a_item = (F + d.FB - 1) / d.FB;
  d.hop_shift = -1;  // log2(hop) for a power of two: shifts, not divisions
  for (int e = 0; e < 31 && d.hop_shift < 0; ++e)
    if (hop == 1 << e) d.hop_shift = e;
  d.RS = (3 + d.FB + d.halo + 3) / 4 * 4;  // a row's lead (<= 3) and values, whole 16 bytes
  d.off_lead = 16;
  d.off_wsq = d.off_lead + 2 * 2 * d.bins * 4;
  d.off_rows = bulk::round16(d.off_wsq + N * 4);
  d.off_frames = d.off_rows + 2 * 2 * d.bins * d.RS * 4;
  d.smem = d.off_frames + (d.FB + d.halo) * (N + 4) * 4;
  return d;
}

// tile -> its item, its frames (staged from fs, nf of them; owned from
// f0) and its samples [t_lo, t_hi) (an item's last tile has the tail)
struct Tile {
  int b, fs, nf, f0, t_lo, t_hi;
};

__host__ __device__ __forceinline__ Tile tile_of(int tile, const Direct& g, int F, int N,
                                                 int hop) {
  Tile t;
  t.b = tile / g.tiles_a_item;
  t.f0 = (tile - t.b * g.tiles_a_item) * g.FB;
  t.fs = t.f0 - g.halo > 0 ? t.f0 - g.halo : 0;
  const int fe = t.f0 + g.FB < F ? t.f0 + g.FB : F;
  t.nf = fe - t.fs;
  t.t_lo = t.f0 * hop;
  t.t_hi = fe == F ? N + hop * (F - 1) : fe * hop;
  return t;
}

// one lane of warp 0 a row: the tile's re and im rows into a slot (every
// lane arrives twice: its bytes, its edges)
__device__ __forceinline__ void stage_tile(const float* re, const float* im, int tile,
                                           const Direct& g, int F, int N, int hop, float* slot,
                                           int* leads, bulk::bar_t* bar) {
  const Tile t = tile_of(tile, g, F, N, hop);
  const int lane = threadIdx.x, bins = g.bins;
  unsigned bytes = 0;
  for (int r = lane; r < 2 * bins; r += 32) {
    const float* src = (r < bins ? re : im) + ((size_t)t.b * bins + r % bins) * F + t.fs;
    leads[r] = bulk::lead(src);
    bulk::stage_edges(slot + r * g.RS, src, t.nf);
    bytes += bulk::stage_bytes(src, t.nf);
  }
  bulk::expect(bar, bytes);
  for (int r = lane; r < 2 * bins; r += 32) {
    const float* src = (r < bins ? re : im) + ((size_t)t.b * bins + r % bins) * F + t.fs;
    bulk::stage_middle(slot + r * g.RS, src, t.nf, bar);
  }
  bulk::edges_landed(bar);
  bulk::landed(bar);
}

// cos and sin of 2 pi m / N from the quarter wave cq[r] = cos(2 pi r / N),
// r <= N / 4 (m known at compile time once the loops are unrolled)
template <int N>
__device__ __forceinline__ void cos_sin(const float* cq, int m, float& c, float& s) {
  m %= N;
  const int q = m / (N / 4), r = m % (N / 4);
  if (q == 0) { c = cq[r]; s = cq[N / 4 - r]; }
  else if (q == 1) { c = -cq[N / 4 - r]; s = cq[r]; }
  else if (q == 2) { c = -cq[r]; s = -cq[N / 4 - r]; }
  else { c = cq[N / 4 - r]; s = -cq[r]; }
}

template <int NT>
__global__ void __launch_bounds__(DIRECT_T) istft_direct(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ window,  // [NT]
    const float2* __restrict__ tw,     // [NT]: cos, -sin of 2 pi t / NT
    float* __restrict__ out, int B, int F, int hop, int n_out, int offset, int n_blocks,
    Direct g) {
  constexpr int N = NT, BINS = N / 2 + 1, FS = N + 4;
  extern __shared__ __align__(16) unsigned char smem_direct[];
  unsigned char* smem = smem_direct;
  bulk::bar_t* bar = reinterpret_cast<bulk::bar_t*>(smem);
  int* leads = reinterpret_cast<int*>(smem + g.off_lead);     // [2][2 bins]
  float* wsq = reinterpret_cast<float*>(smem + g.off_wsq);
  float* rows = reinterpret_cast<float*>(smem + g.off_rows);  // [2][2 bins][RS]
  float* frames = reinterpret_cast<float*>(smem + g.off_frames);
  const int tid = threadIdx.x, slot_words = 2 * BINS * g.RS;
  const int tiles = B * g.tiles_a_item;

  if (tid == 0) {
    bulk::init(bar, 64);
    bulk::init(bar + 1, 64);
    bulk::fence_init();
  }
  __syncthreads();
  if (tid < 32)
    for (int q = 0; q < 2; ++q)
      if (blockIdx.x + q * n_blocks < tiles)
        stage_tile(re, im, blockIdx.x + q * n_blocks, g, F, N, hop, rows + q * slot_words,
                   leads + q * 2 * BINS, bar + q);
  // in registers: the quarter wave and the window over N
  float cq[N / 4 + 1], wn[N];
#pragma unroll
  for (int r = 0; r <= N / 4; ++r) cq[r] = tw[r].x;
#pragma unroll
  for (int n = 0; n < N; ++n) wn[n] = window[n] * (1.f / N);
  if (tid < N) wsq[tid] = window[tid] * window[tid];

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += n_blocks, ++it) {
    const int q = it & 1;
    const Tile t = tile_of(tile, g, F, N, hop);
    const float* rs = rows + q * slot_words;
    const int* ls = leads + q * 2 * BINS;
    bulk::wait(bar + q, (it >> 1) & 1);
    // each frame's windowed inverse DFT, a thread a frame:
    // x[n] = w[n] / N sum_k c_k (re_k cos - im_k sin)(2 pi k n / N)
    for (int fi = tid; fi < t.nf; fi += DIRECT_T) {
      float acc[N];
#pragma unroll
      for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
      for (int k = 0; k < BINS; ++k) {
        const bool edge = k == 0 || 2 * k == N;  // c_k = 1, no imaginary part
        const float a = rs[k * g.RS + ls[k] + fi] * (edge ? 1.f : 2.f);
        const float b = edge ? 0.f : 2.f * rs[(BINS + k) * g.RS + ls[BINS + k] + fi];
#pragma unroll
        for (int n = 0; n < N; ++n) {
          float c, s;
          cos_sin<N>(cq, k * n, c, s);
          acc[n] += a * c;
          if (!edge) acc[n] -= b * s;
        }
      }
      float4* dst = reinterpret_cast<float4*>(frames + fi * FS);
#pragma unroll
      for (int v = 0; v < N / 4; ++v)
        dst[v] = make_float4(acc[4 * v] * wn[4 * v], acc[4 * v + 1] * wn[4 * v + 1],
                             acc[4 * v + 2] * wn[4 * v + 2], acc[4 * v + 3] * wn[4 * v + 3]);
    }
    __syncthreads();  // the slot is read whole; the frames are written
    if (tid < 32 && tile + 2 * n_blocks < tiles)
      stage_tile(re, im, tile + 2 * n_blocks, g, F, N, hop, rows + q * slot_words,
                 leads + q * 2 * BINS, bar + q);
    // the tile's samples kept by the trim: the covering frames in
    // increasing f, over the envelope max(sum_f w^2, 1e-11), summed here in
    // the same order as the host's table (mel._istft_envelope), so equal
    // to it
    const int lo = t.t_lo > offset ? t.t_lo : offset;
    const int hi = t.t_hi < offset + n_out ? t.t_hi : offset + n_out;
    float* ob = out + (size_t)t.b * n_out;
    // four samples a thread where they share their frames and 16-byte
    // alignment (hop, the trim and the output's rows multiples of 4:
    // iSTFTNet's), else one
    const int V = (hop & 3) == 0 && (offset & 3) == 0 && (n_out & 3) == 0 ? 4 : 1;
    for (int s = lo + V * tid; s < hi; s += V * DIRECT_T) {
      const int f_top = g.hop_shift >= 0 ? s >> g.hop_shift : s / hop;
      const int f_hi = f_top < F - 1 ? f_top : F - 1;
      const int f_lo =
          s >= N ? (g.hop_shift >= 0 ? (s - N) >> g.hop_shift : (s - N) / hop) + 1 : 0;
      const int n = s - f_lo * hop;
      const float* fp = frames + (f_lo - t.fs) * FS + n;
      const float* wp = wsq + n;
      if (V == 4) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f), e = acc;
        for (int f = f_lo; f <= f_hi; ++f, fp += FS - hop, wp -= hop) {
          const float4 x = *reinterpret_cast<const float4*>(fp);
          const float4 w = *reinterpret_cast<const float4*>(wp);
          acc = make_float4(acc.x + x.x, acc.y + x.y, acc.z + x.z, acc.w + x.w);
          e = make_float4(e.x + w.x, e.y + w.y, e.z + w.z, e.w + w.w);
        }
        *reinterpret_cast<float4*>(ob + s - offset) =
            make_float4(acc.x / fmaxf(e.x, 1e-11f), acc.y / fmaxf(e.y, 1e-11f),
                        acc.z / fmaxf(e.z, 1e-11f), acc.w / fmaxf(e.w, 1e-11f));
      } else {
        float acc = 0.f, e = 0.f;
        for (int f = f_lo; f <= f_hi; ++f, fp += FS - hop, wp -= hop) {
          acc += *fp;
          e += *wp;
        }
        ob[s - offset] = acc / fmaxf(e, 1e-11f);
      }
    }
    __syncthreads();  // the frames are read whole before the next tile's
  }
}

template <int NT>
int launch_direct(const Direct& g, int n_blocks, cudaStream_t s, const float* re,
                  const float* im, const float* window, const float2* tw, float* out, int B,
                  int F, int hop, int n_out, int offset) {
  static bool done = false;
  allow_smem(istft_direct<NT>, done);
  istft_direct<NT><<<n_blocks, DIRECT_T, g.smem, s>>>(re, im, window, tw, out, B, F, hop,
                                                      n_out, offset, n_blocks, g);
  return (int)cudaGetLastError();
}

// The FFT plan's geometry: threads (a thread holds V values in a pass, as
// in stft.cu); CF frames a block, 4 or, where that does not fit, 2; shared
// memory: the buffer [buf_size(L)] and the reduction's [threads + 32]
// complex values, then the staged spectra [2][bins][CF + 1] floats (re,
// then im; a pad column keeps a warp's reads of consecutive bins on
// distinct banks). The windowed frames go through a [B, F, N] scratch to
// the gather (overlap_env).
struct Fft {
  int L, threads, CF, off_stage, smem;
};

__host__ __device__ inline int fft_length(int N) {
  if ((N & (N - 1)) == 0) return N;
  int L = 1;
  while (L < 2 * N - 1) L *= 2;
  return L;
}

__host__ __device__ inline Fft fft_geometry(int N) {
  Fft g;
  g.L = fft_length(N);
  g.threads = g.L <= 2048 ? (g.L / 8 < 64 ? 64 : g.L / 8) : g.L / 16;
  g.off_stage = (buf_size(g.L) + g.threads + 32) * (int)sizeof(cf);
  g.CF = CF_MAX;
  while (g.CF > 2 && g.off_stage + 2 * (N / 2 + 1) * (g.CF + 1) * 4 > SMEM_MAX) g.CF /= 2;
  g.smem = g.off_stage + 2 * (N / 2 + 1) * (g.CF + 1) * 4;
  return g;
}

// The packed inverse's input conj(Q) at bin k (and N - k), Q = H_f / s_f +
// i H_g / s_g, chirped for Bluestein: a, b the scaled re and im of frame
// f, c, d of frame g.
template <class T>
__device__ __forceinline__ void packed_bin(int k, int N, T a, T b, T c, T d,
                                           const cplx<T>* __restrict__ chirp, cplx<T>& q,
                                           cplx<T>& qm) {
  if (k == 0 || 2 * k == N) {
    q = {a, -c};
    if (chirp) q = cmul(q, chirp[k]);
  } else {
    q = {a - d, -(b + c)};
    qm = {a + d, b - c};
    if (chirp) {
      q = cmul(q, chirp[k]);
      qm = cmul(qm, chirp[N - k]);
    }
  }
}

// frame f's spectrum at bin k (the imaginary parts irfft ignores dropped)
__device__ __forceinline__ void bin_of(const float* re, const float* im, size_t at, int k,
                                       int N, float& a, float& b) {
  a = re[at];
  b = (k == 0 || 2 * k == N) ? 0.f : im[at];
}

template <int MAXT, int MINB, int V>
__global__ void __launch_bounds__(MAXT, MINB) istft_fft(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ window,  // [N]
    const cf* __restrict__ tw, const cf* __restrict__ chirp, const cf* __restrict__ filt,
    float* __restrict__ frames,  // [B, F, N]
    int F, int N, Fft g) {
  extern __shared__ float smem[];
  cf* buf = reinterpret_cast<cf*>(smem);
  cf* red = buf + buf_size(g.L);
  float* stage = smem + g.off_stage / 4;  // [2][bins][CF + 1]
  const int b = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  const int bins = N / 2 + 1, SR = g.CF + 1;
  const int f0 = blockIdx.x * g.CF;
  const int nc = F - f0 < g.CF ? F - f0 : g.CF;
  const float inv_n = 1.f / (float)N;
  const float* re_b = re + (size_t)b * bins * F;
  const float* im_b = im + (size_t)b * bins * F;

  // the block's spectra, coalesced along f
  for (int e = tid; e < bins * nc; e += nt) {
    const int k = e / nc, i = e - k * nc;
    float a, bb;
    bin_of(re_b, im_b, (size_t)k * F + f0 + i, k, N, a, bb);
    stage[k * SR + i] = a;
    stage[(bins + k) * SR + i] = bb;
  }
  __syncthreads();
  for (int p = 0; p < nc; p += 2) {
    const int f = f0 + p;
    const bool second = p + 1 < nc;
    const int pg = second ? p + 1 : p;
    cf m = {0.f, 0.f};
    for (int k = tid; k < bins; k += nt) {
      const float c = second ? stage[k * SR + pg] : 0.f;
      const float d = second ? stage[(bins + k) * SR + pg] : 0.f;
      m = {tmax(m.x, tmax(tabs(stage[k * SR + p]), tabs(stage[(bins + k) * SR + p]))),
           tmax(m.y, tmax(tabs(c), tabs(d)))};
    }
    m = block_max(m, red);
    cf s, inv;
    pow2_above(m.x, s.x, inv.x);
    pow2_above(m.y, s.y, inv.y);
    for (int k = tid; k < bins; k += nt) {
      const float c = second ? stage[k * SR + pg] : 0.f;
      const float d = second ? stage[(bins + k) * SR + pg] : 0.f;
      cf q, qm;
      packed_bin(k, N, stage[k * SR + p] * inv.x, stage[(bins + k) * SR + p] * inv.x,
                 c * inv.y, d * inv.y, chirp, q, qm);
      buf[pad(k)] = q;
      if (k != 0 && 2 * k != N) buf[pad(N - k)] = qm;
    }
    for (int n = N + tid; n < g.L; n += nt) buf[pad(n)] = {0.f, 0.f};
    __syncthreads();
    transform<V>(buf, g.L, tw, filt);
    const float sf = s.x * inv_n, sg = s.y * inv_n;
    float* out0 = frames + ((size_t)b * F + f) * N;
    for (int n = tid; n < N; n += nt) {
      const cf r = spectrum(buf, n, chirp);
      out0[n] = r.x * sf * window[n];
      if (second) out0[N + n] = -r.y * sg * window[n];
    }
    __syncthreads();  // buf is read whole before it is written again
  }
}

template <int MAXT, int MINB, int V>
int launch_fft(const Fft& g, dim3 grid, cudaStream_t s, const float* re, const float* im,
               const float* window, const cf* tw, const cf* chirp, const cf* filt,
               float* frames, int F, int N) {
  static bool done = false;
  allow_smem(istft_fft<MAXT, MINB, V>, done);
  istft_fft<MAXT, MINB, V><<<grid, g.threads, g.smem, s>>>(re, im, window, tw, chirp, filt,
                                                           frames, F, N, g);
  return (int)cudaGetLastError();
}

int run_fft(const Fft& g, dim3 grid, cudaStream_t s, const float* re, const float* im,
            const float* window, const cf* tw, const cf* chirp, const cf* filt,
            float* frames, int F, int N) {
  if (g.L <= 2048)
    return launch_fft<256, 3, 8>(g, grid, s, re, im, window, tw, chirp, filt, frames, F, N);
  if (g.L <= 8192)
    return launch_fft<512, 1, 16>(g, grid, s, re, im, window, tw, chirp, filt, frames, F, N);
  return launch_fft<1024, 1, 16>(g, grid, s, re, im, window, tw, chirp, filt, frames, F, N);
}

// The split plan, float64 (the tables' type). Pair (blockIdx.x, item
// blockIdx.y): each frame's scale, then conj(Q) into the pair's buffer in
// natural order, zero-padded to L.
__global__ void __launch_bounds__(SPLIT_T) split_in(
    const float* __restrict__ re, const float* __restrict__ im,
    const cd* __restrict__ chirp, cd* __restrict__ work, cd* __restrict__ scales, int F,
    int N, int L) {
  __shared__ cd red[SPLIT_T + 32];
  const int pairs = (F + 1) / 2;
  const int f = 2 * blockIdx.x, bins = N / 2 + 1;
  const bool second = f + 1 < F;
  const size_t pi = (size_t)blockIdx.y * pairs + blockIdx.x;
  const float* re_b = re + (size_t)blockIdx.y * bins * F;
  const float* im_b = im + (size_t)blockIdx.y * bins * F;
  cd m = {0, 0};
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    float a, bb, c = 0.f, d = 0.f;
    bin_of(re_b, im_b, (size_t)k * F + f, k, N, a, bb);
    if (second) bin_of(re_b, im_b, (size_t)k * F + f + 1, k, N, c, d);
    m = {tmax(m.x, (double)tmax(tabs(a), tabs(bb))), tmax(m.y, (double)tmax(tabs(c), tabs(d)))};
  }
  m = block_max(m, red);
  cd s, inv;
  pow2_above(m.x, s.x, inv.x);
  pow2_above(m.y, s.y, inv.y);
  if (threadIdx.x == 0) scales[pi] = s;
  cd* buf = work + pi * L;
  for (int k = threadIdx.x; k < bins; k += blockDim.x) {
    float a, bb, c = 0.f, d = 0.f;
    bin_of(re_b, im_b, (size_t)k * F + f, k, N, a, bb);
    if (second) bin_of(re_b, im_b, (size_t)k * F + f + 1, k, N, c, d);
    cd q, qm;
    packed_bin<double>(k, N, a * inv.x, bb * inv.x, c * inv.y, d * inv.y, chirp, q, qm);
    buf[k] = q;
    if (k != 0 && 2 * k != N) buf[N - k] = qm;
  }
  for (int n = N + threadIdx.x; n < L; n += blockDim.x) buf[n] = {0, 0};
}

// the pair's windowed frames w[n] s / N Re and -Im of the inverse, into
// frames [B, F, N]
__global__ void __launch_bounds__(SPLIT_T) split_out(
    const cd* __restrict__ work, const cd* __restrict__ chirp,
    const float* __restrict__ window, const cd* __restrict__ scales,
    float* __restrict__ frames, int N, int L1, int L2, int F) {
  const int pairs = (F + 1) / 2;
  const int f = 2 * blockIdx.x;
  const bool second = f + 1 < F;
  const size_t pi = (size_t)blockIdx.y * pairs + blockIdx.x;
  const cd* buf = work + pi * ((size_t)L1 * L2);
  const cd s = scales[pi];
  const double sf = s.x / N, sg = s.y / N;
  float* out0 = frames + ((size_t)blockIdx.y * F + f) * N;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const cd r = split_spectrum(buf, n, chirp, L1, L2);
    const double w = window[n];
    out0[n] = (float)(w * sf * r.x);
    if (second) out0[N + n] = (float)(-w * sg * r.y);
  }
}

// y[b, t] = (the frames covering t, in increasing f) / env[t], kept where
// the trim keeps it
__global__ void __launch_bounds__(OLA_T) overlap_env(
    const float* __restrict__ frames, const float* __restrict__ env, float* __restrict__ out,
    int N, int hop, int F, int n_out, int offset) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * OLA_T + threadIdx.x;
  if (i >= n_out) return;
  const int t = i + offset;
  const int f_lo = t >= N ? (t - N) / hop + 1 : 0;
  const int f_hi = t / hop < F - 1 ? t / hop : F - 1;
  const float* fb = frames + (size_t)b * F * N;
  float acc = 0.f;
  for (int f = f_lo; f <= f_hi; ++f) acc += fb[(size_t)f * N + (t - f * hop)];
  out[(size_t)b * n_out + i] = acc / env[t];
}

int overlap(cudaStream_t s, const float* frames, const float* env, float* out, int B, int N,
            int hop, int F, int n_out, int offset) {
  const dim3 grid((n_out + OLA_T - 1) / OLA_T, B);
  overlap_env<<<grid, OLA_T, 0, s>>>(frames, env, out, N, hop, F, n_out, offset);
  return (int)cudaGetLastError();
}

// the plan a size takes: direct (n_fft 16 and 32, where shared memory
// holds it), FFT (shared memory), split; -1 for none
int rule(int N, int hop) {
  if (N < 1 || hop < 1) return -1;
  if ((N == 16 || N == 32) && direct_geometry(N, hop, 1).smem <= SMEM_MAX) return DIRECT;
  if (fft_length(N) <= MAX_L && fft_geometry(N).smem <= SMEM_MAX) return FFT;
  return fft_length(N) <= MAX_L_SPLIT ? SPLIT : -1;
}

// the direct plan's blocks: as many as the card holds at once
int direct_blocks(const Direct& g, int tiles) {
  const int sms = bulk::sm_count();
  int per_sm = 233472 / (g.smem + 1024);  // an SM's shared memory, 1 KB a block reserved
  per_sm = per_sm > 2048 / DIRECT_T ? 2048 / DIRECT_T : (per_sm < 1 ? 1 : per_sm);
  return tiles < sms * per_sm ? tiles : sms * per_sm;
}

}  // namespace

// The plan istft takes for (n_fft, hop, F): 0 direct, 1 FFT in shared
// memory, 2 split (four-step FFTs through device memory); -1 for a size it
// does not take.
extern "C" int istft_plan(int n_fft, int hop, int F) {
  return F < 1 ? -1 : rule(n_fft, hop);
}

// re, im [B, bins, F] float32; out [B, n_out] with n_out the samples kept
// after the trim (offset = n_fft / 2 when centred, else 0); env [n_fft +
// hop (F - 1)]; window [n_fft] float32 and twiddle [L], chirp [n_fft], filt
// [L] complex (mel._fft_tables: chirp and filt null for a power of two),
// float32 but for the split plan, whose tables are float64. Scratch (null
// where a plan does not read it): frames [B, F, n_fft] float32 (FFT,
// split); work [B, (F + 1) / 2, L] and scales [B, (F + 1) / 2] complex
// float64 and L1 (mel._split) for split. Contiguous (the Python wrapper
// checks). Launches one kernel (direct), two (FFT: the transforms, the
// gather) or the split path's five (eight by Bluestein). Returns the cudaError_t of the
// launches, or cudaErrorInvalidValue for a size no plan takes.
extern "C" int istft(const void* re, const void* im, const void* window, const void* twiddle,
                     const void* chirp, const void* filt, const void* env, void* work,
                     void* scales, void* frames, void* out, int B, int F, int n_fft, int hop,
                     int L1, int n_out, int offset, void* stream) {
  const int plan = rule(n_fft, hop);
  const int N = n_fft;
  if (plan < 0 || F < 1 || B < 1 || n_out < 1 || !window || !twiddle
      || (plan != DIRECT && !frames))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* rp = (const float*)re;
  const float* ip = (const float*)im;
  const float* ep = (const float*)env;
  const float* wp = (const float*)window;
  float* op = (float*)out;
  float* fr = (float*)frames;
  if (plan == DIRECT) {
    const Direct g = direct_geometry(N, hop, F);
    const int n_blocks = direct_blocks(g, B * g.tiles_a_item);
    const float2* tp = (const float2*)twiddle;
    return N == 16 ? launch_direct<16>(g, n_blocks, s, rp, ip, wp, tp, op, B, F, hop, n_out,
                                       offset)
                   : launch_direct<32>(g, n_blocks, s, rp, ip, wp, tp, op, B, F, hop, n_out,
                                       offset);
  }
  if (plan == FFT) {
    const Fft g = fft_geometry(N);
    const dim3 grid((F + g.CF - 1) / g.CF, B);
    const int err = run_fft(g, grid, s, rp, ip, wp, (const cf*)twiddle, (const cf*)chirp,
                            (const cf*)filt, fr, F, N);
    return err != 0 ? err : overlap(s, fr, ep, op, B, N, hop, F, n_out, offset);
  }
  const int L = fft_length(N);
  if (!work || !scales || L1 < 1 || (L1 & (L1 - 1)) || L % L1 || L1 > MAX_SUB
      || L / L1 > MAX_SUB)
    return (int)cudaErrorInvalidValue;
  const int pairs = (F + 1) / 2;
  const dim3 grid(pairs, B);
  const cd* tp = (const cd*)twiddle;
  const cd* cp = (const cd*)chirp;
  split_in<<<grid, SPLIT_T, 0, s>>>(rp, ip, cp, (cd*)work, (cd*)scales, F, N, L);
  int err = split_transform<double>((cd*)work, tp, (const cd*)filt, pairs * B, L1, L / L1, s);
  if (err != 0) return err;
  split_out<<<grid, SPLIT_T, 0, s>>>((const cd*)work, cp, wp, (const cd*)scales, fr, N, L1,
                                     L / L1, F);
  err = (int)cudaGetLastError();
  return err != 0 ? err : overlap(s, fr, ep, op, B, N, hop, F, n_out, offset);
}
