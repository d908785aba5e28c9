// K3, K9 comb and K9 sine: the harmonic and comb sources from the frames'
// f0, with the frame-phase scan inside every kernel. Four kernels on one
// core:
//
// The frame-phase scan (K3's first half; replaces
// fish_diffusion_tpu/models/vocoders/source.py:77 blocked_phase). Frame k
// advances the phase by a_k = frac(float32(f0 / sr, IEEE) hop) (nearest
// f0, NSF-HiFiGAN) or by a_k = frac(f[k-1] A0 / sr + f[k] A1 / sr + f[k+1]
// A2 / sr) by three float64 FMAs (linear f0, RefineGAN; A the
// coefficients' sums over sr as a sample's lane takes them below, so that a
// frame advances by what its last sample's phase adds; edge frames
// repeated); its base is frac(a_0 + ... + a_{k-1}) in float64, rounded
// once to float32 (models/vocoders/source.py nsf_phase_base_reference,
// which divides by sr).
// Every kernel forms the bases of its block's frames in its setup, while
// the ring's first copies are in flight, unless the caller gives them
// (base [B, T]). The sum has one order, fixed by the frame index and not by
// the block: frames in tiles of 256; a tile by one warp, 8 consecutive
// frames a lane summed in order, the lanes' sums by a Hillis-Steele scan of
// shuffles (its last lane the tile's sum); the tiles' sums added in tile
// order. So every block, kernel and plan gets the same bits for a frame:
// the frames two blocks straddle agree, and the backward recomputes the
// forward's phase. In the nearest mode each a_k is a float32 value (fewer
// than 53 bits in any partial sum), so the bases equal the plain version's
// bit for bit; in the linear mode they agree to ~1e-13 of a turn. A block
// re-reads the f0 of the tiles up to its last frame (~4 KB at 1024 frames
// a row, from L2).
//
// nsf_merge (K3; replaces source.py:92 BlockedSineGen with the merge,
// :92-169). For sample s = k hop + j of item b (frame k):
//
//   phase = frac(base[b, k] + rad (j + 1)),   rad = f0[b, k] / sr
//   s_n = sine_amp sin(2 pi frac(n phase + r_n)) uv + amp noise[b, s, n - 1]
//   out[b, s] = tanh(sum_{n = 1..H} w_{n - 1} s_n + bias)
//
// with r_n = rand_ini[b, n - 1] (r_1 = 0), uv = f0 > 0 and amp = noise_std
// where voiced, sine_amp / 3 where not. The phase is formed as the plain
// version forms it: rad by an IEEE division, then base + rad (j + 1) in
// float32, rounded at each step, less its floor.
//
// nsf_merge_backward (K3's backward; replaces what XLA derives for
// source.py:92): with gz = g (1 - out^2), dW[n] = sum gz s_n and db = sum
// gz over every sample, the s_n recomputed as nsf_merge forms them. Each
// block writes its H + 1 sums (each warp's by a fixed butterfly of
// shuffles, then the warps' in order) and a second kernel adds the blocks'
// in block order: no atomics, so a second launch gives the same bits.
//
// sine_merge (K9 sine; replaces nsf_hifigan.py:188 _mod1_phase_scan under
// refinegan.py:252 RefineSineGen) and comb_merge (K9 comb; replaces
// source.py:172 BlockedCombTooth with :55 linear interpolation): f0
// linearly interpolated, sample j of frame k has, with the frame's
// neighbours (edges repeated) and the coefficient tables a [3, hop]
// (float32) and P [3, hop] (their inclusive prefix sums, float64):
//
//   f0s = (f[k-1] a0[j] + f[k] a1[j]) + f[k+1] a2[j]     (float32, no FMA)
//   phase = base[b, k] + (f[k-1] P0[j] + f[k] P1[j] + f[k+1] P2[j]) / sr
//
// in float64 (within a frame it reaches hop f0 / sr, ~128 near sr / 2,
// where float32's step would cost ~5e-5 of template), reduced mod 1. The
// division by sr is a multiplication by its float64 reciprocal, as torch
// divides a CUDA tensor by a scalar, folded into the prefix sums when a
// lane is read: the phase is base + f[k-1] (P0[j] / sr) + f[k] (P1[j] / sr)
// + f[k+1] (P2[j] / sr) by three float64 FMAs a sample (it moves by ~1e-14
// of a turn). sine_merge: each harmonic's sine is 0 where f0s n > sr // 2,
// voicing is f0s > 0, then the noise and the merge as nsf_merge's; the
// SIGNALS form also writes s [B, T hop, H], which the merge's analytic
// backward reads in training. comb_merge: with x = (float)(phase -
// rint(phase)) (half to even, as torch.round),
//
//   out = wave_amp sinc(sr x / (f0s + 1e-3)) uv + amp noise[b, s]
//
// in float32, the sinc in torch.sinc's form (p = pi z rounded to float32,
// sin(p) / p, 1 at z = 0).
//
// Bound on an H100: bytes. The noise [B, T hop, H] is read once and the
// output [B, T hop] written once (~40 bytes a sample at H = 9); the
// backward reads g and out instead of writing. Design: a block owns a run
// of SB samples of one item (chunks of 512, SB chosen so that the grid is
// about one wave of four blocks an SM). Its noise span is contiguous: one
// thread stages it a chunk at a time into a ring of 3 slots in shared
// memory by TMA bulk copies (csrc/bulk_copy.cuh; the unaligned edges of a
// ragged last chunk by cp.async), so every noise byte crosses the bus once
// in whole sectors; a thread reads its sample's H values from its slot at
// a stride of H words (no bank conflicts for odd H). comb_merge's noise (H
// = 1) is read straight into registers, coalesced, two chunks at a time
// (on the ring it was slower). The harmonics cost one
// sincospif a sample: harmonic n's angle comes from harmonic n - 1's by a
// rotation by the first's, and the start phase r_n by angle addition with
// its sine and cosine, formed once a block (the error grows with n, to
// ~1e-6 at n = 9). The frames' values (rad, base and gains; or the
// neighbours' f0 and base) are formed once a block into shared memory,
// while the first copies are in flight (with the scan, by the lanes that
// hold their f0). The linear modes read the
// coefficient lanes into registers: where hop divides the block's 256
// threads (RefineGAN's 256) each thread's samples lie on one lane, read
// once (the whole hop, ~9 KB, once a block); at larger hops each sample's
// lane is read with the chunk's other loads. (Lanes staged in shared
// memory and read there a sample at a time, six loads a sample, were
// slower.) g, out and the outputs are read and written coalesced, one
// sample a thread.

#include <cuda_runtime.h>
#include "bulk_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 512;   // samples a stage, two a thread
constexpr int STAGES = 3;
constexpr int MAX_H = 16;
constexpr int MAX_CHUNKS = 8;
constexpr int BLOCKS_AN_SM = 4;  // at H = 9: 3 slots of 18 KB
constexpr int TILE = 256;        // frames a tile of the phase scan
constexpr int TILE_LANE = TILE / 32;
constexpr int MAX_T = 1 << 20;   // frames a row: the scan's tile sums fit shared memory

struct Plan {
  int SB;      // samples a block (whole chunks)
  int frames;  // the frames a block's samples span, at most
  int SW;      // floats a slot: CHUNK H and the lead, whole 16 bytes (0: no ring)
  int off_frames, off_loc, off_tot, off_stage, smem;
};

// shared memory: the ring's barriers, the start phases' rotations [MAX_H]
// and the weights [MAX_H], the frames' values [frames], the scan's sums
// (the block's frames' within their tile [frames], the tiles' [tiles];
// none where the bases are given), the ring
__host__ __device__ constexpr int plan_smem(int frames, int scanned, int tiles, int SW) {
  return (32 + MAX_H * 8 + MAX_H * 4 + frames * 16 + scanned * 8 + tiles * 8 + 15) / 16 * 16 +
         STAGES * SW * 4;
}
// the most a plan takes: CHUNK + 2 frames (a block spans at most CHUNK
// frames and the two it straddles), every tile of MAX_T frames and MAX_H
// floats a sample
constexpr int SMEM_MOST =
    plan_smem(CHUNK + 2, CHUNK + 2, MAX_T / TILE, (CHUNK * MAX_H + 4 + 3) / 4 * 4);

// H = 0: no ring (the noise read straight from device memory); scan: the
// bases formed in the kernel
Plan plan_for(int B, int T, int hop, int H, bool scan, int sms) {
  Plan p;
  const long long row = (long long)T * hop;
  const long long chunks = B * ((row + CHUNK - 1) / CHUNK);
  const long long wave = (long long)BLOCKS_AN_SM * sms;
  long long cpb = (chunks + wave - 1) / wave;
  cpb = cpb < 1 ? 1 : (cpb > MAX_CHUNKS ? MAX_CHUNKS : cpb);
  if (cpb > hop) cpb = hop;  // at most CHUNK frames a block
  p.SB = (int)cpb * CHUNK;
  p.frames = p.SB / hop + 2;
  p.SW = H ? (CHUNK * H + 4 + 3) / 4 * 4 : 0;
  const int scanned = scan ? p.frames : 0, tiles = scan ? (T + TILE - 1) / TILE : 0;
  const int off_rot = 32;  // the ring's barriers first
  p.off_frames = off_rot + MAX_H * 8 + MAX_H * 4;
  p.off_loc = p.off_frames + p.frames * 16;
  p.off_tot = p.off_loc + scanned * 8;
  p.off_stage = bulk::round16(p.off_tot + tiles * 8);
  p.smem = plan_smem(p.frames, scanned, tiles, p.SW);
  return p;
}

// The frame-phase scan's inputs: item b's f0 row [T] and the mode's
// constants (nearest: sr and hop; linear: the coefficients' sums over sr,
// A0 / sr, A1 / sr, A2 / sr)
struct PhaseScan {
  const float* f;
  int T;
  float sr, hop;
  double A0, A1, A2;
};

__device__ __forceinline__ PhaseScan nearest_scan(const float* f0, int T, float sr,
                                                  int hop_shift) {
  return PhaseScan{f0 + (size_t)blockIdx.y * T, T, sr, (float)(1 << hop_shift), 0.0, 0.0, 0.0};
}

// psum [3, hop]: the coefficients' inclusive prefix sums, whose last
// entries are the sums; over sr as the samples' lanes take them (Lane), so
// that a frame advances by what its last sample's phase adds
__device__ __forceinline__ PhaseScan linear_scan(const float* f0, int T, const double* psum,
                                                 int hop, double inv_sr) {
  return PhaseScan{f0 + (size_t)blockIdx.y * T, T, 0.f, 0.f, __ldg(psum + hop - 1) * inv_sr,
                   __ldg(psum + 2 * hop - 1) * inv_sr, __ldg(psum + 3 * hop - 1) * inv_sr};
}

// One warp: tile t's frames k = 256 t + 8 lane + i (i < 8), from v = f[k -
// 1 .. k + 8] (clamped to the row). ex[i] is frame k's sum within the
// lane's run, *excl the lanes' before it, *total the tile's. Frames past T
// advance by 0.
template <bool LINEAR>
__device__ __forceinline__ void tile_scan(const PhaseScan& sc, int t, const float* v, double* ex,
                                          double* excl, double* total) {
  const int lane = threadIdx.x & 31;
  const int k = TILE * t + TILE_LANE * lane;
  double run = 0.0;
#pragma unroll
  for (int i = 0; i < TILE_LANE; ++i) {
    ex[i] = run;
    double a = 0.0;
    if (k + i < sc.T) {
      if (LINEAR)
        a = fma((double)v[i + 2], sc.A2, fma((double)v[i + 1], sc.A1, (double)v[i] * sc.A0));
      else
        a = (double)__fmul_rn(__fdiv_rn(v[i + 1], sc.sr), sc.hop);
      a -= floor(a);
    }
    run = __dadd_rn(run, a);
  }
  double inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = __dadd_rn(inc, o);
  }
  const double before = __shfl_up_sync(0xffffffffu, inc, 1);
  *excl = lane == 0 ? 0.0 : before;
  *total = __shfl_sync(0xffffffffu, inc, 31);
}

// The block's frames k0 .. k0 + nfr - 1 with the scan's bases: every warp
// scans tiles warp, warp + 8, ... up to the block's last frame's into
// shared memory (the tiles' sums, and each of the block's frames' within
// its tile), its lanes forming their frames' other values from the f0
// they hold, form(i, f[k-1], f[k], f[k+1]) for frame k0 + i; then a block
// barrier, then frame i's thread adds the tiles before its own in order
// and its own sum, into float `slot` of its float4. All of the block's
// threads call it; the caller's barrier publishes the frames.
template <bool LINEAR, class Form>
__device__ __forceinline__ void scan_frames(unsigned char* smem, const Plan& p,
                                            const PhaseScan& sc, int k0, int nfr, float4* fr,
                                            int slot, Form form) {
  double* tot = reinterpret_cast<double*>(smem + p.off_tot);
  double* loc = reinterpret_cast<double*>(smem + p.off_loc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = (k0 + nfr - 1) / TILE;
  for (int t = warp; t <= last; t += WARPS) {
    const int k = TILE * t + TILE_LANE * lane;
    float v[TILE_LANE + 2];
#pragma unroll
    for (int i = 0; i < TILE_LANE + 2; ++i) {
      int q = k - 1 + i;
      q = q < 0 ? 0 : (q > sc.T - 1 ? sc.T - 1 : q);
      v[i] = __ldg(sc.f + q);
    }
    double ex[TILE_LANE], excl, total;
    tile_scan<LINEAR>(sc, t, v, ex, &excl, &total);
    if (lane == 0) tot[t] = total;
#pragma unroll
    for (int i = 0; i < TILE_LANE; ++i) {
      const int at = k + i - k0;
      if (at >= 0 && at < nfr) {
        form(at, v[i], v[i + 1], v[i + 2]);
        loc[at] = __dadd_rn(excl, ex[i]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nfr; i += THREADS) {
    double x = 0.0;
    for (int t = 0; t < (k0 + i) / TILE; ++t) x = __dadd_rn(x, tot[t]);
    x = __dadd_rn(x, loc[i]);
    reinterpret_cast<float*>(fr + i)[slot] = (float)(x - floor(x));
  }
}

// A block's run of samples: s0 its first in the row, n how many
struct Run {
  long long s0;
  int n;
};

__device__ __forceinline__ Run run_of(const Plan& p, long long row) {
  const long long s0 = (long long)blockIdx.x * p.SB;
  return Run{s0, row - s0 < p.SB ? (int)(row - s0) : p.SB};
}

// A block's noise span, staged a chunk at a time into a ring of STAGES
// slots by TMA bulk copies (the unaligned edges by cp.async)
struct Ring {
  bulk::bar_t* full;
  float* stage;
  const float* src0;  // the block's first noise value
  long long s0;       // its first sample in the row
  int n, C, H, SW;

  // The thread that initialises the barriers and issues every copy: lane 0
  // of the last warp, which forms no start phase and no frame (but where a
  // block spans more than 224 frames, at hops of 16 and below, or the
  // scan reaches an eighth tile of 256 frames), so that
  // the first copies are in flight while the block forms them and the
  // block's barrier does not wait for the issue. Issued by thread 0 (which
  // forms both), the copies held the setup back; issued after the barrier,
  // they came a round trip late.
  static constexpr int ISSUER = THREADS - 32;

  // before the block barrier that publishes the barriers
  __device__ void start() const {
    for (int q = 0; q < STAGES; ++q) bulk::init(full + q, 2);  // the bytes, the edges
    bulk::fence_init();
    for (int c = 0; c < STAGES && c < C; ++c) issue(c);
  }
  __device__ void issue(int c) const {
    const float* src = src0 + (size_t)c * CHUNK * H;
    const int m = (n - c * CHUNK < CHUNK ? n - c * CHUNK : CHUNK) * H;
    float* dst = stage + (c % STAGES) * SW;
    bulk::bar_t* bar = full + c % STAGES;
    bulk::stage_edges(dst, src, m);
    bulk::expect(bar, bulk::stage_bytes(src, m));
    bulk::stage_middle(dst, src, m, bar);
    bulk::edges_landed(bar);
    bulk::landed(bar);
  }
};

__device__ Ring ring_for(unsigned char* smem, const Plan& p, const float* noise, long long row,
                         int H) {
  const Run run = run_of(p, row);
  Ring r;
  r.full = reinterpret_cast<bulk::bar_t*>(smem);
  r.stage = reinterpret_cast<float*>(smem + p.off_stage);
  r.s0 = run.s0;
  r.n = run.n;
  r.C = bulk::cdiv(r.n, CHUNK);
  r.src0 = noise + ((size_t)blockIdx.y * row + r.s0) * H;
  r.H = H;
  r.SW = p.SW;
  return r;
}

// Every sample of the block in chunk order: load(e) (issued before the
// chunk's wait, for reads outside the ring) then sample(e, its H noise
// values in the slot, what load returned); e is the sample's index in the
// block. After Ring::start and the block barrier that publishes it.
template <class Load, class Sample>
__device__ __forceinline__ void walk(const Ring& ring, Load load, Sample sample) {
  for (int c = 0; c < ring.C; ++c) {
    decltype(load(0)) held[CHUNK / THREADS];
#pragma unroll
    for (int r = 0; r < CHUNK / THREADS; ++r) {
      const int e = c * CHUNK + r * THREADS + (int)threadIdx.x;
      if (e < ring.n) held[r] = load(e);
    }
    bulk::wait(ring.full + c % STAGES, (c / STAGES) & 1);
    const float* st = ring.stage + (c % STAGES) * ring.SW +
                      bulk::lead(ring.src0 + (size_t)c * CHUNK * ring.H);
#pragma unroll
    for (int r = 0; r < CHUNK / THREADS; ++r) {
      const int i = r * THREADS + (int)threadIdx.x;
      const int e = c * CHUNK + i;
      if (e < ring.n) sample(e, st + i * ring.H, held[r]);
    }
    __syncthreads();  // the slot is read whole before it is refilled
    if (threadIdx.x == Ring::ISSUER && c + STAGES < ring.C) ring.issue(c + STAGES);
  }
}

// Every sample of a run without the ring: load(e) for two chunks' samples
// (four a thread in flight), then sample(e, what load returned)
template <class Load, class Sample>
__device__ __forceinline__ void walk_direct(const Run& run, Load load, Sample sample) {
  constexpr int PER = 2 * CHUNK / THREADS;
  for (int c = 0; c < run.n; c += 2 * CHUNK) {
    decltype(load(0)) held[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int e = c + r * THREADS + (int)threadIdx.x;
      if (e < run.n) held[r] = load(e);
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      const int e = c + r * THREADS + (int)threadIdx.x;
      if (e < run.n) sample(e, held[r]);
    }
  }
}

struct Nothing {};

// the start phases' rotations (cos, sin of 2 pi r_n) and the weights (when
// given), threads below H
__device__ __forceinline__ void head(unsigned char* smem, const float* rand_ini,
                                     const float* weight, int H) {
  const int tid = threadIdx.x;
  if (tid < H) {
    float sn, cs;
    sincospif(2.f * rand_ini[(size_t)blockIdx.y * H + tid], &sn, &cs);
    reinterpret_cast<float2*>(smem + 32)[tid] = make_float2(cs, sn);
    if (weight) reinterpret_cast<float*>(smem + 32 + MAX_H * 8)[tid] = weight[tid];
  }
}

// f(h, sin(2 pi ((h + 1) phase + r_h))) for h < H, from (s1, c1), the sine
// and cosine of 2 pi phase: each angle from the one before by a rotation by
// the first's, r_h by angle addition (unrolled, so that f may index
// registers by h)
template <class F>
__device__ __forceinline__ void harmonics(float s1, float c1, const float2* rot, int H, F f) {
  float sh = s1, ch = c1;
#pragma unroll
  for (int h = 0; h < MAX_H; ++h) {
    if (h == H) break;
    if (h > 0) {
      const float nc = ch * c1 - sh * s1;
      sh = sh * c1 + ch * s1;
      ch = nc;
    }
    const float2 ro = rot[h];
    f(h, sh * ro.x + ch * ro.y);
  }
}

// K3's frame of f0 f: rad, base (slot 1) and the gains (sine_amp where
// voiced, the noise's amplitude)
__device__ __forceinline__ float4 nsf_frame(float f, float base, float sr, float sine_amp,
                                            float noise_std) {
  const bool uv = f > 0.f;
  return make_float4(__fdiv_rn(f, sr), base, uv ? sine_amp : 0.f,
                     uv ? noise_std : sine_amp / 3.f);
}

// K3's frames k0 .. k0 + nfr - 1 of item b: given base [B, T], or from the
// nearest mode's scan
__device__ __forceinline__ void nsf_frames(unsigned char* smem, const Plan& p, float4* fr,
                                           const float* f0, const float* base, int T, int k0,
                                           int nfr, int hop_shift, float sr, float sine_amp,
                                           float noise_std) {
  if (!base) {
    scan_frames<false>(smem, p, nearest_scan(f0, T, sr, hop_shift), k0, nfr, fr, 1,
                       [&](int i, float, float f, float) {
                         fr[i] = nsf_frame(f, 0.f, sr, sine_amp, noise_std);
                       });
    return;
  }
  const size_t row = (size_t)blockIdx.y * T + k0;
  for (int i = threadIdx.x; i < nfr; i += THREADS)
    fr[i] = nsf_frame(f0[row + i], base[row + i], sr, sine_amp, noise_std);
}

// The linear modes' frames: f[k-1], f[k], f[k+1] (edges repeated) and base
// (slot 3), given base [B, T] or from the linear mode's scan
__device__ __forceinline__ void linear_frames(unsigned char* smem, const Plan& p, float4* fr,
                                              const float* f0, const float* base, int T, int k0,
                                              int nfr, const double* psum, int hop,
                                              double inv_sr) {
  if (!base) {
    scan_frames<true>(smem, p, linear_scan(f0, T, psum, hop, inv_sr), k0, nfr, fr, 3,
                      [&](int i, float fp, float f, float fn) {
                        fr[i] = make_float4(fp, f, fn, 0.f);
                      });
    return;
  }
  const float* f = f0 + (size_t)blockIdx.y * T;
  for (int i = threadIdx.x; i < nfr; i += THREADS) {
    const int k = k0 + i;
    fr[i] = make_float4(f[k > 0 ? k - 1 : 0], f[k], f[k < T - 1 ? k + 1 : T - 1],
                        base[(size_t)blockIdx.y * T + k]);
  }
}

// sine and cosine of 2 pi phase of lane j of a K3 frame q
__device__ __forceinline__ void nsf_angle(float4 q, int j, float* s1, float* c1) {
  float ph = __fadd_rn(q.y, __fmul_rn(q.x, (float)(j + 1)));
  ph -= floorf(ph);
  sincospif(2.f * ph, s1, c1);
}

__device__ __forceinline__ int frames_of(long long s0, int n, int hop_shift, int* k0) {
  *k0 = (int)(s0 >> hop_shift);
  return (int)((s0 + n - 1) >> hop_shift) - *k0 + 1;
}

__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) nsf_merge_kernel(
    const float* __restrict__ f0, const float* __restrict__ base,  // base: null to scan
    const float* __restrict__ rand_ini,  // [B, H]
    const float* __restrict__ noise,     // [B, T hop, H]
    const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ out,  // [B, T hop]
    int T, int hop_shift, int H, float sr, float sine_amp, float noise_std, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float2* rot = reinterpret_cast<const float2*>(smem + 32);
  const float* w = reinterpret_cast<const float*>(smem + 32 + MAX_H * 8);
  float4* fr = reinterpret_cast<float4*>(smem + p.off_frames);
  const long long row = (long long)T << hop_shift;
  const Ring ring = ring_for(smem, p, noise, row, H);
  int k0;
  const int nfr = frames_of(ring.s0, ring.n, hop_shift, &k0);
  if (threadIdx.x == Ring::ISSUER) ring.start();
  head(smem, rand_ini, weight, H);
  nsf_frames(smem, p, fr, f0, base, T, k0, nfr, hop_shift, sr, sine_amp, noise_std);
  __syncthreads();

  const float b0 = bias[0];
  float* ob = out + (size_t)blockIdx.y * row + ring.s0;
  walk(ring, [](int) { return Nothing{}; }, [&](int e, const float* nz, Nothing) {
    const long long s = ring.s0 + e;
    const float4 q = fr[(int)(s >> hop_shift) - k0];
    float s1, c1;
    nsf_angle(q, (int)(s & ((1 << hop_shift) - 1)), &s1, &c1);
    float acc = 0.f;
    harmonics(s1, c1, rot, H, [&](int h, float sine) {
      acc += (q.z * sine + q.w * nz[h]) * w[h];
    });
    ob[e] = tanhf(acc + b0);
  });
}

__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) nsf_merge_backward_kernel(
    const float* __restrict__ g, const float* __restrict__ out,  // [B, T hop]
    const float* __restrict__ f0, const float* __restrict__ base,
    const float* __restrict__ rand_ini, const float* __restrict__ noise,
    float* __restrict__ part,  // [H + 1][blocks]: dW's, then db's
    int T, int hop_shift, int H, float sr, float sine_amp, float noise_std, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float2* rot = reinterpret_cast<const float2*>(smem + 32);
  float4* fr = reinterpret_cast<float4*>(smem + p.off_frames);
  const long long row = (long long)T << hop_shift;
  const Ring ring = ring_for(smem, p, noise, row, H);
  int k0;
  const int nfr = frames_of(ring.s0, ring.n, hop_shift, &k0);
  if (threadIdx.x == Ring::ISSUER) ring.start();
  head(smem, rand_ini, nullptr, H);
  nsf_frames(smem, p, fr, f0, base, T, k0, nfr, hop_shift, sr, sine_amp, noise_std);
  __syncthreads();

  const size_t first = (size_t)blockIdx.y * row + ring.s0;
  float acc[MAX_H + 1];  // dW's sums, db's at MAX_H
#pragma unroll
  for (int h = 0; h <= MAX_H; ++h) acc[h] = 0.f;
  walk(
      ring,
      [&](int e) {
        const float o = out[first + e];
        return g[first + e] * (1.f - o * o);
      },
      [&](int e, const float* nz, float gz) {
        const long long s = ring.s0 + e;
        const float4 q = fr[(int)(s >> hop_shift) - k0];
        float s1, c1;
        nsf_angle(q, (int)(s & ((1 << hop_shift) - 1)), &s1, &c1);
        harmonics(s1, c1, rot, H, [&](int h, float sine) {
          acc[h] += gz * (q.z * sine + q.w * nz[h]);
        });
        acc[MAX_H] += gz;
      });

  // the block's sums in a fixed order: each warp's by a butterfly of
  // shuffles, then the warps' in order (the ring's slots are free now)
  float* red = ring.stage;  // [WARPS][MAX_H + 1]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int h = 0; h <= MAX_H; ++h) {
    if (h < H || h == MAX_H) {
      float v = acc[h];
      for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if (lane == 0) red[warp * (MAX_H + 1) + h] = v;
    }
  }
  __syncthreads();
  if ((int)threadIdx.x <= H) {
    const int h = (int)threadIdx.x < H ? (int)threadIdx.x : MAX_H;
    float v = 0.f;
    for (int q = 0; q < WARPS; ++q) v += red[q * (MAX_H + 1) + h];
    const int blocks = gridDim.x * gridDim.y;
    part[(size_t)threadIdx.x * blocks + blockIdx.y * gridDim.x + blockIdx.x] = v;
  }
}

// sums[o] = the blocks' partials of output o added in block order, a warp
// an output (lane l takes blocks l, l + 32, ...; then a fixed butterfly)
__global__ void __launch_bounds__(32 * (MAX_H + 1)) nsf_partials_sum_kernel(
    const float* __restrict__ part, float* __restrict__ sums, int blocks) {
  const int o = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.f;
  for (int i = lane; i < blocks; i += 32) v += part[(size_t)o * blocks + i];
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  if (lane == 0) sums[o] = v;
}

// The linear modes' interpolation lane j: its coefficients a[0..2][j] and
// their prefix sums over sr, P[0..2][j] / sr (float64)
struct Lane {
  float a0, a1, a2;
  double p0, p1, p2;
};

__device__ __forceinline__ Lane lane_of(const float* coef, const double* psum, int hop, int j,
                                        double inv_sr) {
  return Lane{__ldg(coef + j), __ldg(coef + hop + j), __ldg(coef + 2 * hop + j),
              __ldg(psum + j) * inv_sr, __ldg(psum + hop + j) * inv_sr,
              __ldg(psum + 2 * hop + j) * inv_sr};
}

// The interpolated f0 (float32, no FMA) and the phase mod 1 (float64) of a
// sample on lane l of the linear frame q (f[k-1], f[k], f[k+1], base)
__device__ __forceinline__ float linear_f0(float4 q, const Lane& l) {
  return __fadd_rn(__fadd_rn(__fmul_rn(q.x, l.a0), __fmul_rn(q.y, l.a1)), __fmul_rn(q.z, l.a2));
}

__device__ __forceinline__ double linear_phase(float4 q, const Lane& l) {
  double ph = fma((double)q.z, l.p2, fma((double)q.y, l.p1, fma((double)q.x, l.p0, (double)q.w)));
  return ph - floor(ph);
}

// FIXED: hop divides THREADS, so that a thread's samples all lie on its
// lane threadIdx.x mod hop (a block starts at a multiple of CHUNK), read
// once into registers; else each sample's lane is read with the chunk's
// other loads (from L1 after the block's first reads)
template <bool SIGNALS, bool FIXED>
__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) sine_merge_kernel(
    const float* __restrict__ f0, const float* __restrict__ base,  // base: null to scan
    const float* __restrict__ coef,   // [3, hop]
    const double* __restrict__ psum,  // [3, hop]
    const float* __restrict__ rand_ini, const float* __restrict__ noise,
    const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ out,      // [B, T hop]
    float* __restrict__ signals,  // [B, T hop, H] (SIGNALS)
    int T, int hop_shift, int H, double inv_sr, float sine_amp, float noise_std, float half_sr,
    Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float2* rot = reinterpret_cast<const float2*>(smem + 32);
  const float* w = reinterpret_cast<const float*>(smem + 32 + MAX_H * 8);
  float4* fr = reinterpret_cast<float4*>(smem + p.off_frames);  // f[k-1], f[k], f[k+1], base
  const int hop = 1 << hop_shift;
  const long long row = (long long)T << hop_shift;
  const Ring ring = ring_for(smem, p, noise, row, H);
  int k0;
  const int nfr = frames_of(ring.s0, ring.n, hop_shift, &k0);
  if (threadIdx.x == Ring::ISSUER) ring.start();
  head(smem, rand_ini, weight, H);
  linear_frames(smem, p, fr, f0, base, T, k0, nfr, psum, hop, inv_sr);
  // the lane after the frames: read before them, beside the scan's
  // registers, it made the kernel slower
  Lane mine{};
  if constexpr (FIXED) mine = lane_of(coef, psum, hop, (int)threadIdx.x & (hop - 1), inv_sr);
  __syncthreads();

  const float b0 = bias[0], quiet = sine_amp / 3.f;
  const size_t first = (size_t)blockIdx.y * row + ring.s0;
  walk(
      ring,
      [&](int e) {
        if constexpr (FIXED) return Nothing{};
        else return lane_of(coef, psum, hop, (int)((ring.s0 + e) & (hop - 1)), inv_sr);
      },
      [&](int e, const float* nz, const auto& held) {
        Lane l;
        if constexpr (FIXED) l = mine;
        else l = held;
        const long long s = ring.s0 + e;
        const float4 q = fr[(int)(s >> hop_shift) - k0];
        const float f0s = linear_f0(q, l);
        float s1, c1;
        sincospif(2.f * (float)linear_phase(q, l), &s1, &c1);
        const bool voiced = f0s > 0.f;
        const float amp = voiced ? noise_std : quiet;
        float acc = 0.f;
        harmonics(s1, c1, rot, H, [&](int h, float sine) {
          const bool heard = voiced && !(__fmul_rn(f0s, (float)(h + 1)) > half_sr);
          const float sig = __fadd_rn(heard ? __fmul_rn(sine, sine_amp) : 0.f,
                                      __fmul_rn(amp, nz[h]));
          if (SIGNALS) signals[(first + e) * H + h] = sig;
          acc += sig * w[h];
        });
        out[first + e] = tanhf(acc + b0);
      });
}

// K9 comb: the template of a sample on lane l of frame q, its noise nz
__device__ __forceinline__ float comb_sample(float4 q, const Lane& l, float nz, float sr,
                                             float wave_amp, float noise_std, float quiet) {
  const float f0s = linear_f0(q, l);
  const double ph = linear_phase(q, l);
  const float x = (float)(ph - rint(ph));
  const float z = __fdiv_rn(__fmul_rn(sr, x), __fadd_rn(f0s, 1e-3f));
  const float pz = __fmul_rn(3.14159265358979323846f, z);
  const float sinc = z == 0.f ? 1.f : __fdiv_rn(sinf(pz), pz);
  const bool voiced = f0s > 0.f;
  return __fadd_rn(voiced ? __fmul_rn(sinc, wave_amp) : 0.f,
                   __fmul_rn(voiced ? noise_std : quiet, nz));
}

// FIXED as sine_merge_kernel's; the noise read straight into registers
template <bool FIXED>
__global__ void __launch_bounds__(THREADS, BLOCKS_AN_SM) comb_merge_kernel(
    const float* __restrict__ f0, const float* __restrict__ base,  // base: null to scan
    const float* __restrict__ coef,   // [3, hop]
    const double* __restrict__ psum,  // [3, hop]
    const float* __restrict__ noise,  // [B, T hop]
    float* __restrict__ out,          // [B, T hop]
    int T, int hop_shift, float sr, double inv_sr, float wave_amp, float noise_std, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* fr = reinterpret_cast<float4*>(smem + p.off_frames);  // f[k-1], f[k], f[k+1], base
  const int hop = 1 << hop_shift;
  const long long row = (long long)T << hop_shift;
  const Run run = run_of(p, row);
  int k0;
  const int nfr = frames_of(run.s0, run.n, hop_shift, &k0);
  linear_frames(smem, p, fr, f0, base, T, k0, nfr, psum, hop, inv_sr);
  Lane mine{};
  if constexpr (FIXED) mine = lane_of(coef, psum, hop, (int)threadIdx.x & (hop - 1), inv_sr);
  __syncthreads();

  const float quiet = wave_amp / 3.f;
  const size_t first = (size_t)blockIdx.y * row + run.s0;
  auto lane_at = [&](int e) {
    if constexpr (FIXED) return mine;
    else return lane_of(coef, psum, hop, (int)((run.s0 + e) & (hop - 1)), inv_sr);
  };
  auto frame_at = [&](int e) { return fr[(int)((run.s0 + e) >> hop_shift) - k0]; };
  struct Held {
    Lane l;
    float nz;
  };
  walk_direct(
      run, [&](int e) { return Held{lane_at(e), __ldg(noise + first + e)}; },
      [&](int e, const Held& h) {
        out[first + e] = comb_sample(frame_at(e), h.l, h.nz, sr, wave_amp, noise_std, quiet);
      });
}

bool bad_sizes(int B, int T, int hop, int H) {
  return B < 1 || T < 1 || T > MAX_T || hop < 1 || (hop & (hop - 1)) || H < 1 || H > MAX_H;
}

int shift_of(int hop) {
  int shift = 0;
  while ((1 << shift) < hop) ++shift;
  return shift;
}

// shared memory above 48 KB needs the kernel's attribute: the most its
// plans take, set once a kernel
template <class K>
int allow_smem(K kernel, int bytes, bool* allowed) {
  if (*allowed) return 0;
  const int err =
      (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  *allowed = err == 0;
  return err;
}

}  // namespace

// f0 [B, T]; base [B, T], or null to form it by the nearest mode's scan;
// rand_ini [B, H] (column 0 is 0); noise [B, T hop, H]; weight [H]; bias
// [1]; out [B, T hop]; float32, contiguous (the Python wrapper checks). hop
// a power of two, 1 <= H <= 16, T at most 2^20. Returns the cudaError_t of
// the launch, or cudaErrorInvalidValue for a size the kernel does not take.
extern "C" int nsf_merge(const void* f0, const void* base, const void* rand_ini,
                         const void* noise, const void* weight, const void* bias, void* out,
                         int B, int T, int hop, int H, float sr, float sine_amp,
                         float noise_std, void* stream) {
  if (bad_sizes(B, T, hop, H)) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (const int err = allow_smem(nsf_merge_kernel, SMEM_MOST, &allowed)) return err;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, T, hop, H, base == nullptr, bulk::sm_count());
  const dim3 grid = dim3((unsigned)((row + p.SB - 1) / p.SB), B);
  nsf_merge_kernel<<<grid, THREADS, p.smem, (cudaStream_t)stream>>>(
      (const float*)f0, (const float*)base, (const float*)rand_ini, (const float*)noise,
      (const float*)weight, (const float*)bias, (float*)out, T, shift_of(hop), H, sr, sine_amp,
      noise_std, p);
  return (int)cudaGetLastError();
}

// K3's backward. g, out [B, T hop] (the merged source's gradient and the
// source); f0, base (or null), rand_ini, noise as nsf_merge's; partials:
// scratch of (H + 1) B ceil(T hop / 512) floats; sums [H + 1]: dW, then
// db. Two launches (the blocks' partial sums, then their sum in block
// order).
extern "C" int nsf_merge_backward(const void* g, const void* out, const void* f0,
                                  const void* base, const void* rand_ini, const void* noise,
                                  void* partials, void* sums, int B, int T, int hop, int H,
                                  float sr, float sine_amp, float noise_std, void* stream) {
  if (bad_sizes(B, T, hop, H)) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (const int err = allow_smem(nsf_merge_backward_kernel, SMEM_MOST, &allowed)) return err;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, T, hop, H, base == nullptr, bulk::sm_count());
  const dim3 grid = dim3((unsigned)((row + p.SB - 1) / p.SB), B);
  const cudaStream_t s = (cudaStream_t)stream;
  nsf_merge_backward_kernel<<<grid, THREADS, p.smem, s>>>(
      (const float*)g, (const float*)out, (const float*)f0, (const float*)base,
      (const float*)rand_ini, (const float*)noise, (float*)partials, T, shift_of(hop), H, sr,
      sine_amp, noise_std, p);
  if (const int err = (int)cudaGetLastError()) return err;
  nsf_partials_sum_kernel<<<1, 32 * (H + 1), 0, s>>>((const float*)partials, (float*)sums,
                                                     (int)(grid.x * grid.y));
  return (int)cudaGetLastError();
}

// K9 sine. f0 [B, T]; base [B, T], or null to form it by the linear mode's
// scan; coef [3, hop] float32 and psum [3, hop] float64 (the
// interpolation's coefficients and their prefix sums); rand_ini [B, H];
// noise [B, T hop, H]; weight [H]; bias [1]; out [B, T hop]; signals [B, T
// hop, H] or null (the template alone). half_sr is sr // 2. Sizes as
// nsf_merge's.
extern "C" int sine_merge(const void* f0, const void* base, const void* coef, const void* psum,
                          const void* rand_ini, const void* noise, const void* weight,
                          const void* bias, void* out, void* signals, int B, int T, int hop,
                          int H, float sr, float sine_amp, float noise_std, float half_sr,
                          void* stream) {
  if (bad_sizes(B, T, hop, H)) return (int)cudaErrorInvalidValue;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, T, hop, H, base == nullptr, bulk::sm_count());
  const dim3 grid = dim3((unsigned)((row + p.SB - 1) / p.SB), B);
  const bool fixed = THREADS % hop == 0;
  static bool allowed[4] = {false, false, false, false};
  auto launch = [&](auto kernel, bool* done) {
    if (const int err = allow_smem(kernel, SMEM_MOST, done)) return err;
    kernel<<<grid, THREADS, p.smem, (cudaStream_t)stream>>>(
        (const float*)f0, (const float*)base, (const float*)coef, (const double*)psum,
        (const float*)rand_ini, (const float*)noise, (const float*)weight, (const float*)bias,
        (float*)out, (float*)signals, T, shift_of(hop), H, 1.0 / (double)sr, sine_amp,
        noise_std, half_sr, p);
    return (int)cudaGetLastError();
  };
  if (signals)
    return fixed ? launch(sine_merge_kernel<true, true>, &allowed[0])
                 : launch(sine_merge_kernel<true, false>, &allowed[1]);
  return fixed ? launch(sine_merge_kernel<false, true>, &allowed[2])
               : launch(sine_merge_kernel<false, false>, &allowed[3]);
}

// K9 comb. f0 [B, T]; base [B, T], or null to form it by the linear mode's
// scan; coef, psum as sine_merge's; noise [B, T hop] standard normal; out
// [B, T hop]. Sizes as nsf_merge's.
extern "C" int comb_merge(const void* f0, const void* base, const void* coef, const void* psum,
                          const void* noise, void* out, int B, int T, int hop, float sr,
                          float wave_amp, float noise_std, void* stream) {
  if (bad_sizes(B, T, hop, 1)) return (int)cudaErrorInvalidValue;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, T, hop, 0, base == nullptr, bulk::sm_count());
  const dim3 grid = dim3((unsigned)((row + p.SB - 1) / p.SB), B);
  static bool allowed[2] = {false, false};
  auto launch = [&](auto kernel, bool* done) {
    if (const int err = allow_smem(kernel, SMEM_MOST, done)) return err;
    kernel<<<grid, THREADS, p.smem, (cudaStream_t)stream>>>(
        (const float*)f0, (const float*)base, (const float*)coef, (const double*)psum,
        (const float*)noise, (float*)out, T, shift_of(hop), sr, 1.0 / (double)sr, wave_amp,
        noise_std, p);
    return (int)cudaGetLastError();
  };
  return THREADS % hop == 0 ? launch(comb_merge_kernel<true>, &allowed[0])
                            : launch(comb_merge_kernel<false>, &allowed[1]);
}
