// K3 and K9 sine: the harmonic sources' sines, voicing gate, noise and
// Dense(H -> 1) merge with tanh, from the frames' f0 and start phases, and
// the merge's weight gradient. Three kernels on one core:
//
// nsf_merge (K3; replaces fish_diffusion_tpu/models/vocoders/source.py:92
// BlockedSineGen with the merge, :92-169). For sample s = k hop + j of
// item b (frame k):
//
//   phase = frac(base[b, k] + rad (j + 1)),   rad = f0[b, k] / sr
//   s_n = sine_amp sin(2 pi frac(n phase + r_n)) uv + amp noise[b, s, n - 1]
//   out[b, s] = tanh(sum_{n = 1..H} w_{n - 1} s_n + bias)
//
// with r_n = rand_ini[b, n - 1] (r_1 = 0), uv = f0 > 0 and amp = noise_std
// where voiced, sine_amp / 3 where not; base is K3's first kernel's frame
// phase (models/vocoders/source.py nsf_phase_base). The phase is formed as
// the plain version forms it: rad by an IEEE division, then base + rad (j +
// 1) in float32, rounded at each step, less its floor.
//
// nsf_merge_backward (K3's backward; replaces what XLA derives for
// source.py:92): with gz = g (1 - out^2), dW[n] = sum gz s_n and db = sum
// gz over every sample, the s_n recomputed as nsf_merge forms them. Each
// block writes its H + 1 sums (each warp's by a fixed butterfly of
// shuffles, then the warps' in order) and a second kernel adds the blocks'
// in block order: no atomics, so a second launch gives the same bits.
//
// sine_merge (K9 sine; replaces nsf_hifigan.py:188 _mod1_phase_scan under
// refinegan.py:252 RefineSineGen): f0 linearly interpolated, sample j of
// frame k has, with the frame's neighbours (edges repeated) and the
// coefficient tables a [3, hop] (float32) and P [3, hop] (their inclusive
// prefix sums, float64):
//
//   f0s = (f[k-1] a0[j] + f[k] a1[j]) + f[k+1] a2[j]     (float32, no FMA)
//   phase = base[b, k] + (f[k-1] P0[j] + f[k] P1[j] + f[k+1] P2[j]) / sr
//
// in float64 (within a frame it reaches hop f0 / sr, ~128 near sr / 2,
// where float32's step would cost ~5e-5 of template), reduced mod 1 before
// the float32 sine; s_n's sine is 0 where f0s n > sr // 2, and voicing is
// f0s > 0. The division by sr is a multiplication by its float64
// reciprocal, as torch divides a CUDA tensor by a scalar, folded into the
// prefix sums when a lane is read: the phase is base + f[k-1] (P0[j] / sr)
// + f[k] (P1[j] / sr) + f[k+1] (P2[j] / sr) by three float64 FMAs a
// sample (it moves by ~1e-14 of a turn). The SIGNALS form also writes s
// [B, T hop, H], which the merge's analytic backward reads in training.
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
// a stride of H words (no bank conflicts for odd H). The harmonics cost
// one sincospif a sample: harmonic n's angle comes from harmonic n - 1's by
// a rotation by the first's, and the start phase r_n by angle addition
// with its sine and cosine, formed once a block (the error grows with n,
// to ~1e-6 at n = 9). The frames' values (rad, base and gains; or the
// neighbours' f0 and base) are formed once a block into shared memory,
// while the first copies are in flight. sine_merge reads the coefficient
// lanes into registers: where hop divides the block's 256 threads
// (RefineGAN's 256) each thread's samples lie on one lane, read once (the
// whole hop, ~9 KB, once a block); at larger hops each sample's lane is
// read with the chunk's other loads. (Lanes staged in shared memory and
// read there a sample at a time, six loads a sample, were slower.) g, out
// and the outputs are read and written coalesced, one sample a thread.

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

struct Plan {
  int SB;      // samples a block (whole chunks)
  int frames;  // the frames a block's samples span, at most
  int SW;      // floats a slot: CHUNK H and the lead, whole 16 bytes
  int off_frames, off_stage, smem;
};

// shared memory: the ring's barriers, the start phases' rotations [MAX_H]
// and the weights [MAX_H], the frames' values [frames], the ring
__host__ __device__ constexpr int plan_smem(int frames, int SW) {
  return (32 + MAX_H * 8 + MAX_H * 4 + frames * 16 + 15) / 16 * 16 + STAGES * SW * 4;
}
// the most a plan takes: CHUNK + 2 frames (a block spans at most CHUNK
// frames and the two it straddles) and MAX_H floats a sample
constexpr int SMEM_MOST = plan_smem(CHUNK + 2, (CHUNK * MAX_H + 4 + 3) / 4 * 4);

Plan plan_for(int B, long long row, int hop, int H, int sms) {
  Plan p;
  const long long chunks = B * ((row + CHUNK - 1) / CHUNK);
  const long long wave = (long long)BLOCKS_AN_SM * sms;
  long long cpb = (chunks + wave - 1) / wave;
  cpb = cpb < 1 ? 1 : (cpb > MAX_CHUNKS ? MAX_CHUNKS : cpb);
  if (cpb > hop) cpb = hop;  // at most CHUNK frames a block
  p.SB = (int)cpb * CHUNK;
  p.frames = p.SB / hop + 2;
  p.SW = (CHUNK * H + 4 + 3) / 4 * 4;
  const int off_rot = 32;  // the ring's barriers first
  p.off_frames = off_rot + MAX_H * 8 + MAX_H * 4;
  p.off_stage = bulk::round16(p.off_frames + p.frames * 16);
  p.smem = plan_smem(p.frames, p.SW);
  return p;
}

// A block's geometry and its noise span, staged a chunk at a time into a
// ring of STAGES slots by TMA bulk copies (the unaligned edges by cp.async)
struct Ring {
  bulk::bar_t* full;
  float* stage;
  const float* src0;  // the block's first noise value
  long long s0;       // its first sample in the row
  int n, C, H, SW;

  // The thread that initialises the barriers and issues every copy: lane 0
  // of the last warp, which forms no start phase and no frame (but where a
  // block spans more than 224 frames, at hops of 16 and below), so that
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
  Ring r;
  r.full = reinterpret_cast<bulk::bar_t*>(smem);
  r.stage = reinterpret_cast<float*>(smem + p.off_stage);
  r.s0 = (long long)blockIdx.x * p.SB;
  r.n = row - r.s0 < p.SB ? (int)(row - r.s0) : p.SB;
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

// K3's frames: rad, base and the gains (sine_amp where voiced, the noise's
// amplitude), frames k0 .. k0 + nfr - 1 of item b
__device__ __forceinline__ void nsf_frames(float4* fr, const float* f0, const float* base, int T,
                                           int k0, int nfr, float sr, float sine_amp,
                                           float noise_std) {
  const size_t b = blockIdx.y;
  for (int i = threadIdx.x; i < nfr; i += THREADS) {
    const float f = f0[b * T + k0 + i];
    const bool uv = f > 0.f;
    fr[i] = make_float4(__fdiv_rn(f, sr), base[b * T + k0 + i], uv ? sine_amp : 0.f,
                        uv ? noise_std : sine_amp / 3.f);
  }
}

// sine and cosine of 2 pi phase of lane j of a K3 frame q
__device__ __forceinline__ void nsf_angle(float4 q, int j, float* s1, float* c1) {
  float ph = __fadd_rn(q.y, __fmul_rn(q.x, (float)(j + 1)));
  ph -= floorf(ph);
  sincospif(2.f * ph, s1, c1);
}

__device__ __forceinline__ int frames_of(const Ring& ring, int hop_shift, int* k0) {
  *k0 = (int)(ring.s0 >> hop_shift);
  return (int)((ring.s0 + ring.n - 1) >> hop_shift) - *k0 + 1;
}

__global__ void __launch_bounds__(THREADS) nsf_merge_kernel(
    const float* __restrict__ f0, const float* __restrict__ base,
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
  const int nfr = frames_of(ring, hop_shift, &k0);
  if (threadIdx.x == Ring::ISSUER) ring.start();
  head(smem, rand_ini, weight, H);
  nsf_frames(fr, f0, base, T, k0, nfr, sr, sine_amp, noise_std);
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

__global__ void __launch_bounds__(THREADS) nsf_merge_backward_kernel(
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
  const int nfr = frames_of(ring, hop_shift, &k0);
  if (threadIdx.x == Ring::ISSUER) ring.start();
  head(smem, rand_ini, nullptr, H);
  nsf_frames(fr, f0, base, T, k0, nfr, sr, sine_amp, noise_std);
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

// sine_merge's interpolation lane j: its coefficients a[0..2][j] and
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

// FIXED: hop divides THREADS, so that a thread's samples all lie on its
// lane threadIdx.x mod hop (a block starts at a multiple of CHUNK), read
// once into registers; else each sample's lane is read with the chunk's
// other loads (from L1 after the block's first reads)
template <bool SIGNALS, bool FIXED>
__global__ void __launch_bounds__(THREADS) sine_merge_kernel(
    const float* __restrict__ f0, const float* __restrict__ base,
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
  const int nfr = frames_of(ring, hop_shift, &k0);
  if (threadIdx.x == Ring::ISSUER) ring.start();
  head(smem, rand_ini, weight, H);
  const float* f = f0 + (size_t)blockIdx.y * T;
  for (int i = threadIdx.x; i < nfr; i += THREADS) {
    const int k = k0 + i;
    fr[i] = make_float4(f[k > 0 ? k - 1 : 0], f[k], f[k < T - 1 ? k + 1 : T - 1],
                        base[(size_t)blockIdx.y * T + k]);
  }
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
        const float f0s = __fadd_rn(__fadd_rn(__fmul_rn(q.x, l.a0), __fmul_rn(q.y, l.a1)),
                                    __fmul_rn(q.z, l.a2));
        double ph = fma((double)q.z, l.p2, fma((double)q.y, l.p1, fma((double)q.x, l.p0,
                                                                          (double)q.w)));
        ph -= floor(ph);
        float s1, c1;
        sincospif(2.f * (float)ph, &s1, &c1);
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

bool bad_sizes(int B, int T, int hop, int H) {
  return B < 1 || T < 1 || hop < 1 || (hop & (hop - 1)) || H < 1 || H > MAX_H;
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

// f0, base [B, T]; rand_ini [B, H] (column 0 is 0); noise [B, T hop, H];
// weight [H]; bias [1]; out [B, T hop]; float32, contiguous (the Python
// wrapper checks). hop a power of two, 1 <= H <= 16. Returns the
// cudaError_t of the launch, or cudaErrorInvalidValue for a size the kernel
// does not take.
extern "C" int nsf_merge(const void* f0, const void* base, const void* rand_ini,
                         const void* noise, const void* weight, const void* bias, void* out,
                         int B, int T, int hop, int H, float sr, float sine_amp,
                         float noise_std, void* stream) {
  if (bad_sizes(B, T, hop, H)) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (const int err = allow_smem(nsf_merge_kernel, SMEM_MOST, &allowed)) return err;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, row, hop, H, bulk::sm_count());
  const dim3 grid = dim3((unsigned)((row + p.SB - 1) / p.SB), B);
  nsf_merge_kernel<<<grid, THREADS, p.smem, (cudaStream_t)stream>>>(
      (const float*)f0, (const float*)base, (const float*)rand_ini, (const float*)noise,
      (const float*)weight, (const float*)bias, (float*)out, T, shift_of(hop), H, sr, sine_amp,
      noise_std, p);
  return (int)cudaGetLastError();
}

// K3's backward. g, out [B, T hop] (the merged source's gradient and the
// source); f0, base, rand_ini, noise as nsf_merge's; partials: scratch of
// (H + 1) B ceil(T hop / 512) floats; sums [H + 1]: dW, then db. Two
// launches (the blocks' partial sums, then their sum in block order).
extern "C" int nsf_merge_backward(const void* g, const void* out, const void* f0,
                                  const void* base, const void* rand_ini, const void* noise,
                                  void* partials, void* sums, int B, int T, int hop, int H,
                                  float sr, float sine_amp, float noise_std, void* stream) {
  if (bad_sizes(B, T, hop, H)) return (int)cudaErrorInvalidValue;
  static bool allowed = false;
  if (const int err = allow_smem(nsf_merge_backward_kernel, SMEM_MOST, &allowed)) return err;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, row, hop, H, bulk::sm_count());
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

// K9 sine. f0, base [B, T] (base from nsf_phase_base's linear mode);
// coef [3, hop] float32 and psum [3, hop] float64 (the interpolation's
// coefficients and their prefix sums); rand_ini [B, H]; noise [B, T hop,
// H]; weight [H]; bias [1]; out [B, T hop]; signals [B, T hop, H] or null
// (the template alone). half_sr is sr // 2. Sizes as nsf_merge's.
extern "C" int sine_merge(const void* f0, const void* base, const void* coef, const void* psum,
                          const void* rand_ini, const void* noise, const void* weight,
                          const void* bias, void* out, void* signals, int B, int T, int hop,
                          int H, float sr, float sine_amp, float noise_std, float half_sr,
                          void* stream) {
  if (bad_sizes(B, T, hop, H)) return (int)cudaErrorInvalidValue;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, row, hop, H, bulk::sm_count());
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
