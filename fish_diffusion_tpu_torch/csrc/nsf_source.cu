// K3 nsf_merge: the NSF harmonic source's sines, voicing gate, noise and
// Dense(H -> 1) merge with tanh, from the frames' f0 and start phases.
//
// Replaces fish_diffusion_tpu/models/vocoders/source.py:92 BlockedSineGen
// with the merge (:92-169). For sample s = k hop + j of item b (frame k):
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
// Bound on an H100: bytes. The noise [B, T hop, H] is read once and the
// output [B, T hop] written once (~40 bytes a sample at H = 9). Design: a
// block owns a run of SB samples of one item (chunks of 512, SB chosen so
// that the grid is about one wave of four blocks an SM). Its noise span is
// contiguous: thread 0 stages it a chunk at a time into a ring of 3 slots
// in shared memory by TMA bulk copies (csrc/bulk_copy.cuh; the unaligned
// edges of a ragged last chunk by cp.async), so every noise byte crosses
// the bus once in whole sectors; a thread reads its sample's H values from
// its slot at a stride of H words (no bank conflicts for odd H). The
// harmonics cost one sincospif a sample: harmonic n's angle comes from
// harmonic n - 1's by a rotation by the first's, and the start phase r_n by
// angle addition with its sine and cosine, formed once a block (the error
// grows with n, to ~1e-6 at n = 9). The frames' rad, base and gains are
// formed once a block into shared memory. Stores are coalesced.

#include <cuda_runtime.h>
#include "bulk_copy.cuh"

namespace {

constexpr int THREADS = 256;
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

__global__ void __launch_bounds__(THREADS) nsf_merge_kernel(
    const float* __restrict__ f0, const float* __restrict__ base,
    const float* __restrict__ rand_ini,  // [B, H]
    const float* __restrict__ noise,     // [B, T hop, H]
    const float* __restrict__ weight, const float* __restrict__ bias,
    float* __restrict__ out,  // [B, T hop]
    int T, int hop_shift, int H, float sr, float sine_amp, float noise_std, Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bulk::bar_t* full = reinterpret_cast<bulk::bar_t*>(smem);
  float2* rot = reinterpret_cast<float2*>(smem + 32);    // cos, sin of 2 pi r_n
  float* w = reinterpret_cast<float*>(smem + 32 + MAX_H * 8);
  float4* fr = reinterpret_cast<float4*>(smem + p.off_frames);  // rad, base, gains
  float* stage = reinterpret_cast<float*>(smem + p.off_stage);
  const int b = blockIdx.y, tid = threadIdx.x;
  const long long row = (long long)T << hop_shift;
  const long long s0 = (long long)blockIdx.x * p.SB;
  const int n = row - s0 < p.SB ? (int)(row - s0) : p.SB;
  const int C = bulk::cdiv(n, CHUNK);
  const float* src0 = noise + ((size_t)b * row + s0) * H;
  const int k0 = (int)(s0 >> hop_shift);

  if (tid == 0) {
    for (int q = 0; q < STAGES; ++q) bulk::init(full + q, 2);  // the bytes, the edges
    bulk::fence_init();
  }
  if (tid < H) {
    float sn, cs;
    sincospif(2.f * rand_ini[(size_t)b * H + tid], &sn, &cs);
    rot[tid] = make_float2(cs, sn);
    w[tid] = weight[tid];
  }
  const int nfr = (int)((s0 + n - 1) >> hop_shift) - k0 + 1;
  for (int i = tid; i < nfr; i += THREADS) {
    const float f = f0[(size_t)b * T + k0 + i];
    const bool uv = f > 0.f;
    fr[i] = make_float4(__fdiv_rn(f, sr), base[(size_t)b * T + k0 + i], uv ? sine_amp : 0.f,
                        uv ? noise_std : sine_amp / 3.f);
  }
  __syncthreads();

  auto issue = [&](int c) {  // one thread
    const float* src = src0 + (size_t)c * CHUNK * H;
    const int m = (n - c * CHUNK < CHUNK ? n - c * CHUNK : CHUNK) * H;
    float* dst = stage + (c % STAGES) * p.SW;
    bulk::bar_t* bar = full + c % STAGES;
    bulk::stage_edges(dst, src, m);
    bulk::expect(bar, bulk::stage_bytes(src, m));
    bulk::stage_middle(dst, src, m, bar);
    bulk::edges_landed(bar);
    bulk::landed(bar);
  };
  if (tid == 0)
    for (int c = 0; c < STAGES && c < C; ++c) issue(c);

  const float b0 = bias[0];
  float* ob = out + (size_t)b * row + s0;
  for (int c = 0; c < C; ++c) {
    bulk::wait(full + c % STAGES, (c / STAGES) & 1);
    const float* st = stage + (c % STAGES) * p.SW + bulk::lead(src0 + (size_t)c * CHUNK * H);
#pragma unroll
    for (int r = 0; r < CHUNK / THREADS; ++r) {
      const int i = r * THREADS + tid;
      const int e = c * CHUNK + i;  // the sample's index in the block
      if (e < n) {
        const long long s = s0 + e;
        const int j = (int)(s & ((1 << hop_shift) - 1));
        const float4 q = fr[(int)(s >> hop_shift) - k0];
        float ph = __fadd_rn(q.y, __fmul_rn(q.x, (float)(j + 1)));
        ph -= floorf(ph);
        float s1, c1;
        sincospif(2.f * ph, &s1, &c1);
        float sh = s1, ch = c1, acc = 0.f;
        const float* nz = st + i * H;
        for (int h = 0; h < H; ++h) {
          const float2 ro = rot[h];
          const float sine = sh * ro.x + ch * ro.y;  // sin(2 pi ((h + 1) phase + r))
          acc += (q.z * sine + q.w * nz[h]) * w[h];
          const float nc = ch * c1 - sh * s1;
          sh = sh * c1 + ch * s1;
          ch = nc;
        }
        ob[e] = tanhf(acc + b0);
      }
    }
    __syncthreads();  // the slot is read whole before it is refilled
    if (tid == 0 && c + STAGES < C) issue(c + STAGES);
  }
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
  if (B < 1 || T < 1 || hop < 1 || (hop & (hop - 1)) || H < 1 || H > MAX_H)
    return (int)cudaErrorInvalidValue;
  // shared memory above 48 KB needs the kernel's attribute: the most a
  // plan takes, set once
  static bool allowed = false;
  if (!allowed) {
    const int err = (int)cudaFuncSetAttribute(
        nsf_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MOST);
    if (err != 0) return err;
    allowed = true;
  }
  int shift = 0;
  while ((1 << shift) < hop) ++shift;
  const long long row = (long long)T * hop;
  const Plan p = plan_for(B, row, hop, H, bulk::sm_count());
  const dim3 grid = dim3((unsigned)((row + p.SB - 1) / p.SB), B);
  nsf_merge_kernel<<<grid, THREADS, p.smem, (cudaStream_t)stream>>>(
      (const float*)f0, (const float*)base, (const float*)rand_ini, (const float*)noise,
      (const float*)weight, (const float*)bias, (float*)out, T, shift, H, sr, sine_amp,
      noise_std, p);
  return (int)cudaGetLastError();
}
