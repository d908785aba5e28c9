// The weight gradient of the port's 1-D convolutions: K4 (the NSF-HiFiGAN
// generator's direct and transposed convs) and K6 (the MSD's grouped convs).
//
// Replaces what XLA derives on the TPU for the weight of
// fish_diffusion_tpu/ops/blocked_conv.py:blocked_apply (K4) and
// blocked_apply_grouped (K6): the autodiff of their blocked GEMMs.
//
//   dW[k, i, j] = sum_{b, t < T_b} act_a(A[b, t * s + k * d - p, g * CA_g + i])
//                                * act_b(Bm[b, t, g * CB_g + j])
//
// for group g = j / CB_g, out [K, CA_g, CB] (the packed weight layout of
// K4 and K6), positions of A outside [0, T_a) read as 0. act is
// leaky-relu(slope) where its flag is set, else the identity. A direct
// conv's weight gradient takes A = its input x and Bm = the output's
// gradient dy; a transposed conv's takes A = dy (gathered with the conv's
// stride and padding) and Bm = x, which gives [K, C_out, C_in].
//
// Bound on an H100: arithmetic at the wide levels; at the narrow ones
// (C = 16, B * T = 524288 at the trunk's last level) the output is small
// (K * CA_g x CB_g, 176 x 16 for k = 11) and the reduction long, so one
// block per output tile would leave the card idle. Design: rows (k, i) and
// columns j tile the output as a GEMM with the (b, t) reduction as its
// depth; the reduction is cut into ``splits`` chunks, each chunk's block
// writes its partial tile, and a second kernel adds the partials in split
// order. Both passes are fixed by the shapes, so the result is the same
// on every run (no atomics). The A tile is gathered from x as it is
// loaded (no im2col buffer), the activation applied on the way.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;  // reduction rows per shared-memory stage

struct WgradArgs {
  int B, T_a, T_b, CA, CB, K, stride, dil, pad, groups;
  float slope_a, slope_b;
  int act_a, act_b;
  int splits, chunk;  // reduction rows per split: a multiple of BK
};

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// the output tile's width for CB_g columns per group
int tile_cols(int cb_g) {
  if (cb_g >= 64) return 64;
  if (cb_g >= 32) return 32;
  if (cb_g >= 16) return 16;
  return 1;
}

int tile_rows_for(int bn) { return bn == 64 ? 64 : bn == 1 ? 256 : 128; }

// Block tile BM rows (k, i) x BN columns j; each thread TM x TN.
template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(THREADS) wgrad_partial(
    const float* __restrict__ a, const float* __restrict__ bm,
    float* __restrict__ part, WgradArgs p) {
  constexpr int TX = BN / TN;
  static_assert((BM / TM) * TX == THREADS, "tile must use all threads");
  __shared__ __align__(16) float As[BK][BM];
  __shared__ __align__(16) float Bs[BK][BN];
  __shared__ int q_b[BK], q_t[BK];

  const int CA_g = p.CA / p.groups;
  const int CB_g = p.CB / p.groups;
  const int M = p.K * CA_g;
  const int R = p.B * p.T_b;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int r0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * BN;
  const int g = blockIdx.z % p.groups;
  const int split = blockIdx.z / p.groups;
  const int q_lo = split * p.chunk;
  const int q_hi = q_lo + p.chunk < R ? q_lo + p.chunk : R;

  // rows and columns a thread loads stay fixed over the stages (BM and BN
  // divide THREADS)
  const int a_row = tid % BM;
  const int a_r = r0 + a_row;
  const int a_k = a_r < M ? a_r / CA_g : 0;
  const int a_c = g * CA_g + (a_r < M ? a_r - a_k * CA_g : 0);
  const int a_off = a_k * p.dil - p.pad;
  const int b_col = tid % BN;
  const bool b_ok = j0 + b_col < CB_g;
  const int b_c = g * CB_g + j0 + b_col;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int q0 = q_lo; q0 < q_hi; q0 += BK) {
    if (tid < BK) {
      const int q = q0 + tid;
      const int b = q < q_hi ? q / p.T_b : -1;
      q_b[tid] = b;
      q_t[tid] = q < q_hi ? q - b * p.T_b : 0;
    }
    __syncthreads();
    for (int kk = tid / BM; kk < BK; kk += THREADS / BM) {
      float v = 0.f;
      const int b = q_b[kk];
      const int ta = q_t[kk] * p.stride + a_off;
      if (b >= 0 && a_r < M && ta >= 0 && ta < p.T_a) {
        v = a[((size_t)b * p.T_a + ta) * p.CA + a_c];
        if (p.act_a && v < 0.f) v *= p.slope_a;
      }
      As[kk][a_row] = v;
    }
    for (int kk = tid / BN; kk < BK; kk += THREADS / BN) {
      float v = 0.f;
      const int b = q_b[kk];
      if (b >= 0 && b_ok) {
        v = bm[((size_t)b * p.T_b + q_t[kk]) * p.CB + b_c];
        if (p.act_b && v < 0.f) v *= p.slope_b;
      }
      Bs[kk][b_col] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

  // part [splits, groups, M, CB_g]
  float* out = part + ((size_t)split * p.groups + g) * M * CB_g;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = r0 + ty * TM + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = j0 + tx * TN + j;
      if (col < CB_g) out[(size_t)r * CB_g + col] = acc[i][j];
    }
  }
}

// out[k, i, g * CB_g + j] = sum over splits, in order, of the partials
__global__ void __launch_bounds__(THREADS) wgrad_reduce(
    const float* __restrict__ part, float* __restrict__ out, WgradArgs p) {
  const int CA_g = p.CA / p.groups;
  const int CB_g = p.CB / p.groups;
  const size_t M = (size_t)p.K * CA_g;
  const size_t per_split = (size_t)p.groups * M * CB_g;
  const size_t idx = (size_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= per_split) return;
  float s = 0.f;
  for (int k = 0; k < p.splits; ++k) s += part[k * per_split + idx];
  const size_t col = idx % CB_g;
  const size_t r = (idx / CB_g) % M;
  const size_t g = idx / (CB_g * M);
  out[r * p.CB + g * CB_g + col] = s;
}

template <int BM, int BN, int TM, int TN>
int launch(const float* a, const float* bm, float* part, float* out,
           const WgradArgs& p, cudaStream_t stream) {
  const int M = p.K * (p.CA / p.groups);
  const int CB_g = p.CB / p.groups;
  dim3 grid((M + BM - 1) / BM, (CB_g + BN - 1) / BN, p.groups * p.splits);
  wgrad_partial<BM, BN, TM, TN><<<grid, THREADS, 0, stream>>>(a, bm, part, p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const size_t n = (size_t)p.groups * M * CB_g;
  wgrad_reduce<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                 stream>>>(part, out, p);
  return (int)cudaGetLastError();
}

}  // namespace

// The number of reduction chunks conv1d_wgrad cuts B * T_b rows into, for
// a [K * CA_g, CB_g] output per group: enough blocks for four per SM, with
// at least 8 stages of BK rows in each chunk. The wrapper sizes the
// partial-sum buffer [splits, groups, K * CA_g, CB_g] from it.
extern "C" int conv1d_wgrad_splits(int M, int CB_g, int groups, int R) {
  const int bn = tile_cols(CB_g);
  const int bm = tile_rows_for(bn);
  const long tiles = (long)((M + bm - 1) / bm) * ((CB_g + bn - 1) / bn) * groups;
  const long want = (4L * sm_count() + tiles - 1) / tiles;
  const long most = (R + 8 * BK - 1) / (8 * BK);
  const long s = want < most ? want : most;
  return (int)(s < 1 ? 1 : s);
}

// a [B, T_a, CA], bm [B, T_b, CB], part [splits, groups, K * CA / groups,
// CB / groups] (scratch), out [K, CA / groups, CB]; float32, contiguous
// (the Python wrapper checks). Returns the cudaError_t of the launches.
extern "C" int conv1d_wgrad(const void* a, const void* bm, void* part,
                            void* out, int B, int T_a, int T_b, int CA,
                            int CB, int K, int stride, int dil, int pad,
                            int groups, float slope_a, int act_a,
                            float slope_b, int act_b, int splits,
                            void* stream) {
  const int R = B * T_b;
  int chunk = (R + splits - 1) / splits;
  chunk = (chunk + BK - 1) / BK * BK;
  WgradArgs p{B,      T_a,     T_b,     CA,    CB,    K,      stride, dil,
              pad,    groups,  slope_a, slope_b, act_a, act_b, splits, chunk};
  const float* ap = (const float*)a;
  const float* bp = (const float*)bm;
  float* pp = (float*)part;
  float* op = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch (tile_cols(CB / groups)) {
    case 64:
      return launch<64, 64, 4, 4>(ap, bp, pp, op, p, s);
    case 32:
      return launch<128, 32, 4, 4>(ap, bp, pp, op, p, s);
    case 16:
      return launch<128, 16, 4, 2>(ap, bp, pp, op, p, s);
    default:
      return launch<256, 1, 1, 1>(ap, bp, pp, op, p, s);
  }
}
