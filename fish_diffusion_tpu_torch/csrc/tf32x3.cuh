// 3xTF32: float32 matrix products on the tensor cores, for K1's backward
// (wavenet_block.cu: wavenet_weight_grad, wavenet_input_backward). Include
// after <cuda_runtime.h>.
//
// Replaces the float32 SIMT products that stood for XLA's derivative of
// fish_diffusion_tpu/models/wavenet.py:59 (ResidualBlock.__call__) and of
// models/common.py:103 (DilatedConvK3): the weight gradients and the
// dilated conv's input gradient.
//
// Each float32 operand x is split in registers into two TF32 values,
// big = rna(x) and small = rna(x - big) (rna: round to 10 mantissa bits,
// to nearest, ties away from zero), and a product a * b is taken as three
// tensor-core products (mma.sync.m16n8k8 TF32), small_a * big_b + big_a *
// small_b + big_a * big_b, in that order. small_a * small_b (2^-22 of |a
// b|) is dropped; each product is then within ~2^-21 of the float32 one,
// where one TF32 product alone (2^-11) fails a 1e-4-of-scale gate.
//
// Bound on an H100, both ways, for 2 M N K operations: the float32 SIMT
// units at 67 TFLOP/s give 2 M N K / 67e12 s; the tensor cores at the
// TF32 rate of 495 TFLOP/s (dense) take three products, 3 * 2 M N K /
// 495e12 s, 2.5x less. K1's backward products read each element of their
// operands hundreds of times (K = 3072 or B * T = 10240), so they are
// bound by operations either way.
//
// Why mma.sync.m16n8k8 and not wgmma: for TF32, wgmma reads both operands
// K-major from shared memory, and the weight gradient's operands are
// reduction-major (y, dz, g and do are [B * T, C] and the sum runs over
// the row index). mma.sync's fragments are loaded by each lane from shared
// memory in any layout, at a lower rate than wgmma's. wgmma with a
// transposing stage is later work.
//
// Two shared-memory layouts, one warp_stage each:
// - K-major (the input backward): A[m][k] and B[n][k], rows of LD floats
//   (LD = 4 mod 32). A fragment is one ldmatrix (a TF32 element is two
//   16-bit ones), conflict-free.
// - Reduction-major (the weight gradients): A[k][m] and B[k][n], rows of LD
//   floats (LD = 8 mod 32). ldmatrix cannot transpose 32-bit elements, so a
//   fragment is read with 8-byte loads: an m16 tile's rows are interleaved
//   (its row r at column 2 (r % 8) + r / 8) and so are each pair of n8
//   tiles' columns (tile t's column q at 2 q + t % 2), which puts the two
//   values a lane needs from one k row side by side; conflict-free. The
//   caller's epilogue undoes the interleave.
//
// The host build (the CPU tests' emulation) has no tensor-core or warp
// instructions: there a "fragment" holds what the lane's own accumulator
// elements need, read straight from the same shared-memory tile at the
// same places, split with the same rounding, and the three products are
// summed in the same order, so the emulation reaches the kernels' tiling,
// layouts, halos and epilogues.

#ifndef FDT_TF32X3_CUH
#define FDT_TF32X3_CUH

#include <cstdint>
#include <cstring>

namespace tf32x3 {
namespace {

// x rounded to TF32, to nearest with ties away from zero: the rounding of
// cvt.rna.tf32.f32 (the same bits for every finite x), in two integer
// instructions, where sm_90a lowers the cvt with a NaN guard besides; as a
// float whose low 13 bits are zero. The tensor cores read a TF32 operand's
// top 19 bits, so where the result only feeds them the compiler drops the
// mask.
__device__ __forceinline__ float round_tf32(float x) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  u = (u + 0x1000u) & 0xffffe000u;
  float r;
  memcpy(&r, &u, 4);
  return r;
#endif
}

// x = big + small + (what lies below small's 11 bits)
__device__ __forceinline__ void split(float x, float& big, float& small) {
  big = round_tf32(x);
  small = round_tf32(x - big);
}

// The A operand of one m16n8k8 product: 16 rows (m) x 8 of the reduction
// (k). On the card, the four elements this lane holds, rows g and g + 8 x
// k = c and c + 4 (g = lane / 4, c = lane % 4), split. On the host, the
// split rows g and g + 8 whole: what the lane's accumulators need.
struct FragA {
#if defined(__CUDA_ARCH__)
  uint32_t big[4], small[4];
#else
  float big[2][8], small[2][8];
#endif
};

// The B operand: 8 of the reduction (k) x 8 columns (n). On the card, k = c
// and c + 4 of column g; on the host, columns 2c and 2c + 1 whole.
struct FragB {
#if defined(__CUDA_ARCH__)
  uint32_t big[2], small[2];
#else
  float big[2][8], small[2][8];
#endif
};

#if defined(__CUDA_ARCH__)
template <int N>
__device__ __forceinline__ void split_all(const float* v, uint32_t* big, uint32_t* small) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float b, s;
    split(v[i], b, s);
    big[i] = __float_as_uint(b);
    small[i] = __float_as_uint(s);
  }
}

// Four 8 x 8 matrices of 16-bit elements, i.e. 8 rows x 4 floats each, from
// shared memory: lane l gives the address of row l % 8 of matrix l / 8 and
// receives, from matrix i, the float at row l / 4, column l % 4 of it.
__device__ __forceinline__ void ldmatrix_x4(float (&v)[4], const float* row) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(row));
  uint32_t r[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __uint_as_float(r[i]);
}

__device__ __forceinline__ void mma_tf32(float (&acc)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#endif

// K-major A: element (m, k) at p[m * LD + k]; one ldmatrix, whose matrices
// are rows 0-7 and 8-15 x k 0-3 and 4-7: the fragment's four registers.
template <int LD>
__device__ __forceinline__ void load_a_kmajor(FragA& f, const float* p, int lane) {
#if defined(__CUDA_ARCH__)
  float v[4];
  ldmatrix_x4(v, p + ((lane & 7) + (lane & 8)) * LD + (lane >> 4) * 4);
  split_all<4>(v, f.big, f.small);
#else
  const int g = lane >> 2;
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 8; ++k) split(p[(g + 8 * r) * LD + k], f.big[r][k], f.small[r][k]);
#endif
}

// K-major B, two adjacent n8 tiles: element (k, n) at p[n * LD + k]; one
// ldmatrix (columns 0-7 and 8-15 x k 0-3 and 4-7).
template <int LD>
__device__ __forceinline__ void load_b2_kmajor(FragB& f0, FragB& f1, const float* p, int lane) {
#if defined(__CUDA_ARCH__)
  float v[4];
  ldmatrix_x4(v, p + ((lane & 7) + (lane >> 4) * 8) * LD + (lane & 8) / 2);
  split_all<2>(v, f0.big, f0.small);
  split_all<2>(v + 2, f1.big, f1.small);
#else
  const int c = lane & 3;
  FragB* f[2] = {&f0, &f1};
  for (int t = 0; t < 2; ++t)
    for (int j = 0; j < 2; ++j)
      for (int k = 0; k < 8; ++k)
        split(p[(8 * t + 2 * c + j) * LD + k], f[t]->big[j][k], f[t]->small[j][k]);
#endif
}

// Reduction-major A: row r of the m16 tile, k at p[k * LD + 2 (r % 8) + r /
// 8]; two 8-byte loads (rows g and g + 8 side by side, at k = c and c + 4).
template <int LD>
__device__ __forceinline__ void load_a_rmajor(FragA& f, const float* p, int lane) {
  const int g = lane >> 2;
#if defined(__CUDA_ARCH__)
  const int c = lane & 3;
  const float2 lo = *reinterpret_cast<const float2*>(p + c * LD + 2 * g);
  const float2 hi = *reinterpret_cast<const float2*>(p + (c + 4) * LD + 2 * g);
  const float v[4] = {lo.x, lo.y, hi.x, hi.y};
  split_all<4>(v, f.big, f.small);
#else
  for (int r = 0; r < 2; ++r)
    for (int k = 0; k < 8; ++k) split(p[k * LD + 2 * g + r], f.big[r][k], f.small[r][k]);
#endif
}

// Reduction-major B, two adjacent n8 tiles: tile t's column q, k at p[k *
// LD + 2 q + t]; two 8-byte loads (column g of both tiles, at k = c and c
// + 4).
template <int LD>
__device__ __forceinline__ void load_b2_rmajor(FragB& f0, FragB& f1, const float* p, int lane) {
  const int c = lane & 3;
#if defined(__CUDA_ARCH__)
  const int g = lane >> 2;
  const float2 lo = *reinterpret_cast<const float2*>(p + c * LD + 2 * g);
  const float2 hi = *reinterpret_cast<const float2*>(p + (c + 4) * LD + 2 * g);
  const float v0[2] = {lo.x, hi.x}, v1[2] = {lo.y, hi.y};
  split_all<2>(v0, f0.big, f0.small);
  split_all<2>(v1, f1.big, f1.small);
#else
  FragB* f[2] = {&f0, &f1};
  for (int t = 0; t < 2; ++t)
    for (int j = 0; j < 2; ++j)
      for (int k = 0; k < 8; ++k)
        split(p[k * LD + 2 * (2 * c + j) + t], f[t]->big[j][k], f[t]->small[j][k]);
#endif
}

// acc += A B over one m16n8k8 step: the three TF32 products summed from
// zero on the tensor cores, then added to acc with a float32 add. acc[e]
// is row g + 8 (e / 2), column 2c + (e % 2) of the 16 x 8 tile. The
// tensor cores align and truncate each product's sum to the accumulator's
// magnitude (round toward zero), so a K-long sum kept there would drift by
// up to K / 8 x 3 truncations of its own size, one way; eight products'
// sum truncates at its own, far smaller, magnitude, and the float32 add
// rounds to nearest.
__device__ __forceinline__ void mma3(float (&acc)[4], const FragA& a, const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#if defined(__CUDA_ARCH__)
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
#else
  for (int e = 0; e < 4; ++e) {
    const int r = e >> 1, j = e & 1;
    for (int k = 0; k < 8; ++k) t[e] += a.small[r][k] * b.big[j][k];
    for (int k = 0; k < 8; ++k) t[e] += a.big[r][k] * b.small[j][k];
    for (int k = 0; k < 8; ++k) t[e] += a.big[r][k] * b.big[j][k];
  }
#endif
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += t[e];
}

// One BK-deep stage of a warp's (16 MI) x (8 NJ) tile, K-major: ``a`` at
// A's element (warp row 0, k 0), ``b`` at B's (k 0, warp column 0). The B
// fragments of a step are held while each A fragment meets them.
template <int MI, int NJ, int BK, int LD>
__device__ __forceinline__ void warp_stage_kmajor(float (&acc)[MI][NJ][4], const float* a,
                                                  const float* b, int lane) {
  static_assert(NJ % 2 == 0, "pairs of n8 tiles");
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    FragB fb[NJ];
#pragma unroll
    for (int j = 0; j < NJ; j += 2) load_b2_kmajor<LD>(fb[j], fb[j + 1], b + j * 8 * LD + kk, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      FragA fa;
      load_a_kmajor<LD>(fa, a + i * 16 * LD + kk, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma3(acc[i][j], fa, fb[j]);
    }
  }
}

// The same, reduction-major (rows and column pairs interleaved as above).
template <int MI, int NJ, int BK, int LD>
__device__ __forceinline__ void warp_stage_rmajor(float (&acc)[MI][NJ][4], const float* a,
                                                  const float* b, int lane) {
  static_assert(NJ % 2 == 0, "pairs of n8 tiles");
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    FragB fb[NJ];
#pragma unroll
    for (int j = 0; j < NJ; j += 2) load_b2_rmajor<LD>(fb[j], fb[j + 1], b + kk * LD + j * 8, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      FragA fa;
      load_a_rmajor<LD>(fa, a + kk * LD + i * 16, lane);
#pragma unroll
      for (int j = 0; j < NJ; ++j) mma3(acc[i][j], fa, fb[j]);
    }
  }
}

}  // namespace
}  // namespace tf32x3

#endif  // FDT_TF32X3_CUH
