// 3xTF32: float32 matrix products on the tensor cores, for K1's backward
// (wavenet_block.cu: wavenet_weight_grad, wavenet_input_backward: mma.sync;
// wavenet_gate_backward: wgmma) and its forward (wavenet_gate,
// wavenet_gate_train, wavenet_out: wgmma, the last part of this file).
// Include after <cuda_runtime.h>.
//
// Replaces the float32 SIMT products that stood for XLA's derivative of
// fish_diffusion_tpu/models/wavenet.py:59 (ResidualBlock.__call__) and of
// models/common.py:103 (DilatedConvK3): the weight gradients, the dilated
// conv's input gradient and the output product's (the gate backward's dg).
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

// ---------------------------------------------------------------------------
// wgmma (sm_90a): a warpgroup's (4 warps, 128 threads) 64 x N product of
// depth 8, the sum in registers; B read by the tensor cores from shared
// memory, A from the threads' registers (mma_rs: each warp's 16 rows as
// mma.sync's m16n8k8 A fragment, FragA, loaded and split by load_a, so
// each element is split once by the warp that owns its row). For TF32 both
// operands are K-major. The callers keep every tile in the 128-byte
// swizzled layout: row r's 32 floats (a stage's depth) in the 128 bytes at
// r * 128, its 16-byte chunk c (k = 4c .. 4c + 3) at chunk c ^ (r % 8),
// tiles 1024-byte aligned, so the 8 rows of a group read a k chunk from 8
// different bank groups (without the swizzle every row of a column of
// chunks falls on the same banks). The hardware applies the XOR to the
// address bits, so a k8 step starts 32 bytes after the previous one; 8-row
// groups are 1024 bytes apart (SBO). d[4 j + 2 h +
// e] of thread t is row 16 (t / 32 % 4) + (t % 32) / 4 + 8 h, column 8 j +
// 2 (t % 4) + e (the mma.sync m16n8 layout per warp and n8 tile).
//
// Split operands: each float32 element is split once into big and small
// (split above), and a 3xTF32 product is three wgmma into one sum, small_a
// big_b (scale_d 0: the sum starts from zero), big_a small_b, big_a big_b,
// in that order; the caller adds the sum to its float32 accumulator. The
// host build computes each thread's own elements of d from the same tiles
// at the same (swizzled) places, split the same way, in the same order
// (its FragA holds the whole rows g and g + 8 of the warp's 16).

namespace wg {

// The float offset of row r, 16-byte chunk c in a swizzled tile.
__host__ __device__ __forceinline__ int swizzled(int r, int c) {
  return r * 32 + ((c ^ (r & 7)) << 2);
}

// p rounded up to a multiple of 1024 bytes in the shared window (on the
// host: in the address space, whose bits host_at's XOR reads)
__device__ __forceinline__ float* align1024(float* p) {
#if defined(__CUDA_ARCH__)
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return p + ((1024 - (a & 1023)) & 1023) / 4;
#else
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return p + ((1024 - (a & 1023)) & 1023) / 4;
#endif
}

#if !defined(__CUDA_ARCH__)
// The host's read of element (row, k) of a k8 step that starts at p: the
// hardware's address and XOR (the tiles are 1024-byte aligned on the host
// too, align1024)
inline float host_at(const float* p, int row, int k) {
  uintptr_t addr = reinterpret_cast<uintptr_t>(p) + (row >> 3) * 1024 + (row & 7) * 128 +
                   (k >> 2) * 16;
  addr ^= ((addr >> 7) & 7) << 4;
  return reinterpret_cast<const float*>(addr)[k & 3];
}
#endif

#if defined(__CUDA_ARCH__)
// start address, LBO 16 bytes (unused by swizzled K-major layouts), SBO
// 1024 bytes, base offset 0, 128-byte swizzle
__device__ __forceinline__ uint64_t desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3ffff) >> 4) | (uint64_t)1 << 16 | (uint64_t)(1024 >> 4) << 32 |
         (uint64_t)1 << 62;
}

// A from registers: the four TF32 values of the thread's m16n8k8 fragment
template <int N>
__device__ __forceinline__ void mma_rs_async(float (&d)[N / 2], const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "n64 or n128");
  if constexpr (N == 128) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  } else {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
}
#endif

// The warp's A fragment of a k8 step from a swizzled tile of rows of 32
// floats: rows 16 w .. 16 w + 15 (w the warp of the warpgroup), 16-byte
// chunks 2 ks and 2 ks + 1, times ``scale`` (a float32 product, before the
// split; 1 leaves the elements as they are), split. On the card one
// ldmatrix (a TF32 element is two 16-bit ones; the four 8 x 8 matrices are
// rows 0-7 and 8-15 x the two chunks, the fragment's four registers),
// conflict-free on the swizzled rows.
__device__ __forceinline__ void load_a(FragA& f, const float* tile, int ks, int tid,
                                       float scale = 1.f) {
  const int w = (tid >> 5) & 3, lane = tid & 31;
#if defined(__CUDA_ARCH__)
  float v[4];
  ldmatrix_x4(v, tile + swizzled(16 * w + (lane & 7) + (lane & 8), 2 * ks + (lane >> 4)));
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] *= scale;
  split_all<4>(v, f.big, f.small);
#else
  const int g = lane >> 2;
  for (int h = 0; h < 2; ++h)
    for (int k = 0; k < 8; ++k)
      split(tile[swizzled(16 * w + g + 8 * h, 2 * ks + (k >> 2)) + (k & 3)] * scale,
            f.big[h][k], f.small[h][k]);
#endif
}

// d (scale_d 1) or 0 (scale_d 0) plus the product of A's big (or small)
// half in f with the swizzled B tile whose k8 step starts at b (N rows).
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const FragA& f, bool small,
                                       const float* b, int scale_d) {
#if defined(__CUDA_ARCH__)
  mma_rs_async<N>(d, small ? f.small : f.big, desc(b), scale_d);
#else
  const int t = threadIdx.x & 127, c = t & 3;
  for (int j = 0; j < N / 8; ++j)
    for (int h = 0; h < 2; ++h)
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * c + e;
        float s = scale_d ? d[4 * j + 2 * h + e] : 0.f;
        for (int k = 0; k < 8; ++k) s += (small ? f.small : f.big)[h][k] * host_at(b, col, k);
        d[4 * j + 2 * h + e] = s;
      }
#endif
}

// Order the warpgroup's register and shared-memory accesses before its
// next wgmma; commit the wgmma issued since the last commit as one group;
// wait until at most N groups are in flight.
__device__ __forceinline__ void fence() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
#endif
}

template <int N>
__device__ __forceinline__ void wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
#endif
}

// Keep the compiler from moving accesses of r across a wgmma issue or wait:
// the registers a wgmma in flight writes are not to be read before its
// group is waited for.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
#endif
}

// Keep a fragment's registers live until here: a wgmma in flight reads them
// (called after the wait for its group).
__device__ __forceinline__ void fence_frag(FragA& f) {
#if defined(__CUDA_ARCH__)
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(f.big[i]), "+r"(f.small[i])::"memory");
#endif
}

// Make this thread's generic-proxy writes to shared memory (stores and
// cp.async copies) visible to the tensor cores' reads (the async proxy);
// a barrier then publishes them to the warpgroups.
__device__ __forceinline__ void fence_shared() {
#if defined(__CUDA_ARCH__)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#endif
}

}  // namespace wg

}  // namespace
}  // namespace tf32x3

#endif  // FDT_TF32X3_CUH
