"""The CUDA sources of K1 (with its training mode, backward and weight gradients), K3's merge
(and its backward), K4 (and its weight gradient), K5 (forward,
backward and istft, its three plans), K6 (grouped and 2-D, with the 2-D weight gradient),
K7, K8-cand, K8 dense (pYIN's and CREPE's decoder), K9 comb and sine (K3's and K9's frame-phase
scan inside them) and K10 (with its backward), compiled for the host CPU and run against their
plain PyTorch versions at small shapes.

The card is the real test (``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py``),
but the kernels' tiling, halos, masks and epilogues are plain C++ over
``threadIdx``/``blockIdx``. A small shim makes them host code: ``__shared__``
arrays become function statics (blocks run one after another), each
block's threads run as ``std::thread``s meeting at a ``std::barrier`` for
``__syncthreads``, and ``kernel<<<grid, block, smem, stream>>>(...)``
becomes a call that runs the grid; a shared header (``csrc/*.cuh``) is
inlined, with the headers it includes. The shim covers what the sources use (no
tensor-core instructions; K10's backward's and K8 dense's warp shuffles run as
exchanges through the block's shared array between two barriers of the warp);
PTX sits behind ``#if defined(__CUDA_ARCH__)``
with a plain branch, so the weight gradient's ``cp.async`` copies run as
plain copies here, and K1's 3xTF32 products (``csrc/tf32x3.cuh``) as each
lane's own accumulator elements computed from the same shared-memory tiles
with the same TF32 rounding. A launch with a thread-block cluster
(``cudaLaunchKernelEx``, K8 dense) runs the cluster's blocks at once, each
with its own dynamic shared memory; ``cooperative_groups::this_cluster()``
gives the block's rank, ``map_shared_rank`` points into another block's
region and ``sync`` is a ``std::barrier`` over all of the cluster's
threads (K8 dense's host branch sends with plain stores and meets there at
the end of each frame, where the card uses ``st.async`` and mbarriers).
K8-cand's and K7's chains (``csrc/bulk_copy.cuh``) keep their protocol on
the host: an mbarrier is a word of shared memory updated with atomics (its
waits spin), a TMA bulk copy or a ``cp.async`` is a copy made at once, and
``__shfl_up_sync`` and ``__syncwarp`` run through the warp's barrier; their
sources, and K5 istft's, are built once more with less shared memory a
block (``-DSMEM_MAX``, ``SMALL_SMEM``), so that small cases reach the
streamed plans and istft's split path. Needs ``g++`` with C++20; skips
without one.
"""

import ctypes
import re
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from fish_diffusion_tpu_torch import kernels
from fish_diffusion_tpu_torch.extractors import pitch
from fish_diffusion_tpu_torch.models import convnext, wavenet
from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan
from fish_diffusion_tpu_torch.ops import blocked_conv, mel
from fish_diffusion_tpu_torch.ops import monotonic_align as ma
from tests.test_torch_kernels_cuda import (ALIGN_CASES, QUIET_CASES, align_case,
                                          align_wide_case, candidate_case, convnext_case,
                                          dense_case, istft_scale, quiet_case)

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <math.h>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct alignas(8) float2 { float x, y; };
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline int __float_as_int(float f) { int i; std::memcpy(&i, &f, 4); return i; }
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(16) double2 { double x, y; };
inline double2 make_double2(double x, double y) { return {x, y}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* g_barrier;
inline thread_local std::barrier<>* g_warp_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
// a warp shuffle as an exchange through the block's shared array between
// two barriers of the warp: every thread of the warp must call it, as K10's
// backward and K8 dense do (blocks of whole warps, the shuffles outside any
// branch)
inline thread_local uint32_t* g_shuffle;
template <class T> inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles");
  const unsigned t = threadIdx.x;
  std::memcpy(&g_shuffle[t], &v, 4);
  g_warp_barrier->arrive_and_wait();
  T r;
  std::memcpy(&r, &g_shuffle[(t & ~31u) | ((t & 31u) ^ (unsigned)lane_mask)], 4);
  g_warp_barrier->arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_sync(unsigned, T v, int src_lane) {
  static_assert(sizeof(T) == 4, "32-bit shuffles");
  const unsigned t = threadIdx.x;
  std::memcpy(&g_shuffle[t], &v, 4);
  g_warp_barrier->arrive_and_wait();
  T r;
  std::memcpy(&r, &g_shuffle[(t & ~31u) | ((unsigned)src_lane & 31u)], 4);
  g_warp_barrier->arrive_and_wait();
  return r;
}
template <class T> inline T __shfl_up_sync(unsigned, T v, unsigned delta) {
  static_assert(sizeof(T) == 4, "32-bit shuffles");
  const unsigned t = threadIdx.x;
  std::memcpy(&g_shuffle[t], &v, 4);
  g_warp_barrier->arrive_and_wait();
  T r;
  std::memcpy(&r, &g_shuffle[(t & 31u) >= delta ? t - delta : t], 4);
  g_warp_barrier->arrive_and_wait();
  return r;
}
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_barrier->arrive_and_wait(); }
// a double's shuffle as two of its 32-bit halves
inline double shuffle_halves(double v, uint32_t (*half)(uint32_t)) {
  uint64_t u;
  std::memcpy(&u, &v, 8);
  u = (uint64_t)half((uint32_t)(u >> 32)) << 32 | half((uint32_t)u);
  std::memcpy(&v, &u, 8);
  return v;
}
inline thread_local unsigned g_shuffle_arg;
inline double __shfl_up_sync(unsigned m, double v, unsigned delta) {
  g_shuffle_arg = delta;
  return shuffle_halves(v, [](uint32_t h) {
    return __shfl_up_sync(0xffffffffu, h, g_shuffle_arg);
  });
}
inline double __shfl_sync(unsigned m, double v, int src_lane) {
  g_shuffle_arg = (unsigned)src_lane;
  return shuffle_halves(v, [](uint32_t h) {
    return __shfl_sync(0xffffffffu, h, (int)g_shuffle_arg);
  });
}
// round-to-nearest arithmetic that nvcc never contracts into an FMA (g++
// in ISO C++ mode does not contract either)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __ddiv_rn(double a, double b) { return a / b; }
template <class T> inline T __ldg(const T* p) { return *p; }
// sin and cos of pi x (the card's is exact to a few ulps; this rounds the
// double result)
inline void sincospif(float x, float* s, float* c) {
  const double a = 3.14159265358979323846 * (double)x;
  *s = (float)std::sin(a);
  *c = (float)std::cos(a);
}
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaErrorLaunchOutOfResources = 701 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize,
                         cudaFuncAttributeNonPortableClusterSizeAllowed };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// 8 SMs: small grids then reach every tile shape K1 chooses from
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 8; return 0; }
template <class T> int cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
// two blocks per SM, whatever the kernel: with 8 SMs a plan then splits a
// small reduction into a few chunks
template <class T> int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T, int, size_t) {
  *n = 2;
  return 0;
}
struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.v << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
// dynamic shared memory: one region of 256 KB a block of a cluster
constexpr size_t SMEM_REGION = 256 * 1024;
inline std::vector<float> g_dynamic_smem(16 * SMEM_REGION / sizeof(float));
inline thread_local char* g_smem_base;
// a thread-block cluster: its blocks run at once, each with its own
// dynamic shared memory; the cluster barrier is one std::barrier over all
// of their threads, and map_shared_rank points into another block's region
inline thread_local unsigned g_cluster_rank;
inline thread_local std::barrier<>* g_cluster_barrier;
namespace cooperative_groups {
struct cluster_group {
  unsigned block_rank() const { return g_cluster_rank; }
  void sync() const { g_cluster_barrier->arrive_and_wait(); }
  template <class T> T* map_shared_rank(T* p, unsigned rank) const {
    return reinterpret_cast<T*>(reinterpret_cast<char*>(p) +
                                ((long)rank - (long)g_cluster_rank) * (long)SMEM_REGION);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
// One host thread per CUDA thread of a cluster's blocks (a block is a
// cluster of one); they walk the grid's clusters in order and meet at the
// cluster barrier after each, so the statics that stand for shared memory
// serve one block at a time where clusters are of one block.
template <class F> void run_clusters(dim3 grid, dim3 block, size_t smem, unsigned C, F body) {
  if (smem > 232448 || C > 16 || grid.x % C) throw 1;
  const unsigned n = block.x * block.y * block.z;
  std::barrier<> cluster(C * n);
  std::vector<std::unique_ptr<std::barrier<>>> blocks, warps;
  for (unsigned r = 0; r < C; ++r) {
    blocks.push_back(std::make_unique<std::barrier<>>(n));
    for (unsigned w = 0; w < n; w += 32)
      warps.push_back(std::make_unique<std::barrier<>>(n - w < 32 ? n - w : 32));
  }
  const unsigned warps_a_block = (n + 31) / 32;
  std::vector<uint32_t> shuffle(C * n);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < C * n; ++t)
    threads.emplace_back([&, t] {
      const unsigned r = t / n, tid = t % n;
      threadIdx = dim3(tid);
      blockDim = block;
      gridDim = grid;
      g_barrier = blocks[r].get();
      g_warp_barrier = warps[r * warps_a_block + tid / 32].get();
      g_shuffle = shuffle.data() + r * n;
      g_smem_base = reinterpret_cast<char*>(g_dynamic_smem.data()) + r * SMEM_REGION;
      g_cluster_rank = r;
      g_cluster_barrier = &cluster;
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; x += C) {
            blockIdx = dim3(x + r, y, z);
            body();
            cluster.arrive_and_wait();
          }
    });
  for (auto& th : threads) th.join();
}
template <class F> void run_grid(dim3 grid, dim3 block, size_t smem, F body) {
  run_clusters(grid, block, smem, 1, body);
}
// cudaLaunchKernelEx with a cluster dimension: the shim's GPC holds 16
// SMs, one block an SM
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline unsigned cluster_of(const cudaLaunchConfig_t* cfg) {
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension)
      return cfg->attrs[a].val.clusterDim.x;
  return 1;
}
template <class T> int cudaOccupancyMaxActiveClusters(int* n, T, const cudaLaunchConfig_t* cfg) {
  *n = 16 / cluster_of(cfg);
  return 0;
}
template <class... P, class... A>
int cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...), A&&... args) {
  run_clusters(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes, cluster_of(cfg),
               [&] { kernel(args...); });
  return 0;
}
"""

# a shared header, ``#include "name.cuh"``, inlined before the rewrites
_HEADER = re.compile(r'#include "(\w+\.cuh)"')
_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)
# dynamic shared memory, ``extern __shared__ [__align__(n)] T name[];``
_EXTERN_SHARED = re.compile(r"extern __shared__ (?:__align__\(\d+\) )?(\w+(?: \w+)?) (\w+)\[\];")


def _host_source(cu: str) -> str:
    src = cu
    while _HEADER.search(src):  # headers include headers; each has a guard
        src = _HEADER.sub(lambda m: (kernels.CSRC / m.group(1)).read_text(), src)
    src = src.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src = src.replace("#include <cuda_bf16.h>", "")
    src = src.replace("#include <cooperative_groups.h>", "")
    src = _EXTERN_SHARED.sub(
        lambda m: f"{m.group(1)}* {m.group(2)} = "
                  f"reinterpret_cast<{m.group(1)}*>(g_smem_base);", src)

    def launch(m):
        grid, block, smem = (p.strip() for p in m.group(2).split(",")[:3])
        return (f"run_grid(dim3({grid}), dim3({block}), {smem}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    return _LAUNCH.sub(launch, src)


# sources built once more with less shared memory a block (``-DSMEM_MAX``),
# so that small cases reach their streamed plans (istft: its split path):
# ``host_libs["name@bytes"]``
SMALL_SMEM = [("viterbi", 64000), ("viterbi", 85400), ("monotonic_align", 83000),
              ("istft", 4096)]


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("csrc")
    (out / "shim.h").write_text(SHIM)

    def build(name, smem=0):  # one g++ a library, four at a time
        key = f"{name}@{smem}" if smem else name
        cpp = out / f"{name}.cpp"
        so = out / f"lib{key}.so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        f"-I{out}", *([f"-DSMEM_MAX={smem}"] if smem else []),
                        "-o", str(so), str(cpp)], check=True, capture_output=True, timeout=600)
        return key, name, so

    for name in kernels.SIGNATURES:
        (out / f"{name}.cpp").write_text(
            _host_source((kernels.CSRC / f"{name}.cu").read_text()))
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda job: build(*job),
                              [(name,) for name in kernels.SIGNATURES] + SMALL_SMEM))
    libs = {}
    for key, name, so in built:
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in kernels.SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    return libs


def rn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


def _split_ptrs(dtype, *ws):
    """The float32 kernels' split weights (kept alive by the caller) and their
    pointers; None for bfloat16, whose kernel reads the weights."""
    if dtype != torch.float32:
        return [None] * len(ws), [None] * len(ws)
    splits = [wavenet.tf32_split(w) for w in ws]
    return splits, [t.data_ptr() for t in splits]


@pytest.mark.parametrize(
    "B,T,R,d,dtype",
    # with 8 SMs the rule from M = B*T and R picks the float32 plan: 64 x
    # 64 tiles (M=300 or 51 at R=64), 128 x 128 over two warpgroups (M=600
    # at R=64, M=300 at R=256); bfloat16 takes the SIMT tile
    [
        (2, 150, 64, 1, torch.float32),
        (2, 150, 64, 1, torch.bfloat16),
        (1, 300, 256, 8, torch.float32),
        (3, 17, 64, 4, torch.float32),
        (2, 300, 64, 2, torch.float32),
    ],
)
def test_wavenet_block_source(host_libs, B, T, R, d, dtype):
    """K1: f32 <= 1e-4; bf16 within a few bf16 ulps of the plain bf16
    version (the kernel keeps z and g in float32)."""
    gen = torch.Generator().manual_seed(B * T + d)
    a = [rn(gen, B, T, R), rn(gen, B, T, R), rn(gen, B, R), rn(gen, B, T, 2 * R),
         rn(gen, 3 * R, 2 * R, scale=(3 * R) ** -0.5), rn(gen, 2 * R, scale=0.1),
         rn(gen, R, 2 * R, scale=R ** -0.5), rn(gen, 2 * R, scale=0.1)]
    x, skip, step, cond, w_conv, b_conv, w_out, b_out = (t.to(dtype) for t in a)
    code = kernels.dtype_code(x)
    lib = host_libs["wavenet_block"]
    _, (cs, os_) = _split_ptrs(dtype, w_conv, w_out)
    taps = torch.empty(B, 3, 2 * R)
    g, x_out, skip_out = (torch.empty_like(x) for _ in range(3))
    assert lib.wavenet_gate(code, x.data_ptr(), step.data_ptr(), w_conv.data_ptr(), cs,
                            taps.data_ptr(), b_conv.data_ptr(), cond.data_ptr(), g.data_ptr(),
                            B, T, R, R, d, None) == 0
    assert lib.wavenet_out(code, g.data_ptr(), w_out.data_ptr(), os_, b_out.data_ptr(),
                           x.data_ptr(), skip.data_ptr(), x_out.data_ptr(),
                           skip_out.data_ptr(), B, T, R, None) == 0
    ref_x, ref_skip = wavenet.residual_block_reference(
        x, skip, step, cond, w_conv, b_conv, w_out, b_out, d
    )
    tol = 1e-4 if dtype == torch.float32 else 0.125
    for got, ref in ((x_out, ref_x), (skip_out, ref_skip)):
        assert (got.float() - ref.float()).abs().max().item() <= tol


def _k1_training(gen, B, T, R):
    """Inputs of one block of K1 with its gradient, float32."""
    return dict(x=rn(gen, B, T, R), step=rn(gen, B, R), cond=rn(gen, B, T, 2 * R),
                w_conv=rn(gen, 3 * R, 2 * R, scale=(3 * R) ** -0.5),
                b_conv=rn(gen, 2 * R, scale=0.1), w_out=rn(gen, R, 2 * R, scale=R ** -0.5),
                dx_out=rn(gen, B, T, R), dskip_out=rn(gen, B, T, R))


@pytest.mark.parametrize(
    "B,T,R,d",
    # with 8 SMs: the gate backward's 128 x 128 tiles (R=128, B*T rows for
    # one wave of one block an SM), 64 x 64 (R=64, or few rows); T <= 2d
    # (the halo is all zeros) and a ragged last tile
    [
        (2, 300, 128, 1),
        (2, 150, 64, 2),
        (1, 40, 64, 8),
        (3, 13, 64, 4),
        (1, 7, 64, 4),
        # the input backward's 128-row tiles: a ragged last tile of each
        # item at R = 128 (one column tile), and d >= T
        (2, 131, 128, 2),
        (2, 20, 64, 32),
    ],
)
def test_wavenet_training_source(host_libs, B, T, R, d):
    """K1's training mode (g and z), gate backward (dz) and input backward
    (dx, and ds from the tiles' column sums) against their plain versions:
    <= 1e-4 of each output's scale, float32."""
    gen = torch.Generator().manual_seed(B * T + R + d)
    a = _k1_training(gen, B, T, R)
    lib = host_libs["wavenet_block"]
    g, z = torch.empty(B, T, R), torch.empty(B, T, 2 * R)
    w_split, taps = wavenet.tf32_split(a["w_conv"]), torch.empty(B, 3, 2 * R)
    assert lib.wavenet_gate_train(a["x"].data_ptr(), a["step"].data_ptr(),
                                  a["w_conv"].data_ptr(), w_split.data_ptr(), taps.data_ptr(),
                                  a["b_conv"].data_ptr(), a["cond"].data_ptr(), g.data_ptr(),
                                  z.data_ptr(), B, T, R, d, None) == 0
    ref_g, ref_z = wavenet.residual_gate_train_reference(
        a["x"], a["step"], a["cond"], a["w_conv"], a["b_conv"], d)
    dz = torch.empty(B, T, 2 * R)
    out_split = wavenet.tf32_split(a["w_out"].t())
    assert lib.wavenet_gate_backward(a["dx_out"].data_ptr(), a["dskip_out"].data_ptr(),
                                     out_split.data_ptr(), ref_z.data_ptr(), dz.data_ptr(),
                                     B, T, R, None) == 0
    ref_dz = wavenet.residual_gate_backward_reference(a["dx_out"], a["dskip_out"], ref_z,
                                                      a["w_out"])
    rows = lib.wavenet_backward_rows(B, T, R)
    dx, part = torch.empty(B, T, R), torch.full((B, -(-T // rows), R), float("nan"))
    assert lib.wavenet_input_backward(ref_dz.data_ptr(), a["dx_out"].data_ptr(),
                                      a["w_conv"].data_ptr(), dx.data_ptr(),
                                      part.data_ptr(), B, T, R, d, None) == 0
    ref_dx, ref_ds = wavenet.residual_input_backward_reference(ref_dz, a["dx_out"],
                                                               a["w_conv"], d)
    for name, got, ref in (("g", g, ref_g), ("z", z, ref_z), ("dz", dz, ref_dz),
                           ("dx", dx, ref_dx), ("ds", part.sum(1), ref_ds)):
        err = (got - ref).abs().max().item()
        assert err <= 1e-4 * ref.abs().max().item(), (name, err)


@pytest.mark.parametrize(
    "B,T,R,d,plan",
    # each plan the rule picks from M with the shim's 8 SMs (1 = 64 x 64
    # tiles, 2 = 128 x 128 over two warpgroups), each at: a ragged M whose
    # tiles cross items, T < d and T < the tile (the halo all zeros), R =
    # 128 (several tiles of columns, pairs j0 > 0)
    [(3, 37, 64, 1, 1), (3, 137, 64, 1, 2), (1, 7, 64, 4, 1), (2, 5, 64, 8, 1),
     (40, 5, 128, 8, 2), (1, 70, 128, 4, 1), (1, 200, 128, 4, 2)],
)
def test_wavenet_forward_plans_source(host_libs, B, T, R, d, plan):
    """K1's forward in each plan the rule picks from M (``k1f::plan_for``):
    the gate (serving), its training instance (g and z) and the output
    product (x', skip', the residual and skip columns paired in a thread)
    against their plain versions, <= 1e-5 of each output's scale; serving's
    g and the training instance's equal bit for bit, and a rerun too."""
    gen = torch.Generator().manual_seed(B * T + R + d + plan)
    a = _k1_training(gen, B, T, R)
    skip, b_out = rn(gen, B, T, R), rn(gen, 2 * R, scale=0.1)
    lib = host_libs["wavenet_block"]
    assert lib.wavenet_forward_plan(B, T, R) == plan
    cs, os_ = wavenet.tf32_split(a["w_conv"]), wavenet.tf32_split(a["w_out"])
    taps = torch.full((B, 3, 2 * R), float("nan"))
    gate = (a["x"].data_ptr(), a["step"].data_ptr(), a["w_conv"].data_ptr(), cs.data_ptr(),
            taps.data_ptr(), a["b_conv"].data_ptr(), a["cond"].data_ptr())
    g, z, g_serve, g_again = (torch.full((B, T, c * R), float("nan")) for c in (1, 2, 1, 1))
    assert lib.wavenet_gate_train(*gate, g.data_ptr(), z.data_ptr(), B, T, R, d, None) == 0
    for out in (g_serve, g_again):
        assert lib.wavenet_gate(0, *gate, out.data_ptr(), B, T, R, R, d, None) == 0
    ref_g, ref_z = wavenet.residual_gate_train_reference(
        a["x"], a["step"], a["cond"], a["w_conv"], a["b_conv"], d)
    x_out, skip_out = torch.full((B, T, R), float("nan")), torch.full((B, T, R), float("nan"))
    assert lib.wavenet_out(0, ref_g.data_ptr(), a["w_out"].data_ptr(), os_.data_ptr(),
                           b_out.data_ptr(), a["x"].data_ptr(), skip.data_ptr(),
                           x_out.data_ptr(), skip_out.data_ptr(), B, T, R, None) == 0
    ref_x, ref_skip = wavenet.residual_out_reference(ref_g, a["x"], skip, a["w_out"], b_out)
    for name, got, ref in (("g", g, ref_g), ("z", z, ref_z), ("x'", x_out, ref_x),
                           ("skip'", skip_out, ref_skip)):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), (name, err)
    assert torch.equal(g, g_serve) and torch.equal(g, g_again)


def test_wavenet_forward_plan_rule_source(host_libs):
    """The rule from M (the shim's 8 SMs): 128 x 128 tiles where their grid
    has a block for at least every second SM, else 64 x 64; a float32
    launch without split weights, or without the gate's scratch, is
    refused."""
    lib = host_libs["wavenet_block"]
    assert [lib.wavenet_forward_plan(B, T, R) for B, T, R in
            [(1, 384, 64), (1, 385, 64), (1, 300, 256), (4, 1024, 512), (1, 7, 64)]] == [
        1, 2, 2, 2, 1]
    x = torch.zeros(1, 8, 64)
    assert lib.wavenet_gate(0, x.data_ptr(), None, None, None, None, None, None, x.data_ptr(),
                            1, 8, 64, 64, 1, None) != 0
    assert lib.wavenet_gate(0, x.data_ptr(), None, None, x.data_ptr(), None, None, None,
                            x.data_ptr(), 1, 8, 64, 64, 1, None) != 0
    assert lib.wavenet_out(0, x.data_ptr(), None, None, None, None, None, None, None,
                           1, 8, 64, None) != 0


@pytest.mark.parametrize(
    "B,T,R,plan",
    # each plan of the gate backward on the wgmma core, reached by M = B T
    # as the rule picks it with the shim's 8 SMs (1 = 64 x 64, 2 = 128 x
    # 128 over two warpgroups, 3 = 128 x 64 over two warpgroups), at ragged
    # M whose tiles cross items, at R = 128 or 256 (several column tiles;
    # A's stages from dx' and from dskip') and at few rows
    [(3, 37, 64, 1), (2, 70, 128, 1), (1, 40, 64, 1), (5, 130, 128, 2), (1, 300, 256, 2),
     (2, 300, 128, 2), (4, 1000, 64, 3), (3, 700, 128, 3), (7, 600, 64, 3)],
)
def test_wavenet_gate_backward_plans_source(host_libs, B, T, R, plan):
    """K1's gate backward on the 3xTF32 wgmma core (``wavenet_gate_backward``,
    W_out split as stored) in each plan its rule picks against
    ``residual_gate_backward_reference``: <= 1e-4 of dz's scale, a rerun
    bit-equal."""
    gen = torch.Generator().manual_seed(B * T + R + plan)
    a = _k1_training(gen, B, T, R)
    z = rn(gen, B, T, 2 * R, scale=2.0)
    lib = host_libs["wavenet_block"]
    assert lib.wavenet_gate_backward_plan(B, T, R) == plan
    w_split = wavenet.split_weights_reference([a["w_out"]], [False], [True])[1][0]
    dz, again = (torch.full((B, T, 2 * R), float("nan")) for _ in range(2))
    for out in (dz, again):
        assert lib.wavenet_gate_backward(a["dx_out"].data_ptr(), a["dskip_out"].data_ptr(),
                                         w_split.data_ptr(), z.data_ptr(), out.data_ptr(),
                                         B, T, R, None) == 0
    ref = wavenet.residual_gate_backward_reference(a["dx_out"], a["dskip_out"], z, a["w_out"])
    err = (dz - ref).abs().max().item()
    assert err <= 1e-4 * ref.abs().max().item(), err
    assert torch.equal(dz, again)


def test_wavenet_gate_backward_plan_rule_source(host_libs):
    """The gate backward's rule from M and R (the shim's 8 SMs), in 128 x 64
    tiles: 128 x 64 where they are at least 4 an SM, else 128 x 128 where R
    is a multiple of 128 and they are one or more but fewer than two an
    SM, else 64 x 64; R off the 64-column tile, or a launch without split
    weights, is refused."""
    lib = host_libs["wavenet_block"]
    assert [lib.wavenet_gate_backward_plan(B, T, R) for B, T, R in
            [(1, 512, 128), (1, 384, 128), (1, 300, 256), (20, 512, 512), (4, 1000, 64),
             (4, 900, 64), (1, 1024, 128), (1, 896, 128)]] == [2, 1, 2, 3, 3, 1, 1, 2]
    x = torch.zeros(1, 8, 128)
    w = torch.zeros(2, 64, 128)
    for R, w_ptr in ((32, w.data_ptr()), (96, w.data_ptr()), (64, None)):
        assert lib.wavenet_gate_backward(x.data_ptr(), x.data_ptr(), w_ptr, x.data_ptr(),
                                         x.data_ptr(), 1, 8, R, None) != 0


def _ties(rng, w):
    """w with its first 64 elements (or all) on a TF32 rounding tie (bit 12
    set, the 12 bits below it clear), both signs."""
    n = min(64, w.size)
    ties = (rng.integers(0x30000000, 0x4c000000, n, dtype=np.uint32) & 0xffffe000) | 0x1000
    w.reshape(-1)[:n] = (ties | rng.integers(0, 2, n, dtype=np.uint32) << 31).view(np.float32)
    return w


def test_wavenet_weight_split_source(host_libs):
    """K1's split kernel (``wavenet_weight_split``): one launch over a table
    of weights, each bit-equal to its plain version (``tf32_split(w)``
    transposed, ``tf32_split(w.t())`` as stored, or both from one read),
    ties included, at shapes off the 32 x 32 tile; a table past 64
    weights, or a weight with neither layout asked, is refused."""
    rng = np.random.default_rng(16)
    shapes = [(96, 128, True, False), (40, 72, True, True), (33, 65, False, True),
              (64, 128, False, True), (7, 5, True, True), (5, 9, True, False)]
    ws = [torch.from_numpy(_ties(rng, (rng.standard_normal((r, c))
                                       * 10.0 ** rng.uniform(-6, 6, (r, c))).astype(np.float32)))
          for r, c, _, _ in shapes]
    transposed = [t for _, _, t, _ in shapes]
    stored = [n for _, _, _, n in shapes]
    out_t = [torch.full((2, *w.shape[::-1]), float("nan")) if t else None
             for w, t in zip(ws, transposed)]
    out_n = [torch.full((2, *w.shape), float("nan")) if n else None for w, n in zip(ws, stored)]
    n = len(ws)

    def pointers(ts):
        return (ctypes.c_void_p * len(ts))(*(None if t is None else t.data_ptr() for t in ts))

    lib = host_libs["wavenet_block"]
    assert lib.wavenet_weight_split(
        pointers(ws), pointers(out_t), pointers(out_n),
        (ctypes.c_int * n)(*(r for r, _, _, _ in shapes)),
        (ctypes.c_int * n)(*(c for _, c, _, _ in shapes)), n, None) == 0
    want_t, want_n = wavenet.split_weights_reference(ws, transposed, stored)
    for got, want in zip(out_t + out_n, want_t + want_n):
        assert (got is None) == (want is None)
        assert got is None or torch.equal(got, want)
    assert torch.equal(out_t[1], wavenet.tf32_split(ws[1]))
    assert torch.equal(out_n[1], wavenet.tf32_split(ws[1].t()))
    many = 65
    table = pointers([ws[0]] * many)
    dims = (ctypes.c_int * many)(*([1] * many))
    assert lib.wavenet_weight_split(table, table, table, dims, dims, many, None) != 0
    assert lib.wavenet_weight_split(pointers(ws[:1]), pointers([None]), pointers([None]),
                                    dims, dims, 1, None) != 0


def test_wavenet_weight_split_matches_numpy():
    """``tf32_split`` (the forward kernels' weights): w's transpose (K-major),
    big = w to TF32 (10 mantissa bits, to nearest, ties away from zero) and
    small = the same of w - big, bit for bit against numpy's ``tf32_rna``,
    ties included."""
    rng = np.random.default_rng(15)
    K, N = 96, 128
    w = (rng.standard_normal((K, N)) * 10.0 ** rng.uniform(-6, 6, (K, N))).astype(np.float32)
    ties = (rng.integers(0x30000000, 0x4c000000, 64, dtype=np.uint32) & 0xffffe000) | 0x1000
    w.reshape(-1)[:64] = (ties | rng.integers(0, 2, 64, dtype=np.uint32) << 31).view(np.float32)
    got = wavenet.tf32_split(torch.from_numpy(w)).numpy()
    assert got.shape == (2, N, K)
    big, small = got
    want_big = tf32_rna(w.T)
    np.testing.assert_array_equal(big, want_big)
    tail = (w.T.astype(np.float64) - want_big).astype(np.float32)
    live = tail != 0
    np.testing.assert_array_equal(small[live], tf32_rna(tail[live]))
    assert not small[~live].any()
    assert np.all(np.abs(big.T.reshape(-1)[:64]) > np.abs(w.reshape(-1)[:64]))  # away from 0


@pytest.mark.parametrize("T,R,d", [(40, 64, 1), (40, 64, 8), (12, 32, 8)])
def test_wavenet_weight_gradients_source(host_libs, T, R, d):
    """K1's weight gradients through ``conv1d_wgrad``: dW_conv at K = 3 and
    dilation d (padding d, the packed [3R, 2R] layout) and dW_out at K = 1,
    against the products they stand for, <= 1e-5 of their scale."""
    gen = torch.Generator().manual_seed(T + R + d)
    B = 2
    y, dz, g, do = rn(gen, B, T, R), rn(gen, B, T, 2 * R), rn(gen, B, T, R), rn(gen, B, T, R)
    lib = host_libs["conv1d_wgrad"]
    got = _wgrad1d(lib, y, dz, 3, 1, d, d, 1, None, None, None).reshape(3 * R, 2 * R)
    shifted = (wavenet.shift_time(y, d), y, wavenet.shift_time(y, -d))
    ref = torch.cat([(s.reshape(-1, R).t() @ dz.reshape(-1, 2 * R)) for s in shifted])
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    got = _wgrad1d(lib, g, do, 1, 1, 1, 0, 1, None, None, None)[0]
    ref = g.reshape(-1, R).t() @ do.reshape(-1, R)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize(
    "B,T,R,d",
    # with 8 SMs the rows are cut into chunks of 32 (R = 64: 3 output tiles,
    # 4 chunks) or 64 (R = 128: 8 tiles, 2 chunks); T = 37 and 29 put an
    # item's edge inside a chunk and T off the 32-row stage; d >= T
    [
        (3, 37, 64, 1),
        (2, 45, 64, 8),
        (3, 29, 128, 8),
        (2, 20, 64, 32),
    ],
)
def test_wavenet_weight_grad_source(host_libs, B, T, R, d):
    """K1's weight gradients on the 3xTF32 core, ``wavenet_weight_grad``:
    dW_conv and dW_out in one launch, the chunks' partial tiles added in
    order, against ``residual_weight_grad_reference``: <= 1e-5 of scale."""
    gen = torch.Generator().manual_seed(B * T + R + d)
    y, dz, g = rn(gen, B, T, R), rn(gen, B, T, 2 * R), rn(gen, B, T, R)
    dx_out, dskip_out = rn(gen, B, T, R), rn(gen, B, T, R)
    lib = host_libs["wavenet_block"]
    chunks = lib.wavenet_weight_grad_chunks(B, T, R)
    assert chunks > 1
    part = torch.full((chunks, 4 * R, 2 * R), float("nan"))
    dw_conv, dw_out = torch.empty(3 * R, 2 * R), torch.empty(R, 2 * R)
    assert lib.wavenet_weight_grad(y.data_ptr(), dz.data_ptr(), g.data_ptr(),
                                   dx_out.data_ptr(), dskip_out.data_ptr(), part.data_ptr(),
                                   dw_conv.data_ptr(), dw_out.data_ptr(), B, T, R, d, chunks,
                                   None) == 0
    refs = wavenet.residual_weight_grad_reference(y, dz, g, dx_out, dskip_out, d)
    for name, got, ref in (("dW_conv", dw_conv, refs[0]), ("dW_out", dw_out, refs[1])):
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), (name, err)


SPLIT_SOURCE = r"""
#include <cuda_runtime.h>
#include "tf32x3.cuh"
extern "C" void split_all(const float* x, float* big, float* small, int n) {
  for (int i = 0; i < n; ++i) tf32x3::split(x[i], big[i], small[i]);
}
"""


def tf32_rna(x: np.ndarray) -> np.ndarray:
    """x (normal float32 numbers) to 11 significant bits, to nearest, ties
    away from zero."""
    m, e = np.frexp(x.astype(np.float64))  # x = m 2^e, 0.5 <= |m| < 1
    return (np.sign(m) * np.floor(np.abs(m) * 2.0**11 + 0.5) * 2.0 ** (e - 11)).astype(
        np.float32)


def test_tf32_split_source(tmp_path):
    """``tf32x3::split`` on the host (the emulation's rounding; the card's is
    ``cvt.rna.tf32.f32``): big = x to 10 mantissa bits, to nearest with ties
    away from zero, and small = the same of x - big, against numpy; and
    the three products small a big b + big a small b + big a big b within
    2^-20 of a b (float64)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    (tmp_path / "shim.h").write_text(SHIM)
    (tmp_path / "split.cpp").write_text(_host_source(SPLIT_SOURCE))
    so = tmp_path / "libsplit.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    f"-I{tmp_path}", "-o", str(so), str(tmp_path / "split.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    lib.split_all.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]

    rng = np.random.default_rng(14)
    n = 1 << 14
    # normal numbers whose tails x - big are normal too
    x = (rng.standard_normal(n) * 10.0 ** rng.uniform(-25, 25, n)).astype(np.float32)
    # exact ties: the 13 dropped bits 1 followed by zeros, both signs
    ties = (rng.integers(0x0c000000, 0x72000000, 4096, dtype=np.uint32) & 0xffffe000) | 0x1000
    ties |= rng.integers(0, 2, 4096, dtype=np.uint32) << 31
    x = np.concatenate([x, ties.view(np.float32)])
    big, small = np.empty_like(x), np.empty_like(x)
    lib.split_all(x.ctypes.data, big.ctypes.data, small.ctypes.data, x.size)
    want_big = tf32_rna(x)
    np.testing.assert_array_equal(big, want_big)
    tail = x.astype(np.float64) - want_big  # exact in float32
    live = tail != 0
    np.testing.assert_array_equal(small[live], tf32_rna(tail[live].astype(np.float32)))
    assert not small[~live].any()
    assert np.all(np.abs(big[-4096:]) > np.abs(x[-4096:]))  # ties away from zero

    a, b = x[: n // 2], x[n // 2 : n]
    keep = np.abs(np.log2(np.abs(a.astype(np.float64) * b))) < 120  # normal products
    ba, sa, bb, sb = (v.astype(np.float64) for v in (big[: n // 2], small[: n // 2],
                                                     big[n // 2 : n], small[n // 2 : n]))
    three = sa * bb + ba * sb + ba * bb
    exact = a.astype(np.float64) * b
    rel = np.abs(three - exact)[keep] / np.abs(exact)[keep]
    assert rel.max() <= 2.0**-20, rel.max()


def _conv(lib, transposed, x, w_packed, bias, residual, T_out, K, stride, dil,
          pad, slope, tanh):
    B, T_in, C_in = x.shape
    C_out = w_packed.shape[2]
    out = torch.empty(B, T_out, C_out)
    assert lib.conv1d_forward(
        0, int(transposed), x.data_ptr(), w_packed.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        B, T_in, T_out, C_in, C_out, K, stride, dil, pad, float(slope or 0.0),
        int(slope is not None), int(tanh), None,
    ) == 0
    return out


@pytest.mark.parametrize(
    "C_in,C_out,K,stride,dil,pad,slope,res,tanh",
    [
        (128, 70, 7, 1, 1, 3, None, False, False),   # conv_pre, ragged C_out
        (32, 32, 11, 1, 5, 25, 0.1, True, False),    # resblock, 32-wide tile
        (16, 16, 3, 1, 3, 3, 0.1, False, False),     # resblock, 16-wide tile
        (1, 256, 128, 64, 1, 32, None, True, False),  # noise conv, 49 KB smem
        (1, 24, 16, 8, 1, 4, None, False, False),    # noise conv
        (16, 1, 7, 1, 1, 3, 0.01, False, True),      # conv_post, 1-wide tile
        # the forward core's plans: 8 chunks of 16 channels through a
        # 3-stage ring (more chunks than stages), one chunk of 8 (fewer),
        # two of 16 (a 2-stage ring); dilation 3 and 5 (positions a thread
        # spaced by the dilation), k = 11 past the 8 taps a slide holds
        (128, 64, 3, 1, 1, 1, 0.1, True, False),
        (8, 16, 5, 1, 1, 2, None, False, False),
        (24, 40, 7, 1, 3, 9, 0.1, True, False),
        (64, 64, 11, 1, 5, 25, 0.1, True, False),
        # stride 2 (the taps in two residue classes), stride 8 (eight)
        (24, 40, 4, 2, 1, 1, None, False, False),
        (16, 32, 16, 8, 1, 4, None, True, False),
        # residual, tanh and slope together; widths no multiple of 4 (4-byte
        # copies, masked channels); C_in = 1 with C_out = 1
        (32, 16, 3, 1, 1, 1, 0.2, True, True),
        (6, 10, 5, 1, 2, 4, 0.1, False, False),
        (1, 1, 5, 1, 1, 2, None, True, True),
        (20, 1, 9, 1, 2, 8, 0.1, True, False),
    ],
)
def test_conv1d_source(host_libs, C_in, C_out, K, stride, dil, pad, slope, res, tanh):
    """K4 direct conv: <= 1e-4 relative to the output's scale."""
    gen = torch.Generator().manual_seed(C_in + C_out + K)
    B, T = 2, 40 * stride + 5
    x = rn(gen, B, T, C_in)
    w, b = rn(gen, C_out, C_in, K, scale=(C_in * K) ** -0.5), rn(gen, C_out)
    T_out = (T + 2 * pad - dil * (K - 1) - 1) // stride + 1
    residual = rn(gen, B, T_out, C_out) if res else None
    got = _conv(host_libs["conv1d"], False, x, w.permute(2, 1, 0).contiguous(), b,
                residual, T_out, K, stride, dil, pad, slope, tanh)
    ref = nsf_hifigan.conv1d_reference(x, w, b, stride, dil, pad, slope, residual, tanh)
    assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("C_in,C_out,K,u", [
    (96, 48, 16, 8), (32, 16, 4, 2), (4, 2, 4, 2),
    # 3 taps a class, stride 1 (one class, taps reversed), C_out = 1, and a
    # class count (16) past the classes' shared strip
    (16, 8, 6, 2), (8, 12, 3, 1), (32, 1, 4, 2), (24, 20, 32, 16)])
def test_conv_transpose1d_source(host_libs, C_in, C_out, K, u):
    """K4 transposed conv: <= 1e-4 relative to the output's scale."""
    gen = torch.Generator().manual_seed(C_in + K)
    x = rn(gen, 2, 37, C_in)
    w, b = rn(gen, C_in, C_out, K, scale=(C_in * K / u) ** -0.5), rn(gen, C_out)
    pad = (K - u) // 2
    T_out = (x.shape[1] - 1) * u - 2 * pad + K
    got = _conv(host_libs["conv1d"], True, x, w.permute(2, 0, 1).contiguous(), b,
                None, T_out, K, u, 1, pad, 0.1, False)
    ref = nsf_hifigan.conv_transpose1d_reference(x, w, b, u, pad, 0.1)
    assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


@pytest.mark.parametrize("C_in,C_out,K,u,pad,extra", [
    (16, 1, 16, 8, 4, -3), (16, 1, 16, 8, 4, 5), (24, 32, 4, 2, 1, 1), (64, 1, 128, 64, 32, 0),
    (8, 1, 4, 2, 1, -1)])
def test_conv_transpose1d_source_cut(host_libs, C_in, C_out, K, u, pad, extra):
    """K4's transposed mode with its output cut or extended (``extra``
    positions past the natural length, within the stride: torch's
    ``output_padding``), as a strided conv's input gradient reaches it:
    every residue class masks its own edges."""
    gen = torch.Generator().manual_seed(C_in + K + extra)
    x = rn(gen, 2, 29, C_in)
    w, b = rn(gen, C_in, C_out, K, scale=(C_in * K / u) ** -0.5), rn(gen, C_out)
    natural = (x.shape[1] - 1) * u - 2 * pad + K
    T_out = natural + extra
    got = _conv(host_libs["conv1d"], True, x, w.permute(2, 0, 1).contiguous(), b, None,
                T_out, K, u, 1, pad, None, False)
    ref = nsf_hifigan.conv_transpose1d_reference(x, w, b, u, pad, None,
                                                 max(0, extra))[:, :T_out]
    assert (got - ref).abs().max().item() <= 1e-4 * max(1.0, ref.abs().max().item())


def test_conv1d_source_bf16(host_libs):
    """K4's bfloat16 entry (dtype 1): operands converted to float32 as
    they land, float32 sums, one rounding on the store: within one bf16
    rounding (2^-8 of the scale) of the plain version run in float32 on the
    same bf16 inputs."""
    gen = torch.Generator().manual_seed(7)
    x = rn(gen, 2, 45, 32).bfloat16()
    w = rn(gen, 24, 32, 11, scale=(32 * 11) ** -0.5).bfloat16()
    b, r = rn(gen, 24).bfloat16(), rn(gen, 2, 45, 24).bfloat16()
    out = torch.empty(2, 45, 24, dtype=torch.bfloat16)
    w_packed = w.permute(2, 1, 0).contiguous()  # alive through the call
    assert host_libs["conv1d"].conv1d_forward(
        1, 0, x.data_ptr(), w_packed.data_ptr(), b.data_ptr(), r.data_ptr(), out.data_ptr(),
        2, 45, 45, 32, 24, 11, 1, 5, 25, 0.1, 1, 0, None) == 0
    ref = nsf_hifigan.conv1d_reference(x.float(), w.float(), b.float(), 1, 5, 25, 0.1,
                                       r.float())
    assert (out.float() - ref).abs().max().item() <= 2 ** -8 * ref.abs().max().item()


@pytest.mark.parametrize("kind", ["conv1d", "conv_transpose1d", "conv2d", "conv2d_transposed",
                                  "grouped", "grouped_transposed"])
def test_conv_fwd_source_unaligned(host_libs, kind):
    """The forward core on views that start off a 16-byte boundary (input,
    weights, residual, output): 4-byte copies into the same window layout
    and scalar stores, so the result equals the aligned one bit for bit; a
    second launch on the same inputs gives the same bits. Every mode: K4's
    two, K6 2-D's two (MRD layer 1 and its input gradient), K6 grouped's
    two (MSD layer 1's widths, 4 groups)."""
    gen = torch.Generator().manual_seed(11)
    if kind.startswith("conv2d"):
        transposed = kind == "conv2d_transposed"
        x = rn(gen, 2, 5, 11 if transposed else 21, 32)
        w = rn(gen, 3, 10 if transposed else 9, 32, 32, scale=(32 * 27) ** -0.5)
        lib = host_libs["conv2d"]
        W_in, W_out = (11, 21) if transposed else (21, 11)

        def fn(x_, w_, out):
            assert lib.conv2d(int(transposed), x_.data_ptr(), w_.data_ptr(), None,
                              out.data_ptr(), 2, 5, W_in, 5, W_out, 32, 32, 3, w.shape[1], 1,
                              2, 1, 4, None) == 0
            return out

        shape, args = (2, 5, W_out, 32), (x, w)
    elif kind.startswith("grouped"):
        transposed = kind == "grouped_transposed"
        T_in, T_out = (23, 45) if transposed else (45, 23)
        x, b = rn(gen, 2, T_in, 128), rn(gen, 128)
        w = rn(gen, 42 if transposed else 41, 32, 128, scale=(32 * 41) ** -0.5)
        lib = host_libs["grouped_conv1d"]

        def fn(x_, w_, out):
            assert lib.grouped_conv1d(int(transposed), x_.data_ptr(), w_.data_ptr(),
                                      b.data_ptr(), out.data_ptr(), 2, T_in, T_out, 128, 128,
                                      w.shape[0], 2, 20, 4, None) == 0
            return out

        shape, args = (2, T_out, 128), (x, w)
    else:
        transposed = kind == "conv_transpose1d"
        x = rn(gen, 2, 40, 32)
        w = rn(gen, 16 if transposed else 11, 32, 32, scale=(32 * 11) ** -0.5)
        b, r = rn(gen, 32), rn(gen, 2, 320 if transposed else 40, 32)
        lib = host_libs["conv1d"]
        T_out = 320 if transposed else 40

        def fn(x_, w_, out, r_=None):
            assert lib.conv1d_forward(
                0, int(transposed), x_.data_ptr(), w_.data_ptr(), b.data_ptr(),
                None if transposed else r_.data_ptr(), out.data_ptr(), 2, 40, T_out, 32, 32,
                16 if transposed else 11, 8 if transposed else 1, 1 if transposed else 5,
                4 if transposed else 25, 0.1, 1, 0, None) == 0
            return out

        shape, args = (2, T_out, 32), (x, w)
        if not transposed:
            fn_res = fn
            fn = lambda x_, w_, out, r_=r: fn_res(x_, w_, out, r_)  # noqa: E731
    aligned = fn(*args, torch.full(shape, float("nan")))
    assert torch.equal(fn(*args, torch.full(shape, float("nan"))), aligned)
    views = [(_at_offset(args[0]), args[1]), (args[0], _at_offset(args[1]))]
    for x_, w_ in views:
        out = _at_offset(torch.full(shape, float("nan")))
        assert torch.equal(fn(x_, w_, out), aligned)
    if kind == "conv1d":
        out = _at_offset(torch.full(shape, float("nan")))
        assert torch.equal(fn(x, w, out, _at_offset(r)), aligned)


@pytest.mark.parametrize(
    "B,T,hop,H,seed",
    # hop 16 and 64, the modules' 9 harmonics and 1; T not a multiple of a
    # block's frames (the shim's 8 SMs: a block of 1 or 2 chunks of 512
    # samples here, and a ragged last chunk at hop 16); runs of unvoiced
    # frames; start phases near 1; blocks of 4 chunks (the ring of 3 slots
    # wraps) at hop 256
    [(2, 37, 16, 9, 0), (3, 50, 64, 9, 1), (1, 45, 64, 1, 2), (2, 29, 16, 1, 3),
     (1, 203, 256, 9, 4)],
)
def test_nsf_merge_source(host_libs, B, T, hop, H, seed):
    """K3's merge (``csrc/nsf_source.cu``) against ``nsf_merge_reference``:
    <= 1e-4 (one sincospif a sample, the harmonics by rotation, against nine
    float32 sines), every sample written."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    gen = torch.Generator().manual_seed(seed)
    f0 = torch.rand((B, T), generator=gen) * 900 + 60
    f0[:, T // 4: T // 4 + 7] = 0.0  # a run of unvoiced frames
    f0 = f0 * (torch.rand((B, T), generator=gen) > 0.2)
    rand_ini = 1 - torch.rand((B, H), generator=gen) * 1e-3  # near 1
    rand_ini[:, 0] = 0
    noise = rn(gen, B, T * hop, H)
    weight, bias = rn(gen, H, scale=0.3), rn(gen, 1, scale=0.1)
    base = source.nsf_phase_base_reference(f0, 44100, hop)
    out = torch.full((B, T * hop, 1), float("nan"))
    assert host_libs["nsf_source"].nsf_merge(
        f0.data_ptr(), base.data_ptr(), rand_ini.data_ptr(), noise.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T, hop, H, 44100.0, 0.1,
        0.003, None) == 0
    ref = source.nsf_merge_reference(f0, base, rand_ini, noise, weight, bias, 44100, hop)
    assert (out - ref).abs().max().item() <= 1e-4
    assert host_libs["nsf_source"].nsf_merge(
        f0.data_ptr(), base.data_ptr(), rand_ini.data_ptr(), noise.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T, hop, 17, 44100.0, 0.1,
        0.003, None) != 0


def _nsf_inputs(B, T, hop, H, seed, f0_scale=900.0):
    """f0 [B, T] with a run of unvoiced frames and ~20% more, start phases
    near 1 (column 0 is 0), noise [B, T * hop, H], the merge's weights."""
    gen = torch.Generator().manual_seed(seed)
    f0 = torch.rand((B, T), generator=gen) * f0_scale + 60
    f0[:, T // 4: T // 4 + 7] = 0.0
    f0 = f0 * (torch.rand((B, T), generator=gen) > 0.2)
    rand_ini = 1 - torch.rand((B, H), generator=gen) * 1e-3
    rand_ini[:, 0] = 0
    noise = rn(gen, B, T * hop, H)
    weight, bias = rn(gen, H, scale=H ** -0.5), rn(gen, 1, scale=0.1)
    return gen, f0, rand_ini, noise, weight, bias


@pytest.mark.parametrize(
    "B,T,hop,H,seed",
    # as test_nsf_merge_source: hop 16, 64 and 256, 9 harmonics and 1, T
    # not a multiple of a block's frames (a ragged last chunk at hop 16),
    # unvoiced runs, start phases near 1, the ring wrapping at hop 256
    [(2, 37, 16, 9, 10), (1, 45, 64, 1, 11), (1, 203, 256, 9, 12), (2, 29, 16, 1, 13)],
)
def test_nsf_merge_backward_source(host_libs, B, T, hop, H, seed):
    """K3's backward (``csrc/nsf_source.cu``) against
    ``nsf_merge_backward_reference``: dW and db within 1e-4 of their scale
    (sums over every sample in another order, the sines by rotation); a
    second call gives the same bits; 17 harmonics are refused."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    gen, f0, rand_ini, noise, weight, bias = _nsf_inputs(B, T, hop, H, seed)
    base = source.nsf_phase_base_reference(f0, 44100, hop)
    out = source.nsf_merge_reference(f0, base, rand_ini, noise, weight, bias, 44100, hop)
    g = rn(gen, *out.shape)
    lib = host_libs["nsf_source"]
    partials = torch.full(((H + 1) * B * -(-T * hop // 512),), float("nan"))

    def backward(H_=H):
        sums = torch.full((H + 1,), float("nan"))
        status = lib.nsf_merge_backward(
            g.data_ptr(), out.data_ptr(), f0.data_ptr(), base.data_ptr(), rand_ini.data_ptr(),
            noise.data_ptr(), partials.data_ptr(), sums.data_ptr(), B, T, hop, H_, 44100.0,
            0.1, 0.003, None)
        return status, sums

    status, sums = backward()
    assert status == 0
    dw, db = source.nsf_merge_backward_reference(g, out, f0, base, rand_ini, noise, 44100, hop)
    ref = torch.cat([dw, db])
    assert (sums - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(backward()[1], sums)
    assert backward(17)[0] != 0


@pytest.mark.parametrize(
    "B,T,hop,H,seed",
    # hop 16 and 256 (a thread's samples on one coefficient lane; at hop 16
    # a ragged last chunk), 1 harmonic (RefineGAN's) and 3; an f0 at
    # sr / 2 - 50, whose harmonics above the first cross sr // 2 and whose
    # phase advances ~128 turns in a frame at hop 256; unvoiced frames;
    # blocks of 4 chunks (the ring wraps) at hop 256 and 512; hop 512 and
    # 1024, past the block's 256 threads (a lane read a sample), at 1024 a
    # block inside one frame
    [(2, 37, 16, 1, 20), (1, 45, 256, 1, 21), (2, 29, 16, 3, 22), (1, 200, 256, 3, 23),
     (1, 9, 1024, 1, 24), (1, 100, 512, 3, 25)],
)
def test_sine_merge_source(host_libs, B, T, hop, H, seed):
    """K9 sine (``csrc/nsf_source.cu``'s linear mode) against
    ``_sine_merge_plain``: the template and, in the training form, the
    written signals within 1e-5."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    sr = 44100
    _, f0, rand_ini, noise, weight, bias = _nsf_inputs(B, T, hop, H, seed, f0_scale=700.0)
    f0[0, T // 2] = sr / 2 - 50
    base = source.nsf_phase_base_reference(f0, sr, hop, "linear")
    coef, psum = source._coeff_tensors(hop, "cpu")
    ref, ref_signals = source._sine_merge_plain(f0, base, rand_ini, noise, weight, bias, sr,
                                                hop, 0.1, 0.003)
    for signals in (None, torch.full_like(noise, float("nan"))):
        out = torch.full((B, T * hop, 1), float("nan"))
        assert host_libs["nsf_source"].sine_merge(
            f0.data_ptr(), base.data_ptr(), coef.data_ptr(), psum.data_ptr(),
            rand_ini.data_ptr(), noise.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if signals is None else signals.data_ptr(), B, T, hop, H,
            float(sr), 0.1, 0.003, float(sr // 2), None) == 0
        assert (out - ref).abs().max().item() <= 1e-5
        if signals is not None:
            assert (signals - ref_signals).abs().max().item() <= 1e-5


def _comb_inputs(B, T, hop, seed, sr):
    """f0 [B, T] as ``_nsf_inputs``' (unvoiced runs) with one frame at sr / 2
    - 50, and noise [B, T * hop]."""
    gen, f0, *_ = _nsf_inputs(B, T, hop, 1, seed, f0_scale=700.0)
    f0[0, T // 2] = sr / 2 - 50
    return f0, rn(gen, B, T * hop)


def _comb_merge(lib, f0, base, noise, sr, hop):
    """The C entry ``comb_merge`` (base None: its own scan) -> (status, out)."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    B, T = f0.shape
    coef, psum = source._coeff_tensors(hop, "cpu")
    out = torch.full((B, T * hop), float("nan"))
    status = lib.comb_merge(f0.data_ptr(), None if base is None else base.data_ptr(),
                            coef.data_ptr(), psum.data_ptr(), noise.data_ptr(), out.data_ptr(),
                            B, T, hop, float(sr), 0.1, 0.003, None)
    return status, out


@pytest.mark.parametrize(
    "B,T,hop,seed",
    # hop 16 (a ragged last chunk) and 256 (RefineGAN's: a thread's samples
    # on one coefficient lane), hop 512 past the block's 256 threads (a lane
    # read a sample); unvoiced runs; an f0 at sr / 2 - 50
    [(2, 37, 16, 30), (1, 45, 256, 31), (2, 29, 16, 32), (1, 200, 256, 33), (1, 100, 512, 34)],
)
def test_comb_merge_source(host_libs, B, T, hop, seed):
    """K9 comb (``csrc/nsf_source.cu``'s comb mode) against
    ``comb_merge_reference`` within 1e-5 on a 0.1-amplitude template, given
    the reference's linear bases and with its own scan (a null base)."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    sr = 44100
    f0, noise = _comb_inputs(B, T, hop, seed, sr)
    base = source.nsf_phase_base_reference(f0, sr, hop, "linear")
    ref = source.comb_merge_reference(f0, base, noise, sr, hop)
    for given in (base, None):
        status, out = _comb_merge(host_libs["nsf_source"], f0, given, noise, sr, hop)
        assert status == 0
        assert (out - ref).abs().max().item() <= 1e-5
    assert _comb_merge(host_libs["nsf_source"], f0, base, noise, sr, 24)[0] != 0


# (B, T, hop, H) of the scan inside the kernels: one tile of frames at hop
# 16 (a ragged last chunk); 5 tiles, a block's 128 frames inside one (hop
# 4); 18 tiles at hop 4, blocks of 384 frames straddling tiles and warps
# taking up to three tiles; frames that two blocks share (hop 1024)
SCAN_CASES = [(2, 37, 16, 9), (1, 1100, 4, 1), (2, 4500, 4, 1), (1, 9, 1024, 3)]


@pytest.mark.parametrize("B,T,hop,H", SCAN_CASES)
def test_nsf_merge_source_scans(host_libs, B, T, hop, H):
    """K3 with its own frame-phase scan (a null base) bit-equal to the
    kernel given ``nsf_phase_base_reference``'s bases (the nearest mode's
    sums are exact in any order), and within 1e-4 of the plain version."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    _, f0, rand_ini, noise, weight, bias = _nsf_inputs(B, T, hop, H, T + hop)
    base = source.nsf_phase_base_reference(f0, 44100, hop)
    outs = []
    for given in (base, None):
        out = torch.full((B, T * hop, 1), float("nan"))
        assert host_libs["nsf_source"].nsf_merge(
            f0.data_ptr(), None if given is None else given.data_ptr(), rand_ini.data_ptr(),
            noise.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), B, T, hop, H,
            44100.0, 0.1, 0.003, None) == 0
        outs.append(out)
    assert torch.equal(outs[1], outs[0])
    ref = source.nsf_merge_reference(f0, None, rand_ini, noise, weight, bias, 44100, hop)
    assert (outs[1] - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,T,hop,H", SCAN_CASES)
def test_nsf_merge_backward_source_scans(host_libs, B, T, hop, H):
    """K3's backward with its own scan (a null base): dW and db within 1e-4
    of their scale of the plain version, bit-equal on a second call and to
    the kernel given the reference's bases."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    gen, f0, rand_ini, noise, weight, bias = _nsf_inputs(B, T, hop, H, T + hop + 1)
    base = source.nsf_phase_base_reference(f0, 44100, hop)
    out = source.nsf_merge_reference(f0, base, rand_ini, noise, weight, bias, 44100, hop)
    g = rn(gen, *out.shape)
    partials = torch.full(((H + 1) * B * -(-T * hop // 512),), float("nan"))

    def backward(given):
        sums = torch.full((H + 1,), float("nan"))
        assert host_libs["nsf_source"].nsf_merge_backward(
            g.data_ptr(), out.data_ptr(), f0.data_ptr(),
            None if given is None else given.data_ptr(), rand_ini.data_ptr(), noise.data_ptr(),
            partials.data_ptr(), sums.data_ptr(), B, T, hop, H, 44100.0, 0.1, 0.003, None) == 0
        return sums

    sums = backward(None)
    ref = torch.cat(source.nsf_merge_backward_reference(g, out, f0, None, rand_ini, noise,
                                                        44100, hop))
    assert (sums - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert torch.equal(backward(None), sums)
    assert torch.equal(backward(base), sums)


@pytest.mark.parametrize("B,T,hop,H", SCAN_CASES)
def test_linear_merges_source_scan(host_libs, B, T, hop, H):
    """K9 sine and K9 comb with their own linear scan (a null base) against
    the plain composition, the merge on ``nsf_phase_base_reference``'s
    linear bases: within 1e-5 (the scan's float64 sums in another order
    than the plain cumsum, ~1e-13 of a turn; a base a float32 step apart
    moves the comb by < 4e-6)."""
    from fish_diffusion_tpu_torch.models.vocoders import source

    sr = 44100
    _, f0, rand_ini, noise, weight, bias = _nsf_inputs(B, T, hop, H, T + hop + 2,
                                                       f0_scale=700.0)
    f0[0, T // 2] = sr / 2 - 50
    coef, psum = source._coeff_tensors(hop, "cpu")
    ref = source.sine_template_reference(f0, rand_ini, noise, weight, bias, sr, hop)
    out = torch.full((B, T * hop, 1), float("nan"))
    assert host_libs["nsf_source"].sine_merge(
        f0.data_ptr(), None, coef.data_ptr(), psum.data_ptr(), rand_ini.data_ptr(),
        noise.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(), None, B, T, hop,
        H, float(sr), 0.1, 0.003, float(sr // 2), None) == 0
    assert (out - ref).abs().max().item() <= 1e-5
    comb_noise = noise[..., 0].contiguous()
    status, comb = _comb_merge(host_libs["nsf_source"], f0, None, comb_noise, sr, hop)
    assert status == 0
    assert (comb - source.comb_tooth_reference(f0, comb_noise, sr, hop)).abs().max().item() \
        <= 1e-5


def test_nsf_source_refuses_sizes(host_libs):
    """Every entry of ``csrc/nsf_source.cu`` refuses rows past 2^20 frames
    (the scan's tile sums in shared memory) before any launch."""
    lib, T = host_libs["nsf_source"], (1 << 20) + 1
    assert lib.nsf_merge(*[None] * 7, 1, T, 1, 1, 44100.0, 0.1, 0.003, None) != 0
    assert lib.nsf_merge_backward(*[None] * 8, 1, T, 1, 1, 44100.0, 0.1, 0.003, None) != 0
    assert lib.sine_merge(*[None] * 10, 1, T, 1, 1, 44100.0, 0.1, 0.003, 22050.0, None) != 0
    assert lib.comb_merge(*[None] * 6, 1, T, 1, 44100.0, 0.1, 0.003, None) != 0


def _k5(n_fft, win, double=False):
    """K5's tables on the CPU (float64 for the backward) and the FFT length."""
    return mel._fft_plan(n_fft, win, "cpu", double), mel._fft_size(n_fft)


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F",
    # powers of two (Stockham: 2048 with 51 KB of dynamic shared memory,
    # 4096 at the 4096 / 540 / 2160 mel scale, 64) and Bluestein (2299 =
    # 11 * 11 * 19 at a key shift of +2, 1933 prime at -1, 1149 = 3 * 383 at
    # -10, 300); odd frame counts leave the last frame unpaired; F = 40
    # spans several runs of 8 frames, 21 and 13 a ragged last run
    [(1, 2048, 2048, 512, 5), (2, 2299, 2299, 512, 3), (2, 300, 240, 75, 40),
     (1, 64, 48, 16, 10), (1, 1933, 1933, 512, 4), (2, 1149, 1000, 300, 5),
     (1, 4096, 2160, 540, 13), (1, 64, 64, 16, 21)],
)
def test_stft_source(host_libs, B, n_fft, win, hop, F):
    """K5: <= 1e-5 relative to the largest magnitude (an FFT against the
    plain version's sums of n_fft products)."""
    gen = torch.Generator().manual_seed(n_fft + F)
    y = rn(gen, B, n_fft + (F - 1) * hop + hop // 3, scale=0.3)
    plan, L = _k5(n_fft, win)
    bins = n_fft // 2 + 1
    out = torch.full((B, bins, F), float("nan"))
    assert host_libs["stft"].stft_magnitude(
        y.data_ptr(), *mel._pointers(plan), out.data_ptr(), B, y.shape[1], n_fft, L,
        hop, F, None) == 0
    ref = mel.stft_magnitude_reference(y, n_fft, hop, win)
    assert ref.shape == out.shape
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F",
    # the training scales (512 / 128, 2048 / 512), Bluestein (2299, 1933,
    # 1149 with win 1000), 4096 / 540 / 2160 (the largest float64 buffer
    # on the training path), an unpaired last frame
    [(2, 512, 512, 128, 9), (1, 2048, 2048, 512, 5), (2, 2299, 2299, 512, 3),
     (1, 1933, 1933, 512, 4), (2, 1149, 1000, 300, 5), (1, 4096, 2160, 540, 13),
     (1, 64, 48, 16, 10)],
)
def test_stft_f64_source(host_libs, B, n_fft, win, hop, F):
    """K5's exact forward (float64, the training losses'): every magnitude
    within 1e-6 of its own value of the plain version run in float64."""
    gen = torch.Generator().manual_seed(n_fft + F + 1)
    y = rn(gen, B, n_fft + (F - 1) * hop + hop // 3, scale=0.3)
    plan, L = _k5(n_fft, win, double=True)
    out = torch.full((B, n_fft // 2 + 1, F), float("nan"))
    assert host_libs["stft"].stft_magnitude_f64(
        y.data_ptr(), *mel._pointers(plan), out.data_ptr(), B, y.shape[1], n_fft, L,
        hop, F, None) == 0
    ref = mel.stft_magnitude_reference(y.double(), n_fft, hop, win)
    assert ((out.double() - ref).abs() / ref).max().item() <= 1e-6


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F,L1",
    # the split path (four-step FFTs through device memory) at small
    # splits: a power of two (256 = 16 x 16, 128 = 16 x 8), Bluestein (300:
    # L = 1024 = 32 x 32; 97: 256 = 16 x 16), an odd frame count
    [(2, 256, 200, 64, 5, 16), (1, 128, 128, 32, 4, 16), (1, 300, 300, 100, 4, 32),
     (2, 97, 80, 20, 3, 16)],
)
def test_stft_split_source(host_libs, B, n_fft, win, hop, F, L1):
    """K5's split path: the float32 forward <= 1e-5 of the largest
    magnitude, the float64 forward every magnitude within 1e-6 of its own
    value, the backward <= 1e-5 of the gradient's scale, each against the
    plain version; every sample of the gradient written."""
    gen = torch.Generator().manual_seed(n_fft + F + L1)
    T_pad = n_fft + (F - 1) * hop + hop // 3
    y = rn(gen, B, T_pad, scale=0.3)
    lib = host_libs["stft"]
    bins, pairs = n_fft // 2 + 1, B * ((F + 1) // 2)
    for double in (False, True):
        plan, L = _k5(n_fft, win, double=double)
        dtype = torch.float64 if double else torch.float32
        work, scales = torch.empty(pairs, L, 2, dtype=dtype), torch.empty(pairs, 2, dtype=dtype)
        out = torch.full((B, bins, F), float("nan"))
        assert lib.stft_magnitude_split(y.data_ptr(), *mel._pointers(plan), work.data_ptr(),
                                        scales.data_ptr(), out.data_ptr(), B, T_pad, n_fft, L,
                                        L1, hop, F, int(double), None) == 0
        if double:
            ref = mel.stft_magnitude_reference(y.double(), n_fft, hop, win)
            assert ((out.double() - ref).abs() / ref).max().item() <= 1e-6
        else:
            ref = mel.stft_magnitude_reference(y, n_fft, hop, win)
            assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    g = rn(gen, B, bins, F)
    work, work2 = (torch.empty(pairs, L, 2, dtype=torch.float64) for _ in range(2))
    scales, gscales = (torch.empty(pairs, 2, dtype=torch.float64) for _ in range(2))
    frames = torch.full((B, F, n_fft), float("nan"))
    grad = torch.full((B, T_pad), float("nan"))
    assert lib.stft_backward_split(
        g.data_ptr(), y.data_ptr(), *mel._pointers(plan), work.data_ptr(), work2.data_ptr(),
        scales.data_ptr(), gscales.data_ptr(), frames.data_ptr(), grad.data_ptr(), B, T_pad,
        n_fft, L, L1, hop, F, None) == 0
    ref = mel.stft_backward_reference(g, y, n_fft, hop, win)
    assert (grad - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_stft_split_takes_what_shared_memory_does_not(host_libs):
    """The wrappers' rule: shared memory up to its limits (float32 Bluestein
    up to n_fft 8192, float64 up to L = 8192), the split path beyond, and
    the split path refuses a split it cannot run."""
    lib = host_libs["stft"]
    assert lib.stft_fits_shared(8192, 16384, 8) and not lib.stft_fits_shared(16384, 16384, 8)
    assert lib.stft_fits_shared(4096, 8192, 16) and not lib.stft_fits_shared(6000, 16384, 16)
    assert mel._split(16384) == 128 and mel._split(1 << 22) == 2048
    assert lib.stft_magnitude_split(None, None, None, None, None, None, None, None, 1, 40000,
                                    6000, 16384, 4096, 512, 1, 1, None) != 0


@pytest.mark.parametrize("B,T,K", [(3, 50, 4), (2, 1, 4), (1, 30, 2)])
def test_viterbi_source(host_libs, B, T, K):
    """K8-cand on random candidate maps: path and f0 identical."""
    gen = torch.Generator().manual_seed(T + K)
    freqs = torch.rand((B, T, K), generator=gen) * 1050 + 50
    freqs = freqs * (torch.rand((B, T, K), generator=gen) > 0.3)
    strengths = torch.rand((B, T, K), generator=gen) * 2 - 1
    unvoiced = torch.rand((B, T), generator=gen) * 1.5
    _check_viterbi(host_libs["viterbi"], freqs, strengths, unvoiced)


def test_viterbi_source_ties(host_libs):
    """K8-cand where every score ties (equal candidates and strengths) and
    where voiced states tie among themselves: the first state wins, as in
    the plain version and ``jnp.argmax``."""
    T = 12
    freqs = torch.full((2, T, 4), 220.0)
    freqs[1, :, 2:] = 440.0
    strengths = torch.full((2, T, 4), 0.5)
    unvoiced = torch.full((2, T), 0.5)
    path = _check_viterbi(host_libs["viterbi"], freqs, strengths, unvoiced)
    assert (path == 0).all()


def _viterbi(lib, freqs, strengths, unvoiced, entry="viterbi_candidates"):
    """K8-cand's C entry ``entry`` on a path of -1s and an f0 of NaNs."""
    B, T, K = freqs.shape
    per_item = lib.viterbi_candidates_plan(T, K, 2)
    scratch = torch.zeros(max(B * per_item, 1), dtype=torch.uint8)
    path = torch.full((B, T), -1, dtype=torch.int32)
    f0 = torch.full((B, T), float("nan"))
    assert getattr(lib, entry)(freqs.data_ptr(), strengths.data_ptr(), unvoiced.data_ptr(),
                               scratch.data_ptr(), path.data_ptr(), f0.data_ptr(),
                               B, T, K, None) == 0
    return f0, path


def _check_viterbi(lib, freqs, strengths, unvoiced):
    """K8-cand's C entry: path and f0 identical to the plain version's."""
    f0, path = _viterbi(lib, freqs, strengths, unvoiced)
    ref_f0, ref_path = pitch.viterbi_candidates_reference(freqs, strengths, unvoiced)
    torch.testing.assert_close(path, ref_path, atol=0, rtol=0)
    torch.testing.assert_close(f0, ref_f0, atol=0, rtol=0)
    return path


@pytest.mark.parametrize("kind,B,T,K,smem", [
    ("random", 2, 600, 4, 0),  # 5 chunks of 128 frames: both rings wrap
    ("random", 1, 600, 4, 64000),  # streamed: the backpointers' ring of 4 wraps
    ("grid", 2, 600, 4, 64000), ("inf", 1, 700, 4, 64000),
    ("grid", 2, 300, 4, 0), ("inf", 2, 200, 4, 0), ("random", 2, 300, 7, 0),
    ("random", 2, 1, 1, 0), ("random", 1, 2, 1, 0), ("grid", 2, 40, 1, 0),
    ("random", 1, 1, 31, 0), ("random", 2, 2, 31, 0),
    ("random", 1, 45, 31, 85400),  # streamed, S = 32: the scan in order, 8 frames a chunk
    ("grid", 2, 100, 31, 85400),
    ("grid", 1, 200, 9, 0),  # S = 10: the scan in order, 64 frames a chunk
])
def test_viterbi_source_plans(host_libs, kind, B, T, K, smem):
    """K8-cand's chain at either plan (streamed where the source is built
    with ``smem`` bytes of shared memory, ``SMALL_SMEM``), across chunks of
    the rings, at K = 1 and 31, T = 1 and 2, with exact ties and +-inf
    strengths (``candidate_case``): path and f0 identical."""
    lib = host_libs[f"viterbi@{smem}" if smem else "viterbi"]
    assert lib.viterbi_candidates_plan(T, K, 0) == (smem > 0)
    args = [torch.from_numpy(a) for a in candidate_case(kind, B, T, K, seed=T + K)]
    _check_viterbi(lib, *args)


@pytest.mark.parametrize("T,K,smem", [(300, 4, 0), (600, 4, 64000), (45, 31, 85400)])
def test_viterbi_source_chain(host_libs, T, K, smem):
    """The chain floor's entry (``viterbi_candidates_chain``) runs the
    recursion at either plan and writes nothing but f0[b, 0]."""
    lib = host_libs[f"viterbi@{smem}" if smem else "viterbi"]
    args = [torch.from_numpy(a) for a in candidate_case("random", 2, T, K, seed=T)]
    f0, path = _viterbi(lib, *args, entry="viterbi_candidates_chain")
    assert (path == -1).all() and f0[:, 1:].isnan().all() and f0[:, 0].isfinite().all()


@pytest.mark.parametrize("kind,B,T,ties,S", [
    ("pyin", 2, 24, False, 430), ("crepe", 2, 20, False, 360), ("pyin", 1, 1, False, 430),
    ("crepe", 1, 2, False, 360), ("pyin", 1, 12, True, 430), ("crepe", 1, 12, True, 360),
    ("flat", 2, 12, False, 430), ("edges", 1, 12, False, 430), ("random", 2, 12, False, 1),
    ("random", 2, 12, False, 33), ("random", 1, 12, False, 511)])
def test_viterbi_dense_source(host_libs, kind, B, T, ties, S):
    """K8 dense's cluster kernel (its blocks run at once, exchanging delta
    through each other's shared memory) at S = 430 (pYIN) and 360 (CREPE,
    with -inf bins and pad rows), and at S = 1, 33 and 511, which no
    cluster of 8 or 16 divides: the path identical to the plain version's; the
    ``ties`` cases tie in the recursion and in the final argmax, the
    ``flat`` one across the previous-state parts of the kernel, ``edges``
    in the final argmax across the cluster's blocks (``dense_case``)."""
    delta0, log_obs, log_A = dense_case(kind, B, T, seed=T, ties=ties, S=S)
    backptr = torch.empty(pitch.dense_backptr_shape(B, T, S), dtype=torch.int16)
    path = torch.full((B, T), -1, dtype=torch.int32)
    assert host_libs["viterbi_dense"].viterbi_dense(
        delta0.data_ptr(), log_obs.data_ptr(), log_A.data_ptr(), backptr.data_ptr(),
        path.data_ptr(), B, T, S, None) == 0
    ref = pitch.viterbi_dense_reference(delta0, log_obs, log_A)
    torch.testing.assert_close(path, ref, atol=0, rtol=0)


def test_viterbi_dense_plan_source(host_libs):
    """K8 dense's plan: each block's columns whole groups of 4, the fewest
    that 16 blocks need to cover S, and as many blocks (up to 16: the
    shim's GPC holds one such cluster) as own a column, so that every block
    of the cluster owns one; 8 lanes a column, each lane's previous states a
    multiple of 4 covering S, whole warps; -1 past 512 states."""
    lib = host_libs["viterbi_dense"]
    for S, C_want in ((1, 1), (33, 9), (360, 15), (430, 16), (511, 16), (512, 16)):
        C, P, K, threads = (lib.viterbi_dense_plan(S, w) for w in range(4))
        assert (C, P) == (C_want, 8) and K % 4 == 0 and P * K >= S > P * (K - 4)
        W = threads // P
        assert threads % 32 == 0 and W % 4 == 0 and 16 * W >= S > 16 * (W - 4)
        assert C * W >= S > (C - 1) * W
        assert lib.viterbi_dense_plan(S, 4) >= 1 and lib.viterbi_dense_plan(S, 5) == -1
    assert lib.viterbi_dense_plan(513, 0) == -1


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F",
    # 4 frames cover a sample (hop divides n_fft), 3 (hop 27 and 100, which
    # do not), a short scale with an odd frame count; Bluestein at 1933,
    # 2299 and 1149 (odd F), and 4096 / 540 / 2160 (dynamic shared memory)
    [(1, 64, 64, 16, 9), (2, 64, 48, 27, 6), (1, 256, 200, 100, 4),
     (1, 1933, 1933, 512, 3), (1, 2299, 2299, 512, 4), (2, 1149, 1149, 300, 5),
     (1, 4096, 2160, 540, 5)],
)
def test_stft_backward_source(host_libs, B, n_fft, win, hop, F):
    """K5 in training: the forward <= 1e-5 of the largest magnitude; the
    backward (the spectrum recomputed from the signal) <= 1e-5 of the
    gradient's scale, every sample written."""
    gen = torch.Generator().manual_seed(n_fft + hop)
    T_pad = n_fft + (F - 1) * hop + hop // 2
    y = rn(gen, B, T_pad, scale=0.3)
    plan, L = _k5(n_fft, win)
    bins = n_fft // 2 + 1
    lib = host_libs["stft"]
    mag = torch.empty(B, bins, F)
    assert lib.stft_magnitude(y.data_ptr(), *mel._pointers(plan), mag.data_ptr(), B,
                              T_pad, n_fft, L, hop, F, None) == 0
    ref_mag = mel.stft_magnitude_reference(y, n_fft, hop, win)
    assert (mag - ref_mag).abs().max().item() <= 1e-5 * ref_mag.abs().max().item()
    g = rn(gen, B, bins, F)
    frames = torch.full((B, F, n_fft), float("nan"))
    grad = torch.full((B, T_pad), float("nan"))
    plan64 = mel._pointers(_k5(n_fft, win, double=True)[0])
    assert lib.stft_backward(g.data_ptr(), y.data_ptr(), *plan64, frames.data_ptr(),
                             grad.data_ptr(), B, T_pad, n_fft, L, hop, F, None) == 0
    ref = mel.stft_backward_reference(g, y, n_fft, hop, win)
    assert (grad - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("n_fft,hop,F", QUIET_CASES)
def test_stft_source_near_silence(host_libs, n_fft, hop, F):
    """K5 where a quiet frame pairs with a loud one: every frame's
    magnitudes within 1e-5 of that frame's own peak of the plain version's,
    the exact forward's every magnitude within 1e-6 of its own value, and
    the backward within 1e-5 of the gradient's scale."""
    y, g = quiet_case(n_fft, hop, F, n_fft)
    plan, L = _k5(n_fft, n_fft)
    bins, T_pad = n_fft // 2 + 1, y.shape[1]
    lib = host_libs["stft"]
    mag = torch.empty(1, bins, F)
    assert lib.stft_magnitude(y.data_ptr(), *mel._pointers(plan), mag.data_ptr(), 1, T_pad,
                              n_fft, L, hop, F, None) == 0
    ref = mel.stft_magnitude_reference(y, n_fft, hop)
    peak = ref.abs().amax(dim=1, keepdim=True)  # each frame's own
    assert ((mag - ref).abs() / peak).max().item() <= 1e-5
    plan64 = mel._pointers(_k5(n_fft, n_fft, double=True)[0])
    assert lib.stft_magnitude_f64(y.data_ptr(), *plan64, mag.data_ptr(), 1, T_pad,
                                  n_fft, L, hop, F, None) == 0
    ref64 = mel.stft_magnitude_reference(y.double(), n_fft, hop)
    assert ((mag.double() - ref64).abs() / ref64).max().item() <= 1e-6
    frames, grad = torch.empty(1, F, n_fft), torch.empty(1, T_pad)
    assert lib.stft_backward(g.data_ptr(), y.data_ptr(), *plan64, frames.data_ptr(),
                             grad.data_ptr(), 1, T_pad, n_fft, L, hop, F, None) == 0
    ref_g = mel.stft_backward_reference(g, y, n_fft, hop)
    assert (grad - ref_g).abs().max().item() <= 1e-5 * ref_g.abs().max().item()


def _grouped(lib, transposed, x, w_packed, bias, T_out, stride, pad, groups):
    B, T_in, C_in = x.shape
    K, _, C_out = w_packed.shape
    out = torch.full((B, T_out, C_out), float("nan"))
    assert lib.grouped_conv1d(int(transposed), x.data_ptr(), w_packed.data_ptr(),
                              None if bias is None else bias.data_ptr(), out.data_ptr(),
                              B, T_in, T_out, C_in, C_out, K, stride, pad, groups,
                              None) == 0
    return out


@pytest.mark.parametrize(
    "C_in,C_out,groups,stride,T",
    # output widths a group (the transposed mode's are C_in / groups) of 8
    # (a single output-channel lane), 16, 32 and 64 at strides 1, 2 and 4;
    # MSD layer 1's (128 -> 128 in 4 groups: the 4 x 4 tile) and layer 2's
    # (128 -> 256 in 16: 16 wide, 8 in the transposed mode); 64 wide at
    # stride 1, 16 chunks of 4 channels through a 2-stage ring, 4 strips
    [(16, 16, 2, 2, 21), (32, 32, 2, 2, 19), (32, 64, 2, 1, 9), (64, 128, 2, 4, 30),
     (128, 128, 4, 2, 45), (128, 256, 16, 2, 40), (64, 64, 8, 4, 33), (128, 128, 2, 1, 26),
     (64, 128, 2, 2, 70)],
)
def test_grouped_conv1d_source(host_libs, C_in, C_out, groups, stride, T):
    """K6, k = 41: the forward against the plain grouped conv, the
    transposed mode on ``grouped_transposed_weight`` against the autograd
    input gradient of the plain version (T = 30 at stride 4: its last
    sample lies past ``conv_transpose1d``'s natural length): <= 1e-5 of the
    output's scale."""
    _check_grouped(host_libs["grouped_conv1d"], 1, C_in, C_out, groups, stride, T)


@pytest.mark.parametrize(
    "B,C_in,C_out,groups,stride,T",
    # 8 x 8 tiles: MSD layer 1's widths over lines of 1024 outputs (a
    # 2-stage ring of 256-thread blocks, where a 3-stage one holds 192),
    # and 64 wide a group at stride 1
    [(2, 128, 128, 4, 2, 2048), (8, 128, 128, 2, 1, 200)],
)
def test_grouped_conv1d_source_batched(host_libs, B, C_in, C_out, groups, stride, T):
    """K6 as ``test_grouped_conv1d_source`` at batch sizes and lengths that
    fill the emulated SMs with the 8 x 8 tile."""
    _check_grouped(host_libs["grouped_conv1d"], B, C_in, C_out, groups, stride, T)


def _check_grouped(lib, B, C_in, C_out, groups, stride, T):
    gen = torch.Generator().manual_seed(C_in + C_out + stride)
    K = 41
    x = rn(gen, B, T, C_in)
    w = rn(gen, C_out, C_in // groups, K, scale=(K * C_in / groups) ** -0.5)
    b = rn(gen, C_out)
    T_out = blocked_conv.grouped_out_len(T, stride)
    got = _grouped(lib, False, x, w.permute(2, 1, 0).contiguous(), b, T_out, stride,
                   K // 2, groups)
    ref = blocked_conv.grouped_conv1d_reference(x, w, b, stride, groups)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()

    dy = rn(gen, B, T_out, C_out)
    got = _grouped(lib, True, dy, blocked_conv.grouped_transposed_weight(w, stride, groups),
                   None, T, stride, K // 2, groups)
    xr = x.clone().requires_grad_()
    (ref,) = torch.autograd.grad(blocked_conv.grouped_conv1d_reference(xr, w, b, stride, groups),
                                 xr, dy)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def _wgrad1d(lib, a, bm, K, stride, dil, pad, groups, slope_a, slope_b, splits=None):
    """conv1d_wgrad through the host library with the planned number of
    reduction chunks, or ``splits``."""
    B, T_a, CA = a.shape
    T_b, CB = bm.shape[1:]
    if splits is None:
        splits = lib.conv1d_wgrad_splits(B, T_a, T_b, CA, CB, K, stride, dil, pad, groups)
    part = torch.empty(splits, K, CA // groups, CB)
    out = torch.full((K, CA // groups, CB), float("nan"))
    assert lib.conv1d_wgrad(a.data_ptr(), bm.data_ptr(), part.data_ptr(), out.data_ptr(),
                            B, T_a, T_b, CA, CB, K, stride, dil, pad, groups,
                            float(slope_a or 0.0), int(slope_a is not None),
                            float(slope_b or 0.0), int(slope_b is not None), splits,
                            None) == 0
    return out


@pytest.mark.parametrize(
    "B,T_a,CA,T_b,CB,K,stride,dil,pad,groups,slope_a,slope_b",
    [
        (2, 300, 8, 300, 16, 3, 1, 3, 3, 1, 0.1, None),     # resblock conv, 16 wide
        (2, 160, 8, 80, 32, 4, 2, 1, 1, 1, None, 0.1),      # transposed conv's, 32 wide
        (1, 90, 32, 45, 64, 41, 2, 1, 20, 4, None, None),   # K6 layer, 16 per group
        (2, 200, 16, 200, 1, 7, 1, 1, 3, 1, 0.01, None),    # conv_post, 1 wide
        (1, 50, 4, 50, 64, 5, 1, 1, 2, 1, None, None),      # 64 wide
        (2, 256, 1, 32, 24, 16, 8, 1, 4, 1, None, None),    # noise conv, C_in = 1
        (2, 300, 16, 300, 16, 11, 1, 5, 25, 1, 0.1, None),  # generator C = 16, dilation 5
        (2, 90, 128, 45, 128, 41, 2, 1, 20, 4, None, None),  # MSD layer 1: groups 4,
        #                                                      the 41 taps over 2 blocks
        (2, 60, 128, 30, 256, 41, 2, 1, 20, 16, None, None),  # MSD layer 2: groups 16
        (2, 70, 24, 70, 20, 7, 1, 1, 3, 1, 0.2, 0.1),       # both activations, ragged
        (1, 50, 6, 50, 10, 5, 1, 2, 4, 1, None, 0.3),       # widths no multiple of 4
        (2, 41 * 8, 32, 41, 48, 16, 8, 1, 4, 1, None, 0.1),  # transposed conv's, stride 8
        (2, 600, 32, 300, 32, 41, 2, 1, 20, 1, None, None),  # k = 41 in 2-tap groups over
        #                                                       3 blocks (the plan fills the SMs)
    ],
)
def test_conv1d_wgrad_source(host_libs, B, T_a, CA, T_b, CB, K, stride, dil, pad, groups,
                             slope_a, slope_b):
    """The weight gradient, partial sums over reduction chunks added in
    order: <= 1e-5 of its scale, with the planned chunks, with one, and
    with 7 (chunk boundaries inside a batch row)."""
    gen = torch.Generator().manual_seed(T_a + CB + K)
    a, bm = rn(gen, B, T_a, CA), rn(gen, B, T_b, CB)
    lib = host_libs["conv1d_wgrad"]
    ref = blocked_conv.conv1d_wgrad_reference(a, bm, K, stride, dil, pad, groups,
                                              slope_a, slope_b)
    for splits in (None, 1, 7):
        out = _wgrad1d(lib, a, bm, K, stride, dil, pad, groups, slope_a, slope_b, splits)
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item(), splits


def _at_offset(t):
    """A contiguous copy of ``t`` one float past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1)[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("kind", ["conv1d", "conv2d"])
def test_wgrad_source_unaligned(host_libs, kind):
    """The weight gradients on views that start off a 16-byte boundary
    take 4-byte copies into the same window layout: the result equals the
    aligned inputs' bit for bit (with the planned chunks and with 7)."""
    gen = torch.Generator().manual_seed(16)
    if kind == "conv1d":
        a, bm = rn(gen, 2, 300, 16), rn(gen, 2, 300, 16)
        lib = host_libs["conv1d_wgrad"]
        for splits in (None, 7):
            fn = lambda a_, bm_: _wgrad1d(lib, a_, bm_, 11, 1, 5, 25, 1, 0.1, None, splits)  # noqa: E731
            aligned = fn(a, bm)
            for a_, bm_ in ((_at_offset(a), bm), (a, _at_offset(bm))):
                assert torch.equal(fn(a_, bm_), aligned), splits
    else:
        x, gy = rn(gen, 2, 4, 17, 32), rn(gen, 2, 4, 9, 32)
        lib = host_libs["conv2d"]
        args = (2, 4, 17, 4, 9, 32, 32, 3, 9, 1, 2, 1, 4)
        for splits in (lib.conv2d_wgrad_splits(*args), 7):
            def fn(x_, gy_):
                part = torch.empty(splits, 3, 9, 32, 32)
                dw = torch.full((3, 9, 32, 32), float("nan"))
                assert lib.conv2d_wgrad(x_.data_ptr(), gy_.data_ptr(), part.data_ptr(),
                                        dw.data_ptr(), *args, splits, None) == 0
                return dw
            aligned = fn(x, gy)
            for x_, gy_ in ((_at_offset(x), gy), (x, _at_offset(gy))):
                assert torch.equal(fn(x_, gy_), aligned), splits


def _conv2d(lib, transposed, x, w_packed, bias, out_hw, stride, pad):
    B, H_in, W_in, C_in = x.shape
    KH, KW, _, C_out = w_packed.shape
    out = torch.full((B, *out_hw, C_out), float("nan"))
    assert lib.conv2d(int(transposed), x.data_ptr(), w_packed.data_ptr(),
                      None if bias is None else bias.data_ptr(), out.data_ptr(), B,
                      H_in, W_in, out_hw[0], out_hw[1], C_in, C_out, KH, KW, *stride,
                      *pad, None) == 0
    return out


@pytest.mark.parametrize(
    "C_in,C_out,k,stride,pad,H,W",
    # the MRD's layers: 0 (C_in 1), 1-3 (stride 2 in frequency), 4, conv_post
    # (C_out 1); W odd and even, so the transposed mode's classes are ragged;
    # the weight gradient's window is clipped on all four sides, and W = 150
    # gives three strips of output columns, the last past the edge
    [(1, 32, (3, 9), (1, 1), (1, 4), 5, 33), (32, 32, (3, 9), (1, 2), (1, 4), 4, 17),
     (32, 32, (3, 9), (1, 2), (1, 4), 3, 12), (32, 32, (3, 3), (1, 1), (1, 1), 4, 9),
     (32, 1, (3, 3), (1, 1), (1, 1), 6, 9), (32, 32, (3, 9), (1, 2), (1, 4), 3, 150),
     # the forward core's 2-D tiles: many short lines a block (H = 11 at W'
     # = 20), 12 channels (a chunk of 12, then 4-byte copies), C_in = C_out
     # = 1, 16 -> 8 at 3 x 3 with a ragged last line tile
     (32, 32, (3, 9), (1, 2), (1, 4), 11, 40), (12, 16, (3, 9), (1, 2), (1, 4), 4, 23),
     (1, 1, (3, 3), (1, 1), (1, 1), 5, 12), (16, 8, (3, 3), (1, 1), (1, 1), 13, 7),
     # the transposed mode's tiles: 8 x 8 over 12 short lines and two strips
     # (W = 150), 4 x 4 over three strips and two line tiles at odd W, 6
     # channels (4-byte copies), row padding 0 and 2 (the tap rows reversed
     # at padding KH - 1 - PH), a single output-channel lane
     (32, 32, (3, 9), (1, 2), (1, 4), 12, 150), (32, 32, (3, 9), (1, 2), (1, 4), 16, 65),
     (12, 6, (3, 9), (1, 2), (1, 4), 5, 19), (32, 16, (3, 9), (1, 2), (0, 4), 4, 25),
     (8, 8, (3, 9), (1, 2), (2, 4), 3, 14)],
)
def test_conv2d_source(host_libs, C_in, C_out, k, stride, pad, H, W):
    """K6 2-D: the direct mode against ``F.conv2d``, the input gradient
    (direct mode with flipped taps for stride 1, transposed mode for stride
    2) and the weight gradient (partial sums over chunks added in order;
    the planned chunks, one, and 7) against autograd of the plain version:
    <= 1e-5 of each one's scale."""
    gen = torch.Generator().manual_seed(C_in + C_out + W)
    lib = host_libs["conv2d"]
    x = rn(gen, 2, H, W, C_in)
    w = rn(gen, C_out, C_in, *k, scale=(C_in * k[0] * k[1]) ** -0.5)
    b = rn(gen, C_out)
    out_hw = tuple(blocked_conv.conv2d_out_size(n, kk, s, p)
                   for n, kk, s, p in zip((H, W), k, stride, pad))
    got = _conv2d(lib, False, x, w.permute(2, 3, 1, 0).contiguous(), b, out_hw, stride, pad)
    ref = blocked_conv.conv2d_nhwc_reference(x, w, b, stride, pad)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()

    gy = rn(gen, *ref.shape)
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    ref_dx, ref_dw = torch.autograd.grad(
        blocked_conv.conv2d_nhwc_reference(xr, wr, b, stride, pad), (xr, wr), gy)
    if stride == (1, 1):
        wp = w.flip(2, 3).permute(2, 3, 0, 1).contiguous()
        dx = _conv2d(lib, False, gy, wp, None, (H, W), (1, 1),
                     (k[0] - 1 - pad[0], k[1] - 1 - pad[1]))
    else:
        wp = torch.nn.functional.pad(w.permute(2, 3, 0, 1), (0, 0, 0, 0, 0, -k[1] % stride[1]))
        dx = _conv2d(lib, True, gy, wp.contiguous(), None, (H, W), stride, pad)
    assert (dx - ref_dx).abs().max().item() <= 1e-5 * ref_dx.abs().max().item()

    ref_dw = ref_dw.permute(2, 3, 1, 0)
    planned = lib.conv2d_wgrad_splits(2, H, W, *out_hw, C_in, C_out, *k, *stride, *pad)
    for splits in (planned, 1, 7):  # 7: chunk boundaries inside a row of frames
        part = torch.empty(splits, *k, C_in, C_out)
        dw = torch.full((*k, C_in, C_out), float("nan"))
        assert lib.conv2d_wgrad(x.data_ptr(), gy.contiguous().data_ptr(), part.data_ptr(),
                                dw.data_ptr(), 2, H, W, *out_hw, C_in, C_out, *k, *stride,
                                *pad, splits, None) == 0
        assert (dw - ref_dw).abs().max().item() <= 1e-5 * ref_dw.abs().max().item(), splits


def test_conv2d_source_transposed_takes_stride_1_in_h(host_libs):
    """The transposed mode runs stride 1 in H (every MRD layer's): a call
    with SH = 2 returns an error and writes nothing."""
    x, w = torch.zeros(1, 4, 5, 8), torch.zeros(2, 2, 8, 8)
    out = torch.full((1, 8, 10, 8), float("nan"))
    assert host_libs["conv2d"].conv2d(1, x.data_ptr(), w.data_ptr(), None, out.data_ptr(), 1, 4,
                                      5, 8, 10, 8, 8, 2, 2, 2, 2, 0, 0, None) != 0
    assert out.isnan().all()


def _istft_host(lib, re, im, n_fft, hop, win, center):
    """K5 istft's C entry on CPU tensors, with the tables and scratch its
    rule's plan reads (as ``mel._istft``)."""
    B, _, F = re.shape
    offset = n_fft // 2 if center else 0
    n_out = n_fft + hop * (F - 1) - 2 * offset
    which = mel.ISTFT_PLANS[lib.istft_plan(n_fft, hop, F)]
    tables = mel._fft_plan(n_fft, win, "cpu", double=which == "split")
    scratch, L1 = [None] * 3, 0
    if which in ("fft", "split"):
        scratch[2] = torch.empty(B, F, n_fft)
    if which == "split":
        L = mel._fft_size(n_fft)
        L1, pairs = mel._split(L), B * ((F + 1) // 2)
        scratch[:2] = [torch.empty(pairs, L, 2, dtype=torch.float64),
                       torch.empty(pairs, 2, dtype=torch.float64)]
    out = torch.full((B, n_out), float("nan"))
    assert lib.istft(re.data_ptr(), im.data_ptr(), *mel._pointers(tables),
                     mel._istft_envelope(n_fft, hop, win, F, "cpu").data_ptr(),
                     *mel._pointers(scratch), out.data_ptr(), B, F, n_fft, hop, L1, n_out,
                     offset, None) == 0
    return out


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F,center,smem,plan,quiet",
    # the direct plan: iSTFTNet's shape, a window shorter than n_fft
    # without the trim (4 frames over a sample), the rule's last size (32),
    # an odd frame count (its halo), a hop that is not a multiple of 4 (a
    # sample a thread, by divisions); the FFT plan: twice the threshold
    # (64), a hop that does not divide n_fft (3 frames over some samples, 2
    # over others), n_fft 2048 (1025 bins, 4 frames a sample), Bluestein
    # (100, hop 25; 48; an odd n_fft, 99, with no Nyquist bin); odd frame
    # counts (the last frame pairs with zeros); every other frame at 1e-6
    # of its pair's (quiet); the split path's four-step FFTs at L1 = 16,
    # reached by the source built with 4 KB of shared memory a block
    [(2, 16, 16, 8, 30, True, 0, "direct", False),
     (1, 16, 12, 4, 20, False, 0, "direct", False),
     (1, 32, 32, 16, 9, True, 0, "direct", False),
     (2, 16, 16, 8, 131, True, 0, "direct", True),
     (1, 16, 16, 6, 23, True, 0, "direct", False),
     (1, 64, 64, 16, 9, True, 0, "fft", False), (1, 64, 48, 27, 7, True, 0, "fft", False),
     (1, 2048, 2048, 512, 3, True, 0, "fft", False),
     (1, 2048, 2048, 512, 7, True, 0, "fft", True),
     (2, 100, 100, 25, 9, True, 0, "fft", False), (1, 100, 80, 25, 8, False, 0, "fft", True),
     (1, 48, 48, 12, 21, True, 0, "fft", True), (1, 99, 99, 33, 9, True, 0, "fft", False),
     (1, 256, 200, 64, 5, True, 4096, "split", True),
     (1, 100, 100, 25, 7, False, 4096, "split", False)],
)
def test_istft_source(host_libs, B, n_fft, win, hop, F, center, smem, plan, quiet):
    """K5 istft in the plan its rule picks: every output sample within 1e-5
    of its own scale (``istft_scale``: the covering frames' bounds), and
    within 1e-5 of the output's largest value, against the plain version."""
    lib = host_libs[f"istft@{smem}" if smem else "istft"]
    assert mel.ISTFT_PLANS[lib.istft_plan(n_fft, hop, F)] == plan
    gen = torch.Generator().manual_seed(n_fft + hop + F)
    bins = n_fft // 2 + 1
    re, im = rn(gen, B, bins, F), rn(gen, B, bins, F)
    if quiet:
        re[..., 1::2] *= 1e-6
        im[..., 1::2] *= 1e-6
    out = _istft_host(lib, re, im, n_fft, hop, win, center)
    ref = mel.istft_reference(re, im, n_fft, hop, win, center)
    assert ref.shape == out.shape
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    scale = istft_scale(re, im, n_fft, hop) if center else None
    if scale is not None:
        assert ((out - ref).abs() <= 1e-5 * scale).all()


def test_istft_plan_source(host_libs):
    """K5 istft's rule: direct at n_fft 16 and 32 (iSTFTNet's 16; any
    hop), the FFT core from 64 while shared memory holds the transform and
    the staged spectra (Bluestein sizes too), the split path past it (and
    sooner where the source is built with less shared memory); the entry
    refuses a size no plan takes and a plan's missing tables."""
    lib = host_libs["istft"]
    plan = lambda n, h, F=100: lib.istft_plan(n, h, F)  # noqa: E731
    assert [plan(16, 8), plan(16, 1), plan(32, 16), plan(32, 5)] == [0, 0, 0, 0]
    assert [plan(24, 8), plan(64, 16), plan(65, 16), plan(128, 32)] == [1, 1, 1, 1]
    assert [plan(2048, 512), plan(2299, 512), plan(8192, 2048)] == [1, 1, 1]
    assert [plan(16384, 4096), plan(9000, 2000), plan(1 << 21, 1 << 19)] == [2, 2, 2]
    assert plan(5000, 1000) == 1 and plan(8191, 2048) == 2  # Bluestein's L = 16384
    assert plan((1 << 21) + 1, 1 << 19) == -1 and plan(16, 8, 0) == -1
    small = host_libs["istft@4096"]
    assert [small.istft_plan(n, n // 4, 9) for n in (16, 64, 100, 256)] == [1, 1, 2, 2]
    none = [None] * 11
    assert lib.istft(*none, 1, 4, (1 << 21) + 1, 1 << 19, 0, 100, 0, None) != 0
    assert lib.istft(*none, 1, 0, 64, 16, 0, 100, 0, None) != 0
    assert lib.istft(*none, 1, 4, 64, 16, 0, 100, 0, None) != 0  # no window, tables, scratch


def _maximum_path(lib, values, t_ys, t_xs, entry="maximum_path"):
    """K7's C entry ``entry`` on a path filled with 7s (every cell must be
    written)."""
    B, T_y, T_x = values.shape
    per_item = lib.maximum_path_plan(T_y, T_x, 3)
    scratch = torch.zeros(max(B * per_item, 1), dtype=torch.uint8)
    path = torch.full((B, T_y, T_x), 7, dtype=torch.int32)
    assert getattr(lib, entry)(values.data_ptr(), t_ys.data_ptr(), t_xs.data_ptr(),
                               scratch.data_ptr(), path.data_ptr(), B, T_y, T_x, None) == 0
    return path


@pytest.mark.parametrize("kind,seed", ALIGN_CASES)
def test_maximum_path_source(host_libs, kind, seed):
    """K7 on the parity test's cases (random values, exact ties, a flat
    grid; t_x = t_y, t_x = 1, the full grid): paths identical to the plain
    version and to ``maximum_path_numpy``."""
    values, t_ys, t_xs = (torch.from_numpy(a) for a in align_case(kind, seed))
    got = _maximum_path(host_libs["monotonic_align"], values, t_ys, t_xs)
    torch.testing.assert_close(got, ma.maximum_path_reference(values, t_ys, t_xs),
                               atol=0, rtol=0)
    np.testing.assert_array_equal(
        got.numpy(), ma.maximum_path_numpy(values.numpy(), t_ys.numpy(), t_xs.numpy()))


@pytest.mark.parametrize("T_y,T_x", [(320, 300), (1150, 1100)])
def test_maximum_path_source_wide(host_libs, T_y, T_x):
    """K7 at wide strips (300: 11 columns a lane; 1100: 39 columns a lane,
    8 bytes of decisions a row, past shared memory: the streamed plan),
    integer values (ties), the path through every column: identical to the
    plain version."""
    gen = torch.Generator().manual_seed(T_x)
    values = torch.randint(0, 3, (1, T_y, T_x), generator=gen).float()
    t_ys = torch.tensor([T_y], dtype=torch.int32)
    t_xs = torch.tensor([T_x], dtype=torch.int32)
    got = _maximum_path(host_libs["monotonic_align"], values, t_ys, t_xs)
    torch.testing.assert_close(got, ma.maximum_path_reference(values, t_ys, t_xs),
                               atol=0, rtol=0)


@pytest.mark.parametrize("B,T_y,T_x,smem", [
    (2, 700, 90, 83000),  # streamed: 3 columns a lane, a byte of decisions a row, 6 chunks
    (2, 300, 300, 83000),  # streamed: 11 columns a lane, 2 bytes a row, 5 chunks of 64 rows
    (2, 700, 40, 0), (3, 200, 50, 0), (2, 64, 64, 0), (1, 1, 5, 0), (2, 5, 1, 0),
    (2, 40, 700, 0),  # 23 columns a lane, 4 bytes a row, 5 rows a value slot
])
def test_maximum_path_source_plans(host_libs, B, T_y, T_x, smem):
    """K7 at either plan (streamed where the source is built with ``smem``
    bytes of shared memory, ``SMALL_SMEM``), over the whole grid, t_x =
    t_y, t_x = 1 and drawn lengths, T_y = 1 and T_x = 1, integer values
    (ties; ``align_wide_case``): identical to the plain version."""
    lib = host_libs[f"monotonic_align@{smem}" if smem else "monotonic_align"]
    assert lib.maximum_path_plan(T_y, T_x, 0) == (smem > 0)
    values, t_ys, t_xs = (torch.from_numpy(a) for a in align_wide_case(B, T_y, T_x, seed=T_y))
    got = _maximum_path(lib, values, t_ys, t_xs)
    torch.testing.assert_close(got, ma.maximum_path_reference(values, t_ys, t_xs),
                               atol=0, rtol=0)


@pytest.mark.parametrize("T_y,T_x,smem", [(200, 50, 0), (300, 300, 83000)])
def test_maximum_path_source_chain(host_libs, T_y, T_x, smem):
    """The chain floor's entry (``maximum_path_chain``) runs the DP at
    either plan and writes nothing but path[b, 0, 0]."""
    lib = host_libs[f"monotonic_align@{smem}" if smem else "monotonic_align"]
    values, t_ys, t_xs = (torch.from_numpy(a) for a in align_wide_case(2, T_y, T_x, seed=T_y))
    got = _maximum_path(lib, values, t_ys, t_xs, entry="maximum_path_chain")
    assert (got.flatten(1)[:, 1:] == 7).all()


@pytest.mark.parametrize("T_y,T_x,plan", [(10, 2016, 63), (10, 2017, -1), (75704, 2016, 1),
                                          (75705, 2016, -1), (107192, 1, 1), (107193, 1, -1)])
def test_maximum_path_source_refuses_wide_rows(host_libs, T_y, T_x, plan):
    """Past 2016 text positions (63 columns a lane of one warp), or past the
    rows whose 2-byte indices fit in shared memory beside the rings (75,704
    at 2016 positions, 107,192 at one), the plan refuses and the C entry
    returns an error; the sizes below are taken (field 1: columns a lane,
    field 0: streamed)."""
    lib = host_libs["monotonic_align"]
    assert lib.maximum_path_plan(T_y, T_x, 1 if T_y == 10 else 0) == plan
    if plan < 0:
        assert lib.maximum_path(None, None, None, None, None, 1, T_y, T_x, None) != 0


def _dwconv7_norm(lib, x, step, cond, mask, k, b, ln_scale, ln_bias, d):
    B, T, C = x.shape
    out = torch.full_like(x, float("nan"))
    assert lib.depthwise_conv7_norm(
        x.data_ptr(), step.data_ptr(), cond.data_ptr(),
        None if mask is None else mask.data_ptr(), k.data_ptr(), b.data_ptr(),
        ln_scale.data_ptr(), ln_bias.data_ptr(), out.data_ptr(), B, T, C, d,
        convnext.LN_EPS, None) == 0
    return out


@pytest.mark.parametrize("C", [8, 24, 64])
@pytest.mark.parametrize("T", [5, 37, 130])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_convnext_block_source(host_libs, C, T, d):
    """K10 with and without a mask: residue classes of one row to 17 rows
    (one tile of 16 and a ragged second), T shorter than the halo, C below,
    between and above the threads' stride over channels: <= 1e-5 of the
    plain version's scale, every row written, a rerun bit-equal."""
    lib = host_libs["convnext_block"]
    for masked in (False, True):
        args = convnext_case(2, T, C, T * C + d, masked)
        got = _dwconv7_norm(lib, *args, d)
        ref = convnext.depthwise_conv7_norm_reference(*args, d)
        assert torch.isfinite(got).all()
        err = (got - ref).abs().max().item()
        assert err <= 1e-5 * ref.abs().max().item(), (masked, err)
        assert torch.equal(got, _dwconv7_norm(lib, *args, d))


def test_convnext_block_source_wide_and_padded(host_libs):
    """K10 past one channel per thread (C = 300 > 256 threads) and with a
    zero conv bias, as at init: a padded row whose taps all lie in padding
    has h = 0 and variance 0, and gives the ln bias exactly (not NaN)."""
    lib = host_libs["convnext_block"]
    x, step, cond, mask, k, b, ln_scale, ln_bias = convnext_case(3, 70, 300, 1, True,
                                                                 zero_bias=True)
    got = _dwconv7_norm(lib, x, step, cond, mask, k, b, ln_scale, ln_bias, 4)
    ref = convnext.depthwise_conv7_norm_reference(x, step, cond, mask, k, b, ln_scale,
                                                  ln_bias, 4)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    # rows whose 7 taps at dilation 4 (t - 12 .. t + 12) all read padding
    rows = [(bi, t) for bi in range(3) for t in range(70)
            if all(t + o < 0 or t + o >= 70 or mask[bi, t + o] for o in range(-12, 13))]
    assert rows
    for bi, t in rows:
        assert torch.equal(got[bi, t], ln_bias), (bi, t)


def _dwconv7_norm_backward(lib, go, x, step, cond, mask, k, b, ln_scale, d):
    """K10's backward as the wrapper launches it -> (dx, dstep, dcond, dk,
    db, dln_scale, dln_bias); the slots and the outputs start as NaN."""
    B, T, C = x.shape
    n_slots = lib.depthwise_conv7_norm_backward_slots(B, T, C, d)
    assert n_slots > 0
    slots = torch.full((n_slots, 11, C), float("nan"))
    grads = torch.full((10 + B, C), float("nan"))
    dy = torch.full_like(x, float("nan"))
    assert lib.depthwise_conv7_norm_backward(
        go.data_ptr(), x.data_ptr(), step.data_ptr(), cond.data_ptr(),
        None if mask is None else mask.data_ptr(), k.data_ptr(), b.data_ptr(),
        ln_scale.data_ptr(), dy.data_ptr(), slots.data_ptr(), grads.data_ptr(), B, T, C, d,
        convnext.LN_EPS, None) == 0
    return dy, grads[10:], dy, grads[:7], grads[7], grads[8], grads[9]


def _check_k10_backward(lib, args, d, seed):
    go = torch.randn(args[0].shape, generator=torch.Generator().manual_seed(seed))
    got = _dwconv7_norm_backward(lib, go, *args[:-1], d)
    ref = convnext.depthwise_conv7_norm_backward_reference(go, *args, d)
    for name, g, r in zip(("dx", "dstep", "dcond", "dk", "db", "dln_scale", "dln_bias"),
                          got, ref):
        assert torch.isfinite(g).all(), name
        err = (g - r).abs().max().item()
        assert err <= 1e-5 * r.abs().max().item(), (name, err)
    again = _dwconv7_norm_backward(lib, go, *args[:-1], d)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _segments(lib, B, T, C, d):
    """The segments a class of K10's backward: its slots over B x classes."""
    return lib.depthwise_conv7_norm_backward_slots(B, T, C, d) // (B * min(d, T))


@pytest.mark.parametrize("T", [5, 37, 130])
@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_convnext_backward_source(host_libs, T, d):
    """K10's backward, one kernel and its slots' sum, with and without a
    mask (go nonzero at padded rows): classes of one row to 130 rows, T
    shorter than the halo, classes in one segment or several (on the
    shim's 8 SMs x 2 blocks: T=130 at d = 1 in segments of 17 rows, the
    last of 11): every gradient <= 1e-5 of the plain backward's scale, a
    rerun bit-equal."""
    lib = host_libs["convnext_block"]
    for masked in (False, True):
        _check_k10_backward(lib, convnext_case(2, T, 24, T * 3 + d, masked), d, T + d)


@pytest.mark.parametrize("B,T,d,C", [(2, 130, 1, 40), (1, 300, 8, 41), (1, 77, 1, 41),
                                     (1, 410, 8, 40)])
def test_convnext_backward_source_segments(host_libs, B, T, d, C):
    """K10's backward where a class spans several segments with a ragged
    last one (the rule's segments at these shapes, on the shim's 8 SMs), at
    d = 1 and 8, with and without a mask, C past one warp of 2 channels a
    thread, even (8-byte pairs) and odd (one by one): <= 1e-5 of scale, a
    rerun bit-equal."""
    lib = host_libs["convnext_block"]
    S = _segments(lib, B, T, C, d)
    rows = [(T - r + d - 1) // d for r in range(min(d, T))]
    L = -(-rows[0] // S)
    assert S > 1 and any(n % L for n in rows), (S, L, rows)  # several segments, some ragged
    for masked in (False, True):
        _check_k10_backward(lib, convnext_case(B, T, C, B * T + d, masked), d, T - d)


def test_convnext_backward_source_wide_and_padded(host_libs):
    """K10's backward past one warp of channels a block (C = 300: 160
    threads, 2 channels each, the last warp part idle) with a zero conv
    bias: padded rows of variance 0 (r = 1000) with a nonzero go."""
    lib = host_libs["convnext_block"]
    args = convnext_case(3, 70, 300, 1, True, zero_bias=True)
    _check_k10_backward(lib, args, 4, 2)


def test_convnext_backward_source_four_channels_a_thread(host_libs):
    """K10's backward past 1024 channels, where the plan holds 4 channels a
    thread (C = 1100: 288 threads, the last warp part idle), with a mask:
    <= 1e-5 of scale, a rerun bit-equal."""
    lib = host_libs["convnext_block"]
    _check_k10_backward(lib, convnext_case(2, 24, 1100, 5, True), 2, 3)
