"""The CUDA sources of K1, K4, K5 and K8-cand, compiled for the host CPU
and run against their plain PyTorch versions at small shapes.

The card is the real test (``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py``),
but the kernels' tiling, halos, masks and epilogues are plain C++ over
``threadIdx``/``blockIdx``. A small shim makes them host code: ``__shared__``
arrays become function statics (blocks run one after another), each
block's threads run as ``std::thread``s meeting at a ``std::barrier`` for
``__syncthreads``, and ``kernel<<<grid, block, smem, stream>>>(...)``
becomes a call that runs the grid. The shim covers what the sources use
(no warp intrinsics, PTX or tensor-core instructions). Needs ``g++``
with C++20; skips without one.
"""

import ctypes
import re
import shutil
import subprocess

import pytest
import torch

from fish_diffusion_tpu_torch import kernels
from fish_diffusion_tpu_torch.extractors import pitch
from fish_diffusion_tpu_torch.models import wavenet
from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan
from fish_diffusion_tpu_torch.ops import mel

SHIM = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <math.h>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
struct alignas(16) float4 { float x, y, z, w; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local std::barrier<>* g_barrier;
inline void __syncthreads() { g_barrier->arrive_and_wait(); }
// round-to-nearest arithmetic that nvcc never contracts into an FMA (g++
// in ISO C++ mode does not contract either)
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount };
inline int cudaGetLastError() { return 0; }
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
// 8 SMs: small grids then reach every tile shape K1 chooses from
inline int cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) { *v = 8; return 0; }
template <class T> int cudaFuncSetAttribute(T, cudaFuncAttribute, int) { return 0; }
struct __nv_bfloat16 { uint16_t v; };
inline float __bfloat162float(__nv_bfloat16 b) {
  uint32_t u = (uint32_t)b.v << 16; float f; std::memcpy(&f, &u, 4); return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  uint32_t u; std::memcpy(&u, &f, 4); u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
inline std::vector<float> g_dynamic_smem(1 << 20);
// One host thread per CUDA thread of a block; they walk the grid's blocks
// in order and meet at the barrier after each block, so the statics that
// stand for shared memory serve one block at a time.
template <class F> void run_grid(dim3 grid, dim3 block, size_t smem, F body) {
  if (smem > 232448) throw 1;
  const unsigned n = block.x * block.y * block.z;
  std::barrier<> bar(n);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < n; ++t)
    threads.emplace_back([&, t] {
      threadIdx = dim3(t);
      g_barrier = &bar;
      for (unsigned z = 0; z < grid.z; ++z)
        for (unsigned y = 0; y < grid.y; ++y)
          for (unsigned x = 0; x < grid.x; ++x) {
            blockIdx = dim3(x, y, z);
            body();
            bar.arrive_and_wait();
          }
    });
  for (auto& th : threads) th.join();
}
"""

_LAUNCH = re.compile(r"([A-Za-z_]\w*(?:<[^<>;]*>)?)<<<(.*?)>>>\((.*?)\);", re.S)


def _host_source(cu: str) -> str:
    src = cu.replace("#include <cuda_runtime.h>", '#include "shim.h"')
    src = src.replace("#include <cuda_bf16.h>", "")
    src = src.replace("extern __shared__ float smem[];",
                      "float* smem = g_dynamic_smem.data();")

    def launch(m):
        grid, block, smem = (p.strip() for p in m.group(2).split(",")[:3])
        return (f"run_grid(dim3({grid}), dim3({block}), {smem}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    return _LAUNCH.sub(launch, src)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the CUDA sources for the host")
    out = tmp_path_factory.mktemp("csrc")
    (out / "shim.h").write_text(SHIM)
    libs = {}
    for name, signature in kernels.SIGNATURES.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(_host_source((kernels.CSRC / f"{name}.cu").read_text()))
        so = out / f"lib{name}.so"
        subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                        f"-I{out}", "-o", str(so), str(cpp)], check=True,
                       capture_output=True, timeout=600)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in signature.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def rn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen) * scale


@pytest.mark.parametrize(
    "B,T,R,d,dtype",
    # with 8 SMs the rows M = B*T and R pick the tile: 64x32 (M=300,
    # R=64), 128x64 (M=300, R=256), 32x32 (M=51)
    [
        (2, 150, 64, 1, torch.float32),
        (2, 150, 64, 1, torch.bfloat16),
        (1, 300, 256, 8, torch.float32),
        (3, 17, 64, 4, torch.float32),
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
    g, x_out, skip_out = (torch.empty_like(x) for _ in range(3))
    assert lib.wavenet_gate(code, x.data_ptr(), step.data_ptr(), w_conv.data_ptr(),
                            b_conv.data_ptr(), cond.data_ptr(), g.data_ptr(),
                            B, T, R, R, d, None) == 0
    assert lib.wavenet_out(code, g.data_ptr(), w_out.data_ptr(), b_out.data_ptr(),
                           x.data_ptr(), skip.data_ptr(), x_out.data_ptr(),
                           skip_out.data_ptr(), B, T, R, None) == 0
    ref_x, ref_skip = wavenet.residual_block_reference(
        x, skip, step, cond, w_conv, b_conv, w_out, b_out, d
    )
    tol = 1e-4 if dtype == torch.float32 else 0.125
    for got, ref in ((x_out, ref_x), (skip_out, ref_skip)):
        assert (got.float() - ref.float()).abs().max().item() <= tol


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


@pytest.mark.parametrize("C_in,C_out,K,u", [(96, 48, 16, 8), (32, 16, 4, 2), (4, 2, 4, 2)])
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


@pytest.mark.parametrize(
    "B,n_fft,win,hop,F,tile",
    # with 8 SMs the rows M = B * F and the bins pick the tile: 128 x 64
    # (n_fft 2048 and 2299), 64 x 32 (n_fft 300), 32 x 32 (n_fft 64)
    [(1, 2048, 2048, 512, 5, 128), (2, 2299, 2299, 512, 3, 128),
     (2, 300, 240, 75, 40, 64), (1, 64, 48, 16, 10, 32)],
)
def test_stft_source(host_libs, B, n_fft, win, hop, F, tile):
    """K5: <= 1e-5 relative to the largest magnitude (sums of n_fft
    products in another order); n_fft 2299 and 300 are not powers of two."""
    gen = torch.Generator().manual_seed(n_fft + F)
    y = rn(gen, B, n_fft + (F - 1) * hop + hop // 3, scale=0.3)
    basis = mel._dft_basis(n_fft, win, "cpu")
    bins = n_fft // 2 + 1
    assert host_libs["stft"].stft_tile(B * F, bins) == tile
    out = torch.full((B, bins, F), float("nan"))
    assert host_libs["stft"].stft_magnitude(
        y.data_ptr(), basis.data_ptr(), out.data_ptr(), B, y.shape[1], n_fft,
        hop, bins, F, None) == 0
    ref = mel.stft_magnitude_reference(y, basis, hop)
    assert ref.shape == out.shape
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


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


def _check_viterbi(lib, freqs, strengths, unvoiced):
    B, T, K = freqs.shape
    backptr = torch.empty((B, max(T - 1, 1), K + 1), dtype=torch.int32)
    path = torch.full((B, T), -1, dtype=torch.int32)
    f0 = torch.full((B, T), float("nan"))
    assert lib.viterbi_candidates(freqs.data_ptr(), strengths.data_ptr(),
                                  unvoiced.data_ptr(), backptr.data_ptr(),
                                  path.data_ptr(), f0.data_ptr(), B, T, K, None) == 0
    ref_f0, ref_path = pitch.viterbi_candidates_reference(freqs, strengths, unvoiced)
    torch.testing.assert_close(path, ref_path, atol=0, rtol=0)
    torch.testing.assert_close(f0, ref_f0, atol=0, rtol=0)
    return path
