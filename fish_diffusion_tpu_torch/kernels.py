"""The port's hand-written Hopper kernels: building, binding, launch counts.

CUDA sources live in ``csrc/`` and are compiled at first use with ``nvcc``
for ``sm_90a`` into ``build/kernels/`` at the root of the checkout, as
shared libraries with a plain C interface, and bound with ``ctypes``
(``build_all`` starts one ``nvcc`` per source, all at once). Every
pointer and the stream go through ``ctypes.c_void_p``; each C entry returns
``cudaGetLastError()``, and ``check`` raises if it is not 0. The Triton
kernels are built by their own modules, inside the functions that launch
them.

Each kernel wrapper adds one to ``LAUNCHES[name]`` where it launches its
kernel and nowhere else, so that a run can show which kernels the main path
went through. Where one call's C entry launches more than one kernel (K5's
backward and its split paths, K5 istft's FFT and split plans, K3's
backward with its partial sums' kernel), the wrapper adds one a call:
such a count is of calls. ``KERNELS`` describes
each kernel for reports.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_TPU = "fish_diffusion_tpu/"
_PORT = "fish_diffusion_tpu_torch/"
KERNELS = {
    "wavenet_gate": dict(
        id="K1", route="cuda", source=_PORT + "csrc/wavenet_block.cu",
        replaces=_TPU + "models/wavenet.py:59",
    ),
    "wavenet_out": dict(
        id="K1", route="cuda", source=_PORT + "csrc/wavenet_block.cu",
        replaces=_TPU + "models/wavenet.py:59",
    ),
    "wavenet_gate_train": dict(
        id="K1 train", route="cuda", source=_PORT + "csrc/wavenet_block.cu",
        replaces=_TPU + "models/wavenet.py:59",
    ),
    # XLA's derivative of ResidualBlock.__call__ and models/common.py:103
    # DilatedConvK3
    "wavenet_gate_backward": dict(
        id="K1 bwd", route="cuda", source=_PORT + "csrc/wavenet_block.cu",
        replaces=_TPU + "models/wavenet.py:59",
    ),
    "wavenet_input_backward": dict(
        id="K1 bwd", route="cuda", source=_PORT + "csrc/wavenet_block.cu",
        replaces=_TPU + "models/common.py:103",
    ),
    "wavenet_weight_grad": dict(
        id="K1 dW", route="cuda", source=_PORT + "csrc/wavenet_block.cu",
        replaces=_TPU + "models/wavenet.py:59",
    ),
    # the weights' TF32 split that the 3xTF32 wgmma kernels above read
    # (no TPU kernel does this; listed under the block they serve)
    "wavenet_weight_split": dict(
        id="K1 split", route="cuda", source=_PORT + "csrc/wavenet_block.cu",
        replaces=_TPU + "models/wavenet.py:59",
    ),
    "unipc_predict": dict(
        id="K2", route="triton", source=_PORT + "models/diffusion.py",
        replaces=_TPU + "models/diffusion.py:462",
    ),
    "unipc_correct": dict(
        id="K2", route="triton", source=_PORT + "models/diffusion.py",
        replaces=_TPU + "models/diffusion.py:462",
    ),
    # with the frame-phase scan, source.py:77 blocked_phase, inside (as in
    # nsf_merge_backward, sine_merge and comb_merge)
    "nsf_merge": dict(
        id="K3", route="cuda", source=_PORT + "csrc/nsf_source.cu",
        replaces=_TPU + "models/vocoders/source.py:92",
    ),
    "conv1d": dict(
        id="K4", route="cuda", source=_PORT + "csrc/conv_fwd.cuh",
        replaces=_TPU + "ops/blocked_conv.py:84",
    ),
    "conv_transpose1d": dict(
        id="K4", route="cuda", source=_PORT + "csrc/conv_fwd.cuh",
        replaces=_TPU + "models/vocoders/nsf_hifigan.py:359",
    ),
    "plms_update": dict(
        id="K2", route="triton", source=_PORT + "models/diffusion.py",
        replaces=_TPU + "models/diffusion.py:395",
    ),
    "ddpm_update": dict(
        id="K2", route="triton", source=_PORT + "models/diffusion.py",
        replaces=_TPU + "models/diffusion.py:366",
    ),
    "stft_magnitude": dict(
        id="K5", route="cuda", source=_PORT + "csrc/stft.cu",
        replaces=_TPU + "ops/mel.py:136",
    ),
    "viterbi_candidates": dict(
        id="K8", route="cuda", source=_PORT + "csrc/viterbi.cu",
        replaces=_TPU + "extractors/pitch.py:277",
    ),
    "stft_backward": dict(
        id="K5", route="cuda", source=_PORT + "csrc/stft.cu",
        replaces=_TPU + "ops/mel.py:184",
    ),
    "grouped_conv1d": dict(
        id="K6", route="cuda", source=_PORT + "csrc/conv_fwd.cuh",
        replaces=_TPU + "ops/blocked_conv.py:137",
    ),
    "conv1d_wgrad": dict(
        id="K4/K6", route="cuda", source=_PORT + "csrc/wgrad.cuh",
        replaces=_TPU + "ops/blocked_conv.py:84",
    ),
    "nsf_merge_backward": dict(
        id="K3", route="cuda", source=_PORT + "csrc/nsf_source.cu",
        replaces=_TPU + "models/vocoders/source.py:92",
    ),
    "conv2d": dict(
        id="K6 2-D", route="cuda", source=_PORT + "csrc/conv_fwd.cuh",
        replaces=_TPU + "ops/blocked_conv.py:99",
    ),
    "conv2d_transposed": dict(
        id="K6 2-D", route="cuda", source=_PORT + "csrc/conv_fwd.cuh",
        replaces=_TPU + "ops/blocked_conv.py:99",
    ),
    "conv2d_wgrad": dict(
        id="K6 2-D", route="cuda", source=_PORT + "csrc/wgrad.cuh",
        replaces=_TPU + "ops/blocked_conv.py:99",
    ),
    "comb_merge": dict(
        id="K9", route="cuda", source=_PORT + "csrc/nsf_source.cu",
        replaces=_TPU + "models/vocoders/source.py:172",
    ),
    "pyin_viterbi": dict(
        id="K8 pYIN", route="cuda", source=_PORT + "csrc/viterbi_dense.cu",
        replaces=_TPU + "extractors/pitch.py:631",
    ),
    "crepe_viterbi": dict(
        id="K8 CREPE", route="cuda", source=_PORT + "csrc/viterbi_dense.cu",
        replaces=_TPU + "extractors/crepe.py:133",
    ),
    "istft": dict(
        id="K5 istft", route="cuda", source=_PORT + "csrc/istft.cu",
        replaces=_TPU + "ops/mel.py:249",
    ),
    "sine_merge": dict(
        id="K9 sine", route="cuda", source=_PORT + "csrc/nsf_source.cu",
        replaces=_TPU + "models/vocoders/nsf_hifigan.py:188",
    ),
    "maximum_path": dict(
        id="K7", route="cuda", source=_PORT + "csrc/monotonic_align.cu",
        replaces=_TPU + "ops/monotonic_align.py:30",
    ),
    "depthwise_conv7_norm": dict(
        id="K10", route="cuda", source=_PORT + "csrc/convnext_block.cu",
        replaces=_TPU + "models/convnext.py:47",
    ),
    # XLA's derivative of DepthwiseConv7 and of the nn.LayerNorm that
    # ConvNeXtBlock (:105) applies after it
    "depthwise_conv7_norm_backward": dict(
        id="K10 bwd", route="cuda", source=_PORT + "csrc/convnext_block.cu",
        replaces=_TPU + "models/convnext.py:47",
    ),
}

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_LOGS: dict = {}
BUILD_SECONDS: dict = {}
_LIBS: dict = {}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# csrc/<file>.cu -> {C entry: argtypes}; every entry returns an int
SIGNATURES = {
    "wavenet_block": {
        "wavenet_gate": [_I] + [_P] * 8 + [_I] * 5 + [_P],
        "wavenet_out": [_I] + [_P] * 8 + [_I] * 3 + [_P],
        "wavenet_gate_train": [_P] * 9 + [_I] * 4 + [_P],
        "wavenet_forward_plan": [_I] * 3,
        "wavenet_backward_rows": [_I] * 3,
        "wavenet_gate_backward": [_P] * 5 + [_I] * 3 + [_P],
        "wavenet_gate_backward_plan": [_I] * 3,
        "wavenet_weight_split": [_P] * 5 + [_I, _P],
        "wavenet_input_backward": [_P] * 5 + [_I] * 4 + [_P],
        "wavenet_weight_grad_chunks": [_I] * 3,
        "wavenet_weight_grad": [_P] * 8 + [_I] * 5 + [_P],
    },
    "conv1d": {
        "conv1d_forward": [_I, _I] + [_P] * 5 + [_I] * 9 + [_F, _I, _I, _P],
    },
    "stft": {
        "stft_magnitude": [_P] * 6 + [_I] * 6 + [_P],
        "stft_magnitude_f64": [_P] * 6 + [_I] * 6 + [_P],
        "stft_backward": [_P] * 8 + [_I] * 6 + [_P],
        "stft_fits_shared": [_I] * 3,
        "stft_magnitude_split": [_P] * 8 + [_I] * 8 + [_P],
        "stft_backward_split": [_P] * 12 + [_I] * 7 + [_P],
    },
    "grouped_conv1d": {
        "grouped_conv1d": [_I] + [_P] * 4 + [_I] * 9 + [_P],
    },
    "conv1d_wgrad": {
        "conv1d_wgrad": [_P] * 4 + [_I] * 10 + [_F, _I, _F, _I, _I, _P],
        "conv1d_wgrad_splits": [_I] * 10,
    },
    "viterbi": {
        "viterbi_candidates": [_P] * 6 + [_I] * 3 + [_P],
        "viterbi_candidates_chain": [_P] * 6 + [_I] * 3 + [_P],
        "viterbi_candidates_plan": [_I] * 3,
    },
    "viterbi_dense": {
        "viterbi_dense": [_P] * 5 + [_I] * 3 + [_P],
        "viterbi_dense_chain": [_P] * 5 + [_I] * 3 + [_P],
        "viterbi_dense_plan": [_I] * 2,
    },
    "nsf_source": {
        "nsf_merge": [_P] * 7 + [_I] * 4 + [_F] * 3 + [_P],
        "nsf_merge_backward": [_P] * 8 + [_I] * 4 + [_F] * 3 + [_P],
        "sine_merge": [_P] * 10 + [_I] * 4 + [_F] * 4 + [_P],
        "comb_merge": [_P] * 6 + [_I] * 3 + [_F] * 3 + [_P],
    },
    "istft": {
        "istft_plan": [_I] * 3,
        "istft": [_P] * 11 + [_I] * 7 + [_P],
    },
    "monotonic_align": {
        "maximum_path": [_P] * 5 + [_I] * 3 + [_P],
        "maximum_path_chain": [_P] * 5 + [_I] * 3 + [_P],
        "maximum_path_plan": [_I] * 3,
    },
    "conv2d": {
        "conv2d": [_I] + [_P] * 4 + [_I] * 13 + [_P],
        "conv2d_wgrad_splits": [_I] * 13,
        "conv2d_wgrad": [_P] * 4 + [_I] * 14 + [_P],
    },
    "convnext_block": {
        "depthwise_conv7_norm": [_P] * 9 + [_I] * 4 + [_F, _P],
        "depthwise_conv7_norm_backward_slots": [_I] * 4,
        "depthwise_conv7_norm_backward": [_P] * 11 + [_I] * 4 + [_F, _P],
    },
}


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _library_path(name: str) -> Path:
    """The library's path, tagged by its source, every shared header in
    ``csrc/`` and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    text += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{tag.hexdigest()[:12]}.so"


def _build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless its library is built, keeping the
    compiler's output in ``BUILD_LOGS`` and its wall seconds in
    ``BUILD_SECONDS``."""
    so = _library_path(name)
    if so.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
        capture_output=True, text=True,
    )
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
    os.replace(tmp, so)


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` once (cached by content) and bind its C
    entries with the argument types in ``SIGNATURES``."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    _build(name)
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
    _LIBS[name] = lib
    return lib


def build_all() -> None:
    """Build every CUDA source, one ``nvcc`` each, all started together
    (the Triton kernels build at first launch)."""
    with ThreadPoolExecutor(len(SIGNATURES)) as pool:
        list(pool.map(_build, [name for name in SIGNATURES if name not in _LIBS]))
    for name in SIGNATURES:
        load_library(name)


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {status})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def dtype_code(t: torch.Tensor) -> int:
    """0 = float32, 1 = bfloat16: the element types the CUDA kernels take."""
    if t.dtype == torch.float32:
        return 0
    if t.dtype == torch.bfloat16:
        return 1
    raise TypeError(f"kernel takes float32 or bfloat16, got {t.dtype}")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor of one dtype."""
    dev, dt = tensors[0].device, tensors[0].dtype
    for t in tensors:
        if t.device != dev or not t.is_cuda:
            raise ValueError(f"{name}: all tensors must be on one CUDA device")
        if t.dtype != dt:
            raise TypeError(f"{name}: mixed dtypes {dt} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
