"""Pitch extractors' shared parts (``fish_diffusion_tpu/extractors/pitch.py``).

``BasePitchExtractor.post_process`` stretches an f0 curve to the mel frame
count and, unless ``keep_zeros``, fills unvoiced frames by linear
interpolation over the voiced ones (host numpy, as in the JAX package).

``viterbi_candidates`` is praat's path finder over per-frame pitch
candidates, which Harvest runs on every segment. Its forward recursion and
backtrack are K8-cand, the hand-written CUDA kernel of ``csrc/viterbi.cu``;
``viterbi_candidates_reference`` is the plain version, which the wrapper
takes for CPU tensors.

The other extractors of that file (YIN, autocorrelation, pYIN with its
Viterbi decoder) and CREPE are not ported yet (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..ops.tensor import repeat_expand_np

OCTAVE_JUMP_COST = 0.35
VOICED_UNVOICED_COST = 0.14


class BasePitchExtractor:
    def __init__(
        self,
        hop_length: int = 512,
        f0_min: float = 50.0,
        f0_max: float = 1100.0,
        keep_zeros: bool = True,
    ):
        self.hop_length = hop_length
        self.f0_min = f0_min
        self.f0_max = f0_max
        self.keep_zeros = keep_zeros

    def __call__(self, x, sampling_rate=44100, pad_to=None):
        raise NotImplementedError

    def post_process(self, x, sampling_rate, f0, pad_to):
        """f0 [T] -> [pad_to] (nearest stretch); unless ``keep_zeros``,
        unvoiced frames take ``np.interp`` over the voiced ones (the ends
        extend the first and last voiced values)."""
        f0 = np.asarray(f0, np.float32)
        if pad_to is None:
            return f0

        f0 = repeat_expand_np(f0, pad_to)
        if self.keep_zeros:
            return f0

        nzindex = np.nonzero(f0)[0]
        f0_nz = f0[nzindex]
        if len(f0_nz) == 0:
            return np.zeros(pad_to, np.float32)
        if len(f0_nz) == 1:
            return np.full(pad_to, f0_nz[0], np.float32)

        time_org = self.hop_length / sampling_rate * nzindex
        time_frame = np.arange(pad_to) * self.hop_length / sampling_rate
        return np.interp(time_frame, time_org, f0_nz).astype(np.float32)


# ---------------------------------------------------------------------------
# K8-cand: the candidate Viterbi
# ---------------------------------------------------------------------------


def _states(freqs, strengths, unvoiced):
    """Append the unvoiced state: (f_all, str_all) [B, T, K + 1]."""
    zeros = torch.zeros_like(unvoiced)[..., None]
    return (torch.cat([freqs, zeros], dim=-1),
            torch.cat([strengths, unvoiced[..., None]], dim=-1))


def viterbi_candidates_reference(freqs, strengths, unvoiced):
    """Plain version of K8-cand. freqs, strengths [B, T, K], unvoiced
    [B, T] -> (f0 [B, T] float32, path [B, T] int32). Ties take the first
    state, as ``torch.max`` and ``jnp.argmax`` do."""
    f_all, str_all = _states(freqs, strengths, unvoiced)
    B, T, S = f_all.shape
    lp = torch.log2(torch.clamp(f_all, min=1e-6))
    voiced = f_all > 0
    # cost[b, t - 1, i, j]: from state i at frame t - 1 to state j at frame t
    jump = (lp[:, :-1, :, None] - lp[:, 1:, None, :]).abs()
    vp, vn = voiced[:, :-1, :, None], voiced[:, 1:, None, :]
    cost = torch.where(vp & vn, OCTAVE_JUMP_COST * jump,
                       torch.where(vp ^ vn, VOICED_UNVOICED_COST, 0.0))

    delta = str_all[:, 0]
    backptrs = []
    for t in range(1, T):
        best, arg = torch.max(delta[:, :, None] - cost[:, t - 1], dim=1)
        delta = best + str_all[:, t]
        backptrs.append(arg)

    bp = torch.stack(backptrs, 1).cpu().numpy() if backptrs else None
    path = np.zeros((B, T), np.int64)
    path[:, -1] = torch.argmax(delta, dim=1).cpu().numpy()
    rows = np.arange(B)
    for t in range(T - 1, 0, -1):
        path[:, t - 1] = bp[rows, t - 1, path[:, t]]
    path_t = torch.from_numpy(path).to(f_all.device)
    f0 = torch.gather(f_all, 2, path_t[..., None])[..., 0]
    return f0, path_t.int()


def viterbi_candidates(freqs, strengths, unvoiced):
    """K8-cand: the candidate path and its f0. freqs, strengths [B, T, K],
    unvoiced [B, T], float32 -> (f0 [B, T], path [B, T] int32). CPU tensors
    take ``viterbi_candidates_reference``."""
    if not freqs.is_cuda:
        return viterbi_candidates_reference(freqs, strengths, unvoiced)
    kernels.require_cuda("viterbi_candidates", freqs, strengths, unvoiced)
    if freqs.dtype != torch.float32:
        raise TypeError(f"viterbi_candidates: takes float32, got {freqs.dtype}")
    if freqs.ndim != 3 or strengths.shape != freqs.shape \
            or unvoiced.shape != freqs.shape[:2]:
        raise ValueError(
            f"viterbi_candidates: freqs {tuple(freqs.shape)}, strengths "
            f"{tuple(strengths.shape)}, unvoiced {tuple(unvoiced.shape)}: "
            "expected [B, T, K], [B, T, K], [B, T]"
        )
    B, T, K = freqs.shape
    if not 1 <= K <= 31 or T < 1:
        raise ValueError(f"viterbi_candidates: K = {K}, T = {T}: needs "
                         "1 <= K <= 31 candidates and a frame")
    dev = freqs.device
    backptr = torch.empty((B, max(T - 1, 1), K + 1), dtype=torch.int32, device=dev)
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    f0 = torch.empty((B, T), dtype=torch.float32, device=dev)
    lib = kernels.load_library("viterbi")
    kernels.check(
        lib.viterbi_candidates(freqs.data_ptr(), strengths.data_ptr(),
                               unvoiced.data_ptr(), backptr.data_ptr(),
                               path.data_ptr(), f0.data_ptr(), B, T, K,
                               kernels.stream()),
        "viterbi_candidates",
    )
    kernels.count_launch("viterbi_candidates")
    return f0, path
