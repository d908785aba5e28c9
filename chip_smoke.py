#!/usr/bin/env python3
"""Drive the PyTorch port's SVC paths once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. device:  require CUDA, print the card's name and power limit, turn TF32
            off for every comparison.
2. build:   compile the CUDA sources in ``fish_diffusion_tpu_torch/csrc``,
            one ``nvcc`` each, all started together.
3. kernels: every hand-written kernel against its plain PyTorch version at
            B=4 x 1024 frames, with median CUDA-event times of both, its
            bound (the larger of the bytes the function must move over
            3.35 TB/s and the float32 operations it needs over 67 TFLOP/s)
            and, where one PyTorch call computes the same function, that
            call's time; K5 also at B=1 over a segment for each of its
            tiles; then the whole 20-block denoiser eval and the whole
            vocoder against their plain compositions.
4. serve:   ``SVCInference`` built from ``configs/svc_hubert_soft.py`` at
            full width (HubertSoft 12x768, WaveNet 20x512, NSF-HiFiGAN 512,
            1000 steps at interval 10) with seeded random weights answers
            three requests that carry their f0 (every kernel's launch count
            must grow as the path implies; a short request is checked
            against the plain composition); then the file-to-file path: a
            24 s wav of three phrases through ``inference`` with Harvest
            pitch and UniPC, again with shallow diffusion (``skip_steps``
            500), and a 2.97 s ``forward`` with each of PLMS and naive; K5
            and K8-cand are held against their plain versions, and timed,
            on the inputs the shallow request gave them; a short shallow
            file is checked against the plain composition of every kernel.

The line before the last is a JSON object with one entry per kernel (its
``launches`` count the file-to-file path; K5's and K8-cand's times are
those of the shallow request's own calls, with their B=4 times under
``batch4``); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SR, HOP, MEL = 44100, 512, 128
B, T, R = 4, 1024, 512
# NVIDIA H100 SXM data sheet: HBM3 bytes/s and float32 FLOP/s outside the
# tensor cores (the kernels here are float32 SIMT)
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12


def cuda_ms(fn, iters: int = 10, warmup: int = 2, reps: int = 1) -> float:
    """Median milliseconds of one call of ``fn`` over ``iters`` CUDA-event
    timed runs of ``reps`` back-to-back calls each."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float):
    """(ms, "bytes" | "operations"): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def max_abs(a) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs(x) for x in a)
    return float(a.float().abs().max())


class Report:
    """Collects comparisons; ``finish`` fails if any was out of tolerance."""

    def __init__(self):
        self.failures = []
        self.kernels = {}
        self.extra = {}

    def compare(self, label, got, ref, tol, relative=False):
        err = max_err(got, ref)
        bound = tol * max(1.0, max_abs(ref)) if relative else tol
        ok = err <= bound and np.isfinite(err)
        print(f"  {label}: max_abs_err={err:.3e} tol={bound:.3e}"
              f"{' (relative)' if relative else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(label)
        return err

    def kernel(self, name, err, ms, plain_ms, shape="", n_bytes=0, flops=0,
               library_ms=None):
        """Accumulate one measured call (times, bound and library time add
        up over the calls of one entry; errors take the maximum)."""
        entry = self.kernels.setdefault(name, dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bound_time=defaultdict(float), library_ms=None, shape=""))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["shape"] = shape or entry["shape"]
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        if n_bytes or flops:
            t, by = bound(n_bytes, flops)
            entry["bound_ms"] += t
            entry["bound_time"][by] += t
        if library_ms is not None:
            entry["library_ms"] = (entry["library_ms"] or 0.0) + library_ms

    def batch4(self, name, r, shape):
        """A kernel's times at B=4 x 1024 frames, beside its entry for the
        main path's own calls."""
        t, by = bound(*r["work"])
        self.extra[name] = dict(batch4=dict(
            shape=shape, ms=r["ms"], plain_ms=r["plain"], bound_ms=t, bound_by=by,
            library_ms=r.get("lib")))

    def finish(self, phase):
        if self.failures:
            raise SystemExit(f"chip_smoke: {phase} failed: {self.failures}")


def phase_kernels(report: Report, seed: int):
    import torch

    from fish_diffusion_tpu_torch.models import diffusion, wavenet
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.utils import init_random_

    gen = torch.Generator(device=DEVICE).manual_seed(seed)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=DEVICE) * scale).to(dtype)

    print("[kernels] K1 WaveNet residual block, B=4 T=1024 R=512")
    base = dict(x=rn(B, T, R), skip=rn(B, T, R), step=rn(B, R),
                cond=rn(B, T, 2 * R), w_conv=rn(3 * R, 2 * R, scale=(3 * R) ** -0.5),
                b_conv=rn(2 * R, scale=0.1), w_out=rn(R, 2 * R, scale=R ** -0.5),
                b_out=rn(2 * R, scale=0.1))
    # f32 is the config's type; bf16 differs from its plain version by the
    # rounding of z and g to bf16, which the kernel keeps in float32
    for dtype, tol in ((torch.float32, 1e-3), (torch.bfloat16, 1.25e-1)):
        a = {k: v.to(dtype) for k, v in base.items()}
        tag = "f32" if dtype == torch.float32 else "bf16"
        for d in (1, 2, 4, 8):
            gate_args = (a["x"], a["step"], a["cond"], a["w_conv"], a["b_conv"], d)
            g_ref = wavenet.residual_gate_reference(*gate_args)
            err_g = report.compare(f"wavenet_gate {tag} d={d}",
                                   wavenet.residual_gate(*gate_args), g_ref, tol)
            out_args = (g_ref, a["x"], a["skip"], a["w_out"], a["b_out"])
            err_o = report.compare(f"wavenet_out {tag} d={d}",
                                   wavenet.residual_out(*out_args),
                                   wavenet.residual_out_reference(*out_args), tol)
            if dtype == torch.float32:
                report.kernel("wavenet_gate", err_g, 0.0, 0.0,
                              "one block, B=4 T=1024 R=512 f32")
                report.kernel("wavenet_out", err_o, 0.0, 0.0,
                              "one block, B=4 T=1024 R=512 f32")
        gate_args = (a["x"], a["step"], a["cond"], a["w_conv"], a["b_conv"], 1)
        out_args = (wavenet.residual_gate_reference(*gate_args), a["x"], a["skip"],
                    a["w_out"], a["b_out"])
        times = {
            "wavenet_gate": (cuda_ms(lambda: wavenet.residual_gate(*gate_args)),
                             cuda_ms(lambda: wavenet.residual_gate_reference(*gate_args))),
            "wavenet_out": (cuda_ms(lambda: wavenet.residual_out(*out_args)),
                            cuda_ms(lambda: wavenet.residual_out_reference(*out_args))),
        }
        traffic = {
            "wavenet_gate": nbytes(a["x"], a["step"], a["cond"], a["w_conv"],
                                   a["b_conv"], a["x"]),
            "wavenet_out": nbytes(out_args[0], a["x"], a["skip"], a["w_out"],
                                  a["b_out"], a["x"], a["skip"]),
        }
        for name, (ms, plain) in times.items():
            flops = 2 * B * T * (3 * R if name == "wavenet_gate" else R) * 2 * R
            print(f"  {name} {tag}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s), plain {plain:.4f} ms")
            if dtype == torch.float32:
                report.kernel(name, 0.0, ms, plain, "one block, B=4 T=1024 R=512 f32",
                              traffic[name], flops)

    print("[kernels] K2 steps (UniPC, PLMS, naive), [4, 1024, 128] f32; times "
          "per launch over 20 back-to-back launches")
    coeffs = diffusion.ScheduleCoefficients(np.linspace(1e-4, 0.01, 1000))
    table = diffusion.unipc_step_table(coeffs, 100)
    i = 50
    f = {k: v.astype(np.float64) for k, v in table.items()}
    t = dict(x=rn(B, T, MEL), m0=rn(B, T, MEL), m1=rn(B, T, MEL), m2=rn(B, T, MEL),
             xe=rn(B, T, MEL), eps=rn(B, T, MEL))
    pred = (t["x"], t["m0"], t["m1"], t["m2"], f["c_x"][i], f["c_m0"][i],
            f["c_pred"][i, 0], f["c_pred"][i, 1], f["inv_rk"][i, 0], f["inv_rk"][i, 1])
    corr = (t["x"], t["m0"], t["m1"], t["m2"], t["xe"], t["eps"], f["alpha_in"][i + 1],
            f["sigma_in"][i + 1], f["c_x"][i], f["c_m0"][i], f["c_corr"][i, 0],
            f["c_corr"][i, 1], f["c_corr_D1t"][i], f["inv_rk"][i, 0], f["inv_rk"][i, 1])
    pred = tuple(float(v) if isinstance(v, np.floating) else v for v in pred)
    corr = tuple(float(v) if isinstance(v, np.floating) else v for v in corr)
    acp = coeffs.alphas_cumprod.astype(np.float32)
    naive = diffusion.naive_step_table(coeffs)
    plms = (t["x"], t["eps"], t["m0"], t["m1"], t["m2"], *diffusion.PLMS_WEIGHTS[2],
            *diffusion.plms_transfer(acp, 500, 490))
    ddpm = (t["x"], t["eps"], t["xe"],
            *(float(naive[k][500]) for k in ("a", "b", "c1", "c2", "sigma")))
    elems = B * T * MEL
    for name, fn, ref, args, n_io, flops in (
        ("unipc_predict", diffusion.unipc_predict,
         diffusion.unipc_predict_reference, pred, 5, 10 * elems),
        ("unipc_correct", diffusion.unipc_correct,
         diffusion.unipc_correct_reference, corr, 8, 18 * elems),
        ("plms_update", diffusion.plms_update, diffusion.plms_update_reference,
         plms, 6, 13 * elems),
        ("ddpm_update", diffusion.ddpm_update, diffusion.ddpm_update_reference,
         ddpm, 4, 10 * elems),
    ):
        err = report.compare(name, fn(*args), ref(*args), 1e-5, relative=True)
        ms = cuda_ms(lambda: fn(*args), reps=20)
        plain = cuda_ms(lambda: ref(*args), reps=20)
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
        report.kernel(name, err, ms, plain, "one step, [4, 1024, 128] f32",
                      n_io * elems * 4, flops)

    print("[kernels] K3 NSF source, B=4 T=1024 hop=512, 9 harmonics")
    f0 = (torch.rand((B, T), generator=gen, device=DEVICE) * 400 + 100)
    f0 = f0 * (torch.rand((B, T), generator=gen, device=DEVICE) > 0.2)
    rand_ini = torch.rand((B, 9), generator=gen, device=DEVICE)
    rand_ini[:, 0] = 0
    noise = rn(B, T * HOP, 9)
    weight, bias = rn(9, scale=1 / 3), rn(1, scale=0.1)
    base_ref = source.nsf_phase_base_reference(f0, SR, HOP)
    err = report.compare("nsf_phase_base", source.nsf_phase_base(f0, SR, HOP),
                         base_ref, 1e-6)
    ms = cuda_ms(lambda: source.nsf_phase_base(f0, SR, HOP))
    plain = cuda_ms(lambda: source.nsf_phase_base_reference(f0, SR, HOP))
    print(f"  nsf_phase_base: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    report.kernel("nsf_phase_base", err, ms, plain, "B=4 T=1024",
                  nbytes(f0, base_ref), 4 * B * T)
    margs = (f0, base_ref, rand_ini, noise, weight, bias, SR, HOP)
    err = report.compare("nsf_merge", source.nsf_merge(*margs),
                         source.nsf_merge_reference(*margs), 1e-4)
    ms = cuda_ms(lambda: source.nsf_merge(*margs))
    plain = cuda_ms(lambda: source.nsf_merge_reference(*margs))
    print(f"  nsf_merge: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    # per sample and harmonic: phase, sin, uv gate, noise, weight (~8)
    report.kernel("nsf_merge", err, ms, plain, "B=4 T=1024 hop=512",
                  nbytes(f0, base_ref, rand_ini, noise, weight, bias) + 4 * B * T * HOP,
                  8 * noise.numel())

    print("[kernels] K4 vocoder convolutions, every shape of a B=4 x 1024-frame pass")
    gen_cpu_seed = seed + 1
    vocoder = init_random_(nsf_hifigan.NsfHifiGANGenerator(), gen_cpu_seed).to(DEVICE).eval()
    mel = rn(B, T, MEL, scale=0.5) - 2.0
    calls = {}
    real = {"conv1d": nsf_hifigan.conv1d,
            "conv_transpose1d": nsf_hifigan.conv_transpose1d}
    refs = {"conv1d": nsf_hifigan.conv1d_reference,
            "conv_transpose1d": nsf_hifigan.conv_transpose1d_reference}

    def recorder(name):
        def call(x, *args, **kwargs):
            sig = (name, tuple(x.shape), tuple(args[0].shape), tuple(args[2:]),
                   tuple(sorted((k, v if not torch.is_tensor(v) else "T")
                                for k, v in kwargs.items())))
            if sig in calls:
                calls[sig][2] += 1
            else:
                kw = {k: v.contiguous() if torch.is_tensor(v) else v
                      for k, v in kwargs.items()}
                calls[sig] = [x.contiguous(), (args, kw), 1]
            return refs[name](x, *args, **kwargs)
        return call

    with torch.inference_mode():
        nsf_hifigan.conv1d = recorder("conv1d")
        nsf_hifigan.conv_transpose1d = recorder("conv_transpose1d")
        try:
            vocoder(mel, f0, rand_ini, noise)
        finally:
            nsf_hifigan.conv1d = real["conv1d"]
            nsf_hifigan.conv_transpose1d = real["conv_transpose1d"]
        library = {"conv1d": library_conv1d, "conv_transpose1d": library_conv_transpose1d}
        for (name, xs, ws, *_), (x, (args, kwargs), count) in calls.items():
            got = real[name](x, *args, **kwargs)
            ref = refs[name](x, *args, **kwargs)
            err = report.compare(f"{name} x{list(xs)} w{list(ws)} {kwargs_str(kwargs)}",
                                 got, ref, 1e-4, relative=True)
            ms = cuda_ms(lambda: real[name](x, *args, **kwargs), iters=5)
            plain = cuda_ms(lambda: refs[name](x, *args, **kwargs), iters=5)
            lib = cuda_ms(library[name](x, *args, **kwargs), iters=5)
            w = args[0]
            flops = 2 * got.numel() * w.shape[1] * w.shape[2] if name == "conv1d" \
                else 2 * x.numel() * w.shape[1] * w.shape[2]
            io = nbytes(x, w, args[1], got) + (
                nbytes(kwargs["residual"]) if kwargs.get("residual") is not None else 0)
            print(f"    x{count} per pass: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
                  f"cuDNN alone {lib:.4f} ms")
            report.kernel(name, err, ms * count, plain * count,
                          "sum over one vocoder pass, B=4 x 1024 frames",
                          io * count, flops * count, lib * count)
        calls.clear()

    print("[kernels] whole denoiser eval (20 x 512) and whole vocoder vs plain")
    denoiser = init_random_(wavenet.WaveNet(MEL, 256, R, 20, True, 4), seed + 2).to(DEVICE).eval()
    feats = rn(B, T, 256)
    x_t = rn(B, T, MEL)
    steps = torch.full((B,), 500.0, device=DEVICE)
    plain_fns = {
        (wavenet, "residual_block"): wavenet.residual_block_reference,
        (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
        (nsf_hifigan, "conv_transpose1d"): nsf_hifigan.conv_transpose1d_reference,
        (source, "nsf_source"): source.nsf_source_reference,
    }
    with torch.inference_mode():
        plan = denoiser.prepare(feats)
        run_den = lambda: denoiser(x_t, steps, None, plan=plan)  # noqa: E731
        run_voc = lambda: vocoder(mel, f0, rand_ini, noise)  # noqa: E731
        got_den, got_voc = run_den(), run_voc()
        ms_den, ms_voc = cuda_ms(run_den), cuda_ms(run_voc, iters=5)
        with plain_path(plain_fns):
            ref_den, ref_voc = run_den(), run_voc()
            plain_den, plain_voc = cuda_ms(run_den), cuda_ms(run_voc, iters=5)
    report.compare("denoiser eval", got_den, ref_den, 1e-3, relative=True)
    print(f"  denoiser eval: kernels {ms_den:.3f} ms, plain {plain_den:.3f} ms")
    report.compare("vocoder", got_voc, ref_voc, 1e-3)
    print(f"  vocoder: kernels {ms_voc:.3f} ms, plain {plain_voc:.3f} ms")
    report.finish("kernels")
    return dict(denoiser_eval_ms=ms_den, denoiser_eval_plain_ms=plain_den,
                vocoder_ms=ms_voc, vocoder_plain_ms=plain_voc)


def library_conv1d(x, weight, bias, stride=1, dilation=1, padding=0, **_):
    """One cuDNN call for K4's convolution (its fused input activation,
    residual and tanh left out), on the same inputs in torch's layout."""
    import torch.nn.functional as F

    xt = x.transpose(1, 2).contiguous()
    return lambda: F.conv1d(xt, weight, bias, stride, padding, dilation)


def library_conv_transpose1d(x, weight, bias, stride, padding, **_):
    import torch.nn.functional as F

    xt = x.transpose(1, 2).contiguous()
    return lambda: F.conv_transpose1d(xt, weight, bias, stride, padding)


def stft_work(yp, out, n_fft: int):
    """Bytes and float32 operations that the STFT magnitude needs, whatever
    the kernel does: the signal and the window read once, the magnitudes
    written once; per frame a real FFT of n_fft points (2.5 n log2 n), the
    window's n products and 4 operations per bin for the magnitude."""
    frames, bins = out.shape[0] * out.shape[2], out.shape[1]
    flops = frames * (2.5 * n_fft * np.log2(n_fft) + n_fft + 4 * bins)
    return nbytes(yp, out) + 4 * n_fft, flops


def measure_stft(report: Report, yp, basis, hop: int, label: str, timed=True):
    """K5 against its plain version on one input; with ``timed``, the
    kernel's, the plain version's and ``torch.stft().abs()``'s times."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.ops import mel

    n_fft, bins = basis.shape[0], basis.shape[1] // 2
    got = mel.stft_magnitude(yp, basis, hop)
    tile = kernels.load_library("stft").stft_tile(got.shape[0] * got.shape[2], bins)
    err = report.compare(f"stft_magnitude {label}, M={got.shape[0] * got.shape[2]} "
                         f"(tile {tile} rows)", got,
                         mel.stft_magnitude_reference(yp, basis, hop), 1e-4, relative=True)
    out = dict(err=err, tile=tile, work=stft_work(yp, got, n_fft))
    if timed:
        window = torch.hann_window(n_fft, device=DEVICE)
        out.update(
            ms=cuda_ms(lambda: mel.stft_magnitude(yp, basis, hop), iters=5),
            plain=cuda_ms(lambda: mel.stft_magnitude_reference(yp, basis, hop), iters=5),
            lib=cuda_ms(lambda: torch.stft(yp, n_fft, hop, n_fft, window, center=False,
                                           return_complex=True).abs(), iters=5))
        t_bound, by = bound(*out["work"])
        print(f"    kernel {out['ms']:.4f} ms, plain {out['plain']:.4f} ms, torch.stft "
              f"{out['lib']:.4f} ms, bound {t_bound:.4f} ms ({by})")
    return out


def measure_viterbi(report: Report, args, label: str):
    """K8-cand against its plain version (path and f0 identical), timed."""
    from fish_diffusion_tpu_torch.extractors import pitch

    got, ref = pitch.viterbi_candidates(*args), pitch.viterbi_candidates_reference(*args)
    err = max(report.compare(f"viterbi_candidates path {label} (identical)",
                             got[1], ref[1], 0.0),
              report.compare(f"viterbi_candidates f0 {label} (identical)",
                             got[0], ref[0], 0.0))
    ms = cuda_ms(lambda: pitch.viterbi_candidates(*args), iters=5)
    plain = cuda_ms(lambda: pitch.viterbi_candidates_reference(*args), iters=3)
    B_, T_ = args[2].shape
    print(f"    kernel {ms:.4f} ms ({ms * 1e3 / max(T_ - 1, 1):.3f} us per frame), "
          f"plain {plain:.4f} ms")
    # per transition: 25 state pairs of ~6 operations; the real limit is
    # the chain of T - 1 dependent frames
    return dict(err=err, ms=ms, plain=plain,
                work=(nbytes(*args, *got), 6 * B_ * (T_ - 1) * 25))


def phase_kernels_stft_viterbi(report: Report, seed: int):
    """K5 (STFT magnitude) and K8-cand (candidate Viterbi) against their
    plain versions at B=4 x 1024 frames (timed; kept under ``batch4`` in
    the kernels line) and K5 at B=1 over a segment's length for each of the
    kernel's three tiles. The main path's own calls are held and timed in
    ``phase_file_to_file``."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch.ops import mel

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 7)

    def padded(y, n_fft):
        pad = int((n_fft - HOP) / 2)
        return F.pad(y[:, None], (pad, pad), mode="reflect")[:, 0].contiguous()

    n_samples = T * HOP
    print(f"[kernels] K5 STFT magnitude, B={B} x {n_samples} samples, hop {HOP}")
    y = torch.randn((B, n_samples), generator=gen, device=DEVICE) * 0.3
    for key_shift in (0, 2):
        n_fft = int(np.round(2048 * 2 ** (key_shift / 12)))
        yp = padded(y, n_fft)
        r = measure_stft(report, yp, mel._dft_basis(n_fft, n_fft, DEVICE), HOP,
                         f"B=4 n_fft={n_fft}")
        report.kernel("stft_magnitude", r["err"], 0.0, 0.0)
        if key_shift == 0:
            report.batch4("stft_magnitude", r, f"B=4 x {n_samples} samples, n_fft 2048")
    print("[kernels] K5 at B=1, one segment of 1.5 s, 7.4 s and 1024 frames")
    basis = mel._dft_basis(2048, 2048, DEVICE)
    tiles = set()
    for seconds in (1.5, 7.4, T * HOP / SR):
        y1 = torch.randn((1, int(seconds * SR)), generator=gen, device=DEVICE) * 0.3
        r = measure_stft(report, padded(y1, 2048), basis, HOP, f"B=1 {seconds:.2f} s",
                         timed=False)
        report.kernel("stft_magnitude", r["err"], 0.0, 0.0)
        tiles.add(r["tile"])
    if tiles != {32, 64, 128}:
        report.failures.append(f"stft_magnitude: B=1 cases took tiles {sorted(tiles)}")

    print(f"[kernels] K8-cand candidate Viterbi, B={B} T={T} K=4")
    freqs = torch.rand((B, T, 4), generator=gen, device=DEVICE) * 1050 + 50
    freqs = freqs * (torch.rand((B, T, 4), generator=gen, device=DEVICE) > 0.3)
    strengths = torch.rand((B, T, 4), generator=gen, device=DEVICE) * 2 - 1
    unvoiced = torch.rand((B, T), generator=gen, device=DEVICE) * 1.5
    r = measure_viterbi(report, (freqs, strengths, unvoiced), "B=4 T=1024")
    report.kernel("viterbi_candidates", r["err"], 0.0, 0.0)
    report.batch4("viterbi_candidates", r, "B=4 T=1024 K=4")
    report.finish("kernels (K5, K8)")


class recording:
    """Swap ``module.name`` for a wrapper that calls it and keeps its
    arguments (the tensors are not copied) between ``start`` and ``stop``."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, []
        self.fn = getattr(module, name)

    def start(self):
        def call(*args):
            self.calls.append(args)
            return self.fn(*args)

        setattr(self.module, self.name, call)

    def stop(self):
        setattr(self.module, self.name, self.fn)


def kwargs_str(kwargs):
    return " ".join(f"{k}={v}" for k, v in kwargs.items() if not hasattr(v, "shape"))


class plain_path:
    """Swap kernel wrappers for their plain versions by module attribute."""

    def __init__(self, swaps: dict):
        self.swaps = swaps
        self.saved = {}

    def __enter__(self):
        for (mod, name), fn in self.swaps.items():
            self.saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, fn)

    def __exit__(self, *exc):
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)


def make_request_audio(rng, n_samples: int):
    """Numpy-made audio (a voiced harmonic tone with vibrato and noise) and
    its frame f0 curve with unvoiced stretches."""
    n_frames = n_samples // HOP
    t_frames = np.arange(n_frames) * HOP / SR
    f0 = 220.0 * 2 ** (rng.uniform(-0.5, 0.5)) * (1 + 0.02 * np.sin(2 * np.pi * 5 * t_frames))
    f0[rng.random(n_frames) < 0.1] = 0.0
    f0_s = np.repeat(f0, HOP)[:n_samples]
    f0_s = np.pad(f0_s, (0, n_samples - len(f0_s)), mode="edge")
    phase = 2 * np.pi * np.cumsum(f0_s / SR)
    audio = 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(n_samples)
    return audio.astype(np.float32), f0.astype(np.float32)


def phase_serve(report: Report, seed: int):
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.config import Config
    from fish_diffusion_tpu_torch.inference.svc import SVCInference
    from fish_diffusion_tpu_torch.models import wavenet
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source

    cfg = Config.fromfile(ROOT / "configs" / "svc_hubert_soft.py")
    cfg.preprocessing.text_features_extractor.update(random_init=True, seed=seed)
    cfg.model.vocoder.update(checkpoint_path=None, random_init=True, seed=seed + 1)
    t0 = time.perf_counter()
    engine = SVCInference(cfg, device=DEVICE)
    engine.init_random(seed + 2)
    torch.cuda.synchronize()
    print(f"[serve] engine built at full width in {time.perf_counter() - t0:.1f} s "
          f"(HubertSoft 12x768, WaveNet 20x512, NSF-HiFiGAN 512)")

    rng = np.random.default_rng(seed)
    batch = [make_request_audio(rng, n) for n in (524288, 520000, 515000, 510000)]
    short, short_f0 = make_request_audio(rng, 256 * HOP)
    evals = cfg.model.diffusion.timesteps // cfg.model.diffusion.sampler_interval
    layers = cfg.model.diffusion.denoiser.residual_layers
    per_vocoder = {"conv_transpose1d": 5, "conv1d": 2 + 5 * (1 + 3 * 6),
                   "nsf_phase_base": 1, "nsf_merge": 1}
    expected = {name: 0 for name in kernels.LAUNCHES}
    expected.update({"wavenet_gate": layers * evals, "wavenet_out": layers * evals,
                     "unipc_predict": evals, "unipc_correct": evals, **per_vocoder})

    requests = [
        ("forward_batch 4 x ~11.9 s (bucket 1024)",
         lambda: engine.forward_batch([a for a, _ in batch], engine.parse_speaker(0),
                                      seed=seed, pitches_list=[f for _, f in batch]),
         [len(a) for a, _ in batch]),
        ("forward 1 x 2.97 s (bucket 256)",
         lambda: [engine.forward(short, engine.parse_speaker(1), seed=seed,
                                 pitches=short_f0)],
         [len(short)]),
        ("forward 1 x 2.97 s, speaker mix 0:0.6,1:0.4",
         lambda: [engine.forward(short, engine.parse_speaker("0:0.6,1:0.4"),
                                 seed=seed, pitches=short_f0)],
         [len(short)]),
    ]
    kernels.reset_launches()
    for label, run, lengths in requests:
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        audio_secs = sum(lengths) / SR
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        ok = (
            [len(o) for o in outs] == lengths
            and all(np.isfinite(o).all() and np.abs(o).max() <= 1.0 for o in outs)
            and all(np.abs(o).max() > 0 for o in outs)
            and grew == expected
        )
        print(f"[serve] {label}: {secs:.3f} s for {audio_secs:.2f} s of audio, "
              f"RTF {secs / audio_secs:.4f}, peak |wav| "
              f"{max(float(np.abs(o).max()) for o in outs):.3f}, launches "
              f"{({k: v for k, v in grew.items() if v})} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            report.failures.append(label)
    launches = dict(kernels.LAUNCHES)
    print(f"[serve] launches over the three requests: {launches}")
    for name, n in expected.items():
        if n and launches[name] <= 0:
            report.failures.append(f"{name} never launched")
    print(f"[serve] peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the same short request through the plain compositions
    small, small_f0 = make_request_audio(rng, 96 * HOP)
    run_small = lambda: engine.forward(small, engine.parse_speaker(0), seed=seed,  # noqa: E731
                                       pitches=small_f0)
    got = run_small()
    with plain_path({
        (wavenet, "residual_block"): wavenet.residual_block_reference,
        (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
        (nsf_hifigan, "conv_transpose1d"): nsf_hifigan.conv_transpose1d_reference,
        (source, "nsf_source"): source.nsf_source_reference,
    }):
        ref = run_small()
    report.compare("serve 1 x 1.1 s vs plain composition (wav)",
                   torch.from_numpy(got), torch.from_numpy(ref), 1e-2)
    report.finish("serve")
    return engine


def make_phrase(rng, seconds: float, f0: float) -> np.ndarray:
    """A sung phrase: two partials with 5 Hz vibrato over a noise floor."""
    t = np.arange(int(seconds * SR)) / SR
    phase = 2 * np.pi * np.cumsum(f0 * (1 + 0.015 * np.sin(2 * np.pi * 5 * t))) / SR
    return 0.3 * np.sin(phase) + 0.1 * np.sin(2 * phase) + 0.01 * rng.standard_normal(len(t))


def make_song(rng, path, phrases) -> np.ndarray:
    """Phrases ((seconds, f0), ...) between stretches of digital silence,
    written as a 16-bit wav; returns the samples as read back."""
    from fish_diffusion_tpu_torch.utils.audio import load_wav, save_wav

    parts = [np.zeros(int(0.3 * SR))]
    for seconds, f0 in phrases:
        parts += [make_phrase(rng, seconds, f0), np.zeros(int(0.6 * SR))]
    save_wav(path, np.concatenate(parts[:-1] + [np.zeros(int(0.3 * SR))]), SR)
    return load_wav(path)[0]


class StageClock:
    """Host seconds (with a device sync on each side) spent in chosen
    methods while a request runs."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.saved = []

    def wrap(self, obj, attr, label):
        import torch

        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds[label] += time.perf_counter() - t0
            return out

        self.saved.append((obj, attr, fn, attr in vars(obj)))
        setattr(obj, attr, timed)

    def restore(self):
        for obj, attr, fn, own in reversed(self.saved):
            if own:
                setattr(obj, attr, fn)
            else:
                delattr(obj, attr)


def phase_file_to_file(report: Report, engine, seed: int):
    """The second slice's path: ``inference`` on a 24 s wav with Harvest
    pitch (UniPC; then shallow), ``forward`` with PLMS and naive, and a
    short shallow file against the plain composition of every kernel."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.extractors import pitch, world
    from fish_diffusion_tpu_torch.models import diffusion, wavenet
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import mel
    from fish_diffusion_tpu_torch.utils.audio import load_wav, slice_audio

    cfg = engine.config.model.diffusion
    layers, T_steps, interval = (cfg.denoiser.residual_layers, cfg.timesteps,
                                 cfg.sampler_interval)
    rng = np.random.default_rng(seed + 20)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    song = make_song(rng, tmp / "song.wav", [(7.4, 220.0), (7.4, 247.0), (7.4, 196.0)])
    rms = np.sqrt(np.mean(song ** 2) + 1e-12)
    normed = np.clip(song * (10 ** (-23 / 20) / (rms + 1e-12)), -1, 1)
    n_seg = len(list(slice_audio(normed, SR)))
    short = make_phrase(rng, 256 * HOP / SR, 233.0).astype(np.float32)
    print(f"[file] {len(song) / SR:.2f} s wav, {n_seg} segments (bucket 1024 each); "
          f"a {len(short) / SR:.2f} s segment for PLMS and naive")

    vocoder = {"conv_transpose1d": 5, "conv1d": 2 + 5 * (1 + 3 * 6),
               "nsf_phase_base": 1, "nsf_merge": 1}

    def expect(segments, evals, steps=None, predictor="unipc", stft=0):
        steps = evals if steps is None else steps
        out = {name: 0 for name in kernels.LAUNCHES}
        out.update({k: v * segments for k, v in vocoder.items()})
        out.update(wavenet_gate=layers * evals * segments,
                   wavenet_out=layers * evals * segments,
                   viterbi_candidates=segments, stft_magnitude=stft * segments)
        if predictor == "unipc":
            out.update(unipc_predict=steps * segments, unipc_correct=steps * segments)
        elif predictor == "plms":
            out.update(plms_update=(steps + 1) * segments)
        else:
            out.update(ddpm_update=steps * segments)
        return out

    full, shallow = T_steps // interval, max((T_steps - 500) // interval, 2)
    speakers = engine.parse_speaker(0)
    requests = [
        ("inference (a) 24 s, Harvest + UniPC", len(song),
         lambda: engine.inference(tmp / "song.wav", tmp / "a.wav", seed=seed),
         tmp / "a.wav", expect(n_seg, full)),
        ("inference (b) 24 s, shallow skip_steps=500", len(song),
         lambda: engine.inference(tmp / "song.wav", tmp / "b.wav", skip_steps=500,
                                  seed=seed),
         tmp / "b.wav", expect(n_seg, shallow, stft=1)),
        ("forward (c) 2.97 s, Harvest + PLMS", len(short),
         lambda: engine.forward(short, speakers, noise_predictor="plms", seed=seed),
         None, expect(1, full + 1, full, "plms")),
        ("forward (c) 2.97 s, Harvest + naive", len(short),
         lambda: engine.forward(short, speakers, noise_predictor="naive", seed=seed),
         None, expect(1, full, full, "naive")),
    ]
    # warm-up, not counted: the first request of a bucket designs Harvest's
    # filter bank on the host and plans its FFTs; the first shallow one
    # builds K5's DFT basis on the host
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.inference(tmp / "song.wav", tmp / "warm.wav", seed=seed)
    engine.inference(tmp / "song.wav", tmp / "warm.wav", skip_steps=500, seed=seed)
    engine.forward(short, speakers, seed=seed)
    torch.cuda.synchronize()
    print(f"[file] warm-up (the 24 s file, again shallow, then the 2.97 s segment, "
          f"UniPC): {time.perf_counter() - t0:.3f} s")

    clock = StageClock()
    stft_calls = recording(mel, "stft_magnitude")
    viterbi_calls = recording(world, "viterbi_candidates")
    kernels.reset_launches()
    for label, n_samples, run, written, expected in requests:
        before = dict(kernels.LAUNCHES)
        shallow_request = "shallow" in label
        if shallow_request:
            clock.wrap(world, "harvest_f0", "Harvest")
            clock.wrap(engine.vocoder, "wav2spec", "wav2spec (K5)")
            clock.wrap(engine.text_features_extractor.model, "forward", "HubertSoft")
            clock.wrap(engine.model, "sample", "sample")
            clock.wrap(engine.vocoder, "spec2wav", "vocoder")
            stft_calls.start()
            viterbi_calls.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if shallow_request:
            clock.restore()
            stft_calls.stop()
            viterbi_calls.stop()
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        outs = [out] + ([load_wav(written)[0]] if written else [])
        ok = (
            all(len(o) == n_samples for o in outs)
            and all(np.isfinite(o).all() and np.abs(o).max() <= 1.0 for o in outs)
            and np.abs(out).max() > 0
            and grew == expected
        )
        print(f"[file] {label}: {secs:.3f} s for {n_samples / SR:.2f} s of audio, "
              f"RTF {secs / (n_samples / SR):.4f}, peak |wav| {np.abs(out).max():.3f}, "
              f"launches {({k: v for k, v in grew.items() if v})} {'ok' if ok else 'FAIL'}")
        if not ok:
            print(f"  expected {({k: v for k, v in expected.items() if v})}")
            report.failures.append(label)
        if shallow_request:
            parts = ", ".join(f"{k} {v:.3f} s" for k, v in clock.seconds.items())
            print(f"[file] where the shallow request's time went (synced host "
                  f"clock): {parts}")
    launches = dict(kernels.LAUNCHES)
    print(f"[file] launches over the file-to-file path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            report.failures.append(f"{name} never launched on the file-to-file path")

    # K5 and K8-cand on the inputs request (b) gave them, the tiles the path
    # runs: held against their plain versions and timed (summed per request)
    print("[file] K5 and K8-cand on request (b)'s own inputs")
    frames = "+".join(str((y.shape[1] - b.shape[0]) // h + 1) for y, b, h in stft_calls.calls)
    for yp, basis, hop in stft_calls.calls:
        r = measure_stft(report, yp, basis, hop, f"request (b) B={yp.shape[0]}")
        report.kernel("stft_magnitude", r["err"], r["ms"], r["plain"],
                      f"request (b), sum of its {len(stft_calls.calls)} calls at "
                      f"B=1, {frames} frames, n_fft 2048", *r["work"], r["lib"])
    frames = "+".join(str(a[2].shape[1]) for a in viterbi_calls.calls)
    for args in viterbi_calls.calls:
        r = measure_viterbi(report, args, f"request (b) T={args[2].shape[1]}")
        report.kernel("viterbi_candidates", r["err"], r["ms"], r["plain"],
                      f"request (b), sum of its {len(viterbi_calls.calls)} calls at "
                      f"B=1, {frames} frames, K=4", *r["work"])

    # a short shallow file with Harvest, through the kernels and through the
    # plain version of every kernel
    make_song(rng, tmp / "small.wav", [(1.5, 208.0)])
    run_small = lambda: engine.inference(tmp / "small.wav", tmp / "small_out.wav",  # noqa: E731
                                         skip_steps=500, seed=seed)
    got = run_small()
    with plain_path({
        (wavenet, "residual_block"): wavenet.residual_block_reference,
        (diffusion, "unipc_predict"): diffusion.unipc_predict_reference,
        (diffusion, "unipc_correct"): diffusion.unipc_correct_reference,
        (diffusion, "plms_update"): diffusion.plms_update_reference,
        (diffusion, "ddpm_update"): diffusion.ddpm_update_reference,
        (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
        (nsf_hifigan, "conv_transpose1d"): nsf_hifigan.conv_transpose1d_reference,
        (source, "nsf_source"): source.nsf_source_reference,
        (mel, "stft_magnitude"): mel.stft_magnitude_reference,
        (world, "viterbi_candidates"): pitch.viterbi_candidates_reference,
    }):
        ref = run_small()
    report.compare("file 1.5 s shallow with Harvest vs plain composition (wav)",
                   torch.from_numpy(got), torch.from_numpy(ref), 1e-2)
    report.finish("file to file")
    return launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "fish_diffusion_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))

    print("[device] " + torch.cuda.get_device_name(0)
          + f", torch {torch.__version__}, CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    from fish_diffusion_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build_all()
    print(f"[build] CUDA sources built in {time.perf_counter() - t0:.1f} s, one nvcc "
          f"each, all started together; each took "
          + ", ".join(f"{k} {v:.1f} s" for k, v in kernels.BUILD_SECONDS.items())
          + f" (sum {sum(kernels.BUILD_SECONDS.values()):.1f} s)")
    for name, log in kernels.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    report = Report()
    totals = phase_kernels(report, args.seed)
    phase_kernels_stft_viterbi(report, args.seed)
    engine = phase_serve(report, args.seed)
    launches = phase_file_to_file(report, engine, args.seed)

    entries = []
    for name, meta in kernels.KERNELS.items():
        k = report.kernels[name]
        entries.append(dict(
            name=f"{meta['id']} {name}", route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            bound_ms=k["bound_ms"],
            bound_by=max(k["bound_time"], key=k["bound_time"].get),
            library_ms=k["library_ms"], shape=k["shape"],
            **report.extra.get(name, {}),
        ))
    print(json.dumps(totals))
    print(smi)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
