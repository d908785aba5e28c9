#!/usr/bin/env python3
"""Drive the PyTorch port's SVC paths and vocoder training once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. device:  require CUDA, print the card's name and power limit, turn TF32
            off for every comparison.
2. build:   compile the CUDA sources in ``fish_diffusion_tpu_torch/csrc``,
            one ``nvcc`` each, all started together; print each kernel's
            registers and spills, and the TF32 tensor-core products in the
            SASS of K1's 3xTF32 kernels (mma.sync in the input backward and
            the weight gradients, wgmma in the forward and the gate
            backward; none fails).
3. kernels: every hand-written kernel against its plain PyTorch version at
            B=4 x 1024 frames, with median CUDA-event times of both (K2's and
            K3's Triton kernels by device time, ``device_ms``, with the
            host-paced reading beside), its bound (the larger of the bytes
            the function must move over 3.35 TB/s and the float32
            operations it needs over 67 TFLOP/s; over 495 / 3 TFLOP/s for
            the 3xTF32 tensor-core kernels) and, where one PyTorch call
            computes the same function, that call's time; K1's forward
            (gate and output product, 3xTF32 wgmma with prepare's split
            weights) beside the products alone by cuDNN / cuBLAS, its error
            against float64 no larger than the plain float32 version's, and
            the L2 traffic of its tiles; K1's split kernel on a sampling
            call's 40 weights (one launch) bit-equal to ``tf32_split``,
            timed beside its byte bound; K5 (an FFT) at n_fft 2048 and at the key shifts'
            2299 and 1933 (Bluestein), and at B=1 over a segment, and
            past shared memory (the four-step split path: n_fft 6000 in
            float64, forward and backward, n_fft 16384 in float32); K4 at
            every shape of one vocoder pass (TFLOP/s, share of its bound,
            cuDNN's convolution alone, a rerun bit-equal; summed by level
            into ``conv1d.pass_by_level``); then the whole 20-block
            denoiser eval and the whole vocoder against their plain
            compositions.
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
   pitch:   the same 24 s wav through ``inference`` once with each pitch
            extractor a config can name (ParselMouth, pYIN, CREPE at full
            capacity with seeded weights, DIO, YIN; UniPC): exact launches
            per request (K8-cand for ParselMouth, K8 pYIN and K8 CREPE once
            per segment), the median cents error of each segment's f0
            against the phrases' known f0 (at most 50; CREPE's random
            weights: finite only), stage seconds per segment (pitch with
            CREPE's network apart, HubertSoft, sample, vocoder) and RTF;
            K8 pYIN and K8 CREPE held against their plain versions on the
            requests' own inputs (paths and path scores identical), timed
            beside their bound, chip-wide and on one SM.
   convnext: (after istft_net) ``SVCInference`` from
            ``configs/denoiser_cn_hubert.py`` at full width with seeded
            weights (ChineseHubertSoft 12 x 768 with its gate of 10, ConvNext
            20 x 512 x 4: K10 in every block, NSF-HiFiGAN 512, ParselMouth):
            ``forward_batch`` of 4 x ~11.9 s with f0, a 2.97 s ``forward``,
            ``inference`` on the file phase's 24 s wav in full and shallow
            (``skip_steps`` 500); exact launches per request (K10 20 per
            eval), finite audio of the input's length, |wav| <= 1, request
            seconds, RTF, stage seconds per segment, peak memory; a short
            shallow file against the plain composition of every kernel
            (1e-2); K10 against its plain version on the batch request's own
            inputs at dilations 1, 2, 4, 8 (masked rows included; 1e-4 of
            scale, a rerun bit-equal), timed beside its bound and cuDNN's
            depthwise conv1d + F.layer_norm (two calls); the whole 20-block
            eval against its plain composition; then a 2.97 s ``forward``
            through ``configs/svc_cn_hubert_soft.py`` (gate 25, K1).
   diffusion_train: (after convnext) ``DiffusionTrainer.fit`` on
            ``configs/svc_hubert_soft.py`` at full width (WaveNet 20 x 512,
            batch 20 x 512 frames, float32, warmup-cosine AdamW, clip 0.5)
            over a synthetic SVC dataset: 12 steps (seconds per step and
            mel frames per second over the last 10, the ``wall_*``
            breakdown, peak memory, exact K1 launches per step), validation
            (loss, UniPC at interval 100, both mels vocoded by a random
            NSF-HiFiGAN) and a checkpoint at steps 6 and 12, a resume for 2
            more steps; 3 steps under ``torch.profiler`` (device time by
            kernel, idle share); the whole step through the kernels against
            the plain step (loss within 1e-5 relative; the backward through
            K1's kernels against the plain backward on one forward, every
            gradient within 1e-4 relative L2; the whole step's gradients
            within max(1e-4, 3 x the plain step's own move under mel x
            (1 + d)), the median of six paired comparisons, the plain step
            of each pair on the kernel step's side of every ReLU and the two
            forwards within 1e-4 of scale at the ReLUs' inputs; the state's
            digest, the training order drawn from the seed by the loader);
            K1's training kernels at the step's inputs for each dilation
            against their plain versions (1e-4 of scale, bit-equal on rerun,
            timed beside their bound; the training gate, serving's bits,
            beside ``F.conv1d``, and the output product at the step's
            shapes; the gate backward, 3xTF32 wgmma, beside both bounds and
            ``torch.mm``, its error against float64 no larger than the
            plain float32 version's, in the plan its rule picks;
            the input backward and the weight gradients, 3xTF32 on the
            tensor cores, beside both bounds and cuDNN's ``conv1d_input`` /
            ``conv1d_weight``, and the weight gradients beside
            ``conv1d_wgrad`` on the same shapes, the route they replace;
            one block's forward and backward against torch autograd of the
            plain block; the split kernel on the step's 40 weights, W_out
            in both layouts from one read, bit-equal to ``tf32_split``,
            beside the step's median).
   convnext_train: (after diffusion_train) the same on
            ``configs/denoiser_cn_hubert.py`` (ConvNext 20 x 512 x 4, its
            dataset set to ``NaiveSVCDataset``: the config's
            ``NaiveDenoiserDataset`` carries no pitches, which its DiffSVC
            model needs): 12 steps, validation and checkpoints at 6 and 12
            (K10 serving, K2, K3, K4), a resume, 3 profiled steps, exact
            K10 launches per step (the forward and the backward, one
            kernel with dh on chip and its slots' sum, 20 each), the whole
            step against the plain step (the same three gates); K10's
            backward on the step's own inputs at each dilation against the
            plain whole backward (1e-4 of each output's scale, bit-equal on
            rerun), timed beside its bound and the whole backward through
            cuDNN (autograd of the depthwise conv and the layer norm), and
            one block's forward and backward at each dilation against torch
            autograd of the plain block (1e-4 relative L2).
5. train:   ``VocoderTrainer.fit`` on ``configs/vocoder_nsf_hifigan.py`` at
            full width (NSF-HiFiGAN 512, MPD 2/3/5/7/11, 3-scale MSD, batch
            16 x 32768, float32) over a synthetic dataset: 2 warm-up and 6
            timed steps (seconds, audio seconds per second, stage split,
            peak memory, losses, exact launches per step), validation and a
            checkpoint; a resume from it; the same steps again from the
            seed with cuDNN's deterministic algorithms, so that the gate's
            state is a function of the seed (its digest printed); from
            there one step through the kernels against one
            through every plain version (every loss within 1e-4 relative;
            in six pairs at the audio x (1 + d), the plain step on the
            kernel step's side of every kink, ``pinned_kinks``, and every
            element the two forwards decide differently within 1e-4 of its
            input's scale from its kink: the median
            of the pairs' largest gradient errors within 1e-3 of its max or
            3x the plain step's own largest change under five ~1e-6 changes
            of the audio, whichever is larger: the kinks give float32 noise
            of 1e-4-1e-2 there; and each network's relative L2 gradient
            difference at most ``L2_RATIO_LIMIT`` times the plain step's
            largest own, with the five tensors that carry most of it
            printed); K5's forward at every STFT configuration of the
            step and each kernel of this slice (K5 backward, K6, the weight
            gradient, K4's input gradient, K3 backward) against its plain
            version (K5's backward against the plain version in float64,
            the exact function), timed beside its bound and the PyTorch
            call for the same function; K6 at every launch of the step (MSD
            layers 1, 2, 5 at the three scales, forward and input gradient:
            63 launches, per layer and mode and summed over the step, each
            launched twice, bit-equal); ``conv1d_wgrad`` at every distinct
            shape of the step's NSF-HiFiGAN generator backward (102 calls);
            K4 at every distinct shape of the generator's forward and input
            gradients (``conv1d.train``: every launch of the step, within
            1e-4 of the plain version's scale, beside cuDNN's convolution
            alone and the bound); each weight gradient and K4 shape launched
            twice, bit-equal.
6. train_v2: the same on ``configs/vocoder_refinegan.py`` (RefineGAN
            start_channels 16, hop 256, GAN flavor v2: MPD 2/3/5/7/11 + MRD
            at (1024, 120, 600), (2048, 240, 1200), (512, 50, 240), batch 16
            x 32768, float32): 2 warm-up and 5 timed steps, validation, a
            checkpoint and a resume, the gate's state built twice from the
            seed in one process (the linear resampling's gradient is a
            fixed-order gather: two digests that differ fail the run), the
            whole step against the plain versions (the same tolerances),
            then K6 2-D (forward, input
            gradient in its direct and transposed modes, weight gradient) at
            every layer of one MRD pass (the weight gradient's and the
            transposed mode's ms, TFLOP/s, share of their bound and cuDNN ms
            printed per layer and summed over the pass and the step; the
            forward's and the stride-1 input gradients' share of their bound
            too, each launched twice, bit-equal),
            ``conv1d_wgrad`` at every distinct shape of the step's RefineGAN
            generator backward (104 calls), K4 at every distinct shape of
            its forward and input gradients (``conv1d.train_v2``), K9 at the
            step's template and K5 at the step's MRD and mel shapes, each
            against its plain version and timed beside its bound and
            library call; each weight gradient launched twice, bit-equal.
   istft_net: (between pitch and train, on the serving engine) a
            full-width ``ISTFTNet`` (512 channels, upsample 8.8, n_fft 16,
            hop 8, seeded weights) set with ``set_vocoder``: ``forward_batch``
            of 4 x ~11.9 s with f0 and ``inference`` on the 24 s wav
            (Harvest, UniPC), exact launches (K5 istft once per vocoder
            pass), finite audio of the input's length (no output tanh: the
            peak is printed); a short request against the plain
            composition; K5 istft on the batch request's own spectra
            against its plain version and ``torch.istft``, and at n_fft 2048
            / hop 512.
7. train_sine: phase 6's path with ``template_generator="sine"``: 2
            warm-up and 4 timed steps, exact launches (K9 sine once a
            step), the gate's state built twice (as phase 6), the whole step against the plain step (phase 6's
            check), K9 sine at the step's template against its plain
            version.
8. align:   K7 at GlowTTS/VITS alignment shapes (B=32, T_y 1000, T_x 200,
            lengths per item), paths bit-equal to the plain version on
            random and on integer (tied) values; kernel and plain times.

Each phase prints its wall time.

The line before the last is a JSON object with one entry per kernel (its
``launches`` count the first path that runs it: the file-to-file path for
the serving kernels, the pitch path for K8 dense, the istft_net path for
K5 istft, the convnext path for K10, the vocoder training runs, the diffusion_train path for K1's
training kernels, the convnext_train path for K10's backward, the align phase for K7;
``launches_by_path`` every path; K5's and K8-cand's times are those of
the shallow request's own calls, with their B=4 times under ``batch4``; K8
dense's those of one request's three calls); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import itertools
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
# tensor cores (the SIMT kernels), and the float32 rate of a 3xTF32 product
# on the tensor cores (three TF32 products of 495 TFLOP/s dense per float32
# product: K1's input backward and weight gradients)
HBM_BYTES_PER_S, F32_FLOP_PER_S = 3.35e12, 67e12
TF32X3_FLOP_PER_S = 495e12 / 3


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


def device_ms(fn, reps: int = 40, iters: int = 5) -> float:
    """Median device milliseconds of one call of ``fn``: the stream is held
    by ``torch.cuda._sleep`` while the host enqueues ``reps`` calls between
    two CUDA events, so that the host's launch overhead (tens of
    microseconds a ctypes launch) does not show in a kernel that takes less.
    Where the device has reached the first event before the host has
    enqueued the last call (an autograd call's host work outlasting the
    hold), the host's pace would show: that run is dropped and the hold
    doubled. For kernels shorter than their launch; ``cuda_ms`` times the
    host's pace too."""
    import torch

    fn()
    hold, times = 20_000_000, []
    while len(times) < iters:
        torch.cuda._sleep(hold)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        if start.query() and hold < 2**31:  # the hold ran out first
            torch.cuda.synchronize()
            hold *= 2
            continue
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def timed_device_and_host(report, name: str, fn, ref):
    """(kernel ms, plain ms) of device time (``device_ms``), printed beside
    the host-paced readings (CUDA events around 20 back-to-back calls,
    ``cuda_ms``), which ``report.extra[name]`` keeps."""
    ms, plain = device_ms(fn), device_ms(ref, reps=10)
    host, plain_host = cuda_ms(fn, reps=20), cuda_ms(ref, reps=20)
    print(f"  {name}: kernel {ms:.4f} ms of device time (host-paced {host:.4f}), plain "
          f"{plain:.4f} (host-paced {plain_host:.4f})")
    report.extra.setdefault(name, {}).update(host_paced_ms=host, plain_host_paced_ms=plain_host)
    return ms, plain


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float, rate: float = F32_FLOP_PER_S):
    """(ms, "bytes" | "operations"): the least time the card could take, its
    ``flops`` at ``rate`` FLOP/s."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


def max_abs(a) -> float:
    if isinstance(a, (tuple, list)):
        return max(max_abs(x) for x in a)
    return float(a.float().abs().max())


def digest(tensors) -> str:
    """The first 16 hex digits of the SHA-256 of the tensors' bytes, in
    order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


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

    def compare_local(self, label, got, ref, scale, tol):
        """Every element against its own scale: |got - ref| <= tol * scale
        + 1e-35 (scale >= 0, ref's shape; the floor lies below float32's
        normal numbers, for scales that underflow). Returns the largest
        |got - ref| / scale."""
        err = (got.float() - ref.float()).abs()
        ratio = float((err / scale.clamp(min=1e-35)).max())
        ok = bool((err <= tol * scale + 1e-35).all()) and np.isfinite(ratio)
        mag = ref.float().abs()
        print(f"  {label}: max |err| / local scale {ratio:.3e} tol {tol:.0e} "
              f"{'ok' if ok else 'FAIL'} (max_abs_err {float(err.max()):.3e}; |ref| peak "
              f"{float(mag.max()):.3e}, median {float(mag.median()):.3e}; local scale "
              f"median {float(scale.median()):.3e})")
        if not ok:
            self.failures.append(label)
        return ratio

    def kernel(self, name, err, ms, plain_ms, shape="", n_bytes=0, flops=0,
               library_ms=None, rate=F32_FLOP_PER_S):
        """Accumulate one measured call (times, bound and library time add
        up over the calls of one entry; errors take the maximum); the bound
        counts ``flops`` at ``rate``."""
        entry = self.kernels.setdefault(name, dict(
            max_abs_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            bound_time=defaultdict(float), library_ms=None, shape=""))
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["shape"] = shape or entry["shape"]
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms
        if n_bytes or flops:
            t, by = bound(n_bytes, flops, rate)
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
    k1_forward = measure_k1_forward(report, base)
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
        if dtype == torch.float32:
            continue  # measure_k1_forward times the float32 kernels
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
            print(f"  {name} {tag} (the SIMT kernel, block_gemm): kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {traffic[name] / ms / 1e9:.0f} GB/s), "
                  f"plain {plain:.4f} ms")

    print("[kernels] K2 steps (UniPC, PLMS, naive), [4, 1024, 128] f32; times per "
          "launch: device time (device_ms) and host-paced (CUDA events around 20 "
          "back-to-back launches, which a Triton launch's host work paces)")
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
        ms, plain = timed_device_and_host(report, name, lambda: fn(*args),
                                          lambda: ref(*args))
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
    ms, plain = timed_device_and_host(
        report, "nsf_phase_base", lambda: source.nsf_phase_base(f0, SR, HOP),
        lambda: source.nsf_phase_base_reference(f0, SR, HOP))
    report.kernel("nsf_phase_base", err, ms, plain, "B=4 T=1024",
                  nbytes(f0, base_ref), 4 * B * T)
    margs = (f0, base_ref, rand_ini, noise, weight, bias, SR, HOP)
    err = report.compare("nsf_merge", source.nsf_merge(*margs),
                         source.nsf_merge_reference(*margs), 1e-4)
    ms, plain = timed_device_and_host(report, "nsf_merge", lambda: source.nsf_merge(*margs),
                                      lambda: source.nsf_merge_reference(*margs))
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
        # the pass summed by upsampling level (the output's length: conv_pre
        # at the frame rate, then each level's transposed conv, noise conv
        # and resblocks; conv_post with the last level)
        levels = defaultdict(lambda: defaultdict(float))
        for (name, xs, ws, *_), (x, (args, kwargs), count) in calls.items():
            label = f"{name} x{list(xs)} w{list(ws)} {kwargs_str(kwargs)}"
            got = real[name](x, *args, **kwargs)
            ref = refs[name](x, *args, **kwargs)
            err = report.compare(label, got, ref, 1e-4, relative=True)
            check_rerun(report, label, got, real[name](x, *args, **kwargs))
            ms = cuda_ms(lambda: real[name](x, *args, **kwargs), iters=5)
            plain = cuda_ms(lambda: refs[name](x, *args, **kwargs), iters=5)
            lib = cuda_ms(library[name](x, *args, **kwargs), iters=5)
            w = args[0]
            flops = 2 * got.numel() * w.shape[1] * w.shape[2] if name == "conv1d" \
                else 2 * x.numel() * w.shape[1] * w.shape[2]
            io = nbytes(x, w, args[1], got) + (
                nbytes(kwargs["residual"]) if kwargs.get("residual") is not None else 0)
            t_bound = bound(io, flops)[0]
            print(f"    x{count} per pass: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                  f"{t_bound / ms:.0%} of its bound {t_bound:.4f}), plain {plain:.4f} ms, "
                  f"cuDNN alone {lib:.4f} ms")
            report.kernel(name, err, ms * count, plain * count,
                          "sum over one vocoder pass, B=4 x 1024 frames",
                          io * count, flops * count, lib * count)
            level = levels[got.shape[1]]
            for k, v in (("calls", 1), ("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", t_bound), ("gflop", flops / 1e9)):
                level[k] += v * count
        calls.clear()
        by_level = {}
        print("  K4 over one pass by level (output length; kernel ms, TFLOP/s, share of "
              "bound, cuDNN alone ms, plain ms):")
        for T_out, d in sorted(levels.items()):
            by_level[f"T_out {T_out}"] = dict(d, tflops=d["gflop"] / d["ms"],
                                              share_of_bound=d["bound_ms"] / d["ms"])
            print(f"    T_out {T_out} ({int(d['calls'])} calls): {d['ms']:.3f} ms, "
                  f"{d['gflop'] / d['ms']:.1f} TFLOP/s, {d['bound_ms'] / d['ms']:.0%} of "
                  f"{d['bound_ms']:.3f}, cuDNN {d['library_ms']:.3f}, plain {d['plain_ms']:.3f}")
        report.extra.setdefault("conv1d", {})["pass_by_level"] = by_level

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
    with torch.inference_mode():
        ws = plan["w_conv"] + plan["w_out"]
        split = measure_weight_split(report, ws, [True] * len(ws), [False] * len(ws),
                                     "a sampling call's")
        report.kernel("wavenet_weight_split", split["max_abs_err"], split["ms"],
                      split["plain_ms"], f"the {len(ws)} weights of a sampling call's prepare "
                      f"(20 blocks, R=512), one launch", split["bytes"])
        prepare_ms = cuda_ms(lambda: denoiser.prepare(feats), iters=5)
    print(f"  prepare (20 blocks, B=4 T=1024): {prepare_ms:.3f} ms, of which the split of "
          f"the 40 weights {split['ms']:.4f} ms of device time, once a sampling call")
    report.finish("kernels")
    return dict(denoiser_eval_ms=ms_den, denoiser_eval_plain_ms=plain_den,
                vocoder_ms=ms_voc, vocoder_plain_ms=plain_voc, k1_forward=k1_forward,
                prepare_ms=prepare_ms, prepare_split=split)


def measure_weight_split(report: Report, ws, transposed, stored, label: str) -> dict:
    """K1's split kernel (``split_weights``, one launch) on ``ws`` against its
    plain version (``tf32_split`` of each weight, transposed and / or as
    stored): bit-equal (``max_abs_err`` 0), a rerun bit-equal, device times
    of both (``device_ms``), the bound of its bytes (each weight read once,
    each plane written once)."""
    import torch

    from fish_diffusion_tpu_torch.models import wavenet

    def flat(split):
        return [t for t in split[0] + split[1] if t is not None]

    got = flat(wavenet.split_weights(ws, transposed, stored))
    ref = flat(wavenet.split_weights_reference(ws, transposed, stored))
    same = len(got) == len(ref) and all(torch.equal(g, r) for g, r in zip(got, ref))
    err = max(max_err(g, r) for g, r in zip(got, ref))
    check_rerun(report, f"wavenet_weight_split ({label})", torch.cat([g.flatten() for g in got]),
                torch.cat([g.flatten() for g in
                           flat(wavenet.split_weights(ws, transposed, stored))]))
    if not same:
        report.failures.append(f"wavenet_weight_split ({label}): not bit-equal to tf32_split")
    ms = device_ms(lambda: wavenet.split_weights(ws, transposed, stored), reps=10)
    plain = device_ms(lambda: wavenet.split_weights_reference(ws, transposed, stored), reps=2)
    n_bytes = nbytes(*ws, *got)
    t_bound = bound(n_bytes, 0)[0]
    print(f"  wavenet_weight_split, {label} {len(ws)} weights into {len(got)} splits "
          f"({nbytes(*ws) / 1e6:.0f} MB read, {nbytes(*got) / 1e6:.0f} MB written) in one "
          f"launch: bit-equal to tf32_split {'ok' if same else 'FAIL'}; kernel {ms:.4f} ms of "
          f"device time ({t_bound / ms:.0%} of its byte bound {t_bound:.4f}), tf32_split "
          f"{plain:.4f} ms")
    return dict(weights=len(ws), splits=len(got), ms=ms, plain_ms=plain, bound_ms=t_bound,
                bytes=n_bytes, max_abs_err=err, bit_equal=same)


def measure_k1_forward(report: Report, a: dict) -> dict:
    """K1's float32 forward at B=4 T=1024 R=512 (the batch request's
    shapes): the gate (``wavenet_gate``) and the output product
    (``wavenet_out``) on the 3xTF32 wgmma core with ``prepare``'s split
    weights, each within 1e-3 of its plain version at d = 1, 2, 4, 8,
    reruns bit-equal, its largest error against the float64 product no
    larger than the plain float32 version's (cuBLAS) at the same inputs;
    device times of kernel, plain version and the products alone by cuBLAS
    / cuDNN (``torch.addmm`` and ``F.conv1d``, TF32 off; neither computes
    the kernel's whole function, so ``library_ms`` stays null); bound at
    ``TF32X3_FLOP_PER_S`` with the float32 SIMT bound beside; what the
    rule's plan reads from L2."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.models import wavenet

    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    x, skip, step, cond = a["x"], a["skip"], a["step"], a["cond"]
    w_conv, b_conv, w_out, b_out = a["w_conv"], a["b_conv"], a["w_out"], a["b_out"]
    cs, os_ = wavenet.split_weights([w_conv, w_out], [True, True], [False, False])[0]
    out = {}
    for d in (1, 2, 4, 8):
        gate_args = (x, step, cond, w_conv, b_conv, d)
        g_ref = wavenet.residual_gate_reference(*gate_args)
        g = wavenet.residual_gate(*gate_args, cs)
        err_g = report.compare(f"wavenet_gate f32 d={d}", g, g_ref, 1e-3)
        check_rerun(report, f"wavenet_gate d={d}", g, wavenet.residual_gate(*gate_args, cs))
        out_args = (g_ref, x, skip, w_out, b_out)
        o = wavenet.residual_out(*out_args, os_)
        err_o = report.compare(f"wavenet_out f32 d={d}", o,
                               wavenet.residual_out_reference(*out_args), 1e-3)
        check_rerun(report, f"wavenet_out d={d}", torch.cat(o), torch.cat(
            wavenet.residual_out(*out_args, os_)))
        report.kernel("wavenet_gate", err_g, 0.0, 0.0, "one block, B=4 T=1024 R=512 f32")
        report.kernel("wavenet_out", err_o, 0.0, 0.0, "one block, B=4 T=1024 R=512 f32")
        # against the float64 product: the kernel and the plain float32 version
        z64 = wavenet.gate_preactivation_reference(
            *(t.double() for t in (x, step, cond, w_conv, b_conv)), d)
        zk = wavenet.residual_gate_train(x, step, cond, w_conv, b_conv, d, cs)[1]
        zp = wavenet.gate_preactivation_reference(x, step, cond, w_conv, b_conv, d)
        o64 = wavenet.residual_out_reference(*(t.double() for t in out_args))
        o_plain = wavenet.residual_out_reference(*out_args)
        errs = dict(z_kernel=max_err(zk.double(), z64) / max_abs(z64),
                    z_plain=max_err(zp.double(), z64) / max_abs(z64),
                    out_kernel=max_err([t.double() for t in o], o64) / max_abs(o64),
                    out_plain=max_err([t.double() for t in o_plain], o64) / max_abs(o64))
        ok = errs["z_kernel"] <= errs["z_plain"] and errs["out_kernel"] <= errs["out_plain"]
        print(f"    d={d}: largest error / scale against float64: z {errs['z_kernel']:.3e} "
              f"(plain float32 {errs['z_plain']:.3e}), x' and skip' {errs['out_kernel']:.3e} "
              f"(plain float32 {errs['out_plain']:.3e}) {'ok' if ok else 'FAIL'}")
        out[f"f64_errors_d{d}"] = errs
        if not ok:
            report.failures.append(f"K1 forward d={d}: error against float64 above the plain "
                                   f"float32 version's")

    g = wavenet.residual_gate_reference(x, step, cond, w_conv, b_conv, 1)
    y_t = (x + step[:, None, :]).transpose(1, 2).contiguous()
    w_t = w_conv.reshape(3, R, 2 * R).permute(2, 1, 0).contiguous()
    g2, b_rep = g.reshape(-1, R), b_out
    fns = {
        "wavenet_gate": dict(
            kernel=lambda: wavenet.residual_gate(x, step, cond, w_conv, b_conv, 1, cs),
            plain=lambda: wavenet.residual_gate_reference(x, step, cond, w_conv, b_conv, 1),
            product=lambda: F.conv1d(y_t, w_t, padding=1, dilation=1),
            work=(nbytes(x, step, cond, w_conv, b_conv, x), 2 * B * T * 3 * R * 2 * R),
            product_is="F.conv1d, the dilated product alone"),
        "wavenet_out": dict(
            kernel=lambda: wavenet.residual_out(g, x, skip, w_out, b_out, os_),
            plain=lambda: wavenet.residual_out_reference(g, x, skip, w_out, b_out),
            product=lambda: torch.addmm(b_rep, g2, w_out),
            work=(nbytes(g, x, skip, w_out, b_out, x, skip), 2 * B * T * R * 2 * R),
            product_is="torch.addmm, the output product alone"),
    }
    for name, f in fns.items():
        ms, plain, product = (device_ms(f[k], reps=20) for k in ("kernel", "plain", "product"))
        t_bound, t_simt = bound(*f["work"], TF32X3_FLOP_PER_S)[0], bound(*f["work"])[0]
        flops = f["work"][1]
        print(f"  {name} f32: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{t_bound / ms:.0%} of its 3xTF32 bound {t_bound:.4f}, {t_simt / ms:.0%} of the "
              f"float32 SIMT bound {t_simt:.4f}); plain {plain:.4f} ms; {f['product_is']} "
              f"{product:.4f} ms (TF32 off)")
        report.kernel(name, 0.0, ms, plain, "one block, B=4 T=1024 R=512 f32", *f["work"],
                      rate=TF32X3_FLOP_PER_S)
        report.extra.setdefault(name, {}).update(
            bound_f32_simt_ms=t_simt, library_product_ms=product,
            library_product=f["product_is"], plan=kernels.load_library(
                "wavenet_block").wavenet_forward_plan(B, T, R))
        out[name] = dict(ms=ms, plain_ms=plain, product_ms=product,
                         bound_ms=t_bound, bound_f32_simt_ms=t_simt)

    # what the tiles read from L2 (every block reads its rows' A and its
    # columns' B, big and small, over all of K) and the rate at the time
    traffic = {}
    p = kernels.load_library("wavenet_block").wavenet_forward_plan(B, T, R)
    for name, K in (("wavenet_gate", 3 * R), ("wavenet_out", R)):
        bm = bn = 128 if p == 2 else 64
        blocks = -(-B * T // bm) * (2 * R // bn)
        tile_bytes = blocks * (bm + 2 * bn) * K * 4
        tb_s = tile_bytes / (out[name]["ms"] * 1e-3) / 1e12
        traffic[name] = dict(plan=p, tile_bytes=tile_bytes, tb_per_s=tb_s)
        print(f"  {name}: plan {p} reads {tile_bytes / 1e6:.0f} MB of tiles from L2 a launch, "
              f"{tb_s:.2f} TB/s at its time")
    out["l2_tiles"] = traffic
    return out


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


def stft_window(n_fft: int, win: int):
    """The Hann window of ``win`` centred in ``n_fft`` zeros, on the card:
    the window ``torch.stft`` is timed with beside K5."""
    import torch
    import torch.nn.functional as F

    pad = (n_fft - win) // 2
    return F.pad(torch.hann_window(win, device=DEVICE), (pad, n_fft - win - pad))


def measure_stft(report: Report, yp, n_fft: int, hop: int, win: int, label: str,
                 timed=True, exact=False):
    """K5 against its plain version on one input: 1e-4 relative, or, for the
    exact forward (float64, ``exact``), every magnitude within 1e-6 of its
    own value of the plain version run in float64; with ``timed``, the
    kernel's, the plain version's and ``torch.stft().abs()``'s times (the
    plain version and ``torch.stft`` in float64 beside the exact one)."""
    import torch

    from fish_diffusion_tpu_torch.ops import mel

    got = mel.stft_magnitude(yp, n_fft, hop, win, exact=exact)
    path = "power of two" if mel._fft_size(n_fft) == n_fft else \
        f"Bluestein, L={mel._fft_size(n_fft)}"
    name = (f"stft_magnitude{' exact (float64)' if exact else ''} {label}, "
            f"M={got.shape[0] * got.shape[2]} ({path})")
    y_in = yp.double() if exact else yp
    ref = mel.stft_magnitude_reference(y_in, n_fft, hop, win)
    if exact:
        report.compare_local(name, got, ref, ref.float(), 1e-6)
        err = max_err(got, ref)
    else:
        err = report.compare(name, got, ref, 1e-4, relative=True)
    out = dict(err=err, work=stft_work(yp, got, n_fft))
    if timed:
        window = stft_window(n_fft, win).to(y_in.dtype)
        out.update(
            ms=cuda_ms(lambda: mel.stft_magnitude(yp, n_fft, hop, win, exact=exact), iters=5),
            plain=cuda_ms(lambda: mel.stft_magnitude_reference(y_in, n_fft, hop, win),
                          iters=5),
            lib=cuda_ms(lambda: torch.stft(y_in, n_fft, hop, n_fft, window, center=False,
                                           return_complex=True).abs(), iters=5))
        t_bound, by = bound(*out["work"])
        out["bound"] = t_bound
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
    the kernels line); K5 there at n_fft 2048 (its power-of-two FFT) and at
    the key shifts' 2299 and 1933 (Bluestein), and at B=1 over a
    segment's length. The main path's own calls are held and timed in
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
    bluestein = {}
    for key_shift in (0, 2, -1):
        n_fft = int(np.round(2048 * 2 ** (key_shift / 12)))
        r = measure_stft(report, padded(y, n_fft), n_fft, HOP, n_fft, f"B=4 n_fft={n_fft}")
        report.kernel("stft_magnitude", r["err"], 0.0, 0.0)
        if key_shift == 0:
            report.batch4("stft_magnitude", r, f"B=4 x {n_samples} samples, n_fft 2048")
        else:
            bluestein[f"n_fft {n_fft} (key shift {key_shift:+d})"] = dict(
                ms=r["ms"], plain_ms=r["plain"], library_ms=r["lib"], bound_ms=r["bound"],
                max_abs_err=r["err"])
    report.extra.setdefault("stft_magnitude", {})["bluestein_batch4"] = bluestein
    print("[kernels] K5 at B=1, one segment of 1.5 s, 7.4 s and 1024 frames")
    for seconds in (1.5, 7.4, T * HOP / SR):
        y1 = torch.randn((1, int(seconds * SR)), generator=gen, device=DEVICE) * 0.3
        r = measure_stft(report, padded(y1, 2048), 2048, HOP, 2048,
                         f"B=1 {seconds:.2f} s", timed=False)
        report.kernel("stft_magnitude", r["err"], 0.0, 0.0)

    # the sizes shared memory does not hold (the split path: four-step FFTs
    # through device memory), which the kernel once refused
    print("[kernels] K5 past shared memory: n_fft 6000 in float64 (Bluestein, L 16384), "
          "forward and backward; n_fft 16384 in float32, forward; B=2 x 4 s")
    split = {}
    y2 = torch.randn((2, 4 * SR), generator=gen, device=DEVICE) * 0.3
    for n_fft, exact in ((6000, True), (16384, False)):
        yp = padded(y2, n_fft)
        fwd = lambda: mel.stft_magnitude(yp, n_fft, HOP, n_fft, exact=exact)  # noqa: E731
        ref_fwd = lambda: mel.stft_magnitude_reference(  # noqa: E731
            yp.double() if exact else yp, n_fft, HOP, n_fft)
        got, ref = fwd(), ref_fwd()
        label = f"stft_magnitude n_fft={n_fft} {'float64' if exact else 'float32'}"
        err = report.compare(label, got.double(), ref.double(), 1e-5 * max_abs(ref))
        ms, plain, _ = timed_triple(fwd, ref_fwd, iters=3)
        row = dict(max_abs_err=err, ms=ms, plain_ms=plain)
        print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms")
        if exact:
            g = torch.randn(got.shape, generator=gen, device=DEVICE)
            bwd = lambda: mel.stft_backward(g, yp, n_fft, HOP, n_fft)  # noqa: E731
            ref_bwd = lambda: mel.stft_backward_reference(  # noqa: E731
                g.double(), yp.double(), n_fft, HOP, n_fft)
            got_g, ref_g = bwd(), ref_bwd()
            row["backward_max_abs_err"] = report.compare(
                f"stft_backward n_fft={n_fft} float64", got_g.double(), ref_g,
                1e-5 * max_abs(ref_g))
            row["backward_ms"], row["backward_plain_ms"], _ = timed_triple(bwd, ref_bwd,
                                                                           iters=3)
            print(f"    backward: kernel {row['backward_ms']:.4f} ms, plain "
                  f"{row['backward_plain_ms']:.4f} ms")
        split[f"n_fft {n_fft}"] = row
    report.extra.setdefault("stft_magnitude", {})["split_path"] = split

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
    arguments, (args, kwargs) per call (the tensors are not copied), between
    ``start`` and ``stop``, or inside a ``with`` block. With ``key``, only
    the first call of each ``key(args, kwargs)`` is kept, with its count:
    ``calls`` is then {key: [args, kwargs, count]}."""

    def __init__(self, module, name: str, key=None):
        self.module, self.name, self.key = module, name, key
        self.calls = {} if key else []
        self.fn = getattr(module, name)

    def start(self):
        @functools.wraps(self.fn)
        def call(*args, **kwargs):
            if self.key is None:
                self.calls.append((args, kwargs))
            else:
                entry = self.calls.setdefault(self.key(args, kwargs), [args, kwargs, 0])
                entry[2] += 1
            return self.fn(*args, **kwargs)

        setattr(self.module, self.name, call)

    def stop(self):
        setattr(self.module, self.name, self.fn)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()


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


class _view:
    """A module (``torch``, ``torch.nn.functional``) with some of its
    functions replaced (``over``)."""

    def __init__(self, base, over: dict):
        self._base, self._over = base, over

    def __getattr__(self, name):
        return self._over[name] if name in self._over else getattr(self._base, name)


class pinned_kinks:
    """A network's kinks, in call order: the ReLUs, leaky ReLUs, absolute
    values, clamps and max-pools that the modules in ``namespaces`` call
    through an attribute ((module, "F") or (module, "torch")), and the fused
    input activation (``in_slope``) of the functions in ``slopes`` ((module,
    name): K4's convs, kernel or plain). Without ``other`` it records each
    kink's decision (the side taken, or the max-pool's argmax) and, with
    ``inputs``, its input; given ``other`` (another run's record, the same
    calls in the same order) each kink takes the side ``other`` took, with
    its gradient, so that two forwards whose float32 rounding differs are
    differentiated on the same side of every kink. A pinned run keeps, by
    kind, ``flips`` (the elements the two decided differently) and
    ``near`` (the largest distance of such an element from its kink over
    the input's scale), and where ``other`` kept its inputs, ``gaps`` (each
    call's largest difference from ``other``'s input over its scale)."""

    def __init__(self, namespaces=(), slopes=(), other=None, inputs=False):
        self.namespaces, self.slopes, self.other = list(namespaces), list(slopes), other
        self.inputs, self.met, self.record, self.gaps, self.saved = inputs, 0, [], [], {}
        self.flips, self.near = defaultdict(int), {}

    def _kink(self, kind, x, run, decide, pin, edge=None):
        """``run()`` the call as made, ``decide(x, out)`` its decision,
        ``pin(decision)`` the call on another decision; ``edge(x, out,
        decision)`` each element's distance from its kink (default |x|)."""
        import torch

        if self.other is None:
            out = run()
            self.record.append((kind, x.detach() if self.inputs else None,
                                decide(x.detach(), out)))
            return out
        i, self.met = self.met, self.met + 1
        if i >= len(self.other.record) or self.other.record[i][0] != kind:
            raise SystemExit(f"chip_smoke: kink {i} ({kind}) does not match the recorded run")
        _, x_k, d_k = self.other.record[i]
        with torch.no_grad():
            xd = x.detach()
            scale = max(float(xd.abs().max()), 1e-30)
            if x_k is not None:
                self.gaps.append(float((xd - x_k).abs().max()) / scale)
            out = run() if kind == "max_pool1d" else None
            flipped = decide(xd, out) != d_k
            self.flips[kind] += int(flipped.sum())
            if bool(flipped.any()):
                dist = float((edge(xd, out, d_k) if edge else xd.abs())[flipped].max()) / scale
                self.near[kind] = max(self.near.get(kind, 0.0), dist)
        return pin(d_k)

    def _over(self, base):
        import torch

        def relu(x, inplace=False):
            return self._kink("relu", x, lambda: base.relu(x), lambda v, _: v > 0,
                              lambda d: torch.where(d, x, 0.0))

        def leaky_relu(x, negative_slope=0.01, inplace=False):
            return self._kink("leaky_relu", x, lambda: base.leaky_relu(x, negative_slope),
                              lambda v, _: v > 0,
                              lambda d: torch.where(d, x, x * negative_slope))

        def abs_(x):
            return self._kink("abs", x, lambda: base.abs(x), lambda v, _: v > 0,
                              lambda d: torch.where(d, x, -x))

        def clamp(x, min=None, max=None):
            def inside(v, _):
                d = torch.ones_like(v, dtype=torch.bool)
                d = d if min is None else d & (v >= min)
                return d if max is None else d & (v <= max)
            def edge(v, _, d):
                bounds = [b for b in (min, max) if b is not None]
                return torch.stack([(v - b).abs() for b in bounds]).amin(0)
            return self._kink("clamp", x, lambda: base.clamp(x, min, max), inside,
                              lambda d: torch.where(d, x, x.detach().clamp(min, max)), edge)

        def max_pool1d(x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                       return_indices=False):
            assert not return_indices
            out = self._kink(
                "max_pool1d", x,
                lambda: base.max_pool1d(x, kernel_size, stride, padding, dilation, ceil_mode,
                                        True),
                lambda v, out: out[1], lambda d: x.gather(-1, d),
                lambda v, out, d: (out[0] - v.gather(-1, d)).abs())
            return out[0] if isinstance(out, tuple) else out

        over = {"relu": relu, "leaky_relu": leaky_relu, "abs": abs_, "clamp": clamp,
                "max_pool1d": max_pool1d}
        return {k: f for k, f in over.items() if hasattr(base, k)}

    def _slope(self, fn):
        import inspect

        import torch

        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            slope, x = bound.arguments.get("in_slope"), bound.arguments["x"]
            if slope is None:
                return fn(*args, **kwargs)

            def pin(d):
                bound.arguments["x"] = torch.where(d, x, x * slope)
                bound.arguments["in_slope"] = None
                return fn(*bound.args, **bound.kwargs)

            return self._kink("in_slope", x, lambda: fn(*args, **kwargs), lambda v, _: v > 0,
                              pin)
        return call

    def __enter__(self):
        for mod, name in self.namespaces:
            base = getattr(mod, name)
            self.saved[(mod, name)] = base
            setattr(mod, name, _view(base, self._over(base)))
        for mod, name in self.slopes:
            fn = getattr(mod, name)
            self.saved[(mod, name)] = fn
            setattr(mod, name, self._slope(fn))
        return self

    def __exit__(self, *exc):
        for (mod, name), obj in self.saved.items():
            setattr(mod, name, obj)
        self.saved = {}

    def check(self) -> tuple:
        """A pinned run: (the largest gap, 0 without inputs; the flips by
        kind); every recorded kink was met."""
        if self.met != len(self.other.record) or not self.met:
            raise SystemExit(f"chip_smoke: {self.met} kinks met, "
                             f"{len(self.other.record)} recorded")
        return max(self.gaps, default=0.0), dict(self.flips)


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
                     "wavenet_weight_split": 1, "unipc_predict": evals, "unipc_correct": evals,
                     **per_vocoder})

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


# the file-to-file phases' song: (seconds, f0) of three phrases
PHRASES = ((7.4, 220.0), (7.4, 247.0), (7.4, 196.0))
VOCODER_LAUNCHES = {"conv_transpose1d": 5, "conv1d": 2 + 5 * (1 + 3 * 6),
                    "nsf_phase_base": 1, "nsf_merge": 1}
# iSTFTNet: 2 levels of (transposed conv, noise conv, 3 fans x 6 convs),
# conv_pre and conv_post; the source at trunk rate; one K5 istft
ISTFT_NET_LAUNCHES = {"conv_transpose1d": 2, "conv1d": 2 + 2 * (1 + 3 * 6),
                      "nsf_phase_base": 1, "nsf_merge": 1, "istft": 1}


def expect_file_launches(layers, segments, evals, steps=None, predictor="unipc", stft=0,
                         pitch_kernel="viterbi_candidates", vocoder=None):
    """The launches of a request of ``segments`` segments: the denoiser's
    two K1 kernels per block and eval and its weights' split once a
    segment (a WaveNet's, ``layers`` > 0), the sampler's K2 updates, one
    vocoder pass (``vocoder``: NSF-HiFiGAN's unless given), K5 for a
    shallow request and the pitch extractor's decoder (Harvest's and
    ParselMouth's K8-cand, pYIN's and CREPE's K8 dense, none for DIO and
    YIN) once per segment."""
    from fish_diffusion_tpu_torch import kernels

    steps = evals if steps is None else steps
    out = {name: 0 for name in kernels.LAUNCHES}
    out.update({k: v * segments for k, v in (vocoder or VOCODER_LAUNCHES).items()})
    out.update(wavenet_gate=layers * evals * segments, wavenet_out=layers * evals * segments,
               wavenet_weight_split=segments if layers else 0, stft_magnitude=stft * segments)
    if pitch_kernel:
        out[pitch_kernel] = segments
    if predictor == "unipc":
        out.update(unipc_predict=steps * segments, unipc_correct=steps * segments)
    elif predictor == "plms":
        out.update(plms_update=(steps + 1) * segments)
    else:
        out.update(ddpm_update=steps * segments)
    return out


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
    song = make_song(rng, tmp / "song.wav", PHRASES)
    rms = np.sqrt(np.mean(song ** 2) + 1e-12)
    normed = np.clip(song * (10 ** (-23 / 20) / (rms + 1e-12)), -1, 1)
    n_seg = len(list(slice_audio(normed, SR)))
    short = make_phrase(rng, 256 * HOP / SR, 233.0).astype(np.float32)
    print(f"[file] {len(song) / SR:.2f} s wav, {n_seg} segments (bucket 1024 each); "
          f"a {len(short) / SR:.2f} s segment for PLMS and naive")

    def expect(*args, **kwargs):
        return expect_file_launches(layers, *args, **kwargs)

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
    path_kernels = {k for *_, expected in requests for k, v in expected.items() if v}
    for name in path_kernels:
        if launches[name] <= 0:
            report.failures.append(f"{name} never launched on the file-to-file path")

    # K5 and K8-cand on the inputs request (b) gave them: held against their
    # plain versions and timed (summed per request)
    print("[file] K5 and K8-cand on request (b)'s own inputs")
    frames = "+".join(str((y.shape[1] - n) // h + 1)
                      for (y, n, h, _), _ in stft_calls.calls)
    for (yp, n_fft, hop, win), _ in stft_calls.calls:
        r = measure_stft(report, yp, n_fft, hop, win, f"request (b) B={yp.shape[0]}")
        report.kernel("stft_magnitude", r["err"], r["ms"], r["plain"],
                      f"request (b), sum of its {len(stft_calls.calls)} calls at "
                      f"B=1, {frames} frames, n_fft 2048", *r["work"], r["lib"])
    frames = "+".join(str(a[2].shape[1]) for a, _ in viterbi_calls.calls)
    for args, _ in viterbi_calls.calls:
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
        (mel, "stft_magnitude"): plain_stft_magnitude,
        (world, "viterbi_candidates"): pitch.viterbi_candidates_reference,
    }):
        ref = run_small()
    report.compare("file 1.5 s shallow with Harvest vs plain composition (wav)",
                   torch.from_numpy(got), torch.from_numpy(ref), 1e-2)
    report.finish("file to file")
    return launches


def song_f0_truth(t_abs: np.ndarray) -> np.ndarray:
    """The known f0 of ``make_song(rng, path, PHRASES)`` at times ``t_abs``
    (seconds), NaN outside the phrases' interiors (0.1 s from each end)."""
    truth = np.full(len(t_abs), np.nan)
    start = int(0.3 * SR)
    for seconds, f0 in PHRASES:
        t = t_abs - start / SR
        inside = (t > 0.1) & (t < seconds - 0.1)
        truth[inside] = f0 * (1 + 0.015 * np.sin(2 * np.pi * 5 * t[inside]))
        start += int(seconds * SR) + int(0.6 * SR)
    return truth


class timed_calls:
    """``obj``'s calls timed into ``clock.seconds[label]`` (a device sync on
    each side); every other attribute passes through."""

    def __init__(self, obj, clock, label):
        self.obj, self.clock, self.label = obj, clock, label

    def __call__(self, *args, **kwargs):
        import torch

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.obj(*args, **kwargs)
        torch.cuda.synchronize()
        self.clock.seconds[self.label] += time.perf_counter() - t0
        return out

    def __getattr__(self, name):
        return getattr(self.obj, name)


def path_score(delta0, log_obs, log_A, path):
    """The float32 score of one item's path [T] (the recursion's own sum)."""
    import torch

    p = path.long()
    score = delta0[p[0]]
    for t in range(1, len(p)):
        score = score + log_A[p[t - 1], p[t]] + log_obs[t, p[t]]
    return float(score) if torch.isfinite(score) else float("-inf")


def measure_dense_viterbi(report: Report, name: str, log_obs, log_A, label: str):
    """K8 dense (``pyin_viterbi`` or ``crepe_viterbi``) against its plain
    version on one call's own inputs: the paths and their scores identical;
    kernel and plain times beside the bound, chip-wide and on one SM (one
    item is one dependent chain)."""
    from fish_diffusion_tpu_torch.extractors import pitch

    wrapper = getattr(pitch, name)
    delta0 = (pitch.pyin_delta0 if name == "pyin_viterbi" else pitch.crepe_delta0)(log_obs)
    got = wrapper(log_obs, log_A)
    ref = pitch.viterbi_dense_reference(delta0, log_obs, log_A)
    err = report.compare(f"{name} path {label} (identical)", got, ref, 0.0)
    s_got = path_score(delta0[0], log_obs[0], log_A, got[0])
    s_ref = path_score(delta0[0], log_obs[0], log_A, ref[0])
    print(f"  {name} path score {label}: kernel {s_got!r}, plain {s_ref!r} "
          f"{'ok' if s_got == s_ref else 'FAIL'}")
    if s_got != s_ref:
        report.failures.append(f"{name} path score {label}")
    ms = cuda_ms(lambda: wrapper(log_obs, log_A), iters=5)
    plain = cuda_ms(lambda: pitch.viterbi_dense_reference(delta0, log_obs, log_A),
                    iters=2, warmup=1)
    B_, T_, S_ = log_obs.shape
    flops = 2 * B_ * (T_ - 1) * S_ * S_
    one_sm = flops / (F32_FLOP_PER_S / 132) * 1e3
    t_bound, by = bound(nbytes(delta0, log_obs, log_A, got), flops)
    print(f"    kernel {ms:.4f} ms ({ms * 1e3 / max(T_ - 1, 1):.3f} us per frame), plain "
          f"{plain:.4f} ms, bound {t_bound:.5f} ms ({by}), one SM {one_sm:.4f} ms")
    return dict(err=err, ms=ms, plain=plain, one_sm=one_sm,
                work=(nbytes(delta0, log_obs, log_A, got), flops))


def phase_pitch(report: Report, engine, seed: int):
    """The fifth slice's path: ``inference`` on the file phase's 24 s wav
    with each pitch extractor a config can name (ParselMouth, pYIN, CREPE
    at full capacity with seeded weights, DIO, YIN; UniPC): exact launches
    per request, the median cents error of the f0 each segment was given
    against the phrases' known f0 (CREPE's random weights: finite only),
    stage seconds per segment and RTF; then K8 pYIN and K8 CREPE against
    their plain versions on the requests' own inputs."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.extractors import crepe, pitch
    from fish_diffusion_tpu_torch.registry import PITCH_EXTRACTORS
    from fish_diffusion_tpu_torch.utils.audio import slice_audio

    cfg = engine.config.model.diffusion
    layers, evals = cfg.denoiser.residual_layers, cfg.timesteps // cfg.sampler_interval
    rng = np.random.default_rng(seed + 20)  # the file phase's song, sample for sample
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_pitch_"))
    song = make_song(rng, tmp / "song.wav", PHRASES)
    rms = np.sqrt(np.mean(song ** 2) + 1e-12)
    normed = np.clip(song * (10 ** (-23 / 20) / (rms + 1e-12)), -1, 1)
    segments = list(slice_audio(normed, SR))
    n_seg = len(segments)
    extractors = [
        ("ParselMouth", dict(type="ParselMouthPitchExtractor"), "viterbi_candidates"),
        ("pYIN", dict(type="PyinPitchExtractor"), "pyin_viterbi"),
        ("CREPE", dict(type="CrepePitchExtractor", model="full", random_init=True,
                       seed=seed + 3), "crepe_viterbi"),
        ("DIO", dict(type="DioPitchExtractor"), None),
        ("YIN", dict(type="YinPitchExtractor"), None),
    ]
    built = {label: PITCH_EXTRACTORS.build(dict(cfg_, keep_zeros=False), device=DEVICE)
             for label, cfg_, _ in extractors}
    harvest = engine.pitch_extractor
    print(f"[pitch] {len(song) / SR:.2f} s wav, {n_seg} segments (bucket 1024 each), "
          f"UniPC; extractors {', '.join(built)}")

    def run(out_name):
        return engine.inference(tmp / "song.wav", tmp / out_name, seed=seed)

    # warm-up, not counted: plans the FFTs, designs DIO's filter bank, lets
    # cuDNN pick CREPE's convolutions
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for label, ext in built.items():
        engine.pitch_extractor = ext
        run("warm.wav")
    torch.cuda.synchronize()
    print(f"[pitch] warm-up (each extractor once): {time.perf_counter() - t0:.3f} s")

    given = {}  # label -> the f0 curve each segment was given, in order

    def keep_pitches(label, fn):
        def call(*args, **kwargs):
            seg = fn(*args, **kwargs)
            given[label].append(None if seg is None else seg["pitches_true"])
            return seg
        return call

    kernels.reset_launches()
    seconds = {}
    for label, _, kernel in extractors:
        engine.pitch_extractor = built[label]
        given[label] = []
        engine._prepare_segment = keep_pitches(label, engine._prepare_segment)
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(f"{label}.wav")
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        del engine._prepare_segment
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        expected = expect_file_launches(layers, n_seg, evals, pitch_kernel=kernel)
        ok = (len(out) == len(song) and np.isfinite(out).all() and 0 < np.abs(out).max() <= 1.0
              and grew == expected and len(given[label]) == n_seg
              and all(g is not None and np.isfinite(g).all() for g in given[label]))
        print(f"[pitch] inference 24 s, {label}: {seconds[label]:.3f} s, RTF "
              f"{seconds[label] / (len(song) / SR):.4f}, peak |wav| {np.abs(out).max():.3f}, "
              f"launches {({k: v for k, v in grew.items() if v})} {'ok' if ok else 'FAIL'}")
        if not ok:
            print(f"  expected {({k: v for k, v in expected.items() if v})}")
            report.failures.append(f"pitch: inference with {label}")
    launches = dict(kernels.LAUNCHES)
    print(f"[pitch] launches over the pitch path: {launches}")
    for name in ("viterbi_candidates", "pyin_viterbi", "crepe_viterbi"):
        if launches[name] <= 0:
            report.failures.append(f"{name} never launched on the pitch path")

    # each segment's f0 against the phrases' known f0, in the phrases'
    # interiors
    for label in built:
        cents = []
        for (start, _), f0 in zip(segments, given[label]):
            truth = song_f0_truth((start + np.arange(len(f0)) * HOP) / SR)
            inside = np.isfinite(truth)
            cents.append(np.abs(1200 * np.log2(np.maximum(f0[inside], 1e-3) / truth[inside])))
        cents = np.concatenate(cents)
        median = float(np.median(cents))
        if label == "CREPE":
            print(f"[pitch] {label}: f0 finite over {len(cents)} frames (random weights: "
                  f"median {median:.1f} cents from the known f0, not held)")
            continue
        ok = median <= 50.0
        print(f"[pitch] {label}: median |f0 error| {median:.2f} cents over {len(cents)} "
              f"frames (p90 {np.percentile(cents, 90):.2f}), limit 50 "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            report.failures.append(f"pitch: {label} median {median:.1f} cents")

    # stage seconds per segment, with the K8 dense inputs recorded
    print("[pitch] stage seconds per segment (synced host clock; a second run of each)")
    pyin_calls = recording(pitch, "pyin_viterbi")
    crepe_calls = recording(crepe, "crepe_viterbi")
    for label in built:
        clock = StageClock()
        ext = built[label]
        engine.pitch_extractor = timed_calls(ext, clock, "pitch")
        if label == "CREPE":
            clock.wrap(ext.model, "forward", "CREPE net")
        clock.wrap(engine.text_features_extractor.model, "forward", "HubertSoft")
        clock.wrap(engine.model, "sample", "sample")
        clock.wrap(engine.vocoder, "spec2wav", "vocoder")
        calls = {"pYIN": pyin_calls, "CREPE": crepe_calls}.get(label)
        if calls:
            calls.start()
        run(f"{label}_clocked.wav")
        if calls:
            calls.stop()
        clock.restore()
        parts = ", ".join(f"{k} {v / n_seg:.4f}" for k, v in clock.seconds.items())
        print(f"[pitch] {label}: {parts} s per segment")
    engine.pitch_extractor = harvest

    for name, calls in (("pyin_viterbi", pyin_calls), ("crepe_viterbi", crepe_calls)):
        shapes = "+".join(str(a[0].shape[1]) for a, _ in calls.calls)
        print(f"[pitch] {name} on the request's own inputs ({len(calls.calls)} calls, "
              f"T = {shapes}, S = {calls.calls[0][0][0].shape[2]})")
        one_sm = 0.0
        for (log_obs, log_A), _ in calls.calls:
            r = measure_dense_viterbi(report, name, log_obs, log_A,
                                      f"B=1 T={log_obs.shape[1]}")
            one_sm += r["one_sm"]
            report.kernel(name, r["err"], r["ms"], r["plain"],
                          f"sum of one 24 s request's {len(calls.calls)} calls at B=1, "
                          f"T = {shapes}, S = {log_obs.shape[2]}", *r["work"])
        report.extra[name] = dict(bound_one_sm_ms=one_sm)
    report.finish("pitch")
    return launches


def istft_work(real, out, n_fft: int):
    """Bytes and float32 operations the inverse STFT needs, whatever the
    kernel does: the spectrum read once, the audio written once; per frame
    an inverse real FFT of n_fft points (2.5 n log2 n), the window's n
    products and n overlap-add sums; a division per output sample."""
    frames = real.shape[0] * real.shape[2]
    flops = frames * (2.5 * n_fft * np.log2(n_fft) + 2 * n_fft) + out.numel()
    return 2 * nbytes(real) + nbytes(out) + 4 * n_fft, flops


def istft_scale(real, imag, n_fft: int, hop: int):
    """Each output sample's own scale for the inverse STFT of real + i imag:
    the window-weighted, envelope-divided overlap-add of each covering
    frame's bound (2 / n_fft) sum_k (|re| + |im|) on its inverse DFT,
    trimmed as the output is. A float32 inverse STFT errs by a small
    multiple of eps times it; a wrong one by the order of it. It is the
    plain istft of a spectrum whose frames hold only that bound, at DC."""
    import torch

    from fish_diffusion_tpu_torch.ops import mel

    dc = torch.zeros_like(real)
    dc[:, 0] = (real.abs() + imag.abs()).sum(1) * 2.0
    return mel.istft_reference(dc, torch.zeros_like(imag), n_fft, hop)


def measure_istft(report: Report, real, imag, n_fft: int, hop: int, label: str):
    """K5 istft against its plain version on one input, every output sample
    within 1e-5 of its own scale (``istft_scale``), timed beside
    ``torch.istft`` and its bound."""
    import torch

    from fish_diffusion_tpu_torch.ops import mel

    got = mel.istft(real, imag, n_fft, hop)
    ref = mel.istft_reference(real, imag, n_fft, hop)
    ratio = report.compare_local(f"istft {label}", got, ref,
                                 istft_scale(real, imag, n_fft, hop), 1e-5)
    window = torch.hann_window(n_fft, device=DEVICE)
    spec = torch.complex(real, imag)
    ms, plain, lib = timed_triple(lambda: mel.istft(real, imag, n_fft, hop),
                                  lambda: mel.istft_reference(real, imag, n_fft, hop),
                                  lambda: torch.istft(spec, n_fft, hop, n_fft, window,
                                                      center=True))
    work = istft_work(real, got, n_fft)
    t_bound, by = bound(*work)
    print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.istft {lib:.4f} ms, bound "
          f"{t_bound:.4f} ms ({by})")
    return dict(err=max_err(got, ref), ratio=ratio, ms=ms, plain=plain, lib=lib, work=work)


def phase_istft_net(report: Report, engine, seed: int):
    """The sixth slice's serving path: a full-width ``ISTFTNet`` (seeded
    random weights) set on the serving engine; ``forward_batch`` of 4 x
    ~11.9 s with f0 and ``inference`` on the file phase's 24 s wav
    (Harvest, UniPC), exact launches per request, finite audio of the
    input's length; a short request through the kernels against the plain
    composition, each spectrum element and wav sample against its own
    scale; K5 istft against its plain version and ``torch.istft`` at the
    batch request's shape on standard normal spectra and on the request's
    own, and at n_fft 2048 / hop 512."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.models import wavenet
    from fish_diffusion_tpu_torch.models.vocoders import istft_net, nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import mel
    from fish_diffusion_tpu_torch.utils.audio import load_wav, slice_audio

    t0 = time.perf_counter()
    vocoder = istft_net.ISTFTNet(
        random_init=True, seed=seed + 6, sampling_rate=SR, mel_channels=MEL,
        use_natural_log=engine.config.model.vocoder.get("use_natural_log", True),
        device=DEVICE)
    nsf = engine.vocoder
    engine.set_vocoder(vocoder)
    print(f"[istft_net] ISTFTNet (512 channels, upsample 8.8, ResBlock1 3/7/11, n_fft 16, "
          f"hop 8) built in {time.perf_counter() - t0:.1f} s and set on the serving engine")
    cfg = engine.config.model.diffusion
    layers, evals = cfg.denoiser.residual_layers, cfg.timesteps // cfg.sampler_interval
    rng = np.random.default_rng(seed + 70)
    batch = [make_request_audio(rng, n) for n in (524288, 520000, 515000, 510000)]
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_istft_"))
    song = make_song(np.random.default_rng(seed + 20), tmp / "song.wav", PHRASES)
    rms = np.sqrt(np.mean(song ** 2) + 1e-12)
    n_seg = len(list(slice_audio(np.clip(song * (10 ** (-23 / 20) / (rms + 1e-12)), -1, 1),
                                 SR)))
    speakers = engine.parse_speaker(0)

    def expect(segments, pitch_kernel):
        return expect_file_launches(layers, segments, evals, pitch_kernel=pitch_kernel,
                                    vocoder=ISTFT_NET_LAUNCHES)

    requests = [
        ("forward_batch 4 x ~11.9 s with f0 (bucket 1024)",
         lambda: engine.forward_batch([a for a, _ in batch], speakers, seed=seed,
                                      pitches_list=[f for _, f in batch]),
         [len(a) for a, _ in batch], expect(1, None)),
        ("inference 24 s, Harvest + UniPC",
         lambda: [engine.inference(tmp / "song.wav", tmp / "out.wav", seed=seed)],
         [len(song)], expect(n_seg, "viterbi_candidates")),
    ]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, run, _, _ in requests:
        run()
    torch.cuda.synchronize()
    print(f"[istft_net] warm-up (each request once): {time.perf_counter() - t0:.3f} s")

    istft_calls = recording(mel, "istft")
    kernels.reset_launches()
    for i, (label, run, lengths, expected) in enumerate(requests):
        before = dict(kernels.LAUNCHES)
        if i == 0:
            istft_calls.start()
        clock = StageClock()
        clock.wrap(engine.model, "sample", "sample")
        clock.wrap(vocoder, "spec2wav", "vocoder")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = run()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        clock.restore()
        istft_calls.stop()
        audio_secs = sum(lengths) / SR
        if i == 1:  # the written file too
            outs, lengths = outs + [load_wav(tmp / "out.wav")[0]], lengths * 2
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        peak = max(float(np.abs(o).max()) for o in outs)
        ok = ([len(o) for o in outs] == lengths
              and all(np.isfinite(o).all() and np.abs(o).max() > 0 for o in outs)
              and grew == expected)
        print(f"[istft_net] {label}: {secs:.3f} s for {audio_secs:.2f} s of audio, RTF "
              f"{secs / audio_secs:.4f}, peak |wav| {peak:.3e} (no output tanh), launches "
              f"{({k: v for k, v in grew.items() if v})} {'ok' if ok else 'FAIL'}; synced "
              "stage clocks: " + ", ".join(f"{k} {v:.4f} s" for k, v in clock.seconds.items()))
        if not ok:
            print(f"  expected {({k: v for k, v in expected.items() if v})}")
            report.failures.append(f"istft_net: {label}")
    launches = dict(kernels.LAUNCHES)
    print(f"[istft_net] launches over the path: {launches}")
    for name in {k for *_, expected in requests for k, v in expected.items() if v}:
        if launches[name] <= 0:
            report.failures.append(f"{name} never launched on the istft_net path")

    # a short request through the kernels and through the plain version of
    # every kernel. The random iSTFTNet's spectrum is exp of a random conv
    # (peaks near 1e15, most frames far below), so each element is held
    # against its own scale: the spectrum against its magnitude, each wav
    # sample against ``istft_scale`` of the plain run's spectrum
    small, small_f0 = make_request_audio(rng, 96 * HOP)
    run_small = lambda: engine.forward(small, speakers, seed=seed, pitches=small_f0)  # noqa: E731
    with recording(mel, "istft") as got_calls:
        got = run_small()
    with plain_path({
        (wavenet, "residual_block"): wavenet.residual_block_reference,
        (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
        (nsf_hifigan, "conv_transpose1d"): nsf_hifigan.conv_transpose1d_reference,
        (source, "nsf_source"): source.nsf_source_reference,
        (mel, "istft"): mel.istft_reference,
    }), recording(mel, "istft") as ref_calls:
        ref = run_small()
    (g_re, g_im, n_fft, hop), _ = got_calls.calls[0]
    (r_re, r_im, _, _), _ = ref_calls.calls[0]
    mag = torch.sqrt(r_re * r_re + r_im * r_im)
    report.compare_local("istft_net serve 1 x 1.1 s vs plain composition: the generator's "
                         "spectrum (real, imag) against its magnitude",
                         torch.cat([g_re, g_im]), torch.cat([r_re, r_im]),
                         torch.cat([mag, mag]), 1e-3)
    report.compare_local("istft_net serve 1 x 1.1 s vs plain composition: the wav against "
                         "each sample's scale", torch.from_numpy(got), torch.from_numpy(ref),
                         istft_scale(r_re, r_im, n_fft, hop)[0, : len(ref)].cpu(), 1e-3)

    (real, imag, n_fft, hop), _ = istft_calls.calls[0]
    shape = f"B={real.shape[0]} x {real.shape[2]} frames, n_fft {n_fft}, hop {hop}"
    print(f"[istft_net] K5 istft at the forward_batch request's shape, {shape}: standard "
          "normal spectra, then the request's own")
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 71)
    r = measure_istft(report, *[torch.randn(real.shape, generator=gen, device=DEVICE)
                                for _ in range(2)], n_fft, hop, f"{shape}, randn")
    report.kernel("istft", r["err"], r["ms"], r["plain"],
                  f"the forward_batch request's shape, {shape}, standard normal spectra",
                  *r["work"], r["lib"])
    own = measure_istft(report, real, imag, n_fft, hop, f"{shape}, the request's own")
    report.extra["istft"] = dict(request_spectra=dict(
        shape=shape, max_abs_err=own["err"], max_err_over_local_scale=own["ratio"],
        ms=own["ms"], plain_ms=own["plain"], library_ms=own["lib"]))
    print("[istft_net] K5 istft at n_fft 2048, hop 512, B=4 x 1024 frames")
    big = [torch.randn((B, 1025, T), generator=gen, device=DEVICE) for _ in range(2)]
    r2 = measure_istft(report, *big, 2048, 512, "n_fft=2048 B=4 F=1024")
    t2, by2 = bound(*r2["work"])
    report.extra["istft"]["n_fft_2048"] = dict(
        shape="B=4 x 1024 frames, n_fft 2048, hop 512", max_abs_err=r2["err"], ms=r2["ms"],
        plain_ms=r2["plain"], library_ms=r2["lib"], bound_ms=t2, bound_by=by2)
    engine.set_vocoder(nsf)
    report.finish("istft_net")
    return launches


def k10_work(x, out, C: int):
    """Bytes and float32 operations K10 needs: x, cond and out once, the
    step projections, the mask and the parameters; per element the pre-add
    (2), 7 taps and the bias (14) and the norm (8: the sum, the squared
    deviation, the normalisation with scale and bias)."""
    B_, T_, _ = x.shape
    return 3 * nbytes(x) + 4 * B_ * C + B_ * T_ + 4 * 10 * C, 24 * out.numel()


def measure_k10(report: Report, args, d: int, label: str) -> dict:
    """K10 against its plain version on one call's own inputs (1e-4 of the
    plain version's scale, a rerun bit-equal), timed beside its bound and
    beside cuDNN's depthwise ``F.conv1d(groups=C)`` + ``F.layer_norm`` (two
    calls, on the pre-added and masked input laid out [B, C, T])."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch.models import convnext

    x, step, cond, mask, k, b, ln_w, ln_b = args
    got = convnext.depthwise_conv7_norm(*args, d)
    ref = convnext.depthwise_conv7_norm_reference(*args, d)
    err = report.compare(f"depthwise_conv7_norm {label}", got, ref, 1e-4, relative=True)
    check_rerun(report, f"depthwise_conv7_norm {label}", got,
                convnext.depthwise_conv7_norm(*args, d))
    C = x.shape[-1]
    y = x + step[:, None, :] + cond
    if mask is not None:
        y = y.masked_fill(mask[:, :, None], 0.0)
    y_t = y.transpose(1, 2).contiguous()
    w = k.t().contiguous()[:, None, :]

    def library():
        h = F.conv1d(y_t, w, b, padding=3 * d, dilation=d, groups=C)
        return F.layer_norm(h.transpose(1, 2), (C,), ln_w, ln_b, convnext.LN_EPS)

    lib_err = max_err(library(), ref)
    ms = device_ms(lambda: convnext.depthwise_conv7_norm(*args, d))
    plain = device_ms(lambda: convnext.depthwise_conv7_norm_reference(*args, d), reps=10)
    lib = device_ms(library)
    events_ms = cuda_ms(lambda: convnext.depthwise_conv7_norm(*args, d), iters=20)
    work = k10_work(x, got, C)
    t_bound, by = bound(*work)
    print(f"    device: kernel {ms:.4f} ms ({work[1] / ms / 1e9:.2f} TFLOP/s, {t_bound / ms:.0%} "
          f"of its bound {t_bound:.4f} ms, {by}), plain {plain:.4f} ms, cuDNN depthwise "
          f"conv1d + F.layer_norm {lib:.4f} ms (two calls; max_abs_err {lib_err:.2e}); one "
          f"launch between events, host pace included: {events_ms:.4f} ms")
    return dict(err=err, ms=ms, plain=plain, lib=lib, work=work, bound=t_bound, by=by,
                events_ms=events_ms)


def expect_convnext_launches(layers, segments, evals, **kwargs):
    """``expect_file_launches`` with K10 once a block and eval in place of
    K1's two kernels."""
    out = expect_file_launches(0, segments, evals, **kwargs)
    out["depthwise_conv7_norm"] = layers * evals * segments
    return out


def phase_convnext(report: Report, seed: int):
    """The twelfth slice's path: ``SVCInference`` from
    ``configs/denoiser_cn_hubert.py`` at full width with seeded weights
    (ChineseHubertSoft 12 x 768 with its gate of 10, ConvNext 20 x 512 x 4,
    NSF-HiFiGAN 512, ParselMouth pitch): ``forward_batch`` of 4 x ~11.9 s
    with f0, a 2.97 s ``forward``, ``inference`` on the file phase's 24 s
    wav in full and shallow (``skip_steps`` 500), and a 2.97 s ``forward``
    through ``configs/svc_cn_hubert_soft.py`` (WaveNet, gate 25): exact
    launches per request, finite audio of the input's length, |wav| <= 1,
    request seconds, RTF, stage seconds, peak memory; a short shallow file
    against the plain composition of every kernel; K10 against its plain
    version on the batch request's own inputs at each dilation; the whole
    20-block eval against its plain composition."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.config import Config
    from fish_diffusion_tpu_torch.extractors import pitch
    from fish_diffusion_tpu_torch.inference.svc import SVCInference
    from fish_diffusion_tpu_torch.models import convnext, diffusion
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import mel
    from fish_diffusion_tpu_torch.utils.audio import load_wav, slice_audio

    def build(config, offset):
        cfg = Config.fromfile(ROOT / "configs" / config)
        cfg.preprocessing.text_features_extractor.update(
            checkpoint_path=None, random_init=True, seed=seed + offset)
        cfg.model.vocoder.update(checkpoint_path=None, random_init=True, seed=seed + offset + 1)
        engine = SVCInference(cfg, device=DEVICE)
        engine.init_random(seed + offset + 2)
        return engine

    t0 = time.perf_counter()
    engine = build("denoiser_cn_hubert.py", 80)
    torch.cuda.synchronize()
    den_cfg = engine.config.model.diffusion
    layers, evals = den_cfg.denoiser.num_layers, den_cfg.timesteps // den_cfg.sampler_interval
    hubert = engine.text_features_extractor.model
    print(f"[convnext] engine built at full width in {time.perf_counter() - t0:.1f} s "
          f"(ChineseHubertSoft {len(hubert.encoder.layers)}x768 gate {hubert.gate_size}, "
          f"ConvNext {layers}x{den_cfg.denoiser.dim}x{den_cfg.denoiser.mlp_factor}, "
          f"NSF-HiFiGAN 512, {type(engine.pitch_extractor).__name__})")

    rng = np.random.default_rng(seed + 80)
    batch = [make_request_audio(rng, n) for n in (524288, 520000, 515000, 510000)]
    short, short_f0 = make_request_audio(rng, 256 * HOP)
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_convnext_"))
    song = make_song(np.random.default_rng(seed + 20), tmp / "song.wav", PHRASES)
    rms = np.sqrt(np.mean(song ** 2) + 1e-12)
    n_seg = len(list(slice_audio(np.clip(song * (10 ** (-23 / 20) / (rms + 1e-12)), -1, 1),
                                 SR)))
    speakers = engine.parse_speaker(0)
    shallow = max((den_cfg.timesteps - 500) // den_cfg.sampler_interval, 2)

    def expect(*args, **kwargs):
        return expect_convnext_launches(layers, *args, **kwargs)

    requests = [
        ("forward_batch 4 x ~11.9 s with f0 (bucket 1024)",
         lambda: engine.forward_batch([a for a, _ in batch], speakers, seed=seed,
                                      pitches_list=[f for _, f in batch]),
         [len(a) for a, _ in batch], None, expect(1, evals, pitch_kernel=None)),
        ("forward 2.97 s with f0 (bucket 256)",
         lambda: [engine.forward(short, speakers, seed=seed, pitches=short_f0)],
         [len(short)], None, expect(1, evals, pitch_kernel=None)),
        ("inference 24 s, ParselMouth + UniPC",
         lambda: [engine.inference(tmp / "song.wav", tmp / "a.wav", seed=seed)],
         [len(song)], tmp / "a.wav", expect(n_seg, evals)),
        ("inference 24 s, ParselMouth, shallow skip_steps=500",
         lambda: [engine.inference(tmp / "song.wav", tmp / "b.wav", skip_steps=500,
                                   seed=seed)],
         [len(song)], tmp / "b.wav", expect(n_seg, shallow, stft=1)),
    ]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _, run, *_ in requests:
        run()
    torch.cuda.synchronize()
    print(f"[convnext] warm-up (each request once): {time.perf_counter() - t0:.3f} s")

    k10_calls = recording(convnext, "depthwise_conv7_norm",
                          key=lambda args, kwargs: int(args[8]))
    seconds = {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for i, (label, run, lengths, written, expected) in enumerate(requests):
        before = dict(kernels.LAUNCHES)
        if i == 0:
            k10_calls.start()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = run()
        torch.cuda.synchronize()
        secs = seconds[label] = time.perf_counter() - t0
        k10_calls.stop()
        audio_secs = sum(lengths) / SR
        if written:
            outs, lengths = outs + [load_wav(written)[0]], lengths * 2
        grew = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
        peak = max(float(np.abs(o).max()) for o in outs)
        ok = ([len(o) for o in outs] == lengths
              and all(np.isfinite(o).all() and 0 < np.abs(o).max() <= 1.0 for o in outs)
              and grew == expected)
        print(f"[convnext] {label}: {secs:.3f} s for {audio_secs:.2f} s of audio, RTF "
              f"{secs / audio_secs:.4f}, peak |wav| {peak:.3f}, launches "
              f"{({k: v for k, v in grew.items() if v})} {'ok' if ok else 'FAIL'}")
        if not ok:
            print(f"  expected {({k: v for k, v in expected.items() if v})}")
            report.failures.append(f"convnext: {label}")
    launches = dict(kernels.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[convnext] launches over the path: {launches}; peak device memory "
          f"{peak_gib:.2f} GiB")
    for name in {k for *_, expected in requests for k, v in expected.items() if v}:
        if launches[name] <= 0:
            report.failures.append(f"{name} never launched on the convnext path")

    # where the file requests' time goes (a second, clocked run of each)
    stages = {}
    for label, kwargs in (("full", {}), ("shallow", dict(skip_steps=500))):
        clock = StageClock()
        engine.pitch_extractor = timed_calls(engine.pitch_extractor, clock, "ParselMouth")
        clock.wrap(engine.text_features_extractor.model, "forward", "ChineseHubertSoft")
        clock.wrap(engine.model, "sample", "sample")
        clock.wrap(engine.vocoder, "spec2wav", "vocoder")
        if kwargs:
            clock.wrap(engine.vocoder, "wav2spec", "wav2spec (K5)")
        engine.inference(tmp / "song.wav", tmp / "clocked.wav", seed=seed, **kwargs)
        clock.restore()
        engine.pitch_extractor = engine.pitch_extractor.obj
        stages[label] = {k: v / n_seg for k, v in clock.seconds.items()}
        print(f"[convnext] inference 24 s {label}, seconds per segment (synced host clock): "
              + ", ".join(f"{k} {v:.4f}" for k, v in stages[label].items()))

    # a short shallow file through the kernels and through the plain
    # version of every kernel
    rng_small = np.random.default_rng(seed + 81)
    make_song(rng_small, tmp / "small.wav", [(1.5, 208.0)])
    run_small = lambda: engine.inference(tmp / "small.wav", tmp / "small_out.wav",  # noqa: E731
                                         skip_steps=500, seed=seed)
    got = run_small()
    with plain_path({
        (convnext, "depthwise_conv7_norm"): convnext.depthwise_conv7_norm_reference,
        (diffusion, "unipc_predict"): diffusion.unipc_predict_reference,
        (diffusion, "unipc_correct"): diffusion.unipc_correct_reference,
        (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
        (nsf_hifigan, "conv_transpose1d"): nsf_hifigan.conv_transpose1d_reference,
        (source, "nsf_source"): source.nsf_source_reference,
        (mel, "stft_magnitude"): plain_stft_magnitude,
        (pitch, "viterbi_candidates"): pitch.viterbi_candidates_reference,
    }):
        ref = run_small()
    report.compare("convnext file 1.5 s shallow with ParselMouth vs plain composition (wav)",
                   torch.from_numpy(got), torch.from_numpy(ref), 1e-2)

    # K10 on the batch request's own inputs, one launch at each dilation
    n_calls = sum(count for *_, count in k10_calls.calls.values())
    print(f"[convnext] K10 on the forward_batch request's own inputs: the first block of "
          f"each dilation (of {n_calls} launches)")
    by_dilation = {}
    for d in sorted(k10_calls.calls):
        args, _, _ = k10_calls.calls[d]
        x = args[0]
        padded = int(args[3].sum()) if args[3] is not None else 0
        label = f"d={d} B={x.shape[0]} T={x.shape[1]} C={x.shape[2]}, {padded} masked rows"
        with torch.inference_mode():  # the parameters require grad; K10 has no backward
            r = measure_k10(report, args[:8], d, label)
        by_dilation[f"d={d}"] = dict(ms=r["ms"], events_ms=r["events_ms"],
                                     plain_ms=r["plain"], library_ms=r["lib"],
                                     bound_ms=r["bound"], bound_by=r["by"],
                                     tflops=r["work"][1] / r["ms"] / 1e9,
                                     share_of_bound=r["bound"] / r["ms"],
                                     max_abs_err=r["err"])
        report.kernel("depthwise_conv7_norm", r["err"], r["ms"], r["plain"],
                      f"sum of one launch at each dilation 1, 2, 4, 8 on the forward_batch "
                      f"request's own inputs, B={x.shape[0]} T={x.shape[1]} C={x.shape[2]}",
                      *r["work"], r["lib"])
    if sorted(by_dilation) != ["d=1", "d=2", "d=4", "d=8"]:
        report.failures.append(f"K10 recorded at dilations {sorted(by_dilation)}")
    report.extra["depthwise_conv7_norm"] = dict(
        by_dilation=by_dilation, timing="device_ms: the stream held while 40 launches "
        "are enqueued; events_ms: one launch between events, host pace included",
        library="cuDNN depthwise F.conv1d(groups=C) + F.layer_norm: two calls")

    # the whole 20-block eval against its plain composition
    denoiser = engine.model.diffusion.denoise_fn
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 82)
    lens = torch.tensor([len(a) // HOP for a, _ in batch], device=DEVICE)
    masks = torch.arange(T, device=DEVICE)[None, :] >= lens[:, None]
    feats = torch.randn((B, T, 256), generator=gen, device=DEVICE)
    x_t = torch.randn((B, T, MEL), generator=gen, device=DEVICE)
    steps = torch.full((B,), 500.0, device=DEVICE)
    with torch.inference_mode():
        plan = denoiser.prepare(feats, masks)
        run_den = lambda: denoiser(x_t, steps, None, x_masks=masks, plan=plan)  # noqa: E731
        got_den = run_den()
        ms_den = cuda_ms(run_den)
        with plain_path({(convnext, "depthwise_conv7_norm"):
                         convnext.depthwise_conv7_norm_reference}):
            ref_den = run_den()
            plain_den = cuda_ms(run_den)
    report.compare("convnext denoiser eval (20 x 512 x 4, B=4 x 1024)", got_den, ref_den, 1e-3,
                   relative=True)
    print(f"  convnext denoiser eval: kernels {ms_den:.3f} ms, plain {plain_den:.3f} ms")
    del engine, plan
    torch.cuda.empty_cache()

    # configs/svc_cn_hubert_soft.py: ChineseHubertSoft (gate 25) before WaveNet
    soft = build("svc_cn_hubert_soft.py", 90)
    gate = soft.text_features_extractor.model.gate_size
    w_cfg = soft.config.model.diffusion.denoiser
    w_layers = w_cfg.residual_layers
    soft.forward(short, soft.parse_speaker(0), seed=seed, pitches=short_f0)  # warm-up
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = soft.forward(short, soft.parse_speaker(0), seed=seed, pitches=short_f0)
    torch.cuda.synchronize()
    secs = seconds["svc_cn_hubert_soft forward 2.97 s"] = time.perf_counter() - t0
    soft_launches = dict(kernels.LAUNCHES)
    expected = expect_file_launches(w_layers, 1, evals, pitch_kernel=None)
    ok = (len(out) == len(short) and np.isfinite(out).all() and 0 < np.abs(out).max() <= 1.0
          and soft_launches == expected and gate == 25)
    print(f"[convnext] svc_cn_hubert_soft.py (ChineseHubertSoft gate {gate}, WaveNet "
          f"{w_layers}x{w_cfg.residual_channels}) forward 2.97 s with f0: {secs:.3f} s, RTF "
          f"{secs / (len(short) / SR):.4f}, peak |wav| {np.abs(out).max():.3f}, launches "
          f"{({k: v for k, v in soft_launches.items() if v})} {'ok' if ok else 'FAIL'}")
    if not ok:
        report.failures.append("convnext: svc_cn_hubert_soft.py forward")
    del soft
    report.finish("convnext")
    return launches, dict(request_s=seconds, peak_gib=peak_gib, stage_s_per_segment=stages,
                          denoiser_eval_ms=ms_den, denoiser_eval_plain_ms=plain_den)


TRAIN_B, TRAIN_SEG = 16, 32768
# relative changes of the audio whose gradient moves give a training step's
# float32 noise floor (the largest; ``drive_training``)
FLOOR_SCALES = (1e-6, -1e-6, 2e-6, -2e-6, 3e-6)
# the most a network's relative L2 gradient difference, kernels vs plain,
# may exceed the largest of the plain step's own moves: 3 x the largest
# ratio recorded on an H100 over every training path's runs (12.8)
L2_RATIO_LIMIT = 3 * 12.8


def vocoder_kinks() -> dict:
    """The kinks of a vocoder training step (``pinned_kinks``' sites): the
    discriminators' leaky ReLUs and the losses' absolute values, max-pools
    and clamps (``models/discriminators.py``), the log-mel's clamp
    (``ops/mel.py``), RefineGAN's own leaky ReLUs, and the generators'
    convolutions' fused input activation (K4's ``in_slope``, kernel or
    plain)."""
    from fish_diffusion_tpu_torch.models import discriminators
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, refinegan
    from fish_diffusion_tpu_torch.ops import mel

    return dict(namespaces=[(discriminators, "F"), (discriminators, "torch"), (mel, "torch"),
                            (refinegan, "F")],
                slopes=[(nsf_hifigan, "conv1d"), (nsf_hifigan, "conv_transpose1d")])


def make_vocoder_dataset(rng, root: Path):
    """32 training and 2 validation clips of 2-4 s, harmonic phrases with a
    known f0 (``make_phrase``), as ``.npy`` dicts {path, audio, pitches,
    sampling_rate} (the preprocessing contract; pitches at frame rate)."""
    for split, n in (("train", 32), ("valid", 2)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            seconds, f0 = rng.uniform(2.0, 4.0), rng.uniform(110.0, 440.0)
            audio = make_phrase(rng, seconds, f0).astype(np.float32)
            t = np.arange(len(audio) // HOP + 1) * HOP / SR
            np.save(root / split / f"{i}.npy", {
                "path": f"{split}/{i}.wav", "audio": audio,
                "pitches": (f0 * (1 + 0.015 * np.sin(2 * np.pi * 5 * t))).astype(np.float32),
                "sampling_rate": SR})


def train_launches_per_step(gen_cfg, n_mels: int, n_stft: int = 3) -> dict:
    """Kernel launches one v1 GAN step implies, from the model's structure.

    Generator forward: conv_pre, per level one transposed conv, one noise
    conv and fans x 6 resblock convs, conv_post (all K4), the source (K3).
    Generator backward: K4 input gradients for every conv but conv_pre (the
    mel is data), the noise convs' through K4's transposed mode where they
    are strided; a weight gradient for every conv; K3's backward once.
    STFT: the generator's mel of the real audio, then each mel and STFT
    scale on real and generated audio; a backward per scale on the
    generated. K6: layers 1, 2, 5 of the 3 MSD scales in four passes (D
    real, D fake, G real, G fake), an input gradient in the three passes
    with a graph, a weight gradient in the two of the D phase."""
    levels = len(gen_cfg["upsample_rates"])
    res = levels * len(gen_cfg["resblock_kernel_sizes"]) * 6
    strided_noise = levels - 1  # the last level's noise conv is 1 x 1
    k6 = 3 * 3
    return {
        "conv1d": (2 + levels + res) + (levels + res + 1 + (levels - strided_noise)),
        "conv_transpose1d": levels + strided_noise,
        "nsf_phase_base": 1, "nsf_merge": 1, "nsf_merge_backward": 1,
        "stft_magnitude": 1 + 2 * n_mels + 2 * n_stft,
        "stft_backward": n_mels + n_stft,
        "grouped_conv1d": k6 * 4 + k6 * 3,
        "conv1d_wgrad": (2 + 2 * levels + res) + k6 * 2,
    }


def timed_triple(fn, ref, lib=None, iters=5):
    """(kernel ms, plain ms, library ms or None), CUDA-event medians."""
    return (cuda_ms(fn, iters=iters), cuda_ms(ref, iters=iters),
            cuda_ms(lib, iters=iters) if lib is not None else None)


def check_rerun(report: Report, label: str, got, again) -> bool:
    """A kernel launched twice on the same inputs must give the same bits
    (its partial sums are added in an order fixed by the shapes)."""
    import torch

    same = bool(torch.equal(got, again))
    if not same:
        print(f"  {label}: a second launch differs from the first FAIL")
        report.failures.append(f"{label} rerun")
    return same


def measure_wgrad_calls(report: Report, calls, tag: str) -> dict:
    """conv1d_wgrad at each distinct shape among a step's recorded calls
    (``(x, g, K, stride, dilation, padding)``, ``slope_a`` / ``slope_b``):
    within 1e-4 of the plain version's scale, a second launch bit-equal,
    kernel, plain and cuDNN (``conv1d_weight``) times and the bound, each
    shape weighted by its count in the step."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch.ops import blocked_conv

    keyed, first = defaultdict(int), {}
    for args, kw in calls:
        a, bm, K, stride, dil, pad = args
        key = (tuple(a.shape), tuple(bm.shape), K, stride, dil, pad, kw.get("slope_a"),
               kw.get("slope_b"))
        keyed[key] += 1
        first.setdefault(key, (a.detach(), bm.detach()))
    rows, total = [], defaultdict(float)
    for key, count in keyed.items():
        (_, _, K, s, d, p, sa, sb), (a, bm) = key, first[key]
        CA, CB = a.shape[2], bm.shape[2]
        fn = lambda: blocked_conv.conv1d_wgrad(a, bm, K, s, d, p, 1, sa, sb)  # noqa: E731
        ref_fn = lambda: blocked_conv.conv1d_wgrad_reference(a, bm, K, s, d, p, 1, sa, sb)  # noqa: E731
        got, ref = fn(), ref_fn()
        label = (f"conv1d_wgrad ({tag}) a{list(a.shape)} bm{list(bm.shape)} k{K} s{s} d{d}"
                 + (f" act_a {sa}" if sa is not None else "")
                 + (f" act_b {sb}" if sb is not None else ""))
        err = report.compare(label, got, ref, 1e-4 * max_abs(ref))
        check_rerun(report, label, got, fn())
        at = (F.leaky_relu(a, sa) if sa is not None else a).transpose(1, 2).contiguous()
        bt = (F.leaky_relu(bm, sb) if sb is not None else bm).transpose(1, 2).contiguous()
        ms, plain, lib = timed_triple(
            fn, ref_fn, lambda: torch.nn.grad.conv1d_weight(at, (CB, CA, K), bt, s, p, d))
        flops = 2 * bm.shape[0] * bm.shape[1] * K * CA * CB
        t_bound = bound(nbytes(a, bm, got), flops)[0]
        print(f"    x{count}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{t_bound / ms:.0%} of its bound {t_bound:.4f}), plain {plain:.4f} ms, "
              f"cuDNN {lib:.4f} ms")
        rows.append(dict(shape=label, count=count, max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=t_bound, tflops=flops / ms / 1e9))
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", t_bound), ("gflop", flops / 1e9)):
            total[k] += count * v
    print(f"  conv1d_wgrad over the {sum(keyed.values())} calls of one {tag} step "
          f"({len(keyed)} shapes): kernel {total['ms']:.4f} ms "
          f"({total['gflop'] / total['ms']:.1f} TFLOP/s, {total['bound_ms'] / total['ms']:.0%} "
          f"of its bound {total['bound_ms']:.4f}), cuDNN {total['library_ms']:.4f} ms, plain "
          f"{total['plain_ms']:.4f} ms")
    return dict(calls=sum(keyed.values()), shapes=rows, **total)


def k4_key(args, kwargs):
    """The shape of one ``nsf_hifigan._launch_conv`` call (every launch of
    K4, the forward and the input gradients): name, transposed, the input's
    and the packed weight's shapes, T_out, K, stride, dilation, padding,
    the slope, a residual and the tanh."""
    name, transposed, x, w, bias, res, *rest = args
    return (name, transposed, tuple(x.shape), tuple(w.shape), res is not None, *rest)


def measure_k4_calls(report: Report, calls, tag: str) -> dict:
    """K4 at each distinct shape among a training step's recorded launches
    (``k4_key``: the generator's forward, and its input gradients through
    K4's direct and transposed modes): within 1e-4 of the plain version's
    scale, a second launch bit-equal, kernel, plain and cuDNN (the
    convolution alone) times and the bound, each shape weighted by its
    count in the step."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan

    rows, total = [], defaultdict(float)
    for key, (args, kwargs, count) in calls.items():
        # copies: a packed weight can be a view of a parameter (a k = 1
        # conv's permute is contiguous already) that the optimizer has
        # updated in place since
        with torch.no_grad():
            args = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
        name, transposed, x, w_packed, bias, res, T_out, K, s, d, p, slope, tanh = args
        B, T_in, C_in = x.shape
        C_out = w_packed.shape[2]
        fn = lambda: nsf_hifigan._launch_conv(*args)  # noqa: E731
        if transposed:
            weight = w_packed.permute(1, 2, 0)  # [C_in, C_out, K]
            natural = (T_in - 1) * s - 2 * p + K
            pad_out = max(0, min(s - 1, T_out - natural))

            def ref_fn():
                y = nsf_hifigan.conv_transpose1d_reference(x, weight, bias, s, p, slope,
                                                           pad_out)[:, :T_out]
                return F.pad(y, (0, 0, 0, T_out - y.shape[1]))

            xt = x.transpose(1, 2).contiguous()
            lib_fn = lambda: F.conv_transpose1d(xt, weight, bias, s, p, pad_out)  # noqa: E731
            flops = 2 * B * T_out * C_out * C_in * (K // s)
        else:
            weight = w_packed.permute(2, 1, 0)  # [C_out, C_in, K]
            ref_fn = lambda: nsf_hifigan.conv1d_reference(x, weight, bias, s, d, p, slope,  # noqa: E731
                                                          res, tanh)
            xt = x.transpose(1, 2).contiguous()
            lib_fn = lambda: F.conv1d(xt, weight, bias, s, p, d)  # noqa: E731
            flops = 2 * B * T_out * C_out * C_in * K
        with torch.no_grad():
            got, ref = fn(), ref_fn()
            label = (f"{name} ({tag}) x{list(x.shape)} -> [{T_out}, {C_out}] k{K} s{s} d{d}"
                     + (f" slope {slope}" if slope is not None else "")
                     + (" +res" if res is not None else "") + (" tanh" if tanh else ""))
            err = report.compare(label, got, ref, 1e-4 * max_abs(ref))
            check_rerun(report, label, got, fn())
            ms, plain, lib = timed_triple(fn, ref_fn, lib_fn)
        t_bound = bound(nbytes(x, w_packed, bias, got) + (nbytes(res) if res is not None else 0),
                        flops)[0]
        print(f"    x{count}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{t_bound / ms:.0%} of its bound {t_bound:.4f}), plain {plain:.4f} ms, "
              f"cuDNN alone {lib:.4f} ms")
        rows.append(dict(shape=label, count=count, max_abs_err=err, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=t_bound, tflops=flops / ms / 1e9))
        for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                     ("bound_ms", t_bound), ("gflop", flops / 1e9)):
            total[k] += count * v
    n = sum(c for _, _, c in calls.values())
    print(f"  K4 over the {n} launches of one {tag} step ({len(calls)} shapes): kernel "
          f"{total['ms']:.4f} ms ({total['gflop'] / total['ms']:.1f} TFLOP/s, "
          f"{total['bound_ms'] / total['ms']:.0%} of its bound {total['bound_ms']:.4f}), cuDNN "
          f"alone {total['library_ms']:.4f} ms, plain {total['plain_ms']:.4f} ms")
    return dict(calls=n, shapes=rows, **total)


def measure_stft_configs(report: Report, calls) -> dict:
    """K5's forward at each distinct configuration among a training step's
    recorded ``stft_magnitude`` calls (all exact, float64), held against its
    plain version and timed beside ``torch.stft().abs()`` and its bound;
    with the count of the step's calls of each and their sum weighted by
    it."""
    seen = {}
    for (yp, n_fft, hop, win), kw in calls:
        key = (tuple(yp.shape), n_fft, hop, win, kw.get("exact", False))
        seen[key] = seen.get(key, 0) + 1
    out, total = {}, defaultdict(float)
    for (shape, n_fft, hop, win, exact), count in seen.items():
        yp = next(c[0][0] for c in calls if (tuple(c[0][0].shape), *c[0][1:]) ==
                  (shape, n_fft, hop, win)).detach()
        r = measure_stft(report, yp, n_fft, hop, win,
                         f"B={shape[0]} n_fft={n_fft} hop={hop} win={win}", exact=exact)
        out[f"B={shape[0]} x {shape[1]} n_fft {n_fft} hop {hop} win {win}"
            + (" exact" if exact else "")] = dict(
            calls_per_step=count, max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain"],
            library_ms=r["lib"], bound_ms=r["bound"])
        for k in ("ms", "plain", "lib", "bound"):
            total[k] += count * r[k]
    print(f"    the step's {sum(seen.values())} calls: kernel {total['ms']:.4f} ms, plain "
          f"{total['plain']:.4f} ms, torch.stft {total['lib']:.4f} ms, bound "
          f"{total['bound']:.4f} ms")
    out["step_sum"] = dict(calls=sum(seen.values()), ms=total["ms"], plain_ms=total["plain"],
                           library_ms=total["lib"], bound_ms=total["bound"])
    return out


def plain_stft_magnitude(y, n_fft: int, hop: int, win_length=None, exact=False):
    """The plain version of K5 as a training step runs it: the magnitude
    by ``stft_magnitude_reference`` (in float64 when ``exact``, as the
    training losses ask) and its gradient by ``stft_backward_reference`` in
    float64, the functions K5's kernels compute. In float32 the basis
    product is off the exact function by a few percent at bins 1e-6 of a
    frame's peak, and its gradient by ~1e-4 of its scale, where a log-mel
    loss reads them: at some states that alone moves a generator gradient
    by several times the step's float32 floor, the same in every repeat
    (``chip_step_noise.py``)."""
    import torch

    from fish_diffusion_tpu_torch.ops import mel

    win_length = win_length or n_fft

    def forward(y):
        if exact:
            return mel.stft_magnitude_reference(y.double(), n_fft, hop, win_length).float()
        return mel.stft_magnitude_reference(y, n_fft, hop, win_length)

    class Plain(torch.autograd.Function):
        @staticmethod
        def forward(ctx, y):
            ctx.save_for_backward(y)
            return forward(y)

        @staticmethod
        def backward(ctx, g):
            (y,) = ctx.saved_tensors
            return mel.stft_backward_reference(g.double(), y.double(), n_fft, hop,
                                               win_length).float()

    if torch.is_grad_enabled() and y.requires_grad:
        return Plain.apply(y)
    return forward(y)


def measure_stft_backward(report: Report, g, y, n_fft: int, hop: int, win: int, gen):
    """K5's backward on one recorded call against its plain version in
    float64, the exact function (1e-4 of the gradient's scale; the float32
    plain version's own distance from it printed beside: on a training
    step's spectra, which span 1e-6 of a frame's peak where g is large, it
    reaches 1.6e-4), timed beside the float32 plain version and the
    autograd of ``torch.stft().abs()`` on a signal of the same shape; the
    work counts what the function needs from g and y: the spectrum and the
    inverse transform (two FFTs a frame), g, y and the gradient once."""
    import torch

    from fish_diffusion_tpu_torch.ops import mel

    y = y.detach()
    got = mel.stft_backward(g, y, n_fft, hop, win)
    exact = mel.stft_backward_reference(g.double(), y.double(), n_fft, hop, win)
    plain_err = max_err(mel.stft_backward_reference(g, y, n_fft, hop, win), exact)
    err = report.compare(f"stft_backward n_fft={n_fft} hop={hop} F={g.shape[2]} vs plain "
                         f"in float64 (float32 plain: {plain_err / max_abs(exact):.2e} of "
                         f"scale)", got, exact, 1e-4 * max_abs(exact))
    yl = torch.randn(y.shape, generator=gen, device=DEVICE).requires_grad_()
    mag = torch.stft(yl, n_fft, hop, n_fft, stft_window(n_fft, win), center=False,
                     return_complex=True).abs()
    ms, plain, lib = timed_triple(
        lambda: mel.stft_backward(g, y, n_fft, hop, win),
        lambda: mel.stft_backward_reference(g, y, n_fft, hop, win),
        lambda: torch.autograd.grad(mag, yl, g, retain_graph=True))
    frames, bins = g.shape[0] * g.shape[2], g.shape[1]
    flops = frames * (5 * n_fft * np.log2(n_fft) + 2 * n_fft + 10 * bins)
    work = (nbytes(g, y, got) + 4 * n_fft, flops)
    print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms, torch.stft backward {lib:.4f} ms, "
          f"bound {bound(*work)[0]:.4f} ms")
    return dict(err=err, ms=ms, plain=plain, lib=lib, work=work)


def measure_train_kernels(report: Report, seed: int, stft_fwd_calls, stft_calls, k6_calls,
                          conv_calls):
    """Each kernel of this slice against its plain version on inputs of the
    step's own shapes (the calls the step made), with kernel, plain and
    library times and the bound."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch.models.discriminators import DiscriminatorS
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import blocked_conv

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 31)
    shape_note = f"the step's own inputs, B={TRAIN_B} x {TRAIN_SEG} samples"

    print("[train] K5 forward (stft_magnitude) at the step's STFT configurations")
    report.extra.setdefault("stft_magnitude", {})["train"] = measure_stft_configs(
        report, stft_fwd_calls)

    print("[train] K5 backward (stft_backward) at the step's 6 STFT configurations")
    for g, y, n_fft, hop, win in stft_calls:
        r = measure_stft_backward(report, g, y, n_fft, hop, win, gen)
        report.kernel("stft_backward", r["err"], r["ms"], r["plain"],
                      f"sum of the step's 6 calls, {shape_note}", *r["work"], r["lib"])

    print("[train] K6 (grouped_conv1d) at every launch of a step: MSD layers 1, 2, 5 at the "
          "three scales, forward (4 passes) and input gradient (3 passes); its weight gradient "
          "(conv1d_wgrad) at scale 0")
    wgrad_parts = defaultdict(float)
    k6_rows, k6_step, scale0 = [], defaultdict(float), defaultdict(float)
    passes = {"fwd": 4, "dgrad": 3}  # D real, D fake, G real, G fake; the three with a graph
    n_k6 = 3 * len(DiscriminatorS.K6_LAYERS)
    for i, ((x, w, b, stride, groups), _) in enumerate(k6_calls[:n_k6]):  # one pass
        scale, layer = divmod(i, len(DiscriminatorS.K6_LAYERS))
        layer = DiscriminatorS.K6_LAYERS[layer]
        x, w, b = x.detach(), w.detach(), b.detach()
        K, T_in, C_out = w.shape[2], x.shape[1], w.shape[0]
        fwd = lambda: blocked_conv.grouped_conv1d(x, w, b, stride, groups)  # noqa: E731
        with torch.no_grad():
            out = fwd()
            ref = blocked_conv.grouped_conv1d_reference(x, w, b, stride, groups)
            label = f"scale {scale} layer {layer} x{list(x.shape)} -> {C_out}, s{stride} g{groups}"
            err_f = report.compare(f"grouped_conv1d fwd {label}", out, ref, 1e-4 * max_abs(ref))
            check_rerun(report, f"grouped_conv1d fwd {label}", out, fwd())
        xt = x.transpose(1, 2).contiguous()
        ms_f = timed_triple(fwd,
                            lambda: blocked_conv.grouped_conv1d_reference(x, w, b, stride, groups),
                            lambda: F.conv1d(xt, w, b, stride, K // 2, 1, groups))
        gy = torch.randn(out.shape, generator=gen, device=DEVICE)
        gyt = gy.transpose(1, 2).contiguous()
        xr = x.clone().requires_grad_()
        yr = blocked_conv.grouped_conv1d_reference(xr, w, b, stride, groups)
        (ref_dx,) = torch.autograd.grad(yr, xr, gy, retain_graph=True)
        dgrad = lambda: blocked_conv._grouped_input_grad(gy, w, T_in, stride, groups)  # noqa: E731
        dx = dgrad()
        err_d = report.compare(f"grouped_conv1d dgrad {label}", dx, ref_dx,
                               1e-4 * max_abs(ref_dx))
        check_rerun(report, f"grouped_conv1d dgrad {label}", dx, dgrad())
        ms_d = timed_triple(
            dgrad, lambda: torch.autograd.grad(yr, xr, gy, retain_graph=True),
            lambda: torch.nn.grad.conv1d_input(xt.shape, w, gyt, stride, K // 2, 1, groups))
        flops = 2 * out.numel() * w.shape[1] * K
        io = {"fwd": nbytes(x, w, b, out), "dgrad": nbytes(gy, w, dx)}
        for mode, (ms, plain, lib), err in (("fwd", ms_f, err_f), ("dgrad", ms_d, err_d)):
            t_b = bound(io[mode], flops)[0]
            print(f"    {mode} {label} x{passes[mode]} a step: kernel {ms:.4f} ms "
                  f"({flops / ms / 1e9:.1f} TFLOP/s, {t_b / ms:.0%} of its bound {t_b:.4f}), "
                  f"plain {plain:.4f} ms, cuDNN {lib:.4f} ms")
            k6_rows.append(dict(scale=scale, layer=layer, mode=mode, shape=label,
                                launches_per_step=passes[mode], max_abs_err=err, ms=ms,
                                tflops=flops / ms / 1e9, bound_ms=t_b, share_of_bound=t_b / ms,
                                plain_ms=plain, library_ms=lib))
            for k, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                         ("bound_ms", t_b), ("gflop", flops / 1e9)):
                k6_step[k] += passes[mode] * v
                if scale == 0:
                    scale0[k] += v
        report.kernel("grouped_conv1d", max(err_f, err_d),
                      passes["fwd"] * ms_f[0] + passes["dgrad"] * ms_d[0],
                      passes["fwd"] * ms_f[1] + passes["dgrad"] * ms_d[1],
                      f"every launch of a train step ({n_k6 * sum(passes.values())}): MSD layers "
                      f"1, 2, 5 at its 3 scales, 4 forward + 3 input-gradient passes, {shape_note}",
                      passes["fwd"] * io["fwd"] + passes["dgrad"] * io["dgrad"],
                      sum(passes.values()) * flops,
                      passes["fwd"] * ms_f[2] + passes["dgrad"] * ms_d[2])
        if scale:
            continue
        dw = blocked_conv.conv1d_wgrad(x, gy, K, stride, 1, K // 2, groups)
        ref_dw = blocked_conv.conv1d_wgrad_reference(x, gy, K, stride, 1, K // 2, groups)
        err_w = report.compare(f"conv1d_wgrad (K6) {label}", dw, ref_dw, 1e-4 * max_abs(ref_dw))
        check_rerun(report, f"conv1d_wgrad (K6) {label}", dw,
                    blocked_conv.conv1d_wgrad(x, gy, K, stride, 1, K // 2, groups))
        ms_w = timed_triple(
            lambda: blocked_conv.conv1d_wgrad(x, gy, K, stride, 1, K // 2, groups),
            lambda: blocked_conv.conv1d_wgrad_reference(x, gy, K, stride, 1, K // 2, groups),
            lambda: torch.nn.grad.conv1d_weight(xt, w.shape, gyt, stride, K // 2, 1, groups))
        print(f"    wgrad {label}: kernel {ms_w[0]:.4f} ms ({flops / ms_w[0] / 1e9:.1f} TFLOP/s), "
              f"plain {ms_w[1]:.4f} ms, cuDNN {ms_w[2]:.4f} ms")
        wgrad_parts["K6 layers 1, 2, 5"] += ms_w[0]
        wgrad_parts["K6 layers 1, 2, 5 cuDNN"] += ms_w[2]
        report.kernel("conv1d_wgrad", err_w, ms_w[0], ms_w[1],
                      "", nbytes(x, gy, dw), flops, ms_w[2])
    n = sum(r["launches_per_step"] for r in k6_rows)
    print(f"  K6 over the {n} launches of one train step: kernel {k6_step['ms']:.4f} ms "
          f"({k6_step['gflop'] / k6_step['ms']:.1f} TFLOP/s, "
          f"{k6_step['bound_ms'] / k6_step['ms']:.0%} of its bound {k6_step['bound_ms']:.4f}), "
          f"cuDNN {k6_step['library_ms']:.4f} ms, plain {k6_step['plain_ms']:.4f} ms; scale 0's "
          f"forward + input gradient of layers 1, 2, 5 (one of each) {scale0['ms']:.4f} ms "
          f"(bound {scale0['bound_ms']:.4f}, cuDNN {scale0['library_ms']:.4f})")
    report.extra["grouped_conv1d"] = dict(by_layer=k6_rows, step=dict(launches=n, **k6_step),
                                          scale0_fwd_dgrad=dict(scale0))

    print("[train] conv1d_wgrad and K4's input gradient at the k=11, d=5 resblock "
          "conv of each generator level")
    dgrad = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_rel_err=0.0)
    for (x, w, b), kw in conv_calls:
        x, w = x.detach(), w.detach()
        C_out, C_in, K = w.shape
        d, p, slope = kw["dilation"], kw["padding"], kw["in_slope"]
        gy = torch.randn((x.shape[0], x.shape[1], C_out), generator=gen, device=DEVICE)
        xa, gyt = F.leaky_relu(x, slope).transpose(1, 2).contiguous(), gy.transpose(1, 2).contiguous()
        dw = blocked_conv.conv1d_wgrad(x, gy, K, 1, d, p, slope_a=slope)
        ref = blocked_conv.conv1d_wgrad_reference(x, gy, K, 1, d, p, slope_a=slope)
        label = f"x{list(x.shape)} k{K} d{d}"
        err = report.compare(f"conv1d_wgrad (K4) {label}", dw, ref, 1e-4 * max_abs(ref))
        check_rerun(report, f"conv1d_wgrad (K4) {label}", dw,
                    blocked_conv.conv1d_wgrad(x, gy, K, 1, d, p, slope_a=slope))
        ms = timed_triple(lambda: blocked_conv.conv1d_wgrad(x, gy, K, 1, d, p, slope_a=slope),
                          lambda: blocked_conv.conv1d_wgrad_reference(x, gy, K, 1, d, p,
                                                                      slope_a=slope),
                          lambda: torch.nn.grad.conv1d_weight(xa, w.shape, gyt, 1, p, d))
        flops = 2 * x.shape[0] * x.shape[1] * C_in * C_out * K
        print(f"    wgrad {label}: kernel {ms[0]:.4f} ms ({flops / ms[0] / 1e9:.1f} TFLOP/s), "
              f"plain {ms[1]:.4f} ms, cuDNN {ms[2]:.4f} ms")
        wgrad_parts[f"generator C={C_in}"] += ms[0]
        wgrad_parts[f"generator C={C_in} cuDNN"] += ms[2]
        report.kernel("conv1d_wgrad", err, ms[0], ms[1],
                      "K6 layers 1, 2, 5 of MSD scale 0 and the k=11, d=5 resblock conv "
                      f"of each generator level, {shape_note}", nbytes(x, gy, dw), flops, ms[2])
        # K4's input gradient of the same conv: flipped taps, swapped channels
        w_flip = w.flip(2).transpose(0, 1).contiguous()
        zero = torch.zeros(C_in, device=DEVICE)
        pad_t = (K - 1) * d - p
        dxa = nsf_hifigan._conv1d_forward(gy, w_flip, zero, 1, d, pad_t)
        xr = F.leaky_relu(x, slope).requires_grad_()
        yr = F.conv1d(xr.transpose(1, 2), w, None, 1, p, d).transpose(1, 2)
        (ref_dx,) = torch.autograd.grad(yr, xr, gy, retain_graph=True)
        err = report.compare(f"conv1d dgrad (K4) {label}", dxa, ref_dx, 1e-4 * max_abs(ref_dx))
        ms = timed_triple(lambda: nsf_hifigan._conv1d_forward(gy, w_flip, zero, 1, d, pad_t),
                          lambda: torch.autograd.grad(yr, xr, gy, retain_graph=True),
                          lambda: torch.nn.grad.conv1d_input(xa.shape, w, gyt, 1, p, d))
        print(f"    dgrad {label}: kernel {ms[0]:.4f} ms, plain {ms[1]:.4f} ms, "
              f"cuDNN {ms[2]:.4f} ms")
        dgrad["bound_ms"] += bound(nbytes(gy, w, dxa), flops)[0]
        dgrad["ms"] += ms[0]
        dgrad["plain_ms"] += ms[1]
        dgrad["library_ms"] += ms[2]
        dgrad["max_rel_err"] = max(dgrad["max_rel_err"], err / max_abs(ref_dx))
    report.extra.setdefault("conv1d_wgrad", {})["ms_by_part"] = dict(wgrad_parts)
    report.extra.setdefault("conv1d", {})["train_dgrad"] = dict(
        shape="the k=11, d=5 resblock conv of each generator level, "
              f"B={TRAIN_B} x {TRAIN_SEG} samples", **dgrad)

    print(f"[train] K3 backward (nsf_merge_backward) at B={TRAIN_B} T={TRAIN_SEG // HOP} "
          f"hop={HOP}")
    T_f = TRAIN_SEG // HOP
    f0 = torch.rand((TRAIN_B, T_f), generator=gen, device=DEVICE) * 400 + 100
    f0 = f0 * (torch.rand((TRAIN_B, T_f), generator=gen, device=DEVICE) > 0.2)
    rand_ini = torch.rand((TRAIN_B, 9), generator=gen, device=DEVICE)
    rand_ini[:, 0] = 0
    noise = torch.randn((TRAIN_B, TRAIN_SEG, 9), generator=gen, device=DEVICE)
    weight = torch.randn(9, generator=gen, device=DEVICE) / 3
    bias = torch.randn(1, generator=gen, device=DEVICE) * 0.1
    base = source.nsf_phase_base_reference(f0, SR, HOP)
    out = source.nsf_merge_reference(f0, base, rand_ini, noise, weight, bias, SR, HOP)
    g = torch.randn(out.shape, generator=gen, device=DEVICE)
    args = (g, out, f0, base, rand_ini, noise, SR, HOP)
    got, ref = source.nsf_merge_backward(*args), source.nsf_merge_backward_reference(*args)
    err = report.compare("nsf_merge_backward (dW, db)", got, ref, 1e-4 * max_abs(ref))
    ms, plain, _ = timed_triple(lambda: source.nsf_merge_backward(*args),
                                lambda: source.nsf_merge_backward_reference(*args))
    print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms (no single PyTorch call)")
    report.kernel("nsf_merge_backward", err, ms, plain,
                  f"B={TRAIN_B} T={T_f} hop={HOP}, 9 harmonics",
                  nbytes(g, out, f0, base, rand_ini, noise) + 40,
                  12 * noise.numel() + 3 * g.numel())


def drive_training(report: Report, seed: int, tag: str, config_file: str, describe,
                   warm: int, timed: int, expected_fn, plain_fns: dict, record,
                   override=None, state_twice: bool = False):
    """One training path at full width (float32) on a synthetic dataset:
    ``configs/<config_file>`` (changed in place by ``override(cfg)`` when
    given), ``VocoderTrainer.fit`` for ``warm`` + ``timed`` steps with
    validation and a checkpoint, every step's launches held to
    ``expected_fn(trainer)`` exactly; a resume from the checkpoint; then
    the same number of steps again from the seed with cuDNN's deterministic
    algorithms, and from their state one step through the kernels, during
    which the calls of the wrappers in ``record`` ((module, name) pairs, or
    (module, name, key) to keep the first call of each key: ``recording``)
    are kept, against one through every plain version in ``plain_fns`` on
    the kernel step's side of every kink (``vocoder_kinks``). With
    ``state_twice`` the gate's state is built twice from the seed in this
    process and its two digests must agree. Returns (launches over the fit,
    the path's numbers under ``tag``, the recorded calls by name)."""
    import copy

    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.config import Config
    from fish_diffusion_tpu_torch.training import vocoder_cli
    from fish_diffusion_tpu_torch.training.vocoder_trainer import VocoderTrainer

    say = f"[{tag}]"
    rng = np.random.default_rng(seed + 40)
    np.random.seed(seed + 41)  # the dataset's pitch and loudness shifts, crops
    tmp = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_"))
    make_vocoder_dataset(rng, tmp / "data")
    cfg = Config.fromfile(ROOT / "configs" / config_file)
    if override is not None:
        override(cfg)
    cfg.trainer["precision"] = "32-true"
    cfg.trainer["discriminator_dtype"] = "float32"
    cfg.dataset.train["path"] = str(tmp / "data" / "train")
    cfg.dataset.valid["path"] = str(tmp / "data" / "valid")
    # the loaders read in this process (no worker processes to stop); the
    # training order from the seed
    loader = vocoder_cli.build_loader(cfg.dataset.train, {**cfg.dataloader.train,
                                                          "num_workers": 0, "seed": seed + 42})
    valid = vocoder_cli.build_loader(cfg.dataset.valid, {**cfg.dataloader.valid,
                                                         "num_workers": 0})
    t0 = time.perf_counter()
    trainer = VocoderTrainer(cfg, log_dir=str(tmp / "logs"), steps_per_epoch=len(loader),
                             device=DEVICE)
    expected = {name: 0 for name in kernels.LAUNCHES}
    expected.update(expected_fn(trainer))
    print(f"{say} trainer built in {time.perf_counter() - t0:.1f} s: {describe(cfg)}, "
          f"batch {cfg.dataloader.train.batch_size} x {cfg.dataset.train.segment_size}, "
          f"float32, {len(loader)} steps per epoch")

    step_fn = trainer._train_step
    clock = StageClock()
    for attr, label in (("generate", "generator"), ("d_phase", "D phase"),
                        ("g_phase", "G phase"), ("apply_updates", "optimizer")):
        clock.wrap(step_fn, attr, label)
    steps, stages_after_warmup, peak = [], {}, {}

    def timed_step(state, batch, draws):
        if len(steps) == warm:
            stages_after_warmup.update(clock.seconds)
            torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch, draws)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_step
        steps.append((seconds, {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES},
                      {k: float(v) for k, v in metrics.items()}))
        if len(steps) == warm + timed:
            peak["bytes"] = torch.cuda.max_memory_allocated()
        return state, metrics

    trainer._train_step = timed_step
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(loader, max_steps=warm + timed, valid_loader=valid,
                        valid_every=10 ** 9, log_every=1, save_every=10 ** 9, seed=seed)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    clock.restore()
    trainer._train_step = step_fn

    secs = [s for s, _, _ in steps[warm:]]
    median = statistics.median(secs)
    audio_s = TRAIN_B * TRAIN_SEG / SR
    stages = {k: (v - stages_after_warmup.get(k, 0.0)) / timed for k, v in clock.seconds.items()}
    print(f"{say} fit: {len(steps)} steps + validation + checkpoint in {fit_seconds:.1f} s; "
          f"steps {warm + 1}-{warm + timed}: median {median:.4f} s per step "
          f"(min {min(secs):.4f}, max {max(secs):.4f}), {audio_s / median:.2f} audio s "
          f"trained per s, {1 / median:.3f} steps/s")
    print(f"{say} per step (synchronised stage clocks, mean over the timed steps): "
          + ", ".join(f"{k} {v:.4f} s" for k, v in stages.items()))
    print(f"{say} peak device memory over the timed steps {peak['bytes'] / 2**30:.2f} GiB")
    for i, (s, grew, metrics) in enumerate(steps):
        ok = grew == expected and all(np.isfinite(v) for v in metrics.values())
        print(f"  step {i + 1}: {s:.4f} s, " + ", ".join(
            f"{k} {v:.4f}" for k, v in metrics.items()) + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            print(f"    launches {({k: v for k, v in grew.items() if v})}, "
                  f"expected {({k: v for k, v in expected.items() if v})}")
            report.failures.append(f"{tag} step {i + 1}")
    print(f"{say} launches per step: {({k: v for k, v in expected.items() if v})} "
          "(every step exactly)")
    rows = [json.loads(line) for line in open(tmp / "logs" / "metrics.jsonl")]
    val = [r["valid_mel_l1"] for r in rows if "valid_mel_l1" in r]
    print(f"{say} validation mel L1 at step {state.step}: {val}")
    if state.step != warm + timed or len(val) != 1 or not np.isfinite(val[0]):
        report.failures.append(f"{tag} fit / validation")
    for name, n in expected.items():
        if n and launches[name] <= 0:
            report.failures.append(f"{name} never launched on the {tag} path")

    # resume from the checkpoint fit wrote at its last step
    saved = {k: v.detach().cpu().clone() for k, v in
             {**state.params_g.state_dict(), **state.params_d.state_dict()}.items()}
    resumed = VocoderTrainer(cfg, log_dir=str(tmp / "logs"), steps_per_epoch=len(loader),
                             device=DEVICE)
    restored = resumed.ckpt.restore(resumed.init_state(seed + 1))
    same = all(torch.equal(v.cpu(), saved[k]) for k, v in
               {**restored.params_g.state_dict(), **restored.params_d.state_dict()}.items())
    after = resumed.fit(loader, max_steps=warm + timed + 1, resume=True,
                        save_every=10 ** 9, seed=seed)
    ok = same and restored.opt_state_g.count == warm + timed and after.step == warm + timed + 1
    print(f"{say} resume: checkpoint of step {warm + timed} restored (parameters "
          f"{'identical' if same else 'DIFFER'}), one more step -> step {after.step} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        report.failures.append(f"{tag} resume")
    del resumed, restored, after
    torch.cuda.empty_cache()

    # The gate's state. cuDNN's default algorithms for the discriminators'
    # convolutions sum in an order that varies from run to run (two fits
    # from one seed part at their first step, by ~1e-6 of each gradient),
    # and its deterministic ones cost the step 12-29% on an H100: so the fit
    # above is timed as users run it, and the gate starts from the same
    # number of steps taken again from the seed with the deterministic
    # algorithms, which stay on until the gate ends.
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.cuda.reset_peak_memory_stats()

    def gate_state():
        np.random.seed(seed + 43)
        again = vocoder_cli.build_loader(cfg.dataset.train, {**cfg.dataloader.train,
                                                             "num_workers": 0,
                                                             "seed": seed + 44})
        state = trainer.init_state(seed)
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        for batch in itertools.islice(itertools.chain.from_iterable(itertools.repeat(again)),
                                      warm + timed):
            batch = trainer._to_device(batch)
            state, _ = step_fn(state, batch, trainer.draw(batch, gen))
        return state

    def state_digest(state):
        return digest([*state.params_g.state_dict().values(),
                       *state.params_d.state_dict().values(), *state.spectral_d.values()])

    state = gate_state()
    if state_twice:
        first = state_digest(state)
        del state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = gate_state()
        torch.cuda.synchronize()
        extra_s = time.perf_counter() - t0
        second = state_digest(state)
        same = first == second
        print(f"{say} the gate's state built twice from the seed in this process: parameters "
              f"{first} / {second} {'ok' if same else 'DIFFER'} (the second build "
              f"{extra_s:.1f} s)")
        if not same:
            report.failures.append(f"{tag} gate state not a function of the seed")

    # one step through the kernels and one through every plain version,
    # from the same state, batch and draws (TF32 is off)
    batch = trainer._to_device(next(iter(loader)))
    draws = trainer.draw(batch, torch.Generator(device=DEVICE).manual_seed(seed + 99))
    snap = copy.deepcopy({"g": state.params_g.state_dict(), "d": state.params_d.state_dict(),
                          "s": state.spectral_d, "og": state.opt_state_g.state_dict(),
                          "od": state.opt_state_d.state_dict(), "step": state.step})
    print(f"{say} the gate's state: parameters {digest([*snap['g'].values(), *snap['d'].values(), *snap['s'].values()])}, "
          f"batch {digest(batch[k] for k in sorted(batch))}, draws {digest(draws)} (the first "
          f"16 hex digits of the SHA-256 of their bytes: two runs from one seed that agree "
          f"here start the gate from the same state)")

    def restore():
        state.params_g.load_state_dict(snap["g"])
        state.params_d.load_state_dict(snap["d"])
        state.spectral_d = {k: v.clone() for k, v in snap["s"].items()}
        state.opt_state_g.load_state_dict(copy.deepcopy(snap["og"]))
        state.opt_state_d.load_state_dict(copy.deepcopy(snap["od"]))
        state.step = snap["step"]

    def grads():
        return {f"{t}.{k}": p.grad.detach().clone() for t, m in
                (("g", state.params_g), ("d", state.params_d)) for k, p in m.named_parameters()}

    def one_step(swaps, audio_scale=1.0, kinks=None):
        """One step from the snapshot -> (grads, metrics, launches);
        ``kinks``, a ``pinned_kinks``, is entered around it."""
        restore()
        kernels.reset_launches()
        scaled = {**batch, "audio": batch["audio"] * audio_scale}
        with plain_path(swaps), kinks or contextlib.nullcontext():
            _, metrics = step_fn(state, scaled, draws)
        return grads(), metrics, dict(kernels.LAUNCHES)

    def pinned_pair(audio_scale=1.0, recorders=()):
        """The kernel step at audio x ``audio_scale``, its kinks recorded, and
        the plain step on the kernel step's side of every kink -> (the
        kernel step's grads and metrics, the plain step's grads, the
        forwards' largest difference at the kinks' inputs over their scale,
        the elements the two forwards decided differently, by kind)."""
        record = pinned_kinks(**vocoder_kinks())
        for r in recorders:
            r.start()
        try:
            g_k, m_k, _ = one_step({}, audio_scale, record)
        finally:
            for r in recorders:
                r.stop()
        pinned = pinned_kinks(**vocoder_kinks(), other=record)
        g_pp, _, _ = one_step(plain_fns, audio_scale, pinned)
        pinned.check()
        pinned.other = None  # the record's decisions: several GB at this step
        print(f"{say}   audio x (1 {audio_scale - 1:+.0e}): {len(record.record)} kinks; the "
              f"elements the two forwards decide differently, by kind: "
              + ", ".join(f"{k} {v}" for k, v in sorted(pinned.flips.items()))
              + "; their largest distance from the kink / scale "
              + (", ".join(f"{k} {v:.1e}" for k, v in sorted(pinned.near.items())) or "none"))
        return g_k, m_k, g_pp, pinned

    def worst_error(got, ref, prefix):
        rel = {k: float((got[k] - ref[k]).abs().max())
               / max(float(ref[k].abs().max()), 1e-30) for k in ref if k.startswith(prefix)}
        k = max(rel, key=rel.get)
        return k, rel[k]

    def rel_l2(got, ref, prefix):
        """||got - ref|| / ||ref|| over all of one network's gradients."""
        keys = [k for k in ref if k.startswith(prefix)]
        num = sum(float(((got[k] - ref[k]).double() ** 2).sum()) for k in keys)
        den = sum(float((ref[k].double() ** 2).sum()) for k in keys)
        return (num / max(den, 1e-300)) ** 0.5

    recorders = [recording(*entry) for entry in record]
    g_k, m_k, g_kp, pinned = pinned_pair(1.0, recorders)
    g_p, m_p, launched = one_step(plain_fns)
    if any(launched.values()):
        report.failures.append(f"{tag}: plain step launched kernels: {launched}")
    # The step's float32 noise floor: the plain step again with the audio
    # scaled by 1 + d, a change of the size of the kernels' own differences
    # from plain. The losses and the networks have kinks (the L1 losses'
    # signs, the envelope's max-pool, the log-mel's clamp, every leaky
    # ReLU, K4's fused input activation among them); such a change flips a
    # few of them, and the gradients move by 1e-4-1e-2 of their max
    # whatever its size (1e-7 to 1e-5). Which kinks flip is chance: at one
    # state the largest move ranges over 3.4x from one d to the next. The
    # kernels' own difference from plain flips kinks the same way, a
    # comparison across a discontinuity, not of the kernels: so the plain
    # step of each pair takes the kernel step's side of every kink
    # (``pinned_kinks``, which keeps the kernel step's decisions, not its
    # inputs: a step's kink inputs would not fit beside the plain step),
    # and each element decided differently must lie within rounding of its
    # kink (below). The floor is the largest move over several d, for the generator and the
    # discriminators alike; the gate reads the median of the kernels'
    # errors against the pinned plain step at each scaled audio (six
    # pairs); a kernel that is wrong is wrong at every one of them.
    moves = {"g.": [], "d.": []}
    moves_l2 = {"g.": [], "d.": []}
    paired = {p: [worst_error(g_k, g_kp, p)] for p in moves}
    pins = [pinned]
    for d in FLOOR_SCALES:
        g_q, _, _ = one_step(plain_fns, 1.0 + d)
        for prefix, found in moves.items():
            found.append(worst_error(g_q, g_p, prefix))
            moves_l2[prefix].append(rel_l2(g_q, g_p, prefix))
        del g_q
        g_kq, _, g_qq, pinned = pinned_pair(1.0 + d)
        for prefix in moves:
            paired[prefix].append(worst_error(g_kq, g_qq, prefix))
        pins.append(pinned)
        del g_kq, g_qq
    # the pinning's premise, held over the six pairs: every element the two
    # forwards decide differently lies within rounding of its kink (within
    # 1e-4 of its input's scale), so that pinning moves only what float32
    # rounding decides; a forward that is wrong flips elements far from
    # their kinks
    near = max((v for p in pins for v in p.near.values()), default=0.0)
    ok = near <= 1e-4
    print(f"{say} the kinks, kernel forward vs plain forward over the six pairs: the elements "
          f"on opposite sides, each pinned to the kernel step's side, lie at most {near:.2e} "
          f"of their input's scale from their kink (tol 1e-4) {'ok' if ok else 'FAIL'}")
    if not ok:
        report.failures.append(f"{tag}: an element the forwards decide differently lies "
                               f"{near:.2e} of its scale from its kink")
    print(f"{say} peak device memory over the gate {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB")
    for k, want in m_p.items():
        if k.startswith("loss"):
            report.compare(f"{tag} step {k} vs plain", m_k[k].reshape(1), want.reshape(1),
                           1e-4 * abs(float(want)))
    for prefix in ("g.", "d."):  # a comparison of gradients that are all 0 says nothing
        if max(float(v.abs().max()) for k, v in g_p.items() if k.startswith(prefix)) == 0:
            report.failures.append(f"{tag}: every {prefix[0]} gradient of the plain step is 0")
    held = {}
    for prefix, whose in (("d.", "discriminators'"), ("g.", "generator's")):
        err = statistics.median(m for _, m in paired[prefix])
        floor_name, floor = max(moves[prefix], key=lambda m: m[1])
        tol = max(1e-3, 3 * floor)
        held[prefix[0]] = (err, floor, tol)
        listed = ", ".join(f"{m:.3e} at {d:+.0e}" for d, (_, m) in zip(FLOOR_SCALES,
                                                                         moves[prefix]))
        each = ", ".join(f"{m:.3e} at {d:+.0e} ({k})" for d, (k, m) in
                         zip((0.0,) + FLOOR_SCALES, paired[prefix]))
        print(f"{say} whole step, kernels vs plain (pinned) on the same audio x (1 + d): the "
              f"{whose} largest gradient error of its max |grad|: {each}; median {err:.3e}, "
              f"tol {tol:.3e} = max(1e-3, 3 x the largest {floor:.3e} of the plain step's own "
              f"moves under audio x (1 + d): {listed}; {floor_name}) "
              f"{'ok' if err <= tol else 'FAIL'}")
        if not err <= tol:
            report.failures.append(f"{tag} step {whose} gradients vs plain: median {err:.3e} "
                                   f"> tol {tol:.3e}")
        # the second gate, beside the elementwise one: one kink flip moves
        # the relative L2 less than the largest element, so a kernel wrong
        # on many elements by a little shows here first
        l2, l2_floor = rel_l2(g_k, g_kp, prefix), max(moves_l2[prefix])
        ratio = l2 / max(l2_floor, 1e-300)
        held[prefix[0]] += (l2, l2_floor, ratio)
        ok = ratio <= L2_RATIO_LIMIT
        print(f"{say} whole step, the {whose} gradients' relative L2 difference, kernels vs "
              f"plain (pinned): {l2:.3e}; the plain step's own under audio x (1 + d): "
              + ", ".join(f"{m:.3e}" for m in moves_l2[prefix])
              + f" (largest {l2_floor:.3e}; ratio {ratio:.2f}, limit {L2_RATIO_LIMIT:.1f}) "
              + ("ok" if ok else "FAIL"))
        if not ok:
            report.failures.append(f"{tag} step {whose} gradients' relative L2 vs plain: "
                                   f"ratio {ratio:.2f} > {L2_RATIO_LIMIT:.1f}")
        sq = {k: float(((g_k[k] - g_kp[k]).double() ** 2).sum())
              for k in g_kp if k.startswith(prefix)}
        total = max(sum(sq.values()), 1e-300)
        top = sorted(sq, key=sq.get, reverse=True)[:5]
        print(f"{say}   the five {whose} tensors carrying most of that difference: "
              + "; ".join(f"{k} {sq[k] / total:.1%} (its own relative L2 "
                          f"{sq[k] ** 0.5 / max(float(g_kp[k].double().norm()), 1e-300):.2e})"
                          for k in top))
    restore()
    totals = {
        f"{tag}_step_s_median": median, f"{tag}_step_s": secs,
        f"{tag}_audio_s_per_s": audio_s / median, f"{tag}_steps_per_s": 1 / median,
        f"{tag}_stage_s": stages, f"{tag}_peak_gib": peak["bytes"] / 2**30,
        f"{tag}_losses_last": steps[-1][2],
        f"{tag}_launches_per_step": {k: v for k, v in expected.items() if v},
        f"{tag}_step_vs_plain": {f"{w}_{k}": v for w, row in held.items()
                                 for k, v in zip(("max_rel_err_median", "noise_floor", "tol",
                                                  "rel_l2", "rel_l2_floor", "rel_l2_ratio"),
                                                 row)},
        f"{tag}_kinks": {"flipped_distance_max": near,
                         "opposite": [dict(p.flips) for p in pins]},
    }
    torch.backends.cudnn.deterministic = deterministic
    return launches, totals, {r.name: r.calls for r in recorders}


def phase_train(report: Report, seed: int):
    """The third slice's path: ``VocoderTrainer.fit`` on
    ``configs/vocoder_nsf_hifigan.py`` at full width (float32), a resume,
    the whole step through the kernels against the whole step through the
    plain versions, and each new kernel at the step's shapes."""
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import blocked_conv, mel

    launches, totals, calls = drive_training(
        report, seed, "train", "vocoder_nsf_hifigan.py",
        lambda cfg: (f"NSF-HiFiGAN 512 (upsample 8.8.2.2.2, ResBlock1 3/7/11), MPD "
                     f"periods {cfg.model.mpd.periods}, 3-scale MSD"),
        2, 6,
        lambda trainer: train_launches_per_step(dict(trainer.config.model.generator),
                                                len(trainer.config.model.multi_scale_mels)),
        {
            (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
            (nsf_hifigan, "conv_transpose1d"): nsf_hifigan.conv_transpose1d_reference,
            (source, "nsf_source"): source.nsf_source_reference,
            (mel, "stft_magnitude"): plain_stft_magnitude,
            (blocked_conv, "grouped_conv1d"): blocked_conv.grouped_conv1d_reference,
        },
        [(mel, "stft_magnitude"), (mel, "stft_backward"), (blocked_conv, "grouped_conv1d"),
         (nsf_hifigan, "conv1d"), (nsf_hifigan, "conv1d_wgrad"),
         (nsf_hifigan, "_launch_conv", k4_key)])
    conv = [c for c in calls["conv1d"] if c[0][1].shape[2] == 11 and c[1].get("dilation") == 5]
    measure_train_kernels(report, seed, calls["stft_magnitude"],
                          [c[0] for c in calls["stft_backward"]], calls["grouped_conv1d"], conv)
    print("[train] conv1d_wgrad at the NSF-HiFiGAN generator's weight gradients of one step")
    report.extra.setdefault("conv1d_wgrad", {})["train"] = measure_wgrad_calls(
        report, calls["conv1d_wgrad"], "train")
    print("[train] K4 at every shape of the NSF-HiFiGAN generator's forward and input "
          "gradients of one step")
    report.extra.setdefault("conv1d", {})["train"] = measure_k4_calls(
        report, calls["_launch_conv"], "train")
    report.finish("train")
    return launches, totals


def train_v2_launches_per_step(trainer) -> dict:
    """Kernel launches one v2 GAN step (RefineGAN, MPD + MRD) implies, from
    the model's structure.

    Generator forward: template_conv, 6 convs per down level, mel_conv,
    source_conv, per up level input_conv and 3 branches x 6 convs, and
    output_conv (all K4); the template (K3's linear phase scan, K9). Its
    backward: K4 input gradients for every conv but the three whose input
    is data (template_conv, mel_conv, source_conv), a weight gradient for
    every conv. STFT: the generator's mel of the real audio; each mel scale
    on real and generated audio, with a backward on the generated; each MRD
    resolution in the D phase on real and fake, in the G phase on the fake
    (the v2 G phase has no real pass), with a backward there. K6 2-D: the
    MRD's layers in three passes (D real, D fake, G fake); input gradients
    for every layer but the first in the D phase's two passes and for every
    layer in the G phase's, the stride-2 layers' in the transposed mode;
    weight gradients in the D phase's two passes."""
    from fish_diffusion_tpu_torch.models.discriminators import DiscriminatorR

    gen = trainer.generator
    n_conv = 1 + 6 * len(gen.downsample_rates) + 2 + 19 * len(gen.upsample_rates) + 1
    n_res = len(trainer.discs.mrd.discriminators)
    n_mels = len(trainer.config.model.multi_scale_mels)
    layers = [s for _, _, s, _ in DiscriminatorR.SPECS] + [(1, 1)]
    strided = sum(s != (1, 1) for s in layers)
    direct = len(layers) - strided
    return {
        "conv1d": n_conv + (n_conv - 3), "conv1d_wgrad": n_conv,
        "nsf_phase_base": 1, "comb_merge": 1,
        "stft_magnitude": 1 + 2 * n_mels + 3 * n_res,
        "stft_backward": n_mels + n_res,
        "conv2d": n_res * (3 * len(layers) + 2 * (direct - 1) + direct),
        "conv2d_transposed": n_res * 3 * strided,
        "conv2d_wgrad": n_res * 2 * len(layers),
    }


def measure_train_v2_kernels(report: Report, seed: int, conv2d_calls, stft_calls,
                             stft_bwd_calls, comb_calls):
    """K6 2-D (forward, input gradient in the direct or transposed mode,
    weight gradient) at every layer of one MRD pass of the step, K9 at the
    step's template, and K5 at the step's MRD and mel-loss shapes: each
    against its plain version, with kernel, plain and library times and the
    bound."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch.models.discriminators import DiscriminatorR
    from fish_diffusion_tpu_torch.models.vocoders import source
    from fish_diffusion_tpu_torch.ops import blocked_conv

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 51)
    n_layers = len(DiscriminatorR.SPECS) + 1
    one_pass = conv2d_calls[: len(conv2d_calls) // 3]  # the D phase's real pass
    print(f"[train_v2] K6 2-D at the {len(one_pass)} layers of one MRD pass "
          f"(B={TRAIN_B} x {TRAIN_SEG} samples): forward, input gradient, weight gradient")
    parts, wgrad_rows, fwd_rows, tr_rows = defaultdict(float), [], [], []
    for i, ((x, w, b, stride, pad), _) in enumerate(one_pass):
        x, w, b = x.detach(), w.detach(), b.detach()
        stride, pad = tuple(stride), tuple(pad)
        KH, KW = w.shape[2:]
        with torch.no_grad():
            out = blocked_conv.conv2d_nhwc(x, w, b, stride, pad)
            ref = blocked_conv.conv2d_nhwc_reference(x, w, b, stride, pad)
        label = (f"res {i // n_layers} layer {i % n_layers} x{list(x.shape)} -> "
                 f"{w.shape[0]}, k({KH},{KW}) s{stride}")
        err_f = report.compare(f"conv2d fwd {label}", out, ref, 1e-4 * max_abs(ref))
        with torch.no_grad():
            check_rerun(report, f"conv2d fwd {label}", out,
                        blocked_conv.conv2d_nhwc(x, w, b, stride, pad))
        xc = x.permute(0, 3, 1, 2).contiguous()
        ms_f = timed_triple(lambda: blocked_conv.conv2d_nhwc(x, w, b, stride, pad),
                            lambda: blocked_conv.conv2d_nhwc_reference(x, w, b, stride, pad),
                            lambda: F.conv2d(xc, w, b, stride, pad))
        flops = 2 * out.numel() * w.shape[1] * KH * KW
        gy = torch.randn(out.shape, generator=gen, device=DEVICE)
        gyc = gy.permute(0, 3, 1, 2).contiguous()
        xr = x.clone().requires_grad_()
        yr = blocked_conv.conv2d_nhwc_reference(xr, w, b, stride, pad)
        (ref_dx,) = torch.autograd.grad(yr, xr, gy, retain_graph=True)
        in_hw = tuple(x.shape[1:3])
        dx = blocked_conv.conv2d_input_grad(gy, w, in_hw, stride, pad)
        mode = "conv2d" if stride == (1, 1) else "conv2d_transposed"
        err_d = report.compare(f"{mode} dgrad {label}", dx, ref_dx, 1e-4 * max_abs(ref_dx))
        check_rerun(report, f"{mode} dgrad {label}", dx,
                    blocked_conv.conv2d_input_grad(gy, w, in_hw, stride, pad))
        ms_d = timed_triple(
            lambda: blocked_conv.conv2d_input_grad(gy, w, in_hw, stride, pad),
            lambda: torch.autograd.grad(yr, xr, gy, retain_graph=True),
            lambda: torch.nn.grad.conv2d_input(xc.shape, w, gyc, stride, pad))
        dw = blocked_conv.conv2d_wgrad(x, gy, (KH, KW), stride, pad)
        ref_dw = blocked_conv.conv2d_wgrad_reference(x, gy, (KH, KW), stride, pad)
        err_w = report.compare(f"conv2d_wgrad {label}", dw, ref_dw, 1e-4 * max_abs(ref_dw))
        check_rerun(report, f"conv2d_wgrad {label}", dw,
                    blocked_conv.conv2d_wgrad(x, gy, (KH, KW), stride, pad))
        ms_w = timed_triple(
            lambda: blocked_conv.conv2d_wgrad(x, gy, (KH, KW), stride, pad),
            lambda: blocked_conv.conv2d_wgrad_reference(x, gy, (KH, KW), stride, pad),
            lambda: torch.nn.grad.conv2d_weight(xc, w.shape, gyc, stride, pad))
        t_f = bound(nbytes(x, w, b, out), flops)[0]
        t_d = bound(nbytes(gy, w, dx), flops)[0]
        for tag_, (ms, plain, lib), t_b in (("fwd", ms_f, t_f), ("dgrad", ms_d, t_d),
                                            ("wgrad", ms_w, None)):
            share = f", {t_b / ms:.0%} of its bound {t_b:.4f}" if t_b else ""
            print(f"    {tag_} {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s"
                  f"{share}), plain {plain:.4f} ms, cuDNN {lib:.4f} ms")
        fwd_rows.append(dict(layer=label, fwd_ms=ms_f[0], fwd_tflops=flops / ms_f[0] / 1e9,
                             fwd_share_of_bound=t_f / ms_f[0], fwd_library_ms=ms_f[2],
                             fwd_plain_ms=ms_f[1]))
        if mode == "conv2d":
            fwd_rows[-1].update(dgrad_ms=ms_d[0], dgrad_tflops=flops / ms_d[0] / 1e9,
                                dgrad_share_of_bound=t_d / ms_d[0], dgrad_library_ms=ms_d[2],
                                dgrad_plain_ms=ms_d[1])
        else:
            tr_rows.append(dict(layer=label, max_abs_err=err_d, ms=ms_d[0],
                                tflops=flops / ms_d[0] / 1e9, bound_ms=t_d,
                                share_of_bound=t_d / ms_d[0], plain_ms=ms_d[1],
                                library_ms=ms_d[2]))
        note = f"sum over the {len(one_pass)} layers of one MRD pass, B={TRAIN_B} x {TRAIN_SEG}"
        report.kernel("conv2d", err_f, ms_f[0], ms_f[1],
                      f"forward {note}; with the stride-1 layers' input gradients",
                      nbytes(x, w, b, out), flops, ms_f[2])
        report.kernel(mode, err_d, ms_d[0], ms_d[1],
                      "" if mode == "conv2d" else f"input gradient of the stride-2 layers, {note}",
                      nbytes(gy, w, dx), flops, ms_d[2])
        report.kernel("conv2d_wgrad", err_w, ms_w[0], ms_w[1], f"weight gradient {note}",
                      nbytes(x, gy, dw), flops, ms_w[2])
        parts[f"layer {i % n_layers} fwd"] += ms_f[0]
        parts[f"layer {i % n_layers} dgrad"] += ms_d[0]
        parts[f"layer {i % n_layers} wgrad"] += ms_w[0]
        t_w = bound(nbytes(x, gy, dw), flops)[0]
        wgrad_rows.append(dict(layer=label, ms=ms_w[0], tflops=flops / ms_w[0] / 1e9,
                               bound_ms=t_w, share_of_bound=t_w / ms_w[0], plain_ms=ms_w[1],
                               library_ms=ms_w[2]))
    report.extra.setdefault("conv2d", {})["train_v2_ms_by_layer"] = dict(parts)
    c_ms = sum(r["fwd_ms"] + r.get("dgrad_ms", 0.0) for r in fwd_rows)
    c_lib = sum(r["fwd_library_ms"] + r.get("dgrad_library_ms", 0.0) for r in fwd_rows)
    c_bound = sum(r["fwd_ms"] * r["fwd_share_of_bound"]
                  + r.get("dgrad_ms", 0.0) * r.get("dgrad_share_of_bound", 0.0) for r in fwd_rows)
    print(f"  conv2d (the forward and the stride-1 input gradients) over one MRD pass: "
          f"{c_ms:.4f} ms ({c_bound / c_ms:.0%} of its bound {c_bound:.4f}), cuDNN {c_lib:.4f} ms: "
          f"{'no slower than' if c_ms <= c_lib else 'SLOWER than'} cuDNN")
    report.extra["conv2d"].update(by_layer=fwd_rows, pass_ms=c_ms, pass_library_ms=c_lib,
                                  pass_bound_ms=c_bound)
    print("[train_v2] conv2d_transposed (the stride-(1, 2) layers' input gradients) by layer "
          "(ms, TFLOP/s, share of its bound, cuDNN conv2d_input ms, plain ms):")
    for r in tr_rows:
        print(f"    {r['layer']}: {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s, "
              f"{r['share_of_bound']:.0%} of {r['bound_ms']:.4f} ms, cuDNN {r['library_ms']:.4f}, "
              f"plain {r['plain_ms']:.4f}")
    t_ms, t_lib = sum(r["ms"] for r in tr_rows), sum(r["library_ms"] for r in tr_rows)
    t_bound = sum(r["bound_ms"] for r in tr_rows)
    mrd_passes = 3  # D real, D fake, G fake: each with its input gradients
    print(f"  conv2d_transposed over one MRD pass ({len(tr_rows)} launches): {t_ms:.4f} ms "
          f"({t_bound / t_ms:.0%} of its bound {t_bound:.4f}), cuDNN {t_lib:.4f} ms; a step's "
          f"{mrd_passes * len(tr_rows)} launches {mrd_passes * t_ms:.4f} ms")
    report.extra["conv2d_transposed"] = dict(
        by_layer=tr_rows, pass_ms=t_ms, pass_library_ms=t_lib, pass_bound_ms=t_bound,
        step=dict(launches=mrd_passes * len(tr_rows), ms=mrd_passes * t_ms,
                  library_ms=mrd_passes * t_lib, bound_ms=mrd_passes * t_bound))
    print(f"[train_v2] conv2d_wgrad by layer (ms, TFLOP/s, share of its bound, cuDNN ms):")
    for r in wgrad_rows:
        print(f"    {r['layer']}: {r['ms']:.4f} ms, {r['tflops']:.1f} TFLOP/s, "
              f"{r['share_of_bound']:.0%} of {r['bound_ms']:.4f} ms, cuDNN {r['library_ms']:.4f}")
    w_ms, w_lib = sum(r["ms"] for r in wgrad_rows), sum(r["library_ms"] for r in wgrad_rows)
    w_bound = sum(r["bound_ms"] for r in wgrad_rows)
    print(f"  conv2d_wgrad over one MRD pass: {w_ms:.4f} ms ({w_bound / w_ms:.0%} of its bound "
          f"{w_bound:.4f}), cuDNN {w_lib:.4f} ms: "
          f"{'no slower than' if w_ms <= w_lib else 'SLOWER than'} cuDNN")
    report.extra["conv2d_wgrad"] = dict(by_layer=wgrad_rows, pass_ms=w_ms,
                                        pass_library_ms=w_lib, pass_bound_ms=w_bound)

    print("[train_v2] K9 (K3's linear phase scan + comb_merge) at the step's template")
    (f0, noise, sr, hop, *_), _ = comb_calls[0]
    base_ref = source.nsf_phase_base_reference(f0, sr, hop, "linear")
    d = (source.nsf_phase_base(f0, sr, hop, "linear") - base_ref).abs()
    err = float(torch.minimum(d, 1 - d).max())
    ok = err <= 1e-6
    print(f"  nsf_phase_base linear: max_abs_err={err:.3e} (mod 1) tol=1.000e-06 "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        report.failures.append("nsf_phase_base linear")
    got = source.comb_merge(f0, base_ref, noise, sr, hop)
    ref = source.comb_merge_reference(f0, base_ref, noise, sr, hop)
    err = report.compare(f"comb_merge B={f0.shape[0]} T={f0.shape[1]} hop={hop}", got, ref,
                         1e-5)
    ms, plain, _ = timed_triple(lambda: source.comb_merge(f0, base_ref, noise, sr, hop),
                                lambda: source.comb_merge_reference(f0, base_ref, noise, sr,
                                                                    hop))
    ms_b, plain_b, _ = timed_triple(lambda: source.nsf_phase_base(f0, sr, hop, "linear"),
                                    lambda: source.nsf_phase_base_reference(f0, sr, hop,
                                                                            "linear"))
    print(f"    comb_merge: kernel {ms:.4f} ms, plain {plain:.4f} ms (no single PyTorch "
          f"call); the linear phase scan: kernel {ms_b:.4f} ms, plain {plain_b:.4f} ms")
    # per sample: interpolated f0, the float64 phase, round, sinc, gate, noise
    report.kernel("comb_merge", err, ms, plain, f"B={f0.shape[0]} T={f0.shape[1]} hop={hop}",
                  nbytes(f0, base_ref, noise, got), 30 * got.numel())
    report.extra.setdefault("nsf_phase_base", {})["train_v2_linear"] = dict(
        ms=ms_b, plain_ms=plain_b, shape=f"B={f0.shape[0]} T={f0.shape[1]} hop={hop}")

    print("[train_v2] K5 at the step's STFT shapes (MRD resolutions, mel scales)")
    report.extra.setdefault("stft_magnitude", {})["train_v2"] = measure_stft_configs(
        report, stft_calls)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 32)
    bwd = {}
    for (g, y, n_fft, hop, win), _ in stft_bwd_calls:
        r = measure_stft_backward(report, g, y, n_fft, hop, win, gen)
        bwd[f"n_fft {n_fft} hop {hop} win {win}"] = dict(
            max_abs_err=r["err"], ms=r["ms"], plain_ms=r["plain"], library_ms=r["lib"],
            bound_ms=bound(*r["work"])[0])
    report.extra.setdefault("stft_backward", {})["train_v2"] = bwd


def phase_train_v2(report: Report, seed: int):
    """The fourth slice's path: ``VocoderTrainer.fit`` on
    ``configs/vocoder_refinegan.py`` at full width (RefineGAN start_channels
    16, GAN flavor v2 with MPD + MRD, float32), a resume, the whole step
    through the kernels against the whole step through the plain versions,
    and each new kernel at the step's shapes."""
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import blocked_conv, mel

    launches, totals, calls = drive_training(
        report, seed, "train_v2", "vocoder_refinegan.py",
        lambda cfg: (f"RefineGAN start_channels {cfg.model.generator.start_channels}, hop "
                     f"{cfg.model.generator.hop_length} (down 2.2.8.8, up 8.8.2.2), MPD periods "
                     f"{cfg.model.mpd.periods}, MRD {cfg.model.mrd.resolutions}"),
        2, 5, train_v2_launches_per_step,
        {
            (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
            (source, "comb_tooth"): source.comb_tooth_reference,
            (mel, "stft_magnitude"): plain_stft_magnitude,
            (blocked_conv, "conv2d_nhwc"): blocked_conv.conv2d_nhwc_reference,
        },
        [(blocked_conv, "conv2d_nhwc"), (mel, "stft_magnitude"), (mel, "stft_backward"),
         (source, "comb_tooth"), (nsf_hifigan, "conv1d_wgrad"),
         (nsf_hifigan, "_launch_conv", k4_key)], state_twice=True)
    measure_train_v2_kernels(report, seed, calls["conv2d_nhwc"], calls["stft_magnitude"],
                             calls["stft_backward"], calls["comb_tooth"])
    print("[train_v2] conv1d_wgrad at the RefineGAN generator's weight gradients of one step")
    report.extra.setdefault("conv1d_wgrad", {})["train_v2"] = measure_wgrad_calls(
        report, calls["conv1d_wgrad"], "train_v2")
    print("[train_v2] K4 at every shape of the RefineGAN generator's forward and input "
          "gradients of one step")
    report.extra.setdefault("conv1d", {})["train_v2"] = measure_k4_calls(
        report, calls["_launch_conv"], "train_v2")
    report.finish("train_v2")
    return launches, totals


def train_sine_launches_per_step(trainer) -> dict:
    """Kernel launches one v2 GAN step with the sine template implies: the
    comb step's (``train_v2_launches_per_step``) with K9 sine in place of
    K9 comb, and, since the template now depends on trained weights (the
    merge), the input gradients of the two convs that read it:
    ``template_conv`` (stride 1, K4) and ``source_conv`` (stride 64, K4's
    transposed mode). The merge's own gradient is torch (``_SineMerge``)."""
    out = train_v2_launches_per_step(trainer)
    del out["comb_merge"]
    out.update(sine_merge=1, conv1d=out["conv1d"] + 1, conv_transpose1d=1)
    return out


def phase_train_sine(report: Report, seed: int):
    """The sixth slice's training path: ``VocoderTrainer.fit`` on
    ``configs/vocoder_refinegan.py`` with ``template_generator="sine"`` at
    full width (float32), a resume, the whole step through the kernels
    against the plain step, exact launches per step (K9 sine once), and K9
    sine at the step's template (B=16 x 128 frames, hop 256) against its
    plain version."""
    import torch

    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import blocked_conv, mel

    launches, totals, calls = drive_training(
        report, seed, "train_sine", "vocoder_refinegan.py",
        lambda cfg: (f"RefineGAN start_channels {cfg.model.generator.start_channels}, hop "
                     f"{cfg.model.generator.hop_length}, template "
                     f"{cfg.model.generator.template_generator!r}, MPD periods "
                     f"{cfg.model.mpd.periods}, MRD {cfg.model.mrd.resolutions}"),
        2, 4, train_sine_launches_per_step,
        {
            (nsf_hifigan, "conv1d"): nsf_hifigan.conv1d_reference,
            (source, "sine_template"): source.sine_template_reference,
            (mel, "stft_magnitude"): plain_stft_magnitude,
            (blocked_conv, "conv2d_nhwc"): blocked_conv.conv2d_nhwc_reference,
        },
        [(source, "sine_template")],
        override=lambda cfg: cfg.model.generator.update(template_generator="sine"),
        state_twice=True)

    (f0, rand_ini, noise, weight, bias, sr, hop, *_), _ = calls["sine_template"][0]
    weight, bias = weight.detach(), bias.detach()
    print(f"[train_sine] K9 sine (sine_merge) at the step's template, B={f0.shape[0]} "
          f"T={f0.shape[1]} hop={hop}, {rand_ini.shape[1]} harmonic")
    base = source.nsf_phase_base_reference(f0, sr, hop, "linear")
    args = (f0, base, rand_ini, noise, weight, bias, sr, hop)
    with torch.no_grad():
        got = source.sine_merge(*args)
        err = report.compare(f"sine_merge B={f0.shape[0]} T={f0.shape[1]} hop={hop}", got,
                             source.sine_merge_reference(*args), 1e-5)
        ms, plain, _ = timed_triple(lambda: source.sine_merge(*args),
                                    lambda: source.sine_merge_reference(*args))
    print(f"    kernel {ms:.4f} ms, plain {plain:.4f} ms (no single PyTorch call)")
    # per sample and harmonic: interpolated f0, the float64 phase, sin, the
    # sr / 2 and voicing gates, noise, merge; tanh (~40)
    report.kernel("sine_merge", err, ms, plain, f"B={f0.shape[0]} T={f0.shape[1]} hop={hop}",
                  nbytes(f0, base, rand_ini, noise, weight, bias, got), 40 * noise.numel())
    report.finish("train_sine")
    return launches, totals


# The diffusion training phases: configs/svc_hubert_soft.py (WaveNet) and
# configs/denoiser_cn_hubert.py (ConvNeXt) at full width, batch 20 x 512
# frames (the configs' batch, bucketed), float32
DIFF_B, DIFF_FRAMES = 20, (400, 512)
DIFF_WARM, DIFF_TIMED = 2, 10
# K1's launches in one training step of the 20-block WaveNet: the training
# forward, the output product, the gate and input backward and the weight
# gradients (dW_conv and dW_out in one launch) once a block; no
# conv1d_wgrad; the split of the step's 40 weights in one launch
DIFF_LAUNCHES = {"wavenet_gate_train": 20, "wavenet_out": 20, "wavenet_gate_backward": 20,
                 "wavenet_input_backward": 20, "wavenet_weight_grad": 20,
                 "wavenet_weight_split": 1}
# K10's launches in one training step of the 20-block ConvNeXt: the forward
# and the backward once a block
CONVNEXT_TRAIN_LAUNCHES = {"depthwise_conv7_norm": 20, "depthwise_conv7_norm_backward": 20}


def make_svc_dataset(rng, root: Path):
    """60 training and 4 validation items of 400-512 frames in the SVC
    preprocessing contract (``.npy`` dicts): mel [128, T] in [-5, 0],
    contents [256, T], pitches [T] at 80-600 Hz, key_shift 0, time_stretch 1."""
    for split, n in (("train", 60), ("valid", 4)):
        (root / split).mkdir(parents=True)
        for i in range(n):
            T = int(rng.integers(DIFF_FRAMES[0], DIFF_FRAMES[1] + 1))
            np.save(root / split / f"{i}.npy", {
                "path": f"{split}/{i}.wav", "time_stretch": 1.0, "key_shift": 0.0,
                "mel": rng.uniform(-5, 0, (MEL, T)).astype(np.float32),
                "contents": rng.standard_normal((256, T)).astype(np.float32),
                "pitches": rng.uniform(80, 600, T).astype(np.float32)})


def diffusion_config(seed: int, config_file: str, tmp: Path, dataset_type=None):
    """The config at full width over a synthetic SVC dataset under ``tmp``
    (read by ``dataset_type`` when given): 12 steps, validation (one batch,
    UniPC at interval 100, a random NSF-HiFiGAN) at 6 and 12, metrics every
    step; the loaders read in this process (no worker processes to stop)."""
    from fish_diffusion_tpu_torch.config import Config
    from fish_diffusion_tpu_torch.datasets.loader import build_loader

    make_svc_dataset(np.random.default_rng(seed + 60), tmp / "data")
    cfg = Config.fromfile(ROOT / "configs" / config_file)
    cfg.trainer.update(precision="32-true", max_steps=DIFF_WARM + DIFF_TIMED,
                       val_check_interval=(DIFF_WARM + DIFF_TIMED) // 2, limit_val_batches=1,
                       val_sampler_interval=100, log_every_n_steps=1)
    cfg.model["vocoder"] = dict(type="NsfHifiGAN", random_init=True, seed=seed + 61,
                                sampling_rate=SR, mel_channels=MEL, use_natural_log=False)
    for split, part in (("train", cfg.dataset.train), ("valid", cfg.dataset.valid)):
        part["path"] = str(tmp / "data" / split)
        if dataset_type:
            part["type"] = dataset_type
    # the training order from the seed (the loader's, as the JAX loader
    # draws it)
    loader = build_loader(cfg.dataset.train, {**cfg.dataloader.train, "num_workers": 0,
                                              "seed": seed + 64})
    valid = build_loader(cfg.dataset.valid, {**cfg.dataloader.valid, "num_workers": 0})
    assert cfg.dataloader.train.batch_size == DIFF_B
    return cfg, loader, valid


def drive_diffusion_training(report: Report, seed: int, tag: str, cfg, loader, valid,
                             per_step: dict, forward: dict, plain_fns: dict, backward_fns,
                             recorders, kinks=None):
    """``DiffusionTrainer.fit`` on ``cfg``: 12 steps with validation and a
    checkpoint at steps 6 and 12, exactly ``per_step`` launches every step;
    3 profiled steps; a resume for 2 more steps; then the whole step through
    the kernels against the plain step (``plain_fns``: every kernel wrapper
    to its plain version) on the same parameters, batch, t and noise: the
    loss within 1e-5 relative; the backward through the kernels against the
    backward through their plain versions (``backward_fns``, the keys of
    ``plain_fns`` that the backward calls) on one forward (which launches
    the ``forward`` kernels alone), every gradient within 1e-4 relative L2;
    the whole step's gradients within max(1e-4, 3 x the plain step's own
    move under mel x (1 + d)), the median of six paired comparisons, the
    plain step of each pair on the kernel step's side of every ReLU of the
    module ``kinks`` (``pinned_kinks``) and the two forwards within 1e-4 of
    scale at those ReLUs' inputs. ``recorders`` keep the kernel step's
    calls. Returns (the fit's launches, totals, the state)."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.training.diffusion_state import batch_to_device, model_kwargs
    from fish_diffusion_tpu_torch.training.diffusion_trainer import DiffusionTrainer

    say = f"[{tag}]"
    tmp = Path(cfg.dataset.train["path"]).parents[1]
    t0 = time.perf_counter()
    trainer = DiffusionTrainer(cfg, log_dir=str(tmp / "logs"), steps_per_epoch=len(loader),
                               device=DEVICE)
    print(f"{say} trainer built in {time.perf_counter() - t0:.1f} s")
    expected = {name: 0 for name in kernels.LAUNCHES}
    expected.update(per_step)
    step_fn = trainer._train_step
    steps, peak, shapes = [], {}, []

    def timed_step(state, batch, generator):
        if len(steps) == DIFF_WARM:
            torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch, generator)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_step
        shapes.append(tuple(batch["mel"].shape))
        steps.append((seconds, {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES},
                      {k: float(v) for k, v in metrics.items()}))
        if len(steps) == DIFF_WARM + DIFF_TIMED:
            peak["bytes"] = torch.cuda.max_memory_allocated()
        return state, metrics

    trainer._train_step = timed_step
    kernels.reset_launches()
    t0 = time.perf_counter()
    state = trainer.fit(loader, valid, seed=seed)
    torch.cuda.synchronize()
    fit_seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    trainer._train_step = step_fn

    secs = [s for s, _, _ in steps[DIFF_WARM:]]
    median = statistics.median(secs)
    frames = DIFF_B * 512
    print(f"{say} fit: {len(steps)} steps + 2 validations + 2 checkpoints in "
          f"{fit_seconds:.1f} s; steps {DIFF_WARM + 1}-{DIFF_WARM + DIFF_TIMED}: median "
          f"{median:.4f} s per step (min {min(secs):.4f}, max {max(secs):.4f}), "
          f"{frames / median:.0f} mel frames trained per s (batch {shapes[-1]}), "
          f"{1 / median:.3f} steps/s")
    wall = trainer.last_wall_breakdown
    print(f"{say} wall breakdown: " + ", ".join(f"{k} {v:.2f}" for k, v in wall.items()))
    print(f"{say} peak device memory over the timed steps {peak['bytes'] / 2**30:.2f} GiB")
    for i, (s, grew, metrics) in enumerate(steps):
        ok = (grew == expected and all(np.isfinite(v) for v in metrics.values())
              and shapes[i] == (DIFF_B, 512, MEL))
        print(f"  step {i + 1}: {s:.4f} s, " + ", ".join(f"{k} {v:.5f}" for k, v in
                                                        metrics.items())
              + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            print(f"    launches {({k: v for k, v in grew.items() if v})}, "
                  f"expected {({k: v for k, v in expected.items() if v})}, batch {shapes[i]}")
            report.failures.append(f"{tag} step {i + 1}")
    print(f"{say} launches per step: {per_step} (every step exactly)")
    rows = [json.loads(line) for line in open(tmp / "logs" / "metrics.jsonl")]
    val = [(r["step"], r["valid_loss"]) for r in rows if "valid_loss" in r]
    wavs = sorted(p.name for p in (tmp / "logs").glob("*.wav"))
    mels = sorted(p.name for p in (tmp / "logs").glob("*.npy"))
    ckpts = trainer.ckpt.all_steps()
    print(f"{say} validation loss {val}; {len(wavs)} wav files, {len(mels)} mel files; "
          f"checkpoints at steps {ckpts}")
    if (state.step != DIFF_WARM + DIFF_TIMED or len(val) != 2
            or not all(np.isfinite(v) for _, v in val) or len(wavs) != 8 or len(mels) != 8
            or ckpts != [6, 12]):
        report.failures.append(f"{tag} fit / validation / checkpoints")
    for name in per_step:
        if launches[name] <= 0:
            report.failures.append(f"{name} never launched on the {tag} path")

    # resume from the checkpoint of the last step, for two more steps
    saved = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    totals_profile = profile_steps(state, step_fn, batch_to_device(next(iter(loader)), DEVICE),
                                   seed, tag, median)
    cfg.trainer["max_steps"] = DIFF_WARM + DIFF_TIMED + 2
    resumed = DiffusionTrainer(cfg, log_dir=str(tmp / "logs"), steps_per_epoch=len(loader),
                               device=DEVICE)
    restored = resumed.ckpt.restore(resumed.init_state(seed + 1))
    same = all(torch.equal(v.cpu(), saved[k]) for k, v in restored.model.state_dict().items())
    count = restored.optimizer.count
    after = resumed.fit(loader, valid, resume=True, seed=seed)
    ok = same and count == DIFF_WARM + DIFF_TIMED and after.step == DIFF_WARM + DIFF_TIMED + 2
    print(f"{say} resume: checkpoint of step {DIFF_WARM + DIFF_TIMED} restored (parameters "
          f"{'identical' if same else 'DIFFER'}, {count} updates), two more steps -> step "
          f"{after.step} {'ok' if ok else 'FAIL'}")
    if not ok:
        report.failures.append(f"{tag} resume")
    del resumed, restored, after
    torch.cuda.empty_cache()

    # the whole step, through the kernels and through every plain version,
    # from the same parameters, batch, t and noise
    model = state.model
    batch = batch_to_device(next(iter(loader)), DEVICE)
    gen = torch.Generator(device=DEVICE).manual_seed(seed + 62)
    t = torch.randint(0, cfg.model.diffusion.timesteps, (DIFF_B,), generator=gen, device=DEVICE)
    noise = torch.randn(batch["mel"].shape, generator=gen, device=DEVICE)

    print(f"{say} the gate's state: parameters {digest(model.parameters())}, batch "
          f"{digest(batch[k] for k in sorted(batch) if torch.is_tensor(batch[k]))}, t and "
          f"noise {digest((t, noise))} (the first 16 hex digits of the SHA-256 of their bytes: "
          f"two runs from one seed that agree here start the gate from the same state)")

    def one_step(swaps, order=None, mel_scale=1.0, relu=None):
        """Loss, gradients and launches of one step from the same state;
        ``order`` permutes the batch's items (the same function, its sums
        over the batch taken in another order); ``mel_scale`` scales the
        mel; ``relu``, a ``pinned_kinks``, is entered around the step."""
        b, tt, nn_ = batch, t, noise
        if order is not None:
            b = {k: v[order] for k, v in batch.items()}
            tt, nn_ = t[order], noise[order]
        b = {**b, "mel": b["mel"] * mel_scale}
        model.zero_grad(set_to_none=True)
        kernels.reset_launches()
        with plain_path(swaps), relu or contextlib.nullcontext():
            loss = model(**model_kwargs(b), t=tt, noise=nn_)["loss"]
            loss.backward()
        torch.cuda.synchronize()
        return (float(loss.detach()),
                {k: p.grad.detach().clone() for k, p in model.named_parameters()},
                {k: v for k, v in kernels.LAUNCHES.items() if v})

    def rel_l2(got, ref):
        return {k: float((got[k] - ref[k]).double().norm() / ref[k].double().norm())
                for k in ref if float(ref[k].abs().max()) > 0}

    def summary(d):
        k = max(d, key=d.get)
        return f"median {statistics.median(d.values()):.2e}, max {d[k]:.2e} ({k})"

    def kernel_step(mel_scale=1.0):
        """The kernel step at mel x ``mel_scale``, its ReLUs recorded."""
        relu = pinned_kinks([(kinks, "F")], inputs=True) if kinks is not None else None
        return (*one_step({}, mel_scale=mel_scale, relu=relu), relu)

    def pinned_plain_step(relu_k, mel_scale=1.0):
        """The plain step at mel x ``mel_scale`` on the kernel step's side of
        each ReLU (``relu_k``, the kernel step's record) -> (gradients, the
        forwards' largest difference at the ReLUs' inputs over their scale,
        the units the two forwards decided differently)."""
        relu = pinned_kinks([(kinks, "F")], other=relu_k)
        grads = one_step(plain_fns, mel_scale=mel_scale, relu=relu)[1]
        gap, flips = relu.check()
        return grads, gap, sum(flips.values())

    for r in recorders:
        r.start()
    try:
        loss_k, g_k, launched_k, relu_k = kernel_step()
    finally:
        for r in recorders:
            r.stop()
    loss_p, g_p, launched_p = one_step(plain_fns)
    if launched_p:
        report.failures.append(f"{tag}: plain step launched kernels: {launched_p}")
    if launched_k != per_step:
        report.failures.append(f"{tag}: kernel step launched {launched_k}")
    rel = abs(loss_k - loss_p) / abs(loss_p)
    print(f"{say} whole step, kernels vs plain: loss {loss_k:.7f} vs {loss_p:.7f}, relative "
          f"{rel:.2e} (tol 1e-5) {'ok' if rel <= 1e-5 else 'FAIL'}")
    if not rel <= 1e-5:
        report.failures.append(f"{tag} step loss vs plain: {rel:.2e}")
    zero = [k for k in g_p if float(g_p[k].abs().max()) == 0]
    if any(float(g_k[k].abs().max()) != 0 for k in zero):
        report.failures.append(f"{tag}: a gradient that is 0 in the plain step is not")

    # (1) the backward alone: the same forward (the kernels), the backward
    # through its kernels against the backward through the plain versions.
    # Both differentiate one forward, so every saved tensor is the same: the
    # gradients may differ by rounding only.
    backward_plain = {key: plain_fns[key] for key in backward_fns}
    _, g_h, launched_h = one_step(backward_plain)
    l2_bwd = rel_l2(g_k, g_h)
    bad = [k for k, v in l2_bwd.items() if not v <= 1e-4]
    print(f"{say} whole step, the backward through the kernels vs through the plain versions "
          f"(one forward, the kernels'): every gradient's relative L2 (tol 1e-4): "
          f"{summary(l2_bwd)} over {len(l2_bwd)} tensors ({len(zero)} all-zero in both) "
          f"{'ok' if not bad else 'FAIL'}")
    if bad or launched_h != forward:
        report.failures.append(f"{tag} backward vs plain backward: {bad[:5]} {launched_h}")

    # (2) the whole step, kernels vs plain. A kink in the network (the
    # WaveNet's ReLUs after the input and the skip projections) puts a unit
    # that lies within the two forwards' float32 difference of 0 on one
    # side in one step and on the other in the other, and such a flip moves
    # one row's gradient, which reaches every parameter (~1e-3 relative L2
    # on every tensor, at some states and not others: a comparison across a
    # discontinuity, not of the kernels). So the plain step of each pair
    # takes the kernel step's side of every ReLU (``pinned_kinks``), and the
    # two forwards are held at those ReLUs' inputs: their largest difference
    # within 1e-4 of its scale, so that a unit decided differently lies
    # within rounding of 0. The floor is the plain step's own move when its
    # mel changes by a relative 1e-6 to 3e-6 (FLOOR_SCALES); the gate reads,
    # for each tensor, the median of six paired comparisons, kernels vs
    # plain at mel x (1 + d), d = 0 and FLOOR_SCALES, against 1e-4 or 3 x
    # the largest move, whichever is larger. The plain step with its batch
    # reversed (the same function, its sums in another order) shows the
    # rounding without flips.
    g_pp, gap, flips = pinned_plain_step(relu_k) if kinks is not None else (g_p, 0.0, 0)
    l2 = rel_l2(g_k, g_pp)
    del g_pp, relu_k
    moves = {k: 0.0 for k in l2}
    paired = {k: [v] for k, v in l2.items()}
    kink_gaps, kink_flips = [gap], [flips]
    for d in FLOOR_SCALES:
        _, g_d, _ = one_step(plain_fns, mel_scale=1.0 + d)
        for k, v in rel_l2(g_d, g_p).items():
            moves[k] = max(moves[k], v)
        _, g_kd, _, relu_kd = kernel_step(1.0 + d)
        g_pd, gap, flips = (pinned_plain_step(relu_kd, 1.0 + d) if kinks is not None
                            else (g_d, 0.0, 0))
        for k, v in rel_l2(g_kd, g_pd).items():
            paired[k].append(v)
        kink_gaps.append(gap)
        kink_flips.append(flips)
        del g_d, g_kd, g_pd, relu_kd
    if kinks is not None:
        ok = max(kink_gaps) <= 1e-4
        print(f"{say} the ReLUs' inputs, kernel forward vs plain forward, the six pairs: "
              f"largest difference / scale {', '.join(f'{v:.2e}' for v in kink_gaps)} (tol "
              f"1e-4); units on opposite sides {kink_flips}, each pinned to the kernel "
              f"step's side {'ok' if ok else 'FAIL'}")
        if not ok:
            report.failures.append(f"{tag}: the forwards differ at the ReLUs' inputs by "
                                   f"{max(kink_gaps):.2e} of their scale")
    order = torch.arange(DIFF_B - 1, -1, -1, device=DEVICE)
    _, g_q, _ = one_step(plain_fns, order)
    reordered = rel_l2(g_q, g_p)
    del g_q
    held = {k: statistics.median(v) for k, v in paired.items()}
    tol = {k: max(1e-4, 3 * moves[k]) for k in l2}
    ratio = {k: held[k] / tol[k] for k in l2}
    bad = [k for k in l2 if not held[k] <= tol[k]]
    print(f"{say} whole step, every parameter's gradient, relative L2 kernels vs plain: at "
          f"d = 0 {summary(l2)}; the median of the six pairs {summary(held)}; the plain "
          f"step's own under mel x (1 + d): {summary(moves)}; tol max(1e-4, 3 x that), the "
          f"median over it {summary(ratio)} {'ok' if not bad else 'FAIL'}")
    print(f"{say} the plain step with its batch reversed (rounding without flips): "
          f"{summary(reordered)}")
    if bad:
        report.failures.append(f"{tag} step gradients vs plain: {bad[:5]}")
    totals = {
        f"{tag}_step_s_median": median, f"{tag}_step_s": secs,
        f"{tag}_frames_per_s": frames / median,
        f"{tag}_peak_gib": peak["bytes"] / 2**30,
        f"{tag}_wall": wall, f"{tag}_losses_last": steps[-1][2],
        f"{tag}_launches_per_step": per_step,
        f"{tag}_profile": totals_profile,
        f"{tag}_step_vs_plain": {
            "loss_rel": rel, "backward_rel_l2_max": max(l2_bwd.values()),
            "backward_rel_l2_median": statistics.median(l2_bwd.values()),
            "grad_rel_l2_max": max(l2.values()),
            "grad_rel_l2_median": statistics.median(l2.values()),
            "grad_rel_l2_paired_median_max": max(held.values()),
            "plain_move_rel_l2_max": max(moves.values()),
            "plain_move_rel_l2_median": statistics.median(moves.values()),
            "held_over_tol_max": max(ratio.values()),
            "reordered_rel_l2_max": max(reordered.values()),
            "relu_input_gap_max": max(kink_gaps), "relu_units_opposite": kink_flips},
    }
    del g_k, g_p, g_h
    model.zero_grad(set_to_none=True)
    return launches, totals, state


def phase_diffusion_train(report: Report, seed: int):
    """The eleventh slice's path: ``DiffusionTrainer.fit`` on
    ``configs/svc_hubert_soft.py`` at full width (WaveNet 20 x 512, batch 20
    x 512 frames, float32, the config's warmup-cosine AdamW and clip 0.5)
    over a synthetic dataset (``drive_diffusion_training``: exact K1
    launches every step, validation, checkpoints, a resume, the whole step
    against the plain step); then K1's training kernels at the step's
    shapes for each dilation against their plain versions, timed, bit-equal
    on rerun, with ``conv1d_wgrad`` (the route the weight gradients took
    before) timed on the same shapes."""
    from fish_diffusion_tpu_torch.models import wavenet

    tag = "diffusion_train"
    cfg, loader, valid = diffusion_config(
        seed, "svc_hubert_soft.py", Path(tempfile.mkdtemp(prefix="chip_smoke_diffusion_")))
    den = cfg.model.diffusion.denoiser
    print(f"[{tag}] configs/svc_hubert_soft.py: WaveNet {den.residual_layers} x "
          f"{den.residual_channels} (dilation cycle {den.dilation_cycle}), noise loss "
          f"{cfg.model.diffusion.noise_loss!r}, batch {DIFF_B} x {DIFF_FRAMES[0]}-"
          f"{DIFF_FRAMES[1]} frames (bucketed to 512), float32, clip "
          f"{cfg.trainer.gradient_clip_val}, {len(loader)} steps per epoch")
    plain_fns = {
        (wavenet, "split_weights"): wavenet.split_weights_reference,
        (wavenet, "residual_gate_train"): wavenet.residual_gate_train_reference,
        (wavenet, "residual_out"): wavenet.residual_out_reference,
        (wavenet, "residual_gate_backward"): wavenet.residual_gate_backward_reference,
        (wavenet, "residual_input_backward"): wavenet.residual_input_backward_reference,
        (wavenet, "residual_weight_grad"): wavenet.residual_weight_grad_reference,
    }
    backward = [key for key in plain_fns
                if key[1] not in ("split_weights", "residual_gate_train", "residual_out")]
    recorders = [recording(wavenet, "residual_gate_train", key=lambda a, kw: a[5]),
                 recording(wavenet, "residual_out", key=lambda a, kw: 0),
                 recording(wavenet, "residual_gate_backward", key=lambda a, kw: 0),
                 recording(wavenet, "residual_input_backward", key=lambda a, kw: a[3]),
                 recording(wavenet, "residual_weight_grad", key=lambda a, kw: a[5])]
    forward = {k: DIFF_LAUNCHES[k] for k in ("wavenet_gate_train", "wavenet_out",
                                             "wavenet_weight_split")}
    launches, totals, state = drive_diffusion_training(
        report, seed, tag, cfg, loader, valid, DIFF_LAUNCHES, forward, plain_fns, backward,
        recorders, kinks=wavenet)
    measure_k1_training(report, {r.name: r.calls for r in recorders}, totals)
    measure_training_split(report, state.model.diffusion.denoise_fn, totals, tag)
    report.finish(tag)
    return launches, totals


def phase_convnext_train(report: Report, seed: int):
    """The thirteenth slice's path: ``DiffusionTrainer.fit`` on
    ``configs/denoiser_cn_hubert.py`` at full width (ConvNext 20 x 512 x 4,
    batch 20 x 512 frames, float32, the config's warmup-cosine AdamW and
    clip 0.5) over the synthetic SVC dataset, with the dataset set to
    ``NaiveSVCDataset`` (``drive_diffusion_training``: K10's forward and
    backward 20 times every step, validation with K10 serving,
    checkpoints, a resume, the whole step against the plain step); then
    K10's backward on the step's own inputs at each dilation against its
    plain version (1e-4 of scale, bit-equal on rerun), timed beside its
    bound and cuDNN's, and one block's forward and backward against torch
    autograd of the plain block."""
    from fish_diffusion_tpu_torch.models import convnext

    tag = "convnext_train"
    print(f"[{tag}] configs/denoiser_cn_hubert.py names NaiveDenoiserDataset, whose batches "
          f"carry no pitches; its DiffSVC model has a pitch encoder, so it trains here on "
          f"NaiveSVCDataset (the dataset of its base, configs/_base_/datasets/naive_svc.py)")
    cfg, loader, valid = diffusion_config(
        seed, "denoiser_cn_hubert.py", Path(tempfile.mkdtemp(prefix="chip_smoke_cn_")),
        dataset_type="NaiveSVCDataset")
    den = cfg.model.diffusion.denoiser
    print(f"[{tag}] ConvNext {den.num_layers} x {den.dim} x {den.mlp_factor} (dilation cycle "
          f"{den.dilation_cycle}, condition {den.condition_dim}), noise loss "
          f"{cfg.model.diffusion.noise_loss!r}, batch {DIFF_B} x {DIFF_FRAMES[0]}-"
          f"{DIFF_FRAMES[1]} frames (bucketed to 512), float32, clip "
          f"{cfg.trainer.gradient_clip_val}, {len(loader)} steps per epoch")
    plain_fns = {
        (convnext, "depthwise_conv7_norm"): convnext.depthwise_conv7_norm_reference,
        (convnext, "depthwise_conv7_norm_backward"):
            convnext.depthwise_conv7_norm_backward_reference,
    }
    backward = list(plain_fns)[1:]
    recorders = [recording(convnext, "depthwise_conv7_norm_backward", key=lambda a, kw: a[9])]
    t0 = time.perf_counter()
    launches, totals, state = drive_diffusion_training(
        report, seed, tag, cfg, loader, valid, CONVNEXT_TRAIN_LAUNCHES,
        {"depthwise_conv7_norm": CONVNEXT_TRAIN_LAUNCHES["depthwise_conv7_norm"]}, plain_fns,
        backward, recorders)
    t1 = time.perf_counter()
    measure_k10_training(report, {r.name: r.calls for r in recorders}, state.model, totals)
    print(f"[{tag}] the training path and its gates {t1 - t0:.1f} s, K10's measurements "
          f"{time.perf_counter() - t1:.1f} s")
    report.finish(tag)
    return launches, totals


def profile_steps(state, step_fn, batch, seed: int, tag: str, step_s: float,
                  n: int = 3) -> dict:
    """``n`` training steps under ``torch.profiler``: the device time by
    kernel (per step), the device's busy time (kernels, copies and fills:
    not the device-side spans of ``record_function`` annotations such as
    the optimizer's step, which cover kernels counted on their own rows) and
    its idle share of the window's wall time, and of ``step_s``, the step's
    time without the profiler (whose host work lengthens the window).
    Returns them, or ``{"device": "not measured"}`` when the trace holds no
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 63)
    state, _ = step_fn(state, batch, gen)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step_fn(state, batch, gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    host_keys = {e.key for e in events if e.device_type != DeviceType.CUDA}
    rows, spans = [], 0.0
    for e in events:
        if e.device_type != DeviceType.CUDA:  # the kernels, not the ops that launch them
            continue
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if dev <= 0:
            continue
        # an annotation's device-side twin shares its key with the host-side span
        if getattr(e, "is_user_annotation", False) or e.key in host_keys:
            spans += dev / 1e3 / n
            continue
        rows.append((dev / 1e3 / n, e.count // n, e.key))
    if not rows:
        print(f"[{tag}] profile: the trace holds no device time (not measured)")
        return {"device": "not measured"}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    window = wall / n * 1e3
    print(f"[{tag}] profile of {n} steps (torch.profiler): device busy {busy:.2f} ms a step "
          f"(kernels, copies, fills; annotation spans {spans:.2f} ms left out) of "
          f"{window:.2f} ms wall (idle share {1 - busy / window:.3f}); of the unprofiled "
          f"step's {step_s * 1e3:.2f} ms: idle share {1 - busy / (step_s * 1e3):.3f}; "
          f"device ms a step by kernel:")
    for ms, count, name in rows[:14]:
        print(f"    {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    return {"busy_ms_per_step": busy, "wall_ms_per_step": window,
            "idle_share": 1 - busy / window, "step_ms": step_s * 1e3,
            "idle_share_of_step": 1 - busy / (step_s * 1e3), "annotation_spans_ms": spans,
            "top": [(name[:90], ms, count) for ms, count, name in rows[:14]]}


def k10_backward_work(x, C: int):
    """Bytes and float32 operations K10's backward needs: go, x and cond
    read and dy written once (16 bytes an element; the step projections,
    the mask, the parameters and the [10 + B, C] gradients besides); per
    element the pre-add (2), the conv (14), the norm's statistics and dh
    (14), the column sums of go n, go and dh (4), dk (14), the 7 taps of dy
    (14) and its sum for dstep (1): 63."""
    B_, T_, _ = x.shape
    return 4 * nbytes(x) + 8 * B_ * C + B_ * T_ + 4 * 19 * C, 63 * x.numel()


def measure_k10_training(report: Report, calls: dict, model, totals: dict):
    """K10's backward at the step's recorded inputs (B=20 x 512 x 512), at
    each dilation: the kernel (one kernel, dh on chip, and its slots' sum)
    against the plain whole backward (1e-4 of each output's scale), a rerun
    bit-equal, the kernel's and the plain version's device time beside the bound and the whole backward through cuDNN (autograd of the
    depthwise ``F.conv1d(groups=C)`` + ``F.layer_norm``), summed over a
    step's launches (5 blocks a dilation); then one block's forward and
    backward through the kernels against torch autograd of the plain block
    at each dilation."""
    import torch
    import torch.nn.functional as F

    from fish_diffusion_tpu_torch.models import convnext

    tag = "[convnext_train]"
    print(f"{tag} K10's backward at the step's inputs (B=20 T=512 C=512)")
    by_d = {}
    for d, (args, _, count) in sorted(calls["depthwise_conv7_norm_backward"].items()):
        go, x, step, cond, mask, k, b, ln_w, ln_b, _ = (
            a.detach() if torch.is_tensor(a) else a for a in args)
        go = go.contiguous()
        C = x.shape[-1]
        masked = 0 if mask is None else int(mask.sum())
        label = f"depthwise_conv7_norm_backward d={d}, {masked} masked rows"
        with torch.no_grad():
            fn = lambda: convnext.depthwise_conv7_norm_backward(  # noqa: E731
                go, x, step, cond, mask, k, b, ln_w, ln_b, d)
            ref_fn = lambda: convnext.depthwise_conv7_norm_backward_reference(  # noqa: E731
                go, x, step, cond, mask, k, b, ln_w, ln_b, d)
            got, ref = fn(), ref_fn()
            names = ("dx", "dstep", "dcond", "dk", "db", "dln_scale", "dln_bias")
            err = max(report.compare(f"{label} {name}", g, r, 1e-4 * max_abs(r))
                      for name, g, r in zip(names, got, ref))
            check_rerun(report, label, torch.cat([t.flatten() for t in got]),
                        torch.cat([t.flatten() for t in fn()]))
            ms = device_ms(fn)
            # the plain version launches dozens of kernels a call: two calls
            # a timing, so that the hold outlasts their enqueue
            plain = device_ms(ref_fn, reps=2)
        # the whole backward through cuDNN: autograd of its forward, the
        # pre-added, masked input laid out [B, C, T]
        y_t = convnext._pre_add(x, step, cond, mask).transpose(1, 2).contiguous()
        y_leaf = y_t.clone().requires_grad_(True)
        wl = k.t().unsqueeze(1).contiguous().requires_grad_(True)
        bl = b.clone().requires_grad_(True)
        lw, lb = ln_w.clone().requires_grad_(True), ln_b.clone().requires_grad_(True)
        out = F.layer_norm(F.conv1d(y_leaf, wl, bl, padding=3 * d, dilation=d,
                                    groups=C).transpose(1, 2), (C,), lw, lb, convnext.LN_EPS)
        library = lambda: torch.autograd.grad(  # noqa: E731
            out, (y_leaf, wl, bl, lw, lb), go, retain_graph=True)
        dy_lib = library()[0].transpose(1, 2)  # the pre-add's gradient, 0 at padding
        lib_err = max_err(dy_lib if mask is None else dy_lib.masked_fill(mask[:, :, None], 0),
                          ref[0])
        lib = device_ms(library)
        del out
        work = k10_backward_work(x, C)
        t_bound, by = bound(*work)
        print(f"    x{count}: {label}: kernel {ms:.4f} ms ({t_bound / ms:.0%} of its bound "
              f"{t_bound:.4f} ms, {by}), plain {plain:.4f} ms, the whole backward through "
              f"cuDNN (autograd of F.conv1d + F.layer_norm) {lib:.4f} ms (dx max_abs_err "
              f"{lib_err:.2e})")
        report.kernel("depthwise_conv7_norm_backward", err, ms * count, plain * count,
                      "a step's 20 launches, B=20 T=512 C=512", work[0] * count,
                      work[1] * count, library_ms=lib * count)
        by_d[d] = {"ms": ms, "plain_ms": plain, "cudnn_autograd_ms": lib, "bound_ms": t_bound,
                   "launches": count}
    entry = report.kernels["depthwise_conv7_norm_backward"]
    print(f"    a step's {sum(v['launches'] for v in by_d.values())} launches: kernel "
          f"{entry['ms']:.4f} ms (bound {entry['bound_ms']:.4f}), plain "
          f"{entry['plain_ms']:.4f} ms, cuDNN autograd {entry['library_ms']:.4f} ms")

    # one block forward and backward: K10's kernels (the MLP on cuBLAS)
    # against torch autograd of the plain block, at each dilation
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    block = {}
    for layer in model.diffusion.denoise_fn.residual_layers[:4]:
        args, _, _ = calls["depthwise_conv7_norm_backward"][layer.dilation]
        _, x, _, cond, mask, k = (a.detach() for a in args[:6])
        step = torch.randn((x.shape[0], x.shape[2]), generator=gen, device=DEVICE)
        g_out = torch.randn(x.shape, generator=gen, device=DEVICE)
        leaves = [t.clone().requires_grad_(True) for t in (x, step, cond, k)]

        def fwd_bwd():
            layer.zero_grad(set_to_none=True)
            for leaf in leaves:
                leaf.grad = None
            torch.autograd.backward(layer(*leaves, mask), g_out)
            # (the block's dwconv.weight and condition_projection take no part: k
            # and cond come in made)
            return [p.grad.clone() for p in layer.parameters() if p.grad is not None] + \
                [t.grad.clone() for t in leaves]

        got = fwd_bwd()
        ms = cuda_ms(fwd_bwd, iters=5)
        swap = {(convnext, "depthwise_conv7_norm"): convnext.depthwise_conv7_norm_reference}
        with plain_path(swap):
            ref = fwd_bwd()
            plain = cuda_ms(fwd_bwd, iters=5)
        worst = max(float((a - b).double().norm() / b.double().norm())
                    for a, b in zip(got, ref) if float(b.abs().max()) > 0)
        ok = worst <= 1e-4
        print(f"    one block forward + backward, d={layer.dilation}: K10's kernels {ms:.3f} ms, "
              f"torch autograd of the plain block {plain:.3f} ms; every gradient's relative "
              f"L2 {worst:.2e} (tol 1e-4) {'ok' if ok else 'FAIL'}")
        if not ok:
            report.failures.append(f"convnext_train block d={layer.dilation} vs plain")
        block[layer.dilation] = {"kernels_ms": ms, "plain_autograd_ms": plain,
                                 "grad_rel_l2_max": worst}
        layer.zero_grad(set_to_none=True)
    totals["convnext_train_k10_backward"] = by_d
    totals["convnext_train_block_fwd_bwd"] = block
    report.extra.setdefault("depthwise_conv7_norm_backward", {})["by_dilation"] = by_d
    report.extra["depthwise_conv7_norm_backward"]["block_fwd_bwd"] = block


def measure_training_split(report: Report, den, totals: dict, tag: str):
    """What a training step spends on its kernels' split weights: ``prepare``
    (once a forward, under grad) at the step's shapes, CUDA-event median,
    and of it the split kernel on the 40 weights (all transposed for the
    forward, W_out also as stored for the gate backward, from the same
    read) against ``tf32_split`` (``measure_weight_split``), beside the
    step's median."""
    import torch

    d_enc = den.residual_layers[0].conditioner_projection.conv.weight.shape[1]
    c = torch.zeros(DIFF_B, 512, d_enc, device=DEVICE)
    plan = den.prepare(c)
    n = len(den.residual_layers)
    ws = [w.detach() for w in plan["w_conv"] + plan["w_out"]]
    split = measure_weight_split(report, ws, [True] * (2 * n), [False] * n + [True] * n,
                                 "a training step's")
    prepare_ms = cuda_ms(lambda: den.prepare(c))
    step_ms = totals[f"{tag}_step_s_median"] * 1e3
    print(f"[{tag}] prepare in a training step ({n} blocks, B={DIFF_B} T=512): "
          f"{prepare_ms:.3f} ms, of which the split of the {len(ws)} weights (W_out in both "
          f"layouts) {split['ms']:.4f} ms of device time ({split['ms'] / step_ms:.2%} of the step's "
          f"median {step_ms:.2f} ms; tf32_split {split['plain_ms']:.4f} ms)")
    report.extra.setdefault("wavenet_weight_split", {})["train"] = split
    totals[f"{tag}_prepare_ms"], totals[f"{tag}_split"] = prepare_ms, split


def measure_k1_gate_backward(report: Report, call):
    """K1's gate backward (``wavenet_gate_backward``, 3xTF32 wgmma) at the
    step's recorded inputs (B=20 x 512 x 512; one call stands for the step's
    20: the shapes are the same at every dilation): within 1e-4 of the
    plain version's scale, a rerun bit-equal, its largest error against the
    float64 function no larger than the plain float32 version's (cuBLAS);
    CUDA-event times of kernel and plain and of the product alone
    (``torch.mm``, TF32 off; no one call computes dz, so ``library_ms``
    stays null) beside the bound at ``TF32X3_FLOP_PER_S`` and the float32
    SIMT bound, and the plan the rule picks."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.models import wavenet

    (dx_out, dskip_out, z, w_out, w_split), _, count = call
    dx_out, dskip_out, z, w_out, w_split = (a.detach() for a in (dx_out, dskip_out, z, w_out,
                                                                  w_split))
    B_, T_, R_ = dx_out.shape
    M = B_ * T_
    with torch.no_grad():
        fn = lambda: wavenet.residual_gate_backward(  # noqa: E731
            dx_out, dskip_out, z, w_out, w_split)
        ref_fn = lambda: wavenet.residual_gate_backward_reference(  # noqa: E731
            dx_out, dskip_out, z, w_out)
        got, ref = fn(), ref_fn()
        err = report.compare("wavenet_gate_backward", got, ref, 1e-4 * max_abs(ref))
        check_rerun(report, "wavenet_gate_backward", got, fn())
        ref64 = wavenet.residual_gate_backward_reference(
            *(t.double() for t in (dx_out, dskip_out, z, w_out)))
        errs = dict(kernel=max_err(got.double(), ref64) / max_abs(ref64),
                    plain=max_err(ref.double(), ref64) / max_abs(ref64))
        ok = errs["kernel"] <= errs["plain"]
        print(f"    wavenet_gate_backward: largest error / scale against float64: kernel "
              f"{errs['kernel']:.3e} (plain float32 {errs['plain']:.3e}) "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            report.failures.append("wavenet_gate_backward: error against float64 above the "
                                   "plain float32 version's")
        del ref64
        do = torch.cat([dx_out * 2 ** -0.5, dskip_out], dim=-1).reshape(M, 2 * R_)
        w_t = w_out.t()
        ms, plain, product = timed_triple(fn, ref_fn, lambda: torch.mm(do, w_t))
    flops = 2 * M * 2 * R_ * R_
    work = (nbytes(dx_out, dskip_out, z, w_out, got), flops)
    t_bound, t_simt = bound(*work, TF32X3_FLOP_PER_S)[0], bound(*work)[0]
    plan = kernels.load_library("wavenet_block").wavenet_gate_backward_plan(B_, T_, R_)
    tiles = {1: "64 x 64", 2: "128 x 128", 3: "128 x 64"}[plan]
    print(f"    wavenet_gate_backward x{count}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
          f"TFLOP/s, {t_bound / ms:.0%} of its 3xTF32 bound {t_bound:.4f}, {t_simt / ms:.0%} "
          f"of the float32 SIMT bound {t_simt:.4f}) in the plan the rule picks at M = {M}, "
          f"{plan} ({tiles} tiles); plain {plain:.4f} ms, torch.mm (the product alone, TF32 "
          f"off) {product:.4f} ms")
    report.kernel("wavenet_gate_backward", err, ms * count, plain * count,
                  "a step's 20 launches, B=20 T=512 R=512", work[0] * count, flops * count,
                  rate=TF32X3_FLOP_PER_S)
    report.extra.setdefault("wavenet_gate_backward", {}).update(
        library_product_ms=product * count, library_product="torch.mm, the product alone",
        bound_f32_simt_ms=t_simt * count, f64_errors=errs, plan=plan)


def measure_k1_training(report: Report, calls: dict, totals: dict):
    """K1's training kernels at the step's recorded inputs (B=20 x 512 x
    512), for each dilation: within 1e-4 of the plain version's scale, a
    rerun bit-equal, CUDA-event times of kernel and plain beside the bound,
    summed over a step's launches (5 blocks a dilation). The input backward
    and the weight gradients (3xTF32 on the tensor cores) are bound at
    ``TF32X3_FLOP_PER_S`` with the float32 SIMT bound beside, and timed
    beside cuDNN (``conv1d_input`` for dy; ``conv1d_weight`` at K = 3 and at
    K = 1) and, for the weight gradients, beside ``conv1d_wgrad`` on the
    same shapes (the route they took before). Then one block's forward and
    backward through the kernels against torch autograd of the plain block
    (the cuBLAS composition; no one PyTorch call computes it)."""
    import torch

    from fish_diffusion_tpu_torch.models import wavenet

    import torch.nn.functional as F

    print("[diffusion_train] K1's training kernels at the step's inputs (B=20 T=512 R=512)")
    per_block, gt = {}, {}
    for d, (args, _, count) in sorted(calls["residual_gate_train"].items()):
        x, step, cond, w_conv, b_conv, _, w_split = (a.detach() if torch.is_tensor(a) else a
                                                     for a in args)
        B_, T_, R_ = x.shape
        M = B_ * T_
        with torch.no_grad():
            fn = lambda: wavenet.residual_gate_train(  # noqa: E731
                x, step, cond, w_conv, b_conv, d, w_split)
            ref_fn = lambda: wavenet.residual_gate_train_reference(  # noqa: E731
                x, step, cond, w_conv, b_conv, d)
            (g, z), (ref_g, ref_z) = fn(), ref_fn()
            label = f"wavenet_gate_train d={d}"
            err = max(report.compare(f"{label} g", g, ref_g, 1e-4 * max_abs(ref_g)),
                      report.compare(f"{label} z", z, ref_z, 1e-4 * max_abs(ref_z)))
            again = fn()
            check_rerun(report, label, torch.cat([g.flatten(), z.flatten()]),
                        torch.cat([again[0].flatten(), again[1].flatten()]))
            if not torch.equal(g, wavenet.residual_gate(x, step, cond, w_conv, b_conv, d,
                                                        w_split)):
                print(f"  {label}: serving's wavenet_gate gives other bits FAIL")
                report.failures.append(f"{label}: serving's g")
            ms, plain, _ = timed_triple(fn, ref_fn)
            y_t = (x + step[:, None, :]).transpose(1, 2).contiguous()
            w_t = w_conv.reshape(3, R_, 2 * R_).permute(2, 1, 0).contiguous()
            product = cuda_ms(lambda: F.conv1d(y_t, w_t, padding=d, dilation=d))
        flops = 2 * M * 3 * R_ * 2 * R_
        work = (nbytes(x, step, cond, w_conv, b_conv, g, z), flops)
        t_bound, t_simt = bound(*work, TF32X3_FLOP_PER_S)[0], bound(*work)[0]
        print(f"    x{count}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{t_bound / ms:.0%} of its 3xTF32 bound {t_bound:.4f}, {t_simt / ms:.0%} of the "
              f"float32 SIMT bound {t_simt:.4f}), plain {plain:.4f} ms, F.conv1d (the dilated "
              f"product alone, TF32 off) {product:.4f} ms")
        report.kernel("wavenet_gate_train", err, ms * count, plain * count,
                      "a step's 20 launches, B=20 T=512 R=512", work[0] * count, flops * count,
                      rate=TF32X3_FLOP_PER_S)
        gt[d] = dict(count=count, ms=ms, plain_ms=plain, product_ms=product,
                     bound_ms=t_bound, bound_f32_simt_ms=t_simt)
        per_block[d] = (x, step, cond, w_conv, b_conv)
    report.extra.setdefault("wavenet_gate_train", {}).update(
        by_dilation=gt,
        library_product_ms=sum(v["product_ms"] * v["count"] for v in gt.values()),
        library_product="F.conv1d, the dilated product alone",
        bound_f32_simt_ms=sum(v["bound_f32_simt_ms"] * v["count"] for v in gt.values()))

    # the output product at the step's shapes (its row is the batch request's)
    (g_, x_, skip_, w_out_, b_out_, os_), _, count = calls["residual_out"][0]
    g_, x_, skip_, w_out_, b_out_, os_ = (a.detach() for a in (g_, x_, skip_, w_out_, b_out_,
                                                                 os_))
    with torch.no_grad():
        fn = lambda: wavenet.residual_out(g_, x_, skip_, w_out_, b_out_, os_)  # noqa: E731
        got = fn()
        ref = wavenet.residual_out_reference(g_, x_, skip_, w_out_, b_out_)
        report.compare("wavenet_out (training shapes)", got, ref, 1e-4 * max_abs(ref))
        check_rerun(report, "wavenet_out (training shapes)", torch.cat(got), torch.cat(fn()))
        ms = cuda_ms(fn)
        product = cuda_ms(lambda: torch.addmm(b_out_, g_.reshape(-1, g_.shape[-1]), w_out_))
    print(f"    wavenet_out x{count}: kernel {ms:.4f} ms, torch.addmm (the product alone, TF32 "
          f"off) {product:.4f} ms")
    report.extra.setdefault("wavenet_out", {})["train"] = dict(
        count=count, ms=ms, product_ms=product)

    measure_k1_gate_backward(report, calls["residual_gate_backward"][0])
    (dx_out, dskip_out, _, w_out, _), _, _ = calls["residual_gate_backward"][0]
    dx_out, dskip_out, w_out = (a.detach() for a in (dx_out, dskip_out, w_out))

    # the input backward and the weight gradients: 3xTF32 on the tensor
    # cores, their bound at TF32X3_FLOP_PER_S (the float32 SIMT bound beside)
    ib = {}
    for d, (args, _, count) in sorted(calls["residual_input_backward"].items()):
        dz, dxo, w_conv, _ = (a.detach() if torch.is_tensor(a) else a for a in args)
        B_, T_ = dxo.shape[:2]
        with torch.no_grad():
            fn = lambda: wavenet.residual_input_backward(dz, dxo, w_conv, d)  # noqa: E731
            ref_fn = lambda: wavenet.residual_input_backward_reference(  # noqa: E731
                dz, dxo, w_conv, d)
            (dx, ds), (ref_dx, ref_ds) = fn(), ref_fn()
            label = f"wavenet_input_backward d={d}"
            err = max(report.compare(f"{label} dx", dx, ref_dx, 1e-4 * max_abs(ref_dx)),
                      report.compare(f"{label} ds", ds, ref_ds, 1e-4 * max_abs(ref_ds)))
            again = fn()
            check_rerun(report, label, torch.cat([dx.flatten(), ds.flatten()]),
                        torch.cat([again[0].flatten(), again[1].flatten()]))
            # cuDNN's dy alone: the conv's input gradient, [B, R, T] layout
            dz_t = dz.transpose(1, 2).contiguous()
            w_t = w_conv.reshape(3, R_, 2 * R_).permute(2, 1, 0).contiguous()
            lib_fn = lambda: torch.nn.grad.conv1d_input(  # noqa: E731
                (B_, R_, T_), w_t, dz_t, padding=d, dilation=d)
            lib_err = max_err(lib_fn().transpose(1, 2), ref_dx - dxo * (2 ** -0.5))
            ms, plain, lib = timed_triple(fn, ref_fn, lib_fn)
        flops = 2 * M * 6 * R_ * R_
        work = (nbytes(dz, dxo, w_conv, dx, ds), flops)
        t_bound = bound(*work, TF32X3_FLOP_PER_S)[0]
        t_f32 = bound(*work)[0]
        print(f"    x{count}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{t_bound / ms:.0%} of its 3xTF32 bound {t_bound:.4f}, {t_f32 / ms:.0%} of the "
              f"float32 SIMT bound {t_f32:.4f}), plain {plain:.4f} ms, cuDNN conv1d_input "
              f"(dy alone) {lib:.4f} ms (dy max_abs_err {lib_err:.2e})")
        report.kernel("wavenet_input_backward", err, ms * count, plain * count,
                      "a step's 20 launches, B=20 T=512 R=512", work[0] * count, flops * count,
                      library_ms=lib * count, rate=TF32X3_FLOP_PER_S)
        ib[d] = dict(count=count, ms=ms, plain_ms=plain, library_ms=lib, bound_ms=t_bound,
                     bound_f32_simt_ms=t_f32, tflops=flops / ms / 1e9)
    report.extra.setdefault("wavenet_input_backward", {}).update(
        by_dilation=ib, bound_f32_simt_ms=sum(v["bound_f32_simt_ms"] * v["count"]
                                              for v in ib.values()))

    wg, wgrad_calls = {}, []
    for d, (args, _, count) in sorted(calls["residual_weight_grad"].items()):
        y, dz, g, dxo, dso, _ = (a.detach() if torch.is_tensor(a) else a for a in args)
        B_, T_ = y.shape[:2]
        with torch.no_grad():
            fn = lambda: wavenet.residual_weight_grad(y, dz, g, dxo, dso, d)  # noqa: E731
            ref_fn = lambda: wavenet.residual_weight_grad_reference(  # noqa: E731
                y, dz, g, dxo, dso, d)
            got, ref = fn(), ref_fn()
            label = f"wavenet_weight_grad d={d}"
            err = max(report.compare(f"{label} {name}", a, r, 1e-4 * max_abs(r))
                      for name, a, r in zip(("dW_conv", "dW_out"), got, ref))
            again = fn()
            check_rerun(report, label, torch.cat([a.flatten() for a in got]),
                        torch.cat([a.flatten() for a in again]))
            ms, plain, _ = timed_triple(fn, ref_fn)
            # cuDNN: conv1d_weight at K = 3 (dW_conv) and at K = 1 (dW_out)
            do = torch.cat([dxo * 2 ** -0.5, dso], dim=-1)
            y_t, dz_t = y.transpose(1, 2).contiguous(), dz.transpose(1, 2).contiguous()
            g_t, do_t = g.transpose(1, 2).contiguous(), do.transpose(1, 2).contiguous()
            lib3_fn = lambda: torch.nn.grad.conv1d_weight(  # noqa: E731
                y_t, (2 * R_, R_, 3), dz_t, padding=d, dilation=d)
            lib1_fn = lambda: torch.nn.grad.conv1d_weight(g_t, (2 * R_, R_, 1), do_t)  # noqa: E731
            lib_err = max(max_err(lib3_fn().permute(2, 1, 0).reshape(3 * R_, 2 * R_), ref[0]),
                          max_err(lib1_fn()[:, :, 0].t(), ref[1]))
            lib3, lib1 = cuda_ms(lib3_fn, iters=5), cuda_ms(lib1_fn, iters=5)
        flops3, flops1 = 2 * M * 3 * R_ * 2 * R_, 2 * M * R_ * 2 * R_
        flops = flops3 + flops1
        work = (nbytes(y, dz, g, dxo, dso, *got), flops)
        t_bound = bound(*work, TF32X3_FLOP_PER_S)[0]
        t_f32 = bound(*work)[0]
        print(f"    x{count}: {label}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
              f"{t_bound / ms:.0%} of its 3xTF32 bound {t_bound:.4f}, {t_f32 / ms:.0%} of the "
              f"float32 SIMT bound {t_f32:.4f}), plain {plain:.4f} ms, cuDNN conv1d_weight "
              f"{lib3 + lib1:.4f} ms: K = 3 {lib3:.4f} beside dW_conv's {flops3 / 1e9:.1f} "
              f"GFLOP, K = 1 {lib1:.4f} beside dW_out's {flops1 / 1e9:.1f} (max_abs_err "
              f"{lib_err:.2e})")
        report.kernel("wavenet_weight_grad", err, ms * count, plain * count,
                      "a step's 20 launches, B=20 T=512 R=512", work[0] * count, flops * count,
                      library_ms=(lib3 + lib1) * count, rate=TF32X3_FLOP_PER_S)
        wg[d] = dict(count=count, ms=ms, plain_ms=plain, library_k3_ms=lib3,
                     library_k1_ms=lib1, bound_ms=t_bound, bound_f32_simt_ms=t_f32,
                     tflops=flops / ms / 1e9)
        # the route it replaces: conv1d_wgrad's two calls a block, (a, bm,
        # K, stride, dilation, padding)
        wgrad_calls += [((y, dz, 3, 1, d, d), {})] * count + [((g, do, 1, 1, 1, 0), {})] * count
    old = measure_wgrad_calls(report, wgrad_calls, "diffusion_train (K1 shapes)")
    new_ms = sum(v["ms"] * v["count"] for v in wg.values())
    faster = new_ms < old["ms"]
    print(f"  K1's weight gradients over a step: wavenet_weight_grad {new_ms:.4f} ms against "
          f"conv1d_wgrad's {old['ms']:.4f} ms on the same shapes (cuDNN conv1d_weight "
          f"{old['library_ms']:.4f}) {'ok' if faster else 'SLOWER'}")
    report.extra.setdefault("wavenet_weight_grad", {}).update(
        by_dilation=wg, bound_f32_simt_ms=sum(v["bound_f32_simt_ms"] * v["count"]
                                              for v in wg.values()),
        conv1d_wgrad_same_shapes=old)
    totals["diffusion_train_k1_dw"] = dict(wavenet_weight_grad_ms=new_ms,
                                           conv1d_wgrad_ms=old["ms"],
                                           cudnn_ms=old["library_ms"])

    # one block forward and backward: K1's kernels against torch autograd of
    # the plain block, at each dilation
    block = {}
    for d, (x, step, cond, w_conv, b_conv) in per_block.items():
        skip = torch.zeros_like(x)
        b_out = torch.zeros(2 * R_, device=x.device)
        leaves = [t.clone().requires_grad_(True) for t in (x, skip, step, cond, w_conv, b_conv,
                                                            w_out, b_out)]

        def fwd_bwd(fn):
            def run():
                for leaf in leaves:
                    leaf.grad = None
                torch.autograd.backward(fn(*leaves, d), (dx_out, dskip_out))
            return run

        ms = cuda_ms(fwd_bwd(wavenet.ResidualBlockFunction.apply), iters=5)
        plain = cuda_ms(fwd_bwd(wavenet.residual_block_reference), iters=5)
        block[d] = {"kernels_ms": ms, "plain_autograd_ms": plain}
        print(f"    one block forward + backward, d={d}: K1's kernels {ms:.3f} ms, torch "
              f"autograd of the plain block (cuBLAS) {plain:.3f} ms")
    totals["diffusion_train_block_fwd_bwd"] = block
    report.extra.setdefault("wavenet_gate_backward", {})["block_fwd_bwd"] = block


def phase_align(report: Report, seed: int):
    """The sixth slice's alignment op: K7 at GlowTTS/VITS alignment shapes
    (B=32, T_y 1000 mel frames, T_x 200 text positions, lengths drawn per
    item: t_y 500-1000, t_x 100-200, t_x <= t_y), once on random values and
    once on integer values (ties), paths bit-equal to the plain version and
    valid; kernel and plain times."""
    import torch

    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.ops import monotonic_align as ma

    gen = torch.Generator(device=DEVICE).manual_seed(seed + 61)
    B_, T_y, T_x = 32, 1000, 200
    t_ys = torch.randint(500, T_y + 1, (B_,), generator=gen, device=DEVICE)
    t_xs = torch.minimum(torch.randint(100, T_x + 1, (B_,), generator=gen, device=DEVICE),
                         t_ys)
    cases = {"random": torch.randn((B_, T_y, T_x), generator=gen, device=DEVICE) * 3,
             "ties": torch.randint(0, 3, (B_, T_y, T_x), generator=gen,
                                   device=DEVICE).float()}
    label = f"B={B_} T_y={T_y} T_x={T_x}"
    print(f"[align] K7 maximum_path, {label}, t_y {int(t_ys.min())}-{int(t_ys.max())}, "
          f"t_x {int(t_xs.min())}-{int(t_xs.max())}")
    kernels.reset_launches()
    paths = {k: ma.maximum_path(v, t_ys, t_xs) for k, v in cases.items()}
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if launches["maximum_path"] != len(cases):
        report.failures.append(f"maximum_path launched {launches['maximum_path']} times")
    err = 0.0
    for kind, values in cases.items():
        got = paths[kind]
        err = max(err, report.compare(f"maximum_path {kind} {label} (identical)", got,
                                      ma.maximum_path_reference(values, t_ys, t_xs), 0.0))
        rows = got.sum(dim=2)
        valid = all(
            int(rows[b, : t_ys[b]].min()) == 1 and int(rows[b].sum()) == int(t_ys[b])
            and int(got[b, 0, 0]) == 1 and int(got[b, t_ys[b] - 1, t_xs[b] - 1]) == 1
            for b in range(B_))
        print(f"  {kind}: every path monotonic from (0, 0) to (t_y - 1, t_x - 1), one "
              f"position a frame: {'ok' if valid else 'FAIL'}")
        if not valid:
            report.failures.append(f"maximum_path {kind}: invalid path")
    values = cases["random"]
    ms, plain, _ = timed_triple(lambda: ma.maximum_path(values, t_ys, t_xs),
                                lambda: ma.maximum_path_reference(values, t_ys, t_xs), iters=3)
    # what the op must move: each item's t_y rows of values read once, the
    # whole path written once; per cell an add, a max and a compare
    cells = int((t_ys * T_x).sum())
    work = (4 * cells + nbytes(paths["random"], t_ys, t_xs), 3 * cells)
    t_bound, by = bound(*work)
    print(f"    kernel {ms:.4f} ms ({ms * 1e3 / T_y:.3f} us per frame of the longest chain), "
          f"plain {plain:.4f} ms, bound {t_bound:.5f} ms ({by}; the real limit is the "
          f"chain of t_y dependent rows, then t_y backtrack steps)")
    report.kernel("maximum_path", err, ms, plain, f"{label}, random values", *work)
    report.finish("align")
    return launches


def tensor_core_products(kernels):
    """The SASS of K1's 3xTF32 kernels (``cuobjdump -sass`` of the built
    ``wavenet_block`` library): the input backward's and the weight
    gradients' TF32 ``mma.sync`` products (HMMA.1688.F32.TF32, three per
    m16n8k8 step) and the forward's and the gate backward's TF32 ``wgmma``
    products (HGMMA ... .TF32, three per k8 step) printed per kernel; a
    kernel with none, or a count of kernels other than the two ``mma.sync``
    ones, six forward and three gate backward instances, is a failure.
    Where the toolkit has no cuobjdump: not measured."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    if not cuobjdump.exists():
        print("[build] cuobjdump not found: tensor-core products not measured")
        return
    sass = subprocess.run([str(cuobjdump), "-sass", str(kernels._library_path("wavenet_block"))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if ("k1x3" in fn and "_sum" not in fn) or ("k1f" in fn and "_kernel" in fn):
                counts[fn] = 0
        elif fn in counts and ("HMMA.1688.F32.TF32" in line if "k1x3" in fn else
                               "HGMMA." in line and ".TF32" in line):
            counts[fn] += 1
    for fn, n in counts.items():
        kind = "HMMA.1688.F32.TF32" if "k1x3" in fn else "HGMMA (TF32)"
        print(f"[build] wavenet_block {fn}: {n} {kind} in its SASS")
    n_sync = sum("k1x3" in fn for fn in counts)
    n_gate_bwd = sum("gate_bwd_kernel" in fn for fn in counts)
    if (n_sync != 2 or n_gate_bwd != 3 or len(counts) - n_sync - n_gate_bwd != 6
            or not all(counts.values())):
        raise SystemExit("chip_smoke: K1's 3xTF32 kernels hold no tensor-core products")


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
    tensor_core_products(kernels)

    report = Report()
    wall = {}

    def timed_phase(name, fn, *fn_args):
        t_phase = time.perf_counter()
        out = fn(report, *fn_args)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - t_phase
        print(f"[time] phase {name}: {wall[name]:.1f} s")
        return out

    totals = timed_phase("kernels", phase_kernels, args.seed)
    timed_phase("kernels K5 K8", phase_kernels_stft_viterbi, args.seed)
    engine = timed_phase("serve", phase_serve, args.seed)
    launches = timed_phase("file", phase_file_to_file, engine, args.seed)
    pitch_launches = timed_phase("pitch", phase_pitch, engine, args.seed)
    istft_launches = timed_phase("istft_net", phase_istft_net, engine, args.seed)
    del engine
    torch.cuda.empty_cache()
    convnext_launches, totals["convnext"] = timed_phase("convnext", phase_convnext, args.seed)
    torch.cuda.empty_cache()
    diff_launches, diff_train = timed_phase("diffusion_train", phase_diffusion_train,
                                            args.seed)
    totals.update(diff_train)
    torch.cuda.empty_cache()
    cn_train_launches, cn_train = timed_phase("convnext_train", phase_convnext_train,
                                              args.seed)
    totals.update(cn_train)
    torch.cuda.empty_cache()
    train_launches, train = timed_phase("train", phase_train, args.seed)
    totals.update(train)
    torch.cuda.empty_cache()
    v2_launches, train_v2 = timed_phase("train_v2", phase_train_v2, args.seed)
    totals.update(train_v2)
    torch.cuda.empty_cache()
    sine_launches, train_sine = timed_phase("train_sine", phase_train_sine, args.seed)
    totals.update(train_sine)
    align_launches = timed_phase("align", phase_align, args.seed)
    totals["phase_wall_s"] = wall

    by_path = {"file": launches, "pitch": pitch_launches, "istft_net": istft_launches,
               "convnext": convnext_launches, "train": train_launches,
               "train_v2": v2_launches, "train_sine": sine_launches,
               "diffusion_train": diff_launches, "convnext_train": cn_train_launches,
               "align": align_launches}
    entries = []
    for name, meta in kernels.KERNELS.items():
        k = report.kernels[name]
        # a kernel's launches on the first path that runs it: the
        # file-to-file path for the serving kernels, the pitch path for K8
        # dense, the iSTFTNet path for K5 istft, the ConvNeXt path for K10,
        # the vocoder training runs
        # (NSF-HiFiGAN, RefineGAN comb, RefineGAN sine), the diffusion
        # training for K1's training kernels, the ConvNeXt training for
        # K10's backward, then alignment for K7
        path = next((p for p, counts in by_path.items() if counts[name]), None)
        if path is None:
            raise SystemExit(f"chip_smoke: {name} was launched on no path")
        entries.append(dict(
            name=f"{meta['id']} {name}", route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=by_path[path][name],
            launches_by_path={p: counts[name] for p, counts in by_path.items()},
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
