#!/usr/bin/env python3
"""Drive the PyTorch port's SVC serving path once on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. device:  require CUDA, print the card's name and power limit, turn TF32
            off for every comparison.
2. build:   compile the CUDA sources in ``fish_diffusion_tpu_torch/csrc``.
3. kernels: every hand-written kernel against its plain PyTorch version at
            the shapes of the main path (B=4 x 1024 frames), with median
            CUDA-event times of both; then the whole 20-block denoiser eval
            and the whole vocoder against their plain compositions.
4. serve:   ``SVCInference`` built from ``configs/svc_hubert_soft.py`` at
            full width (HubertSoft 12x768, WaveNet 20x512, NSF-HiFiGAN 512,
            100 UniPC evals) with seeded random weights answers three
            requests; every kernel's launch count must grow; a short request
            is checked against the plain composition.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
SR, HOP, MEL = 44100, 512, 128
B, T, R = 4, 1024, 512


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``iters`` CUDA-event timed runs."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


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

    def compare(self, label, got, ref, tol, relative=False):
        err = max_err(got, ref)
        bound = tol * max(1.0, max_abs(ref)) if relative else tol
        ok = err <= bound and np.isfinite(err)
        print(f"  {label}: max_abs_err={err:.3e} tol={bound:.3e}"
              f"{' (relative)' if relative else ''} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(label)
        return err

    def kernel(self, name, err, ms, plain_ms, shape):
        entry = self.kernels.setdefault(
            name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, shape=shape)
        )
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        entry["ms"] += ms
        entry["plain_ms"] += plain_ms

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
        for name, (ms, plain) in times.items():
            flops = 2 * B * T * (3 * R if name == "wavenet_gate" else R) * 2 * R
            print(f"  {name} {tag}: kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} "
                  f"TFLOP/s), plain {plain:.4f} ms")
            if dtype == torch.float32:
                report.kernel(name, 0.0, ms, plain, "one block, B=4 T=1024 R=512 f32")

    print("[kernels] K2 UniPC step, [4, 1024, 128] f32")
    table = diffusion.unipc_step_table(
        diffusion.ScheduleCoefficients(np.linspace(1e-4, 0.01, 1000)), 100
    )
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
    for name, fn, ref, args in (
        ("unipc_predict", diffusion.unipc_predict,
         diffusion.unipc_predict_reference, pred),
        ("unipc_correct", diffusion.unipc_correct,
         diffusion.unipc_correct_reference, corr),
    ):
        err = report.compare(name, fn(*args), ref(*args), 1e-5, relative=True)
        ms, plain = cuda_ms(lambda: fn(*args)), cuda_ms(lambda: ref(*args))
        print(f"  {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms")
        report.kernel(name, err, ms, plain, "one step, [4, 1024, 128] f32")

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
    report.kernel("nsf_phase_base", err, ms, plain, "B=4 T=1024")
    margs = (f0, base_ref, rand_ini, noise, weight, bias, SR, HOP)
    err = report.compare("nsf_merge", source.nsf_merge(*margs),
                         source.nsf_merge_reference(*margs), 1e-4)
    ms = cuda_ms(lambda: source.nsf_merge(*margs))
    plain = cuda_ms(lambda: source.nsf_merge_reference(*margs))
    print(f"  nsf_merge: kernel {ms:.4f} ms, plain {plain:.4f} ms")
    report.kernel("nsf_merge", err, ms, plain, "B=4 T=1024 hop=512")

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
        for (name, xs, ws, *_), (x, (args, kwargs), count) in calls.items():
            got = real[name](x, *args, **kwargs)
            ref = refs[name](x, *args, **kwargs)
            err = report.compare(f"{name} x{list(xs)} w{list(ws)} {kwargs_str(kwargs)}",
                                 got, ref, 1e-4, relative=True)
            ms = cuda_ms(lambda: real[name](x, *args, **kwargs), iters=5)
            plain = cuda_ms(lambda: refs[name](x, *args, **kwargs), iters=5)
            print(f"    x{count} per pass: kernel {ms:.4f} ms, plain {plain:.4f} ms")
            report.kernel(name, err, ms * count, plain * count,
                          "sum over one vocoder pass, B=4 x 1024 frames")
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
    expected = {"wavenet_gate": layers * evals, "wavenet_out": layers * evals,
                "unipc_predict": evals, "unipc_correct": evals, **per_vocoder}

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
              f"{max(float(np.abs(o).max()) for o in outs):.3f}, launches {grew} "
              f"{'ok' if ok else 'FAIL'}")
        if not ok:
            report.failures.append(label)
    launches = dict(kernels.LAUNCHES)
    print(f"[serve] launches over the three requests: {launches}")
    for name, n in launches.items():
        if n <= 0:
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
    print(f"[build] CUDA sources built in {time.perf_counter() - t0:.1f} s")
    for name, log in kernels.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    report = Report()
    totals = phase_kernels(report, args.seed)
    launches = phase_serve(report, args.seed)

    entries = []
    for name, meta in kernels.KERNELS.items():
        k = report.kernels[name]
        entries.append(dict(
            name=f"{meta['id']} {name}", route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
            shape=k["shape"],
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
