"""The whole training step's gradient difference, kernels vs plain, at many
states: what `chip_smoke.py`'s whole-step gate reads, and where it comes
from.

Trains RefineGAN with the sine template (`configs/vocoder_refinegan.py`,
`template_generator="sine"`, full width, float32, the synthetic dataset of
`chip_smoke.py`) for 6 steps, then, for each trial (a batch and a draw of
the generator's noise), runs one step from the same state:

- through every plain version (P), K5's computed exactly as the kernels
  compute a training step's (`chip_smoke.plain_stft_magnitude`: float64
  forward and backward), and again with the float32 basis product and its
  own float32 gradient, the JAX package's precision (P32);
- through the kernels (K), and again with K5's forward in float32 where
  training asks for it exact (Kf32);
- plain and through the kernels on the audio times 1 + d for each d of
  `chip_smoke.FLOOR_SCALES` (the floor: plain vs P; the pairs: kernels vs
  plain on the same audio);
- through the plain versions but one kernel (only-X), for each kernel.

Each number is the generator's largest gradient error of its max |grad|
over its tensors (`chip_smoke.drive_training`'s measure). Each trial
prints one line with the gate both ways: the single unscaled pair, and the
median of the six pairs, against max(1e-3, 3 x the largest floor move).

    python3 chip_step_noise.py --trials 24 [--seed 5]

`--seed` picks the dataset and the fit, so the state (`chip_smoke.py`
trains from seed 0).

Needs one CUDA card; builds the kernels as `chip_smoke.py` does.
"""

import argparse
import copy
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trials", type=int, default=24)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_step_noise: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from fish_diffusion_tpu_torch import kernels
    from fish_diffusion_tpu_torch.config import Config
    from fish_diffusion_tpu_torch.models.vocoders import nsf_hifigan, source
    from fish_diffusion_tpu_torch.ops import blocked_conv, mel
    from fish_diffusion_tpu_torch.training import vocoder_cli
    from fish_diffusion_tpu_torch.training.vocoder_trainer import VocoderTrainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    swaps = {
        "conv1d": ((nsf_hifigan, "conv1d"), nsf_hifigan.conv1d_reference),
        "sine": ((source, "sine_template"), source.sine_template_reference),
        "stft": ((mel, "stft_magnitude"), cs.plain_stft_magnitude),
        "conv2d": ((blocked_conv, "conv2d_nhwc"), blocked_conv.conv2d_nhwc_reference),
    }
    plain = dict(swaps.values())
    plain32 = {**plain, (mel, "stft_magnitude"):
               lambda y, n_fft, hop, win=None, exact=False:
               mel.stft_magnitude_reference(y, n_fft, hop, win)}
    stft_kernel = mel.stft_magnitude
    kernels32 = {(mel, "stft_magnitude"):
                 lambda y, n_fft, hop, win=None, exact=False: stft_kernel(y, n_fft, hop, win)}

    rng = np.random.default_rng(args.seed + 40)
    np.random.seed(args.seed + 41)
    tmp = Path(tempfile.mkdtemp(prefix="chip_step_noise_"))
    cs.make_vocoder_dataset(rng, tmp / "data")
    cfg = Config.fromfile(root / "configs" / "vocoder_refinegan.py")
    cfg.model.generator.update(template_generator="sine")
    cfg.trainer["precision"] = "32-true"
    cfg.trainer["discriminator_dtype"] = "float32"
    cfg.dataset.train["path"] = str(tmp / "data" / "train")
    loader = vocoder_cli.build_loader(cfg.dataset.train,
                                      {**cfg.dataloader.train, "num_workers": 0})
    trainer = VocoderTrainer(cfg, log_dir=str(tmp / "logs"), steps_per_epoch=len(loader),
                             device="cuda")
    step_fn = trainer._train_step
    state = trainer.fit(loader, max_steps=6, valid_every=10 ** 9, log_every=10 ** 9,
                        save_every=10 ** 9, seed=args.seed)
    batches = [trainer._to_device(b) for b, _ in zip(loader, range(2))]
    snap = copy.deepcopy({"g": state.params_g.state_dict(), "d": state.params_d.state_dict(),
                          "s": state.spectral_d, "og": state.opt_state_g.state_dict(),
                          "od": state.opt_state_d.state_dict(), "step": state.step})

    def restore():
        state.params_g.load_state_dict(snap["g"])
        state.params_d.load_state_dict(snap["d"])
        state.spectral_d = {k: v.clone() for k, v in snap["s"].items()}
        state.opt_state_g.load_state_dict(copy.deepcopy(snap["og"]))
        state.opt_state_d.load_state_dict(copy.deepcopy(snap["od"]))
        state.step = snap["step"]

    def worst(got, ref):
        rel = {k: float((got[k] - ref[k]).abs().max()) / max(float(ref[k].abs().max()), 1e-30)
               for k in ref}
        k = max(rel, key=rel.get)
        return k, rel[k]

    t0 = time.perf_counter()
    for trial in range(args.trials):
        batch = batches[trial % len(batches)]
        draws = trainer.draw(batch, torch.Generator(device="cuda").manual_seed(
            args.seed + 99 + trial))

        def step(fns, scale=1.0):
            """The generator's gradients of one step from the snapshot."""
            restore()
            with cs.plain_path(fns):
                step_fn(state, {**batch, "audio": batch["audio"] * scale}, draws)
            return {k: p.grad.detach().clone() for k, p in state.params_g.named_parameters()}

        P, K, P32 = step(plain), step({}), step(plain32)
        k0, k32, p32 = worst(K, P), worst(K, P32), worst(P32, P)
        kf32 = worst(step(kernels32), P)[1]
        del K, P32
        floors, pairs = [], []
        for d in cs.FLOOR_SCALES:
            Q = step(plain, 1.0 + d)
            floors.append(worst(Q, P)[1])
            pairs.append(worst(step({}, 1.0 + d), Q)[1])
            del Q
        only = {name: worst(step({k: v for k, v in plain.items() if k != key}), P)[1]
                for name, (key, _) in swaps.items()}
        tol = max(1e-3, 3 * max(floors))
        med = float(np.median([k0[1]] + pairs))
        print(f"trial {trial}: K {k0[1]:.3e} ({k0[0]}) K-vs-P32 {k32[1]:.3e} P32-vs-P "
              f"{p32[1]:.3e} Kf32 {kf32:.3e} floors " + " ".join(f"{x:.2e}" for x in floors)
              + " pairs " + " ".join(f"{x:.2e}" for x in pairs)
              + f" | tol {tol:.3e} single {'FAIL' if k0[1] > tol else 'ok'} median "
              f"{med:.3e} {'FAIL' if med > tol else 'ok'} | "
              + " ".join(f"only-{n} {e:.2e}" for n, e in only.items())
              + f" | {time.perf_counter() - t0:.0f} s", flush=True)
    restore()
    return 0


if __name__ == "__main__":
    sys.exit(main())
