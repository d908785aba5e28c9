"""Standalone vocoder trainer (``fish_diffusion_tpu/training/vocoder_trainer.py``):
NSF-HiFiGAN with the v1 GAN step, RefineGAN (generator type ``RefineGAN``
or ``RefineGANGenerator``) with the v2 step (``training/gan.py``), over
(audio, pitches) batches of ``NaiveVOCODERDataset``, with validation,
metrics and checkpoints.

Precision: this port trains in float32 throughout. It takes
``trainer.precision="32-true"`` and ``trainer.discriminator_dtype="float32"``
(the reference's "32-true" pin, both supported by the JAX package) and
raises on any other value; bf16 training is ROADMAP work.

The JAX trainer's device mesh and on-device batch cache are not carried
over: batches come from a ``torch.utils.data.DataLoader``, are pinned, and
are copied to the card one batch ahead of the step that uses them.
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models.vocoders.nsf_hifigan import NsfHifiGANGenerator
from ..models.vocoders.refinegan import RefineGANGenerator
from ..ops.mel import LogMelSpectrogram
from ..utils import init_random_, resolve_device
from .checkpoint import CheckpointManager
from .gan import Discriminators, GANTrainState, create_gan_state, make_gan_train_step
from .optim import build_optimizer
from .trainer import MetricsLogger

PRECISION = "32-true"
DISCRIMINATOR_DTYPE = "float32"


class VocoderTrainer:
    def __init__(self, config, log_dir: str = "logs/vocoder",
                 steps_per_epoch: Optional[int] = None, device="cuda"):
        self.config = config
        self.device = resolve_device(device)
        trainer_cfg = config.get("trainer") or {}
        precision = str(trainer_cfg.get("precision", ""))
        d_dtype = str(trainer_cfg.get("discriminator_dtype", ""))
        if precision != PRECISION or d_dtype != DISCRIMINATOR_DTYPE:
            raise NotImplementedError(
                f"trainer.precision={precision!r}, trainer.discriminator_dtype="
                f"{d_dtype!r}: the port trains in float32 only (set "
                f"{PRECISION!r} and {DISCRIMINATOR_DTYPE!r}); bf16 vocoder "
                "training is in ROADMAP.md")

        mc = config.model
        gen_cfg = dict(mc.get("generator", {}))
        gen_type = gen_cfg.pop("type", "NsfHifiGAN")
        if gen_type in ("RefineGAN", "RefineGANGenerator"):
            self.generator = RefineGANGenerator(**gen_cfg)
            flavor = "v2"
        elif gen_type in ("NsfHifiGAN", "NsfHifiGANGenerator"):
            self.generator = NsfHifiGANGenerator(**gen_cfg)
            flavor = "v1"
        else:
            raise NotImplementedError(f"generator {gen_type!r}: NSF-HiFiGAN and "
                                      "RefineGAN are ported")
        self.generator.to(self.device)
        self.sampling_rate = gen_cfg.get("sampling_rate", 44100)
        # the JAX trainer's rule: the generator's hop_size, else its hop_length
        self.hop_length = getattr(self.generator, "hop_size",
                                  getattr(self.generator, "hop_length", 512))
        # the STFTs of training run exact (float64; ops/mel.py stft_magnitude)
        self.mel_transform = LogMelSpectrogram(
            sample_rate=self.sampling_rate, hop_length=self.hop_length,
            n_mels=self.generator.num_mels, device=self.device, exact=True)
        self.discs = Discriminators(flavor, mpd_cfg=dict(mc.get("mpd", {})) or None,
                                    mrd_cfg=dict(mc.get("mrd", {})) or None)
        self.discs.to(self.device)

        # GAN schedulers decay per epoch: steps_per_epoch = len(train_loader)
        opt_cfg = dict(config.optimizer)
        sched_cfg = dict(config.scheduler) if config.get("scheduler") else None
        self.tx_g = build_optimizer(opt_cfg, sched_cfg, steps_per_epoch)
        self.tx_d = build_optimizer(opt_cfg, sched_cfg, steps_per_epoch)

        self.logger = MetricsLogger(log_dir)
        self.ckpt = CheckpointManager(Path(log_dir) / "checkpoints")
        scales = mc.get("multi_scale_mels", ((2048, self.hop_length, 2048),
                                             (2048, 270, 1080), (4096, 540, 2160)))
        self._train_step = make_gan_train_step(
            self.generator_apply, self.discs, sampling_rate=self.sampling_rate,
            multi_scale_mels=tuple(tuple(s) for s in scales))

    # -- the generator's inputs ------------------------------------------

    def draw(self, batch, generator: torch.Generator):
        """The generator's random inputs. NSF-HiFiGAN, in this order: the
        harmonics' initial phases rand_ini [B, 9] (column 0 is 0), then the
        noise [B, frames * hop, 9]. RefineGAN: the list of its noises in
        call order (``RefineGANGenerator.noise_shapes``)."""
        B = batch["audio"].shape[0]
        if isinstance(self.generator, RefineGANGenerator):
            frames = batch["audio"].shape[1] // self.hop_length
            return [torch.randn(s, generator=generator, device=self.device)
                    for s in self.generator.noise_shapes(B, frames)]
        dim = self.generator.m_source.dim
        rand_ini = torch.rand((B, dim), generator=generator, device=self.device)
        rand_ini[:, 0] = 0.0
        n = batch["audio"].shape[1] // self.hop_length * self.hop_length
        noise = torch.randn((B, n, dim), generator=generator, device=self.device)
        return rand_ini, noise

    def generator_apply(self, generator, batch, draws):
        """The mel of the ground truth (data: no gradient) and the frame f0
        -> audio [B, frames * hop]."""
        audio, pitches = batch["audio"], batch["pitches"]
        with torch.no_grad():
            mel = self.mel_transform.log_mel(audio).transpose(1, 2)
        f0 = pitches[:, :: self.hop_length][:, : mel.shape[1]].contiguous()
        if isinstance(generator, RefineGANGenerator):
            return generator(mel, f0, draws)
        rand_ini, noise = draws
        return generator(mel, f0, rand_ini, noise)

    # -- state -------------------------------------------------------------

    def init_state(self, seed: int = 42) -> GANTrainState:
        """Random weights from ``seed`` (NSF-HiFiGAN by ``init_random_``,
        RefineGAN and the discriminators as the JAX package draws them)."""
        if isinstance(self.generator, RefineGANGenerator):
            self.generator.init_weights(seed)
        else:
            init_random_(self.generator, seed)
        spectral = self.discs.init(seed + 7)
        return create_gan_state(self.generator, self.discs, self.tx_g, self.tx_d,
                                spectral)

    def _to_device(self, batch) -> dict:
        out = {}
        for key in ("audio", "pitches"):
            host = torch.as_tensor(np.asarray(batch[key], np.float32))
            host = host.reshape(host.shape[0], -1)
            if self.device.type == "cuda":
                host = host.pin_memory()
            out[key] = host.to(self.device, non_blocking=True)
        return out

    def _feed(self, batches):
        """Device batches, each copied while the step before it runs."""
        ahead = None
        for batch in batches:
            current, ahead = ahead, self._to_device(batch)
            if current is not None:
                yield current
        if ahead is not None:
            yield ahead

    # -- validation ----------------------------------------------------------

    @torch.no_grad()
    def _val_fn(self, generator, batch):
        gen = torch.Generator(device=self.device).manual_seed(0)
        y_hat = self.generator_apply(generator, batch, self.draw(batch, gen))
        audio = batch["audio"]
        n = min(audio.shape[1], y_hat.shape[1])
        mel_gt = self.mel_transform.log_mel(audio[:, :n])
        mel_hat = self.mel_transform.log_mel(y_hat[:, :n])
        return torch.mean(torch.abs(mel_gt - mel_hat)), y_hat[0, :n], audio[0, :n]

    def validate(self, state: GANTrainState, valid_loader, step: int) -> float:
        """Mel L1 over the valid set, and the first clip's ground truth and
        prediction as wav files."""
        losses = []
        for i, batch in enumerate(self._feed(valid_loader)):
            l1, y_hat0, audio0 = self._val_fn(state.params_g, batch)
            losses.append(float(l1))
            if i == 0:
                self.logger.log_audio(step, "val/gt", audio0.cpu().numpy(),
                                      self.sampling_rate)
                self.logger.log_audio(step, "val/pred", y_hat0.cpu().numpy(),
                                      self.sampling_rate)
        val = float(np.mean(losses)) if losses else float("nan")
        self.logger.log_scalars(step, {"valid_mel_l1": val})
        return val

    # -- the loop ------------------------------------------------------------

    def fit(self, train_loader, max_steps: Optional[int] = None, resume=False,
            valid_loader=None, valid_every: Optional[int] = None,
            log_every: int = 10, save_every: int = 5000, seed: int = 42):
        """Train until ``max_steps`` (default ``trainer.max_steps``), cycling
        over ``train_loader``'s epochs; validate every ``valid_every`` steps
        and at the last, save every ``save_every`` and at the last. Returns
        the state, or None for an empty loader."""
        max_steps = max_steps or self.config.trainer.get("max_steps", 1_000_000)
        valid_every = valid_every or save_every

        def host_batches():
            while True:
                produced = False
                for batch in train_loader:
                    produced = True
                    yield batch
                if not produced:  # empty loader: stop, do not spin
                    return

        batches = self._feed(host_batches())
        first = next(batches, None)
        if first is None:
            return None
        state = self.init_state(seed)
        if resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
        step = state.step
        gen = torch.Generator(device=self.device).manual_seed(seed + step)

        t_emit, last_emit_step = time.perf_counter(), step
        metrics = {}
        for batch in itertools.chain([first], batches):
            state, metrics = self._train_step(state, batch, self.draw(batch, gen))
            step = state.step

            if step % log_every == 0:
                now = time.perf_counter()
                scalars = {k: float(v) for k, v in metrics.items()}
                scalars["steps_per_sec"] = (step - last_emit_step) / max(now - t_emit, 1e-9)
                self.logger.log_scalars(step, scalars)
                t_emit, last_emit_step = now, step

            if valid_loader is not None and (step % valid_every == 0 or step >= max_steps):
                self.validate(state, valid_loader, step)
                t_emit, last_emit_step = time.perf_counter(), step

            if step % save_every == 0 or step >= max_steps:
                self.ckpt.save(state, metrics)
                t_emit, last_emit_step = time.perf_counter(), step

            if step >= max_steps:
                break
        return state
