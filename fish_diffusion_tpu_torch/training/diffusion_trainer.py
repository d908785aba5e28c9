"""The diffusion trainer (``fish_diffusion_tpu/training/trainer.py:Trainer``):
DiffSVC on one card, with the WaveNet denoiser (``configs/svc_hubert_soft.py``)
or the ConvNeXt (``configs/denoiser_cn_hubert.py``; its model has a pitch
encoder, so it trains on ``NaiveSVCDataset``: the config's
``NaiveDenoiserDataset`` carries no pitches, and the model raises on its
batches).

- the train step of ``training/diffusion_state.py`` (AdamW with the
  configured schedule, clip by global norm, accumulation, optional EMA), t
  and the noise drawn from one ``torch.Generator`` seeded from the seed
  and the step;
- every ``log_every_n_steps``: ``train_loss``, ``grad_norm``, ``lr`` and
  ``steps_per_sec`` to ``<log_dir>/metrics.jsonl``;
- every ``val_check_interval`` steps and at ``max_steps``: ``validate``
  (the loss over ``limit_val_batches`` batches with a generator seeded 0
  for each, as the JAX trainer's fixed ``PRNGKey(0)``; then reverse
  diffusion on the first batch at ``val_sampler_interval``), then a
  checkpoint (``training/diffusion_checkpoint.py``; the last one forced);
- ``resume`` restores the latest checkpoint; the ``wall_*`` breakdown
  (setup, first step, train steps, validation, checkpoint, total) is
  logged when ``fit`` returns.

Validation samples: for the first two items of the first batch, the
ground-truth and predicted mels are written as ``.npy`` files
(``sample-<i>_mel_gt_<step>.npy``, ``sample-<i>_mel_pred_<step>.npy``)
where the JAX trainer draws a matplotlib figure (the card's machine has no
matplotlib), and both are vocoded to wav files when the configured vocoder
loads; when it does not, the trainer prints why and goes on, as the JAX
trainer does.

Precision: float32 throughout, ``trainer.precision="32-true"`` (the CLI
sets it); anything else raises, bf16 training is ROADMAP work. TF32 is
turned off for matmuls and cuDNN, so the float32 step is float32.

Not ported (each raises when a config sets it, ROADMAP Queue 1): the JAX
trainer's device feeder and on-device batch cache
(``cache_batches_on_device``, ``cache_bytes_budget``), ``transfer_dtype``,
LoRA (``lora``), FSDP (``trainer.fsdp``), ``trainer.max_epochs`` and
wandb.
"""

from __future__ import annotations

import itertools
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models import build_model
from ..registry import VOCODERS
from ..utils import resolve_device
from .diffusion_checkpoint import CheckpointManager, load_pretrained_params
from .diffusion_state import (TrainState, batch_to_device, create_train_state,
                              make_train_step, model_kwargs)
from .optim import build_lr_schedule, build_optimizer
from .trainer import MetricsLogger

PRECISION = "32-true"
_UNPORTED = {
    "max_epochs": "an epoch limit (train to max_steps)",
    "cache_batches_on_device": "the on-device batch cache",
    "cache_bytes_budget": "the on-device batch cache",
    "transfer_dtype": "transfer_dtype",
    "fsdp": "FSDP",
}


class DiffusionTrainer:
    def __init__(self, config, log_dir: str = "logs", checkpoint_dir: Optional[str] = None,
                 device="cuda", steps_per_epoch: Optional[int] = None,
                 only_train_speaker_embeddings: bool = False):
        self.config = config
        self.device = resolve_device(device)
        tc = config.trainer
        precision = str(tc.get("precision", ""))
        if precision != PRECISION:
            raise NotImplementedError(
                f"trainer.precision={precision!r}: the port trains in float32 only (set "
                f"{PRECISION!r}); bf16 training is in ROADMAP.md")
        for key, what in _UNPORTED.items():
            if tc.get(key):
                raise NotImplementedError(f"trainer.{key}: {what} is not ported (ROADMAP.md)")
        if config.get("lora"):
            raise NotImplementedError("lora: LoRA fine-tuning is not ported (ROADMAP.md)")
        if tc.get("gradient_clip_algorithm", "norm") != "norm":
            raise NotImplementedError("trainer.gradient_clip_algorithm: only 'norm'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        self.model = build_model(config.model).to(self.device)
        self.only_train_speaker_embeddings = only_train_speaker_embeddings
        self.ema_momentum = config.get("ema_momentum", None)
        sched_cfg = dict(config.scheduler) if config.get("scheduler") else None
        self.make_optimizer = build_optimizer(
            dict(config.optimizer), sched_cfg, steps_per_epoch,
            grad_clip_val=tc.get("gradient_clip_val"),
            accumulate_grad_batches=tc.get("accumulate_grad_batches", 1))
        self.lr_schedule = build_lr_schedule(sched_cfg, dict(config.optimizer).get("lr", 1.0),
                                             steps_per_epoch)
        self.max_steps = tc.get("max_steps", 2_000_000)
        self.val_check_interval = tc.get("val_check_interval", 5000)
        self.log_every_n_steps = tc.get("log_every_n_steps", 10)
        self.log_dir = Path(log_dir)
        self.logger = MetricsLogger(log_dir)
        ckpt_cfg = tc.get("checkpoint", {}) or {}
        self.ckpt = CheckpointManager(checkpoint_dir or (self.log_dir / "checkpoints"),
                                      save_top_k=ckpt_cfg.get("save_top_k", -1),
                                      save_interval_steps=ckpt_cfg.get("every_n_train_steps"))
        self.vocoder = None
        if config.model.get("vocoder"):
            try:
                self.vocoder = VOCODERS.build({**dict(config.model["vocoder"]),
                                               "device": self.device})
            except OSError as err:
                print(f"[trainer] vocoder unavailable for validation audio: {err}")
        self._train_step = make_train_step(self.ema_momentum)
        self._sample_rate = config.get("sampling_rate", 44100)
        self.last_wall_breakdown: dict = {}

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int = 42) -> TrainState:
        """Fresh weights (the modules' own initialisation, drawn on the CPU
        from ``seed``), step 0; with ``only_train_speaker_embeddings`` every
        parameter outside ``speaker_encoder`` is frozen (``requires_grad``
        False: no gradient, no update, no weight decay)."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            fresh = build_model(self.config.model)
        self.model.load_state_dict(fresh.state_dict())
        self.model.requires_grad_(True)
        if self.only_train_speaker_embeddings:
            for name, p in self.model.named_parameters():
                p.requires_grad_(name.startswith("speaker_encoder."))
        return create_train_state(self.model, self.make_optimizer, self.ema_momentum)

    def load_pretrained(self, state: TrainState, pretrained: dict) -> TrainState:
        """Warm start: ``pretrained`` (a state dict) into the parameters and
        the EMA with the surgery of ``load_pretrained_params``."""
        state.model.load_state_dict(load_pretrained_params(pretrained,
                                                           state.model.state_dict()))
        if state.ema is not None:
            state.ema.load_state_dict(load_pretrained_params(pretrained,
                                                             state.ema.state_dict()))
        return state

    # -- the loop ---------------------------------------------------------

    def fit(self, train_loader, valid_loader, resume: bool = False, seed: int = 42):
        """Train until ``max_steps``, cycling over the loader's epochs (a
        resume restores the state, not the loader's position). Returns the
        state, or None for an empty loader."""
        t_fit0 = time.perf_counter()

        def host_batches():
            while True:
                produced = False
                for batch in train_loader:
                    produced = True
                    yield batch
                if not produced:  # empty loader: stop, do not spin
                    return

        batches = host_batches()
        first = next(batches, None)
        if first is None:
            return None
        state = self.init_state(seed)
        if resume and self.ckpt.latest_step() is not None:
            state = self.ckpt.restore(state)
            print(f"[trainer] resumed at step {state.step}")
        step = state.step
        gen = torch.Generator(device=self.device).manual_seed(seed + step)

        wall = {"setup_s": time.perf_counter() - t_fit0, "first_step_s": None,
                "validation_s": 0.0, "checkpoint_s": 0.0}
        t_emit, last_emit_step = time.perf_counter(), step
        try:
            for batch in itertools.chain([first], batches):
                t_s0 = time.perf_counter()
                state, metrics = self._train_step(state, batch_to_device(batch, self.device),
                                                  gen)
                if wall["first_step_s"] is None:
                    float(metrics["loss"])  # the first step, synchronised
                    wall["first_step_s"] = time.perf_counter() - t_s0
                step = state.step

                if step % self.log_every_n_steps == 0:
                    now = time.perf_counter()
                    self.logger.log_scalars(step, {
                        "train_loss": metrics["loss"], "grad_norm": metrics["grad_norm"],
                        "lr": self.lr_schedule(step),
                        "steps_per_sec": max(step - last_emit_step, 1) / max(now - t_emit, 1e-9),
                    })
                    t_emit, last_emit_step = now, step

                if step % self.val_check_interval == 0 or step >= self.max_steps:
                    t_v0 = time.perf_counter()
                    val_loss = self.validate(state, valid_loader, step)
                    t_c0 = time.perf_counter()
                    wall["validation_s"] += t_c0 - t_v0
                    self.ckpt.save(state, {"valid_loss": val_loss}, force=step >= self.max_steps)
                    wall["checkpoint_s"] += time.perf_counter() - t_c0
                    t_emit, last_emit_step = time.perf_counter(), step

                if step >= self.max_steps:
                    break
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall["total_s"] = time.perf_counter() - t_fit0
            wall["train_steps_s"] = max(
                wall["total_s"] - wall["setup_s"] - (wall["first_step_s"] or 0.0)
                - wall["validation_s"] - wall["checkpoint_s"], 0.0)
            self.last_wall_breakdown = wall
            self.logger.log_scalars(step, {f"wall_{k}": v for k, v in wall.items()
                                           if v is not None})
        return state

    # -- validation -------------------------------------------------------

    @torch.no_grad()
    def validate(self, state: TrainState, valid_loader, step: int) -> float:
        """The loss over the valid set (at most ``trainer.limit_val_batches``
        batches; t and noise from a generator seeded 0 for each), and the
        samples of the first batch."""
        model = state.inference_params()
        limit = self.config.trainer.get("limit_val_batches")
        losses = []
        for i, batch in enumerate(itertools.islice(valid_loader, limit)):
            b = batch_to_device(batch, self.device)
            gen = torch.Generator(device=self.device).manual_seed(0)
            losses.append(float(model(**model_kwargs(b), generator=gen)["loss"]))
            if i == 0:
                self._log_samples(model, b, step)
        val_loss = float(np.mean(losses)) if losses else float("nan")
        self.logger.log_scalars(step, {"valid_loss": val_loss})
        return val_loss

    def _log_samples(self, model, batch: dict, step: int):
        """Reverse diffusion on the batch (``trainer.val_sampler_interval``,
        x_T from a generator seeded 1); the first two items' mels as
        ``.npy`` and, with a vocoder, their ground-truth and predicted
        audio as wav files."""
        kwargs = model_kwargs(batch)
        mel_target = kwargs.pop("mel")
        gen = torch.Generator(device=self.device).manual_seed(1)
        pred = model.sample(**kwargs, generator=gen,
                            sampler_interval=self.config.trainer.get("val_sampler_interval"))
        mel_lens = batch.get("mel_lens")
        pitches = batch.get("pitches")
        for idx in range(min(2, pred.shape[0])):
            n = int(mel_lens[idx]) if mel_lens is not None else pred.shape[1]
            gt, pr = mel_target[idx, :n], pred[idx, :n]
            for tag, mel in (("gt", gt), ("pred", pr)):
                np.save(self.log_dir / f"sample-{idx}_mel_{tag}_{step}.npy",
                        mel.float().cpu().numpy())
            if self.vocoder is None or pitches is None:
                continue
            f0 = pitches[idx, :n]
            f0 = (f0[:, 0] if f0.ndim == 2 else f0).contiguous()
            for tag, mel in (("wav_gt", gt), ("wav_pred", pr)):
                wav = self.vocoder.spec2wav(mel.contiguous(), f0)
                self.logger.log_audio(step, f"sample-{idx}/{tag}", wav.cpu().numpy(),
                                      self._sample_rate)
