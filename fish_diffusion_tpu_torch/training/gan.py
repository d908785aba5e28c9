"""The two-player GAN step (``fish_diffusion_tpu/training/gan.py``) and its
two loss menus:

- v1 (NSF-HiFiGAN): MPD + MSD, LSGAN adversarial losses summed over
  discriminators, feature matching, 45 x multi-scale mel L1, multi-scale
  linear-STFT L1 and the envelope loss;
- v2 (RefineGAN): MPD + MRD, LSGAN adversarial losses averaged, 45 x
  multi-scale mel smoothed-L1 and the envelope loss; no feature matching,
  no STFT loss, no spectral norm.

A step runs, in order:

1. the generator, once (``generate``). The JAX step calls it twice, in its
   discriminator phase and in its generator phase, with the same ``rng_g1``
   and the same ``params_g``, so the two outputs are identical: the port
   runs it once and hands the discriminator phase the output detached;
2. the discriminator phase (``d_phase``) on real audio and the detached
   fakes, each pass advancing the spectral-norm u/v once;
3. the discriminator update (``apply_updates``);
4. the generator phase (``g_phase``) against the updated discriminators,
   whose parameters are frozen for it (no discriminator weight gradient is
   computed) and whose u/v are used as the discriminator phase left them.
   The real pass contributes no gradient and runs under ``no_grad``, and
   only in v1, whose feature matching reads its maps;
5. the generator update.

The generator's random inputs (NSF-HiFiGAN's ``rand_ini`` and noise,
RefineGAN's list of noises) are passed in as ``draws``, so that a caller
draws them from a ``torch.Generator`` in a fixed order, or injects them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

import torch
from torch import nn

from ..models.discriminators import (
    MultiPeriodDiscriminator,
    MultiResolutionDiscriminator,
    MultiScaleDiscriminator,
    _l2normalize,
    discriminator_loss,
    envelope_loss,
    feature_loss,
    generator_adv_loss,
    multi_scale_mel_loss,
    multi_scale_stft_loss,
)


@dataclass
class GANTrainState:
    step: int
    params_g: nn.Module  # the generator
    params_d: "Discriminators"
    opt_state_g: Any  # training.optim.ScheduledOptimizer
    opt_state_d: Any
    # power-iteration u/v of the spectral-norm MSD scale, by torch name
    # (``msd.discriminators.0.convs.{i}.weight_u`` ...)
    spectral_d: dict = field(default_factory=dict)


class Discriminators(nn.Module):
    """The discriminators of a GAN flavor, in float32: MPD + MSD (v1) or
    MPD + MRD (v2)."""

    def __init__(self, flavor: str = "v1", mpd_cfg: Optional[dict] = None,
                 mrd_cfg: Optional[dict] = None):
        super().__init__()
        if flavor not in ("v1", "v2"):
            raise ValueError(f"GAN flavor {flavor!r}: expected 'v1' or 'v2'")
        self.flavor = flavor
        self.mpd = MultiPeriodDiscriminator(**(mpd_cfg or {}))
        if flavor == "v2":
            self.mrd = MultiResolutionDiscriminator(**(mrd_cfg or {}))
        else:
            self.msd = MultiScaleDiscriminator()

    @torch.no_grad()
    def init(self, seed: int) -> dict:
        """Draw the parameters from a CPU ``torch.Generator`` seeded with
        ``seed``, as the JAX package initialises them (conv weights
        N(0, 0.01^2), weight-norm scales 1, biases 0) and return the
        spectral state (u, v: normalised N(0, 1) draws)."""
        gen = torch.Generator().manual_seed(seed)
        for name, p in self.named_parameters():
            if name.endswith(("weight_v", "weight_orig")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.01)
            elif name.endswith("weight_g"):
                p.fill_(1.0)
            else:
                p.zero_()
        spectral = {}
        for i, d in enumerate(self.msd.discriminators if self.flavor == "v1" else ()):
            if not d.use_spectral_norm:
                continue
            convs = list(d.convs) + [d.conv_post]
            for (ku, kv), conv in zip(d.spectral_names(), convs):
                w = conv.weight_orig
                pre = f"msd.discriminators.{i}."
                spectral[pre + ku] = _l2normalize(torch.randn(w.shape[0], generator=gen))
                spectral[pre + kv] = _l2normalize(torch.randn(w[0].numel(), generator=gen))
        device = next(self.parameters()).device
        return {k: v.to(device) for k, v in spectral.items()}

    def apply(self, wav, spectral: Optional[dict] = None, update: bool = False):
        """-> ((scores_mpd, fmaps_mpd), (scores_2, fmaps_2), spectral), the
        second stack the MSD (v1) or the MRD (v2). ``update=True`` runs one
        power iteration in the MSD's spectral-norm scale (torch train-mode
        semantics) and returns the new u/v; v2 has no spectral state."""
        s1, f1 = self.mpd(wav)
        if self.flavor == "v2":
            s2, f2 = self.mrd(wav)
            return (s1, f1), (s2, f2), dict(spectral or {})
        own = {k[len("msd."):]: v for k, v in (spectral or {}).items()}
        s2, f2, new = self.msd(wav, own, update)
        return (s1, f1), (s2, f2), {"msd." + k: v for k, v in new.items()}


def create_gan_state(generator: nn.Module, discriminators: Discriminators,
                     optimizer_g: Callable, optimizer_d: Callable,
                     spectral_d: dict) -> GANTrainState:
    """``optimizer_*``: ``training.optim.build_optimizer``'s factories."""
    return GANTrainState(
        step=0, params_g=generator, params_d=discriminators,
        opt_state_g=optimizer_g(generator.parameters()),
        opt_state_d=optimizer_d(discriminators.parameters()),
        spectral_d=spectral_d,
    )


class GANTrainStep:
    """``step(state, batch, draws) -> (state, metrics)``; the state is
    updated in place. ``generator_apply(generator, batch, draws) -> wav
    [B, T]``; ``batch["audio"]`` [B, T] is the ground truth. Metrics are
    0-dim tensors (reading them waits for the card). The loss menu follows
    the discriminators' flavor: v1 sums its LSGAN losses and adds feature
    matching, mel L1, STFT L1 and the envelope; v2 averages its LSGAN
    losses and adds mel smoothed-L1 and the envelope."""

    def __init__(self, generator_apply: Callable, discriminators: Discriminators,
                 sampling_rate: int, multi_scale_mels: Sequence,
                 mel_loss_weight: float = 45.0):
        self.generator_apply = generator_apply
        self.discriminators = discriminators
        self.sampling_rate = sampling_rate
        self.multi_scale_mels = tuple(tuple(s) for s in multi_scale_mels)
        self.mel_loss_weight = mel_loss_weight
        self.v1 = discriminators.flavor == "v1"

    def generate(self, state: GANTrainState, batch, draws):
        return self.generator_apply(state.params_g, batch, draws)

    def d_phase(self, state: GANTrainState, y, y_hat):
        """Discriminator losses on real audio and detached fakes, one power
        iteration per pass; backward into the discriminators' gradients.
        Returns (loss_d, score stats); updates ``state.spectral_d``."""
        discs = self.discriminators
        (s1_r, _), (s2_r, _), spectral = discs.apply(y, state.spectral_d, update=True)
        (s1_g, _), (s2_g, _), spectral = discs.apply(y_hat.detach(), spectral, update=True)
        loss_d = (discriminator_loss(s1_r, s1_g, average=not self.v1)
                  + discriminator_loss(s2_r, s2_g, average=not self.v1))
        state.opt_state_d.zero_grad()
        loss_d.backward()
        state.spectral_d = spectral
        with torch.no_grad():
            stats = {
                "d_score_real": sum(s.mean() for s in s1_r + s2_r) / (len(s1_r) + len(s2_r)),
                "d_score_fake": sum(s.mean() for s in s1_g + s2_g) / (len(s1_g) + len(s2_g)),
            }
        return loss_d.detach(), stats

    def g_phase(self, state: GANTrainState, y, y_hat):
        """Generator losses against the (updated, frozen) discriminators;
        backward into the generator's gradients. Returns (loss_g, aux)."""
        discs = self.discriminators
        discs.requires_grad_(False)
        try:
            (s1_g, f1_g), (s2_g, f2_g), _ = discs.apply(y_hat, state.spectral_d)
            aux = {
                "loss_mel": multi_scale_mel_loss(
                    y, y_hat, self.sampling_rate, self.multi_scale_mels,
                    loss="l1" if self.v1 else "smoothed-l1"),
                "loss_env": envelope_loss(y, y_hat),
                "loss_adv": (generator_adv_loss(s1_g, average=not self.v1)
                             + generator_adv_loss(s2_g, average=not self.v1)),
            }
            if self.v1:  # feature matching on the real pass's maps, the STFT loss
                with torch.no_grad():
                    (_, f1_r), (_, f2_r), _ = discs.apply(y, state.spectral_d)
                aux["loss_fm"] = feature_loss(f1_r, f1_g) + feature_loss(f2_r, f2_g)
                aux["loss_stft"] = multi_scale_stft_loss(y, y_hat)
            loss = self.mel_loss_weight * aux["loss_mel"]
            for k, v in aux.items():  # in the JAX step's order
                if k != "loss_mel":
                    loss = loss + v
            state.opt_state_g.zero_grad()
            loss.backward()
        finally:
            discs.requires_grad_(True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    def apply_updates(self, optimizer):
        optimizer.step()

    def __call__(self, state: GANTrainState, batch, draws):
        y_hat = self.generate(state, batch, draws)
        y = batch["audio"][:, : y_hat.shape[1]]
        loss_d, stats = self.d_phase(state, y, y_hat)
        self.apply_updates(state.opt_state_d)
        loss_g, aux = self.g_phase(state, y, y_hat)
        self.apply_updates(state.opt_state_g)
        state.step += 1
        return state, {"loss_d": loss_d, "loss_g": loss_g, **aux, **stats}


def make_gan_train_step(generator_apply: Callable, discriminators: Discriminators,
                        sampling_rate: int = 44100,
                        multi_scale_mels: Sequence = ((2048, 256, 2048),
                                                      (2048, 270, 1080),
                                                      (4096, 540, 2160)),
                        mel_loss_weight: float = 45.0) -> GANTrainStep:
    """The step with the loss menu of ``discriminators.flavor``."""
    return GANTrainStep(generator_apply, discriminators, sampling_rate,
                        multi_scale_mels, mel_loss_weight)
