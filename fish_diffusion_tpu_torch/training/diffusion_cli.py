"""Train the diffusion model on the card (``tools/diffusion/train.py``).

    python -m fish_diffusion_tpu_torch.training.diffusion_cli \
        --config configs/svc_hubert_soft.py [--log-dir logs] [--name NAME] \
        [--resume [CHECKPOINT_DIR]] [--pretrained FILE] \
        [--only-train-speaker-embeddings] [--seed 42] [--device cuda]

The config's ``dataset`` and ``dataloader`` sections give the training and
validation data (a DiffSVC model needs pitches in its batches: train
``configs/denoiser_cn_hubert.py`` with its dataset set to
``NaiveSVCDataset``); logs and checkpoints go to ``<log-dir>/<name or the
config's stem>``. The port trains in float32, so the CLI sets
``trainer.precision="32-true"`` over the config's value.

- ``--resume`` restores the latest checkpoint (of ``CHECKPOINT_DIR`` when
  given, else of the run's ``checkpoints``).
- ``--pretrained`` warm-starts the parameters (and the EMA) from a
  checkpoint of this trainer (``.pt``) or a pickle of the JAX package's
  DiffSVC parameters (WaveNet or ConvNeXt denoiser, ``convert.diffsinger_from_jax``),
  with the surgery of ``load_pretrained_params``
  (unexpected keys dropped, shape mismatches skipped, each printed), saves
  that state as step 0 and trains from it.
- ``--only-train-speaker-embeddings`` freezes every parameter outside
  ``speaker_encoder``: they get no gradient and no update, so they stay
  bit-equal. (The JAX CLI wraps its optimizer in ``optax.masked``, which
  passes the frozen leaves' gradients through as their updates; the port
  does not copy that.)

Not ported (ROADMAP.md): ``--wandb``, ``--entity``, ``--resume-id`` and
``--profile``.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import torch

from ..config import Config
from ..convert import diffsinger_from_jax
from ..datasets.loader import build_loader_from_config
from .diffusion_trainer import PRECISION, DiffusionTrainer


def load_pretrained_file(path) -> dict:
    """A state dict from a checkpoint of this trainer (``.pt``: its
    parameters) or from a pickle of the JAX package's DiffSVC parameters
    with either denoiser (the files this repository's tools write)."""
    path = Path(path)
    if path.suffix == ".pt":
        return torch.load(path, map_location="cpu", weights_only=True)["params"]
    with open(path, "rb") as f:
        return diffsinger_from_jax(pickle.load(f))


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a diffusion model (PyTorch port)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--resume", type=str, nargs="?", const="", default=None,
                        help="resume from the latest checkpoint (of this directory)")
    parser.add_argument("--pretrained", type=str, default=None,
                        help="checkpoint to warm-start the parameters from (with surgery)")
    parser.add_argument("--only-train-speaker-embeddings", action="store_true")
    parser.add_argument("--log-dir", type=str, default="logs")
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    cfg.trainer["precision"] = PRECISION
    log_dir = Path(args.log_dir) / (args.name or Path(args.config).stem)
    train_loader, valid_loader = build_loader_from_config(cfg)
    trainer = DiffusionTrainer(
        cfg, log_dir=str(log_dir), checkpoint_dir=args.resume or None, device=args.device,
        steps_per_epoch=max(len(train_loader), 1),
        only_train_speaker_embeddings=args.only_train_speaker_embeddings)
    if args.only_train_speaker_embeddings:
        print("[train] only training speaker embeddings")
    if args.pretrained:
        state = trainer.init_state(args.seed)
        state = trainer.load_pretrained(state, load_pretrained_file(args.pretrained))
        trainer.ckpt.save(state)  # the warm-started state, as step 0
        print(f"[train] warm-started from {args.pretrained}")
    return trainer.fit(train_loader, valid_loader,
                       resume=args.resume is not None or args.pretrained is not None,
                       seed=args.seed)


if __name__ == "__main__":
    main()
