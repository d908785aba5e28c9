"""Train a vocoder on the card (``tools/nsf_hifigan/train.py``,
``tools/refinegan/train.py``): NSF-HiFiGAN (GAN flavor v1) or RefineGAN
(flavor v2), as the config's generator type says.

    python -m fish_diffusion_tpu_torch.training.vocoder_cli \
        --config configs/vocoder_nsf_hifigan.py [--resume] [--log-dir DIR] [--device cuda]
    python -m fish_diffusion_tpu_torch.training.vocoder_cli \
        --config configs/vocoder_refinegan.py

The config's ``dataset`` and ``dataloader`` sections give the training and
validation data; the learning-rate schedule decays once per epoch of
``len(train_loader)`` steps. The port trains in float32, so the CLI sets
``trainer.precision="32-true"`` and ``trainer.discriminator_dtype="float32"``
over the config's values.
"""

from __future__ import annotations

import argparse

from ..config import Config
from ..datasets.loader import build_loader
from .vocoder_trainer import DISCRIMINATOR_DTYPE, PRECISION, VocoderTrainer


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Train NSF-HiFiGAN or RefineGAN (PyTorch port)")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--log-dir", type=str, default="logs/nsf_hifigan")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    cfg = Config.fromfile(args.config)
    cfg.trainer["precision"] = PRECISION
    cfg.trainer["discriminator_dtype"] = DISCRIMINATOR_DTYPE

    loader = build_loader(cfg.dataset.train, cfg.dataloader.train)
    trainer = VocoderTrainer(cfg, log_dir=args.log_dir,
                             steps_per_epoch=max(len(loader), 1), device=args.device)
    valid_loader = None
    if cfg.dataset.get("valid"):
        try:
            valid_loader = build_loader(cfg.dataset.valid, cfg.dataloader.valid)
        except FileNotFoundError:
            pass  # no valid files present
    return trainer.fit(loader, resume=args.resume, valid_loader=valid_loader)


if __name__ == "__main__":
    main()
