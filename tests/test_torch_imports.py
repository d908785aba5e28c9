"""The port stands alone: importing every module of
``fish_diffusion_tpu_torch`` (the training modules, the datasets, the
discriminators, the RefineGAN and iSTFTNet vocoders, monotonic alignment,
the pitch extractors, the ConvNeXt denoiser with K10's backward, the
denoiser's dataset and the HuBERT front ends among them) loads no JAX, flax, optax or
``fish_diffusion_tpu`` module (checked in a fresh interpreter)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import fish_diffusion_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fish_diffusion_tpu"))
assert len(names) >= 15, names
for name in ("training.gan", "training.vocoder_trainer", "training.vocoder_cli",
             "training.optim", "training.checkpoint", "datasets.naive",
             "models.discriminators", "ops.blocked_conv", "models.vocoders.refinegan",
             "extractors.pitch", "extractors.crepe", "extractors.world",
             "models.vocoders.istft_net", "ops.monotonic_align", "ops.mel",
             "training.diffusion_trainer", "training.diffusion_cli",
             "training.diffusion_state", "training.diffusion_checkpoint",
             "datasets.loader", "datasets.wrappers", "models.convnext",
             "extractors.feature"):
    assert "fish_diffusion_tpu_torch." + name in names, name
assert not bad, bad
from fish_diffusion_tpu_torch.registry import (DENOISERS, FEATURE_EXTRACTORS,
                                               PITCH_EXTRACTORS, VOCODERS)
for name in ("WaveNetDenoiser", "ConvNextDenoiser"):
    assert name in DENOISERS, name
for name in ("HubertSoft", "ChineseHubertSoft", "ChineseHubert", "ContentVec"):
    assert name in FEATURE_EXTRACTORS, name
for name in ("NsfHifiGAN", "ISTFTNet", "RefineGANGenerator"):
    assert name in VOCODERS, name
from fish_diffusion_tpu_torch.datasets import NaiveDenoiserDataset
from fish_diffusion_tpu_torch.registry import DATASETS
for name in ("NaiveSVCDataset", "NaiveDenoiserDataset", "NaiveVOCODERDataset"):
    assert name in DATASETS, name
from fish_diffusion_tpu_torch import kernels
from fish_diffusion_tpu_torch.models import convnext
for name in ("depthwise_conv7_norm_backward_reference", "depthwise_conv7_norm_backward",
             "depthwise_conv7_norm_backward_rows_reference",
             "depthwise_conv7_backward_taps_reference", "DepthwiseConv7NormFunction"):
    assert hasattr(convnext, name), name
assert kernels.KERNELS["depthwise_conv7_norm_backward"]["id"] == "K10 bwd"
assert not [m for m in sys.modules
            if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "fish_diffusion_tpu")]
for name in ("HarvestPitchExtractor", "ParselMouthPitchExtractor", "AutocorrPitchExtractor",
             "PyinPitchExtractor", "CrepePitchExtractor", "DioPitchExtractor",
             "YinPitchExtractor"):
    assert name in PITCH_EXTRACTORS, name
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
