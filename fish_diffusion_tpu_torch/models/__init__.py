from . import convnext, encoders, vocoders, wavenet  # noqa: F401
from .diffsinger import DiffSinger  # noqa: F401
from .diffusion import GaussianDiffusion  # noqa: F401


def build_model(model_cfg):
    """Build the arch from a ``model`` config dict. The vocoder is built
    separately, through ``VOCODERS``."""
    from ..registry import ARCHS

    cfg = dict(model_cfg)
    cfg.pop("vocoder", None)
    return ARCHS.build(cfg)
