from .nsf_hifigan import NsfHifiGAN, NsfHifiGANGenerator  # noqa: F401
