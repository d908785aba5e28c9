from .istft_net import ISTFTNet, ISTFTNetGenerator  # noqa: F401
from .nsf_hifigan import NsfHifiGAN, NsfHifiGANGenerator  # noqa: F401
