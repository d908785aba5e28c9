"""fish_diffusion_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of
``fish_diffusion_tpu``.

The JAX package beside it is the reference. This package mirrors its module
paths, config ``type`` names and public layouts (``[B, T, C]``), imports
``torch`` and numpy and never JAX. Every kernel that the JAX package wrote
for the TPU becomes a hand-written Hopper kernel here (CUDA C++ in
``csrc/`` or Triton), with a plain PyTorch version beside it; see
``kernels.py``.

Ported so far: SVC serving (``inference.svc.SVCInference``): HubertSoft
content features, DiffSVC condition assembly, UniPC sampling over the
WaveNet denoiser, and the NSF-HiFiGAN vocoder.
"""

__version__ = "0.1.0"
