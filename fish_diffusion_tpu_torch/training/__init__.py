"""Training: the v1 GAN step, optimizers, checkpoints and the vocoder
trainer (``python -m fish_diffusion_tpu_torch.training.vocoder_cli``)."""
