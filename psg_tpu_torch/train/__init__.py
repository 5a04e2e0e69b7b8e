"""Training (port of ``psg_tpu/train/``): stage 2, the UNet's diffusion
training on frozen VAE latents (``stage2_diffusion``), its optimizer
(``optim``), train state (``state``) and the CLI (``cli``)."""
