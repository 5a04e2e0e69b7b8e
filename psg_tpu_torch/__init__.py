"""psg_tpu_torch — the PyTorch/CUDA port of ``psg_tpu`` for NVIDIA Hopper.

The package mirrors ``psg_tpu``'s module layout so each part has an obvious
counterpart, and holds the same NHWC / ``[B,H,L,D]`` / ``[B,L,C]`` layouts at
its public functions.  It imports PyTorch and never JAX or ``psg_tpu``.

- ``core``      config, checkpoint reader
- ``text``      offline WordPiece tokenizer
- ``nn``        layer primitives (conv, norms, attention, resize)
- ``ops``       hand-written Hopper kernels (``csrc/``) with plain versions
- ``models``    BERT text encoder, UNet, VAE, parameter bridge
- ``diffusion`` noise schedule, DDIM and DPM-Solver++(2M)
- ``serve``     text -> sprite generator
"""

__version__ = "0.1.0"
