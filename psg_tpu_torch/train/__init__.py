"""Training (port of ``psg_tpu/train/``): the stage trainers' base
``StageTrainer`` (``trainer``: the step, validation, sample grids,
checkpoints and the classic loop), each stage's setup, loss and sampler
(``stage0_mlm``, ``stage1_vae``, ``stage2_diffusion``, ``stage2_sd``,
``stage3_final``), the device-resident fast path (``fastpath``), the
optimizer (``optim``), train state (``state``), the mesh's part of a step
(``common``) and the CLI (``cli``)."""
