"""The benchmark's plain reference: frozen copies of the port's model code
with every kernel call replaced by plain PyTorch (``plainops``), computed in
float32 with TF32 off.  It imports nothing of ``psg_tpu_torch``."""
