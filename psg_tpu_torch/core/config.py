"""Typed configuration, read from the same YAML files as ``psg_tpu``.

An independent copy of ``psg_tpu/core/config.py``: the same section names,
dataclasses and ``section.key=value`` overrides, so the two packages read
``config/train_config.yaml`` identically.  ``configure_torch`` takes the place
of the JAX process setup.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import yaml

log = logging.getLogger(__name__)


@dataclass
class ModelConfig:
    bert_model: str = "google-bert/bert-base-uncased"
    text_embedding_dim: int = 768
    bert_finetune_strategy: str = "minimal"
    max_text_len: int = 256

    latent_dim: int = 8
    image_size: int = 215
    latent_size: int = 27
    # 1.0 = reference channel widths (32..512); <1 builds a proportionally
    # narrower tower (tests)
    vae_width_scale: float = 1.0

    num_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    beta_schedule: str = "cosine"

    time_emb_dim: int = 128
    num_attention_heads: int = 4
    unet_channels: Tuple[int, ...] = (320, 640, 1280, 1280)

    self_attn_scale: float = 0.7
    cross_attn_scale: float = 0.8
    ffn_scale: float = 0.6
    attn_dropout: float = 0.05

    latent_clamp: float = 3.0

    # "bfloat16" runs matmuls and convolutions with bf16 operands; "float32"
    # is the parity setting.  Parameters are always stored fp32.
    compute_dtype: str = "float32"

    # accepted so reference configs load; unused by this package
    pretrained_model_name: str = "runwayml/stable-diffusion-v1-5"
    cross_attention_dim: int = 768
    attention_head_dim: int = 8
    use_flash_attention: bool = True
    freeze_encoder: bool = True
    freeze_decoder: bool = True


@dataclass
class DataConfig:
    csv_path: str = "data/text_description_concat.csv"
    image_dir: str = "data/small_images"
    batch_size: int = 4
    image_size: int = 215
    num_workers: int = 4
    pin_memory: bool = True
    val_split: float = 0.15
    test_split: float = 0.05
    background_color: Union[str, Tuple[int, int, int]] = "white"
    seed: int = 42
    # fixed tokenized text length
    text_len: int = 128
    augment: bool = True
    prefetch: int = 2


@dataclass
class TrainingConfig:
    vae_epochs: int = 50
    diffusion_epochs: int = 50
    final_epochs: int = 20
    kl_anneal_start: int = 0
    kl_anneal_end: int = 3
    kl_weight_start: float = 0.0
    kl_weight_end: float = 0.01
    free_bits: float = 0.1
    reconstruction_weight: float = 1.0
    perceptual_weight: float = 0.01
    kl_weight: float = 0.001
    clip_weight: float = 0.1
    phase1_epochs: Optional[int] = None
    log_every: int = 5
    save_every: int = 20
    sample_every: int = 15
    fast_path: bool = False
    val_every: int = 1
    best_every: int = 1


@dataclass
class OptimizationConfig:
    optimizer: str = "adamw"
    learning_rate: float = 3e-4
    text_encoder_lr: float = 1e-4
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    text_max_grad_norm: float = 0.5
    skip_grad_norm: Optional[float] = None
    use_mixed_precision: bool = False
    scheduler: str = "constant"
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    onecycle_pct_start: float = 0.1
    warmup_steps: int = 500
    lr_end_factor: float = 0.1
    ema_decay: float = 0.0
    mu_dtype: Optional[str] = None


@dataclass
class MeshConfig:
    data: int = -1
    model: int = 1


@dataclass
class Config:
    experiment_dir: str = "experiments"
    device: str = "tpu"  # accepted for reference-config compat
    seed: int = 42
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    # sections this package does not model (e.g. guidance_rescale)
    extra: Dict[str, Any] = field(default_factory=dict)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


_SECTIONS = {
    "model": ModelConfig,
    "data": DataConfig,
    "training": TrainingConfig,
    "optimization": OptimizationConfig,
    "mesh": MeshConfig,
}


def _build_section(cls, raw: Dict[str, Any], section: str):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in raw.items():
        if k in fields:
            kwargs[k] = tuple(v) if isinstance(v, list) else v
        else:
            log.warning("config: unknown key %s.%s (ignored)", section, k)
    return cls(**kwargs)


def config_from_dict(raw: Dict[str, Any]) -> Config:
    cfg = Config()
    extra: Dict[str, Any] = {}
    for k, v in raw.items():
        if k in _SECTIONS and isinstance(v, dict):
            setattr(cfg, k, _build_section(_SECTIONS[k], v, k))
        elif k in ("experiment_dir", "device", "seed"):
            setattr(cfg, k, v)
        else:
            extra[k] = v
    cfg.extra = extra
    return cfg


def _parse_value(s: str) -> Any:
    try:
        v = yaml.safe_load(s)
    except yaml.YAMLError:
        return s
    if isinstance(v, str):
        # YAML 1.1 reads "1e-5" as a string; numeric overrides stay numeric
        try:
            return float(v)
        except ValueError:
            return v
    return v


def apply_overrides(cfg: Config, overrides) -> Config:
    """Apply ``section.key=value`` dotted overrides in place."""
    for item in overrides or []:
        if "=" not in item:
            raise ValueError(f"override must be key=value, got {item!r}")
        path, value = item.split("=", 1)
        parts = path.split(".")
        obj: Any = cfg
        for p in parts[:-1]:
            obj = obj.setdefault(p, {}) if isinstance(obj, dict) else getattr(obj, p)
        leaf = parts[-1]
        parsed = _parse_value(value)
        if isinstance(parsed, list):
            parsed = tuple(parsed)
        if isinstance(obj, dict):
            obj[leaf] = parsed
        else:
            if not hasattr(obj, leaf):
                raise ValueError(f"unknown config key {path!r}")
            setattr(obj, leaf, parsed)
    return cfg


def load_config(path: Union[str, Path, None] = None, overrides=None) -> Config:
    """Load a YAML config (same section names as ``psg_tpu``) + overrides."""
    if path is None:
        cfg = Config()
    else:
        with open(path, "r") as f:
            raw = yaml.safe_load(f) or {}
        cfg = config_from_dict(raw)
    return apply_overrides(cfg, overrides)


def configure_torch(cfg: Config) -> None:
    """Process-level PyTorch setup for an entry point.

    fp32 runs switch TF32 off for both matmuls and cuDNN convolutions: cuDNN
    runs fp32 convolutions in TF32 by default, which keeps about three
    decimal digits and would break fp32 parity with the reference.
    """
    import torch

    if cfg.model.compute_dtype == "float32":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
