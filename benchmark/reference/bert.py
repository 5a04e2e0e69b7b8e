# Frozen copy of psg_tpu_torch/models/bert.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""BERT encoder (port of ``psg_tpu/models/bert.py``).

Embeddings (word + position + type, LayerNorm eps 1e-12), post-LN layers
with exact-GELU FFN, tanh pooler.  The padding mask is an fp32 ``-1e9``
additive key bias.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import plainops as ops
from .layers import layer_norm, layer_norm_init, linear, linear_init


class BertConfig(NamedTuple):
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12

    @classmethod
    def base(cls) -> "BertConfig":
        return cls()

    @classmethod
    def mini(cls) -> "BertConfig":
        return cls(hidden_size=256, num_layers=4, num_heads=4,
                   intermediate_size=1024)

    @classmethod
    def tiny_test(cls, vocab_size: int = 128) -> "BertConfig":
        return cls(vocab_size=vocab_size, hidden_size=32, num_layers=2,
                   num_heads=2, intermediate_size=64, max_position=64)


def bert_config_for(model_name: str, vocab_size: int) -> BertConfig:
    """Configured BERT name -> BertConfig; the vocabulary follows the
    tokenizer (``psg_tpu/train/stage1_vae.py::bert_config_for``)."""
    name = model_name.lower()
    if "mini" in name:
        base = BertConfig.mini()
    elif "tiny-test" in name:
        base = BertConfig.tiny_test()
    else:
        base = BertConfig.base()
    return base._replace(vocab_size=vocab_size)


def bert_init(gen, cfg: BertConfig):
    h = cfg.hidden_size
    dev = gen.device

    def emb(n, d):
        return 0.02 * torch.randn((n, d), generator=gen, device=dev)

    params = {
        "embeddings": {
            "word": emb(cfg.vocab_size, h),
            "position": emb(cfg.max_position, h),
            "token_type": emb(cfg.type_vocab_size, h),
            "ln": layer_norm_init(h, dev),
        },
        "layers": [],
        "pooler": linear_init(gen, h, h, init="torch"),
    }
    for _ in range(cfg.num_layers):
        params["layers"].append({
            "attn": {
                "q": linear_init(gen, h, h, init="torch"),
                "k": linear_init(gen, h, h, init="torch"),
                "v": linear_init(gen, h, h, init="torch"),
                "out": linear_init(gen, h, h, init="torch"),
                "ln": layer_norm_init(h, dev),
            },
            "ffn": {
                "w1": linear_init(gen, h, cfg.intermediate_size, init="torch"),
                "w2": linear_init(gen, cfg.intermediate_size, h, init="torch"),
                "ln": layer_norm_init(h, dev),
            },
        })
    return params


def _self_attention(p, x, mask_bias, num_heads: int, dtype=None):
    b, s, h = x.shape
    hd = h // num_heads

    def heads(t):
        return t.reshape(b, s, num_heads, hd).transpose(1, 2)

    q = heads(linear(p["q"], x, dtype=dtype))
    k = heads(linear(p["k"], x, dtype=dtype))
    v = heads(linear(p["v"], x, dtype=dtype))
    out = ops.sdpa(q, k, v, bias=mask_bias)
    out = out.transpose(1, 2).reshape(b, s, h)
    return linear(p["out"], out, dtype=dtype)


def bert_apply(params, input_ids, attention_mask, cfg: BertConfig, *,
               token_type_ids=None, dtype=None):
    """-> (last_hidden_state [B,S,H], pooled [B,H])."""
    s = input_ids.shape[1]
    e = params["embeddings"]
    pos_ids = torch.arange(s, device=input_ids.device)[None, :]
    tt = token_type_ids if token_type_ids is not None else torch.zeros_like(input_ids)
    x = e["word"][input_ids] + e["position"][pos_ids] + e["token_type"][tt]
    x = layer_norm(e["ln"], x, eps=cfg.ln_eps)
    if dtype is not None:
        x = x.to(dtype)

    # additive mask bias [B,1,1,S], fp32 in every compute dtype
    bias = torch.where(attention_mask[:, None, None, :] > 0, 0.0, -1e9).float()

    for lp in params["layers"]:
        attn = _self_attention(lp["attn"], x, bias, cfg.num_heads, dtype=dtype)
        x = layer_norm(lp["attn"]["ln"], x + attn, eps=cfg.ln_eps)
        ff = linear(lp["ffn"]["w1"], x, dtype=dtype)
        ff = F.gelu(ff)
        ff = linear(lp["ffn"]["w2"], ff, dtype=dtype)
        x = layer_norm(lp["ffn"]["ln"], x + ff, eps=cfg.ln_eps)

    pooled = torch.tanh(linear(params["pooler"], x[:, 0], dtype=dtype))
    return x, pooled
