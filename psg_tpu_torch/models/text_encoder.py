"""Text encoder: BERT -> projection -> LayerNorm (port of
``psg_tpu/models/text_encoder.py``; serving only, no fine-tuning masks).

The projection exists only when ``hidden_size != text_dim``; the final
LayerNorm uses eps 1e-5.
"""

from __future__ import annotations

from psg_tpu_torch.models.bert import BertConfig, bert_apply, bert_init
from psg_tpu_torch.nn.layers import layer_norm, layer_norm_init, linear, linear_init


def text_encoder_init(gen, cfg: BertConfig, text_dim: int):
    params = {"bert": bert_init(gen, cfg)}
    if cfg.hidden_size != text_dim:
        params["projection"] = linear_init(gen, cfg.hidden_size, text_dim,
                                           init="torch")
    params["ln"] = layer_norm_init(text_dim, gen.device)
    return params


def text_encoder_apply(params, input_ids, attention_mask, cfg: BertConfig, *,
                       dtype=None):
    """ids/mask: [B, S] -> normalized hidden states [B, S, text_dim]."""
    hidden, _pooled = bert_apply(params["bert"], input_ids, attention_mask,
                                 cfg, dtype=dtype)
    if "projection" in params:
        hidden = linear(params["projection"], hidden, dtype=dtype)
    return layer_norm(params["ln"], hidden, eps=1e-5)
