"""Text encoder: BERT -> projection -> LayerNorm (port of
``psg_tpu/models/text_encoder.py``).

The projection exists only when ``hidden_size != text_dim``; the final
LayerNorm uses eps 1e-5.  ``finetune_mask`` gives the reference's fine-tune
strategies as a boolean tree over the parameters (True = trainable), which
the optimizer turns into a frozen group (``train.optim.labels_from_mask``).
"""

from __future__ import annotations

from psg_tpu_torch.core import tree
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


def finetune_mask(params, cfg: BertConfig, strategy: str = "minimal"):
    """Boolean tree over ``params``, True = trainable:

    - 'none':    the projection and the final LayerNorm only
    - 'minimal': + the last 2 BERT layers and the pooler (the reference's default)
    - 'partial': + the last 4 BERT layers and the pooler
    - 'full':    everything
    """
    if strategy not in ("none", "minimal", "partial", "full"):
        raise ValueError(f"unknown finetune_strategy {strategy!r}")
    n_unfrozen = {"none": 0, "minimal": 2, "partial": 4, "full": cfg.num_layers}[strategy]
    first_trainable = cfg.num_layers - n_unfrozen

    def like(t, value):
        return tree.map(lambda _: value, t)

    bert = params["bert"]
    bert_mask = {"embeddings": like(bert["embeddings"], strategy == "full"),
                 "layers": [like(layer, i >= first_trainable)
                            for i, layer in enumerate(bert["layers"])],
                 # the pooler trains in every strategy but 'none'
                 "pooler": like(bert["pooler"], strategy != "none")}
    # in the parameters' own key order: the optimizer pairs labels with
    # parameters by position
    return {k: ({b: bert_mask[b] for b in bert} if k == "bert" else like(v, True))
            for k, v in params.items()}
