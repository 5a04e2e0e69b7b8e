"""Text+time-conditioned epsilon-prediction UNet on 27x27x8 latents (port of
``psg_tpu/models/unet.py``).

- init_conv 8->320; encoder levels [320x2 @27, 640x2 @14, 1280x2 @7,
  1280x2 @4] with stride-2 3x3 downsample convs; middle block @4; decoder
  mirrors with bilinear upsample to exact sizes + conv.
- attention on every level except 27x27.
- decoder levels re-concatenate the SAME skip tensor before BOTH of their
  blocks, so decoder blocks take 2x channels in.
- conditioning enters twice: a pooled text vector is FiLM-added in every
  ResBlock with the time embedding, and the text sequence feeds the self +
  cross attention blocks, whose outputs are damped by the ``UNetSpec``
  scales.

Layout is NHWC end to end; GroupNorm+SiLU and attention go through ``ops``.

Training applies ``UNetSpec.attn_dropout`` in every attention block, as the
JAX package does: after the self- and the cross-attention core and on the
FFN output.  ``unet_apply(dropout=...)`` takes a ``torch.Generator`` to draw
the keep masks from, or the masks themselves: one entry per UNet block in
the order the blocks run (``unet_block_count``), each a triple (self, cross,
FFN) of boolean masks or ``None`` for a block without attention.  The JAX
package draws block ``i``'s triple from ``split(split(dropout_key, (2L + 1)B
+ 1)[i], 3)`` (L levels, B blocks a level; the last 2B keys go unused); the
tests pass those masks in.

Serving replays its evaluations as CUDA graphs: ``unet_apply(graphs=...)``
takes a ``UNetGraphs`` bound to one parameter tree, which captures the eager
body once per input shape and replays it for every later call that passes
that very tree with no gradient and no dropout, on the card.  The graph is
captured in pieces around the hand-written kernels' calls, which launch from
the host at every replay (``utils.graphs``).  Training replays its
evaluations too, forward and backward: ``unet_apply(graphs=...)`` takes a
``UNetTrainGraphs`` bound to the trained tree (``DiffusionTrainer`` on one
card), which captures the forward in pieces around those calls and the
backward in pieces around the calls of the kernels' autograd backwards,
and replays both for every later call that passes that very tree with a
gradient asked, no dropout or the trainer's generator, on the card.  Any
other call runs the eager body.  Counters (``utils.profiling``):
``unet_graph.capture``, ``unet_graph.replay``, and ``unet_graph.eager`` for
a call that was handed a serving cache and ran eagerly; the same three
``unet_train_graph.*`` of a training cache.

Spans (``utils.profiling``): ``psg.unet.eval`` around an evaluation, and
inside the eager body one a level, ``psg.unet.enc<i>``, ``psg.unet.mid``
and ``psg.unet.dec<i>``; a level's down or up convolution is part of it.  A
replayed evaluation has only the outer span: its level spans appear in the
trace of its capture.
"""

from __future__ import annotations

import collections
import functools
import threading
import weakref
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from psg_tpu_torch import ops
from psg_tpu_torch.core import draws, tree
from psg_tpu_torch.nn.attention import dropout as apply_dropout
from psg_tpu_torch.nn.attention import mha, mha_init
from psg_tpu_torch.nn.embeddings import sinusoidal_time_embedding
from psg_tpu_torch.nn.layers import (
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    largest_group_count,
    linear,
    linear_init,
)
from psg_tpu_torch.nn.resize import bilinear_resize
from psg_tpu_torch.utils.graphs import PiecewiseGraph
from psg_tpu_torch.utils.profiling import (
    UNET_GRAPH_CAPTURE,
    UNET_GRAPH_EAGER,
    UNET_GRAPH_REPLAY,
    UNET_TRAIN_GRAPH_CAPTURE,
    UNET_TRAIN_GRAPH_EAGER,
    UNET_TRAIN_GRAPH_REPLAY,
    count,
    span,
)


class UNetSpec(NamedTuple):
    latent_dim: int = 8
    text_dim: int = 768
    time_emb_dim: int = 128
    num_heads: int = 4
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    blocks_per_level: int = 2
    attention_levels: Tuple[bool, ...] = (False, True, True, True)
    spatial: Tuple[int, ...] = (27, 14, 7, 4)
    self_attn_scale: float = 0.7
    cross_attn_scale: float = 0.8
    ffn_scale: float = 0.6
    attn_dropout: float = 0.05


def unet_spatial_for(latent_size: int, levels: int = 4):
    """Per-level sizes under stride-2 k3 p1 downsamples: 27 -> 14 -> 7 -> 4."""
    sizes = [latent_size]
    for _ in range(levels - 1):
        sizes.append((sizes[-1] + 1) // 2)
    return tuple(sizes)


def unet_spec_from_config(cfg, latent_size: int) -> UNetSpec:
    m = cfg.model
    return UNetSpec(
        latent_dim=m.latent_dim,
        text_dim=m.text_embedding_dim,
        time_emb_dim=m.time_emb_dim,
        num_heads=m.num_attention_heads,
        channels=tuple(m.unet_channels),
        spatial=unet_spatial_for(latent_size, len(m.unet_channels)),
        self_attn_scale=m.self_attn_scale,
        cross_attn_scale=m.cross_attn_scale,
        ffn_scale=m.ffn_scale,
        attn_dropout=m.attn_dropout,
    )


# ---------------------------------------------------------------------------
# ResBlock with time/text FiLM-adds
# ---------------------------------------------------------------------------


def resblock_init(gen, cin: int, cout: int, time_dim: int, text_dim: int):
    p = {
        "norm1": group_norm_init(cin, gen.device),
        "conv1": conv2d_init(gen, cin, cout, 3, init="kaiming_normal"),
        "time_proj": linear_init(gen, time_dim, cout, init="xavier", gain=0.02),
        "text_proj": linear_init(gen, text_dim, cout, init="xavier", gain=0.02),
        "norm2": group_norm_init(cout, gen.device),
        "conv2": conv2d_init(gen, cout, cout, 3, init="kaiming_normal"),
    }
    if cin != cout:
        p["skip"] = conv2d_init(gen, cin, cout, 1, init="kaiming_normal")
    return p


def resblock_apply(params, x, time_emb, text_pooled, *, cin: int, cout: int,
                   dtype=None):
    residual = x
    h = ops.group_norm_silu(params["norm1"], x, largest_group_count(cin), eps=1e-5)
    h = conv2d(params["conv1"], h, stride=1, padding=1, dtype=dtype)
    h = h + linear(params["time_proj"], time_emb, dtype=dtype)[:, None, None, :]
    h = h + linear(params["text_proj"], text_pooled, dtype=dtype)[:, None, None, :]
    h = ops.group_norm_silu(params["norm2"], h, largest_group_count(cout), eps=1e-5)
    h = conv2d(params["conv2"], h, stride=1, padding=1, dtype=dtype)
    if "skip" in params:
        residual = conv2d(params["skip"], residual, stride=1, padding=0, dtype=dtype)
    return h + residual


# ---------------------------------------------------------------------------
# Self+cross attention transformer block
# ---------------------------------------------------------------------------


def attnblock_init(gen, channels: int, text_dim: int):
    return {
        "norm1": group_norm_init(channels, gen.device),
        "norm2": group_norm_init(channels, gen.device),
        "self_attn": mha_init(gen, channels),
        "cross_attn": mha_init(gen, channels),
        "text_proj": linear_init(gen, text_dim, channels, init="xavier", gain=0.02),
        "ffn1": linear_init(gen, channels, channels * 2, init="xavier", gain=0.02),
        "ffn2": linear_init(gen, channels * 2, channels, init="xavier", gain=0.02),
    }


def attnblock_apply(params, x, text_seq, spec: UNetSpec, *, channels: int,
                    text_bias=None, dtype=None, dropout=None):
    """x: [B,H,W,C]; text_seq: [B,S,text_dim].  ``dropout``: None, a
    ``torch.Generator``, or a (self, cross, FFN) triple of keep masks."""
    b, h, w, c = x.shape
    g = largest_group_count(channels)
    seq = x.reshape(b, h * w, c)
    rate = spec.attn_dropout if dropout is not None else 0.0
    keeps = (dropout,) * 3 if draws.is_source(dropout) or dropout is None \
        else dropout

    xn = group_norm(params["norm1"], seq, g, eps=1e-6)
    attn = mha(params["self_attn"], xn, xn, spec.num_heads, dtype=dtype,
               dropout_rate=rate, dropout_keep=keeps[0])
    seq = seq + spec.self_attn_scale * attn

    xn = group_norm(params["norm2"], seq, g, eps=1e-6)
    text_proj = linear(params["text_proj"], text_seq, dtype=dtype)
    attn = mha(params["cross_attn"], xn, text_proj, spec.num_heads,
               bias=text_bias, dtype=dtype, dropout_rate=rate, dropout_keep=keeps[1])
    seq = seq + spec.cross_attn_scale * attn

    ff = linear(params["ffn1"], seq, dtype=dtype)
    ff = F.gelu(ff)
    ff = apply_dropout(linear(params["ffn2"], ff, dtype=dtype), rate, keeps[2])
    seq = seq + spec.ffn_scale * ff
    return seq.reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# UNet block = ResBlock (+ attention)
# ---------------------------------------------------------------------------


def unetblock_init(gen, cin: int, cout: int, spec: UNetSpec, has_attention: bool):
    p = {"res": resblock_init(gen, cin, cout, spec.time_emb_dim, spec.text_dim)}
    if has_attention:
        p["attn"] = attnblock_init(gen, cout, spec.text_dim)
    return p


def unetblock_apply(params, x, time_emb, text_pooled, text_seq, spec: UNetSpec,
                    *, cin: int, cout: int, text_bias=None, dtype=None, dropout=None):
    x = resblock_apply(params["res"], x, time_emb, text_pooled,
                       cin=cin, cout=cout, dtype=dtype)
    if "attn" in params:
        x = attnblock_apply(params["attn"], x, text_seq, spec, channels=cout,
                            text_bias=text_bias, dtype=dtype, dropout=dropout)
    return x


# ---------------------------------------------------------------------------
# Full UNet
# ---------------------------------------------------------------------------


def unet_init(gen, spec: UNetSpec = UNetSpec()):
    nlvl = len(spec.channels)
    ch = spec.channels
    d = spec.time_emb_dim
    p = {
        "time_mlp": {
            "l1": linear_init(gen, d, d * 4, init="xavier", gain=0.02),
            "l2": linear_init(gen, d * 4, d * 4, init="xavier", gain=0.02),
            "l3": linear_init(gen, d * 4, d, init="xavier", gain=0.02),
        },
        "init_conv": conv2d_init(gen, spec.latent_dim, ch[0], 3, init="kaiming_normal"),
    }
    for lvl in range(nlvl):
        has_attn = spec.attention_levels[lvl]
        if lvl > 0:
            p[f"down{lvl}"] = conv2d_init(gen, ch[lvl - 1], ch[lvl], 3,
                                          init="kaiming_normal")
        p[f"enc{lvl}"] = [unetblock_init(gen, ch[lvl], ch[lvl], spec, has_attn)
                          for _ in range(spec.blocks_per_level)]
    p["middle"] = unetblock_init(gen, ch[-1], ch[-1], spec, True)
    for lvl in reversed(range(nlvl)):
        has_attn = spec.attention_levels[lvl]
        p[f"dec{lvl}"] = [unetblock_init(gen, 2 * ch[lvl], ch[lvl], spec, has_attn)
                          for _ in range(spec.blocks_per_level)]
        if lvl > 0:
            p[f"up{lvl}"] = conv2d_init(gen, ch[lvl], ch[lvl - 1], 3,
                                        init="kaiming_normal")
    p["final_norm"] = group_norm_init(ch[0], gen.device)
    # near-zero final conv
    p["final_conv"] = conv2d_init(gen, ch[0], spec.latent_dim, 3, init="xavier",
                                  gain=0.02)
    return p


def pooled_text(text_seq, text_mask=None):
    """Masked mean of the text sequence for FiLM conditioning (plain mean
    with ``text_mask=None``)."""
    if text_mask is None:
        return text_seq.mean(dim=1)
    m = text_mask.to(text_seq.dtype)[:, :, None]
    denom = m.sum(dim=1).clamp_min(1.0)
    return (text_seq * m).sum(dim=1) / denom


def text_bias_from_mask(text_mask):
    """[B,S] 0/1 mask -> additive fp32 [B,1,1,S] attention bias."""
    if text_mask is None:
        return None
    return torch.where(text_mask[:, None, None, :] > 0, 0.0, -1e9).float()


def unet_block_count(spec: UNetSpec) -> int:
    """UNet blocks (encoder, middle, decoder), in the order they run."""
    return 2 * len(spec.channels) * spec.blocks_per_level + 1


_SPAN_EVAL = "psg.unet.eval"
_SPAN_MID = "psg.unet.mid"


@functools.lru_cache(maxsize=None)
def _level_spans(nlvl: int):
    """The span names of the encoder and decoder levels, by level."""
    return (tuple(f"psg.unet.enc{i}" for i in range(nlvl)),
            tuple(f"psg.unet.dec{i}" for i in range(nlvl)))


def unet_apply(params, noisy_latent, timesteps, text_seq, spec: UNetSpec, *,
               text_mask=None, dtype=None, dropout=None, graphs=None):
    """Predict noise.  noisy_latent: [B, 27, 27, latent_dim]; timesteps: [B];
    text_seq: [B, S, text_dim] -> [B, 27, 27, latent_dim].  ``dropout``:
    None (no attention dropout), a ``torch.Generator``, or one entry per
    block (see the module note).  ``graphs``: a ``UNetGraphs`` or a
    ``UNetTrainGraphs`` the call replays where it can (its ``takes``);
    every other call runs the eager body and counts the cache's ``EAGER``."""
    with span(_SPAN_EVAL):
        if graphs is not None:
            if graphs.takes(params, noisy_latent, timesteps, text_seq, spec,
                            text_mask, dropout, dtype):
                return graphs(noisy_latent, timesteps, text_seq, text_mask, dtype, dropout)
            count(graphs.EAGER)
        return _unet_body(params, noisy_latent, timesteps, text_seq, spec,
                          text_mask=text_mask, dtype=dtype, dropout=dropout)


def _unet_body(params, noisy_latent, timesteps, text_seq, spec: UNetSpec, *,
               text_mask=None, dtype=None, dropout=None):
    """``unet_apply``'s eager evaluation, the one a graph captures."""
    nlvl = len(spec.channels)
    ch = spec.channels
    if dropout is None or draws.is_source(dropout):
        drops = iter([dropout] * unet_block_count(spec))
    else:
        if len(dropout) != unet_block_count(spec):
            raise ValueError(f"dropout: {len(dropout)} entries for "
                             f"{unet_block_count(spec)} UNet blocks")
        drops = iter(dropout)

    enc_spans, dec_spans = _level_spans(nlvl)
    t = sinusoidal_time_embedding(timesteps, spec.time_emb_dim)
    tm = params["time_mlp"]
    t = F.silu(linear(tm["l1"], t, dtype=dtype))
    t = F.silu(linear(tm["l2"], t, dtype=dtype))
    time_emb = linear(tm["l3"], t, dtype=dtype)

    tp = pooled_text(text_seq, text_mask)
    tb = text_bias_from_mask(text_mask)

    x = conv2d(params["init_conv"], noisy_latent, stride=1, padding=1, dtype=dtype)
    skips = []
    for lvl in range(nlvl):
        with span(enc_spans[lvl]):
            if lvl > 0:
                x = conv2d(params[f"down{lvl}"], x, stride=2, padding=1, dtype=dtype)
            for blk in params[f"enc{lvl}"]:
                x = unetblock_apply(blk, x, time_emb, tp, text_seq, spec,
                                    cin=ch[lvl], cout=ch[lvl], text_bias=tb,
                                    dtype=dtype, dropout=next(drops))
            skips.append(x)

    with span(_SPAN_MID):
        x = unetblock_apply(params["middle"], x, time_emb, tp, text_seq, spec,
                            cin=ch[-1], cout=ch[-1], text_bias=tb, dtype=dtype,
                            dropout=next(drops))

    for lvl in reversed(range(nlvl)):
        with span(dec_spans[lvl]):
            skip = skips.pop()
            # the same skip tensor is concatenated before BOTH decoder blocks
            for blk in params[f"dec{lvl}"]:
                x = torch.cat([x, skip], dim=-1)
                x = unetblock_apply(blk, x, time_emb, tp, text_seq, spec,
                                    cin=2 * ch[lvl], cout=ch[lvl], text_bias=tb,
                                    dtype=dtype, dropout=next(drops))
            if lvl > 0:
                target = spec.spatial[lvl - 1]
                x = bilinear_resize(x, (target, target))
                x = conv2d(params[f"up{lvl}"], x, stride=1, padding=1, dtype=dtype)

    x = ops.group_norm_silu(params["final_norm"], x, largest_group_count(ch[0]),
                            eps=1e-5)
    return conv2d(params["final_conv"], x, stride=1, padding=1, dtype=dtype)


# ---------------------------------------------------------------------------
# CUDA-graph replay of evaluations
# ---------------------------------------------------------------------------

# keys a cache holds captured: a serving deployment's key is its UNet batch
# (the prompts of a request, twice under fused CFG), so four hold a guided
# and an unguided sampler at two batch sizes (the least recently used is
# evicted); a trainer's is its batch, so four hold a classic loader's full
# and short last batch (a key beyond them runs eagerly)
_GRAPHS_KEPT = 4


def _graph_key(dtype, inputs, *extra):
    """The shapes and dtypes of the inputs (None where absent), the compute
    dtype and ``extra``."""
    return (dtype, *extra, *(None if t is None else (t.shape, t.dtype) for t in inputs))


class _GraphCache:
    """What the serving and the training graphs share: one parameter tree
    and ``UNetSpec``, its captured keys, one memory pool and one capture
    stream for all of them."""

    def __init__(self, params, spec: UNetSpec):
        self.params = params
        self.spec = spec
        self._entries = collections.OrderedDict()   # key -> entry
        self._pool = self._stream = None

    def __len__(self) -> int:
        return len(self._entries)

    def _side_stream(self, device):
        """The capture stream, made with the pool at the first capture; it
        waits for the caller's stream first."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream())
        return self._stream


class _Captured(NamedTuple):
    inputs: tuple              # static input buffers, None where the input is None
    graph: PiecewiseGraph
    output: torch.Tensor       # static output


class UNetGraphs(_GraphCache):
    """CUDA graphs of ``unet_apply`` evaluations over one parameter tree and
    one ``UNetSpec``, for a caller that owns fixed weights and asks for no
    gradient (``PokemonGenerator`` on one card).

    One graph per key: the shapes and dtypes of ``noisy_latent``,
    ``timesteps``, ``text_seq`` and ``text_mask``, and the compute dtype.
    The graph is captured in pieces (``utils.graphs.PiecewiseGraph``)
    between the calls of the hand-written GN+SiLU and flash kernels, which
    launch from the host at every replay: 62 pieces and 61 such calls an
    evaluation of the default spec, in place of its ~1,435 launches.  The
    first eligible call of a key runs one eager evaluation on a side stream,
    so that cuDNN and cuBLAS choose their kernels and workspaces outside the
    capture, captures the eager body on that stream, and replays it.  Later
    calls copy their inputs into the static buffers, replay, and return a
    clone of the static output: a sampler keeps earlier outputs, which the
    next replay would overwrite.  Every key's graph allocates from one
    memory pool; a graph may reuse another's intermediates, which is sound
    because replays run one at a time and each output is cloned before the
    next.  A lock keeps two threads off the static buffers at once.  At
    most ``_GRAPHS_KEPT`` keys are held.

    The graphs read the tree's leaves where they lay at capture: change
    their values in place or build a new cache for a new tree, but never
    replace a leaf of this one.
    """

    EAGER = UNET_GRAPH_EAGER

    def __init__(self, params, spec: UNetSpec):
        super().__init__(params, spec)
        self._lock = threading.Lock()

    def takes(self, params, noisy_latent, timesteps, text_seq, spec, text_mask,
              dropout, dtype=None) -> bool:
        """Whether a call replays: this very tree and spec, no dropout, no
        gradient, every input on the card."""
        return (params is self.params and dropout is None
                and not torch.is_grad_enabled() and spec == self.spec
                and all(t is None or t.is_cuda
                        for t in (noisy_latent, timesteps, text_seq, text_mask)))

    def __call__(self, noisy_latent, timesteps, text_seq, text_mask, dtype, dropout=None):
        inputs = (noisy_latent, timesteps, text_seq, text_mask)
        key = _graph_key(dtype, inputs)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._capture(key, inputs, dtype)
            else:
                self._entries.move_to_end(key)
                for buf, t in zip(entry.inputs, inputs):
                    if buf is not None:
                        buf.copy_(t)
                entry.graph.replay()
                count(UNET_GRAPH_REPLAY)
            return entry.output.clone()

    def _capture(self, key, inputs, dtype) -> _Captured:
        stream = self._side_stream(inputs[0].device)
        if len(self._entries) >= _GRAPHS_KEPT:
            self._entries.popitem(last=False)
        static = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                       for t in inputs)

        def body():
            return _unet_body(self.params, static[0], static[1], static[2], self.spec,
                              text_mask=static[3], dtype=dtype)

        with torch.cuda.stream(stream):
            body()
        graph = PiecewiseGraph(self._pool)
        output = graph.capture(body, stream)
        entry = self._entries[key] = _Captured(static, graph, output)
        graph.replay()
        count(UNET_GRAPH_CAPTURE)
        return entry


# ---------------------------------------------------------------------------
# CUDA-graph replay of training evaluations, forward and backward
# ---------------------------------------------------------------------------


def unet_dropout_shapes(spec: UNetSpec, batch: int):
    """The shapes of the keep masks a training evaluation draws, one entry
    per block in the order the blocks run (``unet_block_count``): for a
    block with attention the self- and the cross-attention core's output,
    [B, heads, L, C / heads], and the FFN's, [B, L, C], L the level's H*W;
    None for a block without attention."""
    nlvl, bpl = len(spec.channels), spec.blocks_per_level
    levels = ([(lvl, spec.attention_levels[lvl]) for lvl in range(nlvl) for _ in range(bpl)]
              + [(nlvl - 1, True)]
              + [(lvl, spec.attention_levels[lvl]) for lvl in reversed(range(nlvl))
                 for _ in range(bpl)])
    out = []
    for lvl, attn in levels:
        c, n = spec.channels[lvl], spec.spatial[lvl] ** 2
        heads = (batch, spec.num_heads, n, c // spec.num_heads)
        out.append((heads, heads, (batch, n, c)) if attn else None)
    return out


class _TrainEntry:
    """One key's training graphs (``UNetTrainGraphs``)."""

    def __init__(self, inputs, uniforms):
        self.inputs = inputs          # static input buffers, None where the input is None
        self.uniforms = uniforms      # per block, its masks' static uniforms; None: no dropout
        self.forward = self.output = None    # the forward's pieces; its static output
        self.backward = self.grad_out = self.grads = None   # the backward's, once captured
        self.sources = ()     # per backward call left out, the forward call whose node it takes
        self.made = None      # the outputs of the last forward replay's left-out calls


class _Due:
    """A replayed forward whose backward has not run yet."""


class _ReplayedEval(torch.autograd.Function):
    """A training evaluation replayed from a ``UNetTrainGraphs`` entry: its
    inputs are the trained leaves, its output the static output; its
    backward replays the backward's pieces and returns the leaves'
    gradients from their static buffers."""

    @staticmethod
    def forward(ctx, graphs, entry, *leaves):
        ctx.graphs, ctx.entry = graphs, entry
        return graphs._forward(entry, ctx)

    @staticmethod
    def backward(ctx, grad_out):
        return (None, None, *ctx.graphs._backward(ctx.entry, grad_out))


class UNetTrainGraphs(_GraphCache):
    """CUDA graphs of ``unet_apply``'s training evaluations, forward and
    backward, over one parameter tree and one ``UNetSpec``, for a trainer
    on one card (``DiffusionTrainer``), whose optimizer updates the tree's
    leaves in place.

    One entry per key: the shapes and dtypes of ``noisy_latent``,
    ``timesteps``, ``text_seq`` and ``text_mask``, the compute dtype, and
    whether there is dropout.  The forward is captured in pieces between
    the calls of ``ops.sdpa`` and ``ops.group_norm_silu`` (62 pieces and 61
    calls for the default spec), the backward in pieces between the calls
    of ``FlashSDPA.backward`` and ``GroupNormSiLU.backward`` (``utils.graphs``);
    every other launch of the evaluation, forward and backward (convolutions,
    matmuls, the plain norms, casts, adds, the time embedding and the
    dropout's masks and products), replays from the pieces.  The left-out
    calls are made at each replay through the names they have then, so a
    wrapper placed on any of the four sees every call with its shapes and
    the device time of its kernels.  The forward's calls run with autograd
    on: each makes a new node, whose saved tensors (q, k, v, o and the
    logsumexp; x, scale and bias) are this step's, and the backward's calls
    take these nodes, not the capture's.

    The whole evaluation is one ``torch.autograd.Function`` over the trained
    leaves (``_ReplayedEval``): its forward copies the inputs into static
    buffers and replays the forward, and returns the static output (which
    the next replay overwrites); its backward copies the output's gradient
    into a static buffer, replays the backward, and returns the leaves'
    gradients from static buffers (which the next backward overwrites).

    Dropout: with a ``torch.Generator`` the evaluation draws each block's
    uniforms into static buffers before the replay, from that generator in
    the eager body's order and shapes (``unet_dropout_shapes``); the graph
    turns them into the keep masks.  So a replayed step draws what the
    eager step draws.

    A key's first call captures: it runs one eager forward and backward on
    a side stream, so that cuDNN and cuBLAS choose their kernels and
    workspaces outside the capture, captures the forward and replays it;
    the first backward captures the backward from inside the autograd
    engine, on the thread that runs the marked backwards, and replays it.
    So the first step's loss and gradients come from replays.  Every key's
    graphs allocate from one memory pool, which is sound because a step
    replays its forward and then its backward before another key's replay:
    while a replayed forward awaits its backward, other calls run eagerly.

    ``refusal`` says why a call runs the eager body instead: another tree
    or spec, no gradient asked, dropout masks or a mesh's draws given (a
    mesh's step gathers a new tree or cuts its draws; a process group
    anywhere), a backward still due, ``_GRAPHS_KEPT`` other keys held, or
    an input off the card or needing a gradient.  The graphs read the
    tree's leaves where they lay at capture: never replace a leaf of this
    tree (a restored checkpoint is a new tree, which needs a new cache).
    """

    EAGER = UNET_TRAIN_GRAPH_EAGER

    def __init__(self, params, spec: UNetSpec):
        super().__init__(params, spec)
        self.leaves = tree.leaves(params)
        # what the graphs record and differentiate: leaves of their own over
        # the tree's memory, so that the capture's autograd graph, made on
        # the side stream, holds no gradient accumulator of the tree's leaves
        self._own = tree.map(lambda p: p.detach().requires_grad_(True), params)
        self._own_leaves = tree.leaves(self._own)
        self._due = None    # a weak reference to the _Due of the replay awaiting its backward

    def refusal(self, params, noisy_latent, timesteps, text_seq, spec, text_mask,
                dropout, dtype):
        """Why a call runs the eager body, or None when it replays."""
        inputs = (noisy_latent, timesteps, text_seq, text_mask)
        if params is not self.params or spec != self.spec:
            return "another tree"
        if not torch.is_grad_enabled() or not all(p.requires_grad for p in self.leaves):
            return "no gradient"
        if dropout is not None and not isinstance(dropout, torch.Generator):
            return "dropout draws given"
        if torch.distributed.is_available() and torch.distributed.is_initialized():
            return "mesh"
        if self._due is not None and self._due() is not None:
            return "backward due"
        if (len(self._entries) >= _GRAPHS_KEPT
                and _graph_key(dtype, inputs, dropout is not None) not in self._entries):
            return "keys held"
        if not all(t is None or (t.is_cuda and not t.requires_grad) for t in inputs) or (
                dropout is not None and dropout.device.type != "cuda"):
            return "off the card"
        return None

    def takes(self, params, noisy_latent, timesteps, text_seq, spec, text_mask,
              dropout, dtype=None) -> bool:
        return self.refusal(params, noisy_latent, timesteps, text_seq, spec, text_mask,
                            dropout, dtype) is None

    def __call__(self, noisy_latent, timesteps, text_seq, text_mask, dtype, dropout=None):
        inputs = (noisy_latent, timesteps, text_seq, text_mask)
        key = _graph_key(dtype, inputs, dropout is not None)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._entries[key] = self._new_entry(inputs, dropout is not None)
        else:
            for buf, t in zip(entry.inputs, inputs):
                if buf is not None:
                    buf.data.copy_(t)   # bumps no version: see _refill in utils.graphs
        if dropout is not None:   # the eager body's draws, in its order
            for block in entry.uniforms:
                for u in block or ():
                    torch.rand(u.shape, generator=dropout, out=u)
        if entry.forward is None:
            try:
                self._capture(entry, dtype)
            except BaseException:
                del self._entries[key]
                raise
            count(UNET_TRAIN_GRAPH_CAPTURE)
        else:
            count(UNET_TRAIN_GRAPH_REPLAY)
        return _ReplayedEval.apply(self, entry, *self.leaves)

    def _new_entry(self, inputs, dropout: bool) -> _TrainEntry:
        """A key's static inputs (copies of ``inputs``) and, with dropout,
        its uniforms' buffers."""
        static = tuple(None if t is None else t.clone(memory_format=torch.contiguous_format)
                       for t in inputs)
        uniforms = None
        if dropout:
            uniforms = [None if shapes is None else tuple(
                torch.empty(s, device=inputs[0].device) for s in shapes)
                for shapes in unet_dropout_shapes(self.spec, inputs[0].shape[0])]
        return _TrainEntry(static, uniforms)

    def _capture(self, entry, dtype) -> None:
        """One eager forward and backward on the side stream, then the
        forward's capture."""
        stream = self._side_stream(entry.inputs[0].device)
        static, uniforms = entry.inputs, entry.uniforms
        keep = 1.0 - self.spec.attn_dropout

        def body():
            masks = None if uniforms is None else [
                None if u is None else tuple(x < keep for x in u) for u in uniforms]
            return _unet_body(self._own, static[0], static[1], static[2], self.spec,
                              text_mask=static[3], dtype=dtype, dropout=masks)

        with torch.cuda.stream(stream):
            out = body()
            torch.autograd.grad(out, self._own_leaves, torch.ones_like(out),
                                allow_unused=True)
            del out
        entry.forward = PiecewiseGraph(self._pool)
        entry.output = entry.forward.capture(body, stream)

    def _forward(self, entry, ctx):
        """Replay the forward; each left-out call runs with autograd on and
        keeps its output, whose node the backward takes."""
        made = entry.made = [None] * len(entry.forward.calls)

        def call(i, fn, args, kwargs):
            with torch.enable_grad():
                made[i] = fn(*args, **kwargs)
            return made[i]

        entry.forward.replay(call)
        ctx.due = due = _Due()
        self._due = weakref.ref(due)
        return entry.output.detach()

    def _backward(self, entry, grad_out):
        """Replay the backward (captured at the first call) on this step's
        nodes; the leaves' gradients."""
        if entry.backward is None:
            self._capture_backward(entry, grad_out)
        else:
            entry.grad_out.copy_(grad_out)
        made = entry.made

        def call(i, fn, args, kwargs):
            return fn(made[entry.sources[i]].grad_fn, *args[1:], **kwargs)

        entry.backward.replay(call)
        entry.made = self._due = None
        return entry.grads

    def _capture_backward(self, entry, grad_out) -> None:
        """Capture the backward of the capture's autograd graph, from the
        engine's thread that runs this backward and so the marked ones."""
        stream = self._side_stream(grad_out.device)
        entry.grad_out = grad_out.clone(memory_format=torch.contiguous_format)
        graph = PiecewiseGraph(self._pool)
        grads = graph.capture(lambda: torch.autograd.grad(
            entry.output, self._own_leaves, entry.grad_out, allow_unused=True), stream)
        nodes = {id(c.out.grad_fn): i for i, c in enumerate(entry.forward.calls)}
        missing = [c.path for c in graph.calls if id(c.args[0]) not in nodes]
        if missing:
            raise RuntimeError(f"UNetTrainGraphs: backward calls {missing} take no node "
                               f"of the forward's left-out calls")
        entry.sources = tuple(nodes[id(c.args[0])] for c in graph.calls)
        entry.grads = tuple(None if g is None else g.detach() for g in grads)
        entry.backward = graph
