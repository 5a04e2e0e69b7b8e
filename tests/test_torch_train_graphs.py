"""The UNet's training graphs (``models.unet.UNetTrainGraphs``): a training
evaluation's forward and backward replayed from CUDA graphs in pieces, with
the hand-written kernels' calls made from the host between them.

On the CPU:

- the dropout uniforms drawn before a replay, in the order and shapes of
  ``unet_dropout_shapes``, give the masks and the generator state of the
  eager body's own draws;
- when a call runs the eager body, and why: the CPU never captures; dropout
  masks given, a mesh's row draws or process group, another tree, no
  gradient, a backward still due and a full cache each take the eager body
  and count ``unet_train_graph.eager``;
- with the CUDA graph calls stood in for and the kernels' autograd
  Functions on their CPU paths, a tiny UNet's forward is captured in
  ``n + 1`` pieces around its ``n`` GN+SiLU and attention calls and its
  backward in ``n + 1`` pieces around their backwards; the first step's
  output and gradients are the eager step's; wrappers placed on
  ``ops.sdpa``, ``ops.group_norm_silu``, ``FlashSDPA.backward`` and
  ``GroupNormSiLU.backward`` after the capture see every call of a replayed
  step, and each backward call takes the node that this step's forward call
  made;
- the tests' resize with a deterministic backward differentiates the
  UNet's bilinear resize.

On the card (marker ``cuda``, skipped without one), at the tiny config and
at psg655's widths: three graphed steps equal three eager steps bit for bit
from the same weights and generator (in both runs the UNet's bilinear
resize is differentiated by matmuls, and cuDNN runs deterministic
algorithms: the card's ``F.interpolate`` backward sums with atomics, so two
plain eager steps already differ in the leaves upstream of the decoder's
last upsample); wrappers placed after the capture see 61
forward and 61 backward calls a replayed step with the eager step's
shapes; the counters read capture 1, replay n and eager 0 over n + 1
steps; injected masks, a replaced tree, a batch shape beyond the kept keys
and no gradient run eagerly and count ``.eager``.  This file imports no
JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_train_graphs.py
"""

import collections
import contextlib
import weakref
from pathlib import Path

import pytest
import torch

from psg_tpu_torch import ops
from psg_tpu_torch.core import tree
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.core.draws import RowDraws
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import unet as unet_mod
from psg_tpu_torch.ops import cuda_build, flash_attention, fused_norm
from psg_tpu_torch.ops.flash_attention import FlashSDPA
from psg_tpu_torch.ops.fused_norm import GroupNormSiLU
from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer
from psg_tpu_torch.utils import profiling

torch.set_num_threads(1)

TINY = unet_mod.UNetSpec(latent_dim=4, text_dim=16, time_emb_dim=8, num_heads=2,
                         channels=(8, 16, 16, 16))


def _counts():
    c = profiling.counts()
    return {k: c.get(f"unet_train_graph.{k}", 0) for k in ("capture", "replay", "eager")}


def _kernel_calls(spec):
    """The GN+SiLU and attention calls of one evaluation (and so the
    backwards of a training one)."""
    blocks = unet_mod.unet_block_count(spec)
    attn_blocks = 2 * spec.blocks_per_level * sum(spec.attention_levels) + 1
    return 2 * blocks + 1, 2 * attn_blocks


def _inputs(spec, batch, device, dtype=None, seed=1, text_len=6):
    rng = torch.Generator(device=device).manual_seed(seed)
    n = spec.spatial[0]
    x = torch.randn(batch, n, n, spec.latent_dim, generator=rng, device=device)
    t = torch.randint(0, 50, (batch,), generator=rng, device=device)
    emb = torch.randn(batch, text_len, spec.text_dim, generator=rng, device=device)
    lens = torch.randint(1, text_len + 1, (batch, 1), generator=rng, device=device)
    mask = (torch.arange(text_len, device=device) < lens).long()
    if dtype is not None:
        x, emb = x.to(dtype), emb.to(dtype)
    return x, t, emb, mask


def _params(spec, device):
    p = unet_mod.unet_init(torch.Generator(device=device).manual_seed(0), spec)
    return tree.map(lambda t: t.detach().requires_grad_(True), p)


def _tiny_cfg(exp=None, corpus=None):
    cfg = Config()
    cfg.model.bert_model = "tiny-test"
    cfg.model.vae_width_scale = 0.25
    cfg.model.text_embedding_dim = 48
    cfg.model.unet_channels = (16, 24, 32, 32)
    cfg.model.num_attention_heads = 4
    cfg.model.time_emb_dim = 32
    cfg.model.num_timesteps = 50
    cfg.data.image_size = 64
    cfg.data.text_len = 32
    cfg.experiment_dir = str(exp)
    cfg.data.csv_path, cfg.data.image_dir = map(str, corpus)
    cfg.data.batch_size = 2
    cfg.data.num_workers = 2
    cfg.optimization.ema_decay = 0.99
    return cfg


def _trainer(tmp, device, name="t"):
    corpus = write_sprite_corpus(Path(tmp) / "corpus", n=12, seed=0, size=64)
    tr = DiffusionTrainer(_tiny_cfg(Path(tmp) / "exp", corpus), None, experiment_name=name,
                          device=device)
    tr._setup_fast_data()
    return tr


# -- on the CPU --------------------------------------------------------------------


def test_dropout_uniforms_draw_what_the_eager_body_draws():
    params = _params(TINY, "cpu")
    x, t, emb, mask = _inputs(TINY, 2, "cpu")
    eager_gen = torch.Generator().manual_seed(3)
    graph_gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        want = unet_mod._unet_body(params, x, t, emb, TINY, text_mask=mask, dropout=eager_gen)
        shapes = unet_mod.unet_dropout_shapes(TINY, 2)
        assert len(shapes) == unet_mod.unet_block_count(TINY)
        keep = 1.0 - TINY.attn_dropout
        masks = []
        for block in shapes:
            if block is None:
                masks.append(None)
                continue
            us = [torch.empty(s) for s in block]
            for u in us:
                torch.rand(u.shape, generator=graph_gen, out=u)
            masks.append(tuple(u < keep for u in us))
        got = unet_mod._unet_body(params, x, t, emb, TINY, text_mask=mask, dropout=masks)
    assert torch.equal(got, want)
    assert any(m is not None and not m[0].all() for m in masks)   # something dropped
    assert torch.equal(eager_gen.get_state(), graph_gen.get_state())


_REASONS = ("off the card", "dropout draws given", "row draws", "mesh", "another tree",
            "no gradient", "backward due", "keys held")


@pytest.mark.parametrize("case", _REASONS)
def test_calls_the_training_graphs_refuse_run_eagerly(tmp_path, monkeypatch, case):
    """A tiny fast step on the CPU hands the trainer's cache to the UNet;
    each case takes the eager body for its reason and counts ``.eager``."""
    tr = _trainer(tmp_path, "cpu")
    graphs = tr.unet_graphs
    reasons = []
    refusal = graphs.refusal

    def recorded(*args):
        reasons.append(refusal(*args))
        return reasons[-1]

    monkeypatch.setattr(graphs, "refusal", recorded)
    draws = None
    want = {"row draws": "dropout draws given"}.get(case, case)
    if case == "dropout draws given":
        rs = torch.Generator().manual_seed(5)
        draws = {"dropout": [None if s is None else tuple(torch.rand(x, generator=rs) < 0.95
                                                          for x in s)
                             for s in unet_mod.unet_dropout_shapes(tr.spec, 2)]}
    elif case == "row draws":
        monkeypatch.setattr(tr, "_dropout", lambda d, g: RowDraws(g, slice(0, 2), 2))
    elif case == "mesh":
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    elif case == "another tree":
        tr.state = tr._fresh_state(tr.state.params, step=0, rng=tr.state.rng)
    elif case == "no gradient":
        monkeypatch.setattr(tr, "_grads", lambda batch, draws=None: (
            torch.no_grad()(tr._loss)(tr.state.params, batch, tr.state.rng, draws)[0],
            None))
        monkeypatch.setattr(tr, "_apply_update", lambda record, grads: {"loss": record})
    elif case == "backward due":
        token = unet_mod._Due()
        graphs._due = weakref.ref(token)
    elif case == "keys held":
        for i in range(unet_mod._GRAPHS_KEPT):
            graphs._entries[("stand-in", i)] = None
    before = _counts()
    out = tr._step(tr._fast_batch(), draws=draws)
    assert torch.isfinite(torch.as_tensor(out["loss"]))
    assert reasons == [want]
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {"capture": 0, "replay": 0, "eager": 1}
    assert all(entry is None for entry in graphs._entries.values())


def test_validation_hands_no_cache(tmp_path):
    tr = _trainer(tmp_path, "cpu")
    before = _counts()
    tr.validate_fast(0)
    assert _counts() == before


def test_a_restore_binds_new_graphs_to_the_new_tree(tmp_path):
    tr = _trainer(tmp_path, "cpu")
    old = tr.unet_graphs
    assert old.params is tr.state.params and old.spec == tr.spec
    tr.state = tr._fresh_state(tr.state.params, step=0, rng=tr.state.rng)
    tr._after_restore()
    assert tr.unet_graphs is not old and tr.unet_graphs.params is tr.state.params
    assert tr.unet_graphs.leaves == tree.leaves(tr.state.params)


# -- the mechanics on the CPU, the CUDA graph calls stood in for --------------------


class _StandInGraph:
    """Records the calls ``PiecewiseGraph`` makes of a CUDA graph; a
    'captured' launch runs at once, and a replay runs nothing."""

    log = []

    def capture_begin(self, pool=None, capture_error_mode="global"):
        self.log.append("begin")

    def capture_end(self):
        self.log.append("end")

    def replay(self):
        self.log.append("replay")


class _StandInStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stand_ins(monkeypatch):
    """CUDA's graph, stream and pool calls stood in for, and the kernels'
    autograd Functions on their CPU paths (plain forwards; the flash
    backward's tensor-code version, GN+SiLU's recomputed plain version)."""
    stream = _StandInStream()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)

    def sdpa(q, k, v, *, bias=None, scale=None):
        return flash_attention.flash_sdpa_autograd(q, k, v, bias=bias, scale=scale)

    def gn_silu(params, x, num_groups, *, eps=1e-5, silu=True):
        return fused_norm.group_norm_silu_autograd(
            params, x, num_groups, eps=eps, silu=silu,
            forward_impl=lambda p, x_, g, e, s: fused_norm.group_norm_silu_plain(
                p, x_, g, eps=e, silu=s))

    monkeypatch.setattr(flash_attention, "flash_sdpa", sdpa)
    monkeypatch.setattr(fused_norm, "fused_group_norm_silu", gn_silu)
    _StandInGraph.log = []
    return _StandInGraph


def _loss_and_grads(pred, leaves):
    loss = pred.float().square().mean()
    return loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)


def test_training_graph_pieces_and_their_left_out_calls(stand_ins, monkeypatch):
    params = _params(TINY, "cpu")
    leaves = tree.leaves(params)
    x, t, emb, mask = _inputs(TINY, 2, "cpu")
    gn, attn = _kernel_calls(TINY)
    n = gn + attn
    want_loss, want_grads = _loss_and_grads(unet_mod._unet_body(
        params, x, t, emb, TINY, text_mask=mask,
        dropout=torch.Generator().manual_seed(4)), leaves)

    graphs = unet_mod.UNetTrainGraphs(params, TINY)
    profiling.reset_counts("unet_train_graph.")
    gen = torch.Generator().manual_seed(4)
    pred = graphs(x, t, emb, mask, None, gen)
    entry = graphs._entries[next(iter(graphs._entries))]
    assert len(entry.forward) == n + 1 and len(entry.forward.calls) == n
    # warm-up ran eagerly; the forward's capture: n + 1 pieces, then its replay
    assert stand_ins.log == ["begin", "end"] * (n + 1) + ["replay"] * (n + 1)
    assert graphs._due() is not None
    assert graphs.refusal(params, x, t, emb, TINY, mask, gen, None) == "backward due"
    stand_ins.log = []
    loss, grads = _loss_and_grads(pred, leaves)
    assert len(entry.backward) == n + 1 and len(entry.backward.calls) == n
    assert stand_ins.log == ["begin", "end"] * (n + 1) + ["replay"] * (n + 1)
    assert graphs._due is None and entry.made is None
    # the stand-ins ran the capture's launches eagerly: the first step's
    # loss and gradients are the eager step's, drawn from the same generator
    assert torch.equal(loss, want_loss)
    for g, w in zip(grads, want_grads):
        assert torch.equal(g, w)
    assert _counts() == {"capture": 1, "replay": 0, "eager": 0}

    # wrappers placed after the capture see every call of a replayed step;
    # each backward takes the node that this step's forward call made
    made, taken = [], []

    def watch_forward(orig):
        def wrapped(*args, **kwargs):
            out = orig(*args, **kwargs)
            made.append(out.grad_fn)
            return out
        return wrapped

    def watch_backward(orig):
        def wrapped(ctx, grad_out):
            taken.append(ctx)
            return orig(ctx, grad_out)
        return staticmethod(wrapped)

    monkeypatch.setattr(ops, "sdpa", watch_forward(ops.sdpa))
    monkeypatch.setattr(ops, "group_norm_silu", watch_forward(ops.group_norm_silu))
    monkeypatch.setattr(FlashSDPA, "backward", watch_backward(FlashSDPA.backward))
    monkeypatch.setattr(GroupNormSiLU, "backward", watch_backward(GroupNormSiLU.backward))
    captured = {id(c.out.grad_fn) for c in entry.forward.calls}
    stand_ins.log = []
    _loss_and_grads(graphs(x, t, emb, mask, None, gen), leaves)
    assert stand_ins.log == ["replay"] * 2 * (n + 1)
    assert len(made) == len(taken) == n
    assert collections.Counter(type(m).__name__ for m in made) == {
        "FlashSDPABackward": attn, "GroupNormSiLUBackward": gn}
    assert {id(m) for m in made} == {id(c) for c in taken}
    assert not captured & {id(c) for c in taken}
    assert _counts() == {"capture": 1, "replay": 1, "eager": 0}


# -- on the card -------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and run the kernels")
    cuda_build.build_all(k for k in ops.KERNELS)
    return torch.device("cuda")


PSG655 = unet_mod.UNetSpec()


def _unet_steps(spec, params, inputs, graphs, gen, steps, lr=1e-3):
    """``steps`` training steps of the UNet alone: a square loss, its
    gradients, and ``p -= lr * g`` in place.  (losses, gradients by step)."""
    leaves = tree.leaves(params)
    losses, grads = [], []
    for _ in range(steps):
        pred = unet_mod.unet_apply(params, *inputs[:3], spec, text_mask=inputs[3],
                                   dtype=torch.bfloat16, dropout=gen, graphs=graphs)
        loss, g = _loss_and_grads(pred, leaves)
        with torch.no_grad():
            torch._foreach_add_(leaves, [x.clone() for x in g], alpha=-lr)
        losses.append(loss)
        grads.append([x.clone() for x in g])
    torch.cuda.synchronize()
    return losses, grads


def _interpolation(n, m, device):
    """[m, n]: the half-pixel linear interpolation from n to m points."""
    eye = torch.eye(n, device=device)[None]
    return torch.nn.functional.interpolate(eye, size=m, mode="linear",
                                           align_corners=False)[0].t()


class _ResizeByMatmuls(torch.autograd.Function):
    """``bilinear_resize`` forward; backward by matmuls with the
    interpolation matrices, in fp32, deterministic (the card's
    ``F.interpolate`` backward sums with atomics)."""

    @staticmethod
    def forward(ctx, x, size, resize):
        ctx.hw = x.shape[1:3]
        ctx.size = tuple(size)
        return resize(x, size)

    @staticmethod
    def backward(ctx, gy):
        (h, w), (m, n) = ctx.hw, ctx.size
        ah, aw = _interpolation(h, m, gy.device), _interpolation(w, n, gy.device)
        gx = torch.einsum("mh,bmnc,nw->bhwc", ah, gy.float(), aw)
        return gx.to(gy.dtype), None, None


@pytest.fixture
def deterministic(monkeypatch):
    """Two eager steps on the card differ in most gradient leaves: the
    bilinear resize's backward (``F.interpolate``) sums with atomics. For a
    bit-for-bit comparison, the graphed and the eager runs alike take
    ``_ResizeByMatmuls`` in the UNet (the same forward) and cuDNN's
    deterministic algorithms."""
    resize = unet_mod.bilinear_resize
    monkeypatch.setattr(unet_mod, "bilinear_resize",
                        lambda x, size: _ResizeByMatmuls.apply(x, size, resize))
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)


def test_resize_by_matmuls_differentiates_the_resize():
    x = torch.randn(2, 7, 7, 5, dtype=torch.float64, requires_grad=True)
    gy = torch.randn(2, 14, 14, 5, dtype=torch.float64)
    resize = unet_mod.bilinear_resize
    want = torch.autograd.grad(resize(x, (14, 14)), x, gy)[0]
    y = _ResizeByMatmuls.apply(x, (14, 14), resize)
    assert torch.equal(y, resize(x, (14, 14)))
    got = torch.autograd.grad(y, x, gy)[0]
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, (list, tuple)):
            _assert_same(x, y)
        else:
            assert torch.equal(x, y), float((x.float() - y.float()).abs().max())


@pytest.mark.cuda
def test_graphed_fast_steps_equal_eager_steps(card, tmp_path, deterministic):
    """The tiny trainer: three fast steps with the graphs and three without,
    from the same weights and generator: each step's loss and every
    gradient leaf, then the parameters and the EMA, bit for bit."""
    runs = []
    for name, use in (("graphed", True), ("eager", False)):
        tr = _trainer(tmp_path / name, "cuda", name)
        if not use:
            tr.unet_graphs = None
        losses, grads = [], []
        profiling.reset_counts("unet_train_graph.")
        for _ in range(3):
            record, g = tr._grads(tr._fast_batch())
            losses.append(record)
            grads.append([x.clone() for x in tree.leaves(g)])
            tr._apply_update(record, g)
        counts = _counts()
        runs.append((losses, grads, tree.leaves(tr.state.params), tree.leaves(tr.state.ema)))
        assert counts == ({"capture": 1, "replay": 2, "eager": 0} if use
                          else {"capture": 0, "replay": 0, "eager": 0})
    (gl, gg, gp, ge), (el, eg, ep, ee) = runs
    _assert_same(gl, el)
    _assert_same(gg, eg)
    _assert_same([p.detach() for p in gp], [p.detach() for p in ep])
    _assert_same(ge, ee)


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["tiny", "psg655"])
def test_graphed_unet_steps_equal_eager_ones(card, width, deterministic):
    spec = TINY if width == "tiny" else PSG655
    batch, text_len = (2, 6) if width == "tiny" else (2, 128)
    inputs = _inputs(spec, batch, "cuda", torch.bfloat16, text_len=text_len)
    out = []
    for use in (True, False):
        params = _params(spec, "cuda")
        graphs = unet_mod.UNetTrainGraphs(params, spec) if use else None
        gen = torch.Generator(device="cuda").manual_seed(9)
        profiling.reset_counts("unet_train_graph.")
        out.append(_unet_steps(spec, params, inputs, graphs, gen, 3)
                   + (tree.leaves(params), gen.get_state()))
        if use:
            assert _counts() == {"capture": 1, "replay": 2, "eager": 0}
        del params, graphs
    (gl, gg, gp, gs), (el, eg, ep, es) = out
    _assert_same(gl, el)
    _assert_same(gg, eg)
    _assert_same([p.detach() for p in gp], [p.detach() for p in ep])
    assert torch.equal(gs, es)


@pytest.mark.cuda
@pytest.mark.parametrize("width", ["tiny", "psg655"])
def test_replays_call_the_four_entry_points(card, monkeypatch, width):
    """Wrappers placed after the capture see, a replayed step, each forward
    and backward call with the eager step's shapes."""
    spec = TINY if width == "tiny" else PSG655
    batch, text_len = (2, 6) if width == "tiny" else (2, 128)
    inputs = _inputs(spec, batch, "cuda", torch.bfloat16, text_len=text_len)
    params = _params(spec, "cuda")
    graphs = unet_mod.UNetTrainGraphs(params, spec)
    gen = torch.Generator(device="cuda").manual_seed(9)
    _unet_steps(spec, params, inputs, graphs, gen, 1)      # captures
    seen = collections.defaultdict(list)

    def shapes(args):
        return tuple(tuple(a.shape) for a in args if isinstance(a, torch.Tensor))

    def watch(name, orig):
        def wrapped(*args, **kwargs):
            seen[name].append(shapes(args))
            return orig(*args, **kwargs)
        return wrapped

    def watch_backward(name, orig):
        def wrapped(ctx, grad_out):
            seen[name].append(shapes(ctx.saved_tensors) + (tuple(grad_out.shape),))
            return orig(ctx, grad_out)
        return staticmethod(wrapped)

    monkeypatch.setattr(ops, "sdpa", watch("sdpa", ops.sdpa))
    monkeypatch.setattr(ops, "group_norm_silu", watch("gn", ops.group_norm_silu))
    monkeypatch.setattr(FlashSDPA, "backward", watch_backward("attn.bwd", FlashSDPA.backward))
    monkeypatch.setattr(GroupNormSiLU, "backward",
                        watch_backward("gn.bwd", GroupNormSiLU.backward))
    profiling.reset_counts("unet_train_graph.")
    _unet_steps(spec, params, inputs, graphs, gen, 2)
    assert _counts() == {"capture": 0, "replay": 2, "eager": 0}
    replayed = dict(seen)
    seen.clear()
    _unet_steps(spec, params, inputs, None, gen, 2)
    gn, attn = _kernel_calls(spec)
    assert gn + attn == 61
    assert {k: len(v) for k, v in replayed.items()} == {
        "sdpa": 2 * attn, "gn": 2 * gn, "attn.bwd": 2 * attn, "gn.bwd": 2 * gn}
    assert replayed == dict(seen)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["masks", "another tree", "shapes beyond the kept keys",
                                  "no gradient"])
def test_training_graphs_leave_other_calls_eager(card, case):
    spec = TINY
    params = _params(spec, "cuda")
    graphs = unet_mod.UNetTrainGraphs(params, spec)
    inputs = _inputs(spec, 2, "cuda", torch.bfloat16)
    if case == "shapes beyond the kept keys":
        gen = torch.Generator(device="cuda").manual_seed(9)
        for b in range(1, unet_mod._GRAPHS_KEPT + 1):
            _unet_steps(spec, params, _inputs(spec, b + 2, "cuda", torch.bfloat16),
                        graphs, gen, 1)
        assert len(graphs) == unet_mod._GRAPHS_KEPT
    dropout, tree_ = None, params
    if case == "masks":
        dropout = [None if s is None else tuple(torch.rand(x, device="cuda") < 0.95
                                                for x in s)
                   for s in unet_mod.unet_dropout_shapes(spec, 2)]
    elif case == "another tree":
        tree_ = dict(params)

    def call(cache):
        with torch.set_grad_enabled(case != "no gradient"):
            return unet_mod.unet_apply(tree_, *inputs[:3], spec, text_mask=inputs[3],
                                       dtype=torch.bfloat16, dropout=dropout, graphs=cache)

    want = call(None)
    held = len(graphs)
    profiling.reset_counts("unet_train_graph.")
    got = call(graphs)
    assert torch.equal(got, want)
    assert _counts() == {"capture": 0, "replay": 0, "eager": 1}
    assert len(graphs) == held
