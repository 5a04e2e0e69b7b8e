"""psg_tpu_torch's spans and counters (``utils/profiling.py``) on the CPU,
and on the card where there is one.

- the off path: one shared no-op object and no ``record_function`` call;
- under a CPU ``torch.profiler`` session the trace holds the ``psg.*``
  ranges, nested as the program opens them;
- ``span_table`` on a made-up trace: device time and launch calls by the
  launches made (on any thread) while a span was open, a graph's launch
  once, idle time to the innermost span;
- a tiny DPM++ request with one restart, and a tiny fast-path stage-2 step:
  the spans each makes, and the step's one host read;
- ``ops.launch_counts`` keeps its keys and meaning;
- spans change no number: a request's image is the same profiled or not;
- ``utils.graphs`` with the CUDA graph calls stood in for: a tiny UNet
  captured in pieces leaves out each GN+SiLU and attention call and, at
  replay, calls them through the names they have then.

The card tests (marker ``cuda``) skip without a CUDA device: over one fast
step the syncs ``torch.cuda.set_sync_debug_mode`` reports equal the
``host_reads`` counted, and a profiled request holds one ``psg.unet.eval``
range an evaluation, each a graph replay of 3n + 6 calls for its n
hand-written kernel calls.  The UNet's CUDA graphs
(``models.unet.UNetGraphs``): a graphed request equals the eager one bit
for bit and captures once; a replay calls the kernels' entry points, so a
wrapper placed on them after the capture sees every call and its launch;
replays keep earlier outputs intact; a second batch shape captures a second
graph, and one shape more than the cache holds evicts the least recently
used; threads sharing one cache each get their own output; another tree, a
gradient or dropout runs eagerly and counts ``unet_graph.eager``.  This
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py
"""

import collections
import contextlib
import json
import os
import sys
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from psg_tpu_torch import ops
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import unet as unet_mod
from psg_tpu_torch.models.unet import unet_apply
from psg_tpu_torch.ops import cuda_build
from psg_tpu_torch.serve.generator import PokemonGenerator
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer
from psg_tpu_torch.utils import graphs as graphs_mod
from psg_tpu_torch.utils import profiling

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

VOCAB = Path(__file__).resolve().parent.parent / "experiments/evidence_r5c_vae/vocab.txt"
STEPS = 3
LEVELS = ("enc0", "enc1", "enc2", "enc3", "mid", "dec3", "dec2", "dec1", "dec0")


def _tiny(exp=None, corpus=None):
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
    if exp is not None:
        cfg.experiment_dir = str(exp)
        cfg.data.csv_path, cfg.data.image_dir = map(str, corpus)
        cfg.data.batch_size = 2
        cfg.data.num_workers = 2
        cfg.optimization.ema_decay = 0.99
    return cfg


def _generator(device):
    return PokemonGenerator(_tiny(), tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                            sampler="dpmpp", guidance_scale=2.0,
                            negative="blurry low quality", device=device)


def _request(gen):
    return gen.generate_from_text("a small green creature with leaves",
                                  num_inference_steps=STEPS, seed=7, restarts=1)


def _trainer(tmp, device):
    corpus = write_sprite_corpus(Path(tmp) / "corpus", n=12, seed=0, size=64)
    tr = DiffusionTrainer(_tiny(Path(tmp) / "exp", corpus), None, experiment_name="t",
                          device=device)
    tr._setup_fast_data()
    return tr


def _profiled(fn, path, cuda=False):
    """``fn()`` under a ``torch.profiler`` session: (name, start, end) of the
    ``psg.*`` ranges in its exported trace, and its ``span_table``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        fn()
    table = profiling.profile_spans(prof, path)
    ranges = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
              for e in json.loads(Path(path).read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e["name"].startswith("psg.")]
    return ranges, table


def _parents(ranges):
    """Each range's innermost enclosing range's name (``None`` for none), by
    the range's index."""
    out = []
    for i, (_, s, e) in enumerate(ranges):
        around = [r for j, r in enumerate(ranges)
                  if j != i and r[1] <= s and e <= r[2] and (r[1], -r[2]) < (s, -e)]
        out.append(max(around, key=lambda r: r[1])[0] if around else None)
    return out


@pytest.fixture(scope="module")
def gen():
    return _generator("cpu")


# -- spans and counters -----------------------------------------------------------

def test_off_path_is_one_shared_object_and_calls_no_record_function(monkeypatch):
    calls = []
    monkeypatch.setattr(profiling, "_record_function",
                        lambda name: calls.append(name) or torch.profiler.record_function(name))
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.span("psg.a"), profiling.span("psg.b")
    assert first is second
    with first:
        with second:
            pass
    assert calls == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("psg.c"):
            pass
    assert calls == ["psg.c"]


def test_spans_nest_in_the_profiler_trace(tmp_path):
    def nested():
        with profiling.span("psg.a"):
            with profiling.span("psg.b"):
                with profiling.span("psg.c"):
                    time.sleep(0.002)
            with profiling.span("psg.d"):
                pass
        with profiling.span("psg.e"):
            pass

    ranges, table = _profiled(nested, tmp_path / "t.json")
    parent = dict(zip((r[0] for r in ranges), _parents(ranges)))
    assert parent == {"psg.a": None, "psg.b": "psg.a", "psg.c": "psg.b",
                      "psg.d": "psg.a", "psg.e": None}
    assert {k: v["count"] for k, v in table.items()} == dict.fromkeys(parent, 1)
    assert table["psg.c"]["host_ms"] >= 2.0
    assert table["psg.a"]["device_ms"] == table["psg.a"]["calls"] == 0


def _ev(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_span_table_of_a_made_up_trace():
    events = [
        _ev("user_annotation", "psg.eval", 100, 300),
        _ev("user_annotation", "psg.level", 120, 100),
        _ev("user_annotation", "psg.eval", 600, 100),
        _ev("user_annotation", "bench.unet", 100, 300),     # not the program's
        _ev("cuda_runtime", "cudaLaunchKernel", 130, 5, corr=1),
        _ev("cuda_runtime", "cudaGraphLaunch", 150, 5, corr=2),          # three kernels
        _ev("cuda_runtime", "cudaStreamSynchronize", 160, 5, corr=3),    # no device work
        _ev("cuda_driver", "cuLaunchKernel", 300, 5, tid=3, corr=4),     # another thread
        _ev("cuda_runtime", "cudaLaunchKernel", 500, 5, corr=5),         # outside
        _ev("kernel", "k1", 140, 30, tid=7, corr=1),
        *[_ev("kernel", f"g{i}", 170 + 10 * i, 10, tid=7, corr=2) for i in range(3)],
        _ev("gpu_memcpy", "Memcpy HtoD", 310, 40, tid=7, corr=4),
        _ev("kernel", "k5", 550, 100, tid=7, corr=5),
    ]
    t = profiling.span_table(events)
    assert set(t) == {"psg.eval", "psg.level"}
    assert t["psg.eval"]["count"] == 2 and t["psg.level"]["count"] == 1
    assert t["psg.eval"]["host_ms"] == pytest.approx((300 + 100) / 2 / 1e3)
    # k1, the graph's three kernels and the other thread's copy: 100 us in
    # 3 calls over 2 spans; the level holds k1 and the graph
    assert t["psg.eval"]["device_ms"] == pytest.approx(100 / 2 / 1e3)
    assert t["psg.eval"]["calls"] == 1.5
    assert t["psg.level"]["device_ms"] == pytest.approx(60 / 1e3)
    assert t["psg.level"]["calls"] == 2
    # busy 140-200, 310-350, 550-650 between 100 and 700: the gap 100-140
    # is the level's, 200-310 (middle 255) and 650-700 the evals', 350-550
    # (middle 450) no span's
    assert t["psg.level"]["idle_ms"] == pytest.approx(40 / 1e3)
    assert t["psg.eval"]["idle_ms"] == pytest.approx((110 + 50) / 2 / 1e3)
    assert profiling.span_table([e for e in events if "psg." not in e["name"]]) == {}


def test_profile_spans_keeps_the_trace_only_at_its_path(tmp_path, monkeypatch):
    monkeypatch.setattr(profiling.tempfile, "tempdir", str(tmp_path / "tmp"))
    (tmp_path / "tmp").mkdir()
    kept = tmp_path / "kept.json"
    for path in (None, kept):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with profiling.span("psg.a"):
                pass
        assert profiling.profile_spans(prof, path)["psg.a"]["count"] == 1
        assert list((tmp_path / "tmp").rglob("trace.json")) == []
    assert "psg.a" in kept.read_text()


def test_counters():
    profiling.reset_counts()
    profiling.count("test.x")
    profiling.count("test.x", 4)
    profiling.count("launch.test", 2)
    got = profiling.counts()
    assert (got["test.x"], got["launch.test"]) == (5, 2)
    profiling.reset_counts("launch.")
    got = profiling.counts()
    assert (got["test.x"], got["launch.test"]) == (5, 0)
    profiling.reset_counts()
    assert set(profiling.counts().values()) == {0}


def test_launch_counts_keep_their_keys_and_meaning():
    names = ["group_norm_silu", "flash_attention", "spatial_xattn", "flash_attention_bwd"]
    ops.reset_launch_counts()
    assert ops.launch_counts() == {k: 0 for k in names}
    profiling.count(profiling.HOST_READS)
    reads = profiling.counts()[profiling.HOST_READS]
    lib = ops.flash_attention.KERNEL
    lib.check(0)
    lib.check(0)
    assert ops.launch_counts() == dict({k: 0 for k in names}, flash_attention=2)
    assert lib.launches == 2 and profiling.counts()["launch.flash_attention"] == 2
    ops.reset_launch_counts()
    assert ops.launch_counts() == {k: 0 for k in names}
    assert profiling.counts()[profiling.HOST_READS] == reads


# -- the serving chain and the training step --------------------------------------

def test_dpmpp_request_with_one_restart(gen, tmp_path):
    ranges, table = _profiled(lambda: _request(gen), tmp_path / "t.json")
    evals = STEPS * 2
    n = {k: v["count"] for k, v in table.items()}
    assert n["psg.serve.request"] == 1
    assert n["psg.serve.sampler"] == n["psg.serve.text"] == n["psg.serve.vae_decode"] == 2
    assert n["psg.serve.vae_encode"] == 1
    assert n["psg.unet.eval"] == evals
    assert all(n[f"psg.unet.{lvl}"] == evals for lvl in LEVELS)
    for (name, _, _), parent in zip(ranges, _parents(ranges)):
        if name == "psg.unet.eval":
            assert parent == "psg.serve.sampler"
        elif name.startswith("psg.unet."):
            assert parent == "psg.unet.eval"
        elif name != "psg.serve.request":
            assert parent == "psg.serve.request", name


def test_spans_change_no_number(gen):
    plain = np.asarray(_request(gen))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        profiled = np.asarray(_request(gen))
    np.testing.assert_array_equal(profiled, plain)


def test_profiler_trace_holds_the_request_ranges(gen, tmp_path):
    ranges, _ = _profiled(lambda: _request(gen), tmp_path / "t.json")
    (req,) = [r for r in ranges if r[0] == "psg.serve.request"]
    inner = [r for r in ranges if r is not req]
    assert all(req[1] <= s and e <= req[2] for _, s, e in inner)
    n = collections.Counter(name for name, _, _ in inner)
    assert n["psg.unet.eval"] == STEPS * 2 and n["psg.serve.sampler"] == 2
    assert n["psg.serve.text"] == n["psg.serve.vae_decode"] == 2
    assert n["psg.serve.vae_encode"] == 1
    assert all(n[f"psg.unet.{lvl}"] == STEPS * 2 for lvl in LEVELS)


def test_fast_step_spans_and_one_host_read(tmp_path):
    tr = _trainer(tmp_path, "cpu")
    reads = profiling.counts().get(profiling.HOST_READS, 0)
    ranges, _ = _profiled(lambda: tr._step(tr._fast_batch()), tmp_path / "t.json")
    assert profiling.counts()[profiling.HOST_READS] == reads + 1
    parents = _parents(ranges)
    parent = {name: p for (name, _, _), p in zip(ranges, parents)
              if not name.startswith("psg.unet.")}
    assert parent == {"psg.train.fast_batch": None, "psg.train.step": None,
                      "psg.train.grads": "psg.train.step",
                      "psg.train.forward": "psg.train.grads",
                      "psg.train.backward": "psg.train.grads",
                      "psg.train.optimizer": "psg.train.step",
                      "psg.optim.stats": "psg.train.optimizer",
                      "psg.optim.adam": "psg.train.optimizer",
                      "psg.train.ema": "psg.train.optimizer"}
    n = collections.Counter(name for name, _, _ in ranges)
    assert n["psg.unet.eval"] == 1 and all(n[f"psg.unet.{lvl}"] == 1 for lvl in LEVELS)
    (i,) = [i for i, r in enumerate(ranges) if r[0] == "psg.unet.eval"]
    assert parents[i] == "psg.train.forward"


# -- pieces of a CUDA graph, the CUDA calls stood in for ------------------------

class _StandInGraph:
    """Records the calls ``PiecewiseGraph`` makes of a CUDA graph."""

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


def test_eager_between_passes_calls_on_outside_a_capture():
    assert ops.sdpa.__wrapped__.__name__ == "sdpa"
    assert ops.group_norm_silu.__wrapped__.__name__ == "group_norm_silu"
    q = torch.randn(1, 2, 5, 8)
    assert torch.equal(ops.sdpa(q, q, q), ops.sdpa.__wrapped__(q, q, q))


def test_piecewise_capture_leaves_the_kernel_calls_out(monkeypatch):
    """On the CPU a stood-in capture runs every launch at once, so the
    output is the eager one; the pieces and the calls between them follow
    the UNet's structure, and a replay calls ``ops.sdpa`` and
    ``ops.group_norm_silu`` by the names they have at that moment."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandInGraph)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _StandInStream())
    _StandInGraph.log = []
    spec = unet_mod.UNetSpec(latent_dim=4, text_dim=16, time_emb_dim=8, num_heads=2,
                             channels=(8, 16, 16, 16))
    params = unet_mod.unet_init(torch.Generator().manual_seed(0), spec)
    rng = torch.Generator().manual_seed(1)
    x = torch.randn(2, 27, 27, 4, generator=rng)
    t = torch.tensor([3, 5], dtype=torch.int32)
    emb = torch.randn(2, 6, 16, generator=rng)
    mask = torch.tensor([[1] * 6, [1] * 3 + [0] * 3])

    def body():
        return unet_mod._unet_body(params, x, t, emb, spec, text_mask=mask)

    with torch.no_grad():
        want = body()
        graph = graphs_mod.PiecewiseGraph(None)
        out = graph.capture(body, _StandInStream())
        assert torch.equal(out, want)
        gn, attn = _kernel_calls(spec)
        assert len(graph) == gn + attn + 1
        assert _StandInGraph.log == ["begin", "end"] * (gn + attn + 1)
        seen = collections.Counter()
        for name in ("sdpa", "group_norm_silu"):
            orig = getattr(ops, name)
            monkeypatch.setattr(ops, name, lambda *a, _n=name, _o=orig, **k: (
                seen.update([_n]), _o(*a, **k))[1])
        _StandInGraph.log = []
        out.zero_()
        graph.replay()
    assert _StandInGraph.log == ["replay"] * (gn + attn + 1)
    assert seen == {"sdpa": attn, "group_norm_silu": gn}
    # the last piece, which made the output, was not run: only its calls were
    assert not out.any()


# -- on the card ---------------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (and nvcc) to build and run the kernels")
    cuda_build.build_all(k for k in ops.KERNELS)
    return torch.device("cuda")


@pytest.mark.cuda
def test_syncs_of_a_fast_step_are_its_host_reads(card, tmp_path):
    tr = _trainer(tmp_path, "cuda")
    tr._step(tr._fast_batch())    # the first step's one-off work
    torch.cuda.synchronize()
    reads = profiling.counts().get(profiling.HOST_READS, 0)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            tr._step(tr._fast_batch())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if "synchronizing" in str(w.message)]
    assert len(syncs) == profiling.counts()[profiling.HOST_READS] - reads == 1, \
        [str(w.message) for w in syncs]


@pytest.mark.cuda
def test_profiled_request_has_one_unet_range_an_evaluation(card, tmp_path):
    gen = _generator("cuda")
    _request(gen)
    _, table = _profiled(lambda: _request(gen), tmp_path / "t.json", cuda=True)
    assert table["psg.unet.eval"]["count"] == STEPS * 2
    assert table["psg.serve.request"]["count"] == 1
    assert table["psg.unet.eval"]["device_ms"] > 0 and table["psg.unet.eval"]["calls"] > 0
    # every evaluation replays the graph the first request captured: 4
    # input copies, n + 1 pieces, each of the n hand-written kernel calls
    # between them and the copy of its output, the output's clone; no level
    # span
    gn, attn = _kernel_calls(gen.spec)
    assert table["psg.unet.eval"]["calls"] == 3 * (gn + attn) + 6
    assert not any(f"psg.unet.{lvl}" in table for lvl in LEVELS)


# -- the UNet's CUDA graphs ----------------------------------------------------------

def _graph_counts():
    c = profiling.counts()
    return {k: c.get(f"unet_graph.{k}", 0) for k in ("capture", "replay", "eager")}


def _unet_inputs(gen, batch, seed):
    """A UNet call's inputs at the generator's sizes and dtype, from ``seed``."""
    rng = torch.Generator(device=gen.device).manual_seed(seed)
    dt = gen.compute_dtype or torch.float32
    cfg, ls = gen.cfg, gen.latent_size
    x = torch.randn((batch, ls, ls, cfg.model.latent_dim), generator=rng,
                    device=gen.device).to(dt)
    t = torch.randint(0, cfg.model.num_timesteps, (batch,), generator=rng,
                      device=gen.device, dtype=torch.int32)
    emb = torch.randn((batch, cfg.data.text_len, cfg.model.text_embedding_dim),
                      generator=rng, device=gen.device).to(dt)
    lens = torch.randint(1, cfg.data.text_len + 1, (batch, 1), generator=rng,
                         device=gen.device)
    mask = (torch.arange(cfg.data.text_len, device=gen.device) < lens).long()
    return x, t, emb, mask


def _kernel_calls(spec):
    """The GN+SiLU and attention calls of one UNet evaluation: two norms a
    ResBlock and the final one; self and cross attention a block with
    attention."""
    blocks = 2 * len(spec.channels) * spec.blocks_per_level + 1
    attn_blocks = 2 * spec.blocks_per_level * sum(spec.attention_levels) + 1
    return 2 * blocks + 1, 2 * attn_blocks


def _unet(gen, inputs, graphs=None, params=None, dropout=None):
    x, t, emb, mask = inputs
    return unet_apply(gen.params["unet"] if params is None else params, x, t, emb,
                      gen.spec, text_mask=mask, dtype=gen.compute_dtype, dropout=dropout,
                      graphs=graphs)


@pytest.mark.cuda
def test_graphed_request_equals_the_eager_one(card):
    """A DPM++ request with fused CFG and one restart: the first captures
    one graph, the second replays it at every evaluation, and both images
    equal the request's with the cache taken away."""
    gen = _generator("cuda")

    def request():
        return torch.from_numpy(gen.generate_batch(
            ["a small green creature with leaves"], STEPS, seed=7, restarts=1))

    profiling.reset_counts("unet_graph.")
    first = request()
    assert _graph_counts() == {"capture": 1, "replay": 2 * STEPS - 1, "eager": 0}
    profiling.reset_counts("unet_graph.")
    second = request()
    assert _graph_counts() == {"capture": 0, "replay": 2 * STEPS, "eager": 0}
    assert len(gen.unet_graphs) == 1
    graphs, gen.unet_graphs = gen.unet_graphs, None
    eager = request()
    gen.unet_graphs = graphs
    assert torch.equal(first, eager) and torch.equal(second, eager)


@pytest.mark.cuda
def test_replays_call_the_kernels_entry_points(card, monkeypatch):
    """Wrappers placed on ``ops.sdpa`` and ``ops.group_norm_silu`` after the
    capture see each call of a replay, whose kernels launch inside them."""
    gen = _generator("cuda")
    inputs = _unet_inputs(gen, 2, 0)
    with torch.no_grad():
        want = _unet(gen, inputs)
        _unet(gen, inputs, gen.unet_graphs)     # captures
        seen = collections.Counter()

        def watch(name, orig):
            def wrapped(*args, **kwargs):
                before = ops.launch_counts()
                out = orig(*args, **kwargs)
                seen[name] += 1
                seen["launches"] += sum(ops.launch_counts().values()) - sum(before.values())
                return out
            return wrapped

        monkeypatch.setattr(ops, "sdpa", watch("sdpa", ops.sdpa))
        monkeypatch.setattr(ops, "group_norm_silu",
                            watch("group_norm_silu", ops.group_norm_silu))
        profiling.reset_counts("unet_graph.")
        got = [_unet(gen, inputs, gen.unet_graphs) for _ in range(2)]
    assert _graph_counts() == {"capture": 0, "replay": 2, "eager": 0}
    gn, attn = _kernel_calls(gen.spec)
    assert seen == {"sdpa": 2 * attn, "group_norm_silu": 2 * gn,
                    "launches": 2 * (gn + attn)}
    assert all(torch.equal(g, want) for g in got)


@pytest.mark.cuda
def test_graph_replays_keep_their_outputs_and_shapes_their_graphs(card):
    gen = _generator("cuda")
    graphs = gen.unet_graphs
    a, b, four = _unet_inputs(gen, 2, 0), _unet_inputs(gen, 2, 1), _unet_inputs(gen, 4, 2)
    with torch.no_grad():
        want_a, want_b, want_four = (_unet(gen, ins) for ins in (a, b, four))
        profiling.reset_counts("unet_graph.")
        got = [_unet(gen, ins, graphs) for ins in (a, b, a)]
        assert _graph_counts() == {"capture": 1, "replay": 2, "eager": 0}
        # each output its own: the replays after it left it as it was
        assert torch.equal(got[0], want_a) and torch.equal(got[1], want_b)
        assert torch.equal(got[2], want_a)
        assert len(graphs) == 1
        assert torch.equal(_unet(gen, four, graphs), want_four)
        assert torch.equal(_unet(gen, b, graphs), want_b)
    assert _graph_counts() == {"capture": 2, "replay": 3, "eager": 0}
    assert len(graphs) == 2


@pytest.mark.cuda
def test_graphs_keep_the_latest_shapes(card):
    """One shape more than the cache holds evicts the least recently used,
    which captures again at its next call; the others replay."""
    gen = _generator("cuda")
    graphs, kept = gen.unet_graphs, unet_mod._GRAPHS_KEPT
    shapes = [_unet_inputs(gen, b, b) for b in range(1, kept + 2)]
    with torch.no_grad():
        want = [_unet(gen, ins) for ins in shapes]
        profiling.reset_counts("unet_graph.")
        for ins in shapes:
            _unet(gen, ins, graphs)
        assert len(graphs) == kept
        assert torch.equal(_unet(gen, shapes[-1], graphs), want[-1])
        assert _graph_counts() == {"capture": kept + 1, "replay": 1, "eager": 0}
        assert torch.equal(_unet(gen, shapes[0], graphs), want[0])
    assert _graph_counts() == {"capture": kept + 2, "replay": 1, "eager": 0}
    assert len(graphs) == kept


@pytest.mark.cuda
def test_threads_sharing_the_graphs_keep_their_own_outputs(card):
    """More threads than cores replay one cache, switching every
    microsecond: each output equals its own inputs' eager one, which an
    interleaving of copy-in, replay and copy-out would break."""
    gen = _generator("cuda")
    graphs = gen.unet_graphs
    n_threads, rounds = 2 * (os.cpu_count() or 1) + 2, 4
    inputs = [_unet_inputs(gen, 2, seed) for seed in range(n_threads)]
    with torch.no_grad():
        want = [_unet(gen, ins) for ins in inputs]
        _unet(gen, inputs[0], graphs)          # capture before the threads start
    got = [[] for _ in range(n_threads)]
    errors = []

    def worker(i):
        try:
            with torch.no_grad():
                for _ in range(rounds):
                    got[i].append(_unet(gen, inputs[i], graphs))
        except Exception as e:   # reported below: a thread's error is not raised
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    torch.cuda.synchronize()
    for outs, w in zip(got, want):
        assert len(outs) == rounds and all(torch.equal(o, w) for o in outs)
    assert len(graphs) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["another tree", "gradient", "dropout"])
def test_graphs_leave_other_calls_eager(card, case):
    gen = _generator("cuda")
    inputs = _unet_inputs(gen, 2, 0)
    tree = dict(gen.params["unet"]) if case == "another tree" else None

    def call(graphs):
        drop = (torch.Generator(device="cuda").manual_seed(5) if case == "dropout"
                else None)
        with torch.set_grad_enabled(case == "gradient"):
            return _unet(gen, inputs, graphs, params=tree, dropout=drop)

    want = call(None)
    profiling.reset_counts("unet_graph.")
    got = call(gen.unet_graphs)
    assert torch.equal(got, want)
    assert _graph_counts() == {"capture": 0, "replay": 0, "eager": 1}
    assert len(gen.unet_graphs) == 0
