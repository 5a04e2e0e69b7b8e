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
- spans change no number: a request's image is the same profiled or not.

The card tests (marker ``cuda``) skip without a CUDA device: over one fast
step the syncs ``torch.cuda.set_sync_debug_mode`` reports equal the
``host_reads`` counted, and a profiled request holds one ``psg.unet.eval``
range an evaluation.  This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_tracing.py
"""

import collections
import json
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from psg_tpu_torch import ops
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.ops import cuda_build
from psg_tpu_torch.serve.generator import PokemonGenerator
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer
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
