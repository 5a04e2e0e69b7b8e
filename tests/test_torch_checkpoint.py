"""The port's async checkpoint writes (``psg_tpu_torch/core/checkpoint.py``)
against the JAX package's (``psg_tpu/core/checkpoint.py``), on the CPU with
small trees.

- The writer's bytes are msgpack's own encoding of the tree (an independent
  ``msgpack.packb`` here, and flax's for a sorted tree), across the header
  sizes, for arrays written from their buffer as well.
- An async file equals the sync file of the same state byte for byte, also
  when the state is updated in place while the write is in flight (the
  snapshot owns its memory), and JAX's ``load_params`` and
  ``load_sample_params`` read it; the port reads a JAX async file.
- A background write's error comes back once, as ``RuntimeError`` chained
  from it, at the next save, wait or read, with no ``.tmp`` left and the
  old file whole; a sync write's error raises at once (JAX defers it).
- Rotation with writes in flight keeps ``keep`` files (JAX keeps one more).
- ``PSG_TPU_ASYNC_CKPT`` is read as the JAX manager reads it.
- Readers, the CLI's stage hand-off and a trainer's ``train()`` wait for a
  write in flight; interpreter exit leaves a whole file.
"""

import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from psg_tpu.core import checkpoint as jax_ckpt
from psg_tpu_torch.core import checkpoint as ckpt
from psg_tpu_torch.core import tree
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.models import bridge
from psg_tpu_torch.train.optim import build_optimizer
from psg_tpu_torch.train.state import TrainState

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
HOLD_S = 30      # the longest a held write waits for its release


@pytest.fixture(autouse=True)
def _no_write_left():
    """Every test starts and ends with no write in flight and no error."""
    ckpt.wait_for_writes()
    jax_ckpt.wait_for_writes()
    yield
    ckpt.wait_for_writes()
    jax_ckpt.wait_for_writes()


def _in_background() -> bool:
    return threading.current_thread() is not threading.main_thread()


@pytest.fixture
def held(monkeypatch):
    """Background writes of either package wait for a permit
    (``held.release()``) before they write; sync writes go through."""
    permits = threading.Semaphore(0)

    def hold():
        if _in_background() and not permits.acquire(timeout=HOLD_S):
            raise TimeoutError("held write never released")

    write_files = ckpt._write_files
    to_bytes = jax_ckpt.serialization.to_bytes

    def port_write(*a, **k):
        hold()
        return write_files(*a, **k)

    def jax_write(x):
        hold()
        return to_bytes(x)

    monkeypatch.setattr(ckpt, "_write_files", port_write)
    monkeypatch.setattr(jax_ckpt.serialization, "to_bytes", jax_write)
    yield permits
    permits.release(8)


def _release_later(permits, delay=0.3):
    threading.Timer(delay, permits.release).start()


# ---------------------------------------------------------------------------
# a small train state: a conv kernel, a dense layer past 64 KiB (written from
# its buffer), a list, a bf16 first moment, the EMA and the generator
# ---------------------------------------------------------------------------


def _params(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"conv": {"w": torch.randn(8, 4, 3, 3, generator=g),
                     "b": torch.randn(8, generator=g)},
            "dense": {"w": torch.randn(300, 70, generator=g),
                      "b": torch.randn(70, generator=g)},
            "layers": [{"scale": torch.rand(16, generator=g) + 0.5} for _ in range(3)]}


def _train_state(seed: int = 0) -> TrainState:
    opt_cfg = Config().optimization
    opt_cfg.mu_dtype = "bfloat16"
    params = _params(seed)
    tx = build_optimizer(opt_cfg, {"all": {"lr_schedule": lambda n: 1e-2,
                                           "max_grad_norm": 1.0}},
                         tree.map(lambda _: "all", params))
    state = TrainState(0, params, tx.init(params), torch.Generator().manual_seed(seed),
                       ema=tree.map(lambda t: t.clone(), params))
    state.tx = tx
    _step(state, seed)
    return state


def _step(state: TrainState, seed: int) -> None:
    """One optimizer step in place (params and moments), then the EMA."""
    g = torch.Generator().manual_seed(100 + seed)
    grads = tree.map(lambda t: torch.randn(t.shape, generator=g), state.params)
    state.tx.update(state.params, grads, state.opt_state)
    for e, p in zip(tree.leaves(state.ema), tree.leaves(state.params)):
        e.mul_(0.9).add_(p, alpha=0.1)
    state.rng.manual_seed(seed + 7)
    state.step += 1


def _sidecar(path) -> dict:
    meta = json.loads(Path(path).with_suffix(".json").read_text())
    meta.pop("time")
    return meta


def _jax_template(t):
    return jax.tree_util.tree_map(lambda x: np.zeros(x.shape, np.float32), bridge.to_jax(t))


# ---------------------------------------------------------------------------
# the writer's bytes
# ---------------------------------------------------------------------------


def _msgpack_reference(obj) -> bytes:
    """The whole tree through msgpack.packb, arrays as flax packs them."""
    def default(x):
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.bfloat16:
                return msgpack.ExtType(1, msgpack.packb(
                    (list(x.shape), "bfloat16", x.view(torch.int16).numpy().tobytes()),
                    use_bin_type=True))
            x = x.numpy()
        if isinstance(x, np.ndarray):
            return msgpack.ExtType(1, msgpack.packb((list(x.shape), x.dtype.name,
                                                     x.tobytes("C")), use_bin_type=True))
        if isinstance(x, np.generic):
            return msgpack.ExtType(3, msgpack.packb(((), x.dtype.name, x.tobytes()),
                                                    use_bin_type=True))
        raise TypeError(type(x))

    def lists_as_maps(o):
        if isinstance(o, dict):
            return {k: lists_as_maps(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return {str(i): lists_as_maps(v) for i, v in enumerate(o)}
        return o

    return msgpack.packb(lists_as_maps(obj), default=default, use_bin_type=True,
                         strict_types=True)


# array byte sizes at msgpack's header boundaries (fixext 16, ext 8/16/32, bin
# 8/16/32) and past the 64 KiB from which arrays are written from their buffer
SIZES = (0, 1, 5, 16, 251, 255, 256, 65535, 65536, 65537, 300000)


@pytest.mark.parametrize("dtype", ["uint8", "float32", "bfloat16", "float64"])
def test_writer_bytes_are_msgpacks_own(tmp_path, dtype):
    rng = np.random.RandomState(0)
    state = {}
    for n in SIZES:
        if dtype == "uint8":
            state[f"a{n}"] = rng.randint(0, 255, n).astype(np.uint8)
        elif dtype == "bfloat16":
            state[f"a{n}"] = torch.from_numpy(rng.randn(n // 2).astype(np.float32)).bfloat16()
        else:
            state[f"a{n}"] = torch.from_numpy(rng.randn(n // 4).astype(dtype))
    state["matrix"] = rng.randn(130, 140).astype(np.float32)   # 72,800 bytes, 2-D
    state.update(step=np.int32(3), scalar=np.float32(2.5), flag=True, n=7, name="x",
                 nothing=None, empty={}, lst=[np.ones((2, 3), np.float32), {"k": 1.5}])
    for async_write in (False, True):
        path = tmp_path / f"{async_write}.ckpt"
        ckpt.save_state(path, state, async_write=async_write)
        ckpt.wait_for_writes()
        assert path.read_bytes() == _msgpack_reference(state), async_write
    # flax's own writer sorts keys: a sorted tree of numpy arrays is its bytes too
    flat = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in sorted(state.items()) if isinstance(v, (np.ndarray, torch.Tensor))}
    ckpt.save_state(tmp_path / "flax.ckpt", flat)
    assert (tmp_path / "flax.ckpt").read_bytes() == serialization.msgpack_serialize(flat)


# ---------------------------------------------------------------------------
# async equals sync, JAX reads it
# ---------------------------------------------------------------------------


def test_async_file_equals_sync_and_jax_reads_it(tmp_path):
    state = _train_state()
    sync = ckpt.CheckpointManager(tmp_path / "sync", "s", 5, False)
    asyn = ckpt.CheckpointManager(tmp_path / "async", "s", 5, True)
    assert not sync.async_writes and asyn.async_writes
    for m in (sync, asyn):
        assert m.save(state, state.step, 0.5, extra_meta={"epoch": 0})
    asyn.wait()
    for name in ("s_step_00000001.ckpt", "s_best_model.ckpt"):
        a, b = tmp_path / "sync" / name, tmp_path / "async" / name
        assert a.read_bytes() == b.read_bytes(), name
        assert _sidecar(a) == _sidecar(b)
    best = tmp_path / "async" / "s_best_model.ckpt"
    read = jax_ckpt.load_params(best, _jax_template(state.params))
    ema = jax_ckpt.load_sample_params(best, _jax_template(state.params))
    for got, want in ((read, state.params), (ema, state.ema)):
        got = dict(tree.items(bridge.from_jax(jax.tree_util.tree_map(np.asarray, got))))
        assert got.keys() == dict(tree.items(want)).keys()
        assert all(torch.equal(got[p], w) for p, w in tree.items(want))
    restored, meta = asyn.restore(_train_state(seed=5))
    assert meta["metric"] == 0.5 and restored.step == state.step
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(restored.params),
                                                 tree.leaves(state.params)))


def test_port_reads_a_jax_async_file(tmp_path):
    rng = np.random.RandomState(1)
    params = {"dense": {"w": rng.randn(300, 70).astype(np.float32),
                        "b": rng.randn(70).astype(np.float32)},
              "conv": {"w": rng.randn(3, 3, 4, 8).astype(np.float32)}}
    jax_ckpt.save_state(tmp_path / "j.ckpt", {"params": params, "step": 4},
                        {"step": 4}, async_write=True)
    jax_ckpt.wait_for_writes()
    raw = ckpt.read_checkpoint(tmp_path / "j.ckpt")
    assert int(raw["step"]) == 4 and ckpt.load_metadata(tmp_path / "j.ckpt") == {"step": 4}
    for path, want in tree.items(params):
        got = dict(tree.items(raw["params"]))[path]
        assert np.array_equal(np.asarray(got), want), path


def test_snapshot_is_taken_at_save_not_at_write(tmp_path, held):
    """The alias test: the state moves on (an optimizer step in place, the
    EMA, the generator) while the write is held in flight; the file is the
    sync file of the state as it was at save().  Threading the present
    to_checkpoint() (which shares the params' and moments' memory on the
    CPU) writes the updated values instead."""
    state = _train_state()
    assert tree.leaves(state.to_checkpoint()["params"])[2].data_ptr() == \
        tree.leaves(state.params)[2].data_ptr()          # the hazard is real
    ref = ckpt.CheckpointManager(tmp_path / "ref", "s", 5, False)
    asyn = ckpt.CheckpointManager(tmp_path / "async", "s", 5, True)
    ref.save(state, state.step, 0.5)
    asyn.save(state, state.step, 0.5)
    assert not asyn.best_path.exists()                   # held in flight
    _step(state, 1)
    held.release()
    asyn.wait()
    for name in ("s_step_00000001.ckpt", "s_best_model.ckpt"):
        assert (asyn.dir / name).read_bytes() == (ref.dir / name).read_bytes(), name
        assert _sidecar(asyn.dir / name) == _sidecar(ref.dir / name)
    # the light best: its bf16 leaves are shared with the live tree
    live = tree.map(lambda t: t.to(torch.bfloat16), _params(3))
    ref.save_best_light(live, 2, 0.3)
    asyn.save_best_light(live, 2, 0.3)
    for t in tree.leaves(live):
        t.add_(1.0)
    held.release()
    asyn.wait()
    assert asyn.best_path.read_bytes() == ref.best_path.read_bytes()
    assert _sidecar(asyn.best_path) == _sidecar(ref.best_path)
    assert _sidecar(asyn.best_path)["light"] is True


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------


@pytest.fixture
def failing_write(monkeypatch):
    """The background writer dies after writing part of the file."""
    class Boom(OSError):
        pass

    write = ckpt._write

    def partial(f, packer, obj):
        if _in_background():
            f.write(b"\x00" * 100)
            raise Boom("disk full")
        return write(f, packer, obj)

    monkeypatch.setattr(ckpt, "_write", partial)
    return Boom


@pytest.mark.parametrize("where", ["save", "wait_for_writes", "manager_wait", "read",
                                   "restore"])
def test_background_error_comes_back_once(tmp_path, failing_write, where):
    state = _train_state()
    m = ckpt.CheckpointManager(tmp_path, "s", 5, async_writes=True)
    ckpt.save_state(m.best_path, {"old": np.arange(5)}, {"old": True})
    old = m.best_path.read_bytes()
    m.save(state, state.step, 0.5, periodic=False)        # returns; the write fails
    act = {"save": lambda: m.save(state, state.step + 1, 0.1, periodic=False),
           "wait_for_writes": ckpt.wait_for_writes, "manager_wait": m.wait,
           "read": lambda: ckpt.read_checkpoint(m.best_path),
           "restore": lambda: m.restore(state)}[where]
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as err:
        act()
    assert isinstance(err.value.__cause__, failing_write)
    assert list(tmp_path.glob("*.tmp")) == []
    assert m.best_path.read_bytes() == old and ckpt.load_metadata(m.best_path) == {"old": True}
    ckpt.wait_for_writes()                                # raised once only
    assert np.array_equal(ckpt.read_checkpoint(m.best_path)["old"], np.arange(5))


def test_every_rank_of_a_mesh_raises_the_writers_error(tmp_path, failing_write):
    """On a mesh every rank calls ``save`` and ``wait()``, which meet at
    ``sync(failed)`` (``train.common.agree``: a barrier that tells each rank
    whether any rank failed).  Played here in one process, one rank at a
    time, the writer first where it learns of the error (the ranks share
    one module here): the writer raises its write's error after it has met the others,
    and a rank that does not write raises at the same save, so no rank goes
    on into the next step's collective without it."""
    posted = []                                           # the writer's flags

    def writer_sync(failed):
        posted.append(failed)
        return failed

    state = _train_state()
    writer = ckpt.CheckpointManager(tmp_path / "w", "s", 5, True, writer=True,
                                    sync=writer_sync)
    other = ckpt.CheckpointManager(tmp_path / "o", "s", 5, True, writer=False,
                                   sync=lambda failed: failed or any(posted[-1:]))
    for m in (other, writer):
        m.save(state, 1, 0.5, periodic=False)             # the writer's write fails
    with pytest.raises(RuntimeError, match="async checkpoint write failed") as err:
        writer.save(state, 2, 0.4, periodic=False)
    assert isinstance(err.value.__cause__, failing_write) and posted == [False, True]
    with pytest.raises(RuntimeError, match="failed on the writer rank"):
        other.save(state, 2, 0.4, periodic=False)
    writer.wait()                                         # raised once only
    other.wait()
    assert posted == [False, True, False] and not list(other.dir.iterdir())


def test_sync_error_raises_at_once_where_jax_defers_it(tmp_path, monkeypatch):
    """Queue C item 4: the JAX package's sync save_state keeps its own
    error for the next wait_for_writes and returns as if it had written;
    the port's raises the error itself, at once."""
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "_write", boom)
    with pytest.raises(OSError, match="disk full"):
        ckpt.save_state(tmp_path / "p.ckpt", {"a": np.ones(3)})
    assert list(tmp_path.iterdir()) == []
    ckpt.wait_for_writes()                                # nothing deferred

    monkeypatch.setattr(jax_ckpt.serialization, "to_bytes", boom)
    jax_ckpt.save_state(tmp_path / "j.ckpt", {"a": np.ones(3)})   # returns
    assert not (tmp_path / "j.ckpt").exists()
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        jax_ckpt.wait_for_writes()


# ---------------------------------------------------------------------------
# rotation, the switch
# ---------------------------------------------------------------------------


def _periodic_names(d):
    return sorted(p.name for p in Path(d).glob("*_step_*.ckpt"))


def test_rotation_with_writes_in_flight(tmp_path, held):
    """keep=2, four periodic saves, each write held in flight until the next
    save joins it: the two newest files remain.  JAX lists the directory
    before it joins the write in flight, so it misses that file and keeps
    three (Queue C item 4)."""
    state = _train_state()
    m = ckpt.CheckpointManager(tmp_path / "port", "s", keep=2, async_writes=True)
    j = jax_ckpt.CheckpointManager(tmp_path / "jax", "s", keep=2, async_writes=True)
    for step in range(1, 5):
        if step > 1:
            _release_later(held)
        m.save(state, step)
        assert f"s_step_{step:08d}.ckpt" not in _periodic_names(m.dir)   # in flight
        assert len(_periodic_names(m.dir)) <= 2
    held.release()
    m.wait()
    assert _periodic_names(m.dir) == ["s_step_00000003.ckpt", "s_step_00000004.ckpt"]
    assert sorted(p.name for p in m.dir.glob("*.json")) == [
        "s_step_00000003.json", "s_step_00000004.json"]

    for step in range(1, 5):
        if step > 1:
            _release_later(held)
        j.save({"a": np.ones(3) * step}, step)
    held.release()
    jax_ckpt.wait_for_writes()
    assert _periodic_names(j.dir) == ["s_step_00000002.ckpt", "s_step_00000003.ckpt",
                                      "s_step_00000004.ckpt"]


@pytest.mark.parametrize("env", [None, "0", "1", "true"])
@pytest.mark.parametrize("given", [None, False, True])
def test_switch_is_read_as_jax_reads_it(tmp_path, monkeypatch, env, given):
    if env is None:
        monkeypatch.delenv("PSG_TPU_ASYNC_CKPT", raising=False)
    else:
        monkeypatch.setenv("PSG_TPU_ASYNC_CKPT", env)
    port = ckpt.CheckpointManager(tmp_path / "p", "s", 5, given).async_writes
    jax_ = jax_ckpt.CheckpointManager(tmp_path / "j", "s", 5, given).async_writes
    assert port == bool(jax_)
    assert port == (given if given is not None else env == "1")


# ---------------------------------------------------------------------------
# readers wait
# ---------------------------------------------------------------------------


def _template_params():
    return {"vae": {"w": torch.zeros(300, 70)}, "text": {"b": torch.zeros(70)},
            "unet": {"w": torch.zeros(300, 70)}}


@pytest.mark.parametrize("reader", ["read_checkpoint", "load_params", "load_metadata",
                                    "load_serving_params", "restore", "hub"])
def test_readers_wait_for_the_write_in_flight(tmp_path, held, reader):
    """The file is written for the first time and held in flight: each
    reader sees it whole, never missing."""
    from psg_tpu_torch.serve import hub

    params = {"vae": {"w": torch.randn(300, 70)}, "text": {"b": torch.randn(70)},
              "unet": {"w": torch.randn(300, 70)}}
    state = TrainState(1, params, {}, torch.Generator().manual_seed(0),
                       ema=tree.map(lambda t: t + 1, params))
    m = ckpt.CheckpointManager(tmp_path / "exp" / "run_final" / "checkpoints", "final",
                               async_writes=True)
    m.save(state, 1, 0.5, periodic=False)
    assert not m.best_path.exists()
    _release_later(held)
    if reader == "read_checkpoint":
        assert int(ckpt.read_checkpoint(m.best_path)["step"]) == 1
    elif reader == "load_params":
        got = ckpt.load_params(m.best_path, _template_params(), prefer_ema=True)
        assert torch.equal(got["unet"]["w"], params["unet"]["w"] + 1)
    elif reader == "load_metadata":
        assert ckpt.load_metadata(m.best_path)["metric"] == 0.5
    elif reader == "load_serving_params":
        got, loaded = ckpt.load_serving_params(m.best_path, m.best_path, _template_params())
        assert loaded == "final-bundle" and torch.equal(got["vae"]["w"], params["vae"]["w"])
    elif reader == "restore":
        back, meta = m.restore(TrainState(0, _template_params(), {},
                                          torch.Generator(), ema=_template_params()))
        assert back.step == 1 and meta["metric"] == 0.5
    else:
        cfg = Config()
        cfg.experiment_dir = str(tmp_path / "exp")
        found = hub.list_candidates(cfg, "final")
        assert [c["path"] for c in found] == [m.best_path] and found[0]["metric"] == 0.5


def test_stage_hand_off_waits(tmp_path, held, monkeypatch, capsys):
    """``--stage 2`` after a stage-1 best that this process is still writing
    (its first write): the stage-2 trainer is handed the path, not None."""
    from psg_tpu_torch.train import cli, stage2_diffusion

    exp = tmp_path / "exp"
    m = ckpt.CheckpointManager(exp / "run_vae" / "checkpoints", "vae", async_writes=True)
    m.save(_train_state(), 1, 0.5, periodic=False)
    assert not m.best_path.exists()
    handed = {}

    class Stub:
        def __init__(self, cfg, vae_checkpoint_path=None, **kw):
            handed["vae"] = vae_checkpoint_path

        def train(self):
            return exp / "run_diffusion" / "best.ckpt"

    monkeypatch.setattr(stage2_diffusion, "DiffusionTrainer", Stub)
    _release_later(held)
    assert cli.main(["--stage", "2", "--device", "cpu", "--config",
                     str(tmp_path / "none.yaml"), "--experiment-name", "run",
                     f"--override=experiment_dir={exp}"]) == 0
    assert handed["vae"] == str(m.best_path)
    assert "stage 2 complete" in capsys.readouterr().out


def test_train_returns_with_its_files_on_disk(tmp_path, monkeypatch):
    """A tiny stage-2 run through the CLI with ``PSG_TPU_ASYNC_CKPT=1`` and a
    slow disk (every background write starts 0.5 s late): when ``train()``
    returns, its best and its periodic checkpoint are whole and no write is
    in flight; they equal a sync run's bytes apart from the sidecars' time."""
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.train import cli

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    write_files = ckpt._write_files
    background = []

    def slow(*a, **k):
        if _in_background():
            background.append(a[0])
            time.sleep(0.5)
        return write_files(*a, **k)

    monkeypatch.setattr(ckpt, "_write_files", slow)
    csv, images = write_sprite_corpus(tmp_path / "corpus", n=7, seed=1, size=64)
    overrides = [
        "model.bert_model=tiny-test", "model.vae_width_scale=0.25",
        "model.text_embedding_dim=48", "model.unet_channels=[16,24,32,32]",
        "model.time_emb_dim=32", "data.image_size=64", "data.text_len=32",
        f"data.csv_path={csv}", f"data.image_dir={images}", "data.batch_size=3",
        "data.num_workers=1", "training.diffusion_epochs=1", "training.sample_every=1000",
        "optimization.ema_decay=0.9"]
    files = {}
    for env in ("1", "0"):
        monkeypatch.setenv("PSG_TPU_ASYNC_CKPT", env)    # the trainer passes nothing
        background.clear()
        exp = tmp_path / f"exp{env}"
        assert cli.main(["--stage", "2", "--device", "cpu", "--config",
                         str(tmp_path / "none.yaml"), "--experiment-name", "cli"]
                        + [f"--override={o}" for o in overrides + [f"experiment_dir={exp}"]]
                        ) == 0
        assert ckpt._pending is None
        d = exp / "cli_diffusion" / "checkpoints"
        files[env] = {p.name: p.read_bytes() for p in sorted(d.glob("*.ckpt"))}
        assert set(files[env]) == {"diffusion_best_model.ckpt", "diffusion_step_00000002.ckpt"}
        assert list(d.glob("*.tmp")) == []
        assert len(background) == (2 if env == "1" else 0)
    assert files["1"] == files["0"]


def test_exit_leaves_a_whole_file(tmp_path):
    """A process that async-saves a few MB and exits without waiting: the
    write (held 0.5 s in flight) finishes before the interpreter ends."""
    script = f"""
import sys, time
sys.path.insert(0, {str(ROOT)!r})
import numpy as np
from psg_tpu_torch.core import checkpoint as ckpt
write = ckpt._write_files
def slow(*a, **k):
    time.sleep(0.5)
    return write(*a, **k)
ckpt._write_files = slow
a = np.arange(2_000_000, dtype=np.float32)
ckpt.save_state({str(tmp_path / 'x.ckpt')!r}, {{"a": a, "step": 3}}, {{"s": 1}}, async_write=True)
print("returned")
"""
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "returned" in out.stdout and "Traceback" not in out.stderr
    raw = ckpt.read_checkpoint(tmp_path / "x.ckpt")
    assert np.array_equal(raw["a"], np.arange(2_000_000, dtype=np.float32))
    assert raw["step"] == 3 and ckpt.load_metadata(tmp_path / "x.ckpt") == {"s": 1}
