"""The port's scale-out on the CPU with gloo: ``psg_tpu_torch/parallel``,
the trainers' and the generator's ``mesh=``, and ``graft_entry``.

Each mesh layout is spawned once (``tests/torch_mesh_worker.py``, one
process a rank, one thread each, every collective under a timeout) and runs
all of that layout's checks; the single-process references are computed
here while the ranks run.  A run on a mesh must equal the single-process
run on the same global batch: the draws are made at the global shape and
cut to each rank's rows.  Bounds (PERF.md section 2): loss within rel 1e-5;
gradients per leaf within 1e-4 * max|g| + 1e-7; stage-2 params and EMA
within 1e-6; the images of ``generate_batch`` within MAE 1e-6.  Stages 1, 3
and the SD trainer hold their params within 1e-6 wherever the gradient is
determined (|g| at least 100 times the gradient bound, the rule of
tests/test_torch_train_stage1.py): Adam's first step moves an element by
lr * sign(g), so where g is rounding noise the sign is too.

Against JAX: the placements of ``unet_tp_rules`` / ``param_shardings``
leaf by leaf through the layout map (conv OIHW here, HWIO there) on the
conftest's 8-device mesh at model=2, from shapes only; the stage-2 step on
two ranks with JAX's draws against ``DiffusionTrainer(mesh=make_mesh(
data=2))``'s jitted step; and JAX's ``load_params`` reading the checkpoints
the meshes wrote."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.core.checkpoint import load_params as jax_load_params
from psg_tpu.core.checkpoint import load_sample_params as jax_load_sample_params
from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.models.sd_unet import SDUNetSpec as JaxSDSpec
from psg_tpu.models.sd_unet import sd_unet_init as jax_sd_unet_init
from psg_tpu.models.unet import UNetSpec as JaxUNetSpec
from psg_tpu.models.unet import unet_init as jax_unet_init
from psg_tpu.parallel import make_mesh as jax_make_mesh
from psg_tpu.parallel import param_shardings as jax_param_shardings
from psg_tpu.parallel import shard_batch as jax_shard_batch
from psg_tpu.parallel.sharding import unet_tp_rules as jax_unet_tp_rules
from psg_tpu.train.stage2_diffusion import DiffusionTrainer as JaxTrainer

import torch_mesh_worker as W
from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import read_checkpoint
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import bridge
from psg_tpu_torch.train.stage1_vae import VAETrainer
from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer
from psg_tpu_torch.train.stage3_final import FinalTrainer
from test_torch_fastpath import assert_determined_close
from test_torch_train_stage2 import _dropout_masks

torch.set_num_threads(1)

WORKER = Path(W.__file__)
TWO_RANK_CHECKS = ("placements", "stage2_dp", "stage2_jax", "stage1_dp", "stage3_dp",
                   "sd_dp", "generate_dp", "generate_tp")
JOIN_S = 400


def _spawn(root: Path, world: int, checks):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(port),
                              str(root), *checks], env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _join(root: Path, procs, checks):
    """Every rank's results by check; the ranks' output on failure."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(o[-4000:] for o in outs)
    return {c: [torch.load(root / f"{c}.rank{r}.pt", weights_only=False)
                for r in range(len(procs))] for c in checks}


def _jax_config(root: Path):
    cfg = JaxConfig()
    ref = W.tiny_config(root / "exp_jax_ref", W.corpus_of(root), snr_gamma=5.0,
                        cond_dropout=0.5)
    cfg.experiment_dir = ref.experiment_dir
    for section in ("model", "data", "training", "optimization"):
        for k, v in vars(getattr(ref, section)).items():
            if hasattr(getattr(cfg, section), k):
                setattr(getattr(cfg, section), k, v)
    cfg.extra = dict(ref.extra)
    return cfg


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _jax_draws(jt, key, batch: int):
    """The port's draws from the JAX step's key at the global batch (the
    trainer's split: fold_in(rng, step) -> (loss, dropout); loss -> rep,
    t, noise, cond)."""
    k_loss, k_drop = jax.random.split(key)
    k_rep, k_t, k_noise, k_cond = jax.random.split(k_loss, 4)
    lat = (batch, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)
    d = {"rep_noise": jax.random.normal(k_rep, lat, jnp.float32),
         "t": jax.random.randint(k_t, (batch,), 0, jt.schedule.num_timesteps),
         "noise": jax.random.normal(k_noise, lat, jnp.float32),
         "keep": jax.random.uniform(k_cond, (batch, 1, 1)) >= jt.cond_dropout}
    d = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    d["dropout"] = _dropout_masks(jt.spec, k_drop, batch, jt.spec.attn_dropout)
    return d


def _jax_step_with_grads(jt):
    """The JAX trainer's mesh step (jitted over its sharded state and
    batch), returning the loss and gradients beside the new state."""
    def step(state, frozen, batch):
        k_loss, k_drop = jax.random.split(jax.random.fold_in(state.rng, state.step))
        loss, grads = jax.value_and_grad(lambda p: jt._noise_loss(
            p, frozen, batch, k_loss, dropout_key=k_drop))(state.params)
        new, metrics = jt._apply_update(state, loss, grads)
        return grads, new, metrics

    return jax.jit(step)


def _single_refs(root: Path) -> dict:
    """The single-process runs of every two-rank check."""
    refs = {}
    t = W.stage2_trainer(root, "single_s2", None)
    refs["stage2"] = W.stage2_step(t, W.global_batch(t.tokenizer))
    assert t.save_checkpoint(0, 0.5)
    refs["stage2_best"] = str(t.ckpt.best_path)
    t1 = VAETrainer(W.tiny_config(root / "single_s1", W.corpus_of(root)), "m", device="cpu")
    refs["stage1"] = W.step_parts(t1, W.global_batch(t1.tokenizer), lambda b: t1._grads(b, 0.01),
                                  lambda p, g: t1._apply_update(p, g, 0.01),
                                  lambda b: t1._eval(b, 3, 0.01)["total_loss"])
    t3 = FinalTrainer(W.tiny_config(root / "single_s3", W.corpus_of(root)), None, None, "m",
                      device="cpu")
    t3.switch_to_joint_training()
    refs["stage3"] = W.step_parts(t3, W.global_batch(t3.tokenizer), t3._grads,
                                  t3._apply_update, lambda b: t3._eval(b, 3)["total_loss"])
    ts = SDDiffusionTrainer(W.sd_config(root, "single_sd"), None, "m", device="cpu")
    refs["sd"] = W.step_parts(ts, W.global_batch(ts.tokenizer), ts._grads,
                              lambda p, g: ts._apply_update(p["loss"], g),
                              lambda b: ts._eval(b, 3)["loss"])
    refs["generate"] = W.generate(W.generator(root))
    return refs


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("mesh")
    write_sprite_corpus(r / "corpus", n=12, seed=0, size=64)
    return r


@pytest.fixture(scope="module")
def two_ranks(root):
    """The two-rank layout: JAX's mesh trainer and its draws written for
    the ranks, the ranks started, then (while they run) JAX's step and the
    single-process references."""
    jt = JaxTrainer(_jax_config(root), vae_checkpoint_path=None, experiment_name="j",
                    mesh=jax_make_mesh(data=2, devices=jax.devices()[:2]))
    jbatch = W.global_batch(jt.tokenizer)
    jbatch = {k: jbatch[k] for k in ("image", "text_ids", "text_mask")}
    key = jax.random.fold_in(jt.state.rng, jt.state.step)
    torch.save({"params": bridge.from_jax(_np(jt.state.params)),
                "frozen": bridge.from_jax(_np(jt.frozen)),
                "draws": _jax_draws(jt, key, W.GLOBAL_BATCH), "batch": jbatch,
                "options": {"snr_gamma": jt.snr_gamma, "cond_dropout": jt.cond_dropout}},
               root / "jax_step.pt")
    procs = _spawn(root, 2, TWO_RANK_CHECKS)
    try:
        grads, new, metrics = _jax_step_with_grads(jt)(
            jt.state, jt.frozen, jax_shard_batch(jbatch, jt.mesh))
        ref_jax = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                   **{k: dict(tree.items(bridge.from_jax(_np(v)))) for k, v in (
                       ("grads", grads), ("params", new.params), ("ema", new.ema))}}
        refs = _single_refs(root)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    got = _join(root, procs, TWO_RANK_CHECKS)
    return {"ranks": got, "single": refs, "jax": ref_jax, "jax_template": jt.state.params}


@pytest.fixture(scope="module")
def four_ranks(root, two_ranks):
    got = _join(root, _spawn(root, 4, ("stage2_tp",)), ("stage2_tp",))
    return got["stage2_tp"]


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _grads_close(got, ref):
    ref = {p: torch.as_tensor(r).float() for p, r in ref.items()}
    assert set(got) == set(ref)
    for path, r in ref.items():
        bound = 1e-4 * float(r.abs().max()) + 1e-7
        err = float((got[path] - r).abs().max())
        assert err <= bound, f"{path}: max|dg| {err:.3g} > {bound:.3g}"


def _params_close(got, ref, name, atol=1e-6):
    assert set(got) == set(ref)
    for path, r in ref.items():
        err = float((got[path] - torch.as_tensor(r).float()).abs().max())
        assert err <= atol, f"{name} {path}: {err:.3g} > {atol}"


def _stage2_matches(got, ref):
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
    np.testing.assert_allclose(got["val"], ref["val"], rtol=1e-5)
    _grads_close(got["grads"], ref["grads"])
    _params_close(got["params"], ref["params"], "params")
    _params_close(got["ema"], ref["ema"], "ema")


def _jax_placements(name):
    """JAX's param_shardings on the 8-device mesh at model=2 for a tree of
    shapes (no compile), as {port path: the port's sharded dim or None}."""
    key = jax.random.PRNGKey(0)
    if name == "unet":
        shapes = jax.eval_shape(lambda k: jax_unet_init(k, JaxUNetSpec(
            text_dim=48, time_emb_dim=32, channels=(16, 24, 32, 32),
            spatial=(9, 5, 3, 2))), key)
    elif name == "sd_unet":
        shapes = jax.eval_shape(lambda k: jax_sd_unet_init(k, JaxSDSpec.tiny_test(
            text_dim=48)), key)
    else:
        shapes = {"lin_out": {"w": jax.ShapeDtypeStruct((645, 1280), jnp.float32)},
                  "lin_odd": {"w": jax.ShapeDtypeStruct((1280, 645), jnp.float32)},
                  "lin_in": {"w": jax.ShapeDtypeStruct((645, 8), jnp.float32)},
                  "conv": {"w": jax.ShapeDtypeStruct((3, 3, 645, 1280), jnp.float32)},
                  "conv_in": {"w": jax.ShapeDtypeStruct((1, 1, 1280, 8), jnp.float32)},
                  "norm": {"scale": jax.ShapeDtypeStruct((1280,), jnp.float32)}}
    sh = jax_param_shardings(shapes, jax_make_mesh(model=2),
                             jax_unet_tp_rules(W.PLACEMENT_MIN[name]))
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(sh)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        leaf = shapes
        for k in path:
            leaf = leaf[getattr(k, "key", getattr(k, "idx", None))]
        spec = tuple(s.spec) + (None,) * (len(leaf.shape) - len(s.spec))
        dim = spec.index("model") if "model" in spec else None
        if dim is not None and keys[-1] == "w" and len(leaf.shape) == 4:
            dim = (3, 2, 0, 1).index(dim)        # HWIO axis -> OIHW dim
        out[".".join(keys)] = dim
    return out


@pytest.mark.parametrize("name", ["unet", "sd_unet", "wide"])
def test_tp_placements_match_jax(two_ranks, name):
    """unet_tp_rules + param_shardings against JAX's, leaf by leaf."""
    got = two_ranks["ranks"]["placements"][0][name]
    want = _jax_placements(name)
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:5]
    assert got == want, [(p, got[p], want[p]) for p in got if got[p] != want[p]][:5]
    assert any(d is not None for d in got.values())
    assert two_ranks["ranks"]["placements"][1][name] == got


def test_stage2_dp_step_matches_single_process(two_ranks):
    """Two ranks (data 2), min-SNR weights, cond-dropout and attention
    dropout drawn from the trainer's generator: loss, gradients, params,
    EMA and the padded validation equal the single-process step's."""
    for got in two_ranks["ranks"]["stage2_dp"]:
        _stage2_matches(got, two_ranks["single"]["stage2"])


def test_stage2_dp_step_matches_jax_mesh_step(two_ranks):
    """The port's two-rank step with JAX's draws against JAX's
    DiffusionTrainer on a data-2 mesh."""
    for got in two_ranks["ranks"]["stage2_jax"]:
        _stage2_matches({**got, "val": 0.0}, {**two_ranks["jax"], "val": 0.0})


@pytest.mark.parametrize("stage", ["stage1", "stage3", "sd"])
def test_other_trainers_dp_step_matches_single_process(two_ranks, stage):
    ref = two_ranks["single"][stage]
    for got in two_ranks["ranks"][f"{stage}_dp"]:
        assert set(got["parts"]) == set(ref["parts"])
        for k, v in ref["parts"].items():
            np.testing.assert_allclose(got["parts"][k], v, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(got["val"], ref["val"], rtol=1e-5)
        _grads_close(got["grads"], ref["grads"])
        assert_determined_close(got["params"], ref["params"], [ref["grads"]], "params")


@pytest.mark.parametrize("layout", ["generate_dp", "generate_tp"])
def test_generate_batch_on_a_mesh_matches_single_process(two_ranks, layout):
    """n = 3 prompts on (2, 1) (padded to 4) and on (1, 2) (the UNet cut
    by the rule at 32 channels): DDIM with fused CFG, and DDPM from
    retrieval with a restart pass; every rank returns the whole batch."""
    ref = two_ranks["single"]["generate"]
    for got in two_ranks["ranks"][layout]:
        for k in ("ddim", "ddpm"):
            assert got[k].shape == ref[k].shape == (3, 64, 64, 3)
            assert float(np.abs(got[k] - ref[k]).mean()) <= 1e-6, k
    if layout == "generate_tp":
        assert two_ranks["ranks"][layout][0]["sharded"] > 0


def test_tp_shards_follow_the_rule(four_ranks, two_ranks):
    """(2, 2): each rank holds half of every ruled leaf along the rule's
    dim, and so do the EMA and both Adam moments; the rest is whole."""
    whole = {p: tuple(x.shape) for p, x in two_ranks["single"]["stage2"]["params"].items()}
    for got in four_ranks:
        assert got["dims"] and set(got["dims"]) <= set(whole)
        for path, shape in whole.items():
            want = list(shape)
            if path in got["dims"]:
                want[got["dims"][path]] //= 2
                assert shape[got["dims"][path]] >= 32
            for name in ("shards", "moments", "ema_shards"):
                assert got[name][path] == tuple(want), (name, path)
    assert four_ranks[0]["dims"] == four_ranks[3]["dims"]


def test_tp_step_matches_unsharded_step(four_ranks, two_ranks):
    for got in four_ranks:
        _stage2_matches(got, two_ranks["single"]["stage2"])


@pytest.mark.parametrize("layout", ["stage2_dp", "stage2_tp"])
def test_mesh_checkpoint_equals_single_process_and_jax_reads_it(two_ranks, four_ranks,
                                                                layout):
    """The best checkpoint written from the mesh (gathered first under TP)
    holds what the single-process one holds, and JAX's load_params and
    load_sample_params read it into the JAX trainer's template."""
    got = (four_ranks if layout == "stage2_tp" else two_ranks["ranks"]["stage2_dp"])[0]
    mine, ref = read_checkpoint(got["best"]), read_checkpoint(
        two_ranks["single"]["stage2_best"])
    assert int(mine["step"]) == int(ref["step"]) == 1
    for name in ("params", "ema"):
        a = dict(tree.items(bridge.from_jax(mine[name])))
        b = dict(tree.items(bridge.from_jax(ref[name])))
        assert {p: tuple(x.shape) for p, x in a.items()} == {p: tuple(x.shape)
                                                               for p, x in b.items()}
        _params_close({p: x.float() for p, x in a.items()}, b, name)
    for load, name in ((jax_load_params, "params"), (jax_load_sample_params, "ema")):
        read = dict(tree.items(bridge.from_jax(_np(load(got["best"],
                                                          two_ranks["jax_template"])))))
        want = dict(tree.items(bridge.from_jax(mine[name])))
        assert all(torch.equal(read[p], want[p]) for p in want), name


def test_mesh_async_checkpoint_equals_the_sync_one(two_ranks):
    """(2, 1): the best written with async writes (rank 0's thread, the
    barrier in ``wait()``) is the sync best byte for byte, and its sidecar
    apart from the time; every rank restores from it the state it saved."""
    ranks = two_ranks["ranks"]["stage2_dp"]
    sync, asyn = Path(ranks[0]["best"]), Path(ranks[0]["async_best"])
    assert sync != asyn and sync.read_bytes() == asyn.read_bytes()
    metas = [json.loads(p.with_suffix(".json").read_text()) for p in (sync, asyn)]
    assert all(m.pop("time") for m in metas) and metas[0] == metas[1]
    for got in ranks:
        assert got["restored"]["step"] == got["live"]["step"] == 1
        for part in ("params", "ema", "mu"):
            want, back = got["live"][part], got["restored"][part]
            assert want.keys() == back.keys()
            assert all(torch.equal(want[p], back[p]) for p in want), part
            assert all(torch.equal(back[p], ranks[0]["restored"][part][p]) for p in back)


def test_mesh_async_write_error_raises_on_every_rank(two_ranks):
    """(2, 1): a background write that fails on rank 0 (its checkpoint
    directory is a file) raises on both ranks at the next save, and a second
    one at ``wait()``, once each: the ranks meet in ``wait()`` and learn of
    the failure there, so none is left in a collective until its timeout.
    A sync write that fails on rank 0 raises on both at that save."""
    got = [r["failed_write"] for r in two_ranks["ranks"]["stage2_dp"]]
    for rank, err in enumerate(got):
        assert err["first"] is None and err["second"] is None and err["again"] is None, err
        for where in ("save", "wait"):
            assert err[where].startswith("RuntimeError: async checkpoint write failed"), \
                (rank, where, err)
    assert got[0]["save"].endswith("<- FileExistsError"), got[0]
    assert got[1]["save"] == got[1]["wait"] == ("RuntimeError: async checkpoint write "
                                                "failed on the writer rank <- NoneType"), got[1]
    # a sync write that fails on rank 0 raises there at once, and on rank 1
    # at the barrier after it, each time
    for key in ("sync", "sync_again"):
        assert got[0][key].startswith("FileExistsError"), got[0]
        assert got[1][key] == ("RuntimeError: checkpoint write failed on the writer "
                               "rank <- NoneType"), got[1]


def test_tp_resume_reshards(four_ranks):
    """A trainer on the (2, 2) mesh resumes from the checkpoint the mesh
    wrote: the same shards of params and EMA, the same step."""
    for got in four_ranks:
        assert got["resumed"] == {"params": True, "ema": True} and got["resumed_step"] == 1


def test_dryrun_multichip_four_ranks():
    """graft_entry.dryrun_multichip(4): a (2, 2) mesh, one step of each
    stage with shard_state, a DPM-8 chain, and the trainer's placements
    equal to shard_state's."""
    from psg_tpu_torch.graft_entry import dryrun_multichip

    line = dryrun_multichip(4)
    assert "mesh={'data': 2, 'model': 2}" in line and "sample=(4, 64, 64, 3)" in line
