"""psg_tpu_torch's stage-3 trainer against psg_tpu's FinalTrainer on the CPU,
at the JAX stage-3 tests' tiny config (tests/test_train_stage3.py: BERT
tiny-test, VAE x0.25, UNet (16,24,32,32), 64 px, batch 2, text_len 32,
``ClipConfig.tiny_test``) over a sprite corpus made from a seed, fp32.

The JAX trainer's random-init VAE, text encoder, UNet and CLIP go through
the bridge into the port; inputs are made with numpy; JAX's reparameterize
noise (normal of fold_in(rng, step), or of fold_in(rng, -3) in validation)
and its sampler's initial latent are injected into the port.  Bounds (as
PERF.md section 2 states them for stages 1 and 2): loss within rel 1e-5;
gradients per leaf within 1e-4 * max|g_jax| + 1e-7; grad_norm within rel
1e-5; params after a step within 1e-6 (where the port's optimizer takes the
JAX gradients; from its own gradients, wherever the gradient is determined,
as in tests/test_torch_train_stage1.py); sample images within MAE 1e-3.
The fast path (``_fast_epoch_impl``, ``_fast_val_impl``, one step with
``data.augment`` off, JAX's index uniforms and noises injected) is held to
the same bounds."""

import json
import logging
import socket

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psg_tpu.core.checkpoint import load_metadata as jax_load_metadata
from psg_tpu.core.checkpoint import load_params as jax_load_params
from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.core.stability import global_norm as jax_global_norm
from psg_tpu.train.stage3_final import FinalTrainer as JaxTrainer

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import bridge
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.train import stage3_final
from psg_tpu_torch.train.stage3_final import FinalTrainer
from test_torch_fastpath import assert_determined_close, recorded_grads, step_seam

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

CAPTIONS = ["a small green creature with leaves", "a red fire lizard with a flame"]


def _tiny(cls, exp, corpus, scheduler="constant"):
    cfg = cls()
    cfg.experiment_dir = str(exp)
    cfg.model.bert_model = "tiny-test"
    cfg.model.vae_width_scale = 0.25
    cfg.model.text_embedding_dim = 48
    cfg.model.unet_channels = (16, 24, 32, 32)
    cfg.model.num_attention_heads = 4
    cfg.model.time_emb_dim = 32
    cfg.model.num_timesteps = 50
    cfg.data.csv_path, cfg.data.image_dir = str(corpus[0]), str(corpus[1])
    cfg.data.image_size = 64
    cfg.data.batch_size = 2
    cfg.data.text_len = 32
    cfg.data.num_workers = 2
    cfg.training.final_epochs = 2
    cfg.training.phase1_epochs = 1
    cfg.training.log_every = 1
    cfg.training.sample_every = 100
    cfg.optimization.scheduler = scheduler
    return cfg


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module", autouse=True)
def no_weight_files():
    """No pretrained weights are named: both packages draw CLIP."""
    mp = pytest.MonkeyPatch()
    for var in ("PSG_TPU_BERT", "PSG_TPU_BERT_VOCAB", "PSG_TPU_CLIP", "PSG_TPU_CLIP_BPE"):
        mp.delenv(var, raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=12, seed=0, size=64)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory, corpus):
    return JaxTrainer(_tiny(JaxConfig, tmp_path_factory.mktemp("jax_exp"), corpus), None,
                      None, experiment_name="j")


def _carry_across(pt, jt):
    """The JAX trainer's params and CLIP into the port's trainer, phase 1,
    with a fresh optimizer state."""
    pt.phase, pt.tx = "text_encoder", pt.tx_phase1
    pt.state = pt._fresh_state(bridge.fit(pt.state.params, bridge.from_jax(
        _np(jt.state.params))), step=0, rng=pt.state.rng)
    pt.clip_params = prepare_weights(bridge.fit(pt.clip_params, bridge.from_jax(
        _np(jt.clip_params))))


@pytest.fixture(scope="module")
def port_trainer(tmp_path_factory, corpus, jax_trainer):
    t = FinalTrainer(_tiny(Config, tmp_path_factory.mktemp("port_exp"), corpus), None, None,
                     experiment_name="p", device="cpu")
    assert tuple(t.clip_cfg) == tuple(jax_trainer.clip_cfg)
    _carry_across(t, jax_trainer)
    return t


def _batches(jt, pt, seed=0):
    images = np.random.RandomState(seed).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ids, mask = jt.tokenizer.encode_batch(CAPTIONS, 32)
    jb = {"image": jnp.asarray(images), "text_ids": jnp.asarray(ids),
          "text_mask": jnp.asarray(mask)}
    return jb, pt._batch({"image": images, "text_ids": ids, "text_mask": mask})


def _latent(jt):
    return (2, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)


@pytest.fixture(scope="module")
def reference(jax_trainer, port_trainer):
    """JAX's loss parts and gradients of one step at the initial params
    (rng fold_in(rng, 0)), and its phase-1 and joint updates of them."""
    jt = jax_trainer
    jb, _ = _batches(jt, port_trainer)
    rng = jax.random.fold_in(jt.state.rng, jt.state.step)
    (_, parts), grads = jax.jit(jax.value_and_grad(
        lambda p, c: jt._loss(p, c, jb, rng), has_aux=True))(jt.state.params, jt.clip_params)
    params = jt.state.params

    def updated(tx):
        upd, _ = jax.jit(tx.update)(grads, tx.init(params), params)
        return dict(tree.items(bridge.from_jax(_np(optax.apply_updates(params, upd)))))

    return {"parts": {k: float(v) for k, v in parts.items()}, "grads": grads,
            "rep_noise": torch.from_numpy(np.array(jax.random.normal(rng, _latent(jt)))),
            "grad_norm": float(jax_global_norm(grads)),
            "phase1": updated(jt.tx_phase1), "joint": updated(jt.tx_phase2)}


def _assert_grads_close(jgrads, pgrads):
    ref = dict(tree.items(bridge.from_jax(_np(jgrads))))
    got = dict(tree.items(pgrads))
    assert set(ref) == set(got)
    for path, r in ref.items():
        g = got[path]
        bound = 1e-4 * float(r.abs().max()) + 1e-7
        err = float((g - r).abs().max())
        assert err <= bound, f"{path}: max|dg| {err:.3g} > {bound:.3g}"


def _params_close(pt, ref_params, ref_grads=None):
    """Params within 1e-6 of JAX's; with ``ref_grads``, only where the
    gradient is determined (|g| at least 100 times the gradients' bound:
    Adam's first step moves an element by lr * g / (|g| + 1e-8), so rounding
    noise in g, a key bias under softmax, moves it by +-lr in either
    package)."""
    grads = tree.leaves(ref_grads) if ref_grads is not None else None
    for i, (path, p) in enumerate(tree.items(pt.state.params)):
        err = (p.detach() - ref_params[path]).abs()
        if grads is not None:
            g = grads[i]
            err = err[g.abs() >= 100 * (1e-4 * g.abs().max() + 1e-7)]
        assert err.numel() == 0 or float(err.max()) <= 1e-6, \
            f"{path}: params {float(err.max()):.3g} apart"


def test_phase1_step_loss_gradients_and_params_match(jax_trainer, port_trainer, reference):
    """Phase 1: the loss and its parts, every gradient (the decoder's
    nonzero, though frozen; the encoder's, the UNet's and the pooler's
    zero) and the grad norm against JAX's; then only the text encoder
    moves, to JAX's params."""
    jt, pt = jax_trainer, port_trainer
    _, pb = _batches(jt, pt)
    before = tree.map(lambda t: t.detach().clone(), pt.state.params)
    parts, grads = pt._grads(pb, draws={"rep_noise": reference["rep_noise"]})
    for k, v in reference["parts"].items():
        np.testing.assert_allclose(float(parts[k]), v, rtol=1e-5, err_msg=k)
    _assert_grads_close(reference["grads"], grads)
    assert float(grads["vae"]["decoder"]["final_conv"]["w"].abs().max()) > 0
    for part in (grads["unet"], grads["vae"]["encoder"], grads["text"]["bert"]["pooler"]):
        assert all(float(g.abs().max()) == 0.0 for g in tree.leaves(part))
    ref_grads = bridge.fit(pt.state.params, bridge.from_jax(_np(reference["grads"])), "grads")
    got = pt._apply_update(parts, grads)
    np.testing.assert_allclose(got["grad_norm"], reference["grad_norm"], rtol=1e-5)
    assert pt.state.step == 1 and pt.skipped_batches() == 0
    _params_close(pt, reference["phase1"], ref_grads)
    for k in ("vae", "unet"):
        for a, b in zip(tree.leaves(before[k]), tree.leaves(pt.state.params[k])):
            assert torch.equal(a, b.detach())

    pt.state = pt._fresh_state(tree.map(torch.clone, before), step=0, rng=pt.state.rng)
    pt._apply_update(parts, ref_grads)
    _params_close(pt, reference["phase1"])
    _carry_across(pt, jt)


def test_joint_step_moves_decoder_and_decays_the_unet(jax_trainer, port_trainer, reference):
    """After the switch: three groups with fresh state; the decoder moves
    with its gradient, the UNet (gradient 0) by -lr_unet * wd * p, the
    encoder not at all; all to JAX's tx_phase2 params within 1e-6."""
    jt, pt = jax_trainer, port_trainer
    before = tree.map(lambda t: t.detach().clone(), pt.state.params)
    pt.switch_to_joint_training()
    assert pt.phase == "joint" and set(pt.state.opt_state["groups"]) == {
        "text", "decoder", "unet"}
    ref_grads = bridge.fit(pt.state.params, bridge.from_jax(_np(reference["grads"])), "grads")
    pt._apply_update({}, ref_grads)
    _params_close(pt, reference["joint"])
    o = pt.cfg.optimization
    lr_unet = o.text_encoder_lr * 0.1
    for a, b in zip(tree.leaves(before["unet"]), tree.leaves(pt.state.params["unet"])):
        np.testing.assert_allclose(b.detach().numpy(),
                                   (a * (1 - lr_unet * o.weight_decay)).numpy(), rtol=0,
                                   atol=1e-6)
        assert float(a.abs().max()) == 0.0 or not torch.equal(a, b.detach())
    for a, b in zip(tree.leaves(before["vae"]["encoder"]),
                    tree.leaves(pt.state.params["vae"]["encoder"])):
        assert torch.equal(a, b.detach())
    assert not torch.equal(before["vae"]["decoder"]["final_conv"]["w"],
                           pt.state.params["vae"]["decoder"]["final_conv"]["w"].detach())
    assert all(g["count"] == 1 for g in pt.state.opt_state["groups"].values())
    _carry_across(pt, jt)


def test_cosine_schedule_restarts_at_the_switch(tmp_path_factory, corpus):
    """Under 'cosine' each group's schedule spans the whole run; the switch
    re-inits the optimizer state, so counts, bias correction and the
    schedule restart from step 0 (optax's init).  Two phase-1 steps, the
    switch, two joint steps with the same gradients in both packages."""
    exp = tmp_path_factory.mktemp("cos")
    jt = JaxTrainer(_tiny(JaxConfig, exp / "j", corpus, "cosine"), None, None,
                    experiment_name="j")
    pt = FinalTrainer(_tiny(Config, exp / "p", corpus, "cosine"), None, None,
                      experiment_name="p", device="cpu")
    pt.state = pt._fresh_state(bridge.fit(pt.state.params, bridge.from_jax(
        _np(jt.state.params))), step=0, rng=pt.state.rng)
    rs = np.random.RandomState(3)
    grads = [jax.tree_util.tree_map(lambda p: jnp.asarray(
        rs.standard_normal(p.shape).astype(np.float32) * 1e-2), jt.state.params)
        for _ in range(4)]
    params, tx = jt.state.params, jt.tx_phase1
    opt = tx.init(params)
    for i, g in enumerate(grads):
        if i == 2:
            tx = jt.tx_phase2
            opt = tx.init(params)
            pt.switch_to_joint_training()
        upd, opt = jax.jit(tx.update)(g, opt, params)
        params = optax.apply_updates(params, upd)
        pt._apply_update({}, bridge.fit(pt.state.params, bridge.from_jax(_np(g)), "g"))
    assert pt.tx.groups["text"]["lr_schedule"](1) < pt.tx.groups["text"]["lr_schedule"](0)
    assert pt.state.opt_state["groups"]["text"]["count"] == 2
    _params_close(pt, dict(tree.items(bridge.from_jax(_np(params)))))


def test_val_loss_matches_and_ignores_padded_tail(jax_trainer, port_trainer):
    """JAX's _eval (fold_in(rng, -3), the tail weighted 0) against the
    port's with that noise; corrupting the padded sample changes nothing."""
    jt, pt = jax_trainer, port_trainer
    jb, pb = _batches(jt, pt, seed=1)
    ref = jax.jit(jt._eval)(jt.state, jt.clip_params, jb, jnp.int32(1))
    noise = {"rep_noise": torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(jt.state.rng, jnp.int32(-3)), _latent(jt))))}
    got = pt._eval(pb, 1, draws=noise)
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, err_msg=k)
    tail = dict(pb, image=pb["image"].clone())
    tail["image"][1] = 0.77
    again = pt._eval(tail, 1, draws=noise)
    for k, v in got.items():
        assert float(again[k]) == pytest.approx(float(v), rel=1e-6), k
    assert float(pt._eval(pb, 2, draws=noise)["total_loss"]) != pytest.approx(
        float(got["total_loss"]), rel=1e-5)


def test_generate_samples_match(jax_trainer, port_trainer):
    """DDIM (the default) from JAX's initial latent: the sample grid's
    images within MAE 1e-3; DPM-Solver++ and the strided DDPM give finite
    images, and generate_samples writes the grid."""
    jt, pt = jax_trainer, port_trainer
    ids, mask = jt.tokenizer.encode_batch(CAPTIONS, 32)
    rng = jax.random.PRNGKey(7)
    ref = jt._sample(jt.state.params, rng, jnp.asarray(ids), jnp.asarray(mask), num=2,
                     steps=3, sampler="ddim")
    x_t = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[1], _latent(jt))))
    tid, tmask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    got = pt._sample(pt.state.params, None, tid, tmask, num=2, steps=3, initial_latent=x_t)
    assert float(np.abs(got.numpy() - np.asarray(ref)).mean()) <= 1e-3
    for sampler in ("dpmpp", "ddpm"):
        imgs = pt._sample(pt.state.params, torch.Generator().manual_seed(0), tid, tmask,
                          num=2, steps=3, sampler=sampler)
        assert imgs.shape == (2, 64, 64, 3) and torch.isfinite(imgs).all()
    path = pt.generate_samples(0, num=2, steps=2)
    assert path.name == "final_epoch_0000.png" and path.exists()


def test_final_bundle_is_read_and_served_by_both_packages(jax_trainer, port_trainer):
    """The port's stage-3 best holds {vae, text, unet} with stage 'final'
    and its phase: psg_tpu's load_params gives the port's params bit-equal,
    both hubs resolve it as a final bundle, and both generators serve it
    (the port-written analog of tests/test_serve.py::
    test_serve_stage3_final_bundle)."""
    from psg_tpu.serve.generator import PokemonGenerator as JaxGenerator
    from psg_tpu.serve.hub import resolve_checkpoints as jax_resolve

    from psg_tpu_torch.serve import hub
    from psg_tpu_torch.serve.generator import PokemonGenerator

    jt, pt = jax_trainer, port_trainer
    pt.state = pt._fresh_state(tree.map(lambda t: t.detach() + 0.01, pt.state.params),
                               step=3, rng=pt.state.rng)
    assert pt.save_checkpoint(1, 0.5)
    best = pt.ckpt.best_path
    meta = jax_load_metadata(best)
    assert (meta["step"], meta["stage"], meta["metric"], meta["epoch"],
            meta["training_phase"]) == (3, "final", 0.5, 1, "text_encoder")
    ref = dict(tree.items(bridge.from_jax(_np(jax_load_params(best, jt.state.params)))))
    for path, p in tree.items(pt.state.params):
        assert torch.equal(ref[path], p.detach()), path

    jcfg = JaxConfig(**{**jt.cfg.__dict__, "experiment_dir": pt.cfg.experiment_dir})
    assert jax_resolve(jcfg, "p", allow_hub=False) == (str(best), str(best))
    assert hub.resolve_checkpoints(pt.cfg, "p", allow_hub=False) == (str(best), str(best))
    served = JaxGenerator(jcfg, vae_checkpoint=str(best), diffusion_checkpoint=str(best),
                          tokenizer=jt.tokenizer)
    leaf = dict(tree.items(bridge.from_jax(_np(served.params))))
    assert torch.equal(leaf["vae.decoder.final_conv.w"],
                       pt.state.params["vae"]["decoder"]["final_conv"]["w"].detach())
    img = served.generate_from_text(CAPTIONS[0], num_inference_steps=2, seed=0)
    assert img.size == (64, 64)
    gen = PokemonGenerator(pt.cfg, vae_checkpoint=str(best), diffusion_checkpoint=str(best),
                           tokenizer=pt.tokenizer, device="cpu")
    assert gen.loaded == "final-bundle"
    assert np.asarray(gen.generate_from_text(CAPTIONS[0], 2, seed=0)).shape == (64, 64, 3)
    _carry_across(pt, jt)


def _same_state(a, b):
    for name in ("params", "opt_state"):
        x, y = dict(tree.items(getattr(a, name))), dict(tree.items(getattr(b, name)))
        assert set(x) == set(y), name
        for path, u in x.items():
            v = y[path]
            if isinstance(u, torch.Tensor):
                assert u.dtype == v.dtype and torch.equal(u.detach(), v.detach()), path
            else:
                assert u == v, path
    assert a.step == b.step


def test_resume_from_phase1_and_from_a_joint_checkpoint(jax_trainer, port_trainer, tmp_path):
    """A phase-1 checkpoint resumes in phase 1; a joint one switches first
    and restores its three groups' moments and counts with the params
    (the JAX trainer restores into its phase-1 template and re-inits the
    moments at the switch: see the last test)."""
    jt, pt = jax_trainer, port_trainer
    _, pb = _batches(jt, pt)
    pt._step(pb)
    pt.ckpt.dir = tmp_path / "p1"
    pt.ckpt.dir.mkdir()
    pt.ckpt.best_metric = float("inf")
    assert pt.save_checkpoint(0, 0.9)
    fresh = FinalTrainer(pt.cfg, None, None, experiment_name="r1", device="cpu")
    fresh.load_checkpoint(str(pt.ckpt.best_path))
    assert fresh.phase == "text_encoder" and fresh.start_epoch == 1
    _same_state(fresh.state, pt.state)

    pt.switch_to_joint_training()
    pt._step(pb)
    pt.ckpt.dir = tmp_path / "joint"
    pt.ckpt.dir.mkdir()
    pt.ckpt.best_metric = float("inf")
    assert pt.save_checkpoint(1, 0.8)
    fresh = FinalTrainer(pt.cfg, None, None, experiment_name="r2", device="cpu")
    fresh.load_checkpoint(str(pt.ckpt.best_path))
    assert fresh.phase == "joint" and fresh.start_epoch == 2 and fresh.best_val == 0.8
    _same_state(fresh.state, pt.state)
    assert float(fresh.state.opt_state["groups"]["unet"]["nu"][
        "unet.time_mlp.l1.w"].abs().max()) == 0.0      # the UNet's gradient is 0
    assert float(fresh.state.opt_state["groups"]["decoder"]["nu"][
        "vae.decoder.final_conv.w"].abs().max()) > 0.0
    assert fresh.train() == fresh.ckpt.best_path      # nothing left to train
    _carry_across(pt, jt)


def test_fast_epoch_and_validation_match(jax_trainer, port_trainer):
    """JAX's fast epoch (1 scanned step: draw, gather, loss, optax, phase
    1) against the port's train_epoch_fast with JAX's draws (fold_in(rng,
    step), split 3), augmentation off; then the fast validation
    (fold_in(fold_in(rng, -3), i) a batch) from the state both reached."""
    jt, pt = jax_trainer, port_trainer
    jt.cfg.data.augment = pt.cfg.data.augment = False
    try:
        jt._setup_fast_data()
        pt._setup_fast_data()
        jt._fast_len = 1
        k_idx, _, k_loss = jax.random.split(jax.random.fold_in(jt.state.rng, jt.state.step), 3)
        n = jt._train_data["images"].shape[0]
        draws = [{"uniforms": torch.from_numpy(np.array(jax.random.uniform(k_idx, (n,)))),
                  "rep_noise": torch.from_numpy(np.array(jax.random.normal(k_loss,
                                                                           _latent(jt))))}]
        state, ys = jt._fast_epoch_impl(jt.state, jt.clip_params, jt._train_data)
        with recorded_grads(pt) as seen:
            stats = pt.train_epoch_fast(0, draws)
    finally:
        jt.cfg.data.augment = pt.cfg.data.augment = True
    for k in ("total_loss", "l1_loss", "mse_loss", "clip_loss", "grad_norm"):
        np.testing.assert_allclose(stats[k], float(np.asarray(ys[k])[0]), rtol=1e-5, err_msg=k)
    assert pt.state.step == int(state.step) == 1
    assert_determined_close(pt.state.params, bridge.from_jax(_np(state.params)), seen,
                            "params")
    val_draws = [{"rep_noise": torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(state.rng, jnp.int32(-3)), i), _latent(jt))))}
        for i in range(jt._val_data["images"].shape[0])]
    ref = float(jt._fast_val_impl(state, jt.clip_params, jt._val_data))
    np.testing.assert_allclose(pt.validate_fast(0, val_draws), ref, rtol=1e-5)
    _carry_across(pt, jt)


def test_named_weights_must_exist(port_trainer, tmp_path, monkeypatch, caplog):
    """A named CLIP checkpoint, CLIP BPE directory, VAE or diffusion
    checkpoint must exist; with nothing named the log says what was drawn.
    With training.fast_path, train() runs the fast path, switching to the
    joint phase at its first epoch (phase1_epochs 0), and writes a light
    joint best."""
    cfg = port_trainer.cfg
    with monkeypatch.context() as m:
        m.setenv("PSG_TPU_CLIP", str(tmp_path / "missing.ckpt"))
        with pytest.raises(FileNotFoundError, match="PSG_TPU_CLIP"):
            FinalTrainer(cfg, None, None, experiment_name="w", device="cpu")
    with monkeypatch.context() as m:
        m.setenv("PSG_TPU_CLIP_BPE", str(tmp_path))
        with pytest.raises(FileNotFoundError, match="PSG_TPU_CLIP_BPE"):
            FinalTrainer(cfg, None, None, experiment_name="w", device="cpu")
    for vae, diff in ((tmp_path / "vae.ckpt", None), (None, tmp_path / "diff.ckpt")):
        with pytest.raises(FileNotFoundError, match="checkpoint not found"):
            FinalTrainer(cfg, vae, diff, experiment_name="w", device="cpu")
    fast = Config(**{**cfg.__dict__})
    fast.training = type(cfg.training)(**{**cfg.training.__dict__, "fast_path": True,
                                          "final_epochs": 1, "phase1_epochs": 0})
    with caplog.at_level(logging.INFO):
        t = FinalTrainer(fast, None, None, experiment_name="f", device="cpu")
        best = t.train()
    meta = jax_load_metadata(best)
    assert meta["light"] is True and meta["training_phase"] == meta["phase"] == "joint"
    assert t.phase == "joint" and "switching to joint training" in caplog.text
    assert (t.ckpt.dir / f"final_step_{t.state.step:08d}.ckpt").exists()
    with caplog.at_level(logging.INFO):
        t = FinalTrainer(cfg, None, None, experiment_name="w", device="cpu")
    assert "clip=random-init (text ids: WordPiece)" in caplog.text
    assert "VAE and text drawn from seed" in caplog.text and "UNet drawn from seed" in caplog.text
    assert t.clip_bpe is None and "clip_ids" not in t._batch(next(iter(t.train_loader)))


def test_bpe_ids_feed_a_pretrained_clip(port_trainer, tmp_path, monkeypatch):
    """With both a CLIP checkpoint and the BPE files, the loss reads BPE ids
    (the loader's clip_ids) and the CLIP parameters from the file; with the
    BPE files alone, WordPiece ids and a random CLIP.  (ViT-B/32 is swapped
    for the tiny tower, so that the check runs on the CPU.)"""
    from psg_tpu_torch.core.checkpoint import save_state
    from psg_tpu_torch.models.clip import ClipConfig, clip_init
    from test_torch_clip import _toy_vocab

    vocab, merges = _toy_vocab()
    (tmp_path / "clip_vocab.json").write_text(json.dumps(vocab))
    (tmp_path / "clip_merges.txt").write_text("\n".join(" ".join(m) for m in merges))
    monkeypatch.setenv("PSG_TPU_CLIP_BPE", str(tmp_path))
    t = FinalTrainer(port_trainer.cfg, None, None, experiment_name="bpe0", device="cpu")
    assert t.clip_bpe is None and t.clip_cfg.text_vocab == t.tokenizer.vocab_size

    class Tiny(ClipConfig):
        @classmethod
        def b32(cls):
            return ClipConfig.tiny_test()

    monkeypatch.setattr(stage3_final, "ClipConfig", Tiny)
    clip = clip_init(torch.Generator().manual_seed(5), ClipConfig.tiny_test(len(vocab)))
    save_state(tmp_path / "clip.ckpt", bridge.to_jax(clip))
    monkeypatch.setenv("PSG_TPU_CLIP", str(tmp_path / "clip.ckpt"))
    t = FinalTrainer(port_trainer.cfg, None, None, experiment_name="bpe1", device="cpu")
    assert t.clip_bpe is not None and t.clip_cfg.text_vocab == len(vocab)
    for a, b in zip(tree.leaves(t.clip_params), tree.leaves(clip)):
        assert torch.equal(a, b)
    batch = t._batch(next(iter(t.train_loader)))
    assert batch["clip_ids"].shape == (2, 77) and int(batch["clip_ids"][0, 0]) == t.clip_bpe.sot_id
    parts, _ = t._grads(batch)
    assert np.isfinite(float(parts["clip_loss"]))


def test_jax_drops_a_joint_checkpoints_moments(jax_trainer, tmp_path):
    """What the JAX package does with a joint-phase checkpoint (ROADMAP
    Queue C): its load_checkpoint restores into the phase-1 template (flax
    accepts it) and then switches, which re-inits the optimizer state: the
    params come back, the three groups' moments do not."""
    jt = jax_trainer
    params0 = jt.state.params
    cfg = JaxConfig(**{**jt.cfg.__dict__, "experiment_dir": str(tmp_path)})
    src = JaxTrainer(cfg, None, None, experiment_name="src")
    src.switch_to_joint_training()
    src.state = src.state._replace(
        params=jax.tree_util.tree_map(lambda p: p + 0.5, params0),
        opt_state=jax.tree_util.tree_map(
            lambda x: x + 1 if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
            else x, src.state.opt_state))
    src.save_checkpoint(1, 0.5)
    dst = JaxTrainer(cfg, None, None, experiment_name="dst")
    dst.load_checkpoint(str(src.ckpt.best_path))
    assert dst.phase == "joint"
    for a, b in zip(jax.tree_util.tree_leaves(dst.state.params),
                    jax.tree_util.tree_leaves(src.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    moments = [np.asarray(x) for x in jax.tree_util.tree_leaves(dst.state.opt_state)
               if hasattr(x, "ndim") and x.ndim > 0]
    assert moments and all(float(np.abs(m).max()) == 0.0 for m in moments)

def test_step_seam_spans_and_zero_fill(jax_trainer, port_trainer):
    """One ``_step`` as the benchmark's harness sees it (``step_seam``): the
    instance's ``_grads`` and ``_apply_update`` each run once, the step
    reads the host once, and the ``psg.train.*`` ranges nest as
    ``StageTrainer`` opens them.  BERT's pooler, which the loss does not
    reach, gets a zero gradient of its shape (``tree_grads``' fill)."""
    pt = port_trainer
    _, pb = _batches(jax_trainer, pt)
    before = tree.map(lambda t: t.detach().clone(), pt.state.params)
    rng = pt.state.rng.get_state()
    grads = step_seam(pt, lambda: pt._step(pb))
    pooler = grads["text"]["bert"]["pooler"]["w"]
    assert pooler.shape == before["text"]["bert"]["pooler"]["w"].shape
    assert float(pooler.abs().max()) == 0.0
    pt.state.rng.set_state(rng)
    pt.state = pt._fresh_state(before, step=0, rng=pt.state.rng)
