"""psg_tpu_torch's stage-1 trainer against psg_tpu's VAETrainer on the CPU, at
the JAX stage-1 tests' tiny config (tests/test_train_stage1.py: BERT
tiny-test, VAE x0.25, 64 px, batch 2, text_len 32) over a sprite corpus made
from a seed.

The JAX trainer's random-init VAE and text encoder and its random VGG16
(PRNGKey(1234)) go through the bridge into the port; inputs are made with
numpy; JAX's reparameterize noise (normal of fold_in(rng, step)) is injected
into the port.  Bounds: loss within rel 1e-5 (fp32); VAE and text gradients
per leaf within 1e-4 * max|g_jax| + 1e-7; grad_norm within rel 1e-5; params
after a step within 1e-6.  The port's decoder runs its two narrowest fused
spatial sites and the two next through ``SpatialXattn`` (the plain forward on
the CPU), the JAX package's through its XLA path.

The fast path (``_fast_epoch_impl``, ``_fast_val_impl``) with
``data.augment`` off: JAX's index uniforms (fold_in(rng, step), split 3)
and reparameterize noises are injected.  Bounds: the first step's loss
parts and grad norm within rel 1e-5.  Adam's first step moves every
element by lr * sign(g), so an element whose gradient is below the two
packages' agreement (1e-4 * max|g| + 1e-7) may move by +-lr in either: the
second step starts from parameters up to 2 * lr apart there, and its loss
parts, grad norm and gradients agree to rel 1e-3 (``LATER_STEP_RTOL``;
measured 4e-5 for the KL term, 1.4e-4 for the grad norm), as does the
fast validation from the state both reached.  Params after the epoch
within 1e-6 + 0.01 * lr wherever each step's gradient is determined (the
one-step test's rule at each step's bound, judged on the port's own
gradients): such a gradient agrees to 1%, and so does Adam's step, at most
lr (measured 1.2e-6 at lr 3e-4)."""

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
from psg_tpu.train.stage1_vae import VAETrainer as JaxTrainer

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import bridge
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.train import cli
from psg_tpu_torch.train.stage1_vae import VAETrainer
from test_torch_fastpath import assert_determined_close, recorded_grads, step_seam

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

CAPTIONS = ["a small green creature with leaves", "a red fire lizard with a flame"]
LATER_STEP_RTOL = 1e-3      # a fast epoch's steps after the first; see the docstring


def _tiny(cls, exp, corpus):
    cfg = cls()
    cfg.experiment_dir = str(exp)
    cfg.model.bert_model = "tiny-test"
    cfg.model.vae_width_scale = 0.25
    cfg.model.text_embedding_dim = 48
    cfg.data.csv_path, cfg.data.image_dir = str(corpus[0]), str(corpus[1])
    cfg.data.image_size = 64
    cfg.data.batch_size = 2
    cfg.data.text_len = 32
    cfg.data.num_workers = 2
    cfg.training.vae_epochs = 1
    cfg.training.log_every = 1
    cfg.training.sample_every = 1
    return cfg


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module", autouse=True)
def no_weight_files():
    """No pretrained weights are named: both packages draw BERT and VGG16."""
    mp = pytest.MonkeyPatch()
    for var in ("PSG_TPU_BERT", "PSG_TPU_BERT_VOCAB", "PSG_TPU_VGG16"):
        mp.delenv(var, raising=False)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=12, seed=0, size=64)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory, corpus):
    return JaxTrainer(_tiny(JaxConfig, tmp_path_factory.mktemp("jax_exp"), corpus),
                      experiment_name="j")


def _carry_across(pt, jt):
    """The JAX trainer's params and VGG16 into the port's trainer, with a
    fresh optimizer state."""
    pt.state = pt._fresh_state(bridge.fit(pt.state.params, bridge.from_jax(
        _np(jt.state.params))), step=0, rng=pt.state.rng)
    pt.vgg_params = prepare_weights(bridge.fit(pt.vgg_params, bridge.from_jax(
        _np(jt.vgg_params))))


@pytest.fixture(scope="module")
def port_trainer(tmp_path_factory, corpus, jax_trainer):
    t = VAETrainer(_tiny(Config, tmp_path_factory.mktemp("port_exp"), corpus),
                   experiment_name="p", device="cpu")
    _carry_across(t, jax_trainer)
    return t


def _batches(jt, pt):
    images = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ids, mask = jt.tokenizer.encode_batch(CAPTIONS, 32)
    jb = {"image": jnp.asarray(images), "text_ids": jnp.asarray(ids),
          "text_mask": jnp.asarray(mask)}
    return jb, pt._batch({"image": images, "text_ids": ids, "text_mask": mask})


def _assert_grads_close(jgrads, pgrads):
    ref = dict(tree.items(bridge.from_jax(_np(jgrads))))
    got = dict(tree.items(pgrads))
    assert set(ref) == set(got)
    for path, r in ref.items():
        g = got[path]
        bound = 1e-4 * float(r.abs().max()) + 1e-7
        err = float((g - r).abs().max())
        assert err <= bound, f"{path}: max|dg| {err:.3g} > {bound:.3g}"


def test_one_step_loss_gradients_and_params_match(jax_trainer, port_trainer):
    """JAX's step (fold_in(rng, step), value_and_grad of _forward_loss, the
    multi-group optax update) against the port's _step with JAX's
    reparameterize noise: the loss and its parts, every VAE and text
    gradient (frozen BERT layers and the unused pooler included) and the
    grad norm.  Params after the update: within 1e-6 everywhere when the
    port's optimizer takes JAX's gradients; from the port's own gradients,
    within 1e-6 wherever the gradient is determined (|g| at least 100 times
    the gradients' bound).  Adam's first step moves each element by lr * g / (|g| +
    1e-8), so an element whose gradient is rounding noise in both packages
    (a conv bias ahead of a GroupNorm: 0 in exact arithmetic, +-1e-9 here)
    moves by +-lr in either, whatever the gradients' agreement."""
    jt, pt = jax_trainer, port_trainer
    jb, pb = _batches(jt, pt)
    klw = jt.kl_weight(1)
    rng = jax.random.fold_in(jt.state.rng, jt.state.step)
    lat = (2, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)
    draws = {"rep_noise": torch.from_numpy(np.array(jax.random.normal(rng, lat,
                                                                      jnp.float32)))}
    (ref, jparts), jgrads = jax.value_and_grad(
        lambda p: jt._forward_loss(p, jt.vgg_params, jb, rng, jnp.float32(klw), "train"),
        has_aux=True)(jt.state.params)
    updates, _ = jt.tx.update(jgrads, jt.state.opt_state, jt.state.params)
    ref_params = dict(tree.items(bridge.from_jax(_np(optax.apply_updates(
        jt.state.params, updates)))))
    ref_grads = bridge.fit(pt.state.params, bridge.from_jax(_np(jgrads)), "grads")

    before = tree.map(lambda t: t.detach().clone(), pt.state.params)
    parts, grads = pt._grads(pb, klw, draws=draws)
    for k in ("total_loss", "reconstruction_loss", "perceptual_loss", "kl_loss"):
        np.testing.assert_allclose(float(parts[k]), float(jparts[k]), rtol=1e-5, err_msg=k)
    _assert_grads_close(jgrads, grads)
    assert float(grads["text"]["bert"]["pooler"]["w"].abs().max()) == 0.0
    got = pt._apply_update(parts, grads, klw)
    np.testing.assert_allclose(got["grad_norm"], float(jax_global_norm(jgrads)), rtol=1e-5)
    assert pt.state.step == 1 and got["kl_weight"] == klw and pt.skipped_batches() == 0
    for (path, p), g in zip(tree.items(pt.state.params), tree.leaves(ref_grads)):
        # 100x the gradients' bound: the element's update does not hang on noise
        determined = g.abs() >= 100 * (1e-4 * g.abs().max() + 1e-7)
        err = (p.detach() - ref_params[path])[determined].abs()
        assert err.numel() == 0 or float(err.max()) <= 1e-6, \
            f"{path}: params {float(err.max()):.3g} apart where |g| is determined"
    # 'minimal': the embeddings are frozen (no update), the last layer moves
    assert torch.equal(before["text"]["bert"]["embeddings"]["word"],
                       pt.state.params["text"]["bert"]["embeddings"]["word"])
    assert not torch.equal(before["text"]["bert"]["layers"][-1]["ffn"]["w1"]["w"],
                           pt.state.params["text"]["bert"]["layers"][-1]["ffn"]["w1"]["w"])

    # a copy: the optimizer updates in place, and ``before`` restores the trainer below
    pt.state = pt._fresh_state(tree.map(torch.clone, before), step=0, rng=pt.state.rng)
    pt._apply_update(parts, ref_grads, klw)
    for path, p in tree.items(pt.state.params):
        np.testing.assert_allclose(p.detach().numpy(), ref_params[path].numpy(), rtol=0,
                                   atol=1e-6, err_msg=path)
    pt.state = pt._fresh_state(before, step=0, rng=pt.state.rng)


@pytest.mark.parametrize("strategy", ["none", "minimal", "partial", "full"])
def test_finetune_mask_and_labels_match(jax_trainer, port_trainer, strategy):
    """finetune_mask and labels_from_mask leaf for leaf against the JAX
    package's, over the text tower's parameters."""
    from psg_tpu.models.text_encoder import finetune_mask as jax_finetune_mask
    from psg_tpu.train.optim import labels_from_mask as jax_labels_from_mask

    from psg_tpu_torch.models.text_encoder import finetune_mask
    from psg_tpu_torch.train.optim import labels_from_mask

    ref = jax_labels_from_mask(jax_finetune_mask(jax_trainer.state.params["text"],
                                                 jax_trainer.bert_cfg, strategy), "text")
    ref = dict(tree.items(bridge.from_jax(jax.tree_util.tree_map(
        lambda lab: np.asarray(lab == "text"), ref))))
    got = labels_from_mask(finetune_mask(port_trainer.state.params["text"],
                                         port_trainer.bert_cfg, strategy), "text")
    paths = [path for path, _ in tree.items(port_trainer.state.params["text"])]
    assert [path for path, _ in tree.items(got)] == paths    # the optimizer's pairing
    assert {path: lab == "text" for path, lab in tree.items(got)} == \
        {path: bool(v) for path, v in ref.items()}


@pytest.mark.parametrize("mode", ["generate", "sample"])
def test_vae_apply_modes_match(jax_trainer, port_trainer, mode):
    """vae_apply's 'generate' (decode the mean) and 'sample' (decode a prior
    draw, JAX's injected) against the JAX package's."""
    from psg_tpu.models.text_encoder import text_encoder_apply as jax_text_apply
    from psg_tpu.models.unet import text_bias_from_mask as jax_text_bias
    from psg_tpu.models.vae import vae_apply as jax_vae_apply

    from psg_tpu_torch.models.text_encoder import text_encoder_apply
    from psg_tpu_torch.models.unet import text_bias_from_mask
    from psg_tpu_torch.models.vae import vae_apply

    jt, pt = jax_trainer, port_trainer
    jb, pb = _batches(jt, pt)
    key = jax.random.PRNGKey(3)
    emb = jax_text_apply(jt.state.params["text"], jb["text_ids"], jb["text_mask"],
                         jt.bert_cfg)
    ref = jax_vae_apply(jt.state.params["vae"], key, jb["image"], emb, mode,
                        latent_dim=8, latent_size=jt.latent_size,
                        text_bias=jax_text_bias(jb["text_mask"]))
    noise = None
    if mode == "sample":
        noise = torch.from_numpy(np.array(jax.random.normal(
            key, (2, jt.latent_size, jt.latent_size, 8), jnp.float32)))
    with torch.no_grad():
        pemb = text_encoder_apply(pt.state.params["text"], pb["text_ids"], pb["text_mask"],
                                  pt.bert_cfg)
        np.testing.assert_allclose(pemb.numpy(), np.asarray(emb), rtol=1e-5, atol=1e-5)
        # JAX's embedding into both decoders
        got = vae_apply(pt.state.params["vae"], None, pb["image"], torch.from_numpy(
            np.array(emb)), mode, latent_size=pt.latent_size,
            text_bias=text_bias_from_mask(pb["text_mask"]), noise=noise)
    # the decoder's bound in tests/test_torch_models.py::test_vae_decoder_matches
    np.testing.assert_allclose(got["reconstructed"].numpy(), np.asarray(ref["reconstructed"]),
                               rtol=1e-4, atol=2e-5)
    if mode == "generate":
        np.testing.assert_allclose(got["mu"].numpy(), np.asarray(ref["mu"]), rtol=1e-4,
                                   atol=1e-5)
    else:
        assert got["mu"] is None and ref["mu"] is None


@pytest.mark.parametrize("size", [64, 201])
def test_perceptual_loss_matches(jax_trainer, port_trainer, size):
    """perceptual_loss against the JAX package's on its random VGG16: at 64
    px through the resize to 224, at 201 px without it (odd sizes floor at
    each pool: 201 -> 100 -> 50), with sample weights."""
    from psg_tpu.models.losses import perceptual_loss as jax_perceptual_loss

    from psg_tpu_torch.models.losses import perceptual_loss

    rng = np.random.RandomState(size)
    a, b = (rng.uniform(-0.1, 1.1, (2, size, size, 3)).astype(np.float32) for _ in range(2))
    w = np.array([1.0, 0.0], np.float32)
    ref = jax_perceptual_loss(jax_trainer.vgg_params, jnp.asarray(a), jnp.asarray(b),
                              sample_weights=jnp.asarray(w))
    got = perceptual_loss(port_trainer.vgg_params, torch.from_numpy(a), torch.from_numpy(b),
                          sample_weights=torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_kl_anneal_weight_matches(jax_trainer, port_trainer):
    assert [port_trainer.kl_weight(e) for e in range(5)] == \
        [jax_trainer.kl_weight(e) for e in range(5)]
    assert port_trainer.kl_weight(0) == 0.0 and port_trainer.kl_weight(4) == \
        pytest.approx(0.01)


def test_val_loss_ignores_padded_tail(port_trainer):
    """Validation weights the wraparound-padded tail 0 in every term:
    corrupting the padding leaves each part as it was, corrupting a valid
    sample does not."""
    pt = port_trainer
    images = np.random.RandomState(1).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ids, mask = pt.tokenizer.encode_batch(CAPTIONS, 32)
    batch = {"image": images, "text_ids": ids, "text_mask": mask}
    base = pt._eval(pt._batch(batch), 1, 0.01)
    tail = dict(batch, image=images.copy())
    tail["image"][1:] = 0.77
    got = pt._eval(pt._batch(tail), 1, 0.01)
    for k, v in base.items():
        assert float(got[k]) == pytest.approx(float(v), rel=1e-5), k
    head = dict(batch, image=images.copy())
    head["image"][0] = 0.77
    assert float(pt._eval(pt._batch(head), 1, 0.01)["total_loss"]) != pytest.approx(
        float(base["total_loss"]), rel=1e-5)


def test_checkpoint_jax_reads_and_port_resumes(jax_trainer, port_trainer):
    """The port's stage-1 best holds {vae, text} with stage 'vae' and the
    two-group optimizer state; psg_tpu's load_params (what its stage 2
    reads the frozen VAE and text with) gives the port's params bit-equal;
    a fresh port trainer resumes the whole state bit-equal."""
    jt, pt = jax_trainer, port_trainer
    _, pb = _batches(jt, pt)
    pt._step(pb, 0.005)
    assert pt.save_checkpoint(0, 0.75)
    best = pt.ckpt.best_path
    meta = jax_load_metadata(best)
    assert (meta["step"], meta["stage"], meta["metric"], meta["epoch"]) == (1, "vae", 0.75, 0)
    loaded = jax_load_params(best, {"vae": jt.state.params["vae"],
                                    "text": jt.state.params["text"]})
    ref = dict(tree.items(bridge.from_jax(_np(loaded))))
    for path, p in tree.items(pt.state.params):
        assert torch.equal(ref[path], p.detach()), path
    assert set(pt.state.opt_state["groups"]) == {"vae", "text"}

    fresh = VAETrainer(pt.cfg, experiment_name="p", device="cpu")
    fresh.load_checkpoint(str(best))
    for name in ("params", "opt_state"):
        a = dict(tree.items(getattr(fresh.state, name)))
        b = dict(tree.items(getattr(pt.state, name)))
        assert set(a) == set(b)
        for path, x in a.items():
            y = b[path]
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach()), path
            else:
                assert x == y, path
    assert fresh.state.step == 1 and fresh.start_epoch == 1 and fresh.best_val == 0.75
    assert torch.equal(fresh.state.rng.get_state(), pt.state.rng.get_state())
    _carry_across(pt, jt)


def test_checkpoint_lists_past_ten_round_trip(tmp_path):
    """BERT-base's 12 layers: a list of more than 10 entries is written as a
    dict keyed '0'..'11' and read back as a list (a lexicographic key check
    took '10' before '2' and refused the full-width stage-1 checkpoint)."""
    from psg_tpu_torch.core.checkpoint import load_params, save_state

    tree_ = {"text": {"layers": [{"w": torch.full((2, 3), float(i))} for i in range(12)]}}
    path = tmp_path / "twelve.ckpt"
    save_state(path, {"params": bridge.to_jax(tree_)})
    back = load_params(path, tree.map(torch.zeros_like, tree_))
    assert [float(layer["w"][0, 0]) for layer in back["text"]["layers"]] == list(range(12))
    assert jax_load_params(path, {"text": {"layers": [
        {"w": np.zeros((2, 3), np.float32)} for _ in range(12)]}})["text"]["layers"][11][
            "w"][0, 0] == 11.0


def _fast_draws(jt, step: int):
    """JAX's draws for the fast step at ``step``: the index uniforms and
    the reparameterize noise (fold_in(rng, step), split 3)."""
    k_idx, _, k_loss = jax.random.split(jax.random.fold_in(jt.state.rng, step), 3)
    n = jt._train_data["images"].shape[0]
    lat = (2, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)
    return {"uniforms": torch.from_numpy(np.array(jax.random.uniform(k_idx, (n,)))),
            "rep_noise": torch.from_numpy(np.array(jax.random.normal(k_loss, lat)))}


def test_fast_epoch_and_validation_match(jax_trainer, port_trainer):
    """JAX's fast epoch (2 scanned steps: draw, gather, loss at epoch 1's KL
    weight, optax) against the port's train_epoch_fast with JAX's draws,
    augmentation off; then the fast validation (fold_in(fold_in(rng, -1),
    i) a batch) from the state both reached."""
    jt, pt = jax_trainer, port_trainer
    jt.cfg.data.augment = pt.cfg.data.augment = False
    try:
        jt._setup_fast_data()
        pt._setup_fast_data()
        for k in ("images", "text_ids", "text_mask"):
            np.testing.assert_array_equal(pt._val_data[k].numpy(), np.asarray(jt._val_data[k]))
        jt._fast_len = 2
        draws = [_fast_draws(jt, int(jt.state.step) + s) for s in range(2)]
        state, ys = jt._fast_epoch_impl(jt.state, jt.vgg_params, jt._train_data,
                                        jnp.float32(jt.kl_weight(1)))
        with recorded_grads(pt) as seen:
            klw = pt.kl_weight(1)
            got = pt._fast_epoch(lambda batch, draws: pt._step(batch, klw, draws=draws), draws)
    finally:
        jt.cfg.data.augment = pt.cfg.data.augment = True
    for k in ("total_loss", "reconstruction_loss", "perceptual_loss", "kl_loss",
              "grad_norm"):
        ref = np.asarray(ys[k])
        np.testing.assert_allclose(got[k][0], ref[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k][1:], ref[1:], rtol=LATER_STEP_RTOL, err_msg=k)
    assert pt.state.step == int(state.step) == 2
    # the second step's determined elements: gradients within 1% (100 times
    # their bound), so Adam's step (at most lr) within 1% of lr
    assert_determined_close(pt.state.params, bridge.from_jax(_np(state.params)), seen,
                            "params", atol=1e-6 + 0.01 * pt.cfg.optimization.learning_rate,
                            grad_rtols=[1e-4, LATER_STEP_RTOL])
    lat = (2, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)
    val_draws = [{"rep_noise": torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(jax.random.fold_in(state.rng, jnp.int32(-1)), i), lat)))}
        for i in range(jt._val_data["images"].shape[0])]
    ref = float(jt._fast_val_impl(state, jt.vgg_params, jt._val_data,
                                  jnp.float32(jt.kl_weight(1))))
    np.testing.assert_allclose(pt.validate_fast(1, val_draws), ref, rtol=LATER_STEP_RTOL)
    _carry_across(pt, jt)


def test_named_weight_files_must_exist(port_trainer, tmp_path, monkeypatch):
    """A weight file that an environment variable or extra.text_init names
    must exist: the trainer raises instead of drawing random weights.  With
    training.fast_path, train() runs the fast path: an epoch, the light best
    and the final full state."""
    cfg = port_trainer.cfg
    for var in ("PSG_TPU_BERT", "PSG_TPU_VGG16"):
        with monkeypatch.context() as m:
            m.setenv(var, str(tmp_path / "missing.ckpt"))
            with pytest.raises(FileNotFoundError, match=var):
                VAETrainer(cfg, experiment_name="w", device="cpu")
    bad = Config(**{**cfg.__dict__, "extra": {"text_init": str(tmp_path / "mlm.ckpt")}})
    with pytest.raises(FileNotFoundError, match="text_init"):
        VAETrainer(bad, experiment_name="w", device="cpu")
    fast = Config(**{**cfg.__dict__})
    fast.training = type(cfg.training)(**{**cfg.training.__dict__, "fast_path": True,
                                          "sample_every": 100})
    t = VAETrainer(fast, experiment_name="f", device="cpu")
    best = t.train()
    assert jax_load_metadata(best)["light"] is True and t.state.step == t._fast_len
    assert (t.ckpt.dir / f"vae_step_{t.state.step:08d}.ckpt").exists()
    assert np.isfinite(t.best_val)


def test_text_init_warm_starts_the_text_tower(port_trainer, tmp_path):
    """extra.text_init: the text subtree of a checkpoint ({text, mlm}, as
    stage 0 writes it) replaces the drawn text tower."""
    from psg_tpu_torch.core.checkpoint import save_state

    pt = port_trainer
    text = tree.map(lambda t: t.detach() + 0.5, pt.state.params["text"])
    path = tmp_path / "mlm_best_model.ckpt"
    save_state(path, {"params": {"text": bridge.to_jax(text),
                                 "mlm": {"bias": torch.zeros(3)}}})
    cfg = Config(**{**pt.cfg.__dict__, "extra": {"text_init": str(path)}})
    t = VAETrainer(cfg, experiment_name="ti", device="cpu")
    for (path_, a), b in zip(tree.items(t.state.params["text"]), tree.leaves(text)):
        assert torch.equal(a.detach(), b), path_


def test_cli_stage1_then_stage2_from_its_checkpoint(tmp_path, monkeypatch, capsys, caplog):
    """``--stage 1 --device cpu`` trains an epoch and writes its best and a
    sample grid; ``--stage 2`` in the same experiment then loads its frozen
    VAE and text from that stage-1 file (not from the seed)."""
    def no_lookup(*a, **k):
        raise AssertionError("DNS lookup attempted")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(socket, "getaddrinfo", no_lookup)
    csv, images = write_sprite_corpus(tmp_path / "corpus", n=7, seed=1, size=64)
    common = ["--device", "cpu", "--config", str(tmp_path / "none.yaml"),
              "--experiment-name", "cli"] + [f"--override={o}" for o in (
                  f"experiment_dir={tmp_path / 'exp'}", "model.bert_model=tiny-test",
                  "model.vae_width_scale=0.25", "model.text_embedding_dim=48",
                  "model.unet_channels=[16,24,32,32]", "model.time_emb_dim=32",
                  "data.image_size=64", "data.text_len=32", f"data.csv_path={csv}",
                  f"data.image_dir={images}", "data.batch_size=3", "data.num_workers=2",
                  "training.vae_epochs=1", "training.diffusion_epochs=1",
                  "training.sample_every=1", "extra.sample_steps=2")]
    assert cli.main(["--stage", "1"] + common) == 0
    stage1 = tmp_path / "exp" / "cli_vae"
    best = stage1 / "checkpoints" / "vae_best_model.ckpt"
    meta = json.loads(best.with_suffix(".json").read_text())
    assert meta["step"] == 2 and meta["stage"] == "vae" and meta["epoch"] == 0
    assert (stage1 / "samples" / "epoch_0000.png").exists()
    assert (stage1 / "samples" / "recon_0000.png").exists()
    assert "stage 1 complete" in capsys.readouterr().out

    with caplog.at_level(logging.INFO, logger="psg_tpu_torch.diffusion"):
        assert cli.main(["--stage", "2"] + common) == 0
    assert f"loaded frozen VAE/text from {best}" in caplog.text
    assert "drawn from seed" not in caplog.text
    stage2 = tmp_path / "exp" / "cli_diffusion" / "checkpoints" / "diffusion_best_model.ckpt"
    meta2 = json.loads(stage2.with_suffix(".json").read_text())
    assert meta2["vae_checkpoint"] == str(best) and meta2["step"] == 2

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
    grads = step_seam(pt, lambda: pt._step(pb, jax_trainer.kl_weight(1)))
    pooler = grads["text"]["bert"]["pooler"]["w"]
    assert pooler.shape == before["text"]["bert"]["pooler"]["w"].shape
    assert float(pooler.abs().max()) == 0.0
    pt.state.rng.set_state(rng)
    pt.state = pt._fresh_state(before, step=0, rng=pt.state.rng)
