"""psg_tpu_torch's stage-2 trainer against psg_tpu's DiffusionTrainer on the
CPU, at the JAX stage-2 tests' tiny config (tests/test_train_stage2.py) over
a sprite corpus made from a seed.

The JAX trainer's random-init UNet and frozen VAE/text go through the bridge
into the port; inputs are made with numpy; JAX's random draws (the
reparameterize noise, t, the noise, the cond-dropout mask and the attention
dropout masks, split from the step key as the JAX trainer splits it) are
injected into the port.  Bounds: loss within rel 1e-5 (fp32); UNet
gradients per leaf within 1e-4 * max|g_jax| + 1e-7; params and EMA after a
step within 1e-6.

The fast path (``_fast_epoch_impl``, ``_fast_val_impl``) with augmentation
on: JAX's index uniforms and augmentation draws (fold_in(rng, step), split
5) are injected too.  The augmented images then differ from JAX's by at
most 1e-4 a pixel away from the crop's edge and 1e-5 on average
(tests/test_torch_fastpath.py), which the frozen VAE encoder takes in
without gain at this size: the loss and grad-norm bounds hold unchanged.
Params and EMA after the two steps: within 1e-6 wherever the gradient is
determined in both steps (|g| at least 100 times the gradients' bound, the
rule of tests/test_torch_train_stage1.py, judged on the port's own
gradients, which are within that bound of JAX's): Adam divides each
gradient element by its own running size, so an element whose gradient is
rounding noise moves by a rounding-dependent amount in either package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.core.checkpoint import load_metadata as jax_load_metadata
from psg_tpu.core.checkpoint import load_params as jax_load_params
from psg_tpu.core.checkpoint import load_sample_params as jax_load_sample_params
from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.serve import hub as jax_hub
from psg_tpu.train.stage2_diffusion import DiffusionTrainer as JaxTrainer

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.unet import unet_block_count
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.serve import hub
from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer
from test_torch_fastpath import _jax_params as jax_augment_params
from test_torch_fastpath import assert_determined_close, recorded_grads

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

CAPTIONS = ["a small green creature with leaves", "a red fire lizard with a flame"]


def _tiny(cls, exp, corpus):
    cfg = cls()
    cfg.experiment_dir = str(exp)
    cfg.model.bert_model = "tiny-test"
    cfg.model.vae_width_scale = 0.25
    cfg.model.text_embedding_dim = 48
    cfg.model.unet_channels = (16, 24, 32, 32)
    cfg.model.num_attention_heads = 4
    cfg.model.time_emb_dim = 32
    cfg.data.csv_path, cfg.data.image_dir = str(corpus[0]), str(corpus[1])
    cfg.data.image_size = 64
    cfg.data.batch_size = 2
    cfg.data.text_len = 32
    cfg.data.num_workers = 2
    cfg.training.diffusion_epochs = 1
    cfg.training.log_every = 2
    cfg.training.sample_every = 1
    cfg.optimization.ema_decay = 0.99
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=12, seed=0, size=64)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory, corpus):
    return JaxTrainer(_tiny(JaxConfig, tmp_path_factory.mktemp("jax_exp"), corpus),
                      vae_checkpoint_path=None, experiment_name="j")


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def port_trainer(tmp_path_factory, corpus, jax_trainer):
    t = DiffusionTrainer(_tiny(Config, tmp_path_factory.mktemp("port_exp"), corpus),
                         vae_checkpoint_path=None, experiment_name="p", device="cpu")
    t.frozen = prepare_weights(bridge.fit(t.frozen, bridge.from_jax(_np(jax_trainer.frozen))))
    t.state = t._fresh_state(bridge.from_jax(_np(jax_trainer.state.params)), step=0,
                             rng=t.state.rng)
    return t


def _batch():
    rng = np.random.RandomState(0)
    return rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


def _batches(jt, pt):
    images = _batch()
    ids, mask = jt.tokenizer.encode_batch(CAPTIONS, 32)
    jb = {"image": jnp.asarray(images), "text_ids": jnp.asarray(ids),
          "text_mask": jnp.asarray(mask)}
    return jb, pt._batch({"image": images, "text_ids": ids, "text_mask": mask})


def _dropout_masks(spec, key, batch: int, rate: float):
    """The JAX UNet's keep masks: split(key, blocks), then split(., 3) per
    block, Bernoulli(1 - rate) of the attention-core and FFN output shapes;
    None for a block without attention."""
    nlvl, bpl = len(spec.channels), spec.blocks_per_level
    levels = ([(lvl, spec.attention_levels[lvl]) for lvl in range(nlvl) for _ in range(bpl)]
              + [(nlvl - 1, True)]
              + [(lvl, spec.attention_levels[lvl]) for lvl in reversed(range(nlvl))
                 for _ in range(bpl)])
    keys = jax.random.split(key, (2 * nlvl + 1) * bpl + 1)[:unet_block_count(spec)]
    out = []
    for (lvl, attn), k in zip(levels, keys):
        if not attn:
            out.append(None)
            continue
        c, length = spec.channels[lvl], spec.spatial[lvl] ** 2
        head = (batch, spec.num_heads, length, c // spec.num_heads)
        ks = jax.random.split(k, 3)
        out.append(tuple(torch.from_numpy(np.array(jax.random.bernoulli(kk, 1.0 - rate, s)))
                         for kk, s in zip(ks, (head, head, (batch, length, c)))))
    return out


def _loss_draws(jt, k_loss, k_drop, rate: float, train: bool = True):
    """The port's loss draws from JAX's loss and dropout keys."""
    k_rep, k_t, k_noise, k_cond = jax.random.split(k_loss, 4)
    lat = (2, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)
    d = {"rep_noise": jax.random.normal(k_rep, lat, jnp.float32),
         "t": jax.random.randint(k_t, (2,), 0, jt.schedule.num_timesteps),
         "noise": jax.random.normal(k_noise, lat, jnp.float32)}
    if train:
        d["keep"] = jax.random.uniform(k_cond, (2, 1, 1)) >= jt.cond_dropout
    d = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    if train and rate > 0:
        d["dropout"] = _dropout_masks(jt.spec, k_drop, 2, rate)
    return d


def _draws(jt, key, rate: float):
    """(k_loss, k_drop, the port's draws) as the JAX trainer splits them."""
    k_loss, k_drop = jax.random.split(key)
    return k_loss, k_drop, _loss_draws(jt, k_loss, k_drop, rate)


def _configure(jt, pt, **kw):
    """Set the trainers' loss options; returns the old ones."""
    old = {k: (jt.spec.attn_dropout if k == "attn_dropout" else getattr(jt, k)) for k in kw}
    for t in (jt, pt):
        for k, v in kw.items():
            if k == "attn_dropout":
                t.spec = t.spec._replace(attn_dropout=v)
            else:
                setattr(t, k, v)
    return old


def _assert_grads_close(jgrads, pgrads):
    ref = dict(tree.items(bridge.from_jax(_np(jgrads))))
    got = dict(tree.items(pgrads))
    assert set(ref) == set(got)
    for path, r in ref.items():
        g = got[path]
        bound = 1e-4 * float(r.abs().max()) + 1e-7
        err = float((g - r).abs().max())
        assert err <= bound, f"{path}: max|dg| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("pred_type,loss_kind,snr_gamma,cond_dropout,rate", [
    ("eps", "smooth_l1", 5.0, 1.0, 0.0),
    ("v", "mse", 5.0, 0.0, 0.0),
    ("v", "smooth_l1", 0.0, 0.0, 0.05),    # attention dropout, JAX's masks
])
def test_loss_and_gradients_match(jax_trainer, port_trainer, pred_type, loss_kind,
                                  snr_gamma, cond_dropout, rate):
    jt, pt = jax_trainer, port_trainer
    old = _configure(jt, pt, pred_type=pred_type, loss_kind=loss_kind, snr_gamma=snr_gamma,
                     cond_dropout=cond_dropout, attn_dropout=rate)
    try:
        jb, pb = _batches(jt, pt)
        k_loss, k_drop, draws = _draws(jt, jax.random.PRNGKey(11), rate)
        ref, jgrads = jax.value_and_grad(lambda p: jt._noise_loss(
            p, jt.frozen, jb, k_loss, dropout_key=k_drop))(jt.state.params)
        params = pt.state.params
        loss = pt._noise_loss(params, pt.frozen, pb, None, draws=draws,
                              dropout=draws.get("dropout"))
        grads = torch.autograd.grad(loss, tree.leaves(params))
        it = iter(grads)
        np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-5)
        _assert_grads_close(jgrads, tree.map(lambda _: next(it), params))
    finally:
        _configure(jt, pt, **old)


def test_one_step_params_and_ema_match(jax_trainer, port_trainer):
    """JAX's _step (fold_in(rng, step), value_and_grad, optax, EMA) against
    the port's with the same draws; the step's loss and grad norm too."""
    jt, pt = jax_trainer, port_trainer
    jb, pb = _batches(jt, pt)
    key = jax.random.fold_in(jt.state.rng, jt.state.step)
    _, _, draws = _draws(jt, key, jt.spec.attn_dropout)
    state, parts = jt._step(jt.state, jt.frozen, jb)
    before = tree.map(lambda t: t.detach().clone(), pt.state.params)
    got = pt._step(pb, draws=draws)
    np.testing.assert_allclose(float(got["loss"]), float(parts["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], float(parts["grad_norm"]), rtol=1e-4)
    assert pt.state.step == int(state.step) == 1
    for name, ref, mine in (("params", state.params, pt.state.params),
                            ("ema", state.ema, pt.state.ema)):
        ref = dict(tree.items(bridge.from_jax(_np(ref))))
        for path, p in tree.items(mine):
            np.testing.assert_allclose(p.detach().numpy(), ref[path].numpy(), rtol=0,
                                       atol=1e-6, err_msg=f"{name} {path}")
    assert any(not torch.equal(a, b) for a, b in zip(tree.leaves(before),
                                                     tree.leaves(pt.state.params)))
    assert pt.skipped_batches() == jt.skipped_batches() == 0
    # leave the module's trainers at their initial parameters
    pt.state = pt._fresh_state(before, step=0, rng=pt.state.rng)


def test_val_loss_ignores_padded_tail(port_trainer):
    """Eval weights the wraparound-padded tail 0: corrupting the padding
    leaves the loss as it was, corrupting a valid sample does not."""
    pt = port_trainer
    images = _batch()
    ids, mask = pt.tokenizer.encode_batch(CAPTIONS, 32)
    batch = {"image": images, "text_ids": ids, "text_mask": mask}
    base = float(pt._eval(pt._batch(batch), 1)["loss"])
    tail = dict(batch, image=images.copy())
    tail["image"][1:] = 0.77
    assert float(pt._eval(pt._batch(tail), 1)["loss"]) == pytest.approx(base, rel=1e-5)
    head = dict(batch, image=images.copy())
    head["image"][0] = 0.77
    assert float(pt._eval(pt._batch(head), 1)["loss"]) != pytest.approx(base, rel=1e-5)


def test_checkpoints_jax_reads_and_port_resumes(jax_trainer, port_trainer):
    """The port writes a full state and a light best; psg_tpu's
    load_params / load_sample_params / load_metadata read them into JAX
    templates equal to the port's params and EMA; the port resumes its own
    full state bit-equal; both hubs resolve the same stage-2 checkpoint."""
    jt, pt = jax_trainer, port_trainer
    _, pb = _batches(jt, pt)
    pt._step(pb)                               # moments, counts and EMA not trivial
    full = pt.ckpt.dir / "diffusion_step_00000001.ckpt"
    pt.ckpt.save(pt.state, pt.state.step, None, extra_meta=pt._meta(0), periodic=True)
    assert pt.save_checkpoint(0, 0.75)        # the best, a full state
    meta = jax_load_metadata(pt.ckpt.best_path)
    assert (meta["step"], meta["stage"], meta["metric"], meta["epoch"]) == (1, "diffusion",
                                                                             0.75, 0)
    assert meta["vae_checkpoint"] is None and meta["config"]["model"]["unet_channels"] == [
        16, 24, 32, 32]

    def same(jax_tree, port_tree, exact=True):
        ref = dict(tree.items(bridge.from_jax(_np(jax_tree))))
        for path, p in tree.items(port_tree):
            if exact:
                assert torch.equal(ref[path], p.detach()), path
            else:
                torch.testing.assert_close(ref[path], p.detach().to(torch.bfloat16).float(),
                                           rtol=0, atol=0)

    same(jax_load_params(full, jt.state.params), pt.state.params)
    same(jax_load_sample_params(full, jt.state.params), pt.state.ema)

    # the light best: bf16 sampling params only
    assert pt.save_checkpoint_fast(0, 0.5)
    assert jax_load_metadata(pt.ckpt.best_path)["light"] is True
    same(jax_load_sample_params(pt.ckpt.best_path, jt.state.params), pt.state.ema, exact=False)

    # resume: a fresh trainer takes the full state back bit-equal
    fresh = DiffusionTrainer(pt.cfg, vae_checkpoint_path=None, experiment_name="p",
                             device="cpu")
    fresh.load_checkpoint(str(full))
    for name in ("params", "ema", "opt_state"):
        a, b = dict(tree.items(getattr(fresh.state, name))), dict(tree.items(getattr(
            pt.state, name)))
        assert set(a) == set(b)
        for path, x in a.items():
            y = b[path]
            if isinstance(x, torch.Tensor):
                assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach()), path
            else:
                assert x == y, path
    assert fresh.state.step == pt.state.step == 1 and fresh.start_epoch == 1
    assert torch.equal(fresh.state.rng.get_state(), pt.state.rng.get_state())
    assert all(p.requires_grad for p in tree.leaves(fresh.state.params))

    # both hubs pick the same stage-2 checkpoint from the tree the port wrote
    jcfg = JaxConfig()
    jcfg.experiment_dir = pt.cfg.experiment_dir
    assert hub.resolve_checkpoints(pt.cfg, "p", allow_hub=False) == \
        jax_hub.resolve_checkpoints(jcfg, "p", allow_hub=False) == \
        (None, str(pt.ckpt.best_path))
    pt.state = pt._fresh_state(bridge.from_jax(_np(jt.state.params)), step=0,
                               rng=pt.state.rng)


def _fast_draws(jt, step: int):
    """JAX's draws for the fast step at ``step`` (fold_in(rng, step), split
    5): the index uniforms, the augmentation draws, the loss's."""
    k_idx, k_aug, k_loss, k_drop, k_var = jax.random.split(
        jax.random.fold_in(jt.state.rng, step), 5)
    n = jt._train_data["images"].shape[0]
    return {"uniforms": torch.from_numpy(np.array(jax.random.uniform(k_idx, (n,)))),
            "augment": jax_augment_params(k_aug, 2),
            **_loss_draws(jt, k_loss, k_drop, jt.spec.attn_dropout)}


def test_fast_epoch_and_validation_match(jax_trainer, port_trainer):
    """JAX's fast epoch (2 scanned steps: draw, gather, augment, the
    precomputed frozen embeddings, loss, optax, EMA) against the port's
    train_epoch_fast with JAX's draws: the split on the device, the epoch's
    mean loss and grad norms, the params and EMA after it; then the fast
    validation over the padded eval batches (fold_in(fold_in(rng, -2), i)
    a batch) from the state both reached."""
    jt, pt = jax_trainer, port_trainer
    jt._setup_fast_data()
    pt._setup_fast_data()
    for k in ("images", "text_ids", "text_mask"):
        np.testing.assert_array_equal(pt._train_data[k].numpy(), np.asarray(jt._train_data[k]))
    np.testing.assert_allclose(pt._train_data["text_emb"].numpy(),
                               np.asarray(jt._train_data["text_emb"]), rtol=0, atol=1e-5)
    jt._fast_len = 2
    draws = [_fast_draws(jt, int(jt.state.step) + s) for s in range(2)]
    state, ys = jt._fast_epoch_impl(jt.state, jt.frozen, jt._train_data)
    before = tree.map(lambda t: t.detach().clone(), pt.state.params)
    with recorded_grads(pt) as seen:
        stats = pt.train_epoch_fast(0, draws)
    gn = np.asarray(ys["grad_norm"])
    np.testing.assert_allclose(stats["loss"], float(np.mean(ys["loss"])), rtol=1e-5)
    np.testing.assert_allclose([stats["grad_norm"], stats["grad_norm_max"]],
                               [gn.mean(), gn.max()], rtol=1e-4)
    assert pt.state.step == int(state.step) == 2
    for name, ref, mine in (("params", state.params, pt.state.params),
                            ("ema", state.ema, pt.state.ema)):
        assert_determined_close(mine, bridge.from_jax(_np(ref)), seen, name)

    ev = jt._val_data
    val_draws = [_loss_draws(jt, jax.random.fold_in(jax.random.fold_in(
        state.rng, jnp.int32(-2)), i), None, 0.0, train=False)
        for i in range(ev["images"].shape[0])]
    ref_val = float(jt._fast_val_impl(state, jt.frozen, ev))
    np.testing.assert_allclose(pt.validate_fast(0, val_draws), ref_val, rtol=1e-5)
    # leave the module's trainers at their initial parameters
    pt.state = pt._fresh_state(before, step=0, rng=pt.state.rng)


def test_fast_path_and_missing_checkpoint_raise(port_trainer, tmp_path):
    """train() with training.fast_path (which raised before the fast path
    was ported) runs an epoch on its own draws and writes the light best
    and the final full state; a named stage-1 checkpoint that is missing
    raises."""
    cfg = port_trainer.cfg
    fast = Config(**{**cfg.__dict__})
    fast.training = type(cfg.training)(**{**cfg.training.__dict__, "fast_path": True,
                                          "sample_every": 100})
    t = DiffusionTrainer(fast, None, experiment_name="f", device="cpu")
    best = t.train()
    assert jax_load_metadata(best)["light"] is True and t.state.step == t._fast_len
    assert (t.ckpt.dir / f"diffusion_step_{t.state.step:08d}.ckpt").exists()
    assert np.isfinite(t.best_val) and set(t._val_data) == {
        "images", "text_ids", "text_mask", "weight", "text_emb"}
    with pytest.raises(FileNotFoundError):
        DiffusionTrainer(cfg, tmp_path / "missing.ckpt", experiment_name="m", device="cpu")


@pytest.mark.parametrize("sampler,guidance", [("ddim", 2.0), ("fast", 0.0), ("dpmpp", 0.0)])
def test_sample_grid_samplers(port_trainer, sampler, guidance):
    """The sample grid's three samplers (DDIM with the unfused CFG against
    the zero embedding, the strided fast DDPM, DPM-Solver++) give finite
    images; guidance changes DDIM's."""
    pt = port_trainer
    ids, mask = (torch.from_numpy(a).long() for a in pt.tokenizer.encode_batch(CAPTIONS, 32))

    def grid(g):
        return pt._sample(pt.state.sample_params, pt.frozen, torch.Generator().manual_seed(0),
                          ids, mask, num=2, stride=25, sampler=sampler, steps=3, guidance=g)

    imgs = grid(guidance)
    assert imgs.shape == (2, 64, 64, 3) and torch.isfinite(imgs).all()
    if guidance:
        assert not torch.equal(imgs, grid(0.0))
