"""psg_tpu_torch's ``--use-diffusers`` stage 2 (``train/stage2_sd.py``) and
the legacy preset (``train/legacy.py``) against the JAX package on the CPU,
at the JAX SD tests' tiny config (tests/test_train_stage2_sd.py: the tiny
SD spec, 48-d text with 48-d cross-attention, T = 50) over a sprite corpus
made from a seed.

One JAX ``SDDiffusionTrainer`` serves the file.  Its random-init SD wrapper
and text encoder and its frozen VAE go through the bridge into the port;
JAX's loss draws (the reparameterize noise, t and the noise, split from the
step key as its ``_noise_loss`` splits them) are injected.  Bounds (PERF.md
§2): loss and grad norm within rel 1e-5; every leaf's gradient within
1e-4 * max|g_jax| + 1e-7; params after a step within 1e-6 wherever the
gradient is determined (|g| at least 100 times that bound: Adam's first
step moves a noise-gradient element by +-lr); sample images within MAE
1e-3 given JAX's sampler draws; checkpoints read by the other package
exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psg_tpu.core.checkpoint import load_params as jax_load_params
from psg_tpu.core.checkpoint import load_sample_params as jax_load_sample_params
from psg_tpu.core.checkpoint import wait_for_writes
from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.core.stability import global_norm as jax_global_norm
from psg_tpu.models.convert import convert_sd_unet as jax_convert_sd_unet
from psg_tpu.models.sd_unet import sd_training_mask as jax_sd_training_mask
from psg_tpu.models.text_encoder import finetune_mask as jax_finetune_mask
from psg_tpu.models.unet import UNetSpec as JaxUNetSpec
from psg_tpu.models.unet import unet_init as jax_unet_init
from psg_tpu.train import legacy as jax_legacy
from psg_tpu.train import stage2_diffusion as jax_stage2
from psg_tpu.train import stage2_sd as jax_stage2_sd
from psg_tpu.train.optim import build_optimizer as jax_build_optimizer
from psg_tpu.train.optim import labels_from_mask as jax_labels_from_mask
from psg_tpu.train.optim import make_lr_schedule as jax_make_lr_schedule
from psg_tpu.train.stage2_sd import SDDiffusionTrainer as JaxTrainer

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import load_params, save_state
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.diffusion.sampling import x0_timesteps
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.sd_unet import adapt_in_channels, adapt_out_channels
from psg_tpu_torch.models.unet import UNetSpec, unet_init
from psg_tpu_torch.train.legacy import LegacyDiffusionTrainer
from psg_tpu_torch.train.optim import make_lr_schedule
from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer, train_mode_for
from test_torch_convert import _state_dict
from test_torch_fastpath import assert_determined_close, recorded_grads
from test_torch_sampling import _jax_step_draws

CAPTIONS = ["a small green creature with leaves", "a red fire lizard with a flame"]
MODES = {"cross_attention_only": (True, True), "decoder_only": (True, False),
         "full": (False, False)}


def _tiny(cls, exp, corpus, freeze=(True, True)):
    cfg = cls()
    cfg.experiment_dir = str(exp)
    m = cfg.model
    m.bert_model = "tiny-test"
    m.vae_width_scale = 0.25
    m.text_embedding_dim = 48
    m.cross_attention_dim = 48
    m.num_timesteps = 50
    m.freeze_encoder, m.freeze_decoder = freeze
    cfg.data.csv_path, cfg.data.image_dir = str(corpus[0]), str(corpus[1])
    cfg.data.image_size = 64
    cfg.data.batch_size = 2
    cfg.data.text_len = 32
    cfg.data.num_workers = 2
    cfg.training.diffusion_epochs = 1
    cfg.training.log_every = 2
    cfg.training.sample_every = 1
    return cfg


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    # 12 sprites: 9 train, 2 validation (one batch), 1 test
    return write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=12, seed=0, size=64)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory, corpus):
    return JaxTrainer(_tiny(JaxConfig, tmp_path_factory.mktemp("jax_exp"), corpus),
                      vae_checkpoint_path=None, experiment_name="j")


def _port(tmp_path, corpus, jt, mode="cross_attention_only", name="p"):
    """A port trainer in ``mode`` holding the JAX trainer's parameters."""
    t = SDDiffusionTrainer(_tiny(Config, tmp_path, corpus, MODES[mode]),
                           vae_checkpoint_path=None, experiment_name=name, device="cpu")
    t.frozen_vae = bridge.fit(t.frozen_vae, bridge.from_jax(_np(jt.frozen_vae)))
    # fit keeps the port's key order, which the optimizer's labels follow
    t.state = t._fresh_state(bridge.fit(t.state.params, bridge.from_jax(_np(jt.state.params))),
                             step=0, rng=t.state.rng)
    return t


@pytest.fixture(scope="module")
def port_trainer(tmp_path_factory, corpus, jax_trainer):
    return _port(tmp_path_factory.mktemp("port_exp"), corpus, jax_trainer)


def _batches(jt, pt, images=None):
    if images is None:
        images = np.random.RandomState(0).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    ids, mask = jt.tokenizer.encode_batch(CAPTIONS, 32)
    jb = {"image": jnp.asarray(images), "desc_ids": jnp.asarray(ids),
          "desc_mask": jnp.asarray(mask)}
    return jb, pt._batch({"image": images, "desc_ids": ids, "desc_mask": mask})


def _draws(jt, key, batch=2):
    """The port's draws from the key JAX's ``_noise_loss`` takes."""
    k_rep, k_t, k_n = jax.random.split(key, 3)
    lat = (batch, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)
    d = {"rep_noise": jax.random.normal(k_rep, lat, jnp.float32),
         "t": jax.random.randint(k_t, (batch,), 0, jt.schedule.num_timesteps),
         "noise": jax.random.normal(k_n, lat, jnp.float32)}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.fixture(scope="module")
def jax_step(jax_trainer, port_trainer):
    """JAX's loss, gradients and grad norm on one batch at a fixed key."""
    jt = jax_trainer
    jb, _ = _batches(jt, port_trainer)
    key = jax.random.PRNGKey(11)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jt._noise_loss(p, jt.frozen_vae, jb, key)))(jt.state.params)
    return key, float(loss), grads, float(jax_global_norm(grads))


def _jax_tx(jt, mode):
    """The JAX trainer's optimizer in ``mode`` (its own construction)."""
    o, m = jt.cfg.optimization, jt.cfg.model
    spe = max(len(jt.train_loader), 1)
    kind = "onecycle" if o.scheduler == "cosine" else o.scheduler

    def sched(lr):
        return jax_make_lr_schedule(kind, lr, total_steps=jt.cfg.training.diffusion_epochs * spe,
                                    steps_per_epoch=spe, pct_start=o.onecycle_pct_start,
                                    warmup_steps=o.warmup_steps, end_factor=o.lr_end_factor)

    p = jt.state.params
    labels = {"sd": jax_labels_from_mask(jax_sd_training_mask(p["sd"], mode), "unet"),
              "text": jax_labels_from_mask(jax_finetune_mask(p["text"], jt.bert_cfg,
                                                             m.bert_finetune_strategy), "text")}
    return jax_build_optimizer(
        o, {"unet": {"lr_schedule": sched(o.learning_rate), "max_grad_norm": o.max_grad_norm},
            "text": {"lr_schedule": sched(o.text_encoder_lr or o.learning_rate * 0.1),
                     "max_grad_norm": o.max_grad_norm * 0.5}},
        labels)


def _assert_grads_close(jgrads, pgrads):
    ref = dict(tree.items(bridge.from_jax(_np(jgrads))))
    got = dict(tree.items(pgrads))
    assert set(ref) == set(got)
    for path, r in ref.items():
        bound = 1e-4 * float(r.abs().max()) + 1e-7
        err = float((got[path] - r).abs().max())
        assert err <= bound, f"{path}: max|dg| {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_step_matches_in_each_train_mode(tmp_path, corpus, jax_trainer, jax_step, mode):
    """One step: the loss, every leaf's gradient (frozen ones included), the
    grad norm over all of them, and the params after the update."""
    jt = jax_trainer
    key, jloss, jgrads, jnorm = jax_step
    pt = _port(tmp_path, corpus, jt, mode)
    assert pt.train_mode == mode == train_mode_for(pt.cfg.model)
    tx = _jax_tx(jt, mode)
    jparams = jax.jit(lambda g, p: optax.apply_updates(
        p, tx.update(g, tx.init(p), p)[0]))(jgrads, jt.state.params)

    _, pb = _batches(jt, pt)
    with recorded_grads(pt) as seen:
        stats = pt._step(pb, _draws(jt, key))
    np.testing.assert_allclose(float(stats["loss"]), jloss, rtol=1e-5)
    np.testing.assert_allclose(stats["grad_norm"], jnorm, rtol=1e-5)
    _assert_grads_close(jgrads, seen[0])
    frozen = [lab == "frozen" for lab in pt.tx.labels]
    assert any(frozen) and not all(frozen)
    assert_determined_close(pt.state.params, bridge.from_jax(_np(jparams)), seen, mode)


def test_validation_weights_the_padded_tail(jax_trainer, port_trainer):
    """``_eval`` with one real sample of two equals JAX's; the port's
    ``validate`` over its loader is the mean over real samples."""
    jt, pt = jax_trainer, port_trainer
    jb, pb = _batches(jt, pt)
    ref = jt._eval_step(jt.state, jt.frozen_vae, jb, jnp.int32(1))
    key = jax.random.fold_in(jt.state.rng, jnp.int32(-4))
    got = pt._eval(pb, 1, draws=_draws(jt, key))
    np.testing.assert_allclose(float(got["loss"]), float(ref["loss"]), rtol=1e-5)
    one = pt._eval({k: v[:1] for k, v in pb.items()}, 1,
                   draws={k: v[:1] for k, v in _draws(jt, key).items()})
    np.testing.assert_allclose(float(one["loss"]), float(got["loss"]), rtol=1e-5)
    assert len(pt.val_loader) == 1 and np.isfinite(pt.validate(0))


def test_samples_match_jax(jax_trainer, port_trainer, tmp_path):
    """``_sample`` (x0 DDPM, 10 of 50 steps, then the VAE decode) given JAX's
    prior and step draws; ``generate_samples`` writes the grid."""
    jt, pt = jax_trainer, port_trainer
    ids, mask = jt.tokenizer.encode_batch(CAPTIONS, 32)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(jt._sample_fn(jt.state.params, jt.frozen_vae, key, jnp.asarray(ids),
                                   jnp.asarray(mask), num=2, steps=10))
    shape = (2, jt.latent_size, jt.latent_size, jt.cfg.model.latent_dim)
    init = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], shape)))
    got = pt._sample(pt.state.params, None, torch.from_numpy(ids).long(),
                     torch.from_numpy(mask).long(), num=2, steps=10, initial_latent=init,
                     noises=torch.from_numpy(_jax_step_draws(key, len(x0_timesteps(50, 10)), shape)))
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert float(np.abs(got.numpy() - ref).mean()) <= 1e-3
    path = pt.generate_samples(0, num=2, steps=2)
    assert path.exists() and path.name == "epoch_0000.png"


def test_checkpoints_read_across_packages(tmp_path, corpus, jax_trainer):
    """The port's best is read by JAX's ``load_params`` into its {sd, text}
    tree (``None`` attentions included); JAX's is resumed by the port
    (params and step; JAX's optimizer layout is not the port's); a
    stage-3 UNet template refuses the SD checkpoint in both packages, as
    ``--stage all --use-diffusers`` hands it on."""
    jt = jax_trainer
    pt = _port(tmp_path / "p", corpus, jt)
    assert pt.save_checkpoint(0, 0.5)
    best = pt.ckpt.best_path
    assert best.name == "diffusers_best_model.ckpt" and best.parent.parent.name == "p_diffusers"
    back = jax_load_params(best, jt.state.params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jt.state.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert back["sd"]["unet"]["down_blocks"][3]["attentions"] is None

    jt.save_checkpoint(0, 0.25)
    wait_for_writes()
    fresh = _port(tmp_path / "q", corpus, jt, name="q")
    fresh.state = fresh._fresh_state(tree.map(torch.zeros_like, fresh.state.params), step=0,
                                     rng=fresh.state.rng)
    fresh.load_checkpoint(str(jt.ckpt.best_path))
    ref = dict(tree.items(bridge.from_jax(_np(jt.state.params))))
    assert all(torch.equal(p.detach(), ref[k]) for k, p in tree.items(fresh.state.params))
    assert fresh.start_epoch == 1 and fresh.best_val == 0.25

    # a (tiny) stage-3 UNet's template; JAX refuses the keys on shapes alone
    kw = dict(text_dim=48, time_emb_dim=32, channels=(16, 24, 32, 32))
    s3_tmpl = jax.eval_shape(lambda k: jax_unet_init(k, JaxUNetSpec(**kw)),
                             jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        jax_load_sample_params(best, s3_tmpl)
    with pytest.raises(ValueError):
        load_params(best, unet_init(torch.Generator().manual_seed(0), UNetSpec(**kw)),
                    prefer_ema=True)


@pytest.fixture
def sd_env(monkeypatch):
    def set_path(path):
        monkeypatch.setenv("PSG_TPU_SD_UNET", str(path))
    monkeypatch.delenv("PSG_TPU_SD_UNET", raising=False)
    return set_path


def test_named_sd_unet_must_exist(tmp_path, corpus, sd_env):
    sd_env(tmp_path / "missing.ckpt")
    with pytest.raises(FileNotFoundError, match="PSG_TPU_SD_UNET"):
        SDDiffusionTrainer(_tiny(Config, tmp_path, corpus), None, device="cpu")


def test_pth_and_ckpt_routes_and_the_jax_failure(tmp_path, corpus, jax_trainer, sd_env,
                                                 monkeypatch):
    """A diffusers ``.pth`` goes through ``convert_sd_unet``, a ``.ckpt``
    through the checkpoint reader; both adapt to 8 channels.  The JAX
    routine reads an existing ``.pth`` as msgpack and a missing one with
    ``torch.load``: both raise (ROADMAP Queue C)."""
    jt = jax_trainer
    # a 4-channel SD UNet: the JAX trainer's, its 8-channel ends sliced back
    base = dict(_np(jt.state.params["sd"]["unet"]))
    base["conv_in"] = {"w": base["conv_in"]["w"][:, :, :4], "b": base["conv_in"]["b"]}
    base["conv_out"] = {k: v[..., :4] for k, v in base["conv_out"].items()}
    sd = _state_dict(jax_convert_sd_unet, base)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "unet.pth")
    save_state(tmp_path / "unet.ckpt", bridge.to_jax(bridge.from_jax(_np(base))))
    want = adapt_out_channels(adapt_in_channels(bridge.from_jax(_np(base)), 8), 8)
    for name in ("unet.pth", "unet.ckpt"):
        sd_env(tmp_path / name)
        t = SDDiffusionTrainer(_tiny(Config, tmp_path / f"exp_{name}", corpus), None,
                               device="cpu")
        got = dict(tree.items(t.state.params["sd"]["unet"]))
        assert all(torch.equal(got[k], v) for k, v in tree.items(want)), name

    # the JAX routine's template is not what fails: hand it the base
    monkeypatch.setattr(jax_stage2_sd, "jit_init", lambda *a, **k: base)
    sd_env(tmp_path / "unet.pth")
    with pytest.raises(Exception) as err:
        jt._load_sd_base()
    assert not isinstance(err.value, FileNotFoundError)
    sd_env(tmp_path / "absent.pth")
    with pytest.raises(FileNotFoundError):
        jt._load_sd_base()


def test_prediction_type_other_than_eps_is_refused(tmp_path, corpus):
    cfg = _tiny(Config, tmp_path, corpus)
    cfg.extra = {"prediction_type": "v"}
    with pytest.raises(ValueError, match="prediction_type"):
        SDDiffusionTrainer(cfg, None, device="cpu")


def test_legacy_trainer_pins_the_jax_presets_choices(tmp_path, corpus, monkeypatch):
    """The port's preset sets what the JAX preset sets: the linear schedule,
    MSE, and the plain cosine anneal (not OneCycle) over the run."""
    seen = {}
    monkeypatch.setattr(jax_stage2.DiffusionTrainer, "__init__",
                        lambda self, cfg, *a, **k: seen.update(cfg=cfg))
    jcfg = _tiny(JaxConfig, tmp_path / "j", corpus)
    jax_legacy.LegacyDiffusionTrainer(jcfg, None, "j")
    cfg = _tiny(Config, tmp_path / "p", corpus)
    cfg.model.unet_channels, cfg.model.time_emb_dim = (16, 24, 32, 32), 32
    before = cfg.to_dict()
    t = LegacyDiffusionTrainer(cfg, None, "p", device="cpu")
    ref = seen["cfg"]
    assert (t.cfg.model.beta_schedule, t.cfg.optimization.scheduler) == (
        ref.model.beta_schedule, ref.optimization.scheduler) == ("linear", "cosine")
    assert t.cfg.extra == ref.extra == {"diffusion_loss": "mse",
                                         "unet_optimization": {"scheduler": "legacy_cosine"}}
    assert cfg.to_dict() == before     # the caller's config is untouched
    m = cfg.model
    assert t.loss_kind == "mse" and torch.equal(
        t.schedule.alphas_cumprod,
        make_schedule(m.num_timesteps, m.beta_start, m.beta_end, "linear").alphas_cumprod)
    steps = len(t.train_loader)
    want = make_lr_schedule("cosine", cfg.optimization.learning_rate, total_steps=steps)
    lr = t.tx.groups["unet"]["lr_schedule"]
    assert [lr(k) for k in range(steps + 1)] == [want(k) for k in range(steps + 1)]
    assert not os.environ.get("PSG_TPU_SD_UNET")
