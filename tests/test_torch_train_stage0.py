"""psg_tpu_torch's stage-0 MLM pretraining against psg_tpu's on the CPU, at
the JAX MLM tests' tiny config (tests/test_mlm.py: BERT tiny-test, text_len
32, two caption variants a sprite) over a sprite corpus made from a seed.

The JAX trainer's random-init text tower and head go through the bridge into
the port, and its draws (the minibatch index, the masks' uniforms and random
tokens) are injected.  Bounds: ``mlm_logits`` in fp32 within 1e-5 relative;
the masking exactly equal with given draws.  One training step runs BERT in
bf16 in both packages, which round at different points (the port's linear
layer rounds its bf16 product before the bias, JAX adds the bias to the fp32
accumulation).  So the step is held to a bound derived from one bf16 step of
the JAX trainer: the loss and each gradient leaf lie within twice the
distance that bf16 moves JAX's own step from its fp32 step (max over the
leaf, plus 1e-7); on this config the port's distance is 0.35-1.5 times
JAX's.  Params after the step within 1e-6 where the port's optimizer takes
JAX's gradients (the optimizer is fp32 in both)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.train import stage0_mlm as jmlm

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import bridge
from psg_tpu_torch.train import stage0_mlm as mlm

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

BF16_FACTOR = 2.0


def _tiny(cls, exp, corpus):
    cfg = cls()
    cfg.experiment_dir = str(exp)
    cfg.model.bert_model = "tiny-test"
    cfg.model.text_embedding_dim = 48
    cfg.data.csv_path, cfg.data.image_dir = str(corpus[0]), str(corpus[1])
    cfg.data.image_size = 64
    cfg.data.text_len = 32
    cfg.extra = {"mlm_epochs": 2, "mlm_batch": 8, "mlm_caption_augment": 2}
    return cfg


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=20, seed=3, size=64)


@pytest.fixture(scope="module")
def jax_trainer(tmp_path_factory, corpus):
    return jmlm.MLMPretrainer(_tiny(JaxConfig, tmp_path_factory.mktemp("jax"), corpus),
                              experiment_name="j")


@pytest.fixture(scope="module")
def port_trainer(tmp_path_factory, corpus, jax_trainer):
    t = mlm.MLMPretrainer(_tiny(Config, tmp_path_factory.mktemp("port"), corpus),
                          experiment_name="p", device="cpu")
    _carry_across(t, jax_trainer)
    return t


def _carry_across(pt, jt):
    params = bridge.fit(pt.state.params, bridge.from_jax(_np(jt.state.params)))
    params = tree.map(lambda t: t.requires_grad_(True), params)
    pt.state.params, pt.state.step = params, 0
    pt.state.opt_state = pt.tx.init(params)


def _masking_draws(rng, shape, vocab):
    k_sel, k_kind, k_rand = jax.random.split(rng, 3)
    return {"u_select": np.array(jax.random.uniform(k_sel, shape)),
            "u_kind": np.array(jax.random.uniform(k_kind, shape)),
            "random_ids": np.array(jax.random.randint(k_rand, shape, 5, vocab))}


def test_bert_masking_statistics():
    """tests/test_mlm.py's statistics, from the port's generator."""
    ids = torch.full((64, 32), 100, dtype=torch.long)
    mask = torch.ones((64, 32), dtype=torch.long)
    mask[:, 20:] = 0
    masked, labels, sel = mlm.apply_bert_masking(torch.Generator().manual_seed(0), ids, mask,
                                                 mask_id=4, vocab_size=1000)
    sel, m = sel.numpy(), masked.numpy()
    assert not sel[:, 20:].any()
    assert 0.10 < sel[:, :20].mean() < 0.20
    chosen = m[sel]
    assert (chosen == 4).mean() > 0.6 and (chosen == 100).mean() > 0.02
    assert (m[~sel] == 100).all() and (labels.numpy() == 100).all()


def test_bert_masking_matches_jax_with_given_draws():
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 300, (16, 32)).astype(np.int32)
    mask = (np.arange(32)[None] < rs.randint(4, 33, (16, 1))).astype(np.int32)
    rng = jax.random.PRNGKey(11)
    ref = jmlm.apply_bert_masking(rng, jnp.asarray(ids), jnp.asarray(mask), mask_id=4,
                                  vocab_size=300)
    got = mlm.apply_bert_masking(None, torch.from_numpy(ids).long(),
                                 torch.from_numpy(mask).long(), mask_id=4, vocab_size=300,
                                 draws=_masking_draws(rng, ids.shape, 300))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_mlm_logits_match_in_fp32(jax_trainer, port_trainer):
    jt, pt = jax_trainer, port_trainer
    ids, attn = (np.asarray(a[:4]) for a in jt.train_rows)
    ref = jmlm.mlm_logits(jt.state.params["text"], jt.state.params["mlm"], jnp.asarray(ids),
                          jnp.asarray(attn), jt.bert_cfg)
    with torch.no_grad():
        got = mlm.mlm_logits(pt.state.params["text"], pt.state.params["mlm"],
                             torch.from_numpy(ids).long(), torch.from_numpy(attn).long(),
                             pt.bert_cfg)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_corpus_split_and_schedule_match_jax(jax_trainer, port_trainer):
    """The same rows (captions and variants) held out and trained on, the
    same steps an epoch, and optax's warmup-cosine schedule."""
    jt, pt = jax_trainer, port_trainer
    for got, ref in zip(pt.train_rows + pt.val_rows, jt.train_rows + jt.val_rows):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert pt.steps_per_epoch == jt._steps_per_epoch and pt.epochs == jt.epochs == 2
    total = pt.epochs * pt.steps_per_epoch
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup_steps=min(500, total // 10 + 1),
                                             decay_steps=max(total, 2), end_value=3e-5)
    sched = pt.tx.groups["mlm"]["lr_schedule"]
    for c in range(total + 2):
        assert sched(c) == pytest.approx(float(ref(c)), rel=1e-6, abs=1e-12), c


def _jax_fp32_loss(jt, params, ids, attn, rng):
    """JAX's MLM loss with BERT in fp32 (its _loss hard-codes bf16)."""
    masked, labels, sel = jmlm.apply_bert_masking(
        rng, ids, attn, mask_id=jt.tokenizer.ids["[MASK]"], vocab_size=jt.tokenizer.vocab_size)
    logits = jmlm.mlm_logits(params["text"], params["mlm"], masked, attn, jt.bert_cfg)
    nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1), labels[..., None], -1)[..., 0]
    w = sel.astype(jnp.float32)
    return jnp.sum(nll * w) / jnp.maximum(jnp.sum(w), 1.0)


def test_one_bf16_step_matches_jax(jax_trainer, port_trainer):
    """JAX's step (fold_in(rng, step) split into the minibatch key and the
    masks' key; value_and_grad of the bf16 loss; clip + AdamW) against the
    port's with those draws, within twice the distance between JAX's bf16
    and fp32 steps; then the port's optimizer on JAX's gradients to JAX's
    params within 1e-6."""
    jt, pt = jax_trainer, port_trainer
    rng = jax.random.fold_in(jt.state.rng, jt.state.step)
    k_idx, k_mask = jax.random.split(rng)
    n = jt.train_rows[0].shape[0]
    idx = jax.random.randint(k_idx, (jt.batch,), 0, n)
    ids, attn = jt.train_rows[0][idx], jt.train_rows[1][idx]
    loss, grads = jax.value_and_grad(jt._loss)(jt.state.params, ids, attn, k_mask)
    loss32, grads32 = jax.value_and_grad(lambda p: _jax_fp32_loss(jt, p, ids, attn, k_mask))(
        jt.state.params)
    upd, _ = jt.tx.update(grads, jt.state.opt_state, jt.state.params)
    ref_params = dict(tree.items(bridge.from_jax(_np(optax.apply_updates(jt.state.params,
                                                                         upd)))))
    draws = {"index": np.array(idx), **_masking_draws(k_mask, ids.shape, jt.tokenizer.vocab_size)}
    got_loss, got_grads = pt._grads(draws)
    assert abs(float(got_loss) - float(loss)) <= BF16_FACTOR * abs(float(loss) - float(loss32))
    ref = dict(tree.items(bridge.from_jax(_np(grads))))
    ref32 = dict(tree.items(bridge.from_jax(_np(grads32))))
    for path, g in tree.items(got_grads):
        r = ref[path]
        bound = BF16_FACTOR * float((r - ref32[path]).abs().max()) + 1e-7
        assert float((g - r).abs().max()) <= bound, path
    for k in ("text.projection.w", "text.ln.scale", "text.bert.pooler.w"):
        assert float(ref[k].abs().max()) == 0.0 and float(dict(tree.items(got_grads))[k]
                                                         .abs().max()) == 0.0
    ref_grads = bridge.fit(pt.state.params, bridge.from_jax(_np(grads)), "grads")
    stats = pt.tx.update(pt.state.params, ref_grads, pt.state.opt_state)
    assert stats["applied"] == ["mlm"]
    for path, p in tree.items(pt.state.params):
        np.testing.assert_allclose(p.detach().numpy(), ref_params[path].numpy(), rtol=0,
                                   atol=1e-6, err_msg=path)
    _carry_across(pt, jt)


def test_checkpoints_warm_start_stage1_in_both_packages(jax_trainer, port_trainer, tmp_path):
    """The port's best ({text, mlm}) through each package's load_text_init
    (what stage 1 calls for extra.text_init), and the JAX package's MLM
    checkpoint through the port's, all bit-equal; train() lowers the
    validation loss over its two epochs."""
    from psg_tpu.models.text_encoder import text_encoder_init as jax_text_init

    from psg_tpu_torch.models.text_encoder import text_encoder_init

    jt, pt = jax_trainer, port_trainer
    v0 = pt.val_loss()
    best = pt.train()
    assert best.name == "mlm_best_model.ckpt" and pt.state.step == 2 * pt.steps_per_epoch
    assert pt.val_loss() < v0
    text = dict(tree.items(pt.state.params["text"]))
    port_tmpl = text_encoder_init(torch.Generator().manual_seed(1), pt.bert_cfg, 48)
    for path, t in tree.items(mlm.load_text_init(best, port_tmpl)):
        assert torch.equal(t, text[path].detach()), path
    jax_tmpl = jax_text_init(jax.random.PRNGKey(5), jt.bert_cfg, 48)
    warm = dict(tree.items(bridge.from_jax(_np(jmlm.load_text_init(best, jax_tmpl)))))
    for path, t in warm.items():
        assert torch.equal(t, text[path].detach()), path

    jt.ckpt.dir = tmp_path
    jt.ckpt.save({"params": {"text": jt.state.params["text"], "mlm": jt.state.params["mlm"]}},
                 0, 1.0, periodic=False)
    got = mlm.load_text_init(jt.ckpt.best_path, port_tmpl)
    ref = dict(tree.items(bridge.from_jax(_np(jt.state.params["text"]))))
    for path, t in tree.items(got):
        assert torch.equal(t, ref[path]), path
