"""psg_tpu_torch's fast-path pieces against psg_tpu's on the CPU:
``draw_minibatch`` given JAX's uniforms, ``device_split`` and
``eval_batches`` on one sprite corpus made from a seed (caption variants,
CLIP ids, a tiny text encoder's precomputed embeddings), and
``augment_batch`` given the draws JAX's ``_augment_one`` takes from its
keys.

Bounds.  Indices, arrays and weights: equal.  Embeddings: within 1e-5.
``augment_batch`` (64x64, batch 4, fp32, output in [-1, 1]): max abs error
<= 1e-4 at every pixel whose source coordinate lies more than 1e-3 px from
the image's edge (nearer, the in-bounds test may flip between the packages'
roundings, and the pixel takes the fill colour in one and not the other),
and mean abs error <= 1e-5 over all pixels."""

import collections
import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.data import device_augment as jax_augment
from psg_tpu.models.bert import BertConfig as JaxBertConfig
from psg_tpu.models.text_encoder import text_encoder_apply as jax_text_encoder_apply
from psg_tpu.models.text_encoder import text_encoder_init as jax_text_encoder_init
from psg_tpu.train import fastpath as jax_fastpath

from psg_tpu_torch.core import tree
from psg_tpu_torch.data import device_augment
from psg_tpu_torch.data.dataset import PokemonDataset
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.bert import BertConfig
from psg_tpu_torch.models.text_encoder import text_encoder_apply
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
from psg_tpu_torch.train import fastpath
from psg_tpu_torch.utils import profiling

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

VOCAB = Path(__file__).resolve().parent.parent / "experiments/evidence_r5c_vae/vocab.txt"
AUG_ATOL, AUG_MEAN_ATOL, EDGE_PX = 1e-4, 1e-5, 1e-3


@pytest.mark.parametrize("n,batch,seed", [(102, 16, 0), (37, 8, 1), (5, 2, 2), (6, 6, 3),
                                          (4, 9, 4)])
def test_draw_minibatch_matches_jax(n, batch, seed):
    """The same indices in the same (descending-uniform) order as JAX from
    JAX's uniforms; arange(n) when the batch covers the split."""
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax_fastpath.draw_minibatch(key, n, batch))
    uniforms = torch.from_numpy(np.array(jax.random.uniform(key, (n,))))
    got = fastpath.draw_minibatch(None, n, batch, uniforms=uniforms)
    np.testing.assert_array_equal(got.numpy(), ref)
    drawn = fastpath.draw_minibatch(torch.Generator().manual_seed(seed), n, batch)
    assert len(set(drawn.tolist())) == min(n, batch) and int(drawn.max()) < n


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    csv, images = write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=12, seed=4,
                                      size=32)
    ds = PokemonDataset(csv, images, image_size=32,
                        tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB), text_len=24)
    ds.set_caption_variants(3, seed=5)
    ds.clip_ids, ds.clip_mask = ds.text_ids[:, :16] + 7, ds.text_mask[:, :16]
    return ds


def _assert_same(got, ref, keys):
    assert set(got) == set(keys) and set(ref) == set(keys)
    for k in keys:
        assert tuple(got[k].shape) == tuple(ref[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_device_split_matches_jax(dataset):
    """Images, ids, masks, CLIP ids and caption variants equal to JAX's; a
    tiny text encoder's embeddings, JAX's in chunks whose tail it pads, the
    port's unpadded, within 1e-5."""
    idx = np.array([11, 3, 0, 7, 5, 9, 1, 2, 10, 4])
    cfg = JaxBertConfig.tiny_test()._replace(vocab_size=dataset.tokenizer.vocab_size)
    jparams = jax_text_encoder_init(jax.random.PRNGKey(0), cfg, 48)
    pparams = bridge.from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    pcfg = BertConfig.tiny_test()._replace(vocab_size=dataset.tokenizer.vocab_size)
    ref = jax_fastpath.device_split(
        dataset, idx, chunk=4,
        text_emb_fn=jax.jit(lambda i, m: jax_text_encoder_apply(jparams, i, m, cfg)))
    got = fastpath.device_split(
        dataset, idx, device="cpu", chunk=4,
        text_emb_fn=lambda i, m: text_encoder_apply(pparams, i, m, pcfg))
    emb_ref, emb = np.asarray(ref.pop("text_emb")), got.pop("text_emb").detach().numpy()
    _assert_same(got, ref, ("images", "text_ids", "text_mask", "clip_ids", "clip_mask",
                            "text_ids_aug", "text_mask_aug"))
    assert got["images"].dtype == torch.uint8 and emb.shape == (10, 24, 48)
    np.testing.assert_allclose(emb, emb_ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n_val,batch", [(7, 3), (9, 3), (4, 4), (5, 8)])
def test_eval_batches_match_jax(dataset, n_val, batch):
    """[nb, bs, ...] arrays padded by wraparound and the 0/1 weights, equal
    to JAX's."""
    idx = np.arange(12)[::-1][:n_val]
    ref = jax_fastpath.eval_batches(dataset, idx, batch)
    got = fastpath.eval_batches(dataset, idx, batch, device="cpu")
    _assert_same(got, ref, ("images", "text_ids", "text_mask", "weight", "clip_ids",
                            "clip_mask"))
    assert float(got["weight"].sum()) == n_val


def test_eval_batches_pad_a_split_under_half_a_batch(dataset):
    """A split of fewer than half a batch (where the JAX package's single
    wrap raises) repeats cyclically, weighted 0 past the real samples."""
    got = fastpath.eval_batches(dataset, np.array([6, 2]), 5, device="cpu")
    np.testing.assert_array_equal(got["images"][0].numpy(), dataset.images[[6, 2, 6, 2, 6]])
    np.testing.assert_array_equal(got["weight"].numpy(), [[1, 1, 0, 0, 0]])
    with pytest.raises(ValueError):
        jax_fastpath.eval_batches(dataset, np.array([6, 2]), 5)


def _jax_params(key, b, degrees=10.0, scale=(0.9, 1.0), ratio=(0.9, 1.1),
                jitter=(0.1, 0.1, 0.1, 0.05)):
    """Each sample's ten draws as ``_augment_one`` takes them from
    split(key, b), in ``draw_augment_params``'s layout."""
    u = jax.random.uniform
    rows = []
    for k in jax.random.split(key, b):
        kf, kr, ks, kar, kcy, kcx, kb, kc, ksat, kh = jax.random.split(k, 10)
        bj, cj, sj, hj = jitter
        rows.append((jax.random.bernoulli(kf), u(kr, (), minval=-degrees, maxval=degrees),
                     u(ks, (), minval=scale[0], maxval=scale[1]),
                     u(kar, (), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])),
                     u(kcy, (), minval=-1.0, maxval=1.0), u(kcx, (), minval=-1.0, maxval=1.0),
                     u(kb, (), minval=-bj, maxval=bj), u(kc, (), minval=-cj, maxval=cj),
                     u(ksat, (), minval=-sj, maxval=sj), u(kh, (), minval=-hj, maxval=hj)))
    cols = [torch.from_numpy(np.array([np.asarray(r[i]) for r in rows]))
            for i in range(len(device_augment.PARAM_NAMES))]
    return dict(zip(device_augment.PARAM_NAMES, cols))


def _near_edge(params, size):
    """Pixels whose source coordinate lies within EDGE_PX of the edge."""
    p = {k: v.float() for k, v in params.items()}
    aspect = torch.exp(p["log_aspect"])
    cw = torch.sqrt(p["area"] * aspect).clamp_max(1.0)
    ch = torch.sqrt(p["area"] / aspect).clamp_max(1.0)
    yi, xi = device_augment._affine_coords(
        size, p["angle"] * np.pi / 180.0, (ch, cw),
        (p["center_y"] * (1 - ch) * (size - 1) / 2, p["center_x"] * (1 - cw) * (size - 1) / 2))
    dist = torch.stack([yi.abs(), (yi - (size - 1)).abs(), xi.abs(),
                        (xi - (size - 1)).abs()]).amin(0)
    return dist < EDGE_PX


@pytest.mark.parametrize("seed,identity", [(0, False), (1, False), (2, False), (3, True)])
def test_augment_batch_matches_jax(seed, identity):
    """64x64, batch 4, on sprite-like images (a white background, a
    coloured blob): the port given JAX's draws against JAX's augment_batch.
    ``identity``: no rotation, full-image crop, no jitter (flip still
    drawn)."""
    rs = np.random.RandomState(seed)
    images = np.full((4, 64, 64, 3), 255, np.uint8)
    images[:, 12:52, 16:48] = rs.randint(0, 256, (4, 40, 32, 3))
    key = jax.random.PRNGKey(100 + seed)
    kw = dict(degrees=0.0, scale=(1.0, 1.0), ratio=(1.0, 1.0),
              jitter=(0.0, 0.0, 0.0, 0.0)) if identity else {}
    ref = np.array(jax.jit(lambda im: jax_augment.augment_batch(
        im, key, (255, 255, 255), **kw))(jnp.asarray(images)))
    params = _jax_params(key, 4, **kw)
    got = device_augment.augment_batch(torch.from_numpy(images), params, (255, 255, 255))
    assert got.dtype == torch.float32 and got.shape == (4, 64, 64, 3)
    err = (got - torch.from_numpy(ref)).abs()
    far = ~_near_edge(params, 64)
    assert float(err[far].max()) <= AUG_ATOL, float(err[far].max())
    assert float(err.mean()) <= AUG_MEAN_ATOL
    if identity:   # every source point on the pixel grid: no exclusion
        assert float(params["angle"].abs().max()) == 0.0 and float(err.max()) <= AUG_ATOL


def test_augment_params_draw_in_range():
    """The port's own draws: each in its range, flips of both kinds, and
    the batch deterministic in the generator's seed."""
    p = device_augment.draw_augment_params(torch.Generator().manual_seed(0), 64)
    assert set(p) == set(device_augment.PARAM_NAMES) and p["flip"].dtype == torch.bool
    assert 0 < int(p["flip"].sum()) < 64
    for k, (lo, hi) in {"angle": (-10, 10), "area": (0.9, 1.0),
                        "log_aspect": (np.log(0.9), np.log(1.1)), "center_y": (-1, 1),
                        "hue": (-0.05, 0.05), "saturation": (-0.1, 0.1)}.items():
        assert lo <= float(p[k].min()) and float(p[k].max()) <= hi, k
    again = device_augment.draw_augment_params(torch.Generator().manual_seed(0), 64)
    assert all(torch.equal(p[k], again[k]) for k in p)


# -- helpers the trainers' fast-epoch tests share ------------------------------


@contextlib.contextmanager
def recorded_grads(trainer):
    """Keep the gradient tree of each step the trainer takes."""
    seen, orig = [], trainer._grads

    def grads(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out[1])
        return out

    trainer._grads = grads
    try:
        yield seen
    finally:
        del trainer._grads


def assert_determined_close(mine, ref, grads, name, atol=1e-6, grad_rtols=None):
    """``mine`` within ``atol`` of ``ref`` wherever every step's gradient is
    determined: |g| at least 100 times the bound the two packages'
    gradients of that step agree to (``grad_rtols[i]`` * max|g| + 1e-7 a
    leaf, 1e-4 by default), so the element's Adam update does not hang on
    rounding noise."""
    ref = dict(tree.items(ref))
    steps = [dict(tree.items(g)) for g in grads]
    rtols = grad_rtols or [1e-4] * len(steps)
    for path, p in tree.items(mine):
        det = torch.ones_like(ref[path], dtype=torch.bool)
        for g, rtol in zip(steps, rtols):
            a = g[path].detach().abs()
            det &= a >= 100 * (rtol * a.max() + 1e-7)
        err = (p.detach().float() - ref[path])[det].abs()
        assert err.numel() == 0 or float(err.max()) <= atol, \
            f"{name} {path}: {float(err.max()):.3g} apart where |g| is determined"


# the psg.train.* ranges of a step and the range each opens in
STEP_SPANS = {"psg.train.step": None, "psg.train.grads": "psg.train.step",
              "psg.train.forward": "psg.train.grads", "psg.train.backward": "psg.train.grads",
              "psg.train.optimizer": "psg.train.step"}


def step_seam(trainer, step):
    """``step()``, one ``trainer._step``, under a CPU ``torch.profiler``
    with ``_grads`` and ``_apply_update`` wrapped on the instance, as the
    benchmark wraps them: each runs once, the step reads the host once, and
    the ``psg.train.*`` ranges nest as ``STEP_SPANS`` says.  Returns the
    step's gradient tree; the trainer's own methods are back afterwards."""
    calls, grads = collections.Counter(), []

    def counted(name):
        orig = getattr(trainer, name)

        def call(*args, **kwargs):
            calls[name] += 1
            out = orig(*args, **kwargs)
            if name == "_grads":
                grads.append(out[1])
            return out
        return call

    trainer._grads, trainer._apply_update = counted("_grads"), counted("_apply_update")
    reads = profiling.counts().get(profiling.HOST_READS, 0)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step()
    finally:
        del trainer._grads, trainer._apply_update
    assert calls == {"_grads": 1, "_apply_update": 1}
    assert profiling.counts()[profiling.HOST_READS] == reads + 1
    ranges = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
              if e.name.startswith("psg.train.")]
    assert sorted(name for name, _, _ in ranges) == sorted(STEP_SPANS)
    for name, start, end in ranges:
        around = [r for r in ranges if r[0] != name and r[1] <= start and end <= r[2]]
        inner = max(around, key=lambda r: r[1])[0] if around else None
        assert inner == STEP_SPANS[name], f"{name} opens in {inner}"
    return grads[0]
