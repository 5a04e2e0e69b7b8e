"""The rest of serving: psg_tpu_torch against psg_tpu on the CPU.

Image+text, restart passes, retrieval seeding (single and batched), the
``mean`` CFG negative, the retrieval index and the dataset read side, at
tests/test_torch_serve.py's tiny config over a small sprite corpus written
from a seed (``psg_tpu_torch.data.synthetic``).  Torch cannot replay
``jax.random``, so each test draws the gaussians as the JAX method splits
its key and gives them to the port's internal functions; the JAX side runs
its public methods, with ``tensor_to_pil`` patched to hand back the float
image.  Bounds: image MAE <= 1e-3 (the parity bound of BASELINE.md), the
pooled caption embeddings 1e-5, the TF-IDF similarities 1e-6."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.data import dataset as jdataset
from psg_tpu.serve import generator as jgenerator
from psg_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer
from psg_tpu.utils.images import pil_to_array as jax_pil_to_array

from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data import dataset as tdataset
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.diffusion.sampling import (
    ddpm_timesteps,
    fast_stride,
    fast_timesteps,
    renoise_timesteps,
    x0_timesteps,
)
from psg_tpu_torch.models import bridge
from psg_tpu_torch.serve import generator as tgenerator
from psg_tpu_torch.serve.generator import PokemonGenerator, find_tokenizer
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
from psg_tpu_torch.utils.images import pil_to_array

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

VOCAB = Path(__file__).resolve().parent.parent / "experiments/evidence_r5c_vae/vocab.txt"
NEGATIVE = "blurry low quality"
MAE = 1e-3
LATENT = (9, 9, 8)


def _tiny(cls, tmp, csv=None, image_dir=None):
    cfg = cls()
    cfg.model.bert_model = "tiny-test"
    cfg.model.vae_width_scale = 0.25
    cfg.model.text_embedding_dim = 48
    cfg.model.unet_channels = (16, 24, 32, 32)
    cfg.model.num_attention_heads = 4
    cfg.model.time_emb_dim = 32
    cfg.model.num_timesteps = 50
    cfg.data.image_size = 64
    cfg.data.text_len = 32
    cfg.experiment_dir = str(tmp)
    if csv is not None:
        cfg.data.csv_path, cfg.data.image_dir = str(csv), str(image_dir)
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=8, seed=0)


@pytest.fixture(scope="module")
def jax_gen(tmp_path_factory, corpus):
    return jgenerator.PokemonGenerator(
        _tiny(JaxConfig, tmp_path_factory.mktemp("jax_paths"), *corpus),
        tokenizer=JaxTokenizer.from_vocab_file(VOCAB), sampler="ddim",
        guidance_scale=2.0, negative=NEGATIVE)


@pytest.fixture(scope="module")
def port_gen(tmp_path_factory, corpus, jax_gen):
    params = bridge.from_jax(jax.tree_util.tree_map(np.asarray, jax_gen.params))
    return PokemonGenerator(_tiny(Config, tmp_path_factory.mktemp("port_paths"), *corpus),
                            tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                            sampler="ddim", guidance_scale=2.0, negative=NEGATIVE,
                            device="cpu", params=params)


@pytest.fixture
def jax_floats(monkeypatch):
    """The JAX generator's public methods hand back their float images."""
    monkeypatch.setattr(jgenerator, "tensor_to_pil", lambda a: np.asarray(a, np.float32))


def _normal(key, shape, dtype=jnp.float32):
    return torch.from_numpy(np.array(jax.random.normal(key, shape, dtype), np.float32))


def _restart_draws(key, n, num):
    """(encoder noise, lerp noise) per restart pass, as ``_restart_passes``
    splits its key; the key it leaves is unused after the last pass."""
    out = []
    for i in range(n):
        k_enc, k_noise, _k_sample, key = jax.random.split(jax.random.fold_in(key, 100 + i), 4)
        out.append((_normal(k_enc, (num, *LATENT)), _normal(k_noise, (num, *LATENT))))
    return out


def _ids(gen, texts):
    return gen._encode_ids(texts)


def _mae(got, ref):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == np.asarray(ref).shape
    assert np.isfinite(got).all()
    return float(np.abs(got - np.asarray(ref, np.float32)).mean())


def _sprite(seed, size=80):
    return Image.fromarray(
        (np.random.RandomState(seed).rand(size, size, 3) * 255).astype(np.uint8))


@pytest.mark.parametrize("strength", [0.7, 0.0])
def test_image_and_text_matches_jax(jax_gen, port_gen, jax_floats, strength):
    src, desc, seed = _sprite(0), "make it a blue water creature", 3
    ref = jax_gen.generate_from_image_and_text(src, desc, 4, strength, seed)
    k_enc, k_noise, _k_sample = jax.random.split(jax.random.PRNGKey(seed), 3)
    arr = pil_to_array(src, 64)
    np.testing.assert_array_equal(arr, jax_pil_to_array(src, 64))
    ids, mask = _ids(port_gen, [desc])
    got = port_gen._serve(ids, mask, None, steps=4, num=1, sampler="ddim",
                          init_images=torch.from_numpy(arr[None]), init_strength=strength,
                          draws={"init": (_normal(k_enc, (1, *LATENT)),
                                          _normal(k_noise, (1, *LATENT)))})
    assert _mae(got[0], ref) <= MAE


def test_restart_passes_match_jax(jax_gen, port_gen, jax_floats):
    desc, seed = "a small green creature with leaves", 5
    ref = jax_gen.generate_from_text(desc, 4, seed, restarts=2, restart_strength=0.9)
    key = jax.random.PRNGKey(seed)
    prior = _normal(jax.random.split(key)[1], (1, *LATENT))   # the DDIM prior
    ids, mask = _ids(port_gen, [desc])
    got = port_gen._serve(ids, mask, None, steps=4, num=1, sampler="ddim", restarts=2,
                          restart_strength=0.9,
                          draws={"prior": prior, "restarts": _restart_draws(key, 2, 1)})
    assert _mae(got[0], ref) <= MAE
    # a restart pass moves the image
    base = port_gen._serve(ids, mask, None, steps=4, num=1, sampler="ddim",
                           draws={"prior": prior})
    assert _mae(base[0], ref) > 10 * MAE


def test_retrieval_seeded_matches_jax(jax_gen, port_gen, corpus, jax_floats):
    desc, seed, strength = "a brown ice creature with a flame on its tail", 7, 0.8
    assert port_gen.retrieve_nearest(desc) == jax_gen.retrieve_nearest(desc)
    ref = jax_gen.generate_from_text_retrieval(desc, 4, seed, strength=strength,
                                               restarts=1)
    key = jax.random.PRNGKey(seed)
    k_enc, k_noise, _k_sample = jax.random.split(key, 3)
    ids, mask = _ids(port_gen, [desc])
    got = port_gen._serve(ids, mask, None, steps=4, num=1, sampler="ddim",
                          init_images=port_gen._retrieval_images([desc]),
                          init_strength=strength, restarts=1, restart_strength=strength,
                          draws={"init": (_normal(k_enc, (1, *LATENT)),
                                          _normal(k_noise, (1, *LATENT))),
                                 "restarts": _restart_draws(key, 1, 1)})
    assert _mae(got[0], ref) <= MAE


@pytest.mark.parametrize("restarts", [0, 1])
def test_batched_retrieval_init_matches_jax(jax_gen, port_gen, restarts):
    descs = ["a pink rock creature", "a cyan creature with a shell",
             "something purple and electric"]
    seed = 9
    ref = jax_gen.generate_batch(descs, 4, seed, restarts=restarts, restart_strength=0.9,
                                 init="retrieval", init_strength=0.85)
    k_enc, k_noise, key = jax.random.split(jax.random.PRNGKey(seed), 3)
    n = len(descs)
    ids, mask = _ids(port_gen, descs)
    got = port_gen._serve(ids, mask, None, steps=4, num=n, sampler="ddim",
                          init_images=port_gen._retrieval_images(descs),
                          init_strength=0.85, restarts=restarts, restart_strength=0.9,
                          draws={"init": (_normal(k_enc, (n, *LATENT)),
                                          _normal(k_noise, (n, *LATENT))),
                                 "restarts": _restart_draws(key, restarts, n)})
    assert _mae(got, ref) <= MAE


@pytest.mark.parametrize("sampler,steps", [("ddpm", 4), ("fast", 4), ("x0", 4),
                                           ("renoise", 5)])
def test_ddpm_family_chain_matches_jax(jax_gen, port_gen, sampler, steps):
    """The four DDPM-family samplers through the whole chain (unguided, as in
    the reference, though the generators have guidance 2), with JAX's
    per-step draws injected."""
    T = 50
    ts = {"ddpm": ddpm_timesteps(T, steps), "fast": fast_timesteps(T, fast_stride(T, steps)),
          "x0": x0_timesteps(T, steps), "renoise": renoise_timesteps(T, steps)}[sampler]
    descs = ["a red fire lizard", "a blue turtle"]
    latent = np.random.RandomState(1).randn(2, *LATENT).astype(np.float32)
    key = jax.random.PRNGKey(4)
    ids, mask = jax_gen.tokenizer.encode_batch(descs, 32)
    ref = np.asarray(jax_gen._generate(jax_gen.params, key, jnp.asarray(ids),
                                       jnp.asarray(mask), jnp.asarray(latent),
                                       steps=steps, num=2, sampler=sampler))
    key, _ = jax.random.split(key)
    noises = []
    for _ in ts:
        key, kn = jax.random.split(key)
        noises.append(_normal(kn, (2, *LATENT)))
    tids, tmask = _ids(port_gen, descs)
    got = port_gen._generate_impl(port_gen.params, None, tids, tmask,
                                  torch.from_numpy(latent), steps=steps, num=2,
                                  sampler=sampler, noises=torch.stack(noises))
    assert _mae(got, ref) <= MAE


def test_mean_negative_matches_jax(tmp_path, corpus):
    jgen = jgenerator.PokemonGenerator(_tiny(JaxConfig, tmp_path / "j", *corpus),
                                       tokenizer=JaxTokenizer.from_vocab_file(VOCAB),
                                       sampler="dpmpp", guidance_scale=2.0,
                                       negative="mean")
    params = bridge.from_jax(jax.tree_util.tree_map(np.asarray, jgen.params))
    tgen = PokemonGenerator(_tiny(Config, tmp_path / "t", *corpus),
                            tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                            sampler="dpmpp", guidance_scale=2.0, negative="mean",
                            device="cpu", params=params)
    assert tuple(tgen._neg_emb.shape) == jgen._neg_emb.shape == (1, 32, 48)
    np.testing.assert_allclose(tgen._neg_emb.numpy(), np.asarray(jgen._neg_emb),
                               rtol=1e-5, atol=1e-5)
    assert tgen._neg_mask.tolist() == np.asarray(jgen._neg_mask).tolist() == [[1] * 32]
    descs = ["a yellow creature", "a teal one with wings"]
    latent = np.random.RandomState(2).randn(2, *LATENT).astype(np.float32)
    ids, mask = jgen.tokenizer.encode_batch(descs, 32)
    ref = np.asarray(jgen._generate(jgen.params, jax.random.PRNGKey(0), jnp.asarray(ids),
                                    jnp.asarray(mask), jnp.asarray(latent), steps=4,
                                    num=2, sampler="dpmpp"))
    tids, tmask = _ids(tgen, descs)
    got = tgen._generate_impl(tgen.params, None, tids, tmask, torch.from_numpy(latent),
                              steps=4, num=2, sampler="dpmpp")
    assert _mae(got, ref) <= MAE


QUERIES = ["a brown ice creature with a flame on its tail",
           "spiral horn, green bug",
           "Pokemon named Mimimi. A pink rock-type creature with big glowing eyes.",
           "glowing eyes and a pink body",
           "zzqx unknown words only"]


def test_retrieval_index_matches_jax(jax_gen, port_gen):
    pooled_r, ds_r, tfidf_r = jax_gen._retrieval_index()
    pooled, ds, tfidf = port_gen._retrieval_index()
    assert ds.full_descriptions == ds_r.full_descriptions
    np.testing.assert_array_equal(ds.images, ds_r.images)
    assert pooled.dtype == np.float32 and pooled.shape == pooled_r.shape == (8, 48)
    np.testing.assert_allclose(pooled, pooled_r, rtol=1e-5, atol=1e-5)
    assert tfidf.vocab == tfidf_r.vocab
    np.testing.assert_allclose(tfidf.mat, tfidf_r.mat, rtol=1e-6, atol=1e-6)
    for q in QUERIES:
        np.testing.assert_allclose(tfidf.sims(q), tfidf_r.sims(q), rtol=1e-6, atol=1e-6)
        emb = port_gen._query_embedding(q)
        np.testing.assert_allclose(emb, jax_gen._query_embedding(q), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pooled @ emb, pooled_r @ jax_gen._query_embedding(q),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["hybrid", "embed", "lexical"])
def test_retrieve_nearest_matches_jax(jax_gen, port_gen, mode):
    _, ds, _ = port_gen._retrieval_index()
    for q in QUERIES + ds.full_descriptions:
        want = jax_gen.retrieve_nearest(q, mode=mode)
        assert port_gen.retrieve_nearest(q, mode=mode) == want, q
        for excl in (want, 0):
            assert (port_gen.retrieve_nearest(q, exclude=excl, mode=mode)
                    == jax_gen.retrieve_nearest(q, exclude=excl, mode=mode)), (q, excl)
    for i, cap in enumerate(ds.full_descriptions):   # a verbatim caption finds itself
        assert port_gen.retrieve_nearest(cap, mode=mode) == i


def test_tfidf_index_unit():
    corpus = ["a red fire lizard with a burning tail",
              "a blue water turtle with a hard shell",
              "a green plant dinosaur with a round bulb"]
    idx, ref = tgenerator._TfidfIndex(corpus), jgenerator._TfidfIndex(corpus)
    for i, c in enumerate(corpus):
        s = idx.sims(c)
        assert s.argmax() == i and abs(s[i] - 1.0) < 1e-5
    for q in corpus + ["burning lizard tail", "shell turtle water", "xyzzy qwerty", ""]:
        np.testing.assert_allclose(idx.sims(q), ref.sims(q), rtol=1e-6, atol=1e-6)
    assert idx.sims("burning lizard tail").argmax() == 0
    assert np.allclose(idx.sims("xyzzy qwerty"), 0.0) and np.allclose(idx.sims(""), 0.0)


def test_public_paths_seeded(port_gen, corpus):
    """The public methods draw from the request's generator: one seed gives
    one image, another seed another; every sampler is accepted."""
    src = Image.open(Path(corpus[1]) / "001.png")
    a, b, c = (np.asarray(port_gen.generate_from_image_and_text(src, "a blue creature", 3,
                                                                0.6, s)) for s in (1, 1, 2))
    assert a.shape == (64, 64, 3)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    r = [np.asarray(port_gen.generate_from_text("a creature", 3, 5, restarts=1))
         for _ in range(2)]
    assert np.array_equal(r[0], r[1])
    img = port_gen.generate_from_text_retrieval("a teal creature", 3, 0, strength=0.8)
    assert img.size == (64, 64)
    for sampler in ("ddim", "dpmpp", "ddpm", "fast", "x0", "renoise"):
        out = port_gen.generate_batch(["a", "b"], 3, seed=0, sampler=sampler,
                                      init="retrieval", restarts=1)
        assert out.shape == (2, 64, 64, 3) and np.isfinite(out).all()
    with pytest.raises(ValueError):
        port_gen.generate_batch(["a"], 3, init="nearest")


def test_set_guidance(port_gen):
    a = port_gen.generate_batch(["a green creature"], 3, seed=11)
    try:
        port_gen.set_guidance(scale=4.0, rescale=0.5, interval_lo=0.0, interval_hi=1.0)
        assert port_gen.guidance_rescale == 0.5 and port_gen.guidance_t_hi == 50.0
        b = port_gen.generate_batch(["a green creature"], 3, seed=11)
        assert not np.array_equal(a, b)
    finally:
        port_gen.set_guidance(scale=2.0, rescale=0.0, interval_lo=0.0, interval_hi=1.0)
    np.testing.assert_array_equal(a, port_gen.generate_batch(["a green creature"], 3,
                                                             seed=11))


def test_unknown_sampler_or_mode_raises(tmp_path):
    for kw in (dict(sampler="euler"), dict(retrieval_mode="fuzzy")):
        with pytest.raises(ValueError):
            PokemonGenerator(_tiny(Config, tmp_path), device="cpu",
                             tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB), **kw)


# ---------------------------------------------------------------------------
# the dataset read side, images and the tokenizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("encoding", ["utf-8", "utf-16", "latin-1"])
def test_read_description_csv_matches_jax(tmp_path, encoding):
    csv = tmp_path / "c.csv"
    text = ('Bulbasaur; "A grass creature; with a bulb"\n\n  Charmander ;A fire lizard\n'
            'Pokémon Éevee; "Brown, fluffy"\nNoDesc;\n')
    csv.write_bytes(text.encode(encoding))
    rows = tdataset.read_description_csv(csv)
    assert rows == jdataset.read_description_csv(csv)
    assert [r["national_number"] for r in rows] == [1, 2, 3, 4]
    assert ([tdataset.full_description(r["english_name"], r["description"]) for r in rows]
            == [jdataset.full_description(r["english_name"], r["description"])
                for r in rows])


def test_sprites_and_dataset_match_jax(corpus):
    csv, image_dir = corpus
    modes = {p.name: Image.open(p).mode for p in sorted(Path(image_dir).iterdir())}
    assert set(modes.values()) == {"RGBA", "P", "RGB"}
    assert "transparency" in Image.open(Path(image_dir) / "002.png").info
    for name in modes:
        for bg, size in (((255, 255, 255), 64), ((0, 0, 0), 96), ((128, 128, 128), 50)):
            got = tdataset.load_sprite(Path(image_dir) / name, bg, size)
            assert got.dtype == np.uint8 and got.shape == (size, size, 3)
            np.testing.assert_array_equal(
                got, jdataset.load_sprite(Path(image_dir) / name, bg, size))
    ds = tdataset.PokemonDataset(csv, image_dir, image_size=64, background_color="black",
                                 tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                                 text_len=32)
    ref = jdataset.PokemonDataset(csv, image_dir, image_size=64, background_color="black",
                                  tokenizer=JaxTokenizer.from_vocab_file(VOCAB),
                                  text_len=32)
    assert len(ds) == len(ref) == 8 and ds.names == ref.names
    np.testing.assert_array_equal(ds.images, ref.images)
    np.testing.assert_array_equal(ds.text_ids, ref.text_ids)
    np.testing.assert_array_equal(ds.desc_mask, ref.desc_mask)
    np.testing.assert_array_equal(ds.image_float(3), ref.image_float(3))
    for bad in ("mauve", (1, 2)):
        with pytest.raises(ValueError):
            tdataset._resolve_background(bad)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_pil_to_array_matches_jax(mode):
    img = _sprite(4, 97).convert(mode)
    for size in (64, 215):
        got = pil_to_array(img, size)
        assert got.dtype == np.float32 and got.shape == (size, size, 3)
        np.testing.assert_array_equal(got, jax_pil_to_array(img, size))


def test_tokenizer_from_corpus_and_decode_match_jax(corpus, tmp_path):
    texts = [r["description"] for r in tdataset.read_description_csv(corpus[0])] + [
        "Pokémon: a FIRE-type, 'Charmander'-like lizard!!", "zzqxj 中文 tabs\tand"]
    got, ref = WordPieceTokenizer.from_corpus(texts), JaxTokenizer.from_corpus(texts)
    assert got.vocab == ref.vocab
    small = WordPieceTokenizer.from_corpus(texts, max_size=40)
    assert small.vocab == JaxTokenizer.from_corpus(texts, max_size=40).vocab
    vocab = WordPieceTokenizer.from_vocab_file(VOCAB)
    ids, _ = vocab.encode_batch(texts, 48)
    for row in ids:
        assert vocab.decode(row) == JaxTokenizer.from_vocab_file(VOCAB).decode(row)
    got.save_vocab(tmp_path / "vocab.txt")
    assert WordPieceTokenizer.from_vocab_file(tmp_path / "vocab.txt").vocab == got.vocab


def test_find_tokenizer_resolution_order(tmp_path, corpus, monkeypatch):
    """experiment-dir vocab.txt, then the pretrained-BERT vocabulary when both
    files exist (saved to the experiment dir), then the caption corpus."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PSG_TPU_BERT", raising=False)
    monkeypatch.delenv("PSG_TPU_BERT_VOCAB", raising=False)
    cfg = _tiny(Config, tmp_path / "exp", *corpus)
    rows = jdataset.read_description_csv(corpus[0])
    want = JaxTokenizer.from_corpus(
        [jdataset.full_description(r["english_name"], r["description"]) for r in rows])
    assert find_tokenizer(cfg).vocab == want.vocab
    assert not (tmp_path / "exp").exists()   # the corpus vocabulary is not saved

    bert_vocab = tmp_path / "bert_vocab.txt"
    bert_vocab.write_text(VOCAB.read_text())
    monkeypatch.setenv("PSG_TPU_BERT_VOCAB", str(bert_vocab))
    assert find_tokenizer(cfg).vocab == want.vocab   # no converted BERT: not used
    (tmp_path / "bert.ckpt").write_bytes(b"x")
    monkeypatch.setenv("PSG_TPU_BERT", str(tmp_path / "bert.ckpt"))
    tok = find_tokenizer(cfg)
    assert tok.vocab == JaxTokenizer.from_vocab_file(VOCAB).vocab
    assert (tmp_path / "exp" / "vocab.txt").read_text() == "\n".join(tok.vocab) + "\n"

    (tmp_path / "exp" / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\nzz\n")
    assert find_tokenizer(cfg).vocab[-1] == "zz"
