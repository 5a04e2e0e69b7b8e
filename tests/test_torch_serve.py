"""The whole text -> sprite slice: psg_tpu_torch's PokemonGenerator against
psg_tpu's on the CPU, plus the port's checkpoint reader.

The JAX generator runs at tests/test_serve.py's tiny sizes with a tokenizer
from the committed experiments/evidence_r5c_vae/vocab.txt; its random-init
parameters go through the bridge into the port; both run ``_generate`` with
the same ids, mask and numpy-made ``initial_latent``.  The bound is image
MAE <= 1e-3, the parity bound of BASELINE.md."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.core.checkpoint import save_state
from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.serve.generator import PokemonGenerator as JaxGenerator
from psg_tpu.text.tokenizer import WordPieceTokenizer as JaxTokenizer

from psg_tpu_torch.core.checkpoint import load_serving_params, read_checkpoint
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.unet import UNetGraphs, unet_apply
from psg_tpu_torch.serve.generator import PokemonGenerator
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
from psg_tpu_torch.utils import profiling

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

VOCAB = Path(__file__).resolve().parent.parent / "experiments/evidence_r5c_vae/vocab.txt"
NEGATIVE = "blurry low quality"
PROMPTS = ["a small green creature with leaves", "a red fire lizard"]


def _tiny(cls, tmp):
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
    return cfg


@pytest.fixture(scope="module")
def jax_gen(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jax_serve")
    return JaxGenerator(_tiny(JaxConfig, tmp),
                        tokenizer=JaxTokenizer.from_vocab_file(VOCAB),
                        sampler="ddim", guidance_scale=2.0, negative=NEGATIVE)


@pytest.fixture(scope="module")
def port_params(jax_gen):
    return bridge.from_jax(jax.tree_util.tree_map(np.asarray, jax_gen.params))


def _port_gen(tmp, params=None, **kw):
    return PokemonGenerator(_tiny(Config, tmp),
                            tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                            device="cpu", params=params, **kw)


@pytest.mark.parametrize("sampler,guidance,rescale,band,prediction", [
    ("ddim", 0.0, 0.0, (0.0, 1.0), "eps"),
    ("ddim", 2.0, 0.0, (0.0, 1.0), "eps"),
    ("dpmpp", 2.0, 0.0, (0.0, 1.0), "eps"),
    ("dpmpp", 2.0, 0.7, (0.1, 0.8), "eps"),   # CFG rescale + guidance interval
    ("ddim", 2.0, 0.0, (0.0, 1.0), "v"),      # v-prediction converted to eps
])
def test_generate_matches_jax(jax_gen, port_params, tmp_path, sampler, guidance,
                              rescale, band, prediction):
    # set_guidance re-jits the JAX chain, which then reads prediction_type
    jax_gen.prediction_type = prediction
    jax_gen.set_guidance(scale=guidance, rescale=rescale, interval_lo=band[0],
                         interval_hi=band[1])
    ids, mask = jax_gen.tokenizer.encode_batch(PROMPTS, 32)
    latent = np.random.RandomState(0).randn(2, 9, 9, 8).astype(np.float32)
    ref = np.asarray(jax_gen._generate(
        jax_gen.params, jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask),
        jnp.asarray(latent), steps=4, num=2, sampler=sampler))

    cfg = _tiny(Config, tmp_path)
    cfg.extra = {"guidance_rescale": rescale, "guidance_interval_lo": band[0],
                 "guidance_interval_hi": band[1]}
    gen = PokemonGenerator(cfg, tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                           sampler=sampler, guidance_scale=guidance,
                           negative=NEGATIVE, prediction_type=prediction,
                           device="cpu", params=port_params)
    got = gen._generate_impl(gen.params, None, torch.from_numpy(ids).long(),
                             torch.from_numpy(mask).long(), torch.from_numpy(latent),
                             steps=4, num=2, sampler=sampler).numpy()
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).mean() <= 1e-3


@pytest.mark.parametrize("max_len", [8, 32, 128])
def test_tokenizer_matches_jax(max_len):
    """The port's own WordPiece copy gives the JAX package's ids and masks:
    accents, punctuation, unknown characters, sub-words and truncation."""
    texts = PROMPTS + [NEGATIVE, "Pokémon: a FIRE-type, 'Charmander'-like lizard!!",
                       "zzqxj 中文 emoji \U0001f600 tabs\tand\nnewlines", "",
                       "a " * 200 + "very long prompt"]
    ref = JaxTokenizer.from_vocab_file(VOCAB).encode_batch(texts, max_len)
    got = WordPieceTokenizer.from_vocab_file(VOCAB).encode_batch(texts, max_len)
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_seeded_generation_on_cpu(port_params, tmp_path):
    gen = _port_gen(tmp_path, port_params, guidance_scale=2.0, negative=NEGATIVE)
    a = gen.generate_from_text("a blue turtle", num_inference_steps=2, seed=3)
    b = gen.generate_from_text("a blue turtle", num_inference_steps=2, seed=3)
    c = gen.generate_from_text("a blue turtle", num_inference_steps=2, seed=4)
    assert a.size == (64, 64)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    assert not np.array_equal(np.asarray(a), np.asarray(c))
    imgs = gen.generate_batch(["a", "b", "c"], num_inference_steps=2, seed=0,
                              sampler="dpmpp")
    assert imgs.shape == (3, 64, 64, 3) and np.isfinite(imgs).all()


def _graph_counts():
    c = profiling.counts()
    return {k: c.get(f"unet_graph.{k}", 0) for k in ("capture", "replay", "eager")}


def test_unet_graphs_run_eagerly_on_the_cpu(port_params, tmp_path):
    """On the CPU a call handed a graph cache runs the eager body, equals the
    call without it, and counts one ``unet_graph.eager``."""
    gen = _port_gen(tmp_path, port_params)
    p, spec = gen.params["unet"], gen.spec
    rng = torch.Generator().manual_seed(0)
    x = torch.randn((2, gen.latent_size, gen.latent_size, gen.cfg.model.latent_dim),
                    generator=rng)
    t = torch.tensor([3, 41], dtype=torch.int32)
    emb = torch.randn((2, gen.cfg.data.text_len, gen.cfg.model.text_embedding_dim),
                      generator=rng)
    mask = (torch.arange(gen.cfg.data.text_len) < torch.tensor([[5], [9]])).long()
    graphs = UNetGraphs(p, spec)
    with torch.no_grad():
        want = unet_apply(p, x, t, emb, spec, text_mask=mask)
        before = _graph_counts()
        got = unet_apply(p, x, t, emb, spec, text_mask=mask, graphs=graphs)
    assert torch.equal(got, want)
    after = _graph_counts()
    assert {k: after[k] - before[k] for k in after} == {"capture": 0, "replay": 0,
                                                        "eager": 1}
    assert len(graphs) == 0


def test_cpu_generator_builds_no_unet_graphs(port_params, tmp_path):
    gen = _port_gen(tmp_path, port_params, sampler="dpmpp", guidance_scale=2.0,
                    negative=NEGATIVE)
    assert gen.unet_graphs is None
    before = _graph_counts()
    gen.generate_from_text("a blue turtle", num_inference_steps=2, seed=3, restarts=1)
    assert _graph_counts() == before


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoints_read_back_bit_equal(jax_gen, port_params, tmp_path):
    params = jax.tree_util.tree_map(np.asarray, jax_gen.params)
    bundle = tmp_path / "final_best_model.ckpt"
    save_state(bundle, {"params": params, "step": 3})
    served = _port_gen(tmp_path, vae_checkpoint=bundle, diffusion_checkpoint=bundle)
    assert served.loaded == "final-bundle"
    _assert_trees_equal(served.params, port_params)

    # stage-1/2 pair; the diffusion state's EMA weights are the served ones
    vae_ck, diff_ck = tmp_path / "vae.ckpt", tmp_path / "diffusion.ckpt"
    save_state(vae_ck, {"params": {"vae": params["vae"], "text": params["text"]}})
    ema = jax.tree_util.tree_map(lambda a: a + 1.0, params["unet"])
    save_state(diff_ck, {"params": params["unet"], "ema": ema})
    served = _port_gen(tmp_path, vae_checkpoint=vae_ck, diffusion_checkpoint=diff_ck)
    assert served.loaded == "pair"
    _assert_trees_equal(served.params["vae"], port_params["vae"])
    _assert_trees_equal(served.params["unet"], bridge.from_jax(ema))

    # light checkpoints store bf16; read back bit-equal, served as fp32
    light = tmp_path / "light.ckpt"
    bf16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params["unet"])
    save_state(light, {"params": bf16})
    raw = read_checkpoint(light)["params"]
    w = raw["init_conv"]["w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(bf16["init_conv"]["w"], np.float32))
    served = _port_gen(tmp_path, diffusion_checkpoint=light)
    assert served.loaded == "unet-only"
    assert served.params["unet"]["init_conv"]["w"].dtype == torch.float32


def test_mismatched_or_missing_checkpoint_raises(port_params, tmp_path):
    alien = tmp_path / "alien.ckpt"
    save_state(alien, {"params": {"vae": {"w": np.ones((3, 3), np.float32)},
                                  "text": {"blah": np.zeros((2,), np.float32)}}})
    with pytest.raises(ValueError):
        _port_gen(tmp_path, vae_checkpoint=alien)
    with pytest.raises(ValueError):
        _port_gen(tmp_path, vae_checkpoint=alien, diffusion_checkpoint=alien)
    # same structure, wrong widths
    wide = jax.tree_util.tree_map(lambda t: np.zeros(t.shape[:-1] + (t.shape[-1] + 1,),
                                                     np.float32),
                                  {"vae": port_params["vae"], "text": port_params["text"]})
    with pytest.raises(ValueError):
        template = {k: port_params[k] for k in ("vae", "text", "unet")}
        narrow = tmp_path / "wide.ckpt"
        save_state(narrow, {"params": wide})
        load_serving_params(narrow, None, template)
    with pytest.raises(FileNotFoundError):
        _port_gen(tmp_path, vae_checkpoint=tmp_path / "missing.ckpt")


def test_no_silent_cpu_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PokemonGenerator(_tiny(Config, tmp_path),
                         tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB))
