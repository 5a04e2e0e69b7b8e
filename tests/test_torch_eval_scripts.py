"""The evaluation and evidence scripts of the port against their JAX twins
on the CPU: ``scripts/torch_eval_conditioning.py``,
``scripts/torch_recipe_sweep.py``, ``scripts/torch_ddim_evidence.py`` and
``examples/torch_quickstart.py``.

Both packages read the same checkpoint files: tiny parameters (the config
of tests/test_torch_serve_paths.py) drawn from its seed and written in the
JAX layout as a stage-1 and a stage-2 best with their sidecars, over a
sprite corpus written from a seed.
The JAX scripts are loaded from their files and run through ``main()``.
Torch cannot replay ``jax.random``, so every request of the port's
generator gets the gaussians the JAX method splits from the same seed
(``jax_draws``).  Bounds: image MAE <= 1e-3 (the serving parity bound of
BASELINE.md); the conditioning scores ``SCORE_TOL`` (below); the report's
own logic, on identical images, exact.

The JAX eval script builds its dataset from a fixed path whatever the
overrides say (``scripts/eval_conditioning.py:136-138``, likewise
``ddim_evidence.py``'s ``dataset_prompts``); here that read is pointed at
the corpus.  The port reads ``gen.cfg.data``, so ``data.csv_path=`` works
there (ROADMAP Queue C item 4)."""

import importlib.util
import json
import runpy
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import psg_tpu.eval as jeval
from psg_tpu.core.config import load_config as jax_load_config
from psg_tpu.data import dataset as jdataset
from psg_tpu.serve import app as japp
from psg_tpu.serve import hub as jhub

from psg_tpu_torch.core import config as tconfig
from psg_tpu_torch.core.checkpoint import save_state
from psg_tpu_torch.data.dataset import PokemonDataset
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.eval import metrics as tmetrics
from psg_tpu_torch.eval.metrics import pairwise_conditioning_scores
from psg_tpu_torch.models import bridge
from psg_tpu_torch.serve import app as tapp
from psg_tpu_torch.serve import hub as thub
from psg_tpu_torch.serve.generator import PokemonGenerator
from psg_tpu_torch.utils import images as timages

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
VOCAB = ROOT / "experiments/evidence_r5c_vae/vocab.txt"
MAE = 1e-3
# A conditioning score is the mean of a colour-histogram intersection, a
# silhouette IoU (a mask at 0.15 off the background) and 1 - L1/2 on a
# 32^2 box-downsampled, 8-bit-rounded copy.  The L1 term moves by at most
# the images' MAE/2, but the other two are steps: one 64x64 pixel that
# crosses a bin edge or the mask threshold moves the histogram term by up
# to 2/|foreground| and the IoU by up to 1/|union|, about 1e-3 of the
# score on these sprites (1/3 of 2/~700).  Both packages compute in fp32
# and their images agree to about 1e-5 a pixel (8e-3, one 8-bit step, where
# ``init=retrieval-loo`` rounds through a PNG), so a pixel crosses a step
# only when it lies that close to one; 2e-3 allows two such pixels a pair.
# Rows whose top two scores lie within 2 * SCORE_TOL may swap their best
# match: retrieval@1 is held exactly on the other rows.
SCORE_TOL = 2e-3
LATENT = (9, 9, 8)
TINY = ["model.bert_model=tiny-test", "model.vae_width_scale=0.25",
        "model.text_embedding_dim=48", "model.unet_channels=[16,24,32,32]",
        "model.num_attention_heads=4", "model.time_emb_dim=32", "model.num_timesteps=50",
        "data.image_size=64", "data.text_len=32"]


def _load(rel):
    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


jeval_script = _load("scripts/eval_conditioning.py")
jsweep = _load("scripts/recipe_sweep.py")
jddim = _load("scripts/ddim_evidence.py")
teval_script = _load("scripts/torch_eval_conditioning.py")
tsweep = _load("scripts/torch_recipe_sweep.py")
tddim = _load("scripts/torch_ddim_evidence.py")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A sprite corpus and an experiment dir holding tiny parameters drawn
    from the config's seed as a stage-1 best (VAE + text) and a stage-2 best
    (UNet), in the JAX layout, with sidecars."""
    root = tmp_path_factory.mktemp("eval_scripts")
    corpus = write_sprite_corpus(root / "corpus", n=8, seed=0)
    exp = root / "exp"
    exp.mkdir()
    (exp / "vocab.txt").write_text(VOCAB.read_text())
    overrides = TINY + [f"data.csv_path={corpus[0]}", f"data.image_dir={corpus[1]}",
                        f"experiment_dir={exp}"]
    params = bridge.to_jax(PokemonGenerator(tconfig.load_config(None, overrides),
                                            device="cpu").params)
    vae = exp / "tiny_vae" / "checkpoints" / "vae_best_model.ckpt"
    save_state(vae, {"params": {"vae": params["vae"], "text": params["text"]}},
               {"metric": 0.05, "step": 1})
    diff = exp / "tiny_diffusion" / "checkpoints" / "diffusion_best_model.ckpt"
    save_state(diff, {"params": params["unet"]},
               {"metric": 0.4, "step": 1, "vae_checkpoint": str(vae)})
    return SimpleNamespace(root=root, corpus=corpus, exp=exp, diff=diff,
                           overrides=overrides + ["device=cpu"])


@pytest.fixture(scope="module")
def jax_built():
    """JAX generators by their build arguments, shared by the tests."""
    return {}


@pytest.fixture
def env(monkeypatch, tree, jax_built):
    """No Hub, no persistent XLA cache of the JAX entry points (the suite's
    own stays), JAX's fixed dataset path read from the corpus, and one JAX
    generator per set of build arguments (its guidance knobs reset at each
    build: the sweep moves them); the stage-2 sidecar is restored after."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("PSG_TPU_XLA_CACHE", "")
    dataset, read_csv = jdataset.PokemonDataset, jdataset.read_description_csv
    monkeypatch.setattr(jdataset, "PokemonDataset",
                        lambda _csv, _dir, **kw: dataset(*tree.corpus, **kw))
    monkeypatch.setattr(jdataset, "read_description_csv", lambda _csv: read_csv(tree.corpus[0]))
    build = japp.build_generator

    def built(*a, **kw):
        key = json.dumps([a, kw], default=str)
        if key not in jax_built:
            gen = build(*a, **kw)
            jax_built[key] = (gen, (gen.guidance_scale, gen.guidance_rescale,
                                    gen.guidance_t_lo, gen.guidance_t_hi))
        gen, knobs = jax_built[key]
        if (gen.guidance_scale, gen.guidance_rescale, gen.guidance_t_lo,
                gen.guidance_t_hi) != knobs:
            T = gen.cfg.model.num_timesteps
            gen.set_guidance(knobs[0], knobs[1], knobs[2] / T, knobs[3] / T)
        return gen

    monkeypatch.setattr(japp, "build_generator", built)
    monkeypatch.setattr(jddim, "build_generator", built)   # imported by name there
    side = tree.diff.with_suffix(".json")
    meta = side.read_text()
    yield tree
    side.write_text(meta)


def _run_jax(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    assert mod.main() == 0


def _normal(key, shape):
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32), np.float32))


def _restart_draws(key, n, num):
    """(encoder noise, lerp noise) per restart pass, as ``_restart_passes``
    splits its key."""
    out = []
    for i in range(n):
        k_enc, k_noise, _k_sample, key = jax.random.split(jax.random.fold_in(key, 100 + i), 4)
        out.append((_normal(k_enc, (num, *LATENT)), _normal(k_noise, (num, *LATENT))))
    return out


@pytest.fixture
def jax_draws(monkeypatch):
    """Every request of the port's generator gets the gaussians the JAX
    method splits from the request's seed: the prior from the sampler's
    split, an init's encoder and lerp noises, each restart pass's pair.
    ``generate_batch`` goes on from the third key of its init split,
    ``generate_from_text_retrieval`` restarts from the seed's key."""
    req = {}
    for meth in ("generate_batch", "generate_from_text_retrieval"):
        orig = getattr(PokemonGenerator, meth)

        def public(self, *a, _orig=orig, _meth=meth, **kw):
            req["method"] = _meth
            return _orig(self, *a, **kw)

        monkeypatch.setattr(PokemonGenerator, meth, public)
    orig_generator, orig_serve = PokemonGenerator._generator, PokemonGenerator._serve

    def generator(self, seed):
        req["seed"] = seed
        return orig_generator(self, seed)

    def serve(self, ids, mask, gen, *, num, init_images=None, restarts=0, **kw):
        key = jax.random.PRNGKey(req["seed"])
        draws = {}
        if init_images is None:
            draws["prior"] = _normal(jax.random.split(key)[1], (num, *LATENT))
        else:
            k_enc, k_noise, k_next = jax.random.split(key, 3)
            draws["init"] = (_normal(k_enc, (num, *LATENT)), _normal(k_noise, (num, *LATENT)))
            if req["method"] == "generate_batch":
                key = k_next
        draws["restarts"] = _restart_draws(key, restarts, num)
        return orig_serve(self, ids, mask, gen, num=num, init_images=init_images,
                          restarts=restarts, draws=draws, **kw)

    monkeypatch.setattr(PokemonGenerator, "_generator", generator)
    monkeypatch.setattr(PokemonGenerator, "_serve", serve)


@pytest.fixture
def scored(monkeypatch):
    """Records the generations each package's ``conditioning_report`` scores."""
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jeval), ("port", tmetrics)):
        orig = mod.conditioning_report

        def report(generated, real, *a, _orig=orig, _name=name, **kw):
            seen[_name].append(np.stack(generated))
            return _orig(generated, real, *a, **kw)

        monkeypatch.setattr(mod, "conditioning_report", report)
    return seen


def _mae(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape and np.isfinite(a).all()
    return float(np.abs(a - b).mean())


def _decisive(scores):
    """Rows whose best score beats the second by more than 2 * SCORE_TOL."""
    top2 = np.sort(scores, axis=1)[:, -2:]
    return top2[:, 1] - top2[:, 0] > 2 * SCORE_TOL


def _hold_scores(got, ref, real):
    """Images within MAE, score matrices within SCORE_TOL, the same best
    match in every decisive row; returns the decisive mask."""
    assert _mae(got, ref) <= MAE
    s_got = pairwise_conditioning_scores(list(got), real)
    s_ref = pairwise_conditioning_scores(list(ref), real)
    np.testing.assert_allclose(s_got, s_ref, rtol=0, atol=SCORE_TOL)
    sure = _decisive(s_ref)
    np.testing.assert_array_equal(s_got.argmax(1)[sure], s_ref.argmax(1)[sure])
    return sure


def _real(tree, n=8):
    ds = PokemonDataset(*tree.corpus, image_size=64)
    return [ds.image_float(i) for i in range(n)]


# ---------------------------------------------------------------------------
# constants and argument rules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["PARAPHRASES", "FAMILIES", "DEFAULT_SWEEP", "PROMPTS"])
def test_constants_equal_jax(name):
    pairs = {"PARAPHRASES": (teval_script, jeval_script),
             "FAMILIES": (teval_script, jeval_script),
             "DEFAULT_SWEEP": (tsweep, jsweep), "PROMPTS": (tddim, jddim)}[name]
    assert getattr(pairs[0], name) == getattr(pairs[1], name)


@pytest.mark.parametrize("recipe", ["g=2.0", "g=3.5,resc=0.7,lo=0.1,hi=0.8,steps=10,restarts=1",
                                    "steps=25,restarts=0", "hi=0.6,g=1"])
def test_parse_recipe_equals_jax(recipe):
    got = tsweep.parse_recipe(recipe)
    assert got == jsweep.parse_recipe(recipe)
    assert [type(v) for v in got.values()] == [type(v) for v in
                                               jsweep.parse_recipe(recipe).values()]


@pytest.mark.parametrize("recipe", ["g=2.0,cfg=3", "eta=0.5"])
def test_parse_recipe_rejects_unknown_fields_as_jax(recipe):
    with pytest.raises(SystemExit) as got:
        tsweep.parse_recipe(recipe)
    with pytest.raises(SystemExit) as ref:
        jsweep.parse_recipe(recipe)
    assert str(got.value) == str(ref.value)


def test_eval_argument_rules():
    o = teval_script.parse_args([])
    assert (o.name, o.n, o.steps, o.sampler, o.guidance, o.out, o.restarts, o.negative) == (
        "evidence_r3b", 8, 25, "dpmpp", 0.0, Path("docs/eval_conditioning.json"), 0, "zero")
    assert (o.seeds, o.strength, o.stamp, o.device) == ([1234], 0.85, False, None)
    # exact membership: init=retrieval-loo is not init=retrieval
    loo = teval_script.parse_args(["init=retrieval-loo"])
    assert loo.loo and not loo.retrieval
    both = teval_script.parse_args(["init=retrieval", "prompts=paraphrase"])
    assert both.retrieval and both.paraphrase and not both.loo
    o = teval_script.parse_args(["x", "4", "10", "ddim", "2.5", "o.json", "1", "mean",
                                 "seeds=5,6", "strength=0.7", "stamp=0", "device=cpu",
                                 "data.image_size=64", "init=retrieval"])
    assert (o.name, o.n, o.steps, o.sampler, o.guidance, o.out, o.restarts, o.negative) == (
        "x", 4, 10, "ddim", 2.5, Path("o.json"), 1, "mean")
    assert (o.seeds, o.strength, o.stamp, o.device) == ([5, 6], 0.7, False, "cpu")
    assert o.overrides == ["device=cpu", "data.image_size=64"]
    assert [s for s, _, _ in teval_script.seed_outputs(o)] == [5, 6]
    assert teval_script.parse_args(["seed=9"]).seeds == [9]


def test_default_dataset_is_the_jax_scripts_fixed_path():
    """The scripts' default corpus is ``config/train_config.yaml``'s, read as
    the JAX package reads it, and is the path the JAX scripts fix."""
    got = tconfig.dataset_overrides()
    jcfg = jax_load_config(ROOT / "config" / "train_config.yaml")
    assert got == [f"data.csv_path={jcfg.data.csv_path}",
                   f"data.image_dir={jcfg.data.image_dir}"]
    for rel in ("scripts/eval_conditioning.py", "scripts/recipe_sweep.py",
                "scripts/ddim_evidence.py"):
        text = (ROOT / rel).read_text()
        assert all(f'"{o}"' in text for o in got), rel


# ---------------------------------------------------------------------------
# the eval script's own logic, on identical images
# ---------------------------------------------------------------------------


class _FakeGenerator:
    """Stands in for both packages' generators: each request's images come
    from the real sprites and the request alone (caption i's generation is
    its own sprite for i < ``hits``, its neighbour's otherwise, plus noise
    from the seed)."""

    retrieval_mode = "hybrid"

    def __init__(self, tree, ckpt, hits):
        self.cfg = tconfig.load_config(None, tree.overrides)
        self.real = _real(tree)
        self.diffusion_checkpoint = str(ckpt)
        self.hits = hits

    def _image(self, i, seed, salt):
        rs = np.random.RandomState([seed, salt, i])
        src = self.real[i if i < self.hits else (i + 1) % len(self.real)]
        return np.clip(src + 0.05 * rs.randn(*src.shape), -1, 1).astype(np.float32)

    def generate_batch(self, captions, num_inference_steps=50, seed=None, restarts=0,
                       init="prior", init_strength=0.85):
        salt = num_inference_steps + 7 * restarts + (1000 if init == "retrieval" else 0)
        return np.stack([self._image(i, seed, salt) for i in range(len(captions))])

    def generate_from_text_retrieval(self, description, num_inference_steps=50, seed=None,
                                     strength=0.85, restarts=0, exclude=None):
        return timages.tensor_to_pil(self._image(exclude, seed, num_inference_steps))


def _fake_ckpt(root, run, stage, meta):
    p = root / f"{run}_{stage}" / "checkpoints" / f"{stage}_best_model.ckpt"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(b"x")
    p.with_suffix(".json").write_text(json.dumps(meta))
    return p


def _run_both_fake(env, tmp_path, monkeypatch, argv, *, hits=5, jax_ckpt=None,
                   port_ckpt=None):
    """JAX's ``main()`` and the port's on fake generators that return the
    same images; each writes under its own dir and stamps its own sidecar."""
    outs = {}
    for side, ckpt in (("jax", jax_ckpt), ("port", port_ckpt)):
        d = tmp_path / side
        ckpt = ckpt or _fake_ckpt(d, "tiny", "diffusion", {"metric": 0.4, "step": 3})
        gen = _FakeGenerator(env, ckpt, hits)
        args = [*argv[:5], str(d / "eval.json"), *argv[5:]]
        if side == "jax":
            monkeypatch.setattr(japp, "build_generator", lambda *a, **k: gen)
            _run_jax(jeval_script, args, monkeypatch)
        else:
            monkeypatch.setattr(tapp, "build_generator", lambda *a, **k: gen)
            assert teval_script.main(args + ["device=cpu"]) == 0
        outs[side] = (d, Path(ckpt))
    return outs


def _report(path):
    rep = json.loads(path.read_text())
    assert rep.pop("grid") == str(path.with_suffix(".png"))
    return rep


MODES = {"prior": ["stamp=1"], "retrieval": ["init=retrieval", "stamp=1"],
         "retrieval-loo": ["init=retrieval-loo", "strength=0.7", "stamp=1"],
         "paraphrase": ["prompts=paraphrase", "stamp=1"],
         "seeds": ["seeds=11,12", "stamp=1", "1", "mean"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_eval_report_on_identical_images_equals_jax(env, tmp_path, monkeypatch, mode):
    extra = MODES[mode]
    pos = ["tiny", "8", "3", "dpmpp", "2.0"]
    argv = pos + [a for a in extra if "=" not in a] + [a for a in extra if "=" in a]
    outs = _run_both_fake(env, tmp_path, monkeypatch, argv)
    (jd, jck), (td, tck) = outs["jax"], outs["port"]
    names = ["eval.json"] + (["eval_seed12.json"] if mode == "seeds" else [])
    for name in names:
        ref, got = _report(jd / name), _report(td / name)
        assert got.keys() == ref.keys()
        for k in ref:
            if isinstance(ref[k], float):
                assert abs(got[k] - ref[k]) <= 1e-12, k
            else:
                assert got[k] == ref[k], k
        stem = Path(name).stem
        assert ((td / f"{stem}.txt").read_text() == (jd / f"{stem}.txt").read_text())
        np.testing.assert_array_equal(np.asarray(Image.open(td / f"{stem}.png")),
                                      np.asarray(Image.open(jd / f"{stem}.png")))
    assert sorted(p.name for p in td.iterdir()) == sorted(p.name for p in jd.iterdir())
    if mode == "paraphrase":
        assert ref["prompts"] == "paraphrase" and "family_retrieval_at_1" in ref
    got_meta = json.loads(tck.with_suffix(".json").read_text())
    assert got_meta == json.loads(jck.with_suffix(".json").read_text())
    stamped = mode in ("prior", "seeds")   # only dataset prompts from the prior
    assert ("eval" in got_meta) == stamped
    if stamped:
        first = _report(td / "eval.json")
        assert got_meta["eval"]["retrieval_at_1"] == first["retrieval_at_1"]
        assert got_meta["eval"]["recipe"]["seed"] == first["seed"]


@pytest.mark.parametrize("diff_hits,final_hits,stamper", [
    (4, 6, "port"), (6, 4, "port"), (4, 6, "jax"), (5, 5, "jax")])
def test_stamped_sidecars_resolve_alike(env, tmp_path, monkeypatch, diff_hits, final_hits,
                                        stamper):
    """One package's script stamps the stage-2 best, the other's the stage-3
    bundle; both packages' resolution then picks the same checkpoints: the
    bundle shadows the pair only when its stamp is not worse."""
    exp = tmp_path / "exp"
    vae = _fake_ckpt(exp, "tiny", "vae", {"metric": 0.05})
    diff = _fake_ckpt(exp, "tiny", "diffusion", {"metric": 0.4, "vae_checkpoint": str(vae)})
    final = _fake_ckpt(exp, "tiny", "final", {"metric": 0.3})
    scripts = {"jax": (japp, lambda a: _run_jax(jeval_script, a, monkeypatch)),
               "port": (tapp, lambda a: teval_script.main(a + ["device=cpu"]))}
    other = "jax" if stamper == "port" else "port"
    for who, ckpt, hits in ((stamper, diff, diff_hits), (other, final, final_hits)):
        app, run = scripts[who]
        gen = _FakeGenerator(env, ckpt, hits)
        monkeypatch.setattr(app, "build_generator", lambda *a, **k: gen)
        run(["tiny", "8", "3", "dpmpp", "0.0", str(tmp_path / who / "eval.json"), "stamp=1"])
        assert json.loads(ckpt.with_suffix(".json").read_text())["eval"][
            "retrieval_at_1"] == hits / 8
    want = (str(final), str(final)) if final_hits >= diff_hits else (str(vae), str(diff))
    tcfg = tconfig.load_config(None, [f"experiment_dir={exp}"])
    jcfg = jax_load_config(None, [f"experiment_dir={exp}"])
    assert thub.resolve_checkpoints(tcfg, "tiny", allow_hub=False) == want
    assert jhub.resolve_checkpoints(jcfg, "tiny", allow_hub=False) == want


# ---------------------------------------------------------------------------
# end to end against the JAX scripts, with JAX's draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [["stamp=1"], ["init=retrieval-loo", "strength=0.8",
                                                 "stamp=1"]], ids=["prior", "loo"])
def test_eval_matches_jax(env, tmp_path, monkeypatch, jax_draws, scored, flags):
    side = env.diff.with_suffix(".json")
    before = side.read_text()
    runs = {}
    for who in ("jax", "port"):
        argv = ["tiny", "8", "3", "dpmpp", "2.0", str(tmp_path / who / "eval.json"), "0",
                "mean", *env.overrides, *flags]
        if who == "jax":
            _run_jax(jeval_script, argv, monkeypatch)
        else:
            assert teval_script.main(argv) == 0
        runs[who] = (_report(tmp_path / who / "eval.json"), json.loads(side.read_text()))
        side.write_text(before)
    (ref, jside), (got, tside) = runs["jax"], runs["port"]
    (jimgs,), (timgs,) = scored["jax"], scored["port"]
    sure = _hold_scores(timgs, jimgs, _real(env))
    assert got.keys() == ref.keys()
    assert abs(got["retrieval_at_1"] - ref["retrieval_at_1"]) <= (~sure).sum() / 8
    for k in ("matched_mean", "mismatched_mean", "margin"):
        assert abs(got[k] - ref[k]) <= SCORE_TOL, k
    for k in ("n", "chance_retrieval", "checkpoint", "sampler", "guidance", "negative",
              "init", "seed"):
        assert got[k] == ref[k], k
    assert got.get("retrieval_mode") == ref.get("retrieval_mode")
    if "loo" in flags[0]:
        assert tside == jside == json.loads(before)
        return
    assert tside["eval"]["recipe"] == jside["eval"]["recipe"]
    assert tside["eval"]["retrieval_at_1"] == got["retrieval_at_1"]
    assert jside["eval"]["retrieval_at_1"] == ref["retrieval_at_1"]
    # a fresh generator on the experiment resolves the stamped checkpoint,
    # ranked by the stamp
    side.write_text(json.dumps(tside))
    gen = tapp.build_generator(None, "tiny", env.overrides, device="cpu")
    assert (gen.diffusion_checkpoint, gen.loaded) == (str(env.diff), "pair")
    cand = thub.list_candidates(gen.cfg, "diffusion", "tiny")[0]
    assert cand["eval"] == got["retrieval_at_1"]


def test_recipe_sweep_matches_jax(env, tmp_path, monkeypatch, jax_draws, scored):
    recipes = ["g=2.0,steps=3,restarts=1", "g=3.5,resc=0.7,lo=0.1,hi=0.8,steps=3,restarts=0"]
    for who in ("jax", "port"):
        argv = ["tiny", "8", str(tmp_path / who / "sweep.json"), *recipes, *env.overrides]
        if who == "jax":
            _run_jax(jsweep, argv, monkeypatch)
        else:
            assert tsweep.main(argv) == 0
    ref = json.loads((tmp_path / "jax" / "sweep.json").read_text())
    got = json.loads((tmp_path / "port" / "sweep.json").read_text())
    assert {k: v for k, v in got.items() if k != "ranked"} == {
        k: v for k, v in ref.items() if k != "ranked"}
    assert ref["negative"] == "mean" and ref["n"] == 8
    real = _real(env)
    assert len(scored["port"]) == len(scored["jax"]) == len(recipes)
    undecided = {json.dumps(jsweep.parse_recipe(r)): int((~_hold_scores(t, j, real)).sum())
                 for r, t, j in zip(recipes, scored["port"], scored["jax"])}
    by_recipe = {json.dumps(r["recipe"]): r for r in got["ranked"]}
    for rrow in ref["ranked"]:
        key = json.dumps(rrow["recipe"])
        grow = by_recipe[key]
        assert grow.keys() == rrow.keys()
        assert abs(grow["retrieval_at_1"] - rrow["retrieval_at_1"]) <= undecided[key] / 8
        for k in ("margin", "matched_mean"):
            assert abs(grow[k] - rrow[k]) <= SCORE_TOL, k
        tag = "_".join(f"{k}{v}" for k, v in rrow["recipe"].items())
        for who in ("jax", "port"):
            assert (tmp_path / who / f"sweep_{tag}.png").exists()
            assert (tmp_path / who / f"sweep_{tag}.txt").exists()


@pytest.mark.parametrize("prompts", ["PROMPTS", "dataset"])
def test_ddim_evidence_matches_jax(env, tmp_path, monkeypatch, jax_draws, prompts):
    grids = {}
    for side, mod in (("jax", jddim), ("port", timages)):
        orig = mod.save_image_grid

        def save(imgs, path, *a, _orig=orig, _side=side, **kw):
            grids[_side] = np.asarray(imgs, np.float32)
            return _orig(imgs, path, *a, **kw)

        monkeypatch.setattr(mod, "save_image_grid", save)
    for side in ("jax", "port"):
        argv = ["tiny", "4", str(tmp_path / side / "grid.png"), "0.0", "ddim", "0",
                "dataset" if prompts == "dataset" else "none", *env.overrides]
        if side == "jax":
            monkeypatch.setattr(sys, "argv", ["ddim_evidence.py", *argv])
            assert jddim.main() == 0
        else:
            assert tddim.main(argv) == 0
    assert grids["port"].shape == (8, 64, 64, 3)
    assert _mae(grids["port"], grids["jax"]) <= MAE
    txt = (tmp_path / "port" / "grid.txt").read_text()
    assert txt == (tmp_path / "jax" / "grid.txt").read_text()
    if prompts == "dataset":
        assert txt.startswith("0: Pokemon named ")
    else:
        assert txt.splitlines()[1] == "1: " + tddim.PROMPTS[1]


# ---------------------------------------------------------------------------
# the device, and the quickstart's argument list
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("script", ["eval", "sweep", "ddim"])
def test_scripts_raise_without_a_card_before_reading_a_file(script, tmp_path, monkeypatch):
    def no_read(*a, **k):
        raise AssertionError("a file was read before the device was resolved")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod in (tconfig, tapp):
        monkeypatch.setattr(mod, "load_config", no_read)
    monkeypatch.setattr(tconfig, "dataset_overrides", no_read)
    main = {"eval": teval_script.main, "sweep": tsweep.main, "ddim": tddim.main}[script]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["tiny", "2", "3", f"experiment_dir={tmp_path}"])
    assert not any(tmp_path.iterdir())


def test_quickstart_hands_the_cli_the_jax_argument_list(monkeypatch):
    import psg_tpu.train.cli as jcli
    import psg_tpu_torch.train.cli as tcli

    got = {}
    for side, mod in (("jax", jcli), ("port", tcli)):
        monkeypatch.setattr(mod, "main", lambda argv, _side=side: got.setdefault(_side, argv)
                            and 0)
    monkeypatch.setattr(sys, "argv", ["quickstart.py", "--experiment-name", "qs"])
    for side, path in (("jax", "examples/quickstart.py"), ("port", "examples/torch_quickstart.py")):
        with pytest.raises(SystemExit) as done:
            runpy.run_path(str(ROOT / path), run_name="__main__")
        assert done.value.code == 0
    assert got["port"] == got["jax"]
    assert got["port"][:4] == ["--config", "config/train_config.yaml", "--stage", "all"]
    assert got["port"][-2:] == ["--experiment-name", "qs"]


def test_quickstart_raises_without_a_card(monkeypatch):
    """The recipe goes to the real CLI, whose first trainer resolves the
    device: no card and no ``--device cpu`` raises, nothing trains."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", ["torch_quickstart.py"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        runpy.run_path(str(ROOT / "examples/torch_quickstart.py"), run_name="__main__")
