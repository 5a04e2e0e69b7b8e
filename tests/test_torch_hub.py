"""Checkpoint resolution, the serving CLI and the eval metrics of
psg_tpu_torch, against psg_tpu on the CPU.

The resolution scenarios mirror tests/test_serve.py's: fake ``.ckpt`` files
with sidecar JSONs, on which the port must rank, pair and shadow exactly as
the JAX package does (the same candidates, the same resolved pair, the same
``--list-checkpoints`` text).  The CLI runs in-process at the tiny config
over a sprite corpus written from a seed, with the Hub switched off
(``HF_HUB_OFFLINE=1``, and any DNS lookup fails the test)."""

import builtins
import json
import os
import socket
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.eval import metrics as jmetrics
from psg_tpu.serve import app as japp
from psg_tpu.serve import hub as jhub

from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.eval import metrics as tmetrics
from psg_tpu_torch.serve import app as tapp
from psg_tpu_torch.serve import hub as thub

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)


def _fake_ckpt(root, run, stage, *, metric=None, vae_checkpoint=None,
               eval_at_1=None, eval_recipe=None, mtime=None):
    d = root / f"{run}_{stage}" / "checkpoints"
    d.mkdir(parents=True, exist_ok=True)
    p = d / f"{stage}_best_model.ckpt"
    p.write_bytes(b"x")
    meta = {"step": 1}
    if metric is not None:
        meta["metric"] = metric
    if vae_checkpoint is not None:
        meta["vae_checkpoint"] = str(vae_checkpoint)
    if eval_at_1 is not None:
        meta["eval"] = {"retrieval_at_1": eval_at_1}
        if eval_recipe is not None:
            meta["eval"]["recipe"] = eval_recipe
    p.with_suffix(".json").write_text(json.dumps(meta))
    if mtime is not None:
        os.utime(p, (mtime, mtime))
    return p


def _tree_val_beats_mtime(t):
    good = _fake_ckpt(t, "good", "vae", metric=0.03, mtime=1000)
    _fake_ckpt(t, "good", "diffusion", metric=0.44, vae_checkpoint=good, mtime=1000)
    _fake_ckpt(t, "inflight", "vae", metric=0.09, mtime=2000)
    _fake_ckpt(t, "inflight", "diffusion", metric=0.61, mtime=2000)
    return "nonexistent", ("good_diffusion", "good_vae")


def _tree_metricless_last(t):
    _fake_ckpt(t, "measured", "diffusion", metric=0.50, mtime=1000)
    (t / "bare_diffusion" / "checkpoints").mkdir(parents=True)
    (t / "bare_diffusion" / "checkpoints" / "diffusion_best_model.ckpt").write_bytes(b"x")
    return "nonexistent", ("measured_diffusion", None)


def _tree_pairs_by_family(t):
    _fake_ckpt(t, "other", "vae", metric=0.001)
    _fake_ckpt(t, "run1", "vae", metric=0.05)
    _fake_ckpt(t, "run1", "diffusion", metric=0.44)
    return "nonexistent", ("run1_diffusion", "run1_vae")


def _tree_pairs_by_pointer(t):
    _tree_pairs_by_family(t)
    target = _fake_ckpt(t, "elsewhere", "vae", metric=0.07)
    _fake_ckpt(t, "run1", "diffusion", metric=0.44, vae_checkpoint=target)
    return "nonexistent", ("run1_diffusion", "elsewhere_vae")


def _tree_pointer_gone(t):
    _fake_ckpt(t, "best", "vae", metric=0.01)
    _fake_ckpt(t, "run1", "diffusion", metric=0.44, vae_checkpoint=t / "gone.ckpt")
    return "nonexistent", ("run1_diffusion", "best_vae")


def _final_tree(final_eval, prefer=False):
    def build(t):
        vae = _fake_ckpt(t, "s2", "vae", metric=0.03)
        _fake_ckpt(t, "s2", "diffusion", metric=0.44, vae_checkpoint=vae, eval_at_1=0.25)
        _fake_ckpt(t, "s3", "final", metric=0.2, eval_at_1=final_eval)
        shadows = prefer or (final_eval is not None and final_eval >= 0.25)
        return "nonexistent", ("s3_final", "s3_final") if shadows else ("s2_diffusion", "s2_vae")
    build.prefer_final = prefer
    return build


def _tree_stamped_beats_val(t):
    bound = _fake_ckpt(t, "bound", "vae", metric=0.05, mtime=1000)
    _fake_ckpt(t, "bound", "diffusion", metric=0.447, vae_checkpoint=bound,
               eval_at_1=0.375, mtime=1000)
    _fake_ckpt(t, "collapsed", "vae", metric=0.04, mtime=2000)
    _fake_ckpt(t, "collapsed", "diffusion", metric=0.441, eval_at_1=0.0, mtime=2000)
    _fake_ckpt(t, "unstamped", "diffusion", metric=0.430, mtime=3000)
    return "nonexistent", ("bound_diffusion", "bound_vae")


def _tree_foreign_final(same_family):
    def build(t):
        vae = _fake_ckpt(t, "r3c", "vae", metric=0.05)
        _fake_ckpt(t, "r3c", "diffusion", metric=0.448, vae_checkpoint=vae)
        _fake_ckpt(t, "r4", "final", metric=0.045, eval_at_1=0.0625)
        if same_family:
            _fake_ckpt(t, "r3c", "final", metric=0.044, eval_at_1=0.5)
            return "r3c", ("r3c_final", "r3c_final")
        return "r3c", ("r3c_diffusion", "r3c_vae")
    return build


def _tree_foreign_final_named_pair(t):
    vae = _fake_ckpt(t, "mine", "vae", metric=0.05)
    _fake_ckpt(t, "mine", "diffusion", metric=0.448, vae_checkpoint=vae, eval_at_1=0.1)
    _fake_ckpt(t, "other", "final", metric=0.04, eval_at_1=0.9)
    return "mine", ("mine_diffusion", "mine_vae")


def _tree_non_canonical(t):
    _fake_ckpt(t, "honest", "diffusion", metric=0.50, eval_at_1=0.19,
               eval_recipe={"prompts": "dataset", "init": "prior", "n": 16})
    _fake_ckpt(t, "para", "diffusion", metric=0.44, eval_at_1=0.31,
               eval_recipe={"prompts": "paraphrase", "init": "prior", "n": 16})
    _fake_ckpt(t, "crutch", "diffusion", metric=0.44, eval_at_1=0.5,
               eval_recipe={"prompts": "dataset", "init": "retrieval@0.6", "n": 16})
    return "nonexistent", ("honest_diffusion", None)


def _tree_incomparable_final(same_recipe):
    def build(t):
        vae = _fake_ckpt(t, "run", "vae", metric=0.05)
        _fake_ckpt(t, "run", "diffusion", metric=0.448, vae_checkpoint=vae, eval_at_1=0.19,
                   eval_recipe={"prompts": "dataset", "init": "prior", "n": 16})
        _fake_ckpt(t, "run", "final", metric=0.44, eval_at_1=0.25,
                   eval_recipe={"prompts": "dataset", "init": "prior",
                                "n": 16 if same_recipe else 8})
        return "run", ("run_final", "run_final") if same_recipe else ("run_diffusion",
                                                                       "run_vae")
    return build


def _tree_bare(t):
    (t / "diffusion_best_model.ckpt").write_bytes(b"x")
    (t / "vae_best_model.ckpt").write_bytes(b"x")
    return "pokemon", ("", "")


def _tree_empty(t):
    return "pokemon", (None, None)


TREES = {
    "val_beats_mtime": _tree_val_beats_mtime,
    "metricless_last": _tree_metricless_last,
    "pairs_by_family": _tree_pairs_by_family,
    "pairs_by_pointer": _tree_pairs_by_pointer,
    "pointer_gone": _tree_pointer_gone,
    "drifted_final": _final_tree(0.0),
    "evalless_final": _final_tree(None),
    "better_final": _final_tree(0.30),
    "prefer_final": _final_tree(0.0, prefer=True),
    "stamped_beats_val": _tree_stamped_beats_val,
    "foreign_final": _tree_foreign_final(False),
    "same_family_final": _tree_foreign_final(True),
    "foreign_final_named_pair": _tree_foreign_final_named_pair,
    "non_canonical_stamps": _tree_non_canonical,
    "incomparable_final": _tree_incomparable_final(False),
    "comparable_final": _tree_incomparable_final(True),
    "bare_layout": _tree_bare,
    "empty": _tree_empty,
}


def _configs(tmp, build):
    cfgs = []
    for cls in (JaxConfig, Config):
        cfg = cls()
        cfg.experiment_dir = str(tmp)
        if getattr(build, "prefer_final", False):
            cfg.extra["serve_prefer_final"] = True
        cfgs.append(cfg)
    return cfgs


def _run_of(path):
    if path is None:
        return None
    p = Path(path)
    return p.parent.parent.name if p.parent.name == "checkpoints" else ""


@pytest.mark.parametrize("tree", sorted(TREES))
def test_resolution_matches_jax(tree, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the relative weights/ candidates resolve here
    name, want = TREES[tree](tmp_path)
    jcfg, tcfg = _configs(tmp_path, TREES[tree])
    for stage in ("final", "diffusion", "vae"):
        for exp in (name, None):
            assert (thub.list_candidates(tcfg, stage, exp)
                    == jhub.list_candidates(jcfg, stage, exp))
    got = thub.resolve_checkpoints(tcfg, name, allow_hub=False)
    assert got == jhub.resolve_checkpoints(jcfg, name, allow_hub=False)
    diff, vae = want
    assert _run_of(got[1]) == diff
    if vae is not None:
        assert _run_of(got[0]) == vae
    assert (thub.describe_candidates(tcfg, name)
            == jhub.describe_candidates(jcfg, name))


def test_non_canonical_stamps_do_not_rank(tmp_path):
    _tree_non_canonical(tmp_path)
    cfg = Config()
    cfg.experiment_dir = str(tmp_path)
    cands = thub.list_candidates(cfg, "diffusion")
    assert cands[0]["run"] == "honest_diffusion"
    assert {c["run"] for c in cands[1:]} == {"para_diffusion", "crutch_diffusion"}
    assert all(c["eval"] is None for c in cands[1:])


def test_hub_offline_gate_makes_no_lookup(monkeypatch):
    """With HF_HUB_OFFLINE=1 the Hub is skipped before any DNS lookup, and
    huggingface_hub is not imported."""
    def no_lookup(*a, **k):
        raise AssertionError("DNS lookup attempted")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(socket, "getaddrinfo", no_lookup)
    assert thub._try_hub(thub.VAE_REPO, "vae_best_model.ckpt") is None
    assert "huggingface_hub" not in sys.modules or sys.modules["huggingface_hub"] is None


# ---------------------------------------------------------------------------
# the serving CLI
# ---------------------------------------------------------------------------

TINY = ["model.bert_model=tiny-test", "model.vae_width_scale=0.25",
        "model.text_embedding_dim=48", "model.unet_channels=[16,24,32,32]",
        "model.num_attention_heads=4", "model.time_emb_dim=32", "model.num_timesteps=50",
        "data.image_size=64", "data.text_len=32"]


@pytest.fixture
def cli(tmp_path, monkeypatch):
    """A scratch working directory with a sprite corpus; no Hub, no DNS, no
    pretrained-BERT vocabulary.  Returns the --override flags."""
    def no_lookup(*a, **k):
        raise AssertionError("DNS lookup attempted")

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(socket, "getaddrinfo", no_lookup)
    for var in ("PSG_TPU_BERT", "PSG_TPU_BERT_VOCAB"):
        monkeypatch.delenv(var, raising=False)
    csv, image_dir = write_sprite_corpus(tmp_path / "corpus", n=6, seed=1)
    flags = []
    for o in TINY + [f"data.csv_path={csv}", f"data.image_dir={image_dir}",
                     f"experiment_dir={tmp_path / 'exp'}"]:
        flags += ["--override", o]
    return flags


def test_cli_prompt_writes_seeded_png(cli, tmp_path, capsys):
    run = ["--steps", "2", "--device", "cpu", *cli, "--prompt", "a red fire creature"]
    outs = [tmp_path / f"{n}.png" for n in ("a", "b", "c", "d")]
    assert tapp.main(run + ["--seed", "3", "--out", str(outs[0])]) == 0
    assert "loaded=none" in capsys.readouterr().out   # random weights are announced
    assert tapp.main(run + ["--seed", "3", "--out", str(outs[1])]) == 0
    assert tapp.main(run + ["--seed", "4", "--out", str(outs[2])]) == 0
    assert tapp.main(run + ["--seed", "3", "--out", str(outs[3]), "--init", "retrieval",
                            "--restarts", "1", "--sampler", "renoise"]) == 0
    imgs = [np.asarray(Image.open(p)) for p in outs]
    assert imgs[0].shape == (64, 64, 3)
    assert np.array_equal(imgs[0], imgs[1]) and not np.array_equal(imgs[0], imgs[2])
    assert imgs[3].shape == (64, 64, 3)


def test_cli_list_checkpoints_prints_jax_text(cli, tmp_path, capsys):
    _tree_stamped_beats_val(tmp_path / "exp")
    _fake_ckpt(tmp_path / "exp", "bound", "final", metric=0.4)
    argv = ["--list-checkpoints", "--override", f"experiment_dir={tmp_path / 'exp'}"]
    assert tapp.main(argv) == 0
    got = capsys.readouterr().out
    assert japp.main(argv) == 0
    assert got == capsys.readouterr().out
    assert "resolved pair:" in got and "bound_diffusion" in got


def test_cli_repl_exits_on_eof(cli, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", None)   # import gradio fails
    lines = iter(["a blue water turtle"])

    def fake_input(prompt=""):
        try:
            return next(lines)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr(builtins, "input", fake_input)
    out = tmp_path / "repl.png"
    assert tapp.main(["--steps", "2", "--device", "cpu", *cli, "--out", str(out)]) == 0
    assert (tmp_path / "repl_000.png").exists() and not (tmp_path / "repl_001.png").exists()


def test_cli_without_a_gpu_raises(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapp.main(["--steps", "2", *cli, "--prompt", "x", "--out", str(tmp_path / "x.png")])
    assert not (tmp_path / "x.png").exists()


def test_sampler_default_and_flags_match_jax():
    import inspect

    assert inspect.signature(tapp.build_generator).parameters["sampler"].default == "ddim"
    got, ref = _parser_defaults(tapp.main), _parser_defaults(japp.main)
    assert got.pop("device") is None
    assert got == ref and got["sampler"] == "ddim"


def _parser_defaults(main):
    import argparse

    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        seen.update({a.dest: a.default for a in self._actions if a.dest != "help"})
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen


def test_schedule_and_prediction_type_from_sidecar(tmp_path):
    ck = tmp_path / "diffusion_best_model.ckpt"
    ck.write_bytes(b"")
    ck.with_suffix(".json").write_text(json.dumps(
        {"config": {"model": {"beta_schedule": "cosine"}, "extra": {"prediction_type": "v"}}}))
    for mod in (tapp, japp):
        assert mod._schedule_from_checkpoint(ck) == "cosine"
        assert mod._prediction_type_from_checkpoint(ck) == "v"
        assert mod._schedule_from_checkpoint(tmp_path / "missing.ckpt") == "linear"
        assert mod._prediction_type_from_checkpoint(tmp_path / "missing.ckpt") == "eps"
    ck.with_suffix(".json").write_text("not json")
    assert tapp._schedule_from_checkpoint(ck) == "linear"
    assert tapp._prediction_type_from_checkpoint(ck) == "eps"


def test_gradio_interface_wiring(monkeypatch):
    """Both tabs' click handlers route to the generator API (gradio stubbed)."""
    calls = []

    class _Ctx:
        def __init__(self, *a, **k):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _Widget:
        def __init__(self, *a, **k):
            pass

    class _Button(_Widget):
        def click(self, fn, inputs, outputs):
            calls.append(fn)

    gr = types.ModuleType("gradio")
    gr.Blocks = gr.Tab = _Ctx
    gr.Markdown = gr.Textbox = gr.Slider = gr.Number = gr.Checkbox = gr.Image = _Widget
    gr.Button = _Button
    monkeypatch.setitem(sys.modules, "gradio", gr)

    class FakeGen:
        def generate_from_text(self, d, steps, seed, restarts=0):
            return ("text", d, steps, seed, restarts)

        def generate_from_text_retrieval(self, d, steps, seed, strength=0.85, restarts=0):
            return ("retr", d, steps, seed, strength, restarts)

        def generate_from_image_and_text(self, img, d, steps, ns, seed):
            return ("img", img, d, steps, ns, seed)

    assert tapp.create_gradio_interface(FakeGen()) is not None
    assert len(calls) == 2
    assert calls[0]("a creature", 50, 42, 1, False, 0.85) == ("text", "a creature", 50, 42, 1)
    assert calls[0]("a creature", 50, 42, 1, True, 0.9) == (
        "retr", "a creature", 50, 42, 0.9, 1)
    assert calls[1]("IMG", "desc", 30, 0.7, 1) == ("img", "IMG", "desc", 30, 0.7, 1)


# ---------------------------------------------------------------------------
# eval metrics (the stamp that ranks checkpoints)
# ---------------------------------------------------------------------------


def _sprites(seed, n, size=40):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        img = np.ones((size, size, 3), np.float32)
        y, x = rng.randint(2, size // 2, 2)
        h, w = rng.randint(6, size // 2, 2)
        img[y:y + h, x:x + w] = rng.uniform(-1, 1, 3)
        out.append(np.clip(img + rng.normal(0, 0.05, img.shape), -1, 1).astype(np.float32))
    return out


@pytest.mark.parametrize("background", [None, (0.9, 0.9, 0.9)])
def test_conditioning_report_matches_jax(background):
    real = _sprites(0, 5)
    gen = [np.clip(r + np.random.RandomState(i).normal(0, 0.2, r.shape), -1, 1)
           for i, r in enumerate(real)]
    names = [f"s{i}" for i in range(5)]
    got = tmetrics.conditioning_report(gen, real, names=names, background=background)
    ref = jmetrics.conditioning_report(gen, real, names=names, background=background)
    assert got == ref
    assert 0.0 <= got["retrieval_at_1"] <= 1.0 and got["n"] == 5
    np.testing.assert_array_equal(
        tmetrics.pairwise_conditioning_scores(gen, real[:3], background),
        jmetrics.pairwise_conditioning_scores(gen, real[:3], background))
    blank = np.ones((40, 40, 3), np.float32)
    for a, b in ((gen[0], real[0]), (blank, blank), (blank, real[1])):
        assert tmetrics.silhouette_iou(a, b) == jmetrics.silhouette_iou(a, b)
        assert (tmetrics.color_histogram_similarity(a, b, bins=4)
                == jmetrics.color_histogram_similarity(a, b, bins=4))
        assert tmetrics.downsampled_l1(a, b, 16) == jmetrics.downsampled_l1(a, b, 16)
