"""The port's training CLI end to end on the CPU at the tiny config over a
sprite corpus made from a seed: ``--stage 2`` trains one epoch of two steps,
writes its checkpoints and a sample grid, and ``python -m
psg_tpu_torch.serve.app --device cpu`` serves a sprite from what it wrote;
``--stage 3`` alone, ``--stage all`` (1 -> 2 -> 3, then served as a final
bundle) on the classic path and on the device-resident fast path, and
``--stage 0`` followed by a warm-started ``--stage 1``.  Both CLIs are driven
in-process, with ``HF_HUB_OFFLINE=1`` and any DNS lookup failing the test."""

import json
import logging
import socket

import pytest

from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.serve import app
from psg_tpu_torch.train import cli


def _model_overrides(tmp, corpus):
    csv, images = corpus
    return [f"experiment_dir={tmp / 'exp'}", "model.bert_model=tiny-test",
            "model.vae_width_scale=0.25", "model.text_embedding_dim=48",
            "model.unet_channels=[16,24,32,32]", "model.time_emb_dim=32",
            "data.image_size=64", "data.text_len=32", f"data.csv_path={csv}",
            f"data.image_dir={images}"]


@pytest.fixture
def offline(monkeypatch):
    def no_lookup(*a, **k):
        raise AssertionError("DNS lookup attempted")

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setattr(socket, "getaddrinfo", no_lookup)
    for var in ("PSG_TPU_BERT", "PSG_TPU_BERT_VOCAB"):
        monkeypatch.delenv(var, raising=False)


def test_train_stage2_then_serve(tmp_path, offline, capsys):
    # 7 sprites: 6 train (2 steps at batch 3), 1 val
    corpus = write_sprite_corpus(tmp_path / "corpus", n=7, seed=1, size=64)
    model = _model_overrides(tmp_path, corpus)
    train = ["--stage", "2", "--device", "cpu", "--config", str(tmp_path / "none.yaml"),
             "--experiment-name", "cli"]
    assert cli.main(train + [f"--override={o}" for o in model + [
        "data.batch_size=3", "data.num_workers=2", "training.diffusion_epochs=1",
        "training.sample_every=1", "extra.sample_steps=2", "optimization.ema_decay=0.9"]]) == 0
    stage = tmp_path / "exp" / "cli_diffusion"
    best = stage / "checkpoints" / "diffusion_best_model.ckpt"
    assert best.exists() and (stage / "checkpoints" / "diffusion_step_00000002.ckpt").exists()
    meta = json.loads(best.with_suffix(".json").read_text())
    assert meta["step"] == 2 and meta["stage"] == "diffusion" and meta["epoch"] == 0
    assert (stage / "samples" / "epoch_0000.png").exists()
    assert (stage / "logs" / "metrics.jsonl").read_text().count("diffusion_val/loss") == 1
    assert "stage 2 complete" in capsys.readouterr().out

    out = tmp_path / "sprite.png"
    assert app.main(["--device", "cpu", "--config", str(tmp_path / "none.yaml"),
                     "--experiment-name", "cli", "--prompt", "a red fire creature",
                     "--steps", "2", "--out", str(out)]
                    + [f"--override={o}" for o in model]) == 0
    printed = capsys.readouterr().out
    assert "loaded=unet-only" in printed and f"diffusion={best}" in printed
    assert out.exists()


@pytest.mark.parametrize("argv,match", [
    (["--stage", "2", "--use-diffusers"], "use-diffusers"),
    (["--stage", "all", "--use-diffusers"], "use-diffusers"),
])
def test_unported_stages_raise(argv, match, tmp_path, offline, capsys, caplog):
    """``--use-diffusers`` is ported: stage 2 runs the SD trainer (its log
    names the flag) and writes its best under ``{name}_diffusers``.  Under
    ``all`` stage 1 runs first and the SD stage reads its best; stage 3
    then gets the SD best, as the JAX CLI hands it on, and raises as the
    JAX package does: the SD checkpoint does not fit the stage-3 UNet."""
    corpus = write_sprite_corpus(tmp_path / "corpus", n=7, seed=1, size=64)
    args = argv + _train_args(tmp_path, corpus, "model.num_timesteps=50")
    with caplog.at_level(logging.INFO):
        if argv[1] == "all":
            with pytest.raises(ValueError, match="expected keys"):
                cli.main(args)
        else:
            assert cli.main(args) == 0
    assert match in caplog.text
    exp = tmp_path / "exp"
    best = exp / "cli_diffusers" / "checkpoints" / "diffusers_best_model.ckpt"
    meta = json.loads(best.with_suffix(".json").read_text())
    assert (meta["stage"], meta["step"], meta["epoch"]) == ("diffusers", 2, 0)
    out = capsys.readouterr().out
    assert "stage 2 complete" in out and "stage 3 complete" not in out
    if argv[1] == "all":
        vae = exp / "cli_vae" / "checkpoints" / "vae_best_model.ckpt"
        assert meta["vae_checkpoint"] == str(vae) and f"loaded VAE+text from {vae}" in caplog.text


def _train_args(tmp_path, corpus, *extra):
    return (["--device", "cpu", "--config", str(tmp_path / "none.yaml"),
             "--experiment-name", "cli"]
            + [f"--override={o}" for o in _model_overrides(tmp_path, corpus) + [
                "data.batch_size=3", "data.num_workers=2", "training.vae_epochs=1",
                "training.diffusion_epochs=1", "training.final_epochs=2",
                "training.phase1_epochs=1", "training.sample_every=2",
                "extra.sample_steps=2", *extra]])


def test_train_stage3_alone(tmp_path, offline, capsys, caplog):
    """``--stage 3`` with no stage-1 or stage-2 checkpoint in the experiment
    draws the VAE, text encoder and UNet from the seed (and says so), trains
    one text-encoder epoch and one joint epoch, and writes its best (a joint
    one) and the sample grid."""
    corpus = write_sprite_corpus(tmp_path / "corpus", n=7, seed=1, size=64)
    with caplog.at_level(logging.INFO):
        assert cli.main(["--stage", "3"] + _train_args(tmp_path, corpus)) == 0
    assert "VAE and text drawn from seed" in caplog.text
    assert "switching to joint training" in caplog.text
    stage = tmp_path / "exp" / "cli_final"
    meta = json.loads((stage / "checkpoints" / "final_best_model.json").read_text())
    assert (meta["stage"], meta["step"], meta["training_phase"]) == ("final", 4, "joint")
    assert (stage / "samples" / "final_epoch_0001.png").exists()
    assert "stage 3 complete" in capsys.readouterr().out


def test_train_all_then_serve_the_final_bundle(tmp_path, offline, capsys, caplog):
    """``--stage all`` runs 1 -> 2 -> 3, each stage loading the one before
    it; the hub resolves the stage-3 best as a final bundle (with
    ``extra.serve_prefer_final``) and the serving CLI serves it."""
    corpus = write_sprite_corpus(tmp_path / "corpus", n=7, seed=1, size=64)
    with caplog.at_level(logging.INFO):
        assert cli.main(["--stage", "all"] + _train_args(tmp_path, corpus)) == 0
    exp = tmp_path / "exp"
    vae = exp / "cli_vae" / "checkpoints" / "vae_best_model.ckpt"
    diff = exp / "cli_diffusion" / "checkpoints" / "diffusion_best_model.ckpt"
    final = exp / "cli_final" / "checkpoints" / "final_best_model.ckpt"
    assert f"loaded frozen VAE/text from {vae}" in caplog.text
    assert f"loaded VAE+text from {vae}" in caplog.text
    assert f"loaded UNet from {diff}" in caplog.text
    out = capsys.readouterr().out
    assert all(f"stage {i} complete" in out for i in (1, 2, 3))

    sprite = tmp_path / "sprite.png"
    assert app.main(["--device", "cpu", "--config", str(tmp_path / "none.yaml"),
                     "--experiment-name", "cli", "--prompt", "a red fire creature",
                     "--steps", "2", "--out", str(sprite)]
                    + [f"--override={o}" for o in _model_overrides(tmp_path, corpus)
                       + ["extra.serve_prefer_final=true"]]) == 0
    printed = capsys.readouterr().out
    assert "loaded=final-bundle" in printed and f"vae={final}" in printed
    assert sprite.exists()


def test_train_all_fast_path_then_serve_the_final_bundle(tmp_path, offline, capsys, caplog):
    """``--stage all`` with ``training.fast_path=true`` (caption variants,
    EMA, a bf16 first moment and warmup-cosine, as config/r3_evidence.yaml
    sets them): each stage takes the fast path and hands the next its light
    best; the serving CLI serves stage 3's light best as a final bundle."""
    corpus = write_sprite_corpus(tmp_path / "corpus", n=9, seed=1, size=64)
    fast = ["training.fast_path=true", "extra.caption_augment=2", "optimization.ema_decay=0.9",
            "optimization.mu_dtype=bfloat16", "optimization.scheduler=warmup_cosine",
            "optimization.warmup_steps=2", "training.final_epochs=1",
            "training.phase1_epochs=0"]
    with caplog.at_level(logging.INFO):
        assert cli.main(["--stage", "all"] + _train_args(tmp_path, corpus, *fast)) == 0
    exp = tmp_path / "exp"
    best = {s: exp / f"cli_{s}" / "checkpoints" / f"{s}_best_model.ckpt"
            for s in ("vae", "diffusion", "final")}
    assert all(json.loads(b.with_suffix(".json").read_text())["light"] for b in best.values())
    assert all(f"{s} stage (fast path)" in caplog.text for s in best)
    assert f"loaded frozen VAE/text from {best['vae']}" in caplog.text
    assert f"loaded UNet from {best['diffusion']}" in caplog.text
    assert "switching to joint training" in caplog.text
    capsys.readouterr()

    sprite = tmp_path / "sprite.png"
    assert app.main(["--device", "cpu", "--config", str(tmp_path / "none.yaml"),
                     "--experiment-name", "cli", "--prompt", "a red fire creature",
                     "--steps", "2", "--out", str(sprite)]
                    + [f"--override={o}" for o in _model_overrides(tmp_path, corpus)
                       + ["extra.serve_prefer_final=true"]]) == 0
    printed = capsys.readouterr().out
    assert "loaded=final-bundle" in printed and f"vae={best['final']}" in printed
    assert sprite.exists()


def test_stage0_then_stage1_from_its_checkpoint(tmp_path, offline, capsys, caplog):
    """``--stage 0`` writes the MLM best and says how to warm-start stage 1;
    ``--stage 1 --override extra.text_init=...`` then starts its text tower
    from it."""
    corpus = write_sprite_corpus(tmp_path / "corpus", n=7, seed=1, size=64)
    mlm = ["extra.mlm_epochs=1", "extra.mlm_batch=4", "extra.mlm_caption_augment=2"]
    assert cli.main(["--stage", "0"] + _train_args(tmp_path, corpus, *mlm)) == 0
    best = tmp_path / "exp" / "cli_mlm" / "checkpoints" / "mlm_best_model.ckpt"
    out = capsys.readouterr().out
    assert f"stage 0 complete: {best}" in out
    assert f"--override extra.text_init={best}" in out
    with caplog.at_level(logging.INFO):
        assert cli.main(["--stage", "1"] + _train_args(tmp_path, corpus,
                                                       f"extra.text_init={best}")) == 0
    assert f"bert=mlm:{best}" in caplog.text
    assert "stage 1 complete" in capsys.readouterr().out


def test_data_stats(tmp_path, capsys):
    csv, images = write_sprite_corpus(tmp_path / "corpus", n=5, seed=2, size=32)
    assert cli.main(["--data-stats", "--config", str(tmp_path / "none.yaml"),
                     f"--override=data.csv_path={csv}", f"--override=data.image_dir={images}",
                     "--override=data.image_size=32"]) == 0
    out = capsys.readouterr().out
    assert "total_samples: 5" in out and "image_size: 32" in out
