"""The port's training CLI end to end on the CPU: ``python -m
psg_tpu_torch.train.cli --stage 2 --device cpu`` trains one epoch of two
steps at the tiny config over a sprite corpus made from a seed, writes its
checkpoints and a sample grid, and ``python -m psg_tpu_torch.serve.app
--device cpu`` serves a sprite from what it wrote.  Both CLIs are driven
in-process, with ``HF_HUB_OFFLINE=1`` and any DNS lookup failing the test."""

import json
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
    (["--stage", "3"], "stage 3"),
    (["--stage", "0"], "stage 0"),
    (["--stage", "all"], "stage all"),
    (["--stage", "2", "--use-diffusers"], "use-diffusers"),
])
def test_unported_stages_raise(argv, match, tmp_path):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv + ["--config", str(tmp_path / "none.yaml"), "--device", "cpu"])


def test_data_stats(tmp_path, capsys):
    csv, images = write_sprite_corpus(tmp_path / "corpus", n=5, seed=2, size=32)
    assert cli.main(["--data-stats", "--config", str(tmp_path / "none.yaml"),
                     f"--override=data.csv_path={csv}", f"--override=data.image_dir={images}",
                     "--override=data.image_size=32"]) == 0
    out = capsys.readouterr().out
    assert "total_samples: 5" in out and "image_size: 32" in out
