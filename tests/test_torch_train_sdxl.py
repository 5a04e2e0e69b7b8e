"""``--use-diffusers`` stage 2 on an SDXL-shaped UNet (``train/stage2_sd.py``)
against the benchmark's plain SDXL step (``benchmark/reference/train_sdxl.py``)
on the CPU.

A configuration carrying a tiny SDXL-shaped ``sd_unet`` section (the one
``test_torch_sdxl_unet.py`` uses, at cross-attention width 32) builds the
trainer through the normal path; both sides get the same seeded random
leaves and the same loader batch, and draw from generators seeded alike.
One step in ``full`` mode, float32: the loss within rel 1e-6, each trained
leaf's first-gradient norm within the harness's leaf gap
(``benchmark/runners/training.py``) of 1e-4 and its change after the step
within 5e-4 (Adam's first step moves an element whose gradient is near
rounding by up to lr either way; this configuration reads 2e-6 and 6e-5);
the reference computes its gradients a row at a time.  A configuration without
the section still builds SD-1.5's tiny spec; a diffusers state dict in
SDXL's naming, as a ``.safetensors`` file named by ``$PSG_TPU_SD_UNET``,
is the trainer's UNet."""

import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import precision
from benchmark.reference import train_sdxl as ref_xl
from benchmark.reference import tree as rtree
from benchmark.runners.training import leaf_gap, small_leaves
from psg_tpu_torch.core import tree
from psg_tpu_torch.core.config import Config, config_from_dict
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.models.sd_unet import (
    SDUNetSpec,
    adapt_in_channels,
    adapt_out_channels,
    sd_unet_init,
)
from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer, sd_spec_from_config
from test_torch_sdxl_unet import TINY, _diffusers_state_dict

torch.set_num_threads(1)

SECTION = dict(TINY, cross_attention_dim=32)


def _raw(exp, corpus, section=True):
    cfg = Config()
    m = cfg.model
    m.bert_model = "tiny-test"
    m.vae_width_scale = 0.25
    m.text_embedding_dim = 48
    m.cross_attention_dim = 32
    m.num_timesteps = 50
    m.compute_dtype = "float32"
    m.freeze_encoder = m.freeze_decoder = False
    d = cfg.data
    d.csv_path, d.image_dir = str(corpus[0]), str(corpus[1])
    d.image_size, d.batch_size, d.text_len, d.num_workers = 64, 2, 32, 2
    cfg.training.diffusion_epochs = 1
    raw = cfg.to_dict()
    raw.pop("extra")
    raw["experiment_dir"] = str(exp)
    if section:
        raw["sd_unet"] = SECTION
    return raw


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_sprite_corpus(tmp_path_factory.mktemp("corpus"), n=12, seed=0, size=64)


def test_config_without_section_builds_sd15(tmp_path, corpus):
    cfg = config_from_dict(_raw(tmp_path, corpus, section=False))
    assert sd_spec_from_config(cfg) == SDUNetSpec.tiny_test(text_dim=32)
    cfg.model.bert_model = "google-bert/bert-base-uncased"
    assert sd_spec_from_config(cfg) == SDUNetSpec.sd15()._replace(cross_attention_dim=32)


def test_one_full_step_matches_reference(tmp_path, corpus):
    raw = _raw(tmp_path, corpus)
    tr = SDDiffusionTrainer(config_from_dict(raw), None, experiment_name="x", device="cpu")
    assert tr.spec == SDUNetSpec.from_diffusers(SECTION) and tr.train_mode == "full"
    vocab = tr.stage_dir / "vocab.txt"
    template = ref_xl.template(raw, tr.tokenizer.vocab_size, weights.MetaGenerator())
    mine = dict(rtree.items(weights.fill(template, 2 ** 32 + 9, "cpu")))
    with torch.no_grad():
        for prefix, part in (("", tr.state.params), ("vae.", tr.frozen_vae)):
            for path, leaf in tree.items(part):
                leaf.copy_(mine[prefix + path])
    params = dict(tree.items(tr.state.params))
    trained = {p: params[p] for g in tr.state.opt_state["groups"].values() for p in g["mu"]}
    assert {p for p in trained if p.startswith("sd.")} == {p for p in params
                                                           if p.startswith("sd.")}
    before = {p: t.detach().clone() for p, t in trained.items()}

    tr.train_loader.set_epoch(0)
    batch = next(iter(tr.train_loader))
    loss = float(tr._step(tr._batch(batch))["loss"])
    b2 = tr.tx.b2
    grads = {p: float((nu.sum() / (1.0 - b2)).sqrt())
             for g in tr.state.opt_state["groups"].values() for p, nu in g["nu"].items()}
    changes = {p: float((t.detach() - before[p]).norm()) for p, t in trained.items()}

    leaves = weights.separate(weights.fill(template, 2 ** 32 + 9, "cpu"))
    with precision.float32():
        job = ref_xl.Job(raw, leaves, vocab, "cpu",
                         steps_per_epoch=len(tr.train_loader), micro_batch=1)
        ref_before = {p: job.leaves[p].detach().clone() for g in job.paths.values()
                      for p in g}
        gen = torch.Generator().manual_seed(int(raw["seed"]))
        ref_loss, ref_grads = job.step(
            {"image": torch.as_tensor(batch["image"]),
             "desc_ids": torch.as_tensor(batch["desc_ids"]).long(),
             "desc_mask": torch.as_tensor(batch["desc_mask"]).long()}, gen)
    ref_changes = {p: float((job.leaves[p].detach() - ref_before[p]).norm())
                   for p in ref_before}

    assert set(grads) == set(ref_grads) == set(changes) == set(ref_changes)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss)
    assert leaf_gap(grads, ref_grads) <= 1e-4
    small = small_leaves(ref_grads)
    assert leaf_gap({k: v for k, v in changes.items() if k not in small},
                    {k: v for k, v in ref_changes.items() if k not in small}) <= 5e-4


def test_sdxl_checkpoint_loads_from_env(tmp_path, corpus, monkeypatch):
    from safetensors.torch import save_file

    spec = SDUNetSpec.from_diffusers(SECTION)
    unet = sd_unet_init(torch.Generator().manual_seed(5), spec)
    path = tmp_path / "diffusion_pytorch_model.safetensors"
    save_file({k: v.contiguous() for k, v in _diffusers_state_dict(unet).items()},
              str(path))
    monkeypatch.setenv("PSG_TPU_SD_UNET", str(path))
    tr = SDDiffusionTrainer(config_from_dict(_raw(tmp_path / "exp", corpus)), None,
                            experiment_name="x", device="cpu")
    want = dict(tree.items(adapt_out_channels(adapt_in_channels(unet, 8), 8)))
    got = dict(tree.items(tr.state.params["sd"]["unet"]))
    assert set(got) == set(want)
    assert all(torch.equal(got[p].detach(), want[p]) for p in want)
