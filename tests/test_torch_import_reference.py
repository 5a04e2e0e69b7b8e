"""scripts/torch_import_reference_checkpoint.py on the CPU: the reference's
three container layouts, built in the test with the reference's key names
from the JAX package's tiny random-init trees (through
test_torch_convert's `_state_dict`), are imported by the port's
script; both packages' hubs resolve what it wrote and both packages'
``load_serving_params`` read it back equal to the trees the containers were
made from."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from psg_tpu.core.checkpoint import load_serving_params as jax_load_serving_params
from psg_tpu.core.config import Config as JaxConfig
from psg_tpu.models import bert as jbert
from psg_tpu.models import convert as jconvert
from psg_tpu.models import text_encoder as jtext
from psg_tpu.models import unet as junet
from psg_tpu.models import vae as jvae
from psg_tpu.serve import hub as jax_hub

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import load_serving_params
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.models import bridge
from psg_tpu_torch.serve import hub
from test_torch_convert import _state_dict

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = ROOT / "scripts" / "torch_import_reference_checkpoint.py"


@pytest.fixture(scope="module")
def trees():
    key = jax.random.PRNGKey(5)
    bc = jbert.BertConfig.tiny_test(vocab_size=40)
    out = {"vae": jvae.vae_init(key, 8, 48, width_scale=0.25),
           "text": jtext.text_encoder_init(key, bc, 48),
           "unet": junet.unet_init(key, junet.UNetSpec(text_dim=48, time_emb_dim=32,
                                                       channels=(16, 24, 32, 32)))}
    sds = {"vae": _state_dict(jconvert.convert_reference_vae, out["vae"]),
           "text": _state_dict(jconvert.convert_reference_text_encoder, out["text"],
                               num_layers=bc.num_layers, hidden=bc.hidden_size, text_dim=48),
           "unet": _state_dict(jconvert.convert_reference_unet, out["unet"])}
    sds = {k: {n: torch.from_numpy(v) for n, v in sd.items()} for k, sd in sds.items()}
    return jax.tree_util.tree_map(np.asarray, out), sds


def _run(argv):
    out = subprocess.run([sys.executable, str(SCRIPT), *argv], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_layout(jax_tree):
    return dict(tree.items(bridge.from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))))


def _assert_equal(got, ref):
    """``got`` (port layout) leaf for leaf equal to the JAX tree ``ref``."""
    ref, got = _port_layout(ref), dict(tree.items(got))
    assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)


@pytest.mark.parametrize("layout", ["pair", "final"])
def test_import_then_serve_from_both_packages(tmp_path, trees, layout):
    params, sds = trees
    exp = tmp_path / "exp"
    if layout == "pair":
        torch.save({"vae_state_dict": sds["vae"], "text_encoder_state_dict": sds["text"],
                    "epoch": 3}, tmp_path / "vae_best_model.pth")
        torch.save({"unet_state_dict": sds["unet"]}, tmp_path / "diffusion_best_model.pth")
        argv = ["--vae", str(tmp_path / "vae_best_model.pth"),
                "--diffusion", str(tmp_path / "diffusion_best_model.pth")]
    else:
        # vae_encoder.* / vae_decoder.* (the state dict's encoder.* / decoder.*)
        bundle = {**{f"vae_{k}": v for k, v in sds["vae"].items()},
                  **{f"text_encoder.{k}": v for k, v in sds["text"].items()},
                  **{f"unet.{k}": v for k, v in sds["unet"].items()}}
        torch.save({"model_state_dict": bundle}, tmp_path / "final_best_model.pth")
        argv = ["--final", str(tmp_path / "final_best_model.pth")]
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\na\n")
    printed = _run(argv + ["--experiment-name", "imp", "--experiment-dir", str(exp),
                           "--schedule", "linear", "--vocab", str(tmp_path / "vocab.txt")])
    assert printed["experiment_name"] == "imp" and (exp / "vocab.txt").exists()

    cfg, jcfg = Config(), JaxConfig()
    cfg.experiment_dir = jcfg.experiment_dir = str(exp)
    cfg.extra = {"serve_prefer_final": True}
    jcfg.extra = {"serve_prefer_final": True}
    paths = hub.resolve_checkpoints(cfg, "imp", allow_hub=False)
    assert paths == jax_hub.resolve_checkpoints(jcfg, "imp", allow_hub=False)
    stage = "diffusion" if layout == "pair" else "final"
    assert paths[1].endswith(f"imp_{stage}/checkpoints/{stage}_best_model.ckpt")
    meta = json.loads(Path(paths[1]).with_suffix(".json").read_text())
    assert meta["config"]["model"]["beta_schedule"] == "linear" and meta["stage"] == stage

    want = "pair" if layout == "pair" else "final-bundle"
    got, loaded = load_serving_params(*paths, bridge.from_jax(params))
    assert loaded == want
    _assert_equal(got, params)
    jgot, jloaded = jax_load_serving_params(*paths, params)
    assert jloaded == want
    _assert_equal(_port_layout(jgot), params)


def test_no_container_is_an_error():
    out = subprocess.run([sys.executable, str(SCRIPT)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 2 and "need at least one" in out.stderr
