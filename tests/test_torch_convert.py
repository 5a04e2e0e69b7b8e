"""psg_tpu_torch.models.convert against psg_tpu.models.convert on the CPU.

Each converter gets a torch-named state dict built in the test from a JAX
parameter tree (random init of the JAX package's tiny configs): a probe
state dict first records which key lands at which leaf and how it is laid
out (copied, transposed, or a conv's OIHW -> HWIO), and the inverse of that
layout on the tree's leaves gives the state dict.  For every converter the
port's output is exactly ``bridge.from_jax`` of the JAX converter's, leaf
for leaf and dtype for dtype, and the JAX converter gives back the tree the
state dict was made from.  A missing key raises ``KeyError``."""

import jax
import numpy as np
import pytest
import torch

from psg_tpu.models import bert as jbert
from psg_tpu.models import clip as jclip
from psg_tpu.models import convert as jconvert
from psg_tpu.models import sd_unet as jsd
from psg_tpu.models import text_encoder as jtext
from psg_tpu.models import unet as junet
from psg_tpu.models import vae as jvae
from psg_tpu.models import vgg as jvgg

from psg_tpu_torch.core import tree
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models import convert as pconvert

_PROBE_SHAPE = (2, 3, 5, 7)
_LAYOUTS = {(2, 3, 5, 7): "copy", (7, 5, 3, 2): "T", (5, 7, 3, 2): "conv", (105, 2): "patch"}


class _Probe(dict):
    """A state dict that hands every key a distinct (2, 3, 5, 7) array and
    says it holds every key, so each optional branch is taken."""

    def __init__(self):
        super().__init__()
        self.keys_seen = []

    def __getitem__(self, key):
        self.keys_seen.append(key)
        return np.full(_PROBE_SHAPE, len(self.keys_seen), np.float32)

    def __contains__(self, key):
        return True


def _state_dict(jax_converter, tree_, **kw):
    """The torch-named state dict from which ``jax_converter`` makes
    ``tree_``."""
    probe = _Probe()
    out = jax_converter(probe, **kw)
    placed = {}
    for path, leaf in tree.items(_jax_layout_items(out)):
        key = probe.keys_seen[int(leaf.flatten()[0]) - 1]
        placed[path] = (key, _LAYOUTS[tuple(leaf.shape)])
    sd = {}
    for path, leaf in tree.items(_jax_layout_items(tree_)):
        key, layout = placed[path]
        a = np.asarray(leaf)
        if layout == "T":
            a = a.T
        elif layout == "conv":
            a = a.transpose(3, 2, 0, 1)
        elif layout == "patch":     # [P*P*3, W] -> [W, 3, P, P]
            p = int(round((a.shape[0] // 3) ** 0.5))
            a = a.reshape(p, p, 3, a.shape[1]).transpose(3, 2, 0, 1)
        sd[key] = np.ascontiguousarray(a)
    return sd


def _jax_layout_items(tree_):
    """The JAX tree with lists as lists, leaves as numpy, no layout change."""
    if isinstance(tree_, dict):
        return {k: _jax_layout_items(v) for k, v in tree_.items()}
    if isinstance(tree_, (list, tuple)):
        return [_jax_layout_items(v) for v in tree_]
    return None if tree_ is None else np.asarray(tree_)


def _bert_cfg():
    return jbert.BertConfig.tiny_test(vocab_size=40)


def _cases():
    key = jax.random.PRNGKey(0)
    bc = _bert_cfg()
    text = jtext.text_encoder_init(key, bc, 24)
    return {
        "bert": (lambda: jbert.bert_init(key, bc), jconvert.convert_bert,
                 pconvert.convert_bert, {"num_layers": bc.num_layers}),
        "text_encoder": (lambda: text, jconvert.convert_reference_text_encoder,
                         pconvert.convert_reference_text_encoder,
                         {"num_layers": bc.num_layers, "hidden": bc.hidden_size, "text_dim": 24}),
        "vgg16": (lambda: jvgg.vgg16_init(key), jconvert.convert_vgg16,
                  pconvert.convert_vgg16, {}),
        "vae": (lambda: jvae.vae_init(key, 8, 24, width_scale=0.25),
                jconvert.convert_reference_vae, pconvert.convert_reference_vae, {}),
        "unet": (lambda: junet.unet_init(key, junet.UNetSpec(
                     text_dim=24, time_emb_dim=32, channels=(16, 24, 32, 32))),
                 jconvert.convert_reference_unet, pconvert.convert_reference_unet, {}),
        "clip": (lambda: jclip.clip_init(key, jclip.ClipConfig.tiny_test()),
                 jconvert.convert_clip, pconvert.convert_clip,
                 {"vision_layers": jclip.ClipConfig.tiny_test().vision_layers,
                  "text_layers": jclip.ClipConfig.tiny_test().text_layers}),
        "sd_unet": (lambda: jsd.sd_unet_init(key, jsd.SDUNetSpec.tiny_test(20)),
                    jconvert.convert_sd_unet, pconvert.convert_sd_unet, {}),
    }


CASES = _cases()


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    init, jfn, pfn, kw = CASES[request.param]
    params = init()
    return request.param, params, _state_dict(jfn, params, **kw), jfn, pfn, kw


def test_port_converter_equals_from_jax_of_jax_converter(case):
    name, params, sd, jfn, pfn, kw = case
    ref_jax = jfn(sd, **kw)
    # the state dict is right: JAX's converter gives back the tree it came from
    jax.tree_util.tree_map(np.testing.assert_array_equal, params, ref_jax)
    ref = dict(tree.items(bridge.from_jax(jax.tree_util.tree_map(np.asarray, ref_jax))))
    got = pfn(sd, **kw)
    assert sorted(p for p, _ in tree.items(got)) == sorted(ref), name
    for path, g in tree.items(got):
        assert g.dtype == ref[path].dtype and torch.equal(g, ref[path]), (name, path)


def test_port_converter_takes_torch_tensors(case):
    name, _, sd, jfn, pfn, kw = case
    from_np = pfn(sd, **kw)
    from_torch = pfn({k: torch.from_numpy(v) for k, v in sd.items()}, **kw)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(from_np),
                                                 tree.leaves(from_torch))), name


def test_missing_key_raises(case):
    name, _, sd, _, pfn, kw = case
    victim = sorted(sd)[len(sd) // 2]
    with pytest.raises(KeyError, match=victim.replace(".", r"\.")):
        pfn({k: v for k, v in sd.items() if k != victim}, **kw)


def test_load_torch_state_dict(tmp_path):
    """Tensors come back as saved; a ``state_dict`` entry is unwrapped."""
    sd = {"a.weight": torch.randn(3, 2), "a.bias": torch.randn(3)}
    for obj in (sd, {"state_dict": sd, "epoch": 3}):
        torch.save(obj, tmp_path / "w.pth")
        got = pconvert.load_torch_state_dict(tmp_path / "w.pth")
        assert set(got) == set(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
