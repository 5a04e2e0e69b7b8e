"""The SDXL layout of psg_tpu_torch.models.sd_unet on the CPU, against the
benchmark's plain SDXL reference (``benchmark/reference/sdxl_unet.py``).

A tiny SDXL-shaped spec (3 levels, no attention at level 0, transformer
depths 1/2/3, head width 8, linear projections, the ``text_time`` added
embedding at small widths) on the 27/14/7 ladder; both sides get the same
seeded random leaves (the benchmark's ``weights.fill``).  Bounds, as
``test_torch_sd_unet.py`` holds SD-1.5 to the JAX package: the fp32
forward within 1e-5 * max|out| + 1e-6, each parameter leaf's gradient
within 1e-4 * max|g| + 1e-7.  Also: the published configurations' specs,
SDXL's parameter count on the meta device, the converter on SDXL's
diffusers naming, the training masks and the spans.  No JAX is imported
here."""

import json
from pathlib import Path

import pytest
import torch

from benchmark.harness import weights
from benchmark.reference import sdxl_unet as ref
from psg_tpu_torch.core import tree
from psg_tpu_torch.models import sd_unet as psd
from psg_tpu_torch.models.convert import convert_sd_unet
from psg_tpu_torch.utils.profiling import profile_spans

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TINY = {"in_channels": 4, "out_channels": 4, "block_out_channels": [16, 24, 32],
        "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
        "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
        "layers_per_block": 2, "attention_head_dim": [2, 3, 4], "num_attention_heads": None,
        "transformer_layers_per_block": [1, 2, 3], "cross_attention_dim": 20,
        "norm_num_groups": 8, "use_linear_projection": True,
        "addition_embed_type": "text_time", "addition_time_embed_dim": 8,
        "projection_class_embeddings_input_dim": 12 + 6 * 8}
TEXT_DIM = 12
PSPEC = psd.SDUNetSpec.from_diffusers(TINY)
RSPEC = ref.xl_spec(TINY)


def _section(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())[
        "config"]["sd_unet"]


@pytest.fixture(scope="module")
def params():
    template = ref.xl_wrapper_init(weights.MetaGenerator(), RSPEC, TEXT_DIM, latent_dim=8)
    return weights.fill(template, 2 ** 33 + 5, "cpu")


def _inputs(batch=2):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(batch, 27, 27, 8, generator=g)
    t = torch.tensor([3, 700][:batch])
    txt = torch.randn(batch, 6, TEXT_DIM, generator=g)
    mask = torch.tensor([[1] * 6, [1] * 3 + [0] * 3][:batch])
    bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)
    ids = torch.tensor([[215.0, 215.0, 0.0, 0.0, 215.0, 215.0]]).expand(batch, 6)
    return x, t, txt, mask, bias, ids


def _port(p, x, t, txt, mask, bias, ids, **kw):
    return psd.sd_wrapper_apply(p, x, t, txt, PSPEC, text_bias=bias, text_mask=mask,
                                time_ids=ids, **kw)


def _ref(p, x, t, txt, mask, bias, ids):
    return ref.xl_wrapper_apply(p, x, t, txt, RSPEC, text_mask=mask, time_ids=ids,
                                text_bias=bias)


def test_port_tree_is_the_references():
    mine = psd.sd_wrapper_init(weights.MetaGenerator(), PSPEC, TEXT_DIM, latent_dim=8)
    theirs = ref.xl_wrapper_init(weights.MetaGenerator(), RSPEC, TEXT_DIM, latent_dim=8)
    assert [(p, tuple(x.shape)) for p, x in tree.items(mine)] == \
        [(p, tuple(x.shape)) for p, x in tree.items(theirs)]
    unet = mine["unet"]
    assert unet["down_blocks"][0]["attentions"] is None
    assert unet["up_blocks"][2]["attentions"] is None
    assert len(unet["down_blocks"][2]["attentions"][0]["transformer_blocks"]) == 3
    assert len(unet["up_blocks"][0]["attentions"][0]["transformer_blocks"]) == 3
    assert len(unet["mid_block"]["attentions"][0]["transformer_blocks"]) == 3
    assert tuple(unet["down_blocks"][1]["attentions"][0]["proj_in"]["w"].shape) == (24, 24)


def test_forward_matches_reference(params):
    inputs = _inputs()
    out = _port(params, *inputs)
    want = _ref(params, *inputs)
    assert out.shape == (2, 27, 27, 8)
    scale = float(want.abs().max())
    assert scale > 0
    assert float((out - want).abs().max()) <= 1e-5 * scale + 1e-6


def test_gradients_match_reference(params):
    inputs = _inputs(batch=1)
    w = torch.randn(1, 27, 27, 8, generator=torch.Generator().manual_seed(1))

    def grads(apply):
        p = tree.map(lambda a: a.clone().requires_grad_(True), params)
        leaves = tree.leaves(p)
        return torch.autograd.grad((apply(p, *inputs) * w).sum(), leaves)

    mine, theirs = grads(_port), grads(_ref)
    paths = [p for p, _ in tree.items(params)]
    assert len(paths) == len(mine)
    for path, g, r in zip(paths, mine, theirs):
        bound = 1e-4 * float(r.abs().max()) + 1e-7
        assert float((g - r).abs().max()) <= bound, path


def test_time_ids_and_pooled_text_reach_the_output(params):
    """Another size in the time ids, or another mask over the same states,
    changes the prediction: both go through the added embedding."""
    x, t, txt, mask, bias, ids = _inputs()
    base = _port(params, x, t, txt, mask, bias, ids)
    assert not torch.allclose(base, _port(params, x, t, txt, mask, bias, ids * 0.5))
    other = torch.ones_like(mask)
    assert not torch.allclose(base, _port(params, x, t, txt, other, bias, ids))
    with pytest.raises(ValueError, match="time_ids"):
        psd.sd_unet_apply(params["unet"], x, t, torch.zeros(2, 6, 20), PSPEC)


def test_published_specs():
    sd15 = psd.SDUNetSpec.from_diffusers(_section("sd15"))
    assert sd15 == psd.SDUNetSpec.sd15()
    # an SD-1.5 spec iterates as its seven fields, as older readers build it
    assert tuple(sd15) == (4, 4, (320, 640, 1280, 1280), 2, 8, 768, 32)
    xl = psd.SDUNetSpec.from_diffusers(_section("sdxl"))
    assert xl == psd.SDUNetSpec.sdxl()
    assert [xl.heads(i) for i in range(3)] == [5, 10, 20]
    assert all(1280 // xl.heads(2) == c // xl.heads(i) == 64
               for i, c in enumerate(xl.channels) if xl.has_attention(i))
    assert ref.xl_spec(_section("sdxl")).heads_by_level == (5, 10, 20)


def test_sdxl_parameter_count():
    spec = psd.SDUNetSpec.sdxl()
    p = psd.sd_unet_init(weights.MetaGenerator(), spec)
    assert sum(x.numel() for x in tree.leaves(p)) == 2_567_463_684
    blocks = sum(len(a["transformer_blocks"]) for part in ("down_blocks", "up_blocks")
                 for blk in p[part] for a in blk["attentions"] or ())
    blocks += len(p["mid_block"]["attentions"][0]["transformer_blocks"])
    assert blocks == 70
    sd15 = psd.sd_unet_init(weights.MetaGenerator(), psd.SDUNetSpec.sd15())
    assert sum(x.numel() for x in tree.leaves(sd15)) == 859_520_964


def test_training_masks_reach_nested_blocks():
    p = psd.sd_wrapper_init(weights.MetaGenerator(), PSPEC, TEXT_DIM, latent_dim=8)
    full = dict(tree.items(psd.sd_training_mask(p, "full")))
    assert all(full.values()) and len(full) == len(list(tree.items(p)))
    cross = dict(tree.items(psd.sd_training_mask(p, "cross_attention_only")))
    on = {k for k, v in cross.items() if v}
    attn2 = {k for k in cross if ".attn2." in k or ".norm2." in k and "transformer_blocks" in k}
    assert attn2 and attn2 <= on
    assert all(k.startswith(("unet.conv_in", "unet.conv_out", "text_projection",
                             "text_layer_norm", "pooled_projection")) or k in attn2
               for k in on)


def _diffusers_state_dict(p):
    """A tree in diffusers' published naming and layouts: Linear weights
    ``[out, in]``, conv weights OIHW, norms' ``weight``/``bias``."""
    sd = {}

    def conv(key, q):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = q["w"], q["b"]

    def lin(key, q):
        sd[f"{key}.weight"] = q["w"].t()
        if "b" in q:
            sd[f"{key}.bias"] = q["b"]

    def norm(key, q):
        sd[f"{key}.weight"], sd[f"{key}.bias"] = q["scale"], q["bias"]

    def resnet(key, q):
        norm(f"{key}.norm1", q["norm1"])
        conv(f"{key}.conv1", q["conv1"])
        lin(f"{key}.time_emb_proj", q["time_emb_proj"])
        norm(f"{key}.norm2", q["norm2"])
        conv(f"{key}.conv2", q["conv2"])
        if "conv_shortcut" in q:
            conv(f"{key}.conv_shortcut", q["conv_shortcut"])

    def transformer(key, q):
        norm(f"{key}.norm", q["norm"])
        lin(f"{key}.proj_in", q["proj_in"])
        lin(f"{key}.proj_out", q["proj_out"])
        for i, b in enumerate(q["transformer_blocks"]):
            bk = f"{key}.transformer_blocks.{i}"
            for n in ("norm1", "norm2", "norm3"):
                norm(f"{bk}.{n}", b[n])
            for a in ("attn1", "attn2"):
                for w in ("to_q", "to_k", "to_v"):
                    lin(f"{bk}.{a}.{w}", b[a][w])
                lin(f"{bk}.{a}.to_out.0", b[a]["to_out"])
            lin(f"{bk}.ff.net.0.proj", b["ff_proj"])
            lin(f"{bk}.ff.net.2", b["ff_out"])

    conv("conv_in", p["conv_in"])
    conv("conv_out", p["conv_out"])
    norm("conv_norm_out", p["conv_norm_out"])
    for e in ("time_embedding", "add_embedding"):
        for n in ("linear_1", "linear_2"):
            lin(f"{e}.{n}", p[e][n])
    for part, sampler in (("down_blocks", "downsamplers"), ("up_blocks", "upsamplers")):
        for lvl, blk in enumerate(p[part]):
            for j, r in enumerate(blk["resnets"]):
                resnet(f"{part}.{lvl}.resnets.{j}", r)
            for j, a in enumerate(blk["attentions"] or ()):
                transformer(f"{part}.{lvl}.attentions.{j}", a)
            key = sampler[:-1]
            if key in blk:
                conv(f"{part}.{lvl}.{sampler}.0.conv", blk[key])
    for j, r in enumerate(p["mid_block"]["resnets"]):
        resnet(f"mid_block.resnets.{j}", r)
    transformer("mid_block.attentions.0", p["mid_block"]["attentions"][0])
    return sd


def test_convert_takes_sdxl_naming():
    p = psd.sd_unet_init(torch.Generator().manual_seed(3), PSPEC)
    sd = _diffusers_state_dict(p)
    assert "down_blocks.2.attentions.1.transformer_blocks.2.attn2.to_k.weight" in sd
    assert "add_embedding.linear_1.weight" in sd
    got = convert_sd_unet(sd, spec=PSPEC)
    want = dict(tree.items(p))
    have = dict(tree.items(got))
    assert set(have) == set(want)
    for path, leaf in want.items():
        assert torch.equal(have[path], leaf), path
    del sd["add_embedding.linear_2.bias"]
    with pytest.raises(KeyError):
        convert_sd_unet(sd, spec=PSPEC)


def test_spans_of_an_evaluation(params):
    x, t, txt, mask, bias, ids = _inputs()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _port(params, x, t, txt, mask, bias, ids)
    table = profile_spans(prof)
    assert table["psg.sdunet.eval"]["count"] == 1
    assert {f"psg.sdunet.{k}" for k in ("down0", "down1", "down2", "mid", "up0", "up1",
                                         "up2")} <= set(table)
