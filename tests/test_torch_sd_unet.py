"""psg_tpu_torch.models.sd_unet against psg_tpu.models.sd_unet on the CPU.

The JAX package's tiny SD spec (channels 16/24/32/32, 2 heads, 8 groups) on
the odd 27/14/7/4 ladder, its random-init parameters carried across by the
bridge (``None`` ``attentions`` included), inputs made with numpy.  Bounds:
the fp32 forward within 1e-5 * max|out| + 1e-6; a bf16 forward within
twice JAX's own bf16-against-fp32 distance; parameter gradients per leaf
within 1e-4 * max|g| + 1e-7; channel adaptations, training masks and
the nearest resizes equal; the timestep embedding within two fp32
steps of its largest argument."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.models import sd_unet as jsd

from psg_tpu_torch.core import tree
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models import sd_unet as psd

JSPEC = jsd.SDUNetSpec.tiny_test(text_dim=20)
PSPEC = psd.SDUNetSpec.tiny_test(text_dim=20)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@pytest.fixture(scope="module", params=[20, 12], ids=["no_projection", "projection"])
def wrapper(request):
    """(JAX params, port params, text width) of the 8-channel wrapper."""
    tdim = request.param
    jp = jsd.sd_wrapper_init(jax.random.PRNGKey(tdim), JSPEC, text_dim=tdim, latent_dim=8)
    return jp, bridge.from_jax(_np(jp)), tdim


@pytest.fixture(scope="module")
def jax_forward(wrapper):
    """JAX's output on ``_inputs`` in ``dtype`` (fp32 for None), each
    computed once."""
    jp, _, tdim = wrapper
    x, t, txt, bias = _inputs(tdim)
    outs = {}

    def get(dtype=None):
        if dtype not in outs:
            outs[dtype] = np.asarray(jax.jit(lambda p: jsd.sd_wrapper_apply(
                p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(txt), JSPEC,
                text_bias=jnp.asarray(bias), dtype=dtype))(jp)).astype(np.float32)
        return outs[dtype]
    return get


def _inputs(tdim, batch=2):
    rng = np.random.RandomState(0)
    x = rng.randn(batch, 27, 27, 8).astype(np.float32)
    t = np.array([3, 700][:batch])
    txt = rng.randn(batch, 6, tdim).astype(np.float32)
    mask = np.array([[1] * 6, [1] * 3 + [0] * 3][:batch])
    bias = np.where(mask[:, None, None, :] > 0, 0.0, -1e9).astype(np.float32)
    return x, t, txt, bias


def test_bridge_carries_the_none_attentions(wrapper):
    _, pp, _ = wrapper
    assert pp["unet"]["down_blocks"][3]["attentions"] is None
    assert pp["unet"]["up_blocks"][0]["attentions"] is None
    assert "text_projection" in pp or wrapper[2] == 20


def test_forward_matches_fp32(wrapper, jax_forward):
    _, pp, tdim = wrapper
    x, t, txt, bias = _inputs(tdim)
    ref = jax_forward()
    out = psd.sd_wrapper_apply(pp, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(txt), PSPEC,
                               text_bias=torch.from_numpy(bias)).numpy()
    assert out.shape == (2, 27, 27, 8)
    scale = float(np.abs(ref).max())
    assert scale > 0
    assert float(np.abs(out - ref).max()) <= 1e-5 * scale + 1e-6


def test_forward_bf16_within_jaxs_own_distance(wrapper, jax_forward):
    _, pp, tdim = wrapper
    x, t, txt, bias = _inputs(tdim)
    ref32, ref16 = jax_forward(), jax_forward(jnp.bfloat16)
    out = psd.sd_wrapper_apply(pp, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(txt), PSPEC, text_bias=torch.from_numpy(bias),
                               dtype=torch.bfloat16).float().numpy()
    jax_dist = float(np.abs(ref16 - ref32).max())
    assert 0 < jax_dist
    assert float(np.abs(out - ref32).max()) <= 2 * jax_dist


def test_gradients_match(wrapper):
    jp, pp, tdim = wrapper
    x, t, txt, bias = _inputs(tdim, batch=1)
    w = np.random.RandomState(1).randn(1, 27, 27, 8).astype(np.float32)

    def jloss(p):
        out = jsd.sd_wrapper_apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(txt),
                                   JSPEC, text_bias=jnp.asarray(bias))
        return jnp.sum(out * jnp.asarray(w))

    jgrads = jax.jit(jax.grad(jloss))(jp)
    params = tree.map(lambda a: a.clone().requires_grad_(True), pp)
    out = psd.sd_wrapper_apply(params, torch.from_numpy(x), torch.from_numpy(t),
                               torch.from_numpy(txt), PSPEC, text_bias=torch.from_numpy(bias))
    leaves = tree.leaves(params)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    ref = dict(tree.items(bridge.from_jax(_np(jgrads))))
    paths = [p for p, _ in tree.items(params)]
    assert set(ref) == set(paths)
    for path, g in zip(paths, grads):
        r = ref[path]
        bound = 1e-4 * float(r.abs().max()) + 1e-7
        assert float((g - r).abs().max()) <= bound, path


@pytest.mark.parametrize("target", [2, 4, 6, 8])
def test_channel_adaptations_match(target):
    jp = jsd.sd_unet_init(jax.random.PRNGKey(0), JSPEC)
    pp = bridge.from_jax(_np(jp))
    for jfn, pfn in ((jsd.adapt_in_channels, psd.adapt_in_channels),
                     (jsd.adapt_out_channels, psd.adapt_out_channels)):
        ref = bridge.from_jax(_np(jfn(jp, target)))
        got = pfn(pp, target)
        for name in ("conv_in", "conv_out"):
            for k in ("w", "b"):
                assert torch.equal(got[name][k], ref[name][k]), (jfn.__name__, name, k)


@pytest.mark.parametrize("mode", ["full", "cross_attention_only", "decoder_only"])
def test_training_masks_match(wrapper, mode):
    jp, pp, _ = wrapper
    ref = dict(tree.items(bridge.from_jax(jsd.sd_training_mask(jp, mode))))
    got = dict(tree.items(psd.sd_training_mask(pp, mode)))
    assert set(got) == set(ref) == {p for p, _ in tree.items(pp)}
    assert all(bool(ref[k]) is got[k] for k in ref)
    with pytest.raises(ValueError):
        psd.sd_training_mask(pp, "encoder_only")


@pytest.mark.parametrize("src,dst", [(4, 7), (7, 14), (14, 27)])
def test_nearest_resize_matches_jax(src, dst):
    x = np.random.RandomState(src).randn(2, src, src, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (2, dst, dst, 3), method="nearest"))
    got = psd.nearest_resize(torch.from_numpy(x), dst).numpy()
    np.testing.assert_array_equal(got, ref)


def test_timestep_embedding_matches():
    """cos first, denominator ``half``.  The arguments reach 999, whose fp32
    spacing is 6.1e-5; the two packages' exp and cos may round the argument
    one step apart, so the bound is two such steps."""
    t = np.array([0, 1, 17, 999])
    ref = np.asarray(jsd.sd_timestep_embedding(jnp.asarray(t), 320))
    got = psd.sd_timestep_embedding(torch.from_numpy(t), 320).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2 * float(np.spacing(np.float32(999))))
    np.testing.assert_array_equal(got[0], [1.0] * 160 + [0.0] * 160)



def test_none_subtrees_round_trip_both_packages(wrapper, tmp_path):
    """The ``None`` attentions survive tree walks, the optimizer's label
    walk and checkpoints: JAX writes and the port reads, the port writes
    and JAX's ``load_params`` reads."""
    from psg_tpu.core.checkpoint import load_params as jax_load_params
    from psg_tpu.core.checkpoint import save_state as jax_save_state
    from psg_tpu.core.checkpoint import wait_for_writes

    from psg_tpu_torch.core.checkpoint import load_params, save_state
    from psg_tpu_torch.core.config import OptimizationConfig
    from psg_tpu_torch.train.optim import build_optimizer, labels_from_mask

    jp, pp, _ = wrapper
    assert tree.map(lambda a: a, pp)["unet"]["up_blocks"][0]["attentions"] is None
    assert len(tree.leaves(pp)) == len(jax.tree_util.tree_leaves(jp))
    labels = labels_from_mask(psd.sd_training_mask(pp, "cross_attention_only"), "unet")
    tx = build_optimizer(OptimizationConfig(), {"unet": {"lr_schedule": lambda c: 1e-3,
                                                  "max_grad_norm": 1.0}}, labels)
    state = tx.init(pp)
    assert len(state["groups"]["unet"]["mu"]) == sum(lab == "unet" for lab in tx.labels)

    jax_save_state(tmp_path / "jax.ckpt", {"params": jp})
    wait_for_writes()
    template = tree.map(torch.zeros_like, pp)
    got = load_params(tmp_path / "jax.ckpt", template)
    assert got["unet"]["down_blocks"][3]["attentions"] is None
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(got), tree.leaves(pp)))

    save_state(tmp_path / "port.ckpt", {"params": bridge.to_jax(pp)})
    back = jax_load_params(tmp_path / "port.ckpt", jp)
    assert back["unet"]["up_blocks"][0]["attentions"] is None
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
