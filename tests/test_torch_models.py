"""psg_tpu_torch models on the CPU against psg_tpu: JAX random-init
parameters go through ``psg_tpu_torch.models.bridge`` into the port, and the
same numpy-seeded inputs go through both.  fp32 throughout; tolerances cover
summation-order differences only."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.models import bert as jbert
from psg_tpu.models import text_encoder as jtext
from psg_tpu.models import unet as junet
from psg_tpu.models import vae as jvae
from psg_tpu.nn import layers as jlayers
from psg_tpu.nn.embeddings import sinusoidal_time_embedding as jax_time_emb
from psg_tpu.nn.resize import bilinear_resize as jax_resize

from psg_tpu_torch.models import bert as tbert
from psg_tpu_torch.models import text_encoder as ttext
from psg_tpu_torch.models import unet as tunet
from psg_tpu_torch.models import vae as tvae
from psg_tpu_torch.models.bridge import fit, from_jax
from psg_tpu_torch.nn import layers as tlayers
from psg_tpu_torch.nn.embeddings import sinusoidal_time_embedding
from psg_tpu_torch.nn.resize import bilinear_resize


def _t(a):
    return torch.from_numpy(np.array(a))


def _port(params):
    return from_jax(jax.tree_util.tree_map(np.asarray, params))


def _ids_mask(b, s, vocab, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[0, s // 2:] = 0
    ids[mask == 0] = 0
    return ids, mask


# ---------------------------------------------------------------------------
# nn primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,k,stride,pad,size", [
    (3, 8, 4, 2, 1, 21),    # 21 -> 10
    (8, 16, 4, 2, 2, 53),   # the VAE's k4/s2/p2: 53 -> 27
    (8, 8, 3, 2, 1, 27),    # UNet downsample 27 -> 14
    (8, 4, 1, 1, 0, 9),     # 1x1
])
def test_conv2d_matches(cin, cout, k, stride, pad, size):
    p = jlayers.conv2d_init(jax.random.PRNGKey(0), cin, cout, k)
    x = np.random.RandomState(1).randn(2, size, size, cin).astype(np.float32)
    ref = jlayers.conv2d(p, jnp.asarray(x), stride=stride, padding=pad)
    got = tlayers.conv2d(_port(p), _t(x), stride=stride, padding=pad)
    assert tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("src,dst", [(4, 7), (7, 14), (14, 27), (27, 54),
                                     (54, 108), (108, 215)])
def test_bilinear_upsample_matches(src, dst):
    x = np.random.RandomState(2).randn(1, src, src, 3).astype(np.float32)
    ref = jax_resize(jnp.asarray(x), (dst, dst))
    got = bilinear_resize(_t(x), (dst, dst))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=2e-6)


def test_norms_and_time_embedding_match():
    rng = np.random.RandomState(3)
    x = (rng.randn(2, 5, 5, 24) * 3 + 1).astype(np.float32)
    scale = rng.rand(24).astype(np.float32) + 0.5
    bias = rng.randn(24).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": _t(scale), "bias": _t(bias)}
    g = jlayers.largest_group_count(24)
    assert g == tlayers.largest_group_count(24)
    np.testing.assert_allclose(
        tlayers.group_norm(tp, _t(x), g, eps=1e-6).numpy(),
        np.asarray(jlayers.group_norm(jp, jnp.asarray(x), g, eps=1e-6)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tlayers.layer_norm(tp, _t(x), eps=1e-12).numpy(),
        np.asarray(jlayers.layer_norm(jp, jnp.asarray(x), eps=1e-12)),
        rtol=1e-5, atol=1e-5)
    ts = np.array([0, 1, 499, 999], np.int32)
    # arguments reach 999, where one fp32 step of the argument is 6e-5
    np.testing.assert_allclose(sinusoidal_time_embedding(_t(ts), 32).numpy(),
                               np.asarray(jax_time_emb(jnp.asarray(ts), 32)),
                               rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# text tower
# ---------------------------------------------------------------------------


def test_bert_tiny_matches():
    cfg_j = jbert.BertConfig.tiny_test()
    cfg_t = tbert.BertConfig.tiny_test()
    params = jbert.bert_init(jax.random.PRNGKey(0), cfg_j)
    ids, mask = _ids_mask(2, 16, cfg_j.vocab_size)
    h_ref, p_ref = jbert.bert_apply(params, jnp.asarray(ids), jnp.asarray(mask), cfg_j)
    h, p = tbert.bert_apply(_port(params), _t(ids).long(), _t(mask).long(), cfg_t)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_ref), rtol=1e-4, atol=1e-5)


def test_text_encoder_with_projection_matches():
    cfg_j = jbert.BertConfig.tiny_test(vocab_size=64)
    cfg_t = tbert.BertConfig.tiny_test(vocab_size=64)
    params = jtext.text_encoder_init(jax.random.PRNGKey(1), cfg_j, 48)
    assert "projection" in params
    ids, mask = _ids_mask(2, 12, 64, seed=1)
    ref = jtext.text_encoder_apply(params, jnp.asarray(ids), jnp.asarray(mask), cfg_j)
    got = ttext.text_encoder_apply(_port(params), _t(ids).long(), _t(mask).long(),
                                   cfg_t)
    assert tuple(got.shape) == (2, 12, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def test_unet_matches_with_text_mask():
    kw = dict(text_dim=48, time_emb_dim=32, num_heads=4, channels=(16, 24, 32, 32),
              spatial=(9, 5, 3, 2))
    spec_j = junet.UNetSpec(**kw)
    spec_t = tunet.UNetSpec(**kw)
    assert tunet.unet_spatial_for(9) == (9, 5, 3, 2)
    params = junet.unet_init(jax.random.PRNGKey(2), spec_j)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 9, 9, 8).astype(np.float32)
    ts = np.array([3, 41], np.int32)
    text = rng.randn(2, 10, 48).astype(np.float32)
    mask = np.ones((2, 10), np.int32)
    mask[1, 6:] = 0
    ref = junet.unet_apply(params, jnp.asarray(x), jnp.asarray(ts), jnp.asarray(text),
                           spec_j, text_mask=jnp.asarray(mask))
    got = tunet.unet_apply(_port(params), _t(x), _t(ts), _t(text), spec_t,
                           text_mask=_t(mask))
    assert np.abs(np.asarray(ref)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vae_params():
    return jvae.vae_init(jax.random.PRNGKey(3), latent_dim=8, text_dim=48,
                         width_scale=0.25)


@pytest.mark.parametrize("compat", [False, True])
def test_vae_decoder_matches(vae_params, compat):
    rng = np.random.RandomState(5)
    latent = rng.randn(2, 9, 9, 8).astype(np.float32)
    text = rng.randn(2, 10, 48).astype(np.float32)
    mask = np.ones((2, 10), np.int32)
    mask[0, 4:] = 0
    ref = jvae.vae_decode(vae_params, jnp.asarray(latent), jnp.asarray(text),
                          text_bias=junet.text_bias_from_mask(jnp.asarray(mask)),
                          image_size=64, compat_reshape=compat)
    got = tvae.vae_decode(_port(vae_params), _t(latent), _t(text),
                          text_bias=tunet.text_bias_from_mask(_t(mask)),
                          image_size=64, compat_reshape=compat)
    assert tuple(got.shape) == (2, 64, 64, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=2e-5)


def test_vae_encoder_matches(vae_params):
    images = np.random.RandomState(6).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    mu_r, lv_r = jvae.vae_encoder_apply(vae_params["encoder"], jnp.asarray(images))
    mu, lv = tvae.vae_encoder_apply(_port(vae_params)["encoder"], _t(images))
    assert tuple(mu.shape) == (2, tvae.latent_size_for(64), 9, 8)
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(lv.numpy(), np.asarray(lv_r), rtol=1e-4, atol=1e-5)


def test_width_scale_and_latent_size_match():
    for image in (64, 215, 128):
        assert tvae.latent_size_for(image) == jvae.latent_size_for(image)
    for c in (32, 64, 128, 256, 512):
        for s in (1.0, 0.5, 0.25, 0.375):
            assert tvae.width_scale(c, s) == jvae._w(c, s)


def test_port_init_tree_fits_jax_tree(vae_params):
    """The port's own random init has exactly the bridged JAX tree's
    structure and shapes (so checkpoints from either side fit)."""
    gen = torch.Generator().manual_seed(0)
    fit(tvae.vae_init(gen, 8, 48, 0.25), _port(vae_params))
    kw = dict(text_dim=48, time_emb_dim=32, num_heads=4, channels=(16, 24, 32, 32))
    fit(tunet.unet_init(gen, tunet.UNetSpec(**kw)),
        _port(junet.unet_init(jax.random.PRNGKey(0), junet.UNetSpec(**kw))))
    cfg = tbert.BertConfig.tiny_test()
    fit(ttext.text_encoder_init(gen, cfg, 48),
        _port(jtext.text_encoder_init(jax.random.PRNGKey(0),
                                      jbert.BertConfig.tiny_test(), 48)))
    with pytest.raises(ValueError):
        fit(ttext.text_encoder_init(gen, cfg, 32),
            _port(jtext.text_encoder_init(jax.random.PRNGKey(0),
                                          jbert.BertConfig.tiny_test(), 48)))
