"""The pieces of psg_tpu_torch's stage-2 training, each against psg_tpu's on
the CPU: the optimizer and its schedules against optax, the EMA, the losses,
the samplers' unfused classifier-free guidance, and the gradients of the
kernel ops' autograd Functions against direct autograd of their plain
versions.  Inputs are made from a seed with numpy."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from psg_tpu.core.config import OptimizationConfig as JaxOptCfg
from psg_tpu.diffusion import ddim_sample as jax_ddim
from psg_tpu.diffusion import make_schedule as jax_make_schedule
from psg_tpu.models import losses as jax_losses
from psg_tpu.train.optim import build_optimizer as jax_build_optimizer
from psg_tpu.train.optim import make_lr_schedule as jax_make_lr_schedule

from psg_tpu_torch.core.config import OptimizationConfig
from psg_tpu_torch.diffusion.sampling import ddim_sample
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models import bridge, losses
from psg_tpu_torch.ops import flash_attention, fused_norm
from psg_tpu_torch.train.optim import (build_optimizer, ema_update, make_lr_schedule,
                                       skipped_steps)

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

KINDS = ["constant", "cosine", "step", "onecycle", "warmup_cosine"]
SCHED_KW = dict(total_steps=50, steps_per_epoch=5, step_size_epochs=3, pct_start=0.1,
                warmup_steps=10, end_factor=0.1)


@pytest.mark.parametrize("kind", KINDS)
def test_lr_schedules_match_optax(kind):
    """optax computes in fp32, the port in fp64: 1e-6 of the peak apart at
    most (fp32's cosine near its zero)."""
    ref = jax_make_lr_schedule(kind, 1e-2, **SCHED_KW)
    got = make_lr_schedule(kind, 1e-2, **SCHED_KW)
    for count in range(60):
        np.testing.assert_allclose(got(count), float(ref(jnp.int32(count))), rtol=1e-6,
                                   atol=1e-6 * 1e-2, err_msg=f"{kind} at step {count}")


def _params(rng):
    """A small tree with a conv kernel (HWIO here, OIHW in the port), a
    linear layer and a frozen leaf."""
    return {"a": {"w": rng.randn(4, 3).astype(np.float32),
                  "b": rng.randn(3).astype(np.float32)},
            "conv": {"w": rng.randn(3, 3, 2, 4).astype(np.float32)},
            "frozen": {"w": rng.randn(5).astype(np.float32)}}


LABELS = {"a": {"w": "g1", "b": "g1"}, "conv": {"w": "g2"}, "frozen": {"w": "frozen"}}


def _grads(rng, params, step):
    g = jax.tree_util.tree_map(lambda p: rng.randn(*p.shape).astype(np.float32), params)
    if step == 7:      # a NaN anywhere: apply_if_finite rejects the step
        g["frozen"]["w"][2] = np.nan
    if step == 12:     # an exploded step: skip_above_global_norm rejects it
        g["a"]["w"] *= 1e3
    if step == 20:     # an infinity in a trained leaf
        g["conv"]["w"][0, 0, 0, 0] = np.inf
    return g


@pytest.mark.parametrize("kind,mu_dtype", [(k, None) for k in KINDS]
                         + [("constant", "bfloat16"), ("onecycle", "bfloat16")])
def test_optimizer_matches_optax_over_50_steps(kind, mu_dtype):
    """Two groups (g1 clipped at norm 1, g2 unclipped) and a frozen leaf;
    skip above norm 50; one NaN, one infinite and one exploded step."""
    rng = np.random.RandomState(0)
    params = _params(rng)
    jcfg = JaxOptCfg(learning_rate=1e-2, weight_decay=0.01, skip_grad_norm=50.0,
                     mu_dtype=mu_dtype)
    pcfg = OptimizationConfig(**dataclasses.asdict(jcfg))
    groups = lambda mk: {"g1": {"lr_schedule": mk(kind, 1e-2, **SCHED_KW),   # noqa: E731
                                "max_grad_norm": 1.0},
                         "g2": {"lr_schedule": mk("cosine", 3e-3, total_steps=50),
                                "max_grad_norm": None}}
    tx = jax_build_optimizer(jcfg, groups(jax_make_lr_schedule), LABELS)
    jstate = tx.init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    update = jax.jit(tx.update)

    port = build_optimizer(pcfg, groups(make_lr_schedule), LABELS)
    pparams = bridge.from_jax(params)
    pstate = port.init(pparams)
    grads_rng = np.random.RandomState(1)
    for step in range(50):
        g = _grads(grads_rng, params, step)
        upd, jstate = update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        info = port.update(pparams, bridge.from_jax(g), pstate)
        assert info["finite"] == (step not in (7, 20))

    ref = bridge.from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    for (path, r), (_, p) in zip(_items(ref), _items(pparams)):
        np.testing.assert_allclose(p.numpy(), r.numpy(), rtol=0, atol=1e-6, err_msg=path)
    np.testing.assert_array_equal(pparams["frozen"]["w"].numpy(), params["frozen"]["w"])

    # counters: apply_if_finite's, the norm skip's (inside multi_transform)
    # and Adam's step counts
    assert pstate["total_notfinite"] == int(jstate.total_notfinite) == 2
    assert pstate["notfinite_count"] == int(jstate.notfinite_count) == 0
    flat = jax.tree_util.tree_flatten_with_path(jstate.inner_state)[0]
    jskipped = {_group(p): int(v) for p, v in flat if _key(p, "skipped")}
    assert {n: g["skipped"] for n, g in pstate["groups"].items()} == jskipped
    assert jskipped["g1"] == 1 and jskipped["g2"] == 0
    jcounts = {}   # Adam's count and the schedule's, equal in optax
    for p, v in flat:
        if _key(p, "count"):
            jcounts.setdefault(_group(p), set()).add(int(v))
    assert {n: {g["count"]} for n, g in pstate["groups"].items()} == jcounts == {
        "g1": {47}, "g2": {48}}
    assert skipped_steps(pstate) == 3
    mu = next(iter(pstate["groups"]["g1"]["mu"].values()))
    assert mu.dtype == (torch.bfloat16 if mu_dtype else torch.float32)


def _items(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def _key(path, name):
    return any(getattr(k, "key", None) == name or getattr(k, "name", None) == name
               for k in path)


def _group(path):
    return next(k.key for k in path if getattr(k, "key", None) in ("g1", "g2"))


def test_ema_update_matches_the_jax_trainer():
    """psg_tpu/train/stage2_diffusion.py:_apply_update: d*e + (1-d)*p."""
    rng = np.random.RandomState(3)
    e, p = rng.randn(7, 5).astype(np.float32), rng.randn(7, 5).astype(np.float32)
    d = 0.999
    ref = np.asarray(d * jnp.asarray(e) + (1.0 - d) * jnp.asarray(p))
    ema = {"x": [torch.from_numpy(e.copy())]}
    ema_update(ema, {"x": [torch.from_numpy(p)]}, d)
    np.testing.assert_allclose(ema["x"][0].numpy(), ref, rtol=0, atol=1e-7)


@pytest.mark.parametrize("weights", [False, True])
def test_losses_match(weights):
    rng = np.random.RandomState(4)
    pred, target = rng.randn(3, 5, 5, 8).astype(np.float32), rng.randn(3, 5, 5, 8) \
        .astype(np.float32) * 0.1
    mu, logvar = rng.randn(3, 4, 4, 8).astype(np.float32), rng.randn(3, 4, 4, 8) \
        .astype(np.float32)
    w = np.array([1.0, 0.0, 0.5], np.float32) if weights else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    tp, tt, tm, tl = map(torch.from_numpy, (pred, target, mu, logvar))
    pairs = [
        (jax_losses.l1_loss(pred, target, jw), losses.l1_loss(tp, tt, tw)),
        (jax_losses.mse_loss(pred, target, jw), losses.mse_loss(tp, tt, tw)),
        (jax_losses.smooth_l1_loss(pred, target, 0.1, jw), losses.smooth_l1_loss(tp, tt, 0.1, tw)),
        (jax_losses.kl_divergence(mu, logvar, jw), losses.kl_divergence(tm, tl, tw)),
        (jax_losses.kl_divergence_free_bits(mu, logvar, 0.1, jw),
         losses.kl_divergence_free_bits(tm, tl, 0.1, tw)),
    ]
    for ref, got in pairs:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    for epoch in (0, 1, 2, 5):
        kw = dict(start=0, end=3, w_start=0.0, w_end=0.01)
        np.testing.assert_allclose(losses.kl_anneal_weight(epoch, **kw),
                                   float(jax_losses.kl_anneal_weight(epoch, **kw)), rtol=1e-6)


@pytest.mark.parametrize("guidance", [0.0, 2.5])
def test_unfused_cfg_matches_jax(guidance):
    """DDIM with eps = (1+g) eps_cond - g eps_uncond, the unconditional
    branch its own function (the trainer's sample grids)."""
    T = 50
    jsched, sched = jax_make_schedule(T, 1e-4, 0.02, "cosine"), make_schedule(T, 1e-4, 0.02,
                                                                             "cosine")
    rng = np.random.RandomState(5)
    x0 = rng.randn(2, 3, 3, 4).astype(np.float32)
    a, b = rng.randn(4, 4).astype(np.float32) * 0.3, rng.randn(4, 4).astype(np.float32) * 0.3

    def cond(mat, lib):
        def fn(x, t):
            scale = (t.astype(jnp.float32) if lib is jnp else t.float()) / T
            return lib.tanh(x @ (mat if lib is jnp else torch.from_numpy(mat))) \
                * scale[:, None, None, None]
        return fn

    ref = jax_ddim(cond(a, jnp), jsched, jax.random.PRNGKey(0),
                   initial_latent=jnp.asarray(x0), num_inference_steps=6, clip_x0=3.0,
                   guidance_scale=guidance, uncond_denoise_fn=cond(b, jnp))
    got = ddim_sample(cond(a, torch), sched, None, initial_latent=torch.from_numpy(x0),
                      num_inference_steps=6, clip_x0=3.0, guidance_scale=guidance,
                      uncond_denoise_fn=cond(b, torch))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the kernel ops' autograd Functions, run with their plain forwards
# ---------------------------------------------------------------------------

GRAD_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
            torch.bfloat16: dict(rtol=0, atol=0)}
# FlashSDPA's bf16 gradients against autograd of sdpa_plain: the backward
# takes Delta = rowsum(dO * O) from the stored bf16 output, where autograd
# takes rowsum(dP * P) in fp32, so the two differ by a few bf16 ulps of the
# gradient (at most 0.016 at magnitudes up to 5 at these shapes); the
# bound is the card tests' bf16 TOL (tests/test_torch_cuda.py).
FLASH_AUTOGRAD_TOL = {torch.float32: GRAD_TOL[torch.float32],
                      torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _t(a, dtype, grad=True):
    return torch.from_numpy(a).to(dtype).requires_grad_(grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu_function_gradients(dtype, silu):
    """GroupNormSiLU's backward (the plain version recomputed) equals direct
    autograd of the plain version, for x, scale and bias."""
    rng = np.random.RandomState(6)
    x = rng.randn(2, 25, 16).astype(np.float32) * 2 + 0.5
    scale, bias = rng.randn(16).astype(np.float32), rng.randn(16).astype(np.float32)
    gy = rng.randn(2, 25, 16).astype(np.float32)

    def run(fn):
        xs, s, b = _t(x, dtype), _t(scale, torch.float32), _t(bias, torch.float32)
        y = fn({"scale": s, "bias": b}, xs)
        y.backward(torch.from_numpy(gy).to(dtype))
        return y.detach(), xs.grad, s.grad, b.grad

    plain = lambda p, x: fused_norm.group_norm_silu_plain(p, x, 4, silu=silu)  # noqa: E731
    ref = run(plain)
    got = run(lambda p, x: fused_norm.group_norm_silu_autograd(
        p, x, 4, silu=silu,
        forward_impl=lambda p, x, g, eps, silu: fused_norm.group_norm_silu_plain(
            p, x, g, eps=eps, silu=silu)))
    for r, g in zip(ref, got):
        assert g.dtype == r.dtype
        torch.testing.assert_close(g, r, **GRAD_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_flash_function_gradients(dtype, masked):
    """FlashSDPA on the CPU, with the forward returning a [B,H,Lq,D] view
    of [B,Lq,H,D] memory (as the kernel does) and its logsumexp, and a
    non-contiguous incoming gradient: the output equals ``sdpa_plain``'s;
    the gradients of q, k and v equal ``sdpa_backward_plain`` (the backward
    kernel's algorithm) on the saved output and logsumexp, and direct
    autograd of ``sdpa_plain`` (in bf16 within FLASH_AUTOGRAD_TOL); the key
    bias takes no gradient."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 3, n, 8).astype(np.float32) for n in (5, 6, 6))
    bias = None
    if masked:
        keep = np.ones((2, 6), bool)
        keep[1, 3:] = False
        bias = torch.from_numpy(np.where(keep, 0.0, -1e9).astype(np.float32))[:, None, None, :]
    gy = torch.from_numpy(rng.randn(2, 5, 3, 8).astype(np.float32)).to(dtype).transpose(1, 2)
    assert not gy.is_contiguous()

    def viewed(q, k, v, bias, scale):   # the kernel's output layout
        out, lse = flash_attention.sdpa_lse_plain(q, k, v, bias=bias, scale=scale)
        return out.transpose(1, 2).contiguous().transpose(1, 2), lse

    def run(fn):
        ts = [_t(a, dtype) for a in (q, k, v)]
        out = fn(*ts)
        out.backward(gy)
        return [out.detach()] + [t.grad for t in ts]

    ref = run(lambda q, k, v: flash_attention.sdpa_plain(q, k, v, bias=bias))
    got = run(lambda q, k, v: flash_attention.flash_sdpa_autograd(q, k, v, bias=bias,
                                                                  forward_impl=viewed))
    ts = [_t(a, dtype) for a in (q, k, v)]
    out, lse = viewed(*ts, bias, 8 ** -0.5)
    want = [out, *flash_attention.sdpa_backward_plain(*ts, out, gy, lse, bias, 8 ** -0.5)]
    for w, g in zip(want, got):
        assert g.dtype == w.dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, **GRAD_TOL[dtype])
    torch.testing.assert_close(got[0], ref[0], **GRAD_TOL[dtype])
    for r, g in zip(ref[1:], got[1:]):
        torch.testing.assert_close(g, r, **FLASH_AUTOGRAD_TOL[dtype])
