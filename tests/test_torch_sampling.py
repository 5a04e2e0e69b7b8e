"""psg_tpu_torch diffusion schedule and samplers against psg_tpu on the CPU.

The samplers are driven by the same deterministic denoise function and the
same numpy-made ``initial_latent`` on both sides (DDIM at eta 0 and
DPM-Solver++(2M) draw no randomness then).  The four DDPM-family samplers
draw a gaussian a step: JAX draws them from its key, and the port is given
the same draws through ``noises``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psg_tpu.diffusion import sampling as jsampling
from psg_tpu.diffusion.sampling import ddim_sample as jax_ddim
from psg_tpu.diffusion.sampling import dpmpp_2m_sample as jax_dpmpp
from psg_tpu.diffusion.schedule import make_schedule as jax_make_schedule

from psg_tpu_torch.diffusion import sampling as tsampling
from psg_tpu_torch.diffusion.sampling import (
    ddim_sample,
    ddim_timesteps,
    dpmpp_2m_sample,
    ddpm_timesteps,
    fast_stride,
    fast_timesteps,
    renoise_timesteps,
    x0_timesteps,
)
from psg_tpu_torch.diffusion.schedule import linspace_f32, make_schedule

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)

_FIELDS = ("betas", "alphas", "alphas_cumprod", "alphas_cumprod_prev",
           "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
           "sqrt_recip_alphas", "posterior_variance")


@pytest.mark.parametrize("kind", ["linear", "cosine"])
@pytest.mark.parametrize("T", [50, 1000])
def test_schedule_tables_match(kind, T):
    ref = jax_make_schedule(T, 1e-4, 0.02, kind)
    got = make_schedule(T, 1e-4, 0.02, kind)
    assert got.num_timesteps == T
    for f in _FIELDS:
        # fp32 tables: XLA takes the cumulative product in another order and
        # its fp32 cos differs by an ulp; both move entries by ~1e-6
        # relative, amplified up to ~1e-4 where 1 - acp cancels near t = 0
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=2e-4, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("T", [50, 1000])
def test_linspace_and_timestep_tables_bit_exact(T):
    """The integer timestep tables (round for DDIM, truncation for the
    renoise sampler) must equal jnp.linspace's for every step count: plain
    fp32/fp64 constructions differ on dozens of (T, steps) pairs."""
    for steps in range(2, 201):
        # fp32 values are bit-equal, so round-half-even and truncation of
        # them (numpy's and XLA's agree) give equal integer tables
        ref = np.asarray(jnp.linspace(T - 1, 0, steps))
        got = linspace_f32(T - 1, 0, steps)
        np.testing.assert_array_equal(got, ref, err_msg=f"T={T} steps={steps}")
        np.testing.assert_array_equal(ddim_timesteps(T, steps),
                                      np.round(ref).astype(np.int32))
    # the tables as the samplers build them, under jit
    for steps in (10, 15, 20, 50):
        np.testing.assert_array_equal(
            ddim_timesteps(T, steps),
            np.asarray(jax.jit(lambda: jnp.round(
                jnp.linspace(T - 1, 0, steps)).astype(jnp.int32))()))
        np.testing.assert_array_equal(
            linspace_f32(T - 1, 0, steps).astype(np.int32),
            np.asarray(jax.jit(lambda: jnp.linspace(
                T - 1, 0, steps).astype(jnp.int32))()))


def _denoise_pair():
    """The same smooth, t-dependent 'model' on both sides."""
    def jax_fn(x, t):
        tt = (t.astype(jnp.float32) / 50.0)[:, None, None, None]
        return 0.3 * jnp.tanh(x) * (1.0 + tt) + 0.05 * x

    def torch_fn(x, t):
        tt = (t.float() / 50.0)[:, None, None, None]
        return 0.3 * torch.tanh(x) * (1.0 + tt) + 0.05 * x

    return jax_fn, torch_fn


@pytest.mark.parametrize("sampler", ["ddim", "dpmpp"])
@pytest.mark.parametrize("clip_x0", [None, 3.0])
def test_samplers_match(sampler, clip_x0):
    sched_j = jax_make_schedule(50, 1e-4, 0.02, "linear")
    sched_t = make_schedule(50, 1e-4, 0.02, "linear")
    x0 = np.random.RandomState(0).randn(2, 5, 5, 8).astype(np.float32)
    jfn, tfn = _denoise_pair()
    kw = dict(num_inference_steps=7, clip_x0=clip_x0)
    jsamp, tsamp = {"ddim": (jax_ddim, ddim_sample),
                    "dpmpp": (jax_dpmpp, dpmpp_2m_sample)}[sampler]
    ref = jsamp(jfn, sched_j, jax.random.PRNGKey(0), initial_latent=jnp.asarray(x0),
                **kw)
    got = tsamp(tfn, sched_t, None, initial_latent=torch.from_numpy(x0), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_eps_from_v_matches():
    sched_j = jax_make_schedule(50, 1e-4, 0.02, "cosine")
    sched_t = make_schedule(50, 1e-4, 0.02, "cosine")
    rng = np.random.RandomState(1)
    v, x = rng.randn(2, 3, 3, 8).astype(np.float32), rng.randn(2, 3, 3, 8).astype(np.float32)
    t = np.array([0, 37], np.int32)
    ref = sched_j.eps_from_v(jnp.asarray(v), jnp.asarray(x), jnp.asarray(t))
    got = sched_t.eps_from_v(torch.from_numpy(v), torch.from_numpy(x), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_prior_draw_is_seeded():
    sched = make_schedule(50, 1e-4, 0.02, "linear")
    _, tfn = _denoise_pair()
    a, b, c = (ddim_sample(tfn, sched, torch.Generator().manual_seed(s), shape=(1, 3, 3, 8),
                           num_inference_steps=3) for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("T", [50, 1000])
def test_ddpm_family_timestep_tables_match(T):
    """Each DDPM-family table as the JAX samplers build it; the fast and x0
    tables may be longer than ``steps``."""
    for steps in (1, 2, 3, 4, 7, 10, 20, 33, 49, 50):
        stride = T // steps
        np.testing.assert_array_equal(
            ddpm_timesteps(T, steps),
            np.asarray(jnp.maximum(T - 1 - jnp.arange(steps) * max(1, stride), 0)))
        np.testing.assert_array_equal(
            fast_timesteps(T, fast_stride(T, steps)),
            np.asarray(jnp.arange(T - (T - 1) % max(1, stride) - 1, -1, -max(1, stride))))
        ref_x0 = (jnp.arange(T - 1, -1, -1) if steps >= T
                  else jnp.arange(T - 1, -1, -stride))
        np.testing.assert_array_equal(x0_timesteps(T, steps), np.asarray(ref_x0))
        np.testing.assert_array_equal(
            renoise_timesteps(T, steps),
            np.asarray(jnp.linspace(T - 1, 0, steps).astype(jnp.int32)))
    assert len(x0_timesteps(50, 4)) == 5 and len(fast_timesteps(1000, 142)) == 8


def _jax_step_draws(key, n, shape):
    """The gaussians a JAX DDPM-family sampler draws from ``key``: it splits
    off the prior's key, then splits one key a step."""
    key, _kinit = jax.random.split(key)
    out = []
    for _ in range(n):
        key, kn = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(kn, shape, jnp.float32)))
    return np.stack(out)


@pytest.mark.parametrize("sampler,steps", [
    ("ddpm", 7), ("ddpm", 50),
    ("fast", 7), ("fast", 4),
    ("x0", 4),    # 5 evaluations
    ("x0", 7),
    ("renoise", 7), ("renoise", 2),
])
def test_ddpm_family_matches_with_jax_draws(sampler, steps):
    T = 50
    sched_j = jax_make_schedule(T, 1e-4, 0.02, "linear")
    sched_t = make_schedule(T, 1e-4, 0.02, "linear")
    x0 = np.random.RandomState(0).randn(2, 5, 5, 8).astype(np.float32)
    jfn, tfn = _denoise_pair()
    name = {"ddpm": "ddpm_sample", "fast": "ddpm_sample_fast", "x0": "ddpm_sample_x0",
            "renoise": "ddpm_sample_renoise"}[sampler]
    if sampler == "fast":
        kw, ts = dict(stride=fast_stride(T, steps)), fast_timesteps(T, fast_stride(T, steps))
    else:
        kw = dict(num_inference_steps=steps)
        ts = {"ddpm": ddpm_timesteps, "x0": x0_timesteps,
              "renoise": renoise_timesteps}[sampler](T, steps)
    key = jax.random.PRNGKey(11)
    ref = getattr(jsampling, name)(jfn, sched_j, key, initial_latent=jnp.asarray(x0), **kw)
    noises = _jax_step_draws(key, len(ts), x0.shape)
    got = getattr(tsampling, name)(tfn, sched_t, None, initial_latent=torch.from_numpy(x0),
                                   noises=torch.from_numpy(noises), **kw)
    assert np.abs(np.asarray(ref)).max() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sampler", ["ddpm", "fast", "x0", "renoise"])
def test_ddpm_family_draws_from_the_generator(sampler):
    """Without ``noises`` the draws come from the torch generator: seeded and
    repeatable, and they differ between seeds."""
    sched = make_schedule(50, 1e-4, 0.02, "linear")
    _, tfn = _denoise_pair()
    fn = {"ddpm": tsampling.ddpm_sample, "fast": tsampling.ddpm_sample_fast,
          "x0": tsampling.ddpm_sample_x0, "renoise": tsampling.ddpm_sample_renoise}[sampler]
    kw = dict(stride=12) if sampler == "fast" else dict(num_inference_steps=4)
    a, b, c = (fn(tfn, sched, torch.Generator().manual_seed(s), shape=(1, 3, 3, 8), **kw)
               for s in (7, 7, 8))
    assert torch.isfinite(a).all()
    assert torch.equal(a, b) and not torch.equal(a, c)
