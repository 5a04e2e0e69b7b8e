"""psg_tpu_torch.utils (seed, profiling, memory, attention_viz) on the CPU,
against psg_tpu.utils where the two compute the same thing: attention
probabilities within rel 1e-5, and the largest-batch search choosing the
same batch for the same footprints.  The card's side (CUDA events, the
peak-allocated counter) is in tests/test_torch_cuda.py."""

import random

import jax
import numpy as np
import pytest
import torch

from psg_tpu.utils import attention_viz as jax_viz
from psg_tpu.utils import memory as jax_memory

from psg_tpu_torch.utils import memory
from psg_tpu_torch.utils.attention_viz import attention_probs, plot_attention_maps
from psg_tpu_torch.utils.profiling import StepTimer, debug_nans, trace
from psg_tpu_torch.utils.seed import set_seed

# one intra-op thread: the suite runs several test processes at once, and
# a pool of one thread per core in each of them oversubscribes the CPU
torch.set_num_threads(1)


def test_set_seed_seeds_every_generator():
    def draws():
        gen = set_seed(7, device="cpu")
        return (random.random(), np.random.rand(), torch.rand(()).item(),
                torch.rand((), generator=gen).item())

    first = draws()
    assert first == draws()
    assert set_seed(8, device="cpu").initial_seed() == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            set_seed(7)


def test_step_timer_on_the_host_clock():
    timer = StepTimer(device="cpu")
    for _ in range(3):
        with timer.measure():
            torch.randn(64, 64) @ torch.randn(64, 64)
    s = timer.summary()
    assert not timer.cuda and s["n"] == 3 and s["steps_per_s"] > 0
    assert StepTimer(device="cpu").summary() == {}


def test_debug_nans_raises_in_the_backward_and_restores():
    x = torch.tensor(-1.0, requires_grad=True)
    with debug_nans(True):
        assert torch.is_anomaly_enabled()
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x).backward()      # no anomaly mode: the NaN passes
    assert torch.isnan(x.grad)


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(tmp_path / "prof") as prof:
        (torch.randn(32, 32) @ torch.randn(32, 32)).sum()
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert any("matmul" in e.key or "mm" in e.key for e in prof.key_averages())


def test_attention_probs_match_jax(tmp_path):
    key = jax.random.PRNGKey(0)
    q = np.asarray(jax.random.normal(key, (1, 2, 16, 8)))
    k = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, 2, 5, 8)))
    got = attention_probs(torch.from_numpy(q), torch.from_numpy(k))
    np.testing.assert_allclose(got, jax_viz.attention_probs(q, k), rtol=1e-5, atol=1e-7)
    out = tmp_path / "attn.png"
    plot_attention_maps(got, spatial=4, out_path=out, tokens=list("abcde"))
    assert out.exists()
    with pytest.raises(ValueError):
        plot_attention_maps(got, spatial=3, out_path=out)


@pytest.mark.parametrize("limit,cap", [(64, 37), (64, 64), (4096, 1000), (64, 0)])
def test_batch_search_matches_jax(monkeypatch, limit, cap):
    """With the same footprint per batch (1 KiB a sample, and past ``cap``
    samples an out-of-memory error for the port, a failed compile for the
    JAX package), both searches choose the same batch."""
    budget = 1024 * 100

    def port_analysis(step_fn, x):
        if x.shape[0] > cap:
            raise torch.OutOfMemoryError("test")
        return {"peak_bytes": 1024 * x.shape[0]}

    def jax_analysis(step_fn, x):
        if x.shape[0] > cap:
            raise RuntimeError("RESOURCE_EXHAUSTED")
        return {"temp_size_bytes": 1024 * x.shape[0]}

    monkeypatch.setattr(memory, "step_memory_analysis", port_analysis)
    monkeypatch.setattr(jax_memory, "step_memory_analysis", jax_analysis)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    got = memory.find_max_batch_size(lambda b: (torch.zeros(b, 1),), None, limit=limit,
                                     hbm_bytes=budget, safety=1.0)
    ref = jax_memory.find_max_batch_size(lambda b: (np.zeros((b, 1)),), None, limit=limit,
                                         hbm_bytes=budget, safety=1.0)
    assert got == ref == min(cap, limit, 100)


def test_step_memory_analysis_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("the card's side is in tests/test_torch_cuda.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        memory.step_memory_analysis(lambda x: x, torch.zeros(2))
