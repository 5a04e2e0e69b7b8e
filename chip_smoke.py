#!/usr/bin/env python3
"""Smoke test of psg_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
imports nothing of JAX or psg_tpu, exits non-zero at the first failure, and
prints one JSON line per phase:

1. ``build``    the card's name and power limit; the three kernel libraries
                built from ``psg_tpu_torch/csrc/`` (one nvcc each, in parallel).
2. ``kernels_vs_plain``  every kernel against its plain PyTorch version on
                the card at the full-width main path's shapes, in fp32 (TF32
                off) and bf16: max error against the stated tolerance, and
                device times of the kernel, the plain version and, where one
                PyTorch call computes the same function, that call (timed as
                a yardstick only), beside the least time the card could take
                (bytes / 3.35 TB/s or operations / peak).  Device times come
                from CUDA events around the replay of a CUDA graph of many
                calls, so no host time is in them; ``call_ms`` is the
                wrapper's eager time per call, host included, and
                ``host_bound`` marks a case whose eager call takes over 1.5x
                its device time.
3. ``e2e_card_vs_cpu``  the whole text -> sprite chain at a tiny config in
                fp32, the same parameters and initial latent on the card
                (kernels) and on the CPU (plain versions): image MAE <= 1e-3.
4. ``serve_full_width``  config/train_config.yaml (bf16, BERT-base, UNet
                320/640/1280/1280, full VAE, 215x215, text_len 128) with random
                weights from the config's seed: generate_batch of 4 prompts
                (DDIM 20 steps, CFG 2.0 with a negative prompt) and
                generate_from_text (DPM-Solver++ 10 steps) twice with one seed.
                Images must be finite and of the right shape, the seed must
                repeat its image, and every kernel's launch count over these
                requests must equal the count the model's structure predicts.

Then the card's name and power limit, the ``kernels`` line (each kernel at
its heaviest main-path shape, with its launches in phase 4), and last
``{"ok": true, "device": {...}}``.  ``--json PATH`` also writes every
phase's record to PATH.
"""

import argparse
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
VOCAB = ROOT / "experiments" / "evidence_r5c_vae" / "vocab.txt"
CONFIG = ROOT / "config" / "train_config.yaml"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # fp32 outside the tensor cores
L2_BYTES = 50 * 2**20

NEGATIVE = "blurry, low quality, deformed"
PROMPTS = ["a small green grass creature with a leaf on its head",
           "a red fire lizard with a flame on its tail",
           "a blue water turtle with a shell",
           "a yellow electric mouse with red cheeks"]

# tolerance of each kernel against its plain version, by dtype.  fp32 differs
# only in summation order and the fast __expf; bf16 outputs may also round one
# bf16 step apart, and the attention kernel keeps its probabilities in fp32
# where the plain version rounds them to bf16 before the product with V.
TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
COLD_TOL_F32 = dict(rtol=2e-3, atol=2e-3)   # logits in the hundreds
E2E_MAE = 1e-3

REPORT = {}


def emit(phase, record):
    REPORT[phase] = record
    print(json.dumps({"phase": phase, **record}, separators=(",", ":")), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(fn, sets, reps):
    """Eager mean ms per call over ``reps`` calls, cycling through input
    sets: host and device time, whichever is longer."""
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for i in range(reps):
        fn(*sets[i % len(sets)])
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


@functools.lru_cache(maxsize=None)
def _warmup_stream():
    """One side stream for every graph warm-up: cuBLAS keeps a workspace for
    each stream it has run on, for the life of the process."""
    return torch.cuda.Stream()


def device_ms(fn, sets, reps, replays=5):
    """Device ms per call: ``reps`` calls over the input sets captured into
    one CUDA graph, timed over each replay; the median of ``replays``."""
    side = _warmup_stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):   # warm-up off the capture, as graphs need
        for args in sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for i in range(reps):
            fn(*sets[i % len(sets)])
    graph.replay()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        t0.record()
        graph.replay()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    del graph
    return sorted(times)[replays // 2]


def bound(nbytes, flops, flop_dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[flop_dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _randn(shape, seed, dtype=torch.float32, scale=1.0, shift=0.0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return (torch.randn(shape, generator=g, device="cuda") * scale + shift).to(dtype)


def gn_case(name, b, hw, c, g, dtype):
    from psg_tpu_torch.ops import fused_norm

    def make(seed):
        x = _randn((b, hw * hw, c), seed, dtype, scale=2.0, shift=0.5)
        p = {"scale": _randn((c,), seed + 1, scale=0.3, shift=1.0),
             "bias": _randn((c,), seed + 2, scale=0.1)}
        return p, x

    def library(p, x):  # channels-last NCHW view, as the model holds it
        xv = x.view(b, hw, hw, c).permute(0, 3, 1, 2)
        return F.silu(F.group_norm(xv, g, p["scale"].to(dtype), p["bias"].to(dtype),
                                   1e-5)).permute(0, 2, 3, 1).reshape(b, hw * hw, c)

    x = make(0)[1]
    return dict(kernel_name="group_norm_silu", name=name, dtype=dtype, make=make,
                kernel=lambda p, x: fused_norm.fused_group_norm_silu(p, x, g),
                plain=lambda p, x: fused_norm.group_norm_silu_plain(p, x, g),
                library=library, tol=TOL[dtype],
                # one read of x, one write of y, scale and bias; ~10 fp32
                # operations an element (two-pass statistics, affine, SiLU)
                bytes=2 * nbytes(x) + 2 * c * 4, flops=10 * x.numel(),
                flop_dtype=torch.float32)


def flash_case(name, b, h, lq, lk, d, masked, dtype):
    from psg_tpu_torch.ops import flash_attention

    def make(seed):
        q = _randn((b, h, lq, d), seed, dtype)
        k = _randn((b, h, lk, d), seed + 1, dtype)
        v = _randn((b, h, lk, d), seed + 2, dtype)
        bias = None
        if masked:  # the last sample's prompt is a third of the text length
            keep = torch.ones(b, lk, device=q.device, dtype=torch.bool)
            keep[-1, max(1, lk // 3):] = False
            bias = torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
        return q, k, v, bias

    q, k, v, bias = make(0)
    return dict(kernel_name="flash_attention", name=name, dtype=dtype, make=make,
                kernel=lambda q, k, v, bias: flash_attention.flash_sdpa(q, k, v, bias=bias),
                plain=lambda q, k, v, bias: flash_attention.sdpa_plain(
                    q, k, v, bias=bias, scale=d ** -0.5),
                library=lambda q, k, v, bias: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=None if bias is None else bias.to(dtype)),
                tol=TOL[dtype],
                bytes=2 * nbytes(q) + nbytes(k, v, bias), flops=4 * b * h * lq * lk * d,
                flop_dtype=dtype)


def spatial_case(name, b, hw, c, s, cold, dtype):
    from psg_tpu_torch.ops import spatial_xattn as sx

    heads, scale = 8, (c // 8) ** -0.5

    def make(seed):
        xn = _randn((b, hw * hw, c), seed, dtype)
        res = _randn((b, hw * hw, c), seed + 1, dtype)
        k, v = _randn((b, s, c), seed + 2), _randn((b, s, c), seed + 3)
        # cold heads: Q scaled x120 so head logits span hundreds and a
        # shared row max would underflow the cold heads' exp()
        wq = _randn((c, c), seed + 4, scale=c ** -0.5 * (120.0 if cold else 1.0))
        wp = _randn((c, c), seed + 5, scale=c ** -0.5)
        bq, bp = _randn((c,), seed + 6, scale=0.1), _randn((c,), seed + 7, scale=0.1)
        keep = torch.ones(b, s, device=xn.device, dtype=torch.bool)
        keep[-1, s // 3:] = False
        bias = torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
        return xn, res, k, v, wq, bq, wp, bp, bias

    def kernel(xn, res, k, v, wq, bq, wp, bp, bias):
        return sx.fused_spatial_xattn(xn, res, k, v, wq, bq, wp, bp, num_heads=heads,
                                      text_bias=bias)

    def plain(xn, res, k, v, wq, bq, wp, bp, bias):
        return sx.spatial_xattn_plain(
            xn, res, sx.split_heads(k, heads, False).contiguous(),
            sx.split_heads(v, heads, False).contiguous(), wq, bq, wp, bp,
            key_bias=bias.reshape(b, s), scale=scale)

    xn, res, k, v, wq, bq, wp, bp, bias = make(0)
    tol = COLD_TOL_F32 if cold and dtype == torch.float32 else TOL[dtype]
    return dict(kernel_name="spatial_xattn", name=name, dtype=dtype, make=make,
                kernel=kernel, plain=plain, library=None, tol=tol,
                bytes=3 * nbytes(xn) + nbytes(k, v, wq, bq, wp, bp, bias),
                # Q projection, scores, P.V and output projection per pixel
                flops=b * hw * hw * (4 * c * c + 4 * s * c), flop_dtype=dtype)


def main_path_cases():
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        for hw, c in ((27, 320), (27, 640), (14, 640), (14, 1280), (7, 1280),
                      (7, 2560), (4, 1280), (4, 2560)):
            cases.append(gn_case(f"unet {hw}^2x{c}", 8, hw, c, 32, dtype))
        for hw, c, g in ((27, 512, 32), (27, 256, 32), (54, 256, 32), (54, 128, 32),
                         (108, 128, 32), (108, 64, 32), (215, 64, 32), (215, 32, 32),
                         (215, 32, 8)):
            cases.append(gn_case(f"vae {hw}^2x{c} G{g}", 4, hw, c, g, dtype))
        for name, shape in (
                ("bert self L128 hd64", (4, 12, 128, 128, 64, True)),
                ("bert self L128 hd64 b1", (1, 12, 128, 128, 64, True)),
                ("unet 14^2 self hd160", (8, 4, 196, 196, 160, False)),
                ("unet 14^2 cross hd160", (8, 4, 196, 128, 160, True)),
                ("unet 7^2 self hd320", (8, 4, 49, 49, 320, False)),
                ("unet 7^2 cross hd320", (8, 4, 49, 128, 320, True)),
                ("unet 4^2 self hd320", (8, 4, 16, 16, 320, False)),
                ("unet 4^2 cross hd320", (8, 4, 16, 128, 320, True)),
                ("vae 27^2 xattn hd64", (4, 8, 729, 128, 64, True)),
                ("vae 27^2 xattn hd32", (4, 8, 729, 128, 32, True)),
                ("vae 54^2 xattn hd16", (4, 8, 2916, 128, 16, True))):
            cases.append(flash_case(name, *shape, dtype))
        cases.append(spatial_case("vae 108^2 C64", 4, 108, 64, 128, False, dtype))
        cases.append(spatial_case("vae 215^2 C32", 4, 215, 32, 128, False, dtype))
        cases.append(spatial_case("vae 215^2 C32 cold heads", 4, 215, 32, 128, True,
                                  dtype))
    return cases


def run_case(case):
    n_sets = max(2, min(8, math.ceil(2 * L2_BYTES / case["bytes"])))
    sets = [case["make"](17 * i) for i in range(n_sets)]
    got = case["kernel"](*sets[0])
    ref = case["plain"](*sets[0])
    torch.cuda.synchronize()
    if got.dtype != case["dtype"] or got.shape != ref.shape:
        fail(f"{case['name']}: kernel gave {got.dtype} {tuple(got.shape)}, plain "
             f"{ref.dtype} {tuple(ref.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"{case['name']} {case['dtype']}: non-finite kernel output")
    err = (got.float() - ref.float()).abs().max().item()
    ok = torch.allclose(got.float(), ref.float(), **case["tol"])
    lib_ms = None
    if case["library"] is not None:
        lib_ms = device_ms(case["library"], sets, 20)
    b_ms, b_by = bound(case["bytes"], case["flops"], case["flop_dtype"])
    kernel_ms = device_ms(case["kernel"], sets, 30)
    call_ms = time_ms(case["kernel"], sets, 30)
    rec = dict(kernel=case["kernel_name"], name=case["name"],
               dtype=str(case["dtype"]).replace("torch.", ""), max_abs_err=err,
               rtol=case["tol"]["rtol"], atol=case["tol"]["atol"], ok=bool(ok),
               kernel_ms=kernel_ms, call_ms=call_ms,
               host_bound=call_ms > 1.5 * kernel_ms,
               plain_ms=device_ms(case["plain"], sets, 10), library_ms=lib_ms,
               bound_ms=b_ms, bound_by=b_by)
    del sets, got, ref
    torch.cuda.empty_cache()   # the graphs' memory pools
    return rec


# ---------------------------------------------------------------------------
# phases 3 and 4: the serving chain
# ---------------------------------------------------------------------------


def tiny_config():
    from psg_tpu_torch.core.config import Config

    cfg = Config()
    cfg.model.bert_model = "tiny-test"
    cfg.model.vae_width_scale = 0.25
    cfg.model.text_embedding_dim = 48
    cfg.model.unet_channels = (16, 24, 32, 32)
    cfg.model.num_attention_heads = 4
    cfg.model.time_emb_dim = 32
    cfg.model.num_timesteps = 50
    cfg.data.image_size = 64
    cfg.data.text_len = 32
    return cfg


def predicted_launches(gen, n_unet_evals):
    """Kernel launches of one request, from the model's structure: per UNet
    evaluation two GN+SiLU per ResBlock plus the final norm, and two
    attention calls per attention block; per text encode one attention per
    BERT layer; per decode two GN+SiLU per ResNet block plus the final norm,
    and one spatial attention per decoder block (the fused kernel at the
    widths it is built for, else the flash kernel)."""
    from psg_tpu_torch.models.vae import _DEC_BLOCKS, width_scale
    from psg_tpu_torch.ops.spatial_xattn import CHANNELS

    spec = gen.spec
    nlvl, bpl = len(spec.channels), spec.blocks_per_level
    unet_gn = 2 * (2 * nlvl * bpl + 1) + 1
    unet_attn = 2 * (2 * bpl * sum(spec.attention_levels) + 1)
    widths = [width_scale(cout, gen.cfg.model.vae_width_scale)
              for _cin, cout, _up in _DEC_BLOCKS]
    fused = sum(w in CHANNELS for w in widths)
    return {"group_norm_silu": n_unet_evals * unet_gn + 4 * len(_DEC_BLOCKS) + 1,
            "flash_attention": (gen.bert_cfg.num_layers + n_unet_evals * unet_attn
                                + len(widths) - fused),
            "spatial_xattn": fused}


def phase_e2e_card_vs_cpu():
    from psg_tpu_torch import ops
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

    tok = WordPieceTokenizer.from_vocab_file(VOCAB)
    cfg = tiny_config()
    kw = dict(tokenizer=tok, guidance_scale=2.0, negative=NEGATIVE)
    cpu = PokemonGenerator(cfg, device="cpu", **kw)
    card = PokemonGenerator(cfg, device="cuda", params=cpu.params, **kw)
    ids, mask = tok.encode_batch(PROMPTS[:2], cfg.data.text_len)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask).long()
    latent = torch.from_numpy(
        np.random.RandomState(0).randn(2, 9, 9, cfg.model.latent_dim).astype(np.float32))
    out = {}
    for sampler in ("ddim", "dpmpp"):
        ref = cpu._generate_impl(cpu.params, None, ids, mask, latent, steps=4, num=2,
                                 sampler=sampler)
        ops.reset_launch_counts()
        got = card._generate_impl(card.params, None, ids.cuda(), mask.cuda(),
                                  latent.cuda(), steps=4, num=2, sampler=sampler)
        got = got.float().cpu()
        counts = ops.launch_counts()
        mae = (got - ref).abs().mean().item()
        out[sampler] = {"image_mae": mae, "max_abs": (got - ref).abs().max().item(),
                        "launches": counts}
        if got.shape != (2, 64, 64, 3) or not torch.isfinite(got).all():
            fail(f"tiny e2e {sampler}: bad output {tuple(got.shape)}")
        if not mae <= E2E_MAE:
            fail(f"tiny e2e {sampler}: card vs CPU image MAE {mae} > {E2E_MAE}")
        if min(counts.values()) == 0:
            fail(f"tiny e2e {sampler}: a kernel was not launched: {counts}")
    return {"bound": E2E_MAE, **out}


def phase_serve_full_width():
    from psg_tpu_torch import ops
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

    cfg = load_config(CONFIG)
    if cfg.model.compute_dtype != "bfloat16" or cfg.data.image_size != 215:
        fail(f"{CONFIG.name} is not the full-width bf16 configuration")
    t0 = time.perf_counter()
    gen = PokemonGenerator(cfg, tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                           sampler="dpmpp", guidance_scale=2.0, negative=NEGATIVE,
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for part in ("text", "unet", "vae")
                   for t in _leaves(gen.params[part]))
    # warm-up (cuDNN and cuBLAS pick their kernels), outside the counted run
    gen.generate_batch(PROMPTS, num_inference_steps=2, seed=100, sampler="ddim")
    gen.generate_from_text(PROMPTS[0], num_inference_steps=2, seed=101)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()

    requests = []
    expected = {k: 0 for k in ops.launch_counts()}
    ops.reset_launch_counts()   # the main path's counted run starts here

    def serve(kind, fn, n_unet_evals):
        before = ops.launch_counts()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = predicted_launches(gen, n_unet_evals)
        for k in expected:
            expected[k] += want[k]
        requests.append({"request": kind, "wall_s": wall, "launches": got,
                         "predicted": want})
        if got != want:
            fail(f"{kind}: kernel launches {got} != predicted {want}")
        return result

    steps_batch, steps_one = 20, 10
    imgs = serve(f"generate_batch n=4 ddim {steps_batch} steps cfg",
                 lambda: gen.generate_batch(PROMPTS, steps_batch, seed=0,
                                            sampler="ddim"), steps_batch)
    a = serve(f"generate_from_text dpmpp {steps_one} steps cfg",
              lambda: np.asarray(gen.generate_from_text(PROMPTS[1], steps_one, seed=1)),
              steps_one)
    b = serve(f"generate_from_text dpmpp {steps_one} steps cfg (same seed)",
              lambda: np.asarray(gen.generate_from_text(PROMPTS[1], steps_one, seed=1)),
              steps_one)
    launches = ops.launch_counts()   # ... and ends here
    if imgs.shape != (4, 215, 215, 3) or not np.isfinite(imgs).all():
        fail(f"generate_batch: bad images {imgs.shape}")
    if a.shape != (215, 215, 3):
        fail(f"generate_from_text: bad image {a.shape}")
    if not np.array_equal(a, b):
        fail("generate_from_text: the same seed gave a different image")
    if launches != expected or min(launches.values()) == 0:
        fail(f"main path launches {launches} != predicted {expected}")
    return {"params": n_params, "init_s": init_s, "requests": requests,
            "launches": launches, "image_std": float(imgs.std()),
            "resident_gb": resident / 1e9,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------------------


KERNEL_LINE = (  # kernel, its heaviest main-path case, source, TPU kernel
    ("group_norm_silu", "vae 215^2x64 G32", "psg_tpu_torch/csrc/group_norm_silu.cu",
     "psg_tpu/ops/fused_norm.py:71"),
    ("flash_attention", "unet 14^2 self hd160", "psg_tpu_torch/csrc/flash_attention.cu",
     "psg_tpu/ops/flash_attention.py:108"),
    ("spatial_xattn", "vae 215^2 C32 cold heads", "psg_tpu_torch/csrc/spatial_xattn.cu",
     "psg_tpu/ops/spatial_xattn.py:163"),
)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", help="also write every phase's record here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the card only",
              file=sys.stderr)
        return 1
    if not (ROOT / "psg_tpu_torch" / "__init__.py").is_file():
        print(f"chip_smoke: psg_tpu_torch not found beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from psg_tpu_torch import ops
    from psg_tpu_torch.ops import cuda_build

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = card_line()
    print(card, flush=True)
    t = time.perf_counter()
    built = cuda_build.build_all(ops.KERNELS)
    emit("build", {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "seconds": time.perf_counter() - t,
                   "kernels": {k: {"built": v["built"], "seconds": v["seconds"],
                                   "ptxas": [ln.strip() for ln in
                                             v["nvcc_output"].splitlines()
                                             if "registers" in ln or "spill" in ln]}
                               for k, v in built.items()}})

    t = time.perf_counter()
    results = [run_case(c) for c in main_path_cases()]
    emit("kernels_vs_plain", {"card": card, "seconds": time.perf_counter() - t,
                              "cases": results})
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(
            f"{r['name']} {r['dtype']} err {r['max_abs_err']:.3g}" for r in bad))

    t = time.perf_counter()
    emit("e2e_card_vs_cpu", {**phase_e2e_card_vs_cpu(),
                             "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    serve = phase_serve_full_width()
    emit("serve_full_width", {"card": card, **serve, "seconds": time.perf_counter() - t})

    by_name = {(r["kernel"], r["name"], r["dtype"]): r for r in results}
    kernels = []
    for kname, case, source, replaces in KERNEL_LINE:
        r = by_name[(kname, case, "bfloat16")]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "shape": case, "dtype": "bfloat16",
                        "launches": serve["launches"][kname],
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    REPORT["total_s"] = time.perf_counter() - t_start
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({**REPORT, "kernels": kernels}, indent=1))
    print(card_line(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
