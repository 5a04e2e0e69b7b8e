#!/usr/bin/env python3
"""Smoke test of psg_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  It
imports nothing of JAX or psg_tpu, exits non-zero at the first failure, and
prints one JSON line per phase:

1. ``build``    the card's name and power limit; the four kernel libraries
                built from ``psg_tpu_torch/csrc/`` (one nvcc each, in parallel),
                with ptxas's register and spill lines.  The bf16 kernels must
                hold tensor-core instructions (counted in ``cuobjdump -sass``:
                HGMMA in the flash forward, HMMA or HGMMA in the flash
                backward and the spatial kernel) and spill nothing.
2. ``kernels_vs_plain``  every kernel against its plain PyTorch version on
                the card at the full-width main path's shapes, in fp32 (TF32
                off) and bf16: max error against the stated tolerance, and
                device times of the kernel, the plain version and, where one
                PyTorch call computes the same function, that call (timed as
                a yardstick only; for the spatial block, which no one call
                computes, the composite matmul + SDPA + matmul + residual),
                beside the least time the card could take (bytes / 3.35 TB/s,
                operations / peak, and for the spatial block the exponentials
                of its live keys / the special-function unit's rate).  Device times come
                from CUDA events around the replay of a CUDA graph of many
                calls, so no host time is in them; ``call_ms`` is the
                wrapper's eager time per call, host included, and
                ``host_bound`` marks a case whose eager call takes over 1.5x
                its device time.  Then the flash backward kernel at the main
                path's training shapes (``FLASH_BWD_CASES``) against
                ``sdpa_backward_plain`` and autograd of ``sdpa_plain``: its
                device time beside its bound (five products), the plain
                autograd backward's and, as a yardstick,
                ``F.scaled_dot_product_attention``'s backward (each a CUDA
                graph of forward and backward less one of the forward).
3. ``e2e_card_vs_cpu``  the whole text -> sprite chain at a tiny config in
                fp32, the same parameters and draws on the card (kernels) and
                on the CPU (plain versions): DDIM and DPM-Solver++ from one
                initial latent; the four DDPM-family samplers with their
                per-step noises given; and the image+text path (a numpy image
                encoded, reparameterized and lerped with given noise, then one
                restart pass): image MAE <= 1e-3 each.
4. ``serve_full_width``  config/train_config.yaml (bf16, BERT-base, UNet
                320/640/1280/1280, full VAE, 215x215, text_len 128) with random
                weights from the config's seed: generate_batch of 4 prompts
                (DDIM 20 steps, CFG 2.0 with a negative prompt) and
                generate_from_text (DPM-Solver++ 10 steps) twice with one seed;
                the counted run starts from an empty UNet graph cache, so each
                batch shape's first evaluation captures its CUDA graph.
5. ``serve_paths_full_width``  the same generator, and a sprite corpus of 8
                made from a seed in a temporary directory (the config's CSV
                and image paths point there): generate_from_image_and_text on
                a 215x215 sprite of phase 4 (twice with one seed, once with
                another), generate_from_text with one restart pass,
                generate_from_text_retrieval, generate_batch of 4 prompts
                seeded by retrieval, one request each with the renoise, ddpm,
                fast and x0 samplers (7 steps, which the fast and x0 tables
                turn into 8 UNet evaluations), and one request from a second
                generator whose CFG negative is the corpus's mean caption.
6. ``train``   stage-2 training.  (a) GN+SiLU and flash attention through
                their autograd Functions (kernel forward; the flash backward
                kernel, GN+SiLU's plain autograd backward) against plain
                autograd at the UNet's training shapes and the SD UNet's
                27^2 level at batch 32, bf16 and fp32.  (b) A tiny trainer
                on the card against one on the CPU (fp32, TF32 off), the same
                parameters, batches and draws: the first step's loss and
                gradients, the parameters and EMA after 3 steps.  (c)
                config/train_config.yaml at full width (batch 32) on 128
                sprites made from a seed, with the native augmentation engine
                (it fails if that did not build), the frozen VAE and text
                encoder from phase 7's stage-1 checkpoint: the trainer's
                train_epoch (3 steps), validate, generate_samples (DDIM 10)
                and save_checkpoint_fast (the light bf16 best); then the hub
                resolves both checkpoints and the serving generator serves one
                DPM-10 request from them.  It reports the step wall after the
                first step, samples/s, peak memory, the losses and the
                launches of each part against ``predicted_train_launches``
                (the flash backward kernel once for each attention call
                whose q, k or v needs a gradient).
7. ``stage1``   stage-1 training, run before phase 6c so that its stage 2
                trains from the stage-1 checkpoint.  (a) The spatial block
                through ``SpatialXattn`` (kernel forward, the fp32 body
                recomputed in chunks of rows backward) against plain autograd
                of the fp32 body at the decoder's two 215^2 sites at batch
                32, bf16 and fp32, prompt masks and cold heads; the main case
                timed against its plain version and its bound.  (b) A tiny
                stage-1 trainer on the card against one on the CPU (fp32), 3
                steps: losses, the first step's gradients, the parameters.
                (c) config/train_config.yaml at full width (batch 32, 215^2,
                BERT-base 'minimal', VGG16 perceptual loss) on the 128
                sprites of phase 6c: train_epoch (3 steps), validate,
                generate_samples (the prior and reconstruction grids) and
                save_checkpoint; step wall, samples/s, peak memory, the
                backward's chunk of rows, and launches against
                ``predicted_stage1_launches``.
8. ``stage3``   stage-3 training, after phase 6c.  (a) FlashSDPA against
                plain autograd at CLIP ViT-B/32's vision shape [32,12,50,64]
                (no bias), bf16 and fp32.  (b) A tiny stage-3 trainer on the
                card against one on the CPU (fp32): a text-encoder step, the
                switch, two joint steps; losses, the first step's gradients
                (the decoder's nonzero, the UNet's zero), the parameters
                (the UNet's weight decay included), to phase 7b's bounds.
                (c) config/train_config.yaml at full width (batch 32, 215^2,
                BERT-base, the full VAE and UNet, a random ViT-B/32 CLIP on
                the WordPiece ids) on phase 6c's 128 sprites, the VAE and
                text encoder from phase 7's best and the UNet from phase
                6c's: train_epoch (3 steps) and validate in each phase with
                save_checkpoint after each (the bests, full states; stage
                3's periodic write is phase 10c's), generate_samples (DDIM
                10); the
                hub then resolves the final bundle and the serving generator
                serves one DPM-10 request from it (``loaded=final-bundle``).
                Step walls, samples/s, peak memory and seconds of each part,
                the checkpoints' bytes, and launches against
                ``predicted_stage3_launches``.
9. ``stage0``   MLM pretraining of the text tower.  (a) A tiny MLM trainer
                on the card against one on the CPU (BERT in fp32), 3 steps.
                (b) BERT-base at full width (bf16, batch 64, text_len 128)
                on the 128 sprites' captions and 8 variants each, one
                epoch: step wall, samples/s, peak memory, launches (flash
                only, one per BERT layer a step and a validation pass); the
                best warm-starts a full-width stage-1 text template.
10. ``fast_path``  the device-resident fast path.  (a) ``augment_batch`` and
                ``draw_minibatch`` on the card against the CPU with the same
                parameters at 215^2, batch 16, and one augment's device time.
                (b) The tiny config in fp32, card against CPU, draws made on
                the CPU: one fast epoch (3 steps, augmentation on) of each
                stage, stage 2 with caption variants encoded in the step,
                stage 3 across the switch, to phases 6b-8b's bounds.  (c)
                ``python -m psg_tpu_torch.train.cli --stage all --config
                config/r3_evidence.yaml`` in-process at full width (batch 16,
                EMA 0.9995, bf16 first moment, warmup-cosine, skip 5.0) on
                the 128 sprites, 2 epochs a stage, each stage handing the next
                its light best: per stage the step walls, one step's device
                time, one step's host-to-device copies (none allowed, counted
                at PyTorch's dispatcher), samples/s,
                peak memory, launches against ``predicted_fast_launches``,
                every checkpoint's bytes and seconds; then serving loads
                stage 3's light best as a final bundle and serves DPM-10.
11. ``sd``     the SD-1.5 UNet (``--use-diffusers`` stage 2).  (a) Flash
                attention (head dims 40, 80, 160; 27^2 self and cross on
                prompt-masked text keys) and GN+SiLU (27^2x960, 14^2x1920,
                4^2x2560) against their plain versions at batch 32 in bf16,
                with the same times and bounds as phase 2, and the flash
                backward kernel at the four attention shapes
                (``SD_BWD_CASES``) as phase 2 holds it.  (b) The tiny SD
                trainer (with the text projection) on the card against the
                CPU in fp32, 3 steps, to phase 6b's bounds.  (c)
                config/train_config.yaml at full width (SD-1.5, 768-d
                cross-attention, BERT-base 'minimal', the frozen full VAE and
                the text encoder from phase 7's best, the cosine schedule,
                bf16, batch 32) on the 128 sprites: train_epoch (3 steps),
                validate, one best write and generate_samples (8 prompts, 50
                x0-DDPM steps); step walls, samples/s, one step's device
                time, peak memory, the checkpoint's bytes and seconds, the
                parameter counts, and launches against
                ``predicted_sd_launches``.
12. ``scale_out``  ``psg_tpu_torch/parallel`` on a one-rank NCCL group
                (NCCL refuses two ranks on one card): (a) the group and a
                (1, 1) mesh; (b) the full-width stage-2 epoch (3 steps,
                validate, one full best write) on the mesh against the same
                epoch without one, to phase 6b's bounds (params judged
                where every step's gradient is determined, and no farther
                from the run without a mesh than a second such run is),
                and one profiled step whose NCCL all-reduce covers the
                gradient's 2.62 GB; (c) generate_batch on the mesh against
                phase 4's images; (d) ``graft_entry.entry()``, the
                full-width UNet forward at batch 4.  Step walls, the
                all-reduce's device ms, launches against the prediction.
13. ``checkpoints``  async checkpoint writes on phase 8c's full-width
                stage-3 trainer after the switch (its 9.2 GB full state):
                (a) a sync and an async file of the same state, one step
                run under the async write, must have one sha256 (and a
                light best likewise); (b) one epoch ending in a full best
                with the switch off and on: seconds ``save`` blocked, the
                write's own seconds, the step wall with and without a write
                in flight, the epoch wall, the host's peak RSS and pinned
                memory, and a real epoch's period projected with phase 8c's
                disk write; (c) a write that cannot land must raise at
                ``wait()``.  Its large files are pipes drained (and hashed)
                as they are written: the machine's disk takes at most 45 GiB
                of writes a call.  Launches against the prediction.
14. ``eval_scripts``  the evaluation and evidence scripts
                (``scripts/torch_eval_conditioning.py``,
                ``torch_recipe_sweep.py``, ``torch_ddim_evidence.py``) at
                full width on phase 6c's sprites and the checkpoints of
                phases 7c, 6c and 8c: (a) the eval over two seeds with the
                stamp, then a fresh ``build_generator`` must resolve the
                stamped checkpoint, and the eval at guidance 2 with the
                ``mean`` negative; (b) ``init=retrieval-loo`` and
                ``prompts=paraphrase``, which do not stamp; (c) a two-recipe
                sweep; (d) the DDIM grid from the stage-3 bundle; (e) the
                eval at the tiny config on the card against the CPU with the
                same draws.  Each request's wall and launches against the
                prediction, each sub-phase's peak memory and bytes written.
Phase 6c runs after phase 7: its frozen VAE and text encoder come from
phase 7's checkpoint, and serving resolves the pair.
In phases 4-9 images must be finite and of the right shape, a seed must
repeat its image, and every request's kernel launches must equal the count
the model's structure predicts (``predicted_launches``; a serving UNet
evaluation that captures its CUDA graph launches its kernels three times),
and its UNet graph counters the captures and replays that the requests'
batch shapes predict (``UNetGraphKeys``); each phase's counts are set to 0
just before its requests and read just after them.

Phase 2 holds GroupNorm+SiLU at the decoder's and the UNet's sites and, at
batch 1 and 4, at the VAE encoder's (107^2x32 with one channel a group,
53^2x64, 27^2x128).  Throughout, FlashSDPA's backward on the card must call
no plain version (``PlainInBackward``).  Then the card's name and power
limit, the ``kernels`` line (each kernel at its heaviest main-path shape,
with its launches summed over phases 4-14; the flash backward kernel at the
UNet's 14^2 hd-160 training shape; and the spatial kernel's gradient: its
Function's forward and backward at phase 7a's main case, launched in phase
7c's steps), and last ``{"ok": true, "device": {...}}``.
``--json PATH`` also writes every
phase's record to PATH.
"""

import argparse
import fcntl
import functools
import gc
import hashlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent
VOCAB = ROOT / "experiments" / "evidence_r5c_vae" / "vocab.txt"
CONFIG = ROOT / "config" / "train_config.yaml"

HBM_BYTES_PER_S = 3.35e12          # H100 SXM
PEAK_FLOPS = {torch.bfloat16: 989e12,   # dense tensor-core bf16
              torch.float32: 67e12}     # fp32 outside the tensor cores
EX2_PER_CLOCK_PER_SM = 16   # special-function unit, CUDA C Programming Guide, cc 9.0
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
# spatial cold heads, logits in the hundreds.  fp32: the scores' rounding
# and __expf's error grow with them.  bf16: kernel and plain version round
# q * scale to bf16 at the same point but sum q in other orders, so a q
# element can land one bf16 step apart (2^-8 of about 60), which moves one
# head's score by about 0.25 and that pixel's output by up to about 0.1.
COLD_TOL = {torch.float32: dict(rtol=2e-3, atol=2e-3),
            torch.bfloat16: dict(rtol=2e-2, atol=1e-1)}
E2E_MAE = 1e-3

REPORT = {}


def emit(phase, record):
    REPORT[phase] = record
    print(json.dumps({"phase": phase, **record}, separators=(",", ":")), flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def release():
    """Free what a phase left on the card.  A trainer whose step a phase
    wraps sits in a reference cycle (the wrapper closes over its bound
    step), which only the collector breaks; until then its parameters and
    moments would count in the next phase's peak memory."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------

# library, kernel name part, the tensor-core instructions one of which each
# such kernel must hold: the bf16 flash forward runs on Hopper's warpgroup
# products (HGMMA), the backward and the spatial kernel on mma.sync (HMMA)
TENSOR_CORE_KERNELS = (("flash_attention", "flash_bf16", ("HGMMA",)),
                       ("flash_attention_bwd", "_bf16", ("HMMA", "HGMMA")),
                       ("spatial_xattn", "spatial_xattn_tc", ("HMMA", "HGMMA")))


def spilled(nvcc_output, name_part):
    """Spill bytes (stores + loads) of every function whose name holds
    ``name_part``, from ptxas -v."""
    out, fn = {}, None
    for ln in nvcc_output.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn and name_part in fn:
            out[fn] = int(m.group(1)) + int(m.group(2))
    return out


def tensor_core_instructions(lib_path, name_part):
    """HMMA and HGMMA instructions in the SASS of each function whose name
    holds ``name_part`` (``cuobjdump -sass``)."""
    from psg_tpu_torch.ops import cuda_build

    sass = subprocess.run([cuda_build.cuda_tool("cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1) if name_part in m.group(1) else None
            if fn:
                counts[fn] = {"HMMA": 0, "HGMMA": 0}
            continue
        if fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", ln):
                    counts[fn][op] += 1
                    break
    return counts


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


@functools.lru_cache(maxsize=None)
def ex2_per_s():
    """Exponentials a second on the special-function units at the card's
    maximum SM clock (``nvidia-smi --query-gpu=clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return EX2_PER_CLOCK_PER_SM * sms * mhz * 1e6


def bound(nbytes, flops, flop_dtype, exps=0):
    """The least time in ms (bytes, tensor or fp32 operations, exponentials),
    what rules it ("bytes" or "operations") and each part."""
    parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "flops": flops / PEAK_FLOPS[flop_dtype] * 1e3}
    if exps:
        parts["exp"] = exps / ex2_per_s() * 1e3
    top = max(parts, key=parts.get)
    return parts[top], "bytes" if top == "bytes" else "operations", parts


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


@functools.lru_cache(maxsize=None)
def prompt_keys():
    """[4, 128] bool: the keys the four PROMPTS keep under the committed
    vocab (13, 12, 9 and 9), as serving's text mask gives them."""
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

    _ids, mask = WordPieceTokenizer.from_vocab_file(VOCAB).encode_batch(PROMPTS, 128)
    return torch.from_numpy(mask).cuda() > 0


def spatial_case(name, b, hw, c, s, cold, dtype, prompt_mask=False):
    from psg_tpu_torch.ops import spatial_xattn as sx

    heads, scale = 8, (c // 8) ** -0.5
    if prompt_mask:
        keep = prompt_keys()
    else:   # the last sample's prompt is a third of the text length
        keep = torch.ones(b, s, device="cuda", dtype=torch.bool)
        keep[-1, s // 3:] = False
    # keys whose probability is not exactly 0 (all S where none is live)
    live = [n or s for n in keep.sum(1).tolist()]

    def make(seed):
        xn = _randn((b, hw * hw, c), seed, dtype)
        res = _randn((b, hw * hw, c), seed + 1, dtype)
        k, v = _randn((b, s, c), seed + 2), _randn((b, s, c), seed + 3)
        # cold heads: Q scaled x120 so head logits span hundreds and a
        # shared row max would underflow the cold heads' exp()
        wq = _randn((c, c), seed + 4, scale=c ** -0.5 * (120.0 if cold else 1.0))
        wp = _randn((c, c), seed + 5, scale=c ** -0.5)
        bq, bp = _randn((c,), seed + 6, scale=0.1), _randn((c,), seed + 7, scale=0.1)
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

    def composite(xn, res, k, v, wq, bq, wp, bp, bias):
        """The block as PyTorch calls: matmul, SDPA with the key mask,
        matmul and the residual (a yardstick; no one call computes it)."""
        q = (torch.matmul(xn, wq.to(dtype)) + bq.to(dtype)).view(b, -1, heads, c // heads)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), sx.split_heads(k.to(dtype), heads, False),
            sx.split_heads(v.to(dtype), heads, False), attn_mask=bias.to(dtype))
        o = o.transpose(1, 2).reshape(b, -1, c)
        return torch.matmul(o, wp.to(dtype)) + bp.to(dtype) + res

    xn, res, k, v, wq, bq, wp, bp, bias = make(0)
    return dict(kernel_name="spatial_xattn", name=name, dtype=dtype, make=make,
                kernel=kernel, plain=plain, library=None, composite=composite,
                tol=COLD_TOL[dtype] if cold else TOL[dtype],
                bytes=3 * nbytes(xn) + nbytes(k, v, wq, bq, wp, bp, bias),
                # per pixel: the two projections, and scores and P.V over the
                # live keys; one exponential a head and live key
                flops=hw * hw * sum(4 * c * c + 4 * n * c for n in live), flop_dtype=dtype,
                exps=hw * hw * heads * sum(live))


def spatial_cases(dtype):
    """The spatial kernel's phase-2 cases: the decoder's two fused sites
    with the last sample's prompt a third of the text, cold heads, and the
    serving path's prompt masks."""
    return [spatial_case("vae 108^2 C64", 4, 108, 64, 128, False, dtype),
            spatial_case("vae 215^2 C32", 4, 215, 32, 128, False, dtype),
            spatial_case("vae 215^2 C32 cold heads", 4, 215, 32, 128, True, dtype),
            spatial_case("vae 108^2 C64 prompt mask", 4, 108, 64, 128, False, dtype,
                         prompt_mask=True),
            spatial_case("vae 215^2 C32 prompt mask", 4, 215, 32, 128, False, dtype,
                         prompt_mask=True)]


def flash_cases(dtype):
    """The flash kernel's phase-2 cases: (B, H, Lq, Lk, D, masked) of the
    main path."""
    return [flash_case(name, *shape, dtype) for name, shape in (
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
        ("vae 54^2 xattn hd16", (4, 8, 2916, 128, 16, True)),
        ("clip vision L50 hd64", (*CLIP_VISION, False)))]


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
        for hw, c in ((107, 32), (53, 64), (27, 128)):   # the VAE encoder
            for b in (1, 4):
                cases.append(gn_case(f"vae enc {hw}^2x{c} G32 b{b}", b, hw, c, 32, dtype))
        cases += flash_cases(dtype)
        cases += spatial_cases(dtype)
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
    lib_ms = composite_ms = None
    if case["library"] is not None:
        lib_ms = device_ms(case["library"], sets, 20)
    if case.get("composite") is not None:
        composite_ms = device_ms(case["composite"], sets, 10)
    b_ms, b_by, b_parts = bound(case["bytes"], case["flops"], case["flop_dtype"],
                                case.get("exps", 0))
    kernel_ms = device_ms(case["kernel"], sets, 30)
    call_ms = time_ms(case["kernel"], sets, 30)
    rec = dict(kernel=case["kernel_name"], name=case["name"],
               dtype=str(case["dtype"]).replace("torch.", ""), max_abs_err=err,
               rtol=case["tol"]["rtol"], atol=case["tol"]["atol"], ok=bool(ok),
               kernel_ms=kernel_ms, call_ms=call_ms,
               host_bound=call_ms > 1.5 * kernel_ms,
               plain_ms=device_ms(case["plain"], sets, 10), library_ms=lib_ms,
               composite_ms=composite_ms, bound_ms=b_ms, bound_by=b_by,
               bound_parts_ms=b_parts)
    del sets, got, ref
    torch.cuda.empty_cache()   # the graphs' memory pools
    return rec


# The flash backward kernel's cases: the main path's training shapes (the
# UNet's GRAD_FLASH at batch 32, BERT-base and CLIP's vision tower, which
# hand the kernel fp32 in bf16 training) and, in phase 11, the SD UNet's.
FLASH_BWD_CASES = (
    ("unet 14^2 self hd160 b32", (32, 4, 196, 196, 160, False), torch.bfloat16),
    ("unet 14^2 cross hd160 b32", (32, 4, 196, 128, 160, True), torch.bfloat16),
    ("unet 7^2 self hd320 b32", (32, 4, 49, 49, 320, False), torch.bfloat16),
    ("unet 4^2 cross hd320 b32", (32, 4, 16, 128, 320, True), torch.bfloat16),
    ("bert self L128 hd64 b32", (32, 12, 128, 128, 64, True), torch.float32),
    ("clip vision L50 hd64 b32", (32, 12, 50, 50, 64, False), torch.float32),
    ("clip vision L50 hd64 b32", (32, 12, 50, 50, 64, False), torch.bfloat16),
)


def run_flash_bwd_case(name, b, h, lq, lk, d, masked, dtype):
    """The backward kernel at one shape: against sdpa_backward_plain on the
    forward kernel's output and logsumexp and against autograd of
    sdpa_plain (``TOL``); its device time (a CUDA graph's replay) beside
    its bound (five products, 10 B H Lq Lk D operations; q, k, v, o, dO,
    the logsumexp and the bias read once, dq, dk, dv written once; one
    exponential a score), the plain autograd backward's device time and,
    as a yardstick only, F.scaled_dot_product_attention's backward: each a
    graph of forward and backward less a graph of the forward alone."""
    from psg_tpu_torch.ops import flash_attention as fa

    scale = d ** -0.5
    q, k, v, bias = flash_case(name, b, h, lq, lk, d, masked, dtype)["make"](0)
    gy = _randn((b, lq, h, d), 5, dtype).transpose(1, 2)   # the heads' merge hands it back
    key_bias = fa._key_bias(bias, b, lk)
    o, lse = fa._launch(q, k, v, key_bias, scale, lse=True)
    got = fa._launch_bwd(q, k, v, o, gy, lse, key_bias, scale)
    plain = fa.sdpa_backward_plain(q, k, v, o, gy, lse, bias, scale)
    xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    auto = torch.autograd.grad(fa.sdpa_plain(*xs, bias=bias, scale=scale), xs, gy)
    torch.cuda.synchronize()
    errs = [max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
            for ref in (plain, auto)]
    ok = all(torch.isfinite(g.float()).all()
             and torch.allclose(g.float(), r.float(), **TOL[dtype])
             for ref in (plain, auto) for g, r in zip(got, ref))
    del plain, auto
    kernel_ms = device_ms(lambda: fa._launch_bwd(q, k, v, o, gy, lse, key_bias, scale), [()],
                          20)
    call_ms = time_ms(lambda: fa._launch_bwd(q, k, v, o, gy, lse, key_bias, scale), [()], 20)

    def backward_ms(fwd, reps):
        both = device_ms(lambda: torch.autograd.grad(fwd(*xs), xs, gy), [()], reps)
        return both - device_ms(lambda: fwd(*xs), [()], reps)

    plain_ms = backward_ms(lambda q, k, v: fa.sdpa_plain(q, k, v, bias=bias, scale=scale), 3)
    mask = None if bias is None else bias.to(dtype)
    lib_ms = backward_ms(lambda q, k, v: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, scale=scale), 10)
    flops = 10 * b * h * lq * lk * d
    b_ms, b_by, b_parts = bound(nbytes(q, k, v, o, gy, lse, key_bias) + nbytes(q, k, v),
                                flops, dtype, exps=b * h * lq * lk)
    rec = dict(kernel="flash_attention_bwd", name=name, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=max(errs), max_abs_err_vs_plain_algorithm=errs[0],
               max_abs_err_vs_autograd=errs[1], rtol=TOL[dtype]["rtol"],
               atol=TOL[dtype]["atol"], ok=bool(ok), kernel_ms=kernel_ms, call_ms=call_ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
               bound_parts_ms=b_parts)
    del q, k, v, o, lse, got, xs
    torch.cuda.empty_cache()
    return rec


def run_flash_bwd_cases(cases):
    recs = [run_flash_bwd_case(name, *shape, dtype) for name, shape, dtype in cases]
    bad = [r for r in recs if not r["ok"]]
    if bad:
        fail("the flash backward kernel disagrees with its plain version: " + "; ".join(
            f"{r['name']} {r['dtype']} err {r['max_abs_err']:.3g}" for r in bad))
    return recs


class PlainInBackward:
    """Counts calls of the flash plain versions made inside FlashSDPA's
    backward (on the card that backward launches the kernel and must call
    none of them).  Installed for the whole run."""

    NAMES = ("sdpa_plain", "sdpa_lse_plain", "sdpa_backward_plain", "_plain")

    def __init__(self):
        from psg_tpu_torch.ops import flash_attention as fa

        self.calls, self.inside = 0, False
        for name in self.NAMES:
            real = getattr(fa, name)

            def counted(*a, _real=real, **kw):
                self.calls += self.inside
                return _real(*a, **kw)
            setattr(fa, name, counted)
        backward = fa.FlashSDPA.backward

        def watched(ctx, grad, _orig=backward):
            self.inside = True
            try:
                return _orig(ctx, grad)
            finally:
                self.inside = False
        fa.FlashSDPA.backward = staticmethod(watched)

    def check(self, where):
        if self.calls:
            fail(f"{where}: FlashSDPA's backward called a plain version {self.calls} "
                 f"times on the card")
        return {"plain_calls_in_flash_backward": self.calls}


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


def unet_evals(gen, sampler, steps):
    """UNet evaluations of one chain: the sampler's own timestep table."""
    from psg_tpu_torch.diffusion import sampling

    T = gen.schedule.num_timesteps
    if sampler in ("ddim", "dpmpp"):
        return min(steps, T)
    if sampler == "fast":
        return len(sampling.fast_timesteps(T, sampling.fast_stride(T, steps)))
    return len({"ddpm": sampling.ddpm_timesteps, "x0": sampling.x0_timesteps,
                "renoise": sampling.renoise_timesteps}[sampler](T, steps))


def unet_graph_counts():
    """The counters of the serving UNet's CUDA graphs (``models.unet``)."""
    from psg_tpu_torch.utils import profiling

    counts = profiling.counts()
    return {k: counts.get(f"unet_graph.{k}", 0) for k in ("capture", "replay", "eager")}


def graph_delta(before):
    """``unet_graph_counts()`` now, less ``before``."""
    return {k: v - before[k] for k, v in unet_graph_counts().items()}


class UNetGraphKeys:
    """What a generator's UNet graph cache does, kept from its requests'
    structure alone: an evaluation's key is its UNet batch, the request's
    prompts and twice that under fused CFG (DDIM and DPM++ at a guidance
    above 0); the text is padded to ``text_len`` and the dtypes are the
    generator's.  The cache holds the last ``_GRAPHS_KEPT`` keys used.  A
    request's first evaluation at a key the cache lacks captures its graph,
    every other replays one; a generator without a cache counts nothing."""

    def __init__(self, gen):
        from psg_tpu_torch.models.unet import _GRAPHS_KEPT

        self.gen, self.kept, self.keys = gen, _GRAPHS_KEPT, []

    def request(self, sampler, n_prompts, n_unet_evals):
        """The ``unet_graph`` counts of one request: ``n_unet_evals``
        evaluations of ``sampler`` over ``n_prompts`` prompts."""
        if self.gen.unet_graphs is None or not n_unet_evals:
            return {"capture": 0, "replay": 0, "eager": 0}
        guided = sampler in ("ddim", "dpmpp") and self.gen.guidance_scale > 0
        key = n_prompts * (2 if guided else 1)
        capture = int(key not in self.keys)
        if not capture:
            self.keys.remove(key)
        elif len(self.keys) == self.kept:
            self.keys.pop(0)
        self.keys.append(key)
        return {"capture": capture, "replay": n_unet_evals - capture, "eager": 0}


def predicted_launches(gen, n_unet_evals, *, text_encodes=1, encodes=0, decodes=1,
                       captures=0):
    """Kernel launches of one request, from the model's structure: per UNet
    evaluation two GN+SiLU per ResBlock plus the final norm, and two
    attention calls per attention block; per text encode (each chain's
    prompts, the retrieval index in batches of 64, each retrieval query) one
    attention per BERT layer; per VAE encode two GN+SiLU per ResNet block
    (14); per decode two GN+SiLU per ResNet block plus the final norm, and
    one spatial attention per decoder block (the fused kernel at the widths
    it is built for, else the flash kernel).  A serving UNet evaluation
    replayed from its CUDA graph launches these kernels from the host as an
    eager one does; one of the ``captures`` launches them three times: its
    eager warm-up, the capture's calls left out of the graph, and the first
    replay."""
    from psg_tpu_torch.models.vae import _DEC_BLOCKS, _ENC_DOWN, _ENC_RES, width_scale
    from psg_tpu_torch.ops.spatial_xattn import CHANNELS

    n_unet_evals += 2 * captures
    unet_gn = unet_attn = 0
    if n_unet_evals:
        spec = gen.spec
        nlvl, bpl = len(spec.channels), spec.blocks_per_level
        unet_gn = 2 * (2 * nlvl * bpl + 1) + 1
        unet_attn = 2 * (2 * bpl * sum(spec.attention_levels) + 1)
    enc_gn = 2 * (len(_ENC_DOWN) + len(_ENC_RES))
    widths = [width_scale(cout, gen.cfg.model.vae_width_scale)
              for _cin, cout, _up in _DEC_BLOCKS]
    fused = sum(w in CHANNELS for w in widths)
    return {"group_norm_silu": (n_unet_evals * unet_gn + encodes * enc_gn
                                + decodes * (4 * len(_DEC_BLOCKS) + 1)),
            "flash_attention": (text_encodes * gen.bert_cfg.num_layers
                                + n_unet_evals * unet_attn + decodes * (len(widths) - fused)),
            "spatial_xattn": decodes * fused,
            "flash_attention_bwd": 0}


def forward_only(pred):
    """A prediction for a pass without gradient (validation, sampling):
    its forward launches and no backward kernel."""
    return {**pred, "flash_attention_bwd": 0}


def forward_kernels(counts):
    """The counts of the forward kernels only (a request launches no
    backward)."""
    return {k: v for k, v in counts.items() if k != "flash_attention_bwd"}


def with_flash_backward(pred, n):
    """A training step's prediction: its forward launches and ``n``
    launches of the flash backward kernel, one for each attention call
    whose q, k or v needs a gradient."""
    return {**pred, "flash_attention_bwd": n}


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
    rng = np.random.RandomState(1)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32))

    lat = tuple(latent.shape[1:])
    noises = {s: randn(unet_evals(cpu, s, 4), 2, *lat) for s in ("ddpm", "fast", "x0",
                                                                 "renoise")}
    image = torch.from_numpy(rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32))
    init_draws, restart_draws = [randn(2, *lat), randn(2, *lat)], [randn(2, *lat),
                                                                   randn(2, *lat)]

    def chain(gen, name, dev):
        """One tiny chain on ``gen``, its inputs and draws moved by ``dev``:
        a sampler from the initial latent (the DDPM family with its per-step
        noises), or the image+text path with one restart pass."""
        i, m, x = dev(ids), dev(mask), dev(latent)
        if name in ("ddim", "dpmpp"):
            return gen._generate_impl(gen.params, None, i, m, x, steps=4, num=2,
                                      sampler=name)
        if name in noises:
            return gen._generate_impl(gen.params, None, i, m, x, steps=4, num=2,
                                      sampler=name, noises=dev(noises[name]))
        return gen._serve(i, m, None, steps=4, num=2, sampler="ddim",
                          init_images=dev(image), init_strength=0.7, restarts=1,
                          restart_strength=0.9,
                          draws={"init": [dev(t) for t in init_draws],
                                 "restarts": [[dev(t) for t in restart_draws]]})

    out = {}
    for name in ("ddim", "dpmpp", *noises, "image+text, 1 restart"):
        ref = chain(cpu, name, lambda t: t)
        ops.reset_launch_counts()
        got = chain(card, name, lambda t: t.cuda()).float().cpu()
        counts = ops.launch_counts()
        mae = (got - ref).abs().mean().item()
        out[name] = {"image_mae": mae, "max_abs": (got - ref).abs().max().item(),
                     "launches": counts}
        if got.shape != (2, 64, 64, 3) or not torch.isfinite(got).all():
            fail(f"tiny e2e {name}: bad output {tuple(got.shape)}")
        if not mae <= E2E_MAE:
            fail(f"tiny e2e {name}: card vs CPU image MAE {mae} > {E2E_MAE}")
        if min(forward_kernels(counts).values()) == 0 or counts["flash_attention_bwd"]:
            fail(f"tiny e2e {name}: a forward kernel was not launched, or a "
                 f"backward was: {counts}")
    return {"bound": E2E_MAE, **out}


def full_width_config(corpus):
    """config/train_config.yaml with the data paths on ``corpus``."""
    from psg_tpu_torch.core.config import load_config

    csv, image_dir = corpus
    return load_config(CONFIG, [f"data.csv_path={csv}", f"data.image_dir={image_dir}"])


def phase_serve_full_width(corpus):
    from psg_tpu_torch import ops
    from psg_tpu_torch.models.unet import UNetGraphs
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

    cfg = full_width_config(corpus)
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
    # the counted run captures its graphs: it starts from an empty cache
    gen.unet_graphs = UNetGraphs(gen.params["unet"], gen.spec)
    keys = UNetGraphKeys(gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()

    requests = []
    expected = {k: 0 for k in ops.launch_counts()}
    ops.reset_launch_counts()   # the main path's counted run starts here

    def serve(kind, fn, sampler, n_prompts, n_unet_evals):
        want_graphs = keys.request(sampler, n_prompts, n_unet_evals)
        before, g0 = ops.launch_counts(), unet_graph_counts()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {k: v - before[k] for k, v in ops.launch_counts().items()}
        graphs = graph_delta(g0)
        want = predicted_launches(gen, n_unet_evals, captures=want_graphs["capture"])
        for k in expected:
            expected[k] += want[k]
        requests.append({"request": kind, "wall_s": wall, "launches": got,
                         "predicted": want, "unet_graphs": graphs})
        if got != want:
            fail(f"{kind}: kernel launches {got} != predicted {want}")
        if graphs != want_graphs:
            fail(f"{kind}: UNet graphs {graphs} != predicted {want_graphs}")
        return result

    steps_batch, steps_one = 20, 10
    imgs = serve(f"generate_batch n=4 ddim {steps_batch} steps cfg",
                 lambda: gen.generate_batch(PROMPTS, steps_batch, seed=0,
                                            sampler="ddim"), "ddim", len(PROMPTS), steps_batch)
    a = serve(f"generate_from_text dpmpp {steps_one} steps cfg",
              lambda: np.asarray(gen.generate_from_text(PROMPTS[1], steps_one, seed=1)),
              "dpmpp", 1, steps_one)
    b = serve(f"generate_from_text dpmpp {steps_one} steps cfg (same seed)",
              lambda: np.asarray(gen.generate_from_text(PROMPTS[1], steps_one, seed=1)),
              "dpmpp", 1, steps_one)
    launches = ops.launch_counts()   # ... and ends here
    if imgs.shape != (4, 215, 215, 3) or not np.isfinite(imgs).all():
        fail(f"generate_batch: bad images {imgs.shape}")
    if a.shape != (215, 215, 3):
        fail(f"generate_from_text: bad image {a.shape}")
    if not np.array_equal(a, b):
        fail("generate_from_text: the same seed gave a different image")
    if launches != expected or min(forward_kernels(launches).values()) == 0:
        fail(f"main path launches {launches} != predicted {expected}")
    record = {"params": n_params, "init_s": init_s, "requests": requests,
              "launches": launches, "image_std": float(imgs.std()),
              "resident_gb": resident / 1e9,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return record, gen, keys, imgs


def phase_serve_paths_full_width(gen, keys, corpus, sprites):
    """The rest of serving at full width: image+text, restarts, retrieval
    seeding (single and batched), the four DDPM-family samplers and the
    ``mean`` negative, each request's launches and UNet graph counts held
    to their prediction (``keys``: phase 4's ``UNetGraphKeys`` of ``gen``)."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.data.dataset import read_description_csv
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
    from psg_tpu_torch.utils.images import tensor_to_pil

    t0 = time.perf_counter()
    mean_gen = PokemonGenerator(full_width_config(corpus),
                                tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                                sampler="dpmpp", guidance_scale=2.0, negative="mean",
                                device="cuda")
    mean_init_s = time.perf_counter() - t0
    size = gen.cfg.data.image_size
    sprite = tensor_to_pil(sprites[0])
    if sprite.size != (size, size):
        fail(f"phase 4's sprite is {sprite.size}, not {size}x{size}")
    # warm-up of the encoder's convolutions (cuDNN picks its kernels)
    for b in (1, 4):
        gen._encode_impl(gen.params, torch.Generator(device=gen.device).manual_seed(0),
                         torch.zeros(b, size, size, 3, device=gen.device))
    gen.generate_from_image_and_text(sprite, PROMPTS[2], 2, 0.7, seed=100)
    keys.request(gen.sampler_name, 1, unet_evals(gen, gen.sampler_name, 2))
    mean_keys = UNetGraphKeys(mean_gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the serving generator builds its retrieval index inside the first
    # retrieval request: one text encode per 64 captions
    n_corpus = len(read_description_csv(corpus[0]))
    index_encodes = math.ceil(n_corpus / 64)
    steps = 10
    requests = []
    expected = {k: 0 for k in ops.launch_counts()}
    ops.reset_launch_counts()   # this path's counted run starts here

    def serve(kind, fn, sampler, n_prompts, n_unet_evals, on=gen, **structure):
        want_graphs = (keys if on is gen else mean_keys).request(sampler, n_prompts,
                                                                 n_unet_evals)
        before, g0 = ops.launch_counts(), unet_graph_counts()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        got = {k: v - before[k] for k, v in ops.launch_counts().items()}
        graphs = graph_delta(g0)
        want = predicted_launches(gen, n_unet_evals, captures=want_graphs["capture"],
                                  **structure)
        for k in expected:
            expected[k] += want[k]
        requests.append({"request": kind, "wall_s": wall, "unet_evals": n_unet_evals,
                         "launches": got, "predicted": want, "unet_graphs": graphs})
        if got != want:
            fail(f"{kind}: kernel launches {got} != predicted {want}")
        if graphs != want_graphs:
            fail(f"{kind}: UNet graphs {graphs} != predicted {want_graphs}")
        return np.asarray(result, np.float32)

    dpm = gen.sampler_name
    evals = unet_evals(gen, dpm, steps)
    it = [serve(f"generate_from_image_and_text dpmpp {steps} steps cfg, seed {sd}",
                lambda sd=sd: gen.generate_from_image_and_text(sprite, PROMPTS[0], steps,
                                                               0.7, seed=sd),
                dpm, 1, evals, encodes=1) for sd in (5, 5, 6)]
    restart = serve(f"generate_from_text dpmpp {steps} steps cfg, 1 restart",
                    lambda: gen.generate_from_text(PROMPTS[1], steps, seed=7, restarts=1),
                    dpm, 1, 2 * evals, text_encodes=2, encodes=1, decodes=2)
    retr = serve(f"generate_from_text_retrieval dpmpp {steps} steps cfg "
                 f"(index of {n_corpus} captions built)",
                 lambda: gen.generate_from_text_retrieval(PROMPTS[2], steps, seed=8,
                                                          strength=0.85),
                 dpm, 1, evals, text_encodes=index_encodes + 2, encodes=1)
    batch = serve(f"generate_batch n=4 ddim {steps} steps cfg init=retrieval",
                  lambda: gen.generate_batch(PROMPTS, steps, seed=9, sampler="ddim",
                                             init="retrieval"),
                  "ddim", len(PROMPTS), unet_evals(gen, "ddim", steps),
                  text_encodes=len(PROMPTS) + 1, encodes=1)
    by_sampler = {}
    for sampler in ("renoise", "ddpm", "fast", "x0"):
        by_sampler[sampler] = serve(
            f"generate_batch n=1 {sampler} 7 steps (unguided)",
            lambda sampler=sampler: gen.generate_batch(PROMPTS[3:], 7, seed=10,
                                                       sampler=sampler),
            sampler, len(PROMPTS[3:]), unet_evals(gen, sampler, 7))
    mean = serve(f"generate_from_text dpmpp {steps} steps cfg, mean negative",
                 lambda: mean_gen.generate_from_text(PROMPTS[1], steps, seed=7),
                 mean_gen.sampler_name, 1, evals, on=mean_gen)
    launches = ops.launch_counts()   # ... and ends here

    one = (size, size, 3)
    for name, img, shape in [("image+text", it[0], one), ("restart", restart, one),
                             ("retrieval", retr, one),
                             ("batch retrieval", batch, (len(PROMPTS), *one)),
                             ("mean negative", mean, one)] + [
            (s, img, (1, *one)) for s, img in by_sampler.items()]:
        if img.shape != shape or not np.isfinite(img).all():
            fail(f"{name}: bad image {img.shape}")
    if not np.array_equal(it[0], it[1]) or np.array_equal(it[0], it[2]):
        fail("generate_from_image_and_text: a seed did not repeat its image, or "
             "another seed gave the same one")
    if launches != expected or min(forward_kernels(launches).values()) == 0:
        fail(f"serve paths launches {launches} != predicted {expected}")
    record = {"mean_negative_init_s": mean_init_s, "corpus": n_corpus,
              "requests": requests, "launches": launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del mean_gen
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# phase 6: stage-2 training
# ---------------------------------------------------------------------------

GRAD_GN = ((27, 320), (27, 640), (14, 1280), (7, 2560), (4, 2560))
GRAD_FLASH = (("unet 14^2 self hd160", (32, 4, 196, 196, 160, False)),
              ("unet 14^2 cross hd160", (32, 4, 196, 128, 160, True)),
              ("unet 7^2 self hd320", (32, 4, 49, 49, 320, False)),
              ("unet 4^2 cross hd320", (32, 4, 16, 128, 320, True)),
              # the SD UNet's 27^2 level (--use-diffusers), its heaviest backward
              ("sd 27^2 self hd40", (32, 8, 729, 729, 40, False)),
              ("sd 27^2 cross hd40", (32, 8, 729, 128, 40, True)))
# card against CPU on the tiny config (fp32, TF32 off), same params and draws.
# The gradients' bound is per leaf, 1e-3 * max|g| + 1e-6 (cuDNN and CPU
# convolutions sum in other orders); params after 3 AdamW steps at lr 3e-4
# within 1e-4, a third of one step's size.
TRAIN_LOSS_RTOL, TRAIN_GRAD_RTOL, TRAIN_PARAM_ATOL = 1e-4, 1e-3, 1e-4
FULL_STEPS = 3          # train steps of the full-width epoch: 128 sprites, batch 32


def _grad_case(fn, plain, inputs, gy, dtype):
    """max |kernel - plain| over the output and every input's gradient,
    through the autograd Function (kernel forward) and through autograd of
    the plain version."""
    def run(f):
        xs = [t.detach().clone().requires_grad_(True) for t in inputs]
        out = f(*xs)
        out.backward(gy)
        return [out.detach()] + [t.grad for t in xs]

    got, ref = run(fn), run(plain)
    torch.cuda.synchronize()
    err = max((g.float() - r.float()).abs().max().item() for g, r in zip(got, ref))
    ok = all(torch.isfinite(g.float()).all() and torch.allclose(g.float(), r.float(),
                                                                **TOL[dtype])
             for g, r in zip(got, ref))
    return {"max_abs_err": err, **TOL[dtype], "ok": bool(ok)}


def phase_train_gradients():
    """(a) GN+SiLU and flash attention through their autograd Functions on
    the kernels against autograd of the plain versions, at the UNet's
    training shapes at batch 32."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.ops import flash_attention, fused_norm

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).replace("torch.", "")
        for hw, c in GRAD_GN:
            x = _randn((32, hw * hw, c), 0, dtype, scale=2.0, shift=0.3)
            sc, bi = _randn((c,), 1, scale=0.3, shift=1.0), _randn((c,), 2, scale=0.1)
            rec = _grad_case(
                lambda x, s, b: ops.group_norm_silu({"scale": s, "bias": b}, x, 32),
                lambda x, s, b: fused_norm.group_norm_silu_plain({"scale": s, "bias": b},
                                                                 x, 32),
                (x, sc, bi), _randn(x.shape, 3, dtype), dtype)
            cases.append({"kernel": "group_norm_silu", "name": f"unet {hw}^2x{c} b32",
                          "dtype": name, **rec})
        for case, (b, h, lq, lk, d, masked) in GRAD_FLASH:
            q, k, v = (_randn((b, h, n, d), i, dtype) for i, n in enumerate((lq, lk, lk)))
            bias = None
            if masked:
                keep = torch.ones(b, lk, device=q.device, dtype=torch.bool)
                keep[-1, lk // 3:] = False
                bias = torch.where(keep, 0.0, -1e9).float()[:, None, None, :]
            # the gradient as the heads' merge hands it back: non-contiguous
            gy = _randn((b, lq, h, d), 3, dtype).transpose(1, 2)
            rec = _grad_case(lambda q, k, v: ops.sdpa(q, k, v, bias=bias),
                             lambda q, k, v: flash_attention.sdpa_plain(
                                 q, k, v, bias=bias, scale=d ** -0.5),
                             (q, k, v), gy, dtype)
            cases.append({"kernel": "flash_attention", "name": f"{case} b32", "dtype": name,
                          **rec})
    torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail("gradient through a kernel's Function disagrees with plain autograd: "
             + "; ".join(f"{c['name']} {c['dtype']} err {c['max_abs_err']:.3g}" for c in bad))
    return {"cases": cases}


def _dropout_masks(rs, spec, batch, rate):
    """Keep masks for every UNet block (models/unet.py), from numpy."""
    from psg_tpu_torch.models.unet import unet_block_count

    nlvl, bpl = len(spec.channels), spec.blocks_per_level
    levels = ([(lvl, spec.attention_levels[lvl]) for lvl in range(nlvl) for _ in range(bpl)]
              + [(nlvl - 1, True)]
              + [(lvl, spec.attention_levels[lvl]) for lvl in reversed(range(nlvl))
                 for _ in range(bpl)])
    assert len(levels) == unet_block_count(spec)
    out = []
    for lvl, attn in levels:
        c, n = spec.channels[lvl], spec.spatial[lvl] ** 2
        head = (batch, spec.num_heads, n, c // spec.num_heads)
        out.append(tuple(torch.from_numpy(rs.uniform(size=s) < 1.0 - rate)
                         for s in (head, head, (batch, n, c))) if attn else None)
    return out


def _tiny_train_config(exp, corpus):
    cfg = tiny_config()
    cfg.experiment_dir = str(exp)
    cfg.data.csv_path, cfg.data.image_dir = map(str, corpus)
    cfg.data.batch_size = 2
    cfg.data.num_workers = 2
    cfg.optimization.ema_decay = 0.99
    cfg.extra = {"snr_gamma": 5.0, "cond_dropout": 0.5}
    return cfg


def phase_train_card_vs_cpu(tmp):
    """(b) One tiny trainer on the CPU (plain versions) and one on the card
    (kernels), the same parameters, batches and draws: the first step's loss
    and gradients, then the parameters after 3 steps."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.nn.layers import prepare_weights
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

    corpus = write_sprite_corpus(Path(tmp) / "tiny_corpus", n=12, seed=0, size=64)
    cfg = _tiny_train_config(Path(tmp) / "tiny_exp", corpus)
    cpu = DiffusionTrainer(cfg, None, experiment_name="cpu", device="cpu")
    card = DiffusionTrainer(cfg, None, experiment_name="card", device="cuda")
    card.frozen = prepare_weights(bridge.fit(card.frozen, cpu.frozen))
    card.state = card._fresh_state(bridge.fit(card.state.params, cpu.state.params), step=0,
                                   rng=card.state.rng)
    rs = np.random.RandomState(0)
    batches = [next(iter(cpu.train_loader)) for _ in range(3)]
    b, lat = cfg.data.batch_size, (cfg.data.batch_size, cpu.latent_size, cpu.latent_size,
                                   cfg.model.latent_dim)
    draws = [{"rep_noise": torch.from_numpy(rs.randn(*lat).astype(np.float32)),
              "t": torch.from_numpy(rs.randint(0, cpu.schedule.num_timesteps, b)),
              "noise": torch.from_numpy(rs.randn(*lat).astype(np.float32)),
              "keep": torch.from_numpy(rs.uniform(size=(b, 1, 1)) >= cpu.cond_dropout),
              "dropout": _dropout_masks(rs, cpu.spec, b, cpu.spec.attn_dropout)}
             for _ in batches]
    ops.reset_launch_counts()
    loss_cpu, g_cpu = cpu._grads(cpu._batch(batches[0]), draws=draws[0])
    loss_card, g_card = card._grads(card._batch(batches[0]), draws=draws[0])
    ops_counts = ops.launch_counts()
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    grad_err = 0.0
    for (path, r), (_, g) in zip(tree.items(g_cpu), tree.items(g_card)):
        err = (g.float().cpu() - r).abs().max().item()
        bound = TRAIN_GRAD_RTOL * r.abs().max().item() + 1e-6
        grad_err = max(grad_err, err / bound)
        if not err <= bound:
            fail(f"train card vs CPU: gradient {path} max|dg| {err:.3g} > {bound:.3g}")
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"train card vs CPU: loss rel diff {loss_rel:.3g} > {TRAIN_LOSS_RTOL}")
    cpu._apply_update(loss_cpu, g_cpu)
    card._apply_update(loss_card, g_card)
    for batch, d in zip(batches[1:], draws[1:]):
        cpu._step(cpu._batch(batch), draws=d)
        card._step(card._batch(batch), draws=d)
    param_err = max((a.detach().cpu() - r.detach()).abs().max().item() for a, r in zip(
        tree.leaves(card.state.params), tree.leaves(cpu.state.params)))
    ema_err = max((a.cpu() - r).abs().max().item() for a, r in zip(
        tree.leaves(card.state.ema), tree.leaves(cpu.state.ema)))
    if not max(param_err, ema_err) <= TRAIN_PARAM_ATOL:
        fail(f"train card vs CPU: params after 3 steps {param_err:.3g}, ema {ema_err:.3g} "
             f"> {TRAIN_PARAM_ATOL}")
    if min(ops_counts[k] for k in ("group_norm_silu", "flash_attention",
                                   "flash_attention_bwd")) == 0:
        fail(f"train card vs CPU: a kernel was not launched: {ops_counts}")
    return {"loss_cpu": float(loss_cpu), "loss_card": float(loss_card), "loss_rel": loss_rel,
            "loss_rtol": TRAIN_LOSS_RTOL, "grad_err_over_bound": grad_err,
            "grad_rtol": TRAIN_GRAD_RTOL, "params_after_3_steps_max_abs": param_err,
            "ema_after_3_steps_max_abs": ema_err, "params_atol": TRAIN_PARAM_ATOL,
            "first_step_launches": ops_counts}


def predicted_train_launches(trainer):
    """Launches of one training step: forward, a text encode, a VAE encode
    and a UNet evaluation; backward, the flash kernel's for the UNet's
    attention calls only (the text encoder and the VAE encoder run under
    ``no_grad``, stage2_diffusion.py ``_text`` and ``_noise_loss``;
    GN+SiLU and the spatial block recompute their plain versions)."""
    unet = predicted_launches(trainer, 1, text_encodes=0, encodes=0, decodes=0)
    return with_flash_backward(
        predicted_launches(trainer, 1, text_encodes=1, encodes=1, decodes=0),
        unet["flash_attention"])


def phase_train_full_width(exp, corpus, vae_checkpoint):
    """(c) config/train_config.yaml at full width on 128 sprites, its frozen
    VAE and text encoder from phase 7's stage-1 checkpoint: the trainer's
    train_epoch (3 steps at batch 32), validate, generate_samples (DDIM 10
    steps) and save_checkpoint_fast (the light bf16 best); then the serving
    generator resolves both checkpoints through the hub and serves one
    DPM-10 request.  Counts are set to 0 before train_epoch and read after
    the request."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.data import native
    from psg_tpu_torch.serve import hub
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

    cfg = load_config(CONFIG, [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                               f"data.image_dir={corpus[1]}", "extra.sample_steps=10"])
    if (cfg.model.compute_dtype, cfg.data.image_size, cfg.data.batch_size) != (
            "bfloat16", 215, 32):
        fail(f"{CONFIG.name} is not the full-width bf16 batch-32 configuration")
    if not native.available():
        fail("the native augmentation engine did not build: the loader would switch "
             "engines and change every augmented batch")
    t0 = time.perf_counter()
    trainer = DiffusionTrainer(cfg, vae_checkpoint, experiment_name="smoke", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if len(trainer.train_loader) != FULL_STEPS:
        fail(f"the full-width epoch has {len(trainer.train_loader)} steps, not {FULL_STEPS}")
    n_params = sum(t.numel() for t in tree.leaves(trainer.state.params))
    watch = [t.detach().clone() for t in tree.leaves(trainer.state.params)[::97]]

    step_s, step_loss = [], []
    orig_step = trainer._step

    def timed_step(batch, draws=None):   # each step's wall, host clock to a sync
        t = time.perf_counter()
        parts = orig_step(batch, draws=draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(parts["loss"]))
        return parts

    trainer._step = timed_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()          # this path's counted run starts here
    per_step = predicted_train_launches(trainer)
    sample_steps = int(cfg.extra["sample_steps"])
    want = {"train_epoch": {k: FULL_STEPS * v for k, v in per_step.items()},
            "validate": {k: len(trainer.val_loader) * v
                         for k, v in forward_only(per_step).items()},
            "generate_samples": predicted_launches(trainer, sample_steps)}
    got = {}

    def part(name, fn):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got[name] = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return out, time.perf_counter() - t

    stats, epoch_s = part("train_epoch", lambda: trainer.train_epoch(0))
    val, val_s = part("validate", lambda: trainer.validate(0))
    grid, sample_s = part("generate_samples", lambda: trainer.generate_samples(0))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    if not trainer.save_checkpoint_fast(0, val):
        fail("save_checkpoint_fast wrote no best checkpoint")
    save_s = time.perf_counter() - t0
    best = trainer.ckpt.best_path
    ckpt_gb = best.stat().st_size / 1e9
    skipped = trainer.skipped_batches()
    changed = sum(not torch.equal(a, b.detach()) for a, b in zip(
        watch, tree.leaves(trainer.state.params)[::97]))
    tokenizer = trainer.tokenizer
    del trainer
    release()

    vae_ckpt, diff_ckpt = hub.resolve_checkpoints(cfg, "smoke", allow_hub=False)
    if (vae_ckpt, diff_ckpt) != (str(vae_checkpoint), str(best)):
        fail(f"hub resolved {vae_ckpt}, {diff_ckpt}, not the trainers' {vae_checkpoint}, "
             f"{best}")
    t0 = time.perf_counter()
    gen = PokemonGenerator(cfg, vae_checkpoint=vae_ckpt, diffusion_checkpoint=diff_ckpt,
                           tokenizer=tokenizer, sampler="dpmpp", device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want_graphs = UNetGraphKeys(gen).request(gen.sampler_name, 1, 10)
    want["serve DPM-10"] = predicted_launches(gen, 10, captures=want_graphs["capture"])
    g0 = unet_graph_counts()
    img, serve_s = part("serve DPM-10", lambda: np.asarray(
        gen.generate_from_text(PROMPTS[0], 10, seed=3), np.float32))
    if graph_delta(g0) != want_graphs:
        fail(f"serve DPM-10: UNet graphs {graph_delta(g0)} != predicted {want_graphs}")
    launches = ops.launch_counts()     # ... and ends here
    for name in want:
        if got[name] != want[name]:
            fail(f"{name}: kernel launches {got[name]} != predicted {want[name]}")
    if not (np.isfinite(step_loss).all() and np.isfinite(stats["loss"]) and np.isfinite(val)):
        fail(f"non-finite loss: steps {step_loss}, val {val}")
    if skipped:
        fail(f"{skipped} skipped steps")
    if not changed:
        fail("train_epoch left the parameters as they were")
    if gen.loaded != "pair" or img.shape != (215, 215, 3) or not np.isfinite(img).all():
        fail(f"serving from the trained checkpoint: loaded={gen.loaded}, image {img.shape}")
    steady = float(np.mean(step_s[1:]))
    loaded = gen.loaded
    del gen
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "step_s": step_s,
            "step_wall_after_first_s": steady, "samples_per_s": 32 / steady,
            "epoch_s": epoch_s, "step_loss": step_loss, "train_loss": stats["loss"],
            "grad_norm": stats["grad_norm"], "val_loss": val, "validate_s": val_s,
            "generate_samples_s": sample_s, "sample_grid": grid.name,
            "peak_mem_gb": peak / 1e9, "skipped_batches": skipped,
            "watched_leaves_changed": f"{changed}/{len(watch)}",
            "save_best_light_s": save_s, "checkpoint": str(best), "checkpoint_gb": ckpt_gb,
            "vae_checkpoint": str(vae_checkpoint), "serve_load_s": load_s,
            "serve_dpm10_s": serve_s, "loaded": loaded,
            "predicted_per_step": per_step, "launches_by_part": got,
            "launches": launches}


# ---------------------------------------------------------------------------
# phase 7: stage-1 training (the VAE and text encoder)
# ---------------------------------------------------------------------------

# the decoder's two fused sites at the full-width batch: (name, C, cold, mask)
SPATIAL_GRAD_SITES = (("vae 215^2 C64 prompt mask", 64, False, "prompt"),
                      ("vae 215^2 C64 cold heads", 64, True, "third"),
                      ("vae 215^2 C32 prompt mask", 32, False, "prompt"),
                      ("vae 215^2 C32 cold heads", 32, True, "third"))
SPATIAL_GRAD_CASE = "vae 215^2 C32 prompt mask"   # the kernels line's gradient entry
# The training gradient cases' tolerance (atol + rtol |ref|), plus
# max_rtol * max|ref| for the sums over 32 x 46225 rows (k, v, Wq, bq, Wp,
# bp): the Function sums them over chunks of rows, the reference over slices
# of the batch, and their fp32 summation noise scales with the largest
# element (on an H100 both are within 5e-6 max|g| of a float64 reference,
# and bit-equal in one chunk: tests/test_torch_cuda.py).
SPATIAL_GRAD_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4, max_rtol=1e-5),
                    torch.bfloat16: dict(rtol=2e-2, atol=2e-2, max_rtol=1e-4)}


def _spatial_grad_ratio(g, r, dtype):
    """The worst |g - r| / bound over a gradient (<= 1 passes)."""
    tol = SPATIAL_GRAD_TOL[dtype]
    g, r = g.float(), r.float()
    bound = tol["atol"] + tol["rtol"] * r.abs() + tol["max_rtol"] * r.abs().max()
    return float(((g - r).abs() / bound).max())
S1_BATCH = 32


def _spatial_grad_operands(b, c, cold, mask, dtype, seed=0):
    """The fused block's operands at the 215^2 sites: random activations and
    weights; ``cold`` scales Q by 120 (head logits in the hundreds); ``mask``
    'prompt' keeps the four PROMPTS' keys in turn, 'third' a third of the
    last sample's."""
    s, hw = 128, 215
    if mask == "prompt":
        keep = prompt_keys().repeat(b // 4, 1)
    else:
        keep = torch.ones(b, s, device="cuda", dtype=torch.bool)
        keep[-1, s // 3:] = False
    ops_ = [_randn((b, hw * hw, c), seed, dtype), _randn((b, hw * hw, c), seed + 1, dtype),
            _randn((b, s, c), seed + 2), _randn((b, s, c), seed + 3),
            _randn((c, c), seed + 4, scale=c ** -0.5 * (120.0 if cold else 1.0)).to(dtype),
            _randn((c,), seed + 6, scale=0.1),
            _randn((c, c), seed + 5, scale=c ** -0.5).to(dtype), _randn((c,), seed + 7,
                                                                        scale=0.1)]
    bias = torch.where(keep, 0.0, -1e9).float()
    return ops_, bias, keep, _randn((b, hw * hw, c), seed + 8, dtype)


def _spatial_fp32_grads(operands, gy, key_bias, batch_chunk=4):
    """Gradients of the block's fp32 body by plain autograd over
    ``batch_chunk`` samples at a time (the samples are independent; Wq, bq,
    Wp and bp sum over them), each cast to its input's dtype."""
    from psg_tpu_torch.ops import spatial_xattn as sx

    b, c = operands[0].shape[0], operands[0].shape[-1]
    per, shared = [[] for _ in range(4)], None
    for lo in range(0, b, batch_chunk):
        # the shared weights as fp32 leaves: their sums over the slices stay
        # fp32 until the one cast at the end (the body upcasts them anyway)
        xs = [(t[lo:lo + batch_chunk] if i < 4 else t.float()).detach().clone()
              .requires_grad_(True) for i, t in enumerate(operands)]
        out = sx.spatial_xattn_fp32(*xs, num_heads=8, key_bias=key_bias[lo:lo + batch_chunk],
                                    scale=(c // 8) ** -0.5)
        g = torch.autograd.grad(out, xs, gy[lo:lo + batch_chunk].float())
        for i in range(4):
            per[i].append(g[i])
        shared = list(g[4:]) if shared is None else [a + x for a, x in zip(shared, g[4:])]
    return [g.to(t.dtype) for g, t in zip([torch.cat(p) for p in per] + shared, operands)]


def _event_ms(fn, reps=3):
    """Median device time of ``fn`` (CUDA events around one call)."""
    times = []
    for _ in range(reps + 1):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:]))


def phase_stage1_gradients():
    """(a) SpatialXattn on the kernel (forward) and its chunked fp32
    recomputation (backward) against plain autograd of the fp32 body, at the
    decoder's two 215^2 sites at batch 32, bf16 and fp32, prompt masks and
    cold heads.  The main case is also timed: the Function's forward and
    backward, the plain version's (autograd of the bf16-rounding plain
    block, four samples at a time), against the bound of its bytes,
    operations and live-key exponentials."""
    from psg_tpu_torch.ops import spatial_xattn as sx

    cases, timing = [], None
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).replace("torch.", "")
        for name, c, cold, mask in SPATIAL_GRAD_SITES:
            operands, bias, keep, gy = _spatial_grad_operands(S1_BATCH, c, cold, mask, dtype)

            def function(ops_=operands, bias=bias, gy=gy):
                xs = [t.detach().requires_grad_(True) for t in ops_]
                out = sx.fused_spatial_xattn(*xs, num_heads=8,
                                             text_bias=bias[:, None, None, :])
                return out, torch.autograd.grad(out, xs, gy)

            out, got = function()
            ref = _spatial_fp32_grads(operands, gy, bias)
            torch.cuda.synchronize()
            errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(got, ref)]
            ratios = [_spatial_grad_ratio(g, r, dtype) for g, r in zip(got, ref)]
            ok = all(torch.isfinite(g.float()).all() and g.dtype == t.dtype
                     for g, t in zip(got, operands)) and max(ratios) <= 1.0
            names = ("xn", "residual", "k", "v", "wq", "bq", "wp", "bp")
            rec = {"name": f"{name} b{S1_BATCH}", "dtype": dname, "max_abs_err": max(errs),
                   "max_abs_err_by_operand": dict(zip(names, errs)),
                   "err_over_bound_by_operand": dict(zip(names, ratios)),
                   "max_ref_by_operand": dict(zip(names, (r.float().abs().max().item()
                                                          for r in ref))),
                   **SPATIAL_GRAD_TOL[dtype], "ok": bool(ok)}
            if name == SPATIAL_GRAD_CASE and dtype == torch.bfloat16:
                def plain(ops_=operands, bias=bias, gy=gy):
                    for lo in range(0, S1_BATCH, 4):
                        xs = [(t[lo:lo + 4] if i < 4 else t).detach().requires_grad_(True)
                              for i, t in enumerate(ops_)]
                        y = sx.spatial_xattn_plain(
                            xs[0], xs[1], sx.split_heads(xs[2], 8, False),
                            sx.split_heads(xs[3], 8, False), *xs[4:],
                            key_bias=bias[lo:lo + 4], scale=(c // 8) ** -0.5)
                        torch.autograd.grad(y, xs, gy[lo:lo + 4])

                live = keep.sum(1).clamp_min(1).float()
                pix = 215 * 215
                # forward: xn, residual in, out; backward: xn and the gradient
                # in, dxn and dresidual out; k, v, weights and their gradients
                moved = 7 * nbytes(operands[0]) + 2 * nbytes(*operands[2:]) + nbytes(bias)
                # forward 4C^2 + 4SC a pixel; the backward recomputes it and
                # takes about twice that again
                flops = 4 * pix * float((4 * c * c + 4 * live * c).sum())
                exps = 2 * pix * 8 * float(live.sum())     # forward and recomputation
                b_ms, b_by, b_parts = bound(moved, flops, torch.bfloat16, exps)
                timing = {"ms": _event_ms(lambda: function()),
                          "plain_ms": _event_ms(plain), "bound_ms": b_ms, "bound_by": b_by,
                          "bound_parts_ms": b_parts, "max_abs_err": max(errs),
                          "backward_rows": sx.backward_rows(S1_BATCH, 8, 128)}
            cases.append(rec)
            del operands, out, got, ref
            torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail("SpatialXattn's gradient disagrees with the fp32 body's: " + "; ".join(
            f"{c['name']} {c['dtype']} err {c['max_abs_err']:.3g}" for c in bad))
    return {"cases": cases, "main_case": timing}


S1_GRAD_RTOL, S1_LOSS_RTOL, S1_PARAM_ATOL = 1e-3, 1e-4, 1e-4


def _stage1_tiny_config(exp, corpus):
    cfg = tiny_config()
    cfg.experiment_dir = str(exp)
    cfg.data.csv_path, cfg.data.image_dir = map(str, corpus)
    cfg.data.batch_size = 2
    cfg.data.num_workers = 2
    return cfg


def phase_stage1_card_vs_cpu(tmp):
    """(b) One tiny stage-1 trainer on the CPU (plain versions) and one on
    the card (kernels), the same parameters, VGG16, batches and
    reparameterize noises, fp32: every step's loss; the first step's
    gradients; the parameters after 3 steps, where the first step's
    gradient is determined (|g| at least 100 times the gradients' bound:
    Adam's first update is lr * g / (|g| + 1e-8), so a leaf whose gradient
    is rounding noise on both devices, a conv bias a GroupNorm follows,
    moves by +-lr on either)."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.train.stage1_vae import VAETrainer

    corpus = write_sprite_corpus(Path(tmp) / "s1_tiny_corpus", n=12, seed=0, size=64)
    cfg = _stage1_tiny_config(Path(tmp) / "s1_tiny_exp", corpus)
    cpu = VAETrainer(cfg, experiment_name="cpu", device="cpu")
    card = VAETrainer(cfg, experiment_name="card", device="cuda")
    card.state = card._fresh_state(bridge.fit(card.state.params, cpu.state.params), step=0,
                                   rng=card.state.rng)
    card.vgg_params = bridge.fit(card.vgg_params, cpu.vgg_params)
    rs = np.random.RandomState(0)
    batches = [next(iter(cpu.train_loader)) for _ in range(3)]
    lat = (cfg.data.batch_size, cpu.latent_size, cpu.latent_size, cfg.model.latent_dim)
    draws = [{"rep_noise": torch.from_numpy(rs.randn(*lat).astype(np.float32))}
             for _ in batches]
    klw = cpu.kl_weight(1)
    ops.reset_launch_counts()
    parts_cpu, g_cpu = cpu._grads(cpu._batch(batches[0]), klw, draws=draws[0])
    parts_card, g_card = card._grads(card._batch(batches[0]), klw, draws=draws[0])
    counts = ops.launch_counts()
    grad_err, determined = 0.0, []
    for (path, r), g in zip(tree.items(g_cpu), tree.leaves(g_card)):
        err = (g.float().cpu() - r).abs().max().item()
        bound_ = S1_GRAD_RTOL * r.abs().max().item() + 1e-6
        grad_err = max(grad_err, err / bound_)
        if not err <= bound_:
            fail(f"stage 1 card vs CPU: gradient {path} max|dg| {err:.3g} > {bound_:.3g}")
        determined.append(r.abs() >= 100 * (1e-4 * r.abs().max() + 1e-7))
    losses = [(float(parts_cpu["total_loss"]), float(parts_card["total_loss"]))]
    cpu._apply_update(parts_cpu, g_cpu, klw)
    card._apply_update(parts_card, g_card, klw)
    for batch, d in zip(batches[1:], draws[1:]):
        a = cpu._step(cpu._batch(batch), klw, draws=d)
        b = card._step(card._batch(batch), klw, draws=d)
        losses.append((float(a["total_loss"]), float(b["total_loss"])))
    loss_rel = max(abs(b - a) / abs(a) for a, b in losses)
    if not loss_rel <= S1_LOSS_RTOL:
        fail(f"stage 1 card vs CPU: loss rel diff {loss_rel:.3g} > {S1_LOSS_RTOL}: {losses}")
    param_err = 0.0
    for a, r, m in zip(tree.leaves(card.state.params), tree.leaves(cpu.state.params),
                       determined):
        d = (a.detach().cpu() - r.detach())[m].abs()
        param_err = max(param_err, d.max().item() if d.numel() else 0.0)
    if not param_err <= S1_PARAM_ATOL:
        fail(f"stage 1 card vs CPU: params after 3 steps {param_err:.3g} > {S1_PARAM_ATOL}")
    if min(counts.values()) == 0:
        fail(f"stage 1 card vs CPU: a kernel was not launched: {counts}")
    return {"losses_cpu_card": losses, "loss_rel": loss_rel, "loss_rtol": S1_LOSS_RTOL,
            "grad_err_over_bound": grad_err, "grad_rtol": S1_GRAD_RTOL,
            "params_after_3_steps_max_abs_determined": param_err,
            "params_atol": S1_PARAM_ATOL, "first_step_launches": counts}


def predicted_stage1_launches(trainer):
    """Launches of one stage-1 training step: forward, a text encode, a VAE
    encode and a decode; backward, the flash kernel's for every flash call
    of the step (BERT's layers and the decoder's unfused sites): every
    parameter takes a gradient, frozen BERT layers included (stage1_vae.py),
    and the encoder holds no attention.  ``forward_only`` of it is a
    validation batch."""
    fwd = predicted_launches(trainer, 0, text_encodes=1, encodes=1, decodes=1)
    return with_flash_backward(fwd, fwd["flash_attention"])


def phase_stage1_full_width(exp, corpus):
    """(c) config/train_config.yaml at full width (bf16, BERT-base 'minimal',
    the full VAE with VGG16 perceptual loss, 215x215, text_len 128, batch
    32) on 128 sprites: train_epoch (3 steps), validate, generate_samples
    (the prior and the reconstruction grids) and save_checkpoint (the best,
    a full state, which phase 6c's stage 2 then trains from).  Counts are
    set to 0 before train_epoch and read after generate_samples."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.ops import spatial_xattn as sx
    from psg_tpu_torch.train.stage1_vae import VAETrainer

    cfg = load_config(CONFIG, [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                               f"data.image_dir={corpus[1]}"])
    if (cfg.model.compute_dtype, cfg.data.image_size, cfg.data.batch_size,
            cfg.model.bert_finetune_strategy) != ("bfloat16", 215, S1_BATCH, "minimal"):
        fail(f"{CONFIG.name} is not the full-width bf16 batch-32 configuration")
    t0 = time.perf_counter()
    trainer = VAETrainer(cfg, experiment_name="smoke", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if len(trainer.train_loader) != FULL_STEPS:
        fail(f"the full-width epoch has {len(trainer.train_loader)} steps, not {FULL_STEPS}")
    leaves = tree.leaves(trainer.state.params)
    labels = trainer.tx.labels
    n_params = {g: sum(t.numel() for t, lab in zip(leaves, labels) if lab == g)
                for g in ("vae", "text", "frozen")}
    watch = [t.detach().clone() for t in leaves[::29]]

    step_s, step_loss = [], []
    orig_step = trainer._step

    def timed_step(batch, kl_weight, draws=None):
        t = time.perf_counter()
        parts = orig_step(batch, kl_weight, draws=draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(parts["total_loss"]))
        return parts

    trainer._step = timed_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()          # this path's counted run starts here
    per_step = predicted_stage1_launches(trainer)
    prior = predicted_launches(trainer, 0, text_encodes=1, encodes=0, decodes=1)
    want = {"train_epoch": {k: FULL_STEPS * v for k, v in per_step.items()},
            "validate": {k: len(trainer.val_loader) * v
                         for k, v in forward_only(per_step).items()},
            "generate_samples": {k: prior[k] + forward_only(per_step)[k] for k in prior}}
    got = {}

    def part(name, fn):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got[name] = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return out, time.perf_counter() - t

    stats, epoch_s = part("train_epoch", lambda: trainer.train_epoch(0))
    peak_train = torch.cuda.max_memory_allocated()
    val, val_s = part("validate", lambda: trainer.validate(0))
    grids, sample_s = part("generate_samples", lambda: trainer.generate_samples(0))
    launches = ops.launch_counts()     # ... and ends here
    t0 = time.perf_counter()
    if not trainer.save_checkpoint(0, val):
        fail("save_checkpoint wrote no best checkpoint")
    save_s = time.perf_counter() - t0
    best = trainer.ckpt.best_path
    for name in want:
        if got[name] != want[name]:
            fail(f"stage 1 {name}: kernel launches {got[name]} != predicted {want[name]}")
    skipped = trainer.skipped_batches()
    changed = sum(not torch.equal(a, b.detach()) for a, b in zip(
        watch, tree.leaves(trainer.state.params)[::29]))
    if not (np.isfinite(step_loss).all() and np.isfinite(stats["total_loss"])
            and np.isfinite(val)):
        fail(f"stage 1: non-finite loss: steps {step_loss}, val {val}")
    if skipped:
        fail(f"stage 1: {skipped} skipped steps")
    if not changed:
        fail("stage 1: train_epoch left the parameters as they were")
    if not all(p.exists() for p in grids):
        fail(f"stage 1: sample grids missing: {grids}")
    steady = float(np.mean(step_s[1:]))
    rec = {"params": n_params, "init_s": init_s, "step_s": step_s,
           "step_wall_after_first_s": steady, "samples_per_s": S1_BATCH / steady,
           "epoch_s": epoch_s, "step_loss": step_loss,
           "train": {k: stats[k] for k in ("total_loss", "reconstruction_loss",
                                           "perceptual_loss", "kl_loss", "grad_norm")},
           "val_loss": val, "validate_s": val_s, "generate_samples_s": sample_s,
           "grids": [p.name for p in grids], "peak_mem_train_gb": peak_train / 1e9,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "spatial_backward_rows": sx.backward_rows(S1_BATCH, 8, cfg.data.text_len),
           "skipped_batches": skipped, "watched_leaves_changed": f"{changed}/{len(watch)}",
           "save_checkpoint_s": save_s, "checkpoint": str(best),
           "checkpoint_gb": best.stat().st_size / 1e9, "predicted_per_step": per_step,
           "launches_by_part": got, "launches": launches}
    del trainer
    release()
    return rec


# ---------------------------------------------------------------------------
# phase 8: stage-3 training (text encoder, then jointly with decoder and UNet)
# ---------------------------------------------------------------------------

# CLIP ViT-B/32's vision attention at the full-width batch: [B, H, 50, 64],
# no bias (the class token and 7 x 7 patches of 224^2)
CLIP_VISION = (32, 12, 50, 50, 64)
S3_BATCH = 32


def phase_stage3_gradients():
    """(a) FlashSDPA (kernel forward, the plain version's autograd backward)
    against plain autograd at CLIP's vision shape, bf16 and fp32."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.ops import flash_attention

    b, h, lq, lk, d = CLIP_VISION
    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (_randn((b, h, n, d), i, dtype) for i, n in enumerate((lq, lk, lk)))
        gy = _randn((b, lq, h, d), 3, dtype).transpose(1, 2)   # as the heads' merge
        rec = _grad_case(lambda q, k, v: ops.sdpa(q, k, v),
                         lambda q, k, v: flash_attention.sdpa_plain(q, k, v, scale=d ** -0.5),
                         (q, k, v), gy, dtype)
        cases.append({"kernel": "flash_attention", "name": f"clip vision L{lq} hd{d} b{b}",
                      "dtype": str(dtype).replace("torch.", ""), **rec})
    torch.cuda.empty_cache()
    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail("FlashSDPA at CLIP's vision shape disagrees with plain autograd: " + "; ".join(
            f"{c['dtype']} err {c['max_abs_err']:.3g}" for c in bad))
    return {"cases": cases}


def _zero_leaf(g):
    return float(g.abs().max()) == 0.0


def phase_stage3_card_vs_cpu(tmp):
    """(b) One tiny stage-3 trainer on the CPU (plain versions) and one on
    the card (kernels), the same parameters, CLIP, batches and
    reparameterize noises, fp32: a phase-1 step, the switch, two joint
    steps.  Every step's loss; the first step's gradients; the parameters
    after the 3 steps where the first step's gradient is determined (as in
    phase 7b), and everywhere in the leaves whose gradient is 0 on both
    devices (the encoder, the UNet: weight decay alone moves the UNet)."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    corpus = write_sprite_corpus(Path(tmp) / "s3_tiny_corpus", n=12, seed=0, size=64)
    cfg = _stage1_tiny_config(Path(tmp) / "s3_tiny_exp", corpus)
    cfg.training.final_epochs, cfg.training.phase1_epochs = 2, 1
    cpu = FinalTrainer(cfg, None, None, experiment_name="cpu", device="cpu")
    card = FinalTrainer(cfg, None, None, experiment_name="card", device="cuda")
    card.state = card._fresh_state(bridge.fit(card.state.params, cpu.state.params), step=0,
                                   rng=card.state.rng)
    card.clip_params = bridge.fit(card.clip_params, cpu.clip_params)
    rs = np.random.RandomState(0)
    batches = [next(iter(cpu.train_loader)) for _ in range(3)]
    lat = (cfg.data.batch_size, cpu.latent_size, cpu.latent_size, cfg.model.latent_dim)
    draws = [{"rep_noise": torch.from_numpy(rs.randn(*lat).astype(np.float32))}
             for _ in batches]
    ops.reset_launch_counts()
    parts_cpu, g_cpu = cpu._grads(cpu._batch(batches[0]), draws=draws[0])
    parts_card, g_card = card._grads(card._batch(batches[0]), draws=draws[0])
    counts = ops.launch_counts()
    grad_err, keep = 0.0, []
    for (path, r), g in zip(tree.items(g_cpu), tree.leaves(g_card)):
        g = g.float().cpu()
        err = (g - r).abs().max().item()
        bound_ = S1_GRAD_RTOL * r.abs().max().item() + 1e-6
        grad_err = max(grad_err, err / bound_)
        if not err <= bound_:
            fail(f"stage 3 card vs CPU: gradient {path} max|dg| {err:.3g} > {bound_:.3g}")
        if _zero_leaf(r) and _zero_leaf(g):
            keep.append(torch.ones_like(r, dtype=torch.bool))
        else:
            keep.append(r.abs() >= 100 * (1e-4 * r.abs().max() + 1e-7))
    if _zero_leaf(g_cpu["vae"]["decoder"]["final_conv"]["w"]) or not all(
            _zero_leaf(g) for g in tree.leaves(g_cpu["unet"])):
        fail("stage 3 card vs CPU: the decoder's gradient is 0 or the UNet's is not")
    losses = [(float(parts_cpu["total_loss"]), float(parts_card["total_loss"]))]
    cpu._apply_update(parts_cpu, g_cpu)
    card._apply_update(parts_card, g_card)
    cpu.switch_to_joint_training()
    card.switch_to_joint_training()
    for batch, d in zip(batches[1:], draws[1:]):
        a = cpu._step(cpu._batch(batch), draws=d)
        b = card._step(card._batch(batch), draws=d)
        losses.append((float(a["total_loss"]), float(b["total_loss"])))
    loss_rel = max(abs(b - a) / abs(a) for a, b in losses)
    if not loss_rel <= S1_LOSS_RTOL:
        fail(f"stage 3 card vs CPU: loss rel diff {loss_rel:.3g} > {S1_LOSS_RTOL}: {losses}")
    param_err = 0.0
    for a, r, m in zip(tree.leaves(card.state.params), tree.leaves(cpu.state.params), keep):
        d = (a.detach().cpu() - r.detach())[m].abs()
        param_err = max(param_err, d.max().item() if d.numel() else 0.0)
    if not param_err <= S1_PARAM_ATOL:
        fail(f"stage 3 card vs CPU: params after 3 steps {param_err:.3g} > {S1_PARAM_ATOL}")
    if min(counts.values()) == 0:
        fail(f"stage 3 card vs CPU: a kernel was not launched: {counts}")
    return {"losses_cpu_card": losses, "loss_rel": loss_rel, "loss_rtol": S1_LOSS_RTOL,
            "grad_err_over_bound": grad_err, "grad_rtol": S1_GRAD_RTOL,
            "params_after_3_steps_max_abs_determined": param_err,
            "params_atol": S1_PARAM_ATOL, "first_step_launches": counts}


def predicted_stage3_launches(trainer):
    """Launches of one stage-3 training step: forward, a text encode, a VAE
    encode (without gradient, still on the kernels), a decode, and CLIP's
    vision tower (one flash attention per block; its text tower carries a
    causal + padding bias and takes the plain version); backward, the flash
    kernel's for every flash call of the step: BERT and the decoder take
    gradients in both phases (stage3_final.py), and the frozen vision tower
    reads the reconstruction, which needs one.  ``forward_only`` of it is a
    validation batch."""
    want = predicted_launches(trainer, 0, text_encodes=1, encodes=1, decodes=1)
    want["flash_attention"] += trainer.clip_cfg.vision_layers
    return with_flash_backward(want, want["flash_attention"])


def _ckpt_files(directory):
    return {p.name: p.stat().st_size for p in sorted(Path(directory).glob("*.ckpt"))}


def phase_stage3_full_width(exp, corpus, vae_checkpoint, diffusion_checkpoint):
    """(c) config/train_config.yaml at full width (bf16, batch 32, 215^2,
    BERT-base, the full VAE and UNet, a random CLIP ViT-B/32 on the
    WordPiece ids) on the 128 sprites of phases 6c and 7c, the VAE and text
    encoder from phase 7's stage-1 best and the UNet from phase 6c's stage-2
    best: train_epoch (3 steps) and validate in the text-encoder phase and
    save_checkpoint; the switch; train_epoch and validate in the joint
    phase, generate_samples (DDIM 10) and save_checkpoint; then the hub
    resolves the final bundle (``extra.serve_prefer_final``) and the serving
    generator serves one DPM-10 request from it.  Counts are set to 0 before
    the first train_epoch and read after the request."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.serve import hub
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    cfg = load_config(CONFIG, [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                               f"data.image_dir={corpus[1]}", "training.final_epochs=2",
                               "training.phase1_epochs=1", "extra.sample_steps=10",
                               "extra.serve_prefer_final=true"])
    if (cfg.model.compute_dtype, cfg.data.image_size, cfg.data.batch_size) != (
            "bfloat16", 215, S3_BATCH):
        fail(f"{CONFIG.name} is not the full-width bf16 batch-32 configuration")
    disk = shutil.disk_usage(exp)
    release()
    allocated_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = FinalTrainer(cfg, vae_checkpoint, diffusion_checkpoint, experiment_name="smoke",
                           device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if len(trainer.train_loader) != FULL_STEPS:
        fail(f"the full-width epoch has {len(trainer.train_loader)} steps, not {FULL_STEPS}")
    if trainer.clip_cfg.vision_width != 768 or trainer.clip_bpe is not None:
        fail(f"stage 3 is not on ViT-B/32 with WordPiece ids: {trainer.clip_cfg}")
    leaves = tree.leaves(trainer.state.params)
    n_params = {k: sum(t.numel() for t in tree.leaves(v))
                for k, v in trainer.state.params.items()}
    n_params["clip"] = sum(t.numel() for t in tree.leaves(trainer.clip_params))
    watch = {k: [t.detach().clone() for t in tree.leaves(v)[::13]]
             for k, v in (("text", trainer.state.params["text"]),
                          ("decoder", trainer.state.params["vae"]["decoder"]),
                          ("unet", trainer.state.params["unet"]))}

    step_s, step_loss = [], []
    orig_step = trainer._step

    def timed_step(batch, draws=None):
        t = time.perf_counter()
        parts = orig_step(batch, draws=draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(parts["total_loss"]))
        return parts

    trainer._step = timed_step
    per_step = predicted_stage3_launches(trainer)
    n_val = len(trainer.val_loader)
    want, got, secs, peaks = {}, {}, {}, {}

    def part(name, fn, predicted=None):
        before = ops.launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t
        peaks[name] = torch.cuda.max_memory_allocated() / 1e9
        got[name] = {k: v - before[k] for k, v in ops.launch_counts().items()}
        if predicted is not None:
            want[name] = predicted
        return out

    def changed(key):
        now = {"text": trainer.state.params["text"],
               "decoder": trainer.state.params["vae"]["decoder"],
               "unet": trainer.state.params["unet"]}[key]
        return sum(not torch.equal(a, b.detach())
                   for a, b in zip(watch[key], tree.leaves(now)[::13]))

    ops.reset_launch_counts()          # this path's counted run starts here
    st1 = part("train_epoch text_encoder",
               lambda: trainer.train_epoch(0), {k: FULL_STEPS * v for k, v in per_step.items()})
    moved_phase1 = {k: changed(k) for k in watch}
    val1 = part("validate text_encoder", lambda: trainer.validate(0),
                {k: n_val * v for k, v in forward_only(per_step).items()})
    skipped = trainer.skipped_batches()      # the switch starts a new count
    wrote1 = part("save_checkpoint text_encoder", lambda: trainer.save_checkpoint(0, val1))
    files1 = _ckpt_files(trainer.ckpt.dir)
    part("switch_to_joint_training", trainer.switch_to_joint_training)
    st2 = part("train_epoch joint", lambda: trainer.train_epoch(1),
               {k: FULL_STEPS * v for k, v in per_step.items()})
    moved_joint = {k: changed(k) for k in watch}
    val2 = part("validate joint", lambda: trainer.validate(1),
                {k: n_val * v for k, v in forward_only(per_step).items()})
    grid = part("generate_samples", lambda: trainer.generate_samples(1),
                predicted_launches(trainer, int(cfg.extra["sample_steps"])))
    wrote2 = part("save_checkpoint joint", lambda: trainer.save_checkpoint(1, val2))
    files2 = {k: v for k, v in _ckpt_files(trainer.ckpt.dir).items()
              if files1.get(k) != v}
    skipped += trainer.skipped_batches()
    tokenizer, phase, opt_groups = trainer.tokenizer, trainer.phase, sorted(
        trainer.state.opt_state["groups"])
    del trainer, leaves
    release()

    vae_ckpt, diff_ckpt = hub.resolve_checkpoints(cfg, "smoke", allow_hub=False)
    best = Path(exp) / "smoke_final" / "checkpoints" / "final_best_model.ckpt"
    if (vae_ckpt, diff_ckpt) != (str(best), str(best)):
        fail(f"hub resolved {vae_ckpt}, {diff_ckpt}, not the final bundle {best}")
    t0 = time.perf_counter()
    gen = PokemonGenerator(cfg, vae_checkpoint=vae_ckpt, diffusion_checkpoint=diff_ckpt,
                           tokenizer=tokenizer, sampler="dpmpp", device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want_graphs = UNetGraphKeys(gen).request(gen.sampler_name, 1, 10)
    g0 = unet_graph_counts()
    img = part("serve DPM-10", lambda: np.asarray(
        gen.generate_from_text(PROMPTS[0], 10, seed=3), np.float32),
        predicted_launches(gen, 10, captures=want_graphs["capture"]))
    if graph_delta(g0) != want_graphs:
        fail(f"stage 3 serve DPM-10: UNet graphs {graph_delta(g0)} != predicted "
             f"{want_graphs}")
    launches = ops.launch_counts()     # ... and ends here
    for name in want:
        if got[name] != want[name]:
            fail(f"stage 3 {name}: kernel launches {got[name]} != predicted {want[name]}")
    if not (np.isfinite(step_loss).all() and np.isfinite(val1) and np.isfinite(val2)):
        fail(f"stage 3: non-finite loss: steps {step_loss}, val {val1}, {val2}")
    if skipped:
        fail(f"stage 3: {skipped} skipped steps")
    if not wrote1 or not files2:
        fail(f"stage 3: save_checkpoint wrote {files1} then {files2}")
    if phase != "joint" or opt_groups != ["decoder", "text", "unet"]:
        fail(f"stage 3 did not switch: phase {phase}, groups {opt_groups}")
    if not (moved_phase1["text"] and not moved_phase1["decoder"] and not moved_phase1["unet"]
            and moved_joint["decoder"] and moved_joint["unet"]):
        fail(f"stage 3: params moved {moved_phase1} after phase 1, {moved_joint} after joint")
    if gen.loaded != "final-bundle" or img.shape != (215, 215, 3) or not np.isfinite(img).all():
        fail(f"serving the final bundle: loaded={gen.loaded}, image {img.shape}")
    loaded = gen.loaded
    del gen
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "step_s": step_s,
            "step_wall_after_first_s": {"text_encoder": float(np.mean(step_s[1:FULL_STEPS])),
                                        "joint": float(np.mean(step_s[FULL_STEPS + 1:]))},
            "samples_per_s": {"text_encoder": S3_BATCH / float(np.mean(step_s[1:FULL_STEPS])),
                              "joint": S3_BATCH / float(np.mean(step_s[FULL_STEPS + 1:]))},
            "step_loss": step_loss,
            "train": {"text_encoder": st1, "joint": st2}, "val_loss": [val1, val2],
            "seconds_by_part": secs, "peak_mem_gb_by_part": peaks,
            "sample_grid": grid.name, "skipped_batches": skipped,
            "watched_leaves_changed": {"after_text_encoder": moved_phase1,
                                       "after_joint": moved_joint},
            "disk_free_gb_before": disk.free / 1e9,
            "allocated_gb_before": allocated_before / 1e9,
            "checkpoints_text_encoder": files1, "checkpoints_joint": files2,
            "serve_load_s": load_s, "loaded": loaded,
            "predicted_per_step": per_step, "launches_by_part": got, "launches": launches}


# ---------------------------------------------------------------------------
# phase 9: stage-0 MLM pretraining of the text tower
# ---------------------------------------------------------------------------


def phase_stage0_card_vs_cpu(tmp):
    """(a) One tiny MLM trainer on the CPU and one on the card, the same
    parameters, minibatches and masks, BERT in fp32 (the trainers' loss
    runs bf16 by default; fp32 holds the card to phase 7b's bounds), 3
    steps: every step's loss, the first step's gradients, the parameters
    after 3 steps where the first gradient is determined."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.train.stage0_mlm import MLMPretrainer

    corpus = write_sprite_corpus(Path(tmp) / "s0_tiny_corpus", n=20, seed=3, size=64)
    cfg = _stage1_tiny_config(Path(tmp) / "s0_tiny_exp", corpus)
    cfg.extra = {"mlm_epochs": 2, "mlm_batch": 8, "mlm_caption_augment": 2}
    cpu = MLMPretrainer(cfg, experiment_name="cpu", device="cpu")
    card = MLMPretrainer(cfg, experiment_name="card", device="cuda")
    cpu.compute_dtype = card.compute_dtype = None
    card.state.params = tree.map(lambda t: t.requires_grad_(True),
                                 bridge.fit(card.state.params, cpu.state.params))
    card.state.opt_state = card.tx.init(card.state.params)
    rs = np.random.RandomState(0)
    n, shape = cpu.train_rows[0].shape[0], (cpu.batch, cfg.data.text_len)
    draws = [{"index": torch.from_numpy(rs.randint(0, n, cpu.batch)),
              "u_select": torch.from_numpy(rs.uniform(size=shape).astype(np.float32)),
              "u_kind": torch.from_numpy(rs.uniform(size=shape).astype(np.float32)),
              "random_ids": torch.from_numpy(rs.randint(5, cpu.tokenizer.vocab_size, shape))}
             for _ in range(3)]
    ops.reset_launch_counts()
    loss_cpu, g_cpu = cpu._grads(draws[0])
    loss_card, g_card = card._grads(draws[0])
    counts = ops.launch_counts()
    grad_err, keep = 0.0, []
    for (path, r), g in zip(tree.items(g_cpu), tree.leaves(g_card)):
        err = (g.float().cpu() - r).abs().max().item()
        bound_ = S1_GRAD_RTOL * r.abs().max().item() + 1e-6
        grad_err = max(grad_err, err / bound_)
        if not err <= bound_:
            fail(f"stage 0 card vs CPU: gradient {path} max|dg| {err:.3g} > {bound_:.3g}")
        keep.append(r.abs() >= 100 * (1e-4 * r.abs().max() + 1e-7))
    losses = [(float(loss_cpu), float(loss_card))]
    for t, g in ((cpu, g_cpu), (card, g_card)):
        t.tx.update(t.state.params, g, t.state.opt_state)
        t.state.step += 1
    for d in draws[1:]:
        losses.append((float(cpu._step(d)["loss"]), float(card._step(d)["loss"])))
    loss_rel = max(abs(b - a) / abs(a) for a, b in losses)
    if not loss_rel <= S1_LOSS_RTOL:
        fail(f"stage 0 card vs CPU: loss rel diff {loss_rel:.3g} > {S1_LOSS_RTOL}: {losses}")
    param_err = 0.0
    for a, r, m in zip(tree.leaves(card.state.params), tree.leaves(cpu.state.params), keep):
        d = (a.detach().cpu() - r.detach())[m].abs()
        param_err = max(param_err, d.max().item() if d.numel() else 0.0)
    if not param_err <= S1_PARAM_ATOL:
        fail(f"stage 0 card vs CPU: params after 3 steps {param_err:.3g} > {S1_PARAM_ATOL}")
    if counts["flash_attention"] == 0 or counts["flash_attention_bwd"] == 0:
        fail(f"stage 0 card vs CPU: the flash kernels were not launched: {counts}")
    return {"losses_cpu_card": losses, "loss_rel": loss_rel, "loss_rtol": S1_LOSS_RTOL,
            "grad_err_over_bound": grad_err, "grad_rtol": S1_GRAD_RTOL,
            "params_after_3_steps_max_abs_determined": param_err,
            "params_atol": S1_PARAM_ATOL, "first_step_launches": counts}


def phase_stage0_full_width(exp, corpus):
    """(b) BERT-base at full width (bf16, batch 64, text_len 128) on the 128
    sprites' captions and 8 variants of each, one epoch: the step wall,
    samples/s, peak memory and launches (one flash attention per BERT layer
    a step and a validation pass, nothing else); the best loads into a
    full-width stage-1 text template through load_text_init.  Counts are set
    to 0 before the epoch and read after the validation."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.models.text_encoder import text_encoder_init
    from psg_tpu_torch.train.stage0_mlm import MLMPretrainer, load_text_init

    cfg = load_config(CONFIG, [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                               f"data.image_dir={corpus[1]}", "extra.mlm_epochs=1"])
    release()
    allocated_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer = MLMPretrainer(cfg, experiment_name="smoke", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if (trainer.batch, cfg.data.text_len, trainer.bert_cfg.num_layers) != (64, 128, 12):
        fail("stage 0 is not BERT-base at batch 64, text_len 128")
    step_s, step_loss = [], []
    orig_step = trainer._step

    def timed_step(draws=None):
        t = time.perf_counter()
        out = orig_step(draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(out["loss"]))
        return out

    trainer._step = timed_step
    spe = trainer.steps_per_epoch
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()          # this path's counted run starts here
    t0 = time.perf_counter()
    best = trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = ops.launch_counts()     # ... and ends here
    # every BERT layer trains, so each flash call launches the backward too
    per_step = {"group_norm_silu": 0, "flash_attention": trainer.bert_cfg.num_layers,
                "spatial_xattn": 0, "flash_attention_bwd": trainer.bert_cfg.num_layers}
    want = {k: spe * v + forward_only(per_step)[k]   # the steps and one validation
            for k, v in per_step.items()}
    if launches != want:
        fail(f"stage 0: kernel launches {launches} != predicted {want}")
    if not (best.exists() and np.isfinite(step_loss).all()):
        fail(f"stage 0: best {best}, losses {step_loss}")
    m = cfg.model
    template = text_encoder_init(torch.Generator(device=trainer.device).manual_seed(0),
                                 trainer.bert_cfg, m.text_embedding_dim)
    warm = load_text_init(best, template)
    if not all(torch.equal(a, b.detach()) for a, b in zip(
            tree.leaves(warm), tree.leaves(trainer.state.params["text"]))):
        fail("stage 0: the best does not warm-start a stage-1 text template")
    rec = {"params": sum(t.numel() for t in tree.leaves(trainer.state.params)),
           "rows": {"train": int(trainer.train_rows[0].shape[0]),
                    "val": int(trainer.val_rows[0].shape[0])},
           "init_s": init_s, "steps": spe, "step_s": step_s,
           "step_wall_after_first_s": float(np.mean(step_s[1:])),
           "samples_per_s": trainer.batch / float(np.mean(step_s[1:])),
           "step_loss": step_loss, "train_s": train_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "allocated_gb_before": allocated_before / 1e9,
           "checkpoint_gb": best.stat().st_size / 1e9, "predicted_per_step": per_step,
           "launches": launches}
    del trainer, warm, template
    release()
    return rec


# ---------------------------------------------------------------------------
# phase 10: the device-resident fast path
# ---------------------------------------------------------------------------

R3_CONFIG = ROOT / "config" / "r3_evidence.yaml"
FAST_BATCH, FAST_SIZE = 16, 215     # config/r3_evidence.yaml's batch and image size
FAST_EPOCHS = 2            # each stage's epochs in phase 10c
AUG_ATOL, AUG_MEAN_ATOL, AUG_EDGE_PX = 1e-4, 1e-5, 1e-3


def _aug_near_edge(params, size):
    """Pixels whose source coordinate lies within AUG_EDGE_PX of the edge,
    where the in-bounds test may flip between two devices' roundings."""
    from psg_tpu_torch.data import device_augment as da

    p = {k: v.float().cpu() for k, v in params.items()}
    aspect = torch.exp(p["log_aspect"])
    cw = torch.sqrt(p["area"] * aspect).clamp_max(1.0)
    ch = torch.sqrt(p["area"] / aspect).clamp_max(1.0)
    yi, xi = da._affine_coords(size, p["angle"] * math.pi / 180.0, (ch, cw),
                               (p["center_y"] * (1 - ch) * (size - 1) / 2,
                                p["center_x"] * (1 - cw) * (size - 1) / 2))
    return torch.stack([yi.abs(), (yi - (size - 1)).abs(), xi.abs(),
                        (xi - (size - 1)).abs()]).amin(0) < AUG_EDGE_PX


def phase_fast_augment():
    """(a) ``augment_batch`` and ``draw_minibatch`` on the card against the
    CPU with the same parameters at 215^2, batch 16 (the split of phase
    10c: 103 sprites), and the device time of one augment (CUDA events over
    20 calls) beside its bytes bound."""
    from psg_tpu_torch.data.device_augment import augment_batch, draw_augment_params
    from psg_tpu_torch.train.fastpath import draw_minibatch

    rs = np.random.RandomState(0)
    images = torch.from_numpy(rs.randint(0, 256, (FAST_BATCH, FAST_SIZE, FAST_SIZE, 3)
                                          ).astype(np.uint8))
    params = draw_augment_params(torch.Generator().manual_seed(0), FAST_BATCH)
    ref = augment_batch(images, params)
    card_images = images.cuda()
    card_params = {k: v.cuda() for k, v in params.items()}
    got = augment_batch(card_images, card_params).cpu()
    err = (got - ref).abs()
    far = ~_aug_near_edge(params, FAST_SIZE)
    max_far, mean = float(err[far].max()), float(err.mean())
    if not (max_far <= AUG_ATOL and mean <= AUG_MEAN_ATOL):
        fail(f"augment_batch card vs CPU: max {max_far:.3g} (> {AUG_ATOL}) away from the "
             f"edge or mean {mean:.3g} (> {AUG_MEAN_ATOL})")
    uniforms = torch.from_numpy(rs.uniform(size=103).astype(np.float32))
    idx_cpu = draw_minibatch(None, 103, FAST_BATCH, uniforms=uniforms)
    idx_card = draw_minibatch(None, 103, FAST_BATCH, device="cuda", uniforms=uniforms.cuda())
    if not torch.equal(idx_cpu, idx_card.cpu()):
        fail(f"draw_minibatch card vs CPU: {idx_card.tolist()} != {idx_cpu.tolist()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    drawn = draw_minibatch(gen, 103, FAST_BATCH, device="cuda")
    if len(set(drawn.tolist())) != FAST_BATCH:
        fail(f"draw_minibatch on the card repeated an index: {drawn.tolist()}")
    ms = _event_ms(lambda: augment_batch(card_images, card_params), reps=20)
    nb = images.numel() + 4 * images.numel()           # uint8 in, fp32 out
    return {"shape": list(images.shape), "max_abs_err_away_from_edge": max_far,
            "mean_abs_err": mean, "atol": AUG_ATOL, "mean_atol": AUG_MEAN_ATOL,
            "edge_pixels": int((~far).sum()), "max_abs_err": float(err.max()),
            "draw_minibatch_equal": True, "augment_ms": ms,
            "augment_bound_ms": nb / HBM_BYTES_PER_S * 1e3}


def _fast_draws(rs, trainer, steps, *, loss, variants=0):
    """CPU draws for ``steps`` fast steps: the index uniforms, the
    augmentation parameters, the caption-variant index, then ``loss(rs)``."""
    from psg_tpu_torch.data.device_augment import draw_augment_params

    n, b = trainer._train_data["images"].shape[0], trainer.cfg.data.batch_size
    out = []
    for _ in range(steps):
        d = {"uniforms": torch.from_numpy(rs.uniform(size=n).astype(np.float32)),
             "augment": draw_augment_params(
                 torch.Generator().manual_seed(int(rs.randint(1 << 30))), b)}
        if variants:
            d["v"] = torch.from_numpy(rs.randint(0, variants, b))
        out.append({**d, **loss(rs)})
    return out


def _record_grads(trainer):
    seen, orig = [], trainer._grads

    def grads(*args, **kwargs):
        out = orig(*args, **kwargs)
        seen.append(out[1])
        return out

    trainer._grads = grads
    return seen


def _fast_compare(name, cpu, card, epochs, grad_rtol, loss_rtol, param_atol,
                  loss_key="loss", switch=None):
    """One fast epoch of 3 steps (``epochs``: (epoch, draws) pairs; the
    switch to stage 3's joint phase between them) on the CPU trainer and
    the card's: every step's loss, the first step's gradients, the
    parameters (and EMA) after it where the first step's gradient is
    determined or 0 on both devices."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree

    card._setup_fast_data()          # the CPU trainer's split drew the draws
    seen = {"cpu": _record_grads(cpu), "card": _record_grads(card)}
    losses, counts = [], None
    for i, (epoch, step, draws) in enumerate(epochs):
        if i and switch:
            switch(cpu)
            switch(card)
        a = cpu._fast_epoch(step(cpu), draws)
        before = ops.launch_counts()
        b = card._fast_epoch(step(card), draws)
        after = ops.launch_counts()
        counts = counts or {k: v - before[k] for k, v in after.items()}
        losses += list(zip(a[loss_key], b[loss_key]))
    grad_err, keep = 0.0, []
    for (path, r), g in zip(tree.items(seen["cpu"][0]), tree.leaves(seen["card"][0])):
        g = g.float().cpu()
        err = (g - r).abs().max().item()
        bound_ = grad_rtol * r.abs().max().item() + 1e-6
        grad_err = max(grad_err, err / bound_)
        if not err <= bound_:
            fail(f"{name} fast card vs CPU: gradient {path} max|dg| {err:.3g} > {bound_:.3g}")
        keep.append(torch.ones_like(r, dtype=torch.bool) if _zero_leaf(r) and _zero_leaf(g)
                    else r.abs() >= 100 * (1e-4 * r.abs().max() + 1e-7))
    loss_rel = max(abs(b - a) / abs(a) for a, b in losses)
    if not loss_rel <= loss_rtol:
        fail(f"{name} fast card vs CPU: loss rel diff {loss_rel:.3g} > {loss_rtol}: {losses}")
    param_err = 0.0
    trees = [("params", card.state.params, cpu.state.params)]
    if card.state.ema is not None:
        trees.append(("ema", card.state.ema, cpu.state.ema))
    for _what, mine, ref in trees:
        for a, r, m in zip(tree.leaves(mine), tree.leaves(ref), keep):
            d = (a.detach().cpu() - r.detach())[m].abs()
            param_err = max(param_err, d.max().item() if d.numel() else 0.0)
    if not param_err <= param_atol:
        fail(f"{name} fast card vs CPU: params after 3 steps {param_err:.3g} > {param_atol}")
    if card.state.step != 3 or cpu.state.step != 3:
        fail(f"{name} fast card vs CPU: {card.state.step} / {cpu.state.step} steps, not 3")
    need = ("group_norm_silu", "flash_attention", "flash_attention_bwd") + (
        () if name == "stage 2" else ("spatial_xattn",))
    if min(counts[k] for k in need) == 0:
        fail(f"{name} fast card vs CPU: a kernel was not launched: {counts}")
    return {"losses_cpu_card": losses, "loss_rel": loss_rel, "loss_rtol": loss_rtol,
            "grad_err_over_bound": grad_err, "grad_rtol": grad_rtol,
            "params_after_3_steps_max_abs_determined": param_err, "params_atol": param_atol,
            "first_epoch_launches": counts}


def phase_fast_card_vs_cpu(tmp):
    """(b) The tiny config in fp32, one trainer on the CPU and one on the
    card per stage, the same parameters, draws made on the CPU: one fast
    epoch of 3 steps with augmentation on (stage 2 with 2 caption variants
    encoded in the step; stage 3 one text-encoder step, the switch, two
    joint steps), held to phases 6b-8b's bounds."""
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.nn.layers import prepare_weights
    from psg_tpu_torch.train.stage1_vae import VAETrainer
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    corpus = write_sprite_corpus(Path(tmp) / "fast_tiny_corpus", n=12, seed=0, size=64)
    rs = np.random.RandomState(0)
    out = {}

    def rep_noise(t):
        lat = (t.cfg.data.batch_size, t.latent_size, t.latent_size, t.cfg.model.latent_dim)
        return lambda r: {"rep_noise": torch.from_numpy(r.randn(*lat).astype(np.float32))}

    cfg = _stage1_tiny_config(Path(tmp) / "fast_s1", corpus)
    cpu = VAETrainer(cfg, experiment_name="cpu", device="cpu")
    card = VAETrainer(cfg, experiment_name="card", device="cuda")
    card.state = card._fresh_state(bridge.fit(card.state.params, cpu.state.params), step=0,
                                   rng=card.state.rng)
    card.vgg_params = bridge.fit(card.vgg_params, cpu.vgg_params)
    cpu._setup_fast_data()
    klw = cpu.kl_weight(1)
    draws = _fast_draws(rs, cpu, 3, loss=rep_noise(cpu))
    out["stage1"] = _fast_compare(
        "stage 1", cpu, card, [(1, lambda t: (lambda b, draws: t._step(b, klw, draws=draws)),
                                draws)],
        S1_GRAD_RTOL, S1_LOSS_RTOL, S1_PARAM_ATOL, loss_key="total_loss")
    del cpu, card

    cfg = _tiny_train_config(Path(tmp) / "fast_s2", corpus)
    cfg.extra = {**cfg.extra, "caption_augment": 2}
    cpu = DiffusionTrainer(cfg, None, experiment_name="cpu", device="cpu")
    card = DiffusionTrainer(cfg, None, experiment_name="card", device="cuda")
    card.frozen = prepare_weights(bridge.fit(card.frozen, cpu.frozen))
    card.state = card._fresh_state(bridge.fit(card.state.params, cpu.state.params), step=0,
                                   rng=card.state.rng)
    cpu._setup_fast_data()
    b, lat = cfg.data.batch_size, (cfg.data.batch_size, cpu.latent_size, cpu.latent_size,
                                   cfg.model.latent_dim)

    def s2_loss(r):
        return {"rep_noise": torch.from_numpy(r.randn(*lat).astype(np.float32)),
                "t": torch.from_numpy(r.randint(0, cpu.schedule.num_timesteps, b)),
                "noise": torch.from_numpy(r.randn(*lat).astype(np.float32)),
                "keep": torch.from_numpy(r.uniform(size=(b, 1, 1)) >= cpu.cond_dropout),
                "dropout": _dropout_masks(r, cpu.spec, b, cpu.spec.attn_dropout)}

    draws = _fast_draws(rs, cpu, 3, loss=s2_loss, variants=2)
    out["stage2"] = _fast_compare("stage 2", cpu, card, [(0, lambda t: t._step, draws)],
                                  TRAIN_GRAD_RTOL, TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL)
    del cpu, card

    cfg = _stage1_tiny_config(Path(tmp) / "fast_s3", corpus)
    cfg.training.final_epochs, cfg.training.phase1_epochs = 2, 1
    cpu = FinalTrainer(cfg, None, None, experiment_name="cpu", device="cpu")
    card = FinalTrainer(cfg, None, None, experiment_name="card", device="cuda")
    card.state = card._fresh_state(bridge.fit(card.state.params, cpu.state.params), step=0,
                                   rng=card.state.rng)
    card.clip_params = bridge.fit(card.clip_params, cpu.clip_params)
    cpu._setup_fast_data()
    draws = _fast_draws(rs, cpu, 3, loss=rep_noise(cpu))
    out["stage3"] = _fast_compare(
        "stage 3", cpu, card, [(0, lambda t: t._step, draws[:1]),
                               (1, lambda t: t._step, draws[1:])],
        S1_GRAD_RTOL, S1_LOSS_RTOL, S1_PARAM_ATOL, loss_key="total_loss",
        switch=lambda t: t.switch_to_joint_training())
    if card.phase != "joint":
        fail("stage 3 fast card vs CPU: no switch to the joint phase")
    del cpu, card
    release()
    return out


def predicted_fast_launches(trainer, steps, val_batches, setup_encodes):
    """Forward launches of a fast stage: its steps and validation batches
    (stage 1 and 3 as their classic step; stage 2 without the text encode,
    which the fast path precomputes in ``setup_encodes`` calls, or with it
    when caption variants are encoded in the step) and the setup's text
    encodes."""
    from psg_tpu_torch.train.stage1_vae import VAETrainer
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    if isinstance(trainer, VAETrainer):
        per_step = predicted_stage1_launches(trainer)
    elif isinstance(trainer, FinalTrainer):
        per_step = predicted_stage3_launches(trainer)
    else:   # the caption variants' text encode runs without gradient
        unet = predicted_launches(trainer, 1, text_encodes=0, encodes=0, decodes=0)
        per_step = with_flash_backward(
            predicted_launches(trainer, 1, text_encodes=int(trainer.caption_augment > 0),
                               encodes=1, decodes=0), unet["flash_attention"])
    per_val = forward_only(per_step)
    if not isinstance(trainer, (VAETrainer, FinalTrainer)):
        per_val = predicted_launches(trainer, 1, text_encodes=0, encodes=1, decodes=0)
    setup = predicted_launches(trainer, 0, text_encodes=1, encodes=0, decodes=0)
    return {k: steps * per_step[k] + val_batches * per_val[k] + setup_encodes * setup[k]
            for k in per_step}


def _device_ms(fn):
    """(result, summed device time in ms) of one call under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    kernel_us = sum(evt.self_device_time_total for evt in prof.key_averages()
                    if evt.device_type == torch.autograd.DeviceType.CUDA)
    return out, kernel_us / 1e3


class _HostToDevice(TorchDispatchMode):
    """Records every copy of a CPU tensor onto the card that goes through
    PyTorch's dispatcher (``_to_copy``, ``copy_``) as (shape, bytes).  The
    profiler's memcpy records are not used: on that machine it dropped some,
    the first of a run among them."""

    def __init__(self):
        super().__init__()
        self.copies = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._to_copy.default:
            src, dst = args[0], out
        elif func is torch.ops.aten.copy_.default:
            src, dst = args[1], args[0]
        else:
            return out
        if src.device.type == "cpu" and dst.device.type == "cuda":
            self.copies.append((list(src.shape), src.numel() * src.element_size()))
        return out


def phase_fast_full_width(tmp, corpus):
    """(c) ``python -m psg_tpu_torch.train.cli --stage all --config
    config/r3_evidence.yaml`` in-process at full width (bf16, BERT-base,
    the 655M UNet, the full VAE, 215^2, text_len 128, batch 16, EMA 0.9995,
    bf16 first moment, warmup-cosine, skip 5.0) on phase 6c's 128 sprites,
    2 epochs a stage, validating and writing a light best each epoch: each
    stage's step walls (after its first step), the device time of its last
    step of epoch 0 under the profiler, the host-to-device copies of the
    next step (none allowed),
    samples/s, peak memory, launches against ``predicted_fast_launches``,
    and the bytes and seconds of every checkpoint; then the hub resolves
    stage 3's light best as a final bundle and the serving generator serves
    one DPM-10 request from it.  Counts are set to 0 before the CLI and
    read after the request."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core.checkpoint import CheckpointManager
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.serve import hub
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.train import cli
    from psg_tpu_torch.train.stage1_vae import VAETrainer
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    exp = Path(tmp) / "fast_exp"
    exp.mkdir()
    (exp / "vocab.txt").write_bytes(VOCAB.read_bytes())
    overrides = [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                 f"data.image_dir={corpus[1]}", f"training.vae_epochs={FAST_EPOCHS}",
                 f"training.diffusion_epochs={FAST_EPOCHS}",
                 f"training.final_epochs={FAST_EPOCHS}", "training.val_every=1",
                 "training.best_every=1"]
    cfg = load_config(R3_CONFIG, overrides)
    o = cfg.optimization
    if not (cfg.training.fast_path and cfg.model.compute_dtype == "bfloat16"
            and cfg.data.batch_size == FAST_BATCH and cfg.data.image_size == FAST_SIZE
            and o.ema_decay == 0.9995 and o.mu_dtype == "bfloat16"
            and o.scheduler == "warmup_cosine" and o.skip_grad_norm == 5.0):
        fail(f"{R3_CONFIG.name} is not the full-width fast-path recipe")
    stages = {}
    current = {}
    classes = {VAETrainer: "stage1", DiffusionTrainer: "stage2", FinalTrainer: "stage3"}
    wrapped = [(cls, name) for cls in classes
               for name in ("_step", "train", "_setup_fast_data", "validate_fast")]
    wrapped += [(CheckpointManager, "save"), (CheckpointManager, "save_best_light")]
    saved = {(cls, name): cls.__dict__.get(name) for cls, name in wrapped}

    def wrap_step(orig):
        def step(self, *args, **kwargs):
            rec = stages[classes[type(self)]]
            i = len(rec["step_s"])
            torch.cuda.synchronize()
            t = time.perf_counter()
            if i == self._fast_len - 1:      # the last step of epoch 0: device time
                out, rec["profiled_step_device_ms"] = _device_ms(
                    lambda: orig(self, *args, **kwargs))
            elif i == self._fast_len:        # the first of epoch 1: host-to-device copies
                with _HostToDevice() as mode:
                    out = orig(self, *args, **kwargs)
                    torch.cuda.synchronize()
                rec["h2d_copies"] = mode.copies
            else:
                out = orig(self, *args, **kwargs)
                torch.cuda.synchronize()
            rec["step_s"].append(time.perf_counter() - t)
            return out
        return step

    def wrap_train(orig):
        def train(self):
            name = classes[type(self)]
            stages[name] = rec = {"step_s": [], "checkpoints": [], "val_batches": 0}
            current["stage"] = name
            release()
            torch.cuda.reset_peak_memory_stats()
            before = ops.launch_counts()
            t = time.perf_counter()
            best = orig(self)
            torch.cuda.synchronize()
            rec["train_s"] = time.perf_counter() - t
            rec["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
            rec["launches"] = {k: v - before[k] for k, v in ops.launch_counts().items()}
            n_setup = 0
            if isinstance(self, DiffusionTrainer) and not self.caption_augment:
                n_setup = (-(-self._train_data["images"].shape[0] // 64)
                           + self._val_data["images"].shape[0])
            rec["predicted_launches"] = predicted_fast_launches(
                self, len(rec["step_s"]), rec["val_batches"], n_setup)
            rec["skipped_batches"] = self.skipped_batches()
            rec["steps"], rec["best"] = self.state.step, str(best)
            return best
        return train

    def wrap_setup(orig):
        def setup(self):
            t = time.perf_counter()
            orig(self)
            torch.cuda.synchronize()
            stages[classes[type(self)]]["setup_fast_data_s"] = time.perf_counter() - t
        return setup

    def wrap_validate(orig):
        def validate(self, epoch, draws=None):
            t = time.perf_counter()
            val = orig(self, epoch, draws)
            rec = stages[classes[type(self)]]
            rec["val_batches"] += self._val_data["images"].shape[0]
            rec.setdefault("val_loss", []).append(val)
            rec.setdefault("validate_s", []).append(time.perf_counter() - t)
            return val
        return validate

    def wrap_save(orig, kind):
        # "blocking_s": until save returns; "s": until the file is on disk (with
        # PSG_TPU_ASYNC_CKPT=1 the write goes on after save returns)
        def save(self, *args, **kwargs):
            t = time.perf_counter()
            out = orig(self, *args, **kwargs)
            blocking = time.perf_counter() - t
            self.wait()
            path = self.best_path if kind == "light best" else self.latest_path()
            if kind == "full state" or out:
                stages[current["stage"]]["checkpoints"].append(
                    {"kind": kind, "gb": path.stat().st_size / 1e9,
                     "s": time.perf_counter() - t, "blocking_s": blocking})
            return out
        return save

    for cls in classes:       # each class's own wraps of what it inherits
        cls._step = wrap_step(cls._step)
        cls.train = wrap_train(cls.train)
        cls._setup_fast_data = wrap_setup(cls._setup_fast_data)
        cls.validate_fast = wrap_validate(cls.validate_fast)
    CheckpointManager.save = wrap_save(CheckpointManager.__dict__["save"], "full state")
    CheckpointManager.save_best_light = wrap_save(
        CheckpointManager.__dict__["save_best_light"], "light best")
    ops.reset_launch_counts()          # this path's counted run starts here
    try:
        t = time.perf_counter()
        rc = cli.main(["--stage", "all", "--config", str(R3_CONFIG), "--experiment-name",
                       "fast"] + [f"--override={o}" for o in overrides])
        cli_s = time.perf_counter() - t
    finally:
        for (cls, name), fn in saved.items():
            if fn is None:
                delattr(cls, name)
            else:
                setattr(cls, name, fn)
    if rc != 0:
        fail(f"the training CLI exited {rc}")
    release()
    for name, rec in stages.items():
        if rec["launches"] != rec["predicted_launches"]:
            fail(f"{name} fast path: launches {rec['launches']} != predicted "
                 f"{rec['predicted_launches']}")
        if rec["skipped_batches"] or not np.isfinite(rec["val_loss"]).all():
            fail(f"{name} fast path: {rec['skipped_batches']} skipped steps, val "
                 f"{rec['val_loss']}")
        if rec.get("h2d_copies") != []:
            fail(f"{name} fast path: host-to-device copies in a step: "
                 f"{rec.get('h2d_copies', 'not counted')}")
        kinds = [c["kind"] for c in rec["checkpoints"]]
        if "light best" not in kinds or kinds[-1] != "full state":
            fail(f"{name} fast path: checkpoints {kinds}")
        # after the first step, less the profiled and the counted one
        n = len(rec["step_s"]) // FAST_EPOCHS
        steady = [s for i, s in enumerate(rec["step_s"]) if i not in (0, n - 1, n)]
        rec["step_wall_after_first_s"] = float(np.mean(steady))
        rec["samples_per_s"] = FAST_BATCH / rec["step_wall_after_first_s"]
    if sorted(stages) != ["stage1", "stage2", "stage3"]:
        fail(f"the CLI ran {sorted(stages)}")

    serve_cfg = load_config(R3_CONFIG, overrides + ["extra.serve_prefer_final=true"])
    vae_ckpt, diff_ckpt = hub.resolve_checkpoints(serve_cfg, "fast", allow_hub=False)
    if vae_ckpt != stages["stage3"]["best"] or diff_ckpt != vae_ckpt:
        fail(f"hub resolved {vae_ckpt}, {diff_ckpt}, not stage 3's light best")
    t = time.perf_counter()
    gen = PokemonGenerator(serve_cfg, vae_checkpoint=vae_ckpt, diffusion_checkpoint=diff_ckpt,
                           sampler="dpmpp", device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    want_graphs = UNetGraphKeys(gen).request(gen.sampler_name, 1, 10)
    before, g0 = ops.launch_counts(), unet_graph_counts()
    t = time.perf_counter()
    img = np.asarray(gen.generate_from_text(PROMPTS[0], 10, seed=3), np.float32)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t
    launches = ops.launch_counts()     # ... and ends here
    want = predicted_launches(gen, 10, captures=want_graphs["capture"])
    got = {k: v - before[k] for k, v in launches.items()}
    if got != want:
        fail(f"serving the fast path's bundle: launches {got} != predicted {want}")
    if graph_delta(g0) != want_graphs:
        fail(f"serving the fast path's bundle: UNet graphs {graph_delta(g0)} != "
             f"predicted {want_graphs}")
    if gen.loaded != "final-bundle" or img.shape != (FAST_SIZE, FAST_SIZE, 3) or not np.isfinite(
            img).all():
        fail(f"serving the fast path's bundle: loaded={gen.loaded}, image {img.shape}")
    loaded = gen.loaded
    del gen
    release()
    return {"config": R3_CONFIG.name, "epochs_per_stage": FAST_EPOCHS, "cli_s": cli_s,
            "stages": stages, "serve_load_s": load_s, "serve_dpm10_s": serve_s,
            "loaded": loaded, "serve_launches": got, "launches": launches}


# ---------------------------------------------------------------------------
# phase 11: the SD-1.5 UNet (--use-diffusers stage 2)
# ---------------------------------------------------------------------------

SD_BATCH = 32
SD_STEPS = 3               # the full-width epoch: 128 sprites, batch 32
SD_SAMPLES, SD_SAMPLE_STEPS = 8, 50   # generate_samples: prompts, x0-DDPM steps
SD_UNET_PARAMS = 859_544_008          # SD-1.5's UNet adapted to 8 latent channels


def sd_cases():
    """(a) The kernels at the SD UNet's shapes that no earlier phase reaches,
    batch 32, bf16: flash at head dims 40 (27^2, self and cross on the text
    keys), 80 and 160; GN+SiLU on the up path's 960- and 1920-channel
    concatenations and the 4^2 x 2560 site."""
    bf16, b = torch.bfloat16, SD_BATCH
    return [flash_case("sd 27^2 self hd40", b, 8, 729, 729, 40, False, bf16),
            flash_case("sd 27^2 cross hd40", b, 8, 729, 128, 40, True, bf16),
            flash_case("sd 14^2 self hd80", b, 8, 196, 196, 80, False, bf16),
            flash_case("sd 7^2 self hd160", b, 8, 49, 49, 160, False, bf16),
            gn_case("sd 27^2x960 G32", b, 27, 960, 32, bf16),
            gn_case("sd 14^2x1920 G32", b, 14, 1920, 32, bf16),
            gn_case("sd 4^2x2560 G32", b, 4, 2560, 32, bf16)]


# (a) the flash backward kernel at the SD UNet's attention shapes, batch 32
SD_BWD_CASES = tuple((f"{name} b{SD_BATCH}", (SD_BATCH, 8, *shape), torch.bfloat16)
                     for name, shape in (("sd 27^2 self hd40", (729, 729, 40, False)),
                                         ("sd 27^2 cross hd40", (729, 128, 40, True)),
                                         ("sd 14^2 self hd80", (196, 196, 80, False)),
                                         ("sd 7^2 self hd160", (49, 49, 160, False))))


def predicted_sd_launches(trainer, n_unet_evals, *, text_encodes=1, encodes=0, decodes=0,
                          grad=False):
    """Launches from the SD UNet's structure: per evaluation two GN+SiLU
    per resnet plus conv_norm_out, and two attention calls per transformer;
    the text encodes and VAE passes as ``predicted_launches`` counts them.
    With ``grad`` (a training step) every flash call also launches the
    backward kernel: the SD step trains BERT and the UNet, and the VAE
    encoder (under ``no_grad``, stage2_sd.py) holds no attention."""
    spec = trainer.spec
    nlvl, lpb = len(spec.channels), spec.layers_per_block
    resnets = nlvl * lpb + 2 + nlvl * (lpb + 1)
    transformers = (nlvl - 1) * lpb + 1 + (nlvl - 1) * (lpb + 1)
    out = predicted_launches(trainer, 0, text_encodes=text_encodes, encodes=encodes,
                             decodes=decodes)
    out["group_norm_silu"] += n_unet_evals * (2 * resnets + 1)
    out["flash_attention"] += n_unet_evals * 2 * transformers
    return with_flash_backward(out, out["flash_attention"]) if grad else out


def phase_sd_card_vs_cpu(tmp):
    """(b) The tiny SD trainer (the tiny SD spec, the text projection 48 ->
    768, T 50) on the CPU (plain versions) and on the card (kernels) in
    fp32, the same parameters, batches and draws: the first step's loss and
    every leaf's gradient, then the parameters after 3 steps."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.nn.layers import prepare_weights
    from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer

    corpus = write_sprite_corpus(Path(tmp) / "sd_corpus", n=12, seed=0, size=64)
    cfg = _tiny_train_config(Path(tmp) / "sd_exp", corpus)
    cfg.extra = {}
    cpu = SDDiffusionTrainer(cfg, None, experiment_name="cpu", device="cpu")
    card = SDDiffusionTrainer(cfg, None, experiment_name="card", device="cuda")
    card.frozen_vae = prepare_weights(bridge.fit(card.frozen_vae, cpu.frozen_vae))
    card.state = card._fresh_state(bridge.fit(card.state.params, cpu.state.params), step=0,
                                   rng=card.state.rng)
    rs = np.random.RandomState(0)
    batches = [next(iter(cpu.train_loader)) for _ in range(3)]
    b = cfg.data.batch_size
    lat = (b, cpu.latent_size, cpu.latent_size, cfg.model.latent_dim)
    draws = [{"rep_noise": torch.from_numpy(rs.randn(*lat).astype(np.float32)),
              "t": torch.from_numpy(rs.randint(0, cpu.schedule.num_timesteps, b)),
              "noise": torch.from_numpy(rs.randn(*lat).astype(np.float32))}
             for _ in batches]
    ops.reset_launch_counts()
    loss_cpu, g_cpu = cpu._grads(cpu._batch(batches[0]), draws=draws[0])
    loss_card, g_card = card._grads(card._batch(batches[0]), draws=draws[0])
    counts = ops.launch_counts()
    want = predicted_sd_launches(card, 1, encodes=1, grad=True)
    if counts != want:
        fail(f"sd card vs CPU: first step's launches {counts} != predicted {want}")
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    if not loss_rel <= TRAIN_LOSS_RTOL:
        fail(f"sd card vs CPU: loss rel diff {loss_rel:.3g} > {TRAIN_LOSS_RTOL}")
    grad_err = 0.0
    for (path, r), (_, g) in zip(tree.items(g_cpu), tree.items(g_card)):
        err = (g.float().cpu() - r).abs().max().item()
        lim = TRAIN_GRAD_RTOL * r.abs().max().item() + 1e-6
        grad_err = max(grad_err, err / lim)
        if not err <= lim:
            fail(f"sd card vs CPU: gradient {path} max|dg| {err:.3g} > {lim:.3g}")
    cpu._apply_update(loss_cpu, g_cpu)
    card._apply_update(loss_card, g_card)
    for batch, d in zip(batches[1:], draws[1:]):
        cpu._step(cpu._batch(batch), draws=d)
        card._step(card._batch(batch), draws=d)
    param_err = max((a.detach().cpu() - r.detach()).abs().max().item() for a, r in zip(
        tree.leaves(card.state.params), tree.leaves(cpu.state.params)))
    if not param_err <= TRAIN_PARAM_ATOL:
        fail(f"sd card vs CPU: params after 3 steps {param_err:.3g} > {TRAIN_PARAM_ATOL}")
    return {"train_mode": card.train_mode, "loss_cpu": float(loss_cpu),
            "loss_card": float(loss_card), "loss_rel": loss_rel, "loss_rtol": TRAIN_LOSS_RTOL,
            "grad_err_over_bound": grad_err, "grad_rtol": TRAIN_GRAD_RTOL,
            "params_after_3_steps_max_abs": param_err, "params_atol": TRAIN_PARAM_ATOL,
            "first_step_launches": counts}


def phase_sd_full_width(exp, corpus, vae_checkpoint):
    """(c) ``--use-diffusers`` stage 2 at full width: config/train_config.yaml
    (SD-1.5 with 768-d cross-attention, no text projection; BERT-base trained
    with the 'minimal' strategy; the cosine schedule; bf16, batch 32), the
    frozen VAE and the text encoder from phase 7's best, on the 128 sprites:
    train_epoch (3 steps), validate, one best write (save_checkpoint) and
    generate_samples (8 prompts, 50 x0-DDPM steps, then the VAE decode).
    The epoch count and the sample and save cadences are cut here, not in
    the file.  Counts are set to 0 before train_epoch and read after the
    samples; one more step is then profiled for its device time."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.diffusion.sampling import x0_timesteps
    from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer

    cfg = load_config(CONFIG, [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                               f"data.image_dir={corpus[1]}", "training.diffusion_epochs=1",
                               "training.sample_every=1", "training.save_every=1000"])
    if (cfg.model.compute_dtype, cfg.data.batch_size, cfg.model.cross_attention_dim) != (
            "bfloat16", SD_BATCH, 768):
        fail(f"{CONFIG.name} is not the bf16 batch-32 768-d configuration")
    t0 = time.perf_counter()
    trainer = SDDiffusionTrainer(cfg, vae_checkpoint, experiment_name="smoke", device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    if len(trainer.train_loader) != SD_STEPS:
        fail(f"the SD epoch has {len(trainer.train_loader)} steps, not {SD_STEPS}")
    n_unet = sum(t.numel() for t in tree.leaves(trainer.state.params["sd"]))
    n_text = sum(t.numel() for t in tree.leaves(trainer.state.params["text"]))
    if n_unet != SD_UNET_PARAMS or "text_projection" in trainer.state.params["sd"]:
        fail(f"the SD wrapper has {n_unet} parameters, not {SD_UNET_PARAMS} (no projection)")
    trainable = sum(p.numel() for p, lab in zip(tree.leaves(trainer.state.params),
                                                trainer.tx.labels) if lab != "frozen")
    watch = [t.detach().clone() for t in tree.leaves(trainer.state.params)[::53]]

    step_s, step_loss = [], []
    orig_step = trainer._step

    def timed_step(batch, draws=None):
        t = time.perf_counter()
        parts = orig_step(batch, draws=draws)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        step_loss.append(float(parts["loss"]))
        return parts

    trainer._step = timed_step
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()          # this path's counted run starts here
    per_step = predicted_sd_launches(trainer, 1, encodes=1, grad=True)
    evals = len(x0_timesteps(cfg.model.num_timesteps, SD_SAMPLE_STEPS))
    want = {"train_epoch": {k: SD_STEPS * v for k, v in per_step.items()},
            "validate": {k: len(trainer.val_loader) * v
                         for k, v in forward_only(per_step).items()},
            "generate_samples": predicted_sd_launches(trainer, evals, decodes=1)}
    got = {}

    def part(name, fn):
        before = ops.launch_counts()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        if name is not None:
            got[name] = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return out, time.perf_counter() - t

    stats, epoch_s = part("train_epoch", lambda: trainer.train_epoch(0))
    peak = torch.cuda.max_memory_allocated()
    val, val_s = part("validate", lambda: trainer.validate(0))
    t0 = time.perf_counter()
    if not trainer.save_checkpoint(0, val):
        fail("save_checkpoint wrote no best checkpoint")
    save_s = time.perf_counter() - t0
    grid, sample_s = part("generate_samples", lambda: trainer.generate_samples(
        0, num=SD_SAMPLES, steps=SD_SAMPLE_STEPS))
    launches = ops.launch_counts()     # ... and ends here
    for name in want:
        if got[name] != want[name]:
            fail(f"sd {name}: kernel launches {got[name]} != predicted {want[name]}")
    best = trainer.ckpt.best_path
    ckpt = sorted(p.name for p in best.parent.iterdir())
    if ckpt != ["diffusers_best_model.ckpt", "diffusers_best_model.json"]:
        fail(f"the SD epoch wrote {ckpt}, not one best")
    batch = trainer._batch(next(iter(trainer.train_loader)))
    _, step_device_ms = _device_ms(lambda: orig_step(batch))
    skipped = trainer.skipped_batches()
    changed = sum(not torch.equal(a, b.detach()) for a, b in zip(
        watch, tree.leaves(trainer.state.params)[::53]))
    if not (np.isfinite(step_loss).all() and np.isfinite(val)) or skipped or not changed:
        fail(f"sd epoch: losses {step_loss}, val {val}, skipped {skipped}, "
             f"changed {changed}/{len(watch)}")
    if not grid.exists():
        fail("generate_samples wrote no grid")
    meta = json.loads(best.with_suffix(".json").read_text())
    if meta["vae_checkpoint"] != str(vae_checkpoint):
        fail(f"the SD best names {meta['vae_checkpoint']}, not {vae_checkpoint}")
    steady = float(np.mean(step_s[1:]))
    train_mode = trainer.train_mode
    del trainer, batch
    release()
    return {"train_mode": train_mode, "unet_params": n_unet, "text_params": n_text,
            "trainable_params": trainable, "init_s": init_s, "step_s": step_s,
            "step_wall_after_first_s": steady, "samples_per_s": SD_BATCH / steady,
            "step_device_ms": step_device_ms, "epoch_s": epoch_s, "step_loss": step_loss,
            "train_loss": stats["loss"], "grad_norm": stats["grad_norm"], "val_loss": val,
            "validate_s": val_s, "generate_samples_s": sample_s, "sample_grid": grid.name,
            "peak_mem_gb": peak / 1e9, "skipped_batches": skipped,
            "watched_leaves_changed": f"{changed}/{len(watch)}", "save_best_s": save_s,
            "checkpoint": str(best), "checkpoint_gb": best.stat().st_size / 1e9,
            "predicted_per_step": per_step, "launches_by_part": got, "launches": launches}


# ---------------------------------------------------------------------------
# phase 12: scale-out (the port's parallel/, mesh= on the trainer and the
# generator, graft_entry)
# ---------------------------------------------------------------------------


def _nccl_profile(step):
    """One ``step()`` under torch.profiler: {NCCL kernel: summed device ms}
    and {all-reduce op: the bytes of its recorded inputs}."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        step()
        torch.cuda.synchronize()
    kernels, calls = {}, {}
    for evt in prof.events():
        name = evt.name.lower()
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            # kernels only: the profiler lists the "nccl:all_reduce" range too
            if ("nccl" in name or "onerankreduce" in name) and not name.startswith("nccl:"):
                kernels[evt.name] = kernels.get(evt.name, 0.0) + evt.device_time_total / 1e3
        elif "allreduce" in name.replace("_", "") and evt.input_shapes:
            shapes = [s for s in evt.input_shapes if s and not isinstance(s[0], list)]
            shapes += [t for s in evt.input_shapes if s and isinstance(s[0], list) for t in s]
            calls[evt.name] = calls.get(evt.name, 0) + 4 * sum(math.prod(t) for t in shapes)
    return kernels, calls


def phase_scale_out(exp, corpus, vae_checkpoint, sprites):
    """(a) A one-rank NCCL group and a (1, 1) mesh.  (b) The full-width
    stage-2 trainer on the mesh against one without, from the same start
    (seed, phase 7's stage-1 checkpoint, the 128 sprites): train_epoch (3
    steps), validate, one best write.  Phase 6b's bounds: losses rel 1e-4,
    the first step's gradients 1e-3 max|g| + 1e-6 a leaf, params, moments
    and the checkpoint read back within 1e-4 where every step's gradient
    is determined; and their L2 distance from the run without a mesh at
    most twice that of a second run without one (the bf16 step is not
    bit-reproducible on the card).  One profiled step must run an NCCL
    all-reduce over the gradient's bytes.  (c) generate_batch on the mesh
    (batch 4, DDIM 20, CFG) against phase 4's images, MAE <= 1e-6.  (d)
    graft_entry.entry().  Counts are set to 0 before the mesh trainer's
    epoch and read after entry()."""
    import socket
    import torch.distributed as dist

    from psg_tpu_torch import ops
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.checkpoint import read_checkpoint
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.graft_entry import entry
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.models.unet import UNetSpec
    from psg_tpu_torch.parallel import initialize_distributed, make_mesh
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    if not initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda", timeout_s=300):
        fail("initialize_distributed started no group")
    mesh = make_mesh(data=1, model=1)
    group_s = time.perf_counter() - t0
    if dist.get_backend() != "nccl":
        fail(f"the one-rank group runs {dist.get_backend()}, not nccl")
    try:
        cfg = load_config(CONFIG, [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                                   f"data.image_dir={corpus[1]}", "training.save_every=1000"])

        def run(name, mesh_, on_grads):
            """train_epoch and validate, each step's wall and loss kept and
            its gradient handed to ``on_grads(step, {path: grad})``."""
            trainer = DiffusionTrainer(cfg, vae_checkpoint, experiment_name=name,
                                       device="cuda", mesh=mesh_)
            step_s, losses, orig, orig_grads = [], [], trainer._step, trainer._grads

            def grads_seen(batch, draws=None):
                out = orig_grads(batch, draws=draws)
                on_grads(len(losses), dict(tree.items(out[1])))
                return out

            def timed(batch, draws=None):
                t = time.perf_counter()
                parts = orig(batch, draws=draws)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t)
                losses.append(float(parts["loss"]))
                return parts

            trainer._grads, trainer._step = grads_seen, timed
            stats = trainer.train_epoch(0)
            val = trainer.validate(0)
            del trainer._grads, trainer._step
            return trainer, step_s, losses, stats, val, orig

        # the reference's gradients, and where every step's is determined: |g|
        # at least 100x the card bound, so Adam's step does not hang on the
        # order of cuDNN's and the bilinear backward's atomic sums
        ref_grads, determined = [], {}

        def keep_ref(step, grads):
            ref_grads.append({k: g.detach().clone() for k, g in grads.items()})
            for k, g in grads.items():
                a = g.detach().abs()
                det = a >= 100 * (TRAIN_GRAD_RTOL * a.max() + 1e-6)
                determined[k] = det if k not in determined else determined[k] & det

        ref, ref_step_s, ref_losses, _, ref_val, _ = run("scale_ref", None, keep_ref)
        want = {k: dict(tree.items(getattr(ref.state, k))) for k in ("params", "ema")
                if getattr(ref.state, k) is not None}
        want = {k: {p: t.detach().clone() for p, t in v.items()} for k, v in want.items()}
        want["mu"] = {p: m.clone() for p, m in ref.state.opt_state["groups"]["unet"]["mu"].items()}
        per_step = predicted_train_launches(ref)
        del ref
        release()

        def l2(got, ref_tree):
            """The L2 distance of a tree from ``ref_tree`` (fp64 sum)."""
            return math.sqrt(sum(float((got[k].detach().double() - r.double()).square().sum())
                                 for k, r in ref_tree.items()))

        # the floor: a second run without a mesh lands this far from the first
        # (the card's bf16 step is not bit-reproducible, and Adam moves a
        # noise-gradient element by up to lr); the mesh must land no farther
        again, *_ = run("scale_ref_again", None, lambda step, grads: None)
        floor = {"params": l2(dict(tree.items(again.state.params)), want["params"]),
                 "mu": l2(again.state.opt_state["groups"]["unet"]["mu"], want["mu"])}
        del again
        release()

        # each step's worst leaf, max|dg| / (1e-3 max|g| + 1e-6); phase 6b's bound
        # holds the first step's (later steps start from params that Adam moved
        # apart by up to lr where the gradient was noise)
        grad_ratio = []

        def check_grads(step, grads):
            grad_ratio.append(max(
                float((g.float() - ref_grads[step][k]).abs().max())
                / (TRAIN_GRAD_RTOL * float(ref_grads[step][k].abs().max()) + 1e-6)
                for k, g in grads.items()))

        ops.reset_launch_counts()          # this path's counted run starts here
        trainer, step_s, losses, stats, val, orig_step = run("scale_mesh", mesh, check_grads)
        del ref_grads
        t = time.perf_counter()
        if not trainer.save_checkpoint(0, val):
            fail("the mesh trainer wrote no best checkpoint")
        save_s = time.perf_counter() - t

        def err(got, ref_tree):
            """(max abs error where determined, max abs error anywhere)."""
            d = [(float((got[k].detach().float() - r.float())[determined[k]].abs().max())
                  if determined[k].any() else 0.0,
                  float((got[k].detach().float() - r.float()).abs().max()))
                 for k, r in ref_tree.items()]
            return max(a for a, _ in d), max(b for _, b in d)

        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
        val_err = abs(val - ref_val) / abs(ref_val)
        errs, anywhere, dist_ = {}, {}, {}
        for k in want:
            got = (dict(tree.items(getattr(trainer.state, k))) if k != "mu"
                   else trainer.state.opt_state["groups"]["unet"]["mu"])
            errs[k], anywhere[k] = err(got, want[k])
            dist_[k] = l2(got, want[k])
        t = time.perf_counter()
        raw = read_checkpoint(trainer.ckpt.best_path)
        read_s = time.perf_counter() - t
        saved = {p: x.to("cuda") for p, x in tree.items(bridge.from_jax(raw["params"]))}
        errs["checkpoint_params"], anywhere["checkpoint_params"] = err(saved, want["params"])
        dist_["checkpoint_params"] = l2(saved, want["params"])
        judged = (sum(int(m.sum()) for m in determined.values())
                  / sum(m.numel() for m in determined.values()))
        if int(raw["step"]) != FULL_STEPS:
            fail(f"the mesh checkpoint holds step {int(raw['step'])}, not {FULL_STEPS}")
        del raw, saved, want, determined
        floor["checkpoint_params"] = floor["params"]
        if not (loss_err <= TRAIN_LOSS_RTOL and val_err <= TRAIN_LOSS_RTOL
                and grad_ratio[0] <= 1.0 and max(errs.values()) <= TRAIN_PARAM_ATOL
                and all(dist_[k] <= 2.0 * floor[k] + 1e-6 for k in dist_)):
            fail(f"stage 2 on the mesh against no mesh: losses rel {loss_err:.3g}, val rel "
                 f"{val_err:.3g}, first step's gradients {grad_ratio[0]:.3g} of their bound, "
                 f"{errs} where determined (bounds {TRAIN_LOSS_RTOL}, {TRAIN_PARAM_ATOL}), "
                 f"L2 distances {dist_} against twice the no-mesh runs' {floor}")

        batch = trainer._batch(next(iter(trainer.train_loader)))
        grad_bytes = sum(p.numel() * 4 for p in tree.leaves(trainer.state.params))
        nccl, call_bytes = _nccl_profile(lambda: orig_step(batch))
        train_launches = ops.launch_counts()    # 3 steps, validation, the profiled step
        want_train = {k: (FULL_STEPS + 1) * v + len(trainer.val_loader) * forward_only(
            per_step)[k] for k, v in per_step.items()}
        if train_launches != want_train:
            fail(f"mesh train_epoch + validate + a step: launches {train_launches} "
                 f"!= {want_train}")
        reducer = trainer.mesh_run.reducer
        if not nccl:
            fail("the profiled mesh step ran no NCCL kernel")
        if reducer.bucket_bytes_total != grad_bytes:
            fail(f"the all-reduce buckets hold {reducer.bucket_bytes_total} bytes, "
                 f"the gradient {grad_bytes}")
        del trainer, batch
        release()

        gen_cfg = full_width_config(corpus)
        gen = PokemonGenerator(gen_cfg, tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB),
                               sampler="dpmpp", guidance_scale=2.0, negative=NEGATIVE,
                               device="cuda", mesh=mesh)
        t = time.perf_counter()
        imgs = gen.generate_batch(PROMPTS, 20, seed=0, sampler="ddim")
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t
        gen_mae = float(np.abs(imgs - sprites).mean())
        # the request's prompts and, at construction, the negative prompt
        want_gen = predicted_launches(gen, 20, text_encodes=2)
        del gen
        release()
        if imgs.shape != sprites.shape or not gen_mae <= 1e-6:
            fail(f"generate_batch on the mesh against phase 4: MAE {gen_mae:.3g} > 1e-6")

        t = time.perf_counter()
        out = entry()
        torch.cuda.synchronize()
        entry_s = time.perf_counter() - t
        if tuple(out.shape) != (4, 27, 27, 8) or not bool(torch.isfinite(out).all()):
            fail(f"graft_entry.entry(): {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
        del out
        release()
        launches = ops.launch_counts()     # ... and ends here
        spec = UNetSpec(text_dim=768, num_heads=4)
        entry_want = {"group_norm_silu": 2 * (2 * len(spec.channels) * spec.blocks_per_level
                                              + 1) + 1,
                      "flash_attention": 2 * (2 * spec.blocks_per_level
                                              * sum(spec.attention_levels) + 1),
                      "spatial_xattn": 0, "flash_attention_bwd": 0}
        total_want = {k: want_train[k] + want_gen[k] + entry_want[k] for k in want_train}
        if launches != total_want:
            fail(f"phase 12 launches {launches} != predicted {total_want}")
    finally:
        dist.destroy_process_group()
    steady = float(np.mean(step_s[1:]))
    return {"group_s": group_s, "mesh": {"data": 1, "model": 1}, "backend": "nccl",
            "step_s": step_s, "ref_step_s": ref_step_s,
            "step_wall_after_first_s": steady, "ref_step_wall_after_first_s":
            float(np.mean(ref_step_s[1:])), "samples_per_s": 32 / steady,
            "step_loss": losses, "ref_step_loss": ref_losses, "val_loss": val,
            "ref_val_loss": ref_val, "loss_max_rel_err": loss_err, "val_rel_err": val_err,
            "grad_err_of_bound": grad_ratio, "max_abs_err_determined": errs,
            "max_abs_err_anywhere": anywhere, "determined_share": judged,
            "l2_from_reference": dist_, "l2_between_two_references": floor,
            "params_atol": TRAIN_PARAM_ATOL, "save_best_s": save_s,
            "read_best_s": read_s, "nccl_kernels_ms": nccl,
            "allreduce_ms": sum(nccl.values()), "allreduce_call_bytes": call_bytes,
            "train_launches": train_launches,
            "grad_bytes": grad_bytes, "buckets": len(reducer._buckets),
            "generate_batch_s": gen_s, "generate_batch_mae_vs_phase4": gen_mae,
            "entry_s": entry_s, "predicted_per_step": per_step, "launches": launches,
            "predicted_launches": total_want}


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
# phase 13: async checkpoint writes at full width
# ---------------------------------------------------------------------------

CKPT_INFLIGHT_STEPS = 6    # steps timed with a full-state write in flight, and without
CKPT_PIPE_S = 300          # the longest a piped checkpoint file may take


def _bytes_written_gb():
    """Bytes this process has passed to write(), GB (/proc/self/io), or None."""
    try:
        io = dict(ln.split(": ") for ln in Path("/proc/self/io").read_text().splitlines())
        return int(io["wchar"]) / 1e9
    except (OSError, KeyError, ValueError):
        return None


class _PipedFile:
    """A checkpoint file whose bytes go through a pipe and not to the disk.
    The writer writes a temporary file beside its destination (its name:
    the destination's suffix, ``.<pid>.tmp``) and renames it into place;
    here that temporary path is made a FIFO first, which a thread drains as
    the writer writes (and hashes, with ``digest``).  The rename then moves
    the FIFO into place; the sidecar is a plain file.  Phase 13 passes 40 GB
    through the writer, and a card machine whose disk takes at most 45 GiB
    of writes a run (deleted files included) would end the smoke there:
    phases 1-12 write most of that."""

    def __init__(self, path, digest=True):
        path = Path(path)
        fifo = path.with_suffix(f"{path.suffix}.{os.getpid()}.tmp")
        os.mkfifo(fifo)
        self.nbytes, self.error = 0, None
        self._hash = hashlib.sha256() if digest else None
        self._thread = threading.Thread(target=self._drain, args=(fifo,), daemon=True)
        self._thread.start()

    def _drain(self, fifo):
        buf = memoryview(bytearray(16 << 20))
        try:
            with open(fifo, "rb", buffering=0) as f:
                fcntl.fcntl(f, fcntl.F_SETPIPE_SZ, 1 << 20)
                while n := f.readinto(buf):
                    self.nbytes += n
                    if self._hash is not None:
                        self._hash.update(buf[:n])
        except BaseException as e:     # reported by result()
            self.error = e

    def result(self):
        """(GB, sha256 or None) once the writer closed the file."""
        self._thread.join(CKPT_PIPE_S)
        if self._thread.is_alive() or self.error is not None:
            fail(f"checkpoints: the piped file was not written whole: {self.error!r}")
        return self.nbytes / 1e9, None if self._hash is None else self._hash.hexdigest()


def _pinned_gb(manager):
    """GB of the host buffers an async manager keeps, and of the pinned
    blocks PyTorch's host allocator holds (``host_memory_stats``; None where
    this PyTorch does not count them)."""
    stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
    held = stats.get("allocated_bytes.current", stats.get("reserved_bytes.current"))
    return {"manager_buffers_gb": sum(b.nbytes for b in manager._buffers.values()) / 1e9,
            "host_allocator_gb": None if held is None else held / 1e9}


def _sidecar_but_time(path):
    meta = json.loads(Path(path).with_suffix(".json").read_text())
    meta.pop("time")
    return meta


def _rss_gb():
    """This process's resident size, GB (/proc/self/statm)."""
    return int(Path("/proc/self/statm").read_text().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e9


class _PeakRss:
    """The largest resident size seen every 20 ms inside the block (the
    process's own peak, ``ru_maxrss``, cannot be started anew)."""

    def __enter__(self):
        self.peak_gb = _rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak_gb = max(self.peak_gb, _rss_gb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gb = max(self.peak_gb, _rss_gb())


def phase_checkpoints(exp, corpus, vae_checkpoint, diffusion_checkpoint, disk_write):
    """13. Async checkpoint writes on phase 8c's full-width stage-3 trainer
    (config/train_config.yaml, batch 32, the bests of phases 7 and 6c),
    switched to its joint phase: its full state (params, EMA-free, both
    Adam moments of three groups) is the smoke's largest.  (a) Bytes: the
    state written sync to one manager and async to another, one training
    step run while the async write is in flight; the two files' sha256 and
    their sidecars but ``time`` must be equal; the same for a light best.
    (b) One epoch (3 steps) ending in a full best write forced by a fresh
    manager's metric, with ``async_writes`` off and on: seconds ``save``
    blocked, the write's own seconds up to ``wait()``, the step wall with
    the write in flight and without one, the epoch wall, the host's peak
    resident size; and the period of a real epoch (the 898-sprite
    dataset's train split at batch 32) projected from them and from
    ``disk_write`` (GB, seconds), phase 8c's sync write of the same state to
    the disk; the pinned host memory the async manager keeps.  (c) A write
    into a directory that is a file must raise at ``wait()``.  The large
    files are pipes (``_PipedFile``), so the write seconds here are the
    serializer's through a pipe (and SHA-256 in (a)), not the disk's.
    Counts are set to 0 before the first step and read after the last."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.core import checkpoint as ckpt
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.data.dataset import split_indices
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    cfg = load_config(CONFIG, [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                               f"data.image_dir={corpus[1]}", "training.final_epochs=2",
                               "training.phase1_epochs=1"])
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_")
    root = Path(tmp.name) / "phase13"
    written_before = _bytes_written_gb()
    release()
    t0 = time.perf_counter()
    trainer = FinalTrainer(cfg, vae_checkpoint, diffusion_checkpoint, experiment_name="ckpt",
                           device="cuda")
    trainer.switch_to_joint_training()
    batches = [trainer._batch(b) for b in trainer.train_loader]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_steps = [0]

    def step():
        t = time.perf_counter()
        loss = float(trainer._step(batches[n_steps[0] % len(batches)])["total_loss"])
        torch.cuda.synchronize()
        n_steps[0] += 1
        if not math.isfinite(loss):
            fail(f"checkpoints: non-finite loss {loss}")
        return time.perf_counter() - t

    ops.reset_launch_counts()          # this path's counted run starts here
    step()                             # cuDNN picks its kernels
    rec = {"init_s": init_s, "process_bytes_written_gb_before": written_before}

    # (a) the same bytes, with a training step under the write
    same = {}
    for kind in ("full state", "light best"):
        sync = ckpt.CheckpointManager(root / "sync", "final", 5, False)
        asyn = ckpt.CheckpointManager(root / "async", "final", 5, True)
        state, meta = trainer.state, trainer._meta(1)
        write = ((lambda m: m.save(state, state.step, 1.0, meta, periodic=False))
                 if kind == "full state" else
                 (lambda m: m.save_best_light(state.sample_params, state.step, 1.0, meta)))
        files = [_PipedFile(m.best_path) for m in (sync, asyn)]
        t = time.perf_counter()
        write(sync)
        sync_s = time.perf_counter() - t
        t = time.perf_counter()
        write(asyn)
        blocked_s = time.perf_counter() - t
        in_flight = ckpt._pending is not None and ckpt._pending.is_alive()
        step_s = step()
        still_in_flight = ckpt._pending is not None and ckpt._pending.is_alive()
        asyn.wait()
        write_s = time.perf_counter() - t
        (gb, sync_sha), (_, async_sha) = (f.result() for f in files)
        sides = [_sidecar_but_time(m.best_path) for m in (sync, asyn)]
        same[kind] = {"gb": gb, "sync_s": sync_s, "async_blocked_s": blocked_s,
                      "async_write_s": write_s, "step_in_flight": in_flight,
                      "in_flight_after_step": still_in_flight, "step_s": step_s,
                      "sha256": async_sha, "equal": sync_sha == async_sha
                      and sides[0] == sides[1]}
        if not in_flight:
            fail(f"checkpoints: the async {kind} write ended before the step under it")
        if not same[kind]["equal"]:
            fail(f"checkpoints: the async {kind} differs from the sync one: "
                 f"{sync_sha} {async_sha}, {sides[0] == sides[1]}")
        shutil.rmtree(root)
    rec["bytes"] = same

    # (b) the epoch with the switch off and on
    epochs = {}
    for async_writes in (False, True):
        trainer.ckpt = ckpt.CheckpointManager(root / f"epoch_{async_writes}", "final", 5,
                                              async_writes)
        piped = _PipedFile(trainer.ckpt.best_path, digest=False)
        rss_before = _rss_gb()
        with _PeakRss() as peak:
            t0 = time.perf_counter()
            walls = [step() for _ in range(FULL_STEPS)]
            t = time.perf_counter()
            trainer.ckpt.save(trainer.state, trainer.state.step, 1.0,
                              extra_meta=trainer._meta(1), periodic=False)
            blocked_s = time.perf_counter() - t
            epoch_s = time.perf_counter() - t0
            during, after, landed = [], [], None
            for _ in range(CKPT_INFLIGHT_STEPS):
                flying = ckpt._pending is not None and ckpt._pending.is_alive()
                if not flying and landed is None:
                    landed = time.perf_counter()
                (during if flying else after).append(step())
            trainer.ckpt.wait()
            write_s = (landed or time.perf_counter()) - t
        after += [step() for _ in range(CKPT_INFLIGHT_STEPS - len(after))]
        epochs["on" if async_writes else "off"] = {
            "gb": piped.result()[0], "epoch_steps_s": walls,
            "save_blocked_s": blocked_s, "write_s": write_s, "epoch_wall_s": epoch_s,
            "steps_in_flight_s": during, "steps_without_write_s": after,
            "mean_step_in_flight_s": float(np.mean(during)) if during else None,
            "mean_step_without_write_s": float(np.mean(after)),
            "rss_before_gb": rss_before, "peak_rss_gb": peak.peak_gb, "rss_after_gb": _rss_gb(),
            "pinned": _pinned_gb(trainer.ckpt)}
        shutil.rmtree(root)
    off, on = epochs["off"], epochs["on"]
    if not on["steps_in_flight_s"]:
        fail(f"checkpoints: the async write ended before a step could run under it: {on}")

    # (c) a write that cannot land raises at wait(), once
    bad = ckpt.CheckpointManager(root / "bad", "final", 5, True)
    shutil.rmtree(bad.dir)
    bad.dir.write_text("a file where the checkpoint directory was")
    bad.save_best_light({"w": torch.ones(4096, device="cuda")}, 0, 1.0)
    try:
        bad.wait()
    except RuntimeError as e:
        error = f"{e} <- {type(e.__cause__).__name__}: {e.__cause__}"
    else:
        fail("checkpoints: a write into a file's path did not raise at wait()")
    bad.wait()                         # raised once only
    tmp.cleanup()
    launches = ops.launch_counts()     # ... and ends here
    want = {k: n_steps[0] * v for k, v in predicted_stage3_launches(trainer).items()}
    if launches != want:
        fail(f"checkpoints: kernel launches {launches} != predicted {want}")

    # a real epoch: the 898-sprite dataset's train split at batch 32
    n_train = len(split_indices(898, cfg.data.val_split, cfg.data.test_split)[0])
    real_steps = n_train // S3_BATCH
    compute = real_steps * off["mean_step_without_write_s"]
    disk_gb, disk_s = disk_write
    rec.update(
        epochs=epochs, error=error, steps=n_steps[0], launches=launches,
        predicted_launches=want, process_bytes_written_gb_after=_bytes_written_gb(),
        projection={"real_epoch_steps": real_steps, "compute_s": compute,
                    "disk_write_gb": disk_gb, "disk_write_s": disk_s,
                    "period_off_s": compute + disk_s,
                    "period_on_s": max(compute + on["save_blocked_s"], disk_s)})
    del trainer, batches
    release()
    return rec


# ---------------------------------------------------------------------------
# phase 14: the evaluation and evidence scripts
# ---------------------------------------------------------------------------

EVAL_N = 8              # captions an eval run scores (the JAX script's default)
EVAL_SCORE_TOL = 2e-3   # the conditioning scores' bound (tests/test_torch_eval_scripts.py)
SWEEP = ("g=2.0,steps=10,restarts=1", "g=3.5,resc=0.7,lo=0.1,hi=0.8,steps=10,restarts=1")


def _script(rel):
    """A script of the checkout as a module (registered in ``sys.modules``:
    its dataclasses look their module up there)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(rel).stem, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def request_launches(gen, keys, method, n_prompts, kw, index_encodes):
    """Kernel launches and UNet graph counts of one public request, from
    the model's structure: its chain and each restart pass (a text encode,
    the UNet evaluations and a decode; a restart also an encode), a VAE
    encode and a query encode a prompt when retrieval seeds it, and
    ``index_encodes`` when the retrieval index is built inside it.  Fused
    CFG doubles a UNet call's rows, not its launches; ``keys``: the
    generator's ``UNetGraphKeys``."""
    restarts = kw.get("restarts", 0)
    seeded = method == "generate_from_text_retrieval" or kw.get("init") == "retrieval"
    sampler = kw.get("sampler") or gen.sampler_name
    evals = unet_evals(gen, sampler, kw["num_inference_steps"]) * (1 + restarts)
    graphs = keys.request(sampler, n_prompts, evals)
    return predicted_launches(gen, evals,
                              text_encodes=(1 + restarts + index_encodes
                                            + (n_prompts if seeded else 0)),
                              encodes=int(seeded) + restarts, decodes=1 + restarts,
                              captures=graphs["capture"]), graphs


def _watch_requests(gen, requests, expected, corpus_size):
    """Time each public request the scripts make of ``gen`` (ending in a
    sync) and hold its launches and UNet graph counts to
    ``request_launches``."""
    from psg_tpu_torch import ops

    keys = UNetGraphKeys(gen)
    for method in ("generate_batch", "generate_from_text_retrieval"):
        orig = getattr(gen, method)

        def watched(descriptions, _orig=orig, _method=method, **kw):
            batch = _method == "generate_batch"
            seeded = not batch or kw.get("init") == "retrieval"
            index = math.ceil(corpus_size / 64) if seeded and gen._retr is None else 0
            n = len(descriptions) if batch else 1
            want, want_graphs = request_launches(gen, keys, _method, n, kw, index)
            before, g0 = ops.launch_counts(), unet_graph_counts()
            t = time.perf_counter()
            out = _orig(descriptions, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            got = {k: v - before[k] for k, v in ops.launch_counts().items()}
            graphs = graph_delta(g0)
            for k in expected:
                expected[k] += want[k]
            kind = (f"{_method} n={n} {kw.get('sampler') or gen.sampler_name}"
                    f"@{kw['num_inference_steps']} g={gen.guidance_scale}"
                    f" restarts={kw.get('restarts', 0)}"
                    + (f" init={kw.get('init', 'prior')}" if batch else " loo")
                    + (" (index built)" if index else ""))
            requests.append({"request": kind, "wall_s": wall, "launches": got,
                             "predicted": want, "unet_graphs": graphs})
            if got != want:
                fail(f"{kind}: kernel launches {got} != predicted {want}")
            if graphs != want_graphs:
                fail(f"{kind}: UNet graphs {graphs} != predicted {want_graphs}")
            return out

        setattr(gen, method, watched)


def _check_images(name, images, size, n):
    arr = np.asarray(images, np.float32)
    if arr.shape != (n, size, size, 3) or not np.isfinite(arr).all():
        fail(f"{name}: bad images {arr.shape}")


def _check_report(name, rep, n):
    keys = {"n", "retrieval_at_1", "chance_retrieval", "margin", "checkpoint", "sampler",
            "guidance", "negative", "init", "seed", "grid"}
    if not keys <= rep.keys() or rep["n"] != n or not 0.0 <= rep["retrieval_at_1"] <= 1.0:
        fail(f"{name}: bad report {sorted(rep)}")
    if not Path(rep["grid"]).is_file() or not Path(rep["grid"]).with_suffix(".txt").is_file():
        fail(f"{name}: no grid beside the report")


def phase_eval_scripts(exp, corpus, diffusion_checkpoint):
    """14. The evaluation and evidence scripts at full width
    (config/train_config.yaml: bf16, BERT-base, the full UNet and VAE,
    215x215) on phase 6c's 128 sprites, serving experiment "smoke": phase
    7c's stage-1 best, 6c's stage-2 best and 8c's final bundle.  Their
    functions run in-process on generators from ``build_generator``:
    (a) ``torch_eval_conditioning`` dpmpp@25 at guidance 0 over seeds
    1234 and 1235 with ``stamp=1``; a fresh ``build_generator`` then must
    resolve the stamped checkpoint, its hub candidate carrying the report's
    retrieval@1; on it dpmpp@25 at guidance 2.0 with the ``mean`` negative.
    (b) dpmpp@10 with ``init=retrieval-loo`` (retrieval and the VAE
    encoder) and with ``prompts=paraphrase``; neither stamps.  (c)
    ``torch_recipe_sweep`` with the two ``SWEEP`` recipes.  (d)
    ``torch_ddim_evidence`` DDIM@20 on its 8 ``PROMPTS``, served from the
    final bundle (``extra.serve_prefer_final``).  Each request's launches
    are held to ``request_launches``; counts are set to 0 before the first
    build and read after (d)."""
    from psg_tpu_torch import ops
    from psg_tpu_torch.data.dataset import PokemonDataset
    from psg_tpu_torch.serve import hub
    from psg_tpu_torch.serve.app import build_generator

    ev = _script("scripts/torch_eval_conditioning.py")
    sw = _script("scripts/torch_recipe_sweep.py")
    dd = _script("scripts/torch_ddim_evidence.py")
    out = Path(exp) / "phase14"
    overrides = [f"experiment_dir={exp}", f"data.csv_path={corpus[0]}",
                 f"data.image_dir={corpus[1]}"]
    ds = PokemonDataset(*corpus, image_size=215)
    side = Path(diffusion_checkpoint).with_suffix(".json")
    requests, expected, subs, gens = [], {k: 0 for k in ops.launch_counts()}, {}, {}
    release()

    def build(*, extra=(), **kw):
        t = time.perf_counter()
        gen = build_generator(CONFIG, "smoke", overrides + list(extra), device="cuda", **kw)
        torch.cuda.synchronize()
        if (gen.cfg.model.compute_dtype, gen.cfg.data.image_size) != ("bfloat16", 215):
            fail(f"{CONFIG.name} is not the full-width bf16 configuration")
        if gen.negative == "mean":    # one encode of the dataset's captions
            want = predicted_launches(gen, 0, decodes=0)
            for k in expected:
                expected[k] += want[k]
        _watch_requests(gen, requests, expected, len(ds))
        return gen, time.perf_counter() - t

    def timed(runs, label, fn):
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        runs.append({"run": label, "wall_s": time.perf_counter() - t})
        return result

    def sub(name, fn):
        first, before, wrote = len(requests), ops.launch_counts(), _bytes_written_gb()
        want_before = dict(expected)
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        rec = fn()
        torch.cuda.synchronize()
        subs[name] = {**rec, "wall_s": time.perf_counter() - t,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "bytes_written_gb": _bytes_written_gb() - wrote,
                      "requests": requests[first:],
                      "launches": {k: v - before[k] for k, v in ops.launch_counts().items()},
                      "predicted": {k: v - want_before[k] for k, v in expected.items()}}
        if subs[name]["launches"] != subs[name]["predicted"]:
            fail(f"phase 14{name}: launches {subs[name]['launches']} "
                 f"!= predicted {subs[name]['predicted']}")

    def stamp_and_guidance():
        gen, build_s = build(sampler="dpmpp", guidance=0.0, negative="zero")
        if (gen.loaded, gen.diffusion_checkpoint) != ("pair", str(diffusion_checkpoint)):
            fail(f"eval: served {gen.loaded} {gen.diffusion_checkpoint}, not the stage-2 pair")
        opts = ev.parse_args(["smoke", str(EVAL_N), "25", "dpmpp", "0.0",
                              str(out / "eval.json"), "seeds=1234,1235", "stamp=1"])
        captions, names, real = ev.eval_set(ds, opts)
        runs, reports = [], []
        for seed, path, stamp in ev.seed_outputs(opts):
            imgs, rep = timed(runs, f"eval dpmpp@25 g=0 seed={seed} stamp={stamp}",
                              lambda: ev.evaluate(gen, captions, real, names, opts, seed,
                                                  path, stamp))
            _check_images("eval", imgs, 215, EVAL_N)
            _check_report("eval", rep, EVAL_N)
            reports.append(rep)
        meta = json.loads(side.read_text())
        recipe = meta.get("eval", {}).get("recipe", {})
        if (meta.get("eval", {}).get("retrieval_at_1") != reports[0]["retrieval_at_1"]
                or (recipe.get("seed"), recipe.get("n"), recipe.get("prompts"))
                != (1234, EVAL_N, "dataset")):
            fail(f"eval: the sidecar's stamp {meta.get('eval')} is not seed 1234's report")
        if not (out / "eval_seed1235.json").is_file():
            fail("eval: no report for the second seed")
        gens["zero"] = gen
        # a fresh build resolves the stamped checkpoint, ranked by its stamp
        gen2, build2_s = build(sampler="dpmpp", guidance=2.0, negative="mean")
        cand = hub.list_candidates(gen2.cfg, "diffusion", "smoke")[0]
        if (gen2.diffusion_checkpoint != str(diffusion_checkpoint) or gen2.loaded != "pair"
                or cand["path"] != Path(diffusion_checkpoint)
                or cand["eval"] != reports[0]["retrieval_at_1"]):
            fail(f"eval: a fresh build served {gen2.diffusion_checkpoint} ({gen2.loaded}), "
                 f"candidate {cand['path']} eval {cand['eval']}")
        opts2 = ev.parse_args(["smoke", str(EVAL_N), "25", "dpmpp", "2.0",
                               str(out / "eval_g2.json"), "0", "mean"])
        imgs, rep = timed(runs, "eval dpmpp@25 g=2.0 negative=mean",
                          lambda: ev.evaluate(gen2, captions, real, names, opts2, 1234,
                                              opts2.out))
        _check_images("eval g=2", imgs, 215, EVAL_N)
        _check_report("eval g=2", rep, EVAL_N)
        gens["mean"] = gen2
        return {"build_s": [build_s, build2_s], "runs": runs,
                "retrieval_at_1": [r["retrieval_at_1"] for r in reports + [rep]],
                "stamped": meta["eval"], "resolved": str(cand["path"])}

    def retrieval_and_paraphrase():
        gen, runs, stamps = gens["zero"], [], side.read_text()
        res = {}
        for label, flag in (("loo", "init=retrieval-loo"), ("paraphrase", "prompts=paraphrase")):
            opts = ev.parse_args(["smoke", str(EVAL_N), "10", "dpmpp", "0.0",
                                  str(out / f"eval_{label}.json"), flag, "stamp=1"])
            captions, names, real = ev.eval_set(ds, opts)
            imgs, rep = timed(runs, f"eval dpmpp@10 {flag}",
                              lambda: ev.evaluate(gen, captions, real, names, opts, 1234,
                                                  opts.out, True))
            _check_images(label, imgs, 215, EVAL_N)
            _check_report(label, rep, EVAL_N)
            res[label] = rep["retrieval_at_1"]
        rep_keys = set(rep)
        if side.read_text() != stamps:
            fail("a retrieval-seeded or paraphrase eval stamped the checkpoint")
        if not {"family_retrieval_at_1", "family_chance", "prompts"} <= rep_keys:
            fail(f"paraphrase: no family count in {sorted(rep_keys)}")
        return {"runs": runs, "retrieval_at_1": res}

    def recipe_sweep():
        opts = ev.parse_args(["smoke", str(EVAL_N)])
        captions, names, real = ev.eval_set(ds, opts)
        runs = []
        report = timed(runs, "recipe_sweep " + " ".join(SWEEP), lambda: sw.sweep(
            gens["mean"], captions, real, names, [sw.parse_recipe(r) for r in SWEEP],
            name="smoke", n=EVAL_N, seed=1234, negative="mean", out=out / "sweep.json"))
        if len(report["ranked"]) != len(SWEEP) or not (out / "sweep.json").is_file():
            fail(f"recipe sweep: {len(report['ranked'])} ranked rows")
        return {"runs": runs, "ranked": report["ranked"]}

    def ddim_evidence():
        gens.clear()
        release()
        gen, build_s = build(schedule="auto", sampler="ddim", guidance=0.0, negative="zero",
                             extra=["extra.serve_prefer_final=true"])
        if gen.loaded != "final-bundle":
            fail(f"ddim evidence: served {gen.loaded}, not the stage-3 final bundle")
        runs = []
        imgs = timed(runs, "ddim_evidence ddim@20 PROMPTS", lambda: dd.render(
            gen, dd.PROMPTS, steps=20, out=out / "ddim.png"))
        _check_images("ddim evidence", imgs, 215, len(dd.PROMPTS))
        lines = (out / "ddim.txt").read_text().splitlines()
        if len(lines) != len(dd.PROMPTS) or not (out / "ddim.png").is_file():
            fail("ddim evidence: no captioned grid")
        return {"build_s": build_s, "runs": runs, "served": gen.diffusion_checkpoint,
                "image_std": float(np.std(imgs))}

    ops.reset_launch_counts()   # this path's counted run starts here
    sub("a", stamp_and_guidance)
    sub("b", retrieval_and_paraphrase)
    sub("c", recipe_sweep)
    sub("d", ddim_evidence)
    launches = ops.launch_counts()   # ... and ends here
    if launches != expected or min(forward_kernels(launches).values()) == 0:
        fail(f"phase 14 launches {launches} != predicted {expected}")
    release()
    return {"sub_phases": subs, "launches": launches, "predicted": expected, "ev": ev}


def _inject_draws(gen):
    """Give every request of ``gen`` draws from ``np.random.RandomState(seed)``
    (the prior, or an init's encoder and lerp noises, and each restart
    pass's pair) made on the host and moved to its device: the card and the
    CPU then start from the same numbers."""
    seeds, make_generator, serve = [], gen._generator, gen._serve
    shape = (gen.latent_size, gen.latent_size, gen.cfg.model.latent_dim)

    def generator(seed):
        seeds.append(seed)
        return make_generator(seed)

    def serve_with_draws(ids, mask, generator, *, num, init_images=None, restarts=0, **kw):
        rs = np.random.RandomState(seeds[-1])

        def draw():
            return torch.from_numpy(rs.randn(num, *shape).astype(np.float32)).to(gen.device)

        draws = {"prior": draw()} if init_images is None else {"init": (draw(), draw())}
        draws["restarts"] = [(draw(), draw()) for _ in range(restarts)]
        return serve(ids, mask, generator, num=num, init_images=init_images,
                     restarts=restarts, draws=draws, **kw)

    gen._generator, gen._serve = generator, serve_with_draws


def phase_eval_card_vs_cpu(ev, exp, corpus):
    """14e. ``torch_eval_conditioning``'s function at the tiny config (64x64,
    fp32, dpmpp@4, guidance 2.0, the ``mean`` negative) on the card and on
    the CPU with the same draws, from the prior and with
    ``init=retrieval-loo``: images within ``E2E_MAE``, the score matrices
    within ``EVAL_SCORE_TOL`` and the same best match in every row whose
    top two scores are further apart than twice that."""
    from psg_tpu_torch.data.dataset import PokemonDataset
    from psg_tpu_torch.eval.metrics import pairwise_conditioning_scores
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

    cfg = tiny_config()
    cfg.data.csv_path, cfg.data.image_dir = str(corpus[0]), str(corpus[1])
    kw = dict(tokenizer=WordPieceTokenizer.from_vocab_file(VOCAB), sampler="dpmpp",
              guidance_scale=2.0, negative="mean")
    cpu = PokemonGenerator(cfg, device="cpu", **kw)
    card = PokemonGenerator(cfg, device="cuda", params=cpu.params, **kw)
    for gen in (cpu, card):
        _inject_draws(gen)
    ds = PokemonDataset(*corpus, image_size=64)
    out, rec = Path(exp) / "phase14" / "tiny", {"bound": E2E_MAE, "score_bound": EVAL_SCORE_TOL}
    for mode, flags in (("prior", []), ("retrieval-loo", ["init=retrieval-loo"])):
        got = {}
        for name, gen in (("cpu", cpu), ("card", card)):
            opts = ev.parse_args(["tiny", str(EVAL_N), "4", "dpmpp", "2.0",
                                  str(out / name / f"{mode}.json"), "0", "mean", *flags])
            captions, names, real = ev.eval_set(ds, opts)
            imgs, rep = ev.evaluate(gen, captions, real, names, opts, 5, opts.out)
            got[name] = (np.stack(imgs), pairwise_conditioning_scores(imgs, real), rep)
        (a, sa, ra), (b, sb, rb) = got["card"], got["cpu"]
        mae = float(np.abs(a - b).mean())
        top2 = np.sort(sb, axis=1)[:, -2:]
        sure = top2[:, 1] - top2[:, 0] > 2 * EVAL_SCORE_TOL
        rec[mode] = {"image_mae": mae, "image_max_abs": float(np.abs(a - b).max()),
                     "score_max_abs": float(np.abs(sa - sb).max()),
                     "decisive_rows": int(sure.sum()),
                     "retrieval_at_1": {"card": ra["retrieval_at_1"], "cpu": rb["retrieval_at_1"]}}
        if a.shape != (EVAL_N, 64, 64, 3) or not np.isfinite(a).all():
            fail(f"tiny eval {mode}: bad images {a.shape}")
        if not mae <= E2E_MAE:
            fail(f"tiny eval {mode}: card vs CPU image MAE {mae} > {E2E_MAE}")
        if not np.abs(sa - sb).max() <= EVAL_SCORE_TOL:
            fail(f"tiny eval {mode}: scores differ by {np.abs(sa - sb).max()}")
        if not np.array_equal(sa.argmax(1)[sure], sb.argmax(1)[sure]):
            fail(f"tiny eval {mode}: a decisive row's best match moved")
    return rec


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
    os.environ["HF_HUB_OFFLINE"] = "1"   # checkpoint resolution never asks the network
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
    build_s = time.perf_counter() - t
    tc, spills = {}, {}
    for lib_name, kernel_part, _ops in TENSOR_CORE_KERNELS:
        lib = next(k for k in ops.KERNELS if k.name == lib_name)
        tc[lib_name] = tensor_core_instructions(lib.path, kernel_part)
        spills[lib_name] = spilled(built[lib_name]["nvcc_output"], kernel_part)
    emit("build", {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                   "seconds": build_s,
                   "kernels": {k: {"built": v["built"], "seconds": v["seconds"],
                                   "ptxas": [ln.strip() for ln in
                                             v["nvcc_output"].splitlines()
                                             if "registers" in ln or "spill" in ln]}
                               for k, v in built.items()},
                   "tensor_core_instructions": tc, "spill_bytes": spills})
    for lib_name, part, want_ops in TENSOR_CORE_KERNELS:
        counts = list(tc[lib_name].values())
        if not counts or any(sum(c[op] for op in want_ops) == 0 for c in counts):
            fail(f"the bf16 {part} kernels of {lib_name} hold no "
                 f"{' or '.join(want_ops)}: {tc[lib_name]}")
        spill = list(spills[lib_name].values())
        if not spill or any(spill):
            fail(f"the bf16 {part} kernels of {lib_name} spill (or ptxas printed "
                 f"nothing): {spills[lib_name]}")
    plain_watch = PlainInBackward()

    t = time.perf_counter()
    results = [run_case(c) for c in main_path_cases()]
    bwd_results = run_flash_bwd_cases(FLASH_BWD_CASES)
    emit("kernels_vs_plain", {"card": card, "seconds": time.perf_counter() - t,
                              "cases": results, "flash_backward": bwd_results})
    bad = [r for r in results if not r["ok"]]
    if bad:
        fail("kernel disagrees with its plain version: " + "; ".join(
            f"{r['name']} {r['dtype']} err {r['max_abs_err']:.3g}" for r in bad))

    t = time.perf_counter()
    emit("e2e_card_vs_cpu", {**phase_e2e_card_vs_cpu(),
                             "seconds": time.perf_counter() - t})
    from psg_tpu_torch.data.synthetic import write_sprite_corpus

    with tempfile.TemporaryDirectory(prefix="chip_smoke_corpus_") as tmp:
        corpus = write_sprite_corpus(tmp, n=8, seed=0, size=215)
        t = time.perf_counter()
        serve, gen, keys, sprites = phase_serve_full_width(corpus)
        emit("serve_full_width", {"card": card, **serve,
                                  "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        paths = phase_serve_paths_full_width(gen, keys, corpus, sprites)
        emit("serve_paths_full_width", {"card": card, **paths,
                                        "seconds": time.perf_counter() - t})
        del gen
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        t = time.perf_counter()
        grads = phase_train_gradients()
        tiny = phase_train_card_vs_cpu(tmp)
        t6 = time.perf_counter() - t
        corpus = write_sprite_corpus(Path(tmp) / "corpus128", n=128, seed=0, size=215)
        exp = Path(tmp) / "exp"
        exp.mkdir()
        # the committed vocabulary, as in phases 4-5; both stages resolve it
        (exp / "vocab.txt").write_bytes(VOCAB.read_bytes())
        t = time.perf_counter()
        s1_grads = phase_stage1_gradients()
        s1_tiny = phase_stage1_card_vs_cpu(tmp)
        t_full = time.perf_counter()
        s1 = phase_stage1_full_width(exp, corpus)
        emit("stage1", {"card": card, "gradients": s1_grads, "card_vs_cpu": s1_tiny,
                        "full_width": s1, "full_width_seconds": time.perf_counter() - t_full,
                        "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        full = phase_train_full_width(exp, corpus, s1["checkpoint"])
        emit("train", {"card": card, "gradients": grads, "card_vs_cpu": tiny,
                       "full_width": full, "full_width_seconds": time.perf_counter() - t,
                       "seconds": t6 + time.perf_counter() - t,
                       **plain_watch.check("phases 6-7")})
        t = time.perf_counter()
        s3_grads = phase_stage3_gradients()
        s3_tiny = phase_stage3_card_vs_cpu(tmp)
        t_full = time.perf_counter()
        s3 = phase_stage3_full_width(exp, corpus, s1["checkpoint"], full["checkpoint"])
        emit("stage3", {"card": card, "gradients": s3_grads, "card_vs_cpu": s3_tiny,
                        "full_width": s3, "full_width_seconds": time.perf_counter() - t_full,
                        "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        s0_tiny = phase_stage0_card_vs_cpu(tmp)
        t_full = time.perf_counter()
        s0 = phase_stage0_full_width(exp, corpus)
        emit("stage0", {"card": card, "card_vs_cpu": s0_tiny, "full_width": s0,
                        "full_width_seconds": time.perf_counter() - t_full,
                        "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        fast_aug = phase_fast_augment()
        fast_tiny = phase_fast_card_vs_cpu(tmp)
        t_full = time.perf_counter()
        fast = phase_fast_full_width(tmp, corpus)
        emit("fast_path", {"card": card, "augment": fast_aug, "card_vs_cpu": fast_tiny,
                           "full_width": fast,
                           "full_width_seconds": time.perf_counter() - t_full,
                           "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        sd_kernels = [run_case(c) for c in sd_cases()]
        bad = [r for r in sd_kernels if not r["ok"]]
        if bad:
            fail("kernel disagrees with its plain version at an SD shape: " + "; ".join(
                f"{r['name']} err {r['max_abs_err']:.3g}" for r in bad))
        sd_bwd = run_flash_bwd_cases(SD_BWD_CASES)
        sd_tiny = phase_sd_card_vs_cpu(tmp)
        t_full = time.perf_counter()
        sd = phase_sd_full_width(exp, corpus, s1["checkpoint"])
        emit("sd", {"card": card, "kernels_vs_plain": sd_kernels, "flash_backward": sd_bwd,
                    "card_vs_cpu": sd_tiny,
                    "full_width": sd, "full_width_seconds": time.perf_counter() - t_full,
                    "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        scale = phase_scale_out(exp, corpus, s1["checkpoint"], sprites)
        emit("scale_out", {"card": card, **scale, "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        ck = phase_checkpoints(exp, corpus, s1["checkpoint"], full["checkpoint"], (
            s3["checkpoints_joint"]["final_best_model.ckpt"] / 1e9,
            s3["seconds_by_part"]["save_checkpoint joint"]))
        emit("checkpoints", {"card": card, **ck, "seconds": time.perf_counter() - t})
        t = time.perf_counter()
        evs = phase_eval_scripts(exp, corpus, full["checkpoint"])
        ev_tiny = phase_eval_card_vs_cpu(evs.pop("ev"), exp, corpus)
        emit("eval_scripts", {"card": card, **evs, "card_vs_cpu": ev_tiny,
                              "seconds": time.perf_counter() - t})

    by_name = {(r["kernel"], r["name"], r["dtype"]): r for r in results}
    kernels = []
    for kname, case, source, replaces in KERNEL_LINE:
        r = by_name[(kname, case, "bfloat16")]
        kernels.append({"name": kname, "route": "cuda", "source": source,
                        "replaces": replaces, "shape": case, "dtype": "bfloat16",
                        "launches": sum(ph["launches"][kname] for ph in (
                            serve, paths, s1, full, s3, s0, fast, sd, scale, ck,
                            evs)),
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "composite_ms": r["composite_ms"]})
    bwd_by_name = {(r["name"], r["dtype"]): r for r in bwd_results}
    for case in ("unet 14^2 self hd160 b32",):
        r = bwd_by_name[(case, "bfloat16")]
        kernels.append({"name": "flash_attention_bwd", "route": "cuda",
                        "source": "psg_tpu_torch/csrc/flash_attention_bwd.cu",
                        "replaces": "psg_tpu/ops/flash_attention.py:108",
                        "shape": case, "dtype": "bfloat16",
                        "launches": sum(ph["launches"]["flash_attention_bwd"] for ph in (
                            serve, paths, s1, full, s3, s0, fast, sd, scale, ck, evs)),
                        "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    g = s1_grads["main_case"]
    kernels.append({"name": "spatial_xattn_grad", "route": "cuda",
                    "source": "psg_tpu_torch/ops/spatial_xattn.py",
                    "replaces": "psg_tpu/ops/spatial_xattn.py:154",
                    "shape": f"{SPATIAL_GRAD_CASE} b{S1_BATCH}, forward and backward",
                    "dtype": "bfloat16",
                    "launches": s1["launches_by_part"]["train_epoch"]["spatial_xattn"],
                    "max_abs_err": g["max_abs_err"], "ms": g["ms"], "plain_ms": g["plain_ms"],
                    "bound_ms": g["bound_ms"], "bound_by": g["bound_by"], "library_ms": None,
                    "backward_rows": g["backward_rows"]})
    plain_watch.check("phases 8-14")
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
