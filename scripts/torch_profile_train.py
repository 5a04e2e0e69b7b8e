#!/usr/bin/env python3
"""Where one full-width training step of psg_tpu_torch spends its time on
the card.

    python3 scripts/torch_profile_train.py [--stage 0|1|2|3] [--steps 3] [--trace PATH]
    python3 scripts/torch_profile_train.py --stage 2 --use-diffusers [--steps 3]
    python3 scripts/torch_profile_train.py --use-diffusers --config benchmark/configs/sdxl.json
    python3 scripts/torch_profile_train.py --fast-vs-classic [--steps 3]

Builds the trainer of the stage at config/train_config.yaml's full width
(bf16, BERT-base, full VAE, 215x215, batch 32; stage 2 with the UNet
320/640/1280/1280, stage 1 with the VGG16 perceptual loss, stage 3 with the
UNet and a CLIP ViT-B/32 on the WordPiece ids; stage 0, MLM pretraining of
BERT-base, at batch 64 on the captions and 8 variants of each) with random
weights from the config's seed over 128 sprites made from a seed (in a
temporary directory), takes one warm-up step, then for the whole step and
for each of its parts prints one JSON line: host wall time ending in a sync
(the mean of ``--steps`` runs without the profiler, and the profiled run's),
the summed device time of its kernels, their number, the device's idle share
(1 - kernel time / wall), device time and kernel count by kernel family, the
ten heaviest kernels, and the device time of each kernel Function's backward
(``function_backward``): CUDA events around each autograd Function's
backward (the script wraps them; the backward runs on the current stream, so
the interval holds exactly its kernels and the gaps between them), summed per
step, with what that backward is: FlashSDPA's launches the backward kernel
(csrc/flash_attention_bwd.cu), GroupNormSiLU's and SpatialXattn's recompute
their plain versions; and the program's ``psg.*`` spans in the profiled
run (``spans``, as ``scripts/torch_profile_serve.py`` prints them: every
stage trainer's ``psg.train.step``, ``grads``, ``forward``, ``backward``,
``optimizer`` and stage 2's ``ema``, the fast path's ``fast_batch``, the optimizer's
``psg.optim.stats`` and ``adam``, and the UNet's).  Then the step's
samples/s and peak device memory.

Parts.  Stage 2: the forward to the loss (frozen text and VAE encoders,
q_sample, the UNet), the backward, the optimizer and the EMA.  Stage 1: the
text encode, the VAE encode (and reparameterize), the decode, the VGG16
perceptual loss, each with autograd recording as in the step; the backward;
the optimizer.  Stage 3: the text encode, the VAE encode (no gradient) and
reparameterize, the decode, CLIP's image and text towers and the alignment
loss, the backward, the optimizer of the text-encoder phase; then, after
the switch, the joint phase's step and optimizer (text, decoder and UNet).
Stage 0: the forward to the loss (masking, BERT in bf16, the tied head),
the backward, the optimizer.  ``--use-diffusers`` (stage 2 on the SD-1.5
UNet with 768-d cross-attention and BERT-base trained with the 'minimal'
strategy, ``train/stage2_sd.py``): the text encode, the VAE encode (no
gradient) with q_sample, the SD UNet, each with autograd recording as in
the step; the backward (every leaf, frozen ones included); the optimizer.
``--config FILE`` builds the trainer from a JSON configuration dict
instead (a benchmark configuration's ``config`` entry, e.g.
``benchmark/configs/sdxl.json``: the SDXL base UNet trained in full, shaped
by its ``sd_unet`` section, whose ``psg.sdunet.*`` spans the ``spans``
field then lists); the corpus, experiment directory and vocabulary stay
the script's.

``--fast-vs-classic``: config/r3_evidence.yaml (the device-resident fast
path's recipe: batch 16, EMA 0.9995, bf16 first moment, warmup-cosine) at
full width, for stages 1, 2 and 3 (the text-encoder phase): the classic
step (the upload of a batch the loader made, the step) and the fast step (the
minibatch drawn, gathered and augmented on the card, the step), in the
order classic, fast, fast, classic, each with the line above plus the
CUDA runtime's allocations, frees, synchronisations and copies in the
profiled step and its heaviest host ops; then the host-to-device copies of
one more step of each kind (``HostToDevice``: shape and bytes).  Needs one NVIDIA card (it exits otherwise); every line names the
card and its power limit; imports no JAX.
"""

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from psg_tpu_torch.utils import profiling  # noqa: E402
from torch_profile_serve import family  # noqa: E402


BACKWARDS = defaultdict(list)   # Function name -> [(start, end) CUDA events]
BACKWARD_KIND = {"FlashSDPA": "kernel", "GroupNormSiLU": "plain recomputation",
                 "SpatialXattn": "plain recomputation"}


def time_backwards():
    """Wrap the kernels' autograd Functions' backwards in CUDA events."""
    from psg_tpu_torch.ops import flash_attention, fused_norm, spatial_xattn

    for cls in (fused_norm.GroupNormSiLU, flash_attention.FlashSDPA,
                spatial_xattn.SpatialXattn):
        def timed(ctx, grad, _orig=cls.backward, _name=cls.__name__):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                enable_timing=True)
            start.record()
            out = _orig(ctx, grad)
            end.record()
            BACKWARDS[_name].append((start, end))
            return out
        cls.backward = staticmethod(timed)


CARD = None     # nvidia-smi's name and power limit, set in main()
RUNTIME_CALLS = ("cudaMalloc", "cudaFree", "cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaMemcpyAsync")


class HostToDevice(TorchDispatchMode):
    """Records every copy of a CPU tensor onto a CUDA device that goes
    through PyTorch's dispatcher (``_to_copy``, ``copy_``) as (shape,
    bytes).  The profiler's memcpy records are not used for this: on that
    machine it dropped some of them, the first of a run among them."""

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


def h2d_copies(fn, arg=None):
    """The host-to-device copies of one call of ``fn``."""
    with HostToDevice() as mode:
        fn(arg)
        torch.cuda.synchronize()
    return mode.copies


def measure(name, fn, reps, setup=None, trace=None):
    """Wall (mean of ``reps`` runs, each after ``setup``) and one profiled
    run.  ``fn`` takes what ``setup`` returns."""
    walls, rec_ms, rec_calls = [], defaultdict(float), defaultdict(int)
    for _ in range(reps):
        arg = setup() if setup else None
        torch.cuda.synchronize()
        BACKWARDS.clear()           # only this run's backwards
        t = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
        for k, evs in BACKWARDS.items():
            rec_ms[k] += sum(s.elapsed_time(e) for s, e in evs)
            rec_calls[k] += len(evs)
    backwards = {k: {"calls_per_run": rec_calls[k] // reps,
                     "device_ms_per_run": rec_ms[k] / reps, "kind": BACKWARD_KIND[k]}
                 for k in rec_ms}
    arg = setup() if setup else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn(arg)
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t
    spans = profiling.profile_spans(prof, trace)
    by_family, count_by_family = defaultdict(float), defaultdict(int)
    kernels, launches, top, host = 0.0, 0, [], []
    runtime = defaultdict(int)
    for evt in prof.key_averages():
        if evt.key in RUNTIME_CALLS:
            runtime[evt.key] += evt.count
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            host.append((evt.self_cpu_time_total, evt.count, evt.key[:60]))
            continue
        # the program's spans are listed as device ranges too: not kernels
        if evt.key.startswith("psg."):
            continue
        us = evt.self_device_time_total
        kernels += us
        launches += evt.count
        by_family[family(evt.key)] += us
        count_by_family[family(evt.key)] += evt.count
        top.append((us, evt.count, evt.key[:100]))
    top.sort(reverse=True)
    wall = sum(walls) / len(walls)
    rec = {"card": CARD, "part": name, "wall_ms": wall * 1e3,
           "wall_ms_median": statistics.median(walls) * 1e3,
           "walls_ms": [w * 1e3 for w in walls],
           "wall_ms_profiled": wall_profiled * 1e3, "kernel_ms": kernels / 1e3,
           "kernels": launches,
           "device_idle_share": (1.0 - kernels / 1e6 / wall) if kernels else None,
           "function_backward": backwards, "runtime_calls": dict(runtime),
           "top_host_ms": [{"ms": us / 1e3, "count": n, "op": k}
                           for us, n, k in sorted(host, reverse=True)[:8]],
           "by_family_ms": {k: v / 1e3 for k, v in sorted(by_family.items(),
                                                          key=lambda kv: -kv[1])},
           "by_family_kernels": dict(count_by_family),
           "top": [{"ms": us / 1e3, "count": n, "kernel": k} for us, n, k in top[:10]],
           "spans": spans}
    print(json.dumps(rec), flush=True)
    return rec


def profile_stage2(cfg, args):
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.train.optim import ema_update
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

    tr = DiffusionTrainer(cfg, None, experiment_name="profile", device="cuda")
    batch = tr._batch(next(iter(tr.train_loader)))
    bs = batch["image"].shape[0]
    print(json.dumps({"stage": 2, "batch": bs,
                      "params": sum(t.numel() for t in tree.leaves(tr.state.params))}),
          flush=True)
    tr._step(batch)                        # warm-up: cuDNN and cuBLAS pick kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = tr.state
    leaves = tree.leaves(st.params)

    def forward(_):
        return tr._noise_loss(st.params, tr.frozen, batch, st.rng,
                              dropout=tr._dropout(None, st.rng))

    step = measure(f"train step (batch {bs})", lambda _: tr._step(batch), args.steps,
                   trace=args.trace)
    measure("forward to the loss", forward, args.steps)
    measure("backward", lambda loss: torch.autograd.grad(loss, leaves), args.steps,
            setup=lambda: forward(None))

    def update(g):
        tr.tx.update(st.params, g, st.opt_state)
        if tr.ema_decay > 0:
            ema_update(st.ema, st.params, tr.ema_decay)

    measure("optimizer + EMA", update, args.steps, setup=lambda: tr._grads(batch)[1])
    return bs, step, tr.skipped_batches()


def profile_sd(cfg, args):
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.models.sd_unet import sd_wrapper_apply
    from psg_tpu_torch.models.text_encoder import text_encoder_apply
    from psg_tpu_torch.models.unet import text_bias_from_mask
    from psg_tpu_torch.models.vae import reparameterize, vae_encoder_apply
    from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer

    tr = SDDiffusionTrainer(cfg, None, experiment_name="profile", device="cuda")
    batch = tr._batch(next(iter(tr.train_loader)))
    bs = batch["image"].shape[0]
    p = tr.state.params
    print(json.dumps({"stage": "2 (--use-diffusers)", "batch": bs, "train_mode": tr.train_mode,
                      "unet_params": sum(t.numel() for t in tree.leaves(p["sd"])),
                      "text_params": sum(t.numel() for t in tree.leaves(p["text"]))}),
          flush=True)
    tr._step(batch)                        # warm-up: cuDNN and cuBLAS pick kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    leaves = tree.leaves(p)
    dt = tr.compute_dtype

    step = measure(f"train step (batch {bs})", lambda _: tr._step(batch), args.steps,
                   trace=args.trace)
    emb = measure_out("text encode", lambda _: text_encoder_apply(
        p["text"], batch["desc_ids"], batch["desc_mask"], tr.bert_cfg, dtype=dt), args.steps)

    def encode(_):
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(tr.frozen_vae["encoder"], batch["image"], dtype=dt)
            latent = reparameterize(tr.state.rng, mu, logvar).clamp(
                -cfg.model.latent_clamp, cfg.model.latent_clamp)
            t = torch.randint(0, tr.schedule.num_timesteps, (bs,), generator=tr.state.rng,
                              device="cuda")
            noise = torch.randn(latent.shape, generator=tr.state.rng, device="cuda")
            return tr.schedule.add_noise(latent, noise, t), t

    noisy, t = measure_out("VAE encode + q_sample (no gradient)", encode, args.steps)
    bias = text_bias_from_mask(batch["desc_mask"])
    cond = tr._conditioning(batch["desc_mask"])
    measure("SD UNet forward", lambda _: sd_wrapper_apply(
        p["sd"], noisy.to(emb.dtype), t, emb, tr.spec, text_bias=bias, dtype=dt, **cond),
        args.steps)

    def loss(_):
        return tr._loss(p, batch, tr.state.rng, None)[0]

    measure("backward", lambda lo: torch.autograd.grad(lo, leaves, allow_unused=True),
            args.steps, setup=lambda: loss(None))
    measure("optimizer (unet + text groups)",
            lambda g: tr.tx.update(p, g, tr.state.opt_state), args.steps,
            setup=lambda: tr._grads(batch)[1])
    return bs, step, tr.skipped_batches()


def profile_stage1(cfg, args):
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.models.losses import perceptual_loss
    from psg_tpu_torch.models.text_encoder import text_encoder_apply
    from psg_tpu_torch.models.unet import text_bias_from_mask
    from psg_tpu_torch.models.vae import reparameterize, vae_decode, vae_encoder_apply
    from psg_tpu_torch.train.stage1_vae import VAETrainer

    tr = VAETrainer(cfg, experiment_name="profile", device="cuda")
    batch = tr._batch(next(iter(tr.train_loader)))
    bs, klw = batch["image"].shape[0], tr.kl_weight(1)
    print(json.dumps({"stage": 1, "batch": bs,
                      "params": sum(t.numel() for t in tree.leaves(tr.state.params))}),
          flush=True)
    tr._step(batch, klw)                   # warm-up: cuDNN and cuBLAS pick kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, dt = tr.state, tr.compute_dtype
    p = st.params
    leaves = tree.leaves(p)
    bias = text_bias_from_mask(batch["text_mask"])

    def text(_):
        return text_encoder_apply(p["text"], batch["text_ids"], batch["text_mask"],
                                  tr.bert_cfg, dtype=dt)

    def encode(_):
        mu, logvar = vae_encoder_apply(p["vae"]["encoder"], batch["image"], dtype=dt)
        return reparameterize(st.rng, mu, logvar), mu, logvar

    def decode(_):
        return vae_decode(p["vae"], latent, emb, text_bias=bias, dtype=dt,
                          image_size=cfg.data.image_size)

    def perceptual(_):
        return perceptual_loss(tr.vgg_params, (recon + 1.0) / 2.0,
                               (batch["image"] + 1.0) / 2.0, dtype=dt)

    def forward(_):
        return tr._loss(p, batch, st.rng, None, klw)[0]

    step = measure(f"train step (batch {bs})", lambda _: tr._step(batch, klw), args.steps,
                   trace=args.trace)
    emb = measure_out("text encode", text, args.steps)
    latent, mu, logvar = measure_out("VAE encode + reparameterize", encode, args.steps)
    recon = measure_out("decode", decode, args.steps)
    measure("VGG16 perceptual loss", perceptual, args.steps)
    del emb, latent, mu, logvar, recon
    measure("backward", lambda loss: torch.autograd.grad(loss, leaves, allow_unused=True),
            args.steps, setup=lambda: forward(None))
    measure("optimizer", lambda g: tr.tx.update(p, g, st.opt_state), args.steps,
            setup=lambda: tr._grads(batch, klw)[1])
    return bs, step, tr.skipped_batches()


def profile_stage3(cfg, args):
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.models.clip import clip_alignment_loss
    from psg_tpu_torch.models.text_encoder import text_encoder_apply
    from psg_tpu_torch.models.unet import text_bias_from_mask
    from psg_tpu_torch.models.vae import reparameterize, vae_decode, vae_encoder_apply
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    tr = FinalTrainer(cfg, None, None, experiment_name="profile", device="cuda")
    batch = tr._batch(next(iter(tr.train_loader)))
    bs = batch["image"].shape[0]
    params = {k: sum(t.numel() for t in tree.leaves(v)) for k, v in tr.state.params.items()}
    params["clip"] = sum(t.numel() for t in tree.leaves(tr.clip_params))
    print(json.dumps({"stage": 3, "batch": bs, "params": params,
                      "clip": tr.clip_cfg._asdict()}), flush=True)
    tr._step(batch)                        # warm-up: cuDNN and cuBLAS pick kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, dt = tr.state, tr.compute_dtype
    p = st.params
    leaves = tree.leaves(p)
    bias = text_bias_from_mask(batch["text_mask"])

    def text(_):
        return text_encoder_apply(p["text"], batch["text_ids"], batch["text_mask"],
                                  tr.bert_cfg, dtype=dt)

    @torch.no_grad()
    def encode(_):
        mu, logvar = vae_encoder_apply(p["vae"]["encoder"], batch["image"], dtype=dt)
        return reparameterize(st.rng, mu, logvar)

    def decode(_):
        return vae_decode(p["vae"], latent.to(emb.dtype), emb, text_bias=bias, dtype=dt,
                          image_size=cfg.data.image_size)

    def clip(_):
        return clip_alignment_loss(tr.clip_params, recon, batch["text_ids"],
                                   batch["text_mask"], tr.clip_cfg, dtype=dt)

    def forward(_):
        return tr._loss(p, batch, st.rng, None)[0]

    step = measure(f"train step, text-encoder phase (batch {bs})", lambda _: tr._step(batch),
                   args.steps, trace=args.trace)
    emb = measure_out("text encode", text, args.steps)
    latent = measure_out("VAE encode (no grad) + reparameterize", encode, args.steps)
    recon = measure_out("decode", decode, args.steps)
    measure("CLIP image + text + alignment loss", clip, args.steps)
    del emb, latent, recon
    measure("backward", lambda loss: torch.autograd.grad(loss, leaves, allow_unused=True),
            args.steps, setup=lambda: forward(None))
    measure("optimizer, text-encoder phase", lambda g: tr.tx.update(p, g, st.opt_state),
            args.steps, setup=lambda: tr._grads(batch)[1])
    tr.switch_to_joint_training()
    tr._step(batch)                        # the joint optimizer's first step
    torch.cuda.synchronize()
    joint = measure(f"train step, joint phase (batch {bs})", lambda _: tr._step(batch),
                    args.steps)
    measure("optimizer, joint phase", lambda g: tr.tx.update(p, g, tr.state.opt_state),
            args.steps, setup=lambda: tr._grads(batch)[1])
    print(json.dumps({"card": CARD, "joint_samples_per_s": bs / (joint["wall_ms"] / 1e3)}),
          flush=True)
    return bs, step, tr.skipped_batches()


def profile_stage0(cfg, args):
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.train.stage0_mlm import MLMPretrainer

    tr = MLMPretrainer(cfg, experiment_name="profile", device="cuda")
    bs, st = tr.batch, tr.state
    print(json.dumps({"stage": 0, "batch": bs, "text_len": cfg.data.text_len,
                      "rows": int(tr.train_rows[0].shape[0]),
                      "params": sum(t.numel() for t in tree.leaves(st.params))}), flush=True)
    tr._step()                             # warm-up: cuBLAS picks kernels
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    leaves = tree.leaves(st.params)
    index = torch.randint(0, tr.train_rows[0].shape[0], (bs,), generator=st.rng,
                          device="cuda")
    ids, attn = (r[index] for r in tr.train_rows)

    def forward(_):
        return tr._loss(st.params, ids, attn, st.rng)

    step = measure(f"train step (batch {bs})", lambda _: tr._step(), args.steps,
                   trace=args.trace)
    measure("forward to the loss", forward, args.steps)
    measure("backward", lambda loss: torch.autograd.grad(loss, leaves, allow_unused=True),
            args.steps, setup=lambda: forward(None))
    measure("optimizer", lambda g: tr.tx.update(st.params, g, st.opt_state), args.steps,
            setup=lambda: tr._grads()[1])
    return bs, step, 0


def fast_vs_classic(cfg, args):
    """The classic and the fast step of stages 1, 2 and 3, in turns."""
    import gc

    from psg_tpu_torch.train.stage1_vae import VAETrainer
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    out = {}
    for stage, make in ((1, lambda: VAETrainer(cfg, experiment_name="fvc", device="cuda")),
                        (2, lambda: DiffusionTrainer(cfg, None, experiment_name="fvc",
                                                     device="cuda")),
                        (3, lambda: FinalTrainer(cfg, None, None, experiment_name="fvc",
                                                 device="cuda"))):
        tr = make()
        tr._setup_fast_data()
        extra = (tr.kl_weight(1),) if stage == 1 else ()

        it = itertools.cycle(list(tr.train_loader))     # one epoch of host batches
        bs = cfg.data.batch_size

        def classic(_):
            return tr._step(tr._batch(next(it)), *extra)

        def fast(_):
            return tr._step(tr._fast_batch(), *extra)

        classic(None)                      # warm-up: cuDNN and cuBLAS pick kernels
        fast(None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        recs = [measure(f"stage {stage} {kind} step (batch {bs})", fn, args.steps)
                for kind, fn in (("classic", classic), ("fast", fast), ("fast", fast),
                                 ("classic", classic))]
        out[stage] = {"classic_wall_ms": [recs[0]["wall_ms"], recs[3]["wall_ms"]],
                      "fast_wall_ms": [recs[1]["wall_ms"], recs[2]["wall_ms"]],
                      "classic_wall_ms_median": [recs[0]["wall_ms_median"],
                                                 recs[3]["wall_ms_median"]],
                      "fast_wall_ms_median": [recs[1]["wall_ms_median"],
                                              recs[2]["wall_ms_median"]],
                      "classic_device_ms": [recs[0]["kernel_ms"], recs[3]["kernel_ms"]],
                      "fast_device_ms": [recs[1]["kernel_ms"], recs[2]["kernel_ms"]],
                      "classic_h2d_copies": h2d_copies(classic),
                      "fast_h2d_copies": h2d_copies(fast),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "skipped_batches": tr.skipped_batches()}
        print(json.dumps({"card": CARD, "stage": stage, **out[stage]}), flush=True)
        del tr, it
        gc.collect()
        torch.cuda.empty_cache()
    return out


def measure_out(name, fn, reps):
    """``measure``, then one more call whose output the next part takes."""
    measure(name, fn, reps)
    out = fn(None)
    torch.cuda.synchronize()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--stage", type=int, default=2, choices=(0, 1, 2, 3))
    ap.add_argument("--steps", type=int, default=3, help="unprofiled runs per part")
    ap.add_argument("--trace", help="write the whole step's chrome trace here")
    ap.add_argument("--use-diffusers", action="store_true",
                    help="stage 2 on the SD UNet (train/stage2_sd.py)")
    ap.add_argument("--config", help="a JSON config dict in place of train_config.yaml "
                                     "(e.g. benchmark/configs/sdxl.json)")
    ap.add_argument("--fast-vs-classic", action="store_true",
                    help="the fast and the classic step of stages 1-3 (r3_evidence.yaml)")
    args = ap.parse_args()
    if not torch.cuda.is_available() or "NVIDIA" not in torch.cuda.get_device_name(0):
        sys.exit("torch_profile_train: needs an NVIDIA CUDA device")

    from psg_tpu_torch import ops
    from psg_tpu_torch.core.config import config_from_dict, load_config
    from psg_tpu_torch.data.synthetic import write_sprite_corpus
    from psg_tpu_torch.ops import cuda_build

    cuda_build.build_all(ops.KERNELS)
    global CARD
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    CARD = smi.splitlines()[0]
    print(json.dumps({"card": CARD, "torch": torch.__version__}), flush=True)
    with tempfile.TemporaryDirectory(prefix="profile_train_") as tmp:
        csv, images = write_sprite_corpus(Path(tmp) / "corpus", n=128, seed=0, size=215)
        (Path(tmp) / "exp").mkdir()
        (Path(tmp) / "exp" / "vocab.txt").write_bytes(
            (ROOT / "experiments" / "evidence_r5c_vae" / "vocab.txt").read_bytes())
        if args.config:
            raw = json.loads(Path(args.config).read_text())
            cfg = config_from_dict(raw.get("config", raw))
            cfg.experiment_dir = str(Path(tmp) / "exp")
            cfg.data.csv_path, cfg.data.image_dir = str(csv), str(images)
        else:
            config = "r3_evidence.yaml" if args.fast_vs_classic else "train_config.yaml"
            cfg = load_config(ROOT / "config" / config,
                              [f"experiment_dir={Path(tmp) / 'exp'}", f"data.csv_path={csv}",
                               f"data.image_dir={images}"])
        time_backwards()
        if args.fast_vs_classic:
            fast_vs_classic(cfg, args)
            print(smi, flush=True)
            return
        if args.use_diffusers and args.stage != 2:
            sys.exit("torch_profile_train: --use-diffusers is a stage-2 option")
        profile_fn = profile_sd if args.use_diffusers else {
            0: profile_stage0, 1: profile_stage1, 2: profile_stage2,
            3: profile_stage3}[args.stage]
        bs, step, skipped = profile_fn(cfg, args)
        print(json.dumps({"card": CARD, "samples_per_s": bs / (step["wall_ms"] / 1e3),
                          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                          "skipped_batches": skipped}), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
