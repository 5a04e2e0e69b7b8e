#!/usr/bin/env python3
"""Where one full-width serving request of psg_tpu_torch spends its time on
the card.

    python3 scripts/torch_profile_serve.py [--batch 4] [--steps 20] [--trace PATH]

Builds the full-width generator (config/train_config.yaml, bf16, random
weights from the config's seed), warms it up, then runs each component of the
chain and one whole request (DDIM, CFG with a negative prompt, so the UNet
runs at batch 2N) under ``torch.profiler``.  For each it prints one JSON line:
host wall time (ending in a sync; the mean of 3 runs without the profiler, and
the profiled run's), the summed device time of its kernels,
their number, the device's idle share (1 - kernel time / wall), and the
device time by kernel family.  Needs one CUDA card; imports no JAX.
"""

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("gn_silu (ours)", ("gn_partial_stats", "gn_combine", "gn_apply")),
    ("flash (ours)", ("flash_kernel",)),
    ("spatial_xattn (ours)", ("spatial_xattn_kernel",)),
    ("conv (cuDNN)", ("conv", "implicit", "cudnn", "nhwc", "xmma_fprop", "sm90_xmma")),
    ("gemm", ("gemm", "cutlass", "sm90_", "ampere_", "cublas")),
    ("norm/softmax/reduce", ("norm", "softmax", "reduce", "welford")),
    ("elementwise/copy", ("elementwise", "vectorized", "copy", "cat", "fill",
                          "upsample", "index")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def wall_ms(fn, reps=3):
    """Host wall per call, ending in a sync, without the profiler."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / reps * 1e3


def profiled(name, fn, trace=None):
    wall = wall_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_profiled = time.perf_counter() - t
    if trace:
        prof.export_chrome_trace(trace)
    by_family, kernels, launches, top = defaultdict(float), 0.0, 0, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        kernels += us
        launches += evt.count
        by_family[family(evt.key)] += us
        top.append((us, evt.count, evt.key[:90]))
    top.sort(reverse=True)
    rec = {"component": name, "wall_ms": wall, "wall_ms_profiled": wall_profiled * 1e3,
           "kernel_ms": kernels / 1e3, "kernels": launches,
           "device_idle_share": (1.0 - kernels / 1e3 / wall) if kernels else None,
           "by_family_ms": {k: v / 1e3 for k, v in sorted(by_family.items(),
                                                          key=lambda kv: -kv[1])},
           "top": [{"ms": us / 1e3, "count": n, "kernel": k} for us, n, k in top[:8]]}
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", help="write the whole request's chrome trace here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_serve: needs a CUDA device")

    from psg_tpu_torch import ops
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.models.text_encoder import text_encoder_apply
    from psg_tpu_torch.models.unet import text_bias_from_mask, unet_apply
    from psg_tpu_torch.models.vae import vae_decode
    from psg_tpu_torch.ops import cuda_build
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

    cuda_build.build_all(ops.KERNELS)
    cfg = load_config(ROOT / "config" / "train_config.yaml")
    gen = PokemonGenerator(
        cfg, tokenizer=WordPieceTokenizer.from_vocab_file(
            ROOT / "experiments" / "evidence_r5c_vae" / "vocab.txt"),
        sampler="ddim", guidance_scale=2.0, negative="blurry, low quality",
        device="cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi, "torch": torch.__version__, "batch": args.batch,
                      "steps": args.steps}), flush=True)

    prompts = [f"a small creature number {i} with a long tail" for i in range(args.batch)]
    n, dt, p = args.batch, gen.compute_dtype, gen.params
    ids, mask = gen._encode_ids(prompts)
    with torch.no_grad():
        emb = text_encoder_apply(p["text"], ids, mask, gen.bert_cfg, dtype=dt)
        emb2, mask2 = torch.cat([emb, emb]), torch.cat([mask, mask])
        x = torch.randn(2 * n, gen.latent_size, gen.latent_size, cfg.model.latent_dim,
                        device="cuda")
        t = torch.full((2 * n,), 500, device="cuda", dtype=torch.int32)
        lat = x[:n]
        components = {
            "text_encode": lambda: text_encoder_apply(p["text"], ids, mask,
                                                      gen.bert_cfg, dtype=dt),
            f"unet_eval (batch {2 * n})": lambda: unet_apply(
                p["unet"], x, t, emb2, gen.spec, text_mask=mask2, dtype=dt),
            "vae_decode": lambda: vae_decode(p["vae"], lat, emb,
                                             text_bias=text_bias_from_mask(mask),
                                             image_size=cfg.data.image_size, dtype=dt),
        }
        for fn in components.values():  # warm-up
            fn()
        gen.generate_batch(prompts, num_inference_steps=2, seed=0)
        for name, fn in components.items():
            profiled(name, fn)
    profiled(f"request: generate_batch n={n} ddim {args.steps} steps cfg",
             lambda: gen.generate_batch(prompts, num_inference_steps=args.steps, seed=1),
             trace=args.trace)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
