#!/usr/bin/env python3
"""Where one full-width serving request of psg_tpu_torch spends its time on
the card.

    python3 scripts/torch_profile_serve.py [--batch 4] [--steps 20] [--trace PATH]

Builds the full-width generator (config/train_config.yaml, bf16, random
weights from the config's seed), warms it up, then runs under
``torch.profiler`` each component of the chain (text encode, one UNet eval,
VAE decode, and the VAE encode with ``reparameterize`` at batch 1 and 4),
one whole batch request (DDIM, CFG with a negative prompt, so the UNet runs
at batch 2N), and three batch-1 requests at the same steps: text -> sprite,
image+text -> sprite (a 215x215 sprite of the batch request, noise strength
0.7), and one restart pass (encode the draft, lerp at 0.9, the chain).  For each it prints one JSON line:
host wall time (ending in a sync; the mean of 3 runs without the profiler, and
the profiled run's), the summed device time of its kernels,
their number, the device's idle share (1 - kernel time / wall), the device
time of the spatial cross-attention kernel, and the device time and kernel
count by kernel family (``copy`` is Tensor.copy_: ``.contiguous()`` and
dtype casts), and the program's ``psg.*`` spans in the profiled run
(``spans``: ``utils.profiling.span_table``; a request's
``psg.serve.request``, ``text``, ``sampler``, ``vae_decode`` and
``vae_encode``, ``psg.unet.eval`` and its nine levels, each with its count
and, a span on average, host ms under the profiler, device ms, launch calls
that reached the device and the device's idle ms inside it).  Needs one CUDA
card; imports no JAX.
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

from psg_tpu_torch.utils import profiling  # noqa: E402

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("gn_silu (ours)", ("gn_cluster", "gn_chunk_stats", "gn_chunk_apply")),
    ("flash (ours)", ("flash_bf16", "flash_f32")),
    ("spatial_xattn (ours)", ("spatial_xattn_tc", "spatial_xattn_f32")),
    ("conv (cuDNN)", ("conv", "implicit", "cudnn", "nhwc", "xmma_fprop", "sm90_xmma")),
    ("gemm", ("gemm", "cutlass", "sm90_", "ampere_", "cublas")),
    ("norm/softmax/reduce", ("norm", "softmax", "reduce", "welford")),
    # Tensor.copy_: .contiguous() and dtype casts
    ("copy", ("copy",)),
    ("elementwise", ("elementwise", "vectorized", "cat", "fill", "upsample", "index")),
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
    spans = profiling.profile_spans(prof, trace)
    by_family, count_by_family = defaultdict(float), defaultdict(int)
    kernels, launches, top = 0.0, 0, []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = evt.self_device_time_total
        kernels += us
        launches += evt.count
        by_family[family(evt.key)] += us
        count_by_family[family(evt.key)] += evt.count
        top.append((us, evt.count, evt.key[:90]))
    top.sort(reverse=True)
    rec = {"component": name, "wall_ms": wall, "wall_ms_profiled": wall_profiled * 1e3,
           "kernel_ms": kernels / 1e3, "kernels": launches,
           "device_idle_share": (1.0 - kernels / 1e3 / wall) if kernels else None,
           "spatial_xattn_ms": by_family["spatial_xattn (ours)"] / 1e3,
           "by_family_ms": {k: v / 1e3 for k, v in sorted(by_family.items(),
                                                          key=lambda kv: -kv[1])},
           "by_family_kernels": dict(count_by_family),
           "top": [{"ms": us / 1e3, "count": n, "kernel": k} for us, n, k in top[:8]],
           "spans": spans}
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
    from psg_tpu_torch.utils.images import pil_to_array, tensor_to_pil

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
        sprite = tensor_to_pil(gen.generate_batch(prompts[:1], 2, seed=0)[0])
        img1 = torch.from_numpy(pil_to_array(sprite, cfg.data.image_size)[None]).cuda()
        img4 = img1.repeat(4, 1, 1, 1)
        rng = torch.Generator(device="cuda").manual_seed(0)
        components = {
            "text_encode": lambda: text_encoder_apply(p["text"], ids, mask,
                                                      gen.bert_cfg, dtype=dt),
            f"unet_eval (batch {2 * n})": lambda: unet_apply(
                p["unet"], x, t, emb2, gen.spec, text_mask=mask2, dtype=dt),
            "vae_decode": lambda: vae_decode(p["vae"], lat, emb,
                                             text_bias=text_bias_from_mask(mask),
                                             image_size=cfg.data.image_size, dtype=dt),
            "vae_encode + reparameterize (batch 1)": lambda: gen._encode_impl(p, rng, img1),
            "vae_encode + reparameterize (batch 4)": lambda: gen._encode_impl(p, rng, img4),
        }
        for fn in components.values():  # warm-up
            fn()
        gen.generate_batch(prompts, num_inference_steps=2, seed=0)
        gen.generate_from_image_and_text(sprite, prompts[0], 2, 0.7, seed=0)
        for name, fn in components.items():
            profiled(name, fn)
    profiled(f"request: generate_batch n={n} ddim {args.steps} steps cfg",
             lambda: gen.generate_batch(prompts, num_inference_steps=args.steps, seed=1),
             trace=args.trace)
    profiled(f"request: generate_from_text n=1 ddim {args.steps} steps cfg",
             lambda: gen.generate_from_text(prompts[0], args.steps, seed=2))
    profiled(f"request: generate_from_image_and_text n=1 ddim {args.steps} steps cfg",
             lambda: gen.generate_from_image_and_text(sprite, prompts[0], args.steps, 0.7,
                                                      seed=3))
    ids1, mask1 = gen._encode_ids(prompts[:1])
    profiled(f"restart pass n=1 ddim {args.steps} steps cfg",
             lambda: gen._restart_passes(img1, ids1, mask1, rng, steps=args.steps, num=1,
                                         sampler="ddim", restarts=1, strength=0.9))
    print(smi, flush=True)


if __name__ == "__main__":
    main()
