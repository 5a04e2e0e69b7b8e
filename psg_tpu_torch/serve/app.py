"""Serving front ends (port of ``psg_tpu/serve/app.py``).

    python -m psg_tpu_torch.serve.app --prompt "a small green creature" \\
        --steps 20 --seed 42 --out sprite.png [--device cuda|cpu]

1. ``create_gradio_interface``: the reference's two-tab UI (Text -> Sprite
   with restarts and retrieval seeding; Image + Text -> Sprite), when gradio
   is installed (it is imported only then).
2. ``main``: a one-shot ``--prompt``, ``--list-checkpoints``, the Gradio UI,
   or, without gradio, a line-oriented REPL over the same generator API.

The JAX CLI's flags, plus ``--device``: the card unless ``--device cpu`` is
given; without a card it raises.  ``main`` prints which weights it serves
(the generator's ``loaded`` tag), so random weights are never silent.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from psg_tpu_torch.core.config import load_config
from psg_tpu_torch.serve.generator import PokemonGenerator, resolve_device
from psg_tpu_torch.serve.hub import describe_candidates, resolve_checkpoints


def _sidecar_config(diff_ckpt) -> dict:
    """The training config recorded in a checkpoint's sidecar JSON, or {}."""
    try:
        cfg = json.loads(Path(diff_ckpt).with_suffix(".json").read_text())["config"]
    except (OSError, ValueError, KeyError, TypeError):
        return {}
    return cfg if isinstance(cfg, dict) else {}


def _schedule_from_checkpoint(diff_ckpt) -> str:
    """A checkpoint is sampled under its TRAINING beta schedule, which the
    sidecar JSON beside every .ckpt records; 'linear' without one."""
    try:
        return str(_sidecar_config(diff_ckpt)["model"]["beta_schedule"])
    except (KeyError, TypeError):
        return "linear"


def _prediction_type_from_checkpoint(diff_ckpt) -> str:
    """The prediction parameterization ('eps' or 'v') is a training property
    recorded in the sidecar config: sampling a v-trained UNet as eps yields
    pure noise."""
    extra = _sidecar_config(diff_ckpt).get("extra")
    return str(extra.get("prediction_type", "eps")) if isinstance(extra, dict) else "eps"


def build_generator(config_path=None, experiment_name: str = "pokemon",
                    overrides=None, schedule: str = "auto", sampler: str = "ddim",
                    guidance: float = 0.0, negative: str = "zero",
                    retrieval_mode: str = "hybrid", device=None) -> PokemonGenerator:
    device = resolve_device(device)   # fail before any file is read
    cfg = load_config(config_path if config_path and Path(config_path).exists()
                      else None, overrides=overrides)
    vae, diff = resolve_checkpoints(cfg, experiment_name)
    if schedule == "auto":
        schedule = _schedule_from_checkpoint(diff) if diff else "linear"
    ptype = _prediction_type_from_checkpoint(diff) if diff else "eps"
    return PokemonGenerator(cfg, vae_checkpoint=vae, diffusion_checkpoint=diff,
                            schedule_kind=schedule, sampler=sampler,
                            guidance_scale=guidance, negative=negative,
                            retrieval_mode=retrieval_mode, prediction_type=ptype,
                            device=device)


def create_gradio_interface(generator: PokemonGenerator):
    import gradio as gr

    with gr.Blocks(title="Pokemon Sprite Generator (GPU)") as demo:
        gr.Markdown("# Pokemon Sprite Generator")
        with gr.Tab("Text to Sprite"):
            desc = gr.Textbox(label="Description", lines=3,
                              placeholder="A small green creature with a bulb on its back")
            steps = gr.Slider(10, 100, value=50, step=1, label="Inference steps")
            seed = gr.Number(value=42, label="Seed", precision=0)
            restarts = gr.Slider(0, 3, value=1, step=1, label="Restart passes",
                                 info="re-encode + resample; 1 markedly "
                                      "sharpens structure and prompt color")
            retr = gr.Checkbox(value=False,
                               label="Seed from nearest sprite (retrieval)",
                               info="automatic img2img: retrieve the closest "
                                    "dataset caption (hybrid embedding+TF-IDF) "
                                    "and start from its sprite's latent")
            retr_strength = gr.Slider(0.5, 1.0, value=0.85, step=0.05,
                                      label="Retrieval noise strength")
            btn = gr.Button("Generate")
            out = gr.Image(label="Generated sprite", type="pil")

            def gen_text(d, s, sd, r, use_retr, ns):
                if use_retr:
                    return generator.generate_from_text_retrieval(
                        d, int(s), int(sd), strength=float(ns), restarts=int(r))
                return generator.generate_from_text(d, int(s), int(sd), restarts=int(r))

            btn.click(gen_text, [desc, steps, seed, restarts, retr, retr_strength], out)
            if hasattr(gr, "Examples"):
                gr.Examples(
                    examples=[
                        ["A fire-type Pokemon with orange flames and wings", 25, 42],
                        ["A water-type Pokemon with blue scales and fins", 25, 123],
                        ["An electric-type Pokemon with yellow fur", 25, 456],
                        ["A grass-type Pokemon with green leaves and petals", 25, 789],
                    ],
                    inputs=[desc, steps, seed])

        with gr.Tab("Image + Text to Sprite"):
            img = gr.Image(label="Input image", type="pil")
            desc2 = gr.Textbox(label="Description", lines=3)
            steps2 = gr.Slider(10, 100, value=50, step=1, label="Inference steps")
            strength = gr.Slider(0.0, 1.0, value=0.7, step=0.05, label="Noise strength")
            seed2 = gr.Number(value=42, label="Seed", precision=0)
            btn2 = gr.Button("Generate")
            out2 = gr.Image(label="Generated sprite", type="pil")

            def gen_img(i, d, s, ns, sd):
                return generator.generate_from_image_and_text(i, d, int(s), float(ns),
                                                              int(sd))

            btn2.click(gen_img, [img, desc2, steps2, strength, seed2], out2)
    return demo


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Pokemon sprite generator serving")
    p.add_argument("--config", default="config/train_config.yaml")
    p.add_argument("--experiment-name", default="pokemon")
    p.add_argument("--override", action="append", default=[])
    p.add_argument("--prompt", default=None,
                   help="one-shot: generate a sprite for this prompt and exit")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", default="generated.png")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default=None,
                   help="torch device; default the GPU (raises without one)")
    p.add_argument("--schedule", default="auto", choices=["auto", "linear", "cosine"],
                   help="beta schedule; 'auto' reads the checkpoint sidecar")
    p.add_argument("--sampler", default="ddim",
                   choices=["ddim", "dpmpp", "ddpm", "fast", "x0", "renoise"],
                   help="'ddim' is the quality sampler (correct striding, x0 "
                        "clipping, optional CFG); 'dpmpp' is 2nd-order "
                        "DPM-Solver++(2M); the rest are reference-parity variants")
    p.add_argument("--guidance", type=float, default=0.0,
                   help="classifier-free guidance scale (ddim/dpmpp only; needs a "
                        "checkpoint trained with extra.cond_dropout)")
    p.add_argument("--negative", default="zero",
                   help="CFG negative branch: 'zero' (cond-dropout embedding), "
                        "'mean' (mean dataset-caption embedding) or a negative "
                        "prompt string")
    p.add_argument("--init", default="prior", choices=["prior", "retrieval"],
                   help="'retrieval' seeds the chain from the nearest dataset "
                        "sprite's latent at --init-strength noise")
    p.add_argument("--init-strength", type=float, default=0.85)
    p.add_argument("--retrieval-mode", default="hybrid",
                   choices=["hybrid", "embed", "lexical"],
                   help="caption-retrieval similarity for --init retrieval")
    p.add_argument("--restarts", type=int, default=0,
                   help="restart-sampling passes after the base chain (re-encode, "
                        "re-noise at --restart-strength, resample)")
    p.add_argument("--restart-strength", type=float, default=0.9)
    p.add_argument("--list-checkpoints", action="store_true",
                   help="print every on-disk checkpoint candidate, ranked, plus "
                        "the pair that would be served, then exit")
    args = p.parse_args(argv)

    if args.list_checkpoints:
        cfg = load_config(args.config if Path(args.config).exists() else None,
                          overrides=args.override)
        print(describe_candidates(cfg, args.experiment_name))
        return 0

    gen = build_generator(args.config, args.experiment_name, args.override,
                          schedule=args.schedule, sampler=args.sampler,
                          guidance=args.guidance, negative=args.negative,
                          retrieval_mode=args.retrieval_mode, device=args.device)
    print(f"serving on {gen.device}: loaded={gen.loaded} vae={gen.vae_checkpoint} "
          f"diffusion={gen.diffusion_checkpoint}", flush=True)

    if args.prompt is not None:
        if args.init == "retrieval":
            img = gen.generate_from_text_retrieval(
                args.prompt, args.steps, args.seed, strength=args.init_strength,
                restarts=args.restarts)
        else:
            img = gen.generate_from_text(args.prompt, args.steps, args.seed,
                                         restarts=args.restarts,
                                         restart_strength=args.restart_strength)
        img.save(args.out)
        print(f"wrote {args.out}")
        return 0

    try:
        import gradio  # noqa: F401
    except ImportError:
        # headless: a line-oriented REPL over the same generator API (one
        # prompt per line; blank line or EOF quits)
        print("gradio not installed — REPL mode (one prompt per line; blank line quits)")
        i = 0
        while True:
            try:
                line = input("prompt> ").strip()
            except EOFError:
                break
            if not line:
                break
            img = gen.generate_from_text(line, args.steps, args.seed + i,
                                         restarts=args.restarts,
                                         restart_strength=args.restart_strength)
            out = Path(args.out).with_name(
                f"{Path(args.out).stem}_{i:03d}{Path(args.out).suffix or '.png'}")
            img.save(out)
            print(f"wrote {out}")
            i += 1
        return 0
    demo = create_gradio_interface(gen)
    demo.launch(server_name="127.0.0.1", server_port=args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
