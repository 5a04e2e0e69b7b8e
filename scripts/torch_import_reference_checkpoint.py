"""Import the reference's trained torch checkpoints for psg_tpu_torch serving
(the port's twin of ``scripts/import_reference_checkpoint.py``: the same
flags, containers and output layout, written by the port's own writer).

The containers the reference's trainers write:

- stage 1 ``vae_best_model.pth``: {'vae_state_dict', 'text_encoder_state_dict', ...}
- stage 2 ``diffusion_best_model.pth``: {'unet_state_dict', ...}
- stage 3 ``final_best_model.pth``: {'model_state_dict': the generator, with
  submodules vae_encoder / vae_decoder / unet / text_encoder}

Each is converted (``psg_tpu_torch.models.convert``) and written as a
``.ckpt`` (flax msgpack, parameters in the JAX layout) where both packages'
hubs (``psg_tpu_torch.serve.hub`` and ``psg_tpu.serve.hub``) resolve it,
with the schedule sidecar that ``--schedule auto`` reads:

  python scripts/torch_import_reference_checkpoint.py --experiment-name imported \\
      --vae vae_best_model.pth --diffusion diffusion_best_model.pth \\
      [--final final_best_model.pth] [--schedule cosine] [--vocab vocab.txt]

``--schedule`` is the schedule the UNet was trained under: ``cosine`` for
the reference's default trainer, ``linear`` for its legacy one.  ``--vocab``
is the WordPiece vocabulary of the BERT the text encoder was fine-tuned
from; it is copied into the experiment directory so serving tokenizes the
same way.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402


def _container(path):
    """The reference checkpoint container's tensors (older containers also
    carry scheduler lambdas, which only a full unpickle reads)."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        return torch.load(path, map_location="cpu", weights_only=False)


def _sd(sd):
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(v)
            for k, v in sd.items()}


def _sub(container, *keys):
    """The first present key, else the container itself."""
    for k in keys:
        if isinstance(container, dict) and k in container:
            return container[k]
    return container


def _strip_prefix(sd, mapping):
    """Remap key prefixes ({'vae_encoder.': 'encoder.', ...}); keys matching
    no prefix are dropped."""
    out = {}
    for k, v in sd.items():
        for src, dst in mapping.items():
            if k.startswith(src):
                out[dst + k[len(src):]] = v
                break
    return out


def _text_encoder_dims(sd):
    """(num_layers, hidden, text_dim) from the state dict itself."""
    layers = {int(k.split(".")[3]) for k in sd if k.startswith("bert.encoder.layer.")}
    hidden = sd["bert.embeddings.word_embeddings.weight"].shape[1]
    text_dim = sd["projection.weight"].shape[0] if "projection.weight" in sd else hidden
    return max(layers) + 1, int(hidden), int(text_dim)


def _save(path: Path, params, schedule: str, src: str, stage: str) -> None:
    from psg_tpu_torch.core.checkpoint import save_state
    from psg_tpu_torch.models import bridge

    meta = {"stage": stage, "step": 0, "imported_from": str(src),
            "config": {"model": {"beta_schedule": schedule}}}
    save_state(path, {"params": bridge.to_jax(params)}, meta)
    print(f"wrote {path}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vae", help="reference vae_best_model.pth")
    ap.add_argument("--diffusion", help="reference diffusion_best_model.pth")
    ap.add_argument("--final", help="reference final_best_model.pth")
    ap.add_argument("--experiment-name", default="imported")
    ap.add_argument("--experiment-dir", default="experiments")
    ap.add_argument("--schedule", default="cosine", choices=["cosine", "linear"],
                    help="beta schedule the UNet was trained under")
    ap.add_argument("--vocab", help="WordPiece vocab.txt of the source BERT")
    args = ap.parse_args(argv)
    if not (args.vae or args.diffusion or args.final):
        ap.error("need at least one of --vae / --diffusion / --final")

    from psg_tpu_torch.models.convert import (
        convert_reference_text_encoder,
        convert_reference_unet,
        convert_reference_vae,
    )

    exp = Path(args.experiment_dir)

    def stage_ckpt(stage: str) -> Path:
        d = exp / f"{args.experiment_name}_{stage}" / "checkpoints"
        d.mkdir(parents=True, exist_ok=True)
        return d / f"{stage}_best_model.ckpt"

    if args.vae:
        c = _container(args.vae)
        params = {"vae": convert_reference_vae(_sd(_sub(c, "vae_state_dict",
                                                        "model_state_dict")))}
        if isinstance(c, dict) and "text_encoder_state_dict" in c:
            tsd = _sd(c["text_encoder_state_dict"])
            params["text"] = convert_reference_text_encoder(tsd, *_text_encoder_dims(tsd))
        _save(stage_ckpt("vae"), params, args.schedule, args.vae, "vae")

    if args.diffusion:
        c = _container(args.diffusion)
        unet_sd = _sd(_sub(c, "unet_state_dict", "model_state_dict"))
        _save(stage_ckpt("diffusion"), convert_reference_unet(unet_sd), args.schedule,
              args.diffusion, "diffusion")

    if args.final:
        gen_sd = _sd(_sub(_container(args.final), "model_state_dict"))
        tsd = _strip_prefix(gen_sd, {"text_encoder.": ""})
        _save(stage_ckpt("final"),
              {"vae": convert_reference_vae(_strip_prefix(
                  gen_sd, {"vae_encoder.": "encoder.", "vae_decoder.": "decoder."})),
               "text": convert_reference_text_encoder(tsd, *_text_encoder_dims(tsd)),
               "unet": convert_reference_unet(_strip_prefix(gen_sd, {"unet.": ""}))},
              args.schedule, args.final, "final")

    if args.vocab:
        dst = exp / "vocab.txt"
        shutil.copyfile(args.vocab, dst)
        print(f"wrote {dst}")

    print(json.dumps({
        "experiment_name": args.experiment_name,
        "serve": (f"python -m psg_tpu_torch.serve.app --prompt '...' "
                  f"--experiment-name {args.experiment_name} "
                  f"--override experiment_dir={exp}"),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
