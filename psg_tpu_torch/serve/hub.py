"""Checkpoint resolution: local paths first, HF Hub when online (port of
``psg_tpu/serve/hub.py``; the JSON sidecars and directory layout are the
JAX package's, so both packages resolve the same files).

Resolution policy:

- candidates are ranked by the STAMPED conditioning eval in each
  checkpoint's sidecar JSON when present (``eval.retrieval_at_1``, written
  from ``eval.metrics.conditioning_report``), then by the recorded best
  validation loss, never by mtime: "newest" must not shadow "measured best"
  (an in-flight retrain would otherwise hijack serving), and a better val
  loss must not shadow a measured conditioning regression;
- the VAE and the diffusion checkpoint are resolved as a PAIR: a UNet's
  latent space is defined by the frozen VAE it trained against, so the
  diffusion sidecar's recorded ``vae_checkpoint`` is followed first, then a
  VAE from the same run family (``X_diffusion`` -> ``X_vae``), and only then
  the best-ranked VAE anywhere (with a warning);
- a stage-3 ``final`` bundle shadows the stage-2 pair ONLY when its sidecar
  records a conditioning eval that is not worse than the stage-2
  candidate's; ``extra.serve_prefer_final: true`` restores the reference's
  unconditional preference.

The generator's checkpoint reader (``core.checkpoint``) is the only loader:
this module only picks paths.  The Hub is tried only where ``HF_HUB_OFFLINE``
is not 1 and a DNS probe answers; ``huggingface_hub`` is imported then.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from psg_tpu_torch.core.checkpoint import wait_for_writes

log = logging.getLogger(__name__)

VAE_REPO = "GabrieleConte/PokemonVAE"
UNET_REPO = "GabrieleConte/PokemonU-Net"


def _sidecar(path: Path) -> Dict:
    p = path.with_suffix(".json")
    try:
        return json.loads(p.read_text())
    except Exception:
        return {}


def _candidate(path: Path, named: bool = False) -> Dict:
    meta = _sidecar(path)
    # {run}_{stage}/checkpoints/x.ckpt -> run.  Bare layouts (the
    # reference's 'weights/x.ckpt', '<experiment_dir>/x.ckpt') have no run
    # directory: record '' rather than a name like the repo dir, which would
    # feed bogus families into pairing and shadowing.
    run = path.parent.parent.name if path.parent.name == "checkpoints" else ""
    ev = meta.get("eval") or {}
    recipe = ev.get("recipe") or {}
    # Only a CANONICAL stamp ranks: dataset prompts, generated from the
    # pure prior.  A paraphrase stamp lives on a different chance scale
    # and a retrieval-seeded stamp measures the seeding crutch, not the
    # checkpoint; comparing either against canonical numbers silently
    # serves the wrong model.  Recipe-less stamps (the older sidecar
    # format) count as canonical.
    canonical = (not recipe) or (
        recipe.get("prompts", "dataset") == "dataset"
        and str(recipe.get("init", "prior")) == "prior")
    return {
        "path": path,
        "run": run,
        "named": named,
        "metric": meta.get("metric"),
        "eval": ev.get("retrieval_at_1") if canonical else None,
        "eval_recipe": recipe if canonical and recipe else None,
        "step": meta.get("step"),
        "vae_checkpoint": meta.get("vae_checkpoint"),
        "mtime": path.stat().st_mtime if path.exists() else 0.0,
    }


def list_candidates(cfg, stage: str,
                    experiment_name: Optional[str] = None) -> List[Dict]:
    """All on-disk best checkpoints of ``stage``, ranked best-first:

    1. the explicitly-named run;
    2. runs with a STAMPED conditioning eval (``eval.retrieval_at_1``),
       highest first: a retrain's val loss can improve while its
       conditioning collapses, so val loss alone must never outrank a
       measured conditioning number;
    3. runs with only a recorded val metric, ascending;
    4. metricless checkpoints (mid-write / old format), newest first.
    """
    wait_for_writes()     # a best this process is still writing counts once it is whole
    exp = Path(cfg.experiment_dir)
    seen = set()
    out: List[Dict] = []

    def add(p: Path, named: bool):
        if p.exists() and p not in seen:
            seen.add(p)
            out.append(_candidate(p, named))

    if experiment_name:
        add(exp / f"{experiment_name}_{stage}" / "checkpoints"
            / f"{stage}_best_model.ckpt", named=True)
    add(exp / f"{stage}_best_model.ckpt", named=False)
    add(Path("weights") / f"{stage}_best_model.ckpt", named=False)
    for p in exp.glob(f"*_{stage}/checkpoints/{stage}_best_model.ckpt"):
        add(p, named=False)

    def key(c):
        has_eval = c["eval"] is not None
        has_metric = c["metric"] is not None
        return (not c["named"], not has_eval,
                -(c["eval"] if has_eval else 0.0), not has_metric,
                c["metric"] if has_metric else -c["mtime"])

    out.sort(key=key)
    return out


def _pair_vae(cfg, diff: Dict, vaes: List[Dict]) -> Optional[Dict]:
    """The VAE that belongs to ``diff``: never pair a UNet with a VAE from
    a different latent space."""
    recorded = diff.get("vae_checkpoint")
    if recorded:
        p = Path(recorded)
        wait_for_writes()
        if p.exists():
            return _candidate(p)
        log.warning("recorded vae_checkpoint %s is gone — falling back", p)
    # same run family: X_diffusion -> X_vae
    prefix = diff["run"].removesuffix("_diffusion")
    for v in vaes:
        if v["run"].removesuffix("_vae") == prefix:
            return v
    if vaes:
        log.warning(
            "no paired VAE for diffusion %s — using best-ranked %s "
            "(verify the latent spaces match)",
            diff["run"] or diff["path"], vaes[0]["path"])
        return vaes[0]
    return None


def _family(run: str) -> str:
    for suffix in ("_final", "_diffusion", "_vae", "_diffusers"):
        if run.endswith(suffix):
            return run[: -len(suffix)]
    return run


def _final_shadows(final: Dict, diff: Optional[Dict], cfg) -> bool:
    if (getattr(cfg, "extra", None) or {}).get("serve_prefer_final"):
        return True
    if diff is None:
        return True  # no stage-2 alternative — the final bundle is all we have
    if final["eval"] is None:
        log.info("stage-3 final %s has no recorded conditioning eval — "
                 "serving the stage-2 pair", final["path"])
        return False
    diff_eval = (diff or {}).get("eval")
    if _family(final["run"]) != _family(diff["run"]) and not final["named"]:
        # A final bundle from ANOTHER run never shadows an explicitly-
        # named stage-2 pair, and shadows an unnamed one only on measured
        # merit (both sides stamped; the not-worse check below).
        if diff["named"] or diff_eval is None:
            log.info("foreign-run final %s does not shadow the %s stage-2 "
                     "pair %s", final["path"],
                     "named" if diff["named"] else "unstamped", diff["path"])
            return False
    if diff_eval is not None:
        fr, dr = final.get("eval_recipe"), diff.get("eval_recipe")
        if (fr and dr and (fr.get("prompts"), fr.get("n"))
                != (dr.get("prompts"), dr.get("n"))):
            # different prompt set or n => different chance rate; the two
            # retrieval@1 numbers are NOT comparable — require a matching
            # stamp rather than crown a winner on incomparable scales
            log.info("stage-3 final %s stamped under a different eval "
                     "recipe (%s/n=%s vs %s/n=%s) — serving the stage-2 "
                     "pair; re-stamp both under one recipe to compare",
                     final["path"], fr.get("prompts"), fr.get("n"),
                     dr.get("prompts"), dr.get("n"))
            return False
        if final["eval"] < diff_eval:
            log.info("stage-3 final eval %.3f < stage-2 eval %.3f — serving "
                     "the stage-2 pair", final["eval"], diff_eval)
            return False
    return True


def describe_candidates(cfg, experiment_name: str = "pokemon") -> str:
    """Human-readable candidate table (serve CLI --list-checkpoints)."""
    lines = []
    for stage in ("final", "diffusion", "vae"):
        cands = list_candidates(cfg, stage, experiment_name)
        lines.append(f"[{stage}]" + ("  (none)" if not cands else ""))
        for c in cands:
            lines.append(
                f"  {c['path']}  run={c['run']} step={c['step']} "
                f"val={c['metric'] if c['metric'] is not None else '-'} "
                f"eval@1={c['eval'] if c['eval'] is not None else '-'}"
                + ("  [named]" if c["named"] else ""))
    vae, diff = resolve_checkpoints(cfg, experiment_name, allow_hub=False)
    lines.append(f"resolved pair: vae={vae} diffusion={diff}")
    return "\n".join(lines)


def _hub_reachable(timeout: float = 2.0) -> bool:
    """Quick DNS probe — zero-egress environments would otherwise burn
    minutes in huggingface_hub's internal retry/backoff loops."""
    import os
    import socket

    if os.environ.get("HF_HUB_OFFLINE") == "1":
        return False
    try:
        socket.setdefaulttimeout(timeout)
        socket.getaddrinfo("huggingface.co", 443)
        return True
    except OSError:
        return False
    finally:
        socket.setdefaulttimeout(None)


def _try_hub(repo: str, filename: str) -> Optional[str]:
    if not _hub_reachable():
        log.info("HF Hub unreachable (offline) — skipping %s/%s", repo, filename)
        return None
    try:
        from huggingface_hub import hf_hub_download

        return hf_hub_download(repo_id=repo, filename=filename)
    except Exception as e:  # missing dependency / no repo / auth
        log.info("HF Hub unavailable for %s/%s: %s", repo, filename, e)
        return None


def resolve_checkpoints(cfg, experiment_name: str = "pokemon",
                        allow_hub: bool = True) -> Tuple[Optional[str], Optional[str]]:
    """-> (vae_ckpt_path or None, diffusion_ckpt_path or None).

    When a stage-3 ``final`` bundle wins (see module docstring), both
    slots point at the same file and the generator loads all three
    components from it."""
    diffs = list_candidates(cfg, "diffusion", experiment_name)
    vaes = list_candidates(cfg, "vae", experiment_name)
    diff = diffs[0] if diffs else None
    vae = _pair_vae(cfg, diff, vaes) if diff else (vaes[0] if vaes else None)

    finals = list_candidates(cfg, "final", experiment_name)
    if finals and _final_shadows(finals[0], diff, cfg):
        log.info("serving the stage-3 final checkpoint %s", finals[0]["path"])
        return str(finals[0]["path"]), str(finals[0]["path"])

    vae_p = str(vae["path"]) if vae else None
    diff_p = str(diff["path"]) if diff else None
    if diff_p:
        log.info("serving diffusion %s (val %s) + vae %s", diff_p,
                 diff.get("metric"), vae_p)
    if vae_p is None and allow_hub:
        vae_p = _try_hub(VAE_REPO, "vae_best_model.ckpt")
    if diff_p is None and allow_hub:
        diff_p = _try_hub(UNET_REPO, "diffusion_best_model.ckpt")
    return vae_p, diff_p
