#!/usr/bin/env python3
"""The checkpoint writer of two trees of psg_tpu_torch, timed in turns on
one card.

    python3 scripts/torch_ckpt_ab.py OTHER_TREE [--dir DIR] [--json PATH]

OTHER_TREE is an unpacked earlier commit (``git archive``).  Each run is a
process of its own that imports ``psg_tpu_torch`` from one tree, draws the
full-width stage-2 state on the card from a seed (the 655M-parameter UNet
of ``config/train_config.yaml`` and both Adam moments, fp32) and writes it
with that tree's ``save_state``, sync: the seconds of ``to_checkpoint()``
(the copy to the host in trees that make it there; views of the state
where the writer copies each leaf itself), of the write, and their sum
(``sync_s``, what compares across trees), the file's GB and sha256.  A tree
with async writes also times ``save_state(..., async_write=True)``: the
seconds it blocks and the write's own seconds up to ``wait_for_writes()``.
The order is other, this, this, other; every file must have the same
sha256.  The files go to a temporary directory in DIR (default: the
system's; each run writes about 16 GB, so on a machine whose disk limits
what a run may write, give a RAM-backed DIR such as /dev/shm).  Prints one
JSON line per run, then the card's name and power limit.  Needs one CUDA
card; imports no JAX.
"""

import argparse
import hashlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _sha256(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(64 << 20):
            h.update(chunk)
    return h.hexdigest()


def worker(tree: Path, directory):
    sys.path.insert(0, str(tree))
    import torch

    from psg_tpu_torch.core import checkpoint, tree as tree_util
    from psg_tpu_torch.core.config import load_config
    from psg_tpu_torch.models.unet import unet_init, unet_spec_from_config
    from psg_tpu_torch.train.state import TrainState

    if not Path(checkpoint.__file__).resolve().is_relative_to(tree.resolve()):
        raise SystemExit(f"psg_tpu_torch came from {checkpoint.__file__}, not {tree}")
    cfg = load_config(ROOT / "config" / "train_config.yaml")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = unet_init(gen, unet_spec_from_config(cfg, 27))
    moments = {k: {p: torch.rand(t.shape, generator=gen, device="cuda")
                   for p, t in tree_util.items(params)} for k in ("mu", "nu")}
    state = TrainState(1, params, {"count": 1, **moments},
                       torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    out = {"tree": str(tree)}
    with tempfile.TemporaryDirectory(prefix="ckpt_ab_", dir=directory) as tmp:
        t = time.perf_counter()
        ckpt_tree = state.to_checkpoint()
        out["to_checkpoint_s"] = time.perf_counter() - t
        path = Path(tmp) / "sync.ckpt"
        t = time.perf_counter()
        checkpoint.save_state(path, ckpt_tree, {"step": 1})
        out["sync_write_s"] = time.perf_counter() - t
        out["sync_s"] = out["to_checkpoint_s"] + out["sync_write_s"]
        out["gb"], out["sha256"] = path.stat().st_size / 1e9, _sha256(path)
        path.unlink()
        del ckpt_tree
        if hasattr(checkpoint, "wait_for_writes"):
            path = Path(tmp) / "async.ckpt"
            t = time.perf_counter()
            checkpoint.save_state(path, state.to_checkpoint(), {"step": 1},
                                  async_write=True)
            out["async_blocked_s"] = time.perf_counter() - t
            checkpoint.wait_for_writes()
            out["async_write_s"] = time.perf_counter() - t
            if _sha256(path) != out["sha256"]:
                raise SystemExit("the async file differs from the sync one")
    print(json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", type=Path, help="the other tree's root")
    ap.add_argument("--dir", help="where the files go (default: the system's temp dir)")
    ap.add_argument("--json", help="also write the runs here")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        return worker(args.worker, args.dir)
    runs = []
    for tree in (args.other, ROOT, ROOT, args.other):
        res = subprocess.run([sys.executable, __file__, "--worker", str(tree), str(tree)]
                             + (["--dir", args.dir] if args.dir else []),
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            raise SystemExit(f"run on {tree} failed:\n{res.stdout[-3000:]}{res.stderr[-3000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    if len({r["sha256"] for r in runs}) != 1:
        raise SystemExit("the trees' writers wrote different bytes")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=30).stdout.strip()
    print(card, flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"card": card, "runs": runs}, indent=1))


if __name__ == "__main__":
    main()
