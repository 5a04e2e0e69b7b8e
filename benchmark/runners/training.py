"""What the training runners share: the first steps that the reference
follows, the measured window of optimizer steps, and the comparison.

A job's set-up builds one trainer, hands it the benchmark's weights, and
drives it through its first steps by the window's own call and feed; the
same trainer then runs the window.  From those first steps the program's
readings are kept: each step's loss, the norm of each trained leaf's first
gradient as the optimizer got it (from its second moment after step 1), and
each trained leaf's change after step 3 (before step 4 moves it).  After the
window the reference runs the same steps from the same weights and draws.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import corpus, kernels, weights
from benchmark.harness.hostuse import HostUse
from benchmark.harness.parts import Parts
from benchmark.harness.spans import Spans
from benchmark.reference import precision, tree as tree_

CHECKED_STEPS = 3


def leaf_gap(program: dict, reference: dict):
    """The worst leaf's gap between the program's norm and the reference's,
    over the larger of the reference's norm of that leaf and of the median
    leaf; a leaf missing on one side counts as a gap of 1."""
    med = float(np.median(list(reference.values()))) if reference else 0.0
    worst = 0.0
    for path, ref in reference.items():
        got = program.get(path)
        if got is None:
            return 1.0
        worst = max(worst, abs(got - ref) / max(ref, med, 1e-30))
    if set(program) - set(reference):
        return 1.0
    return worst


class Readings:
    """The numbers of the first steps compared: losses, first-gradient
    norms and change norms, by trained leaf."""

    def __init__(self):
        self.losses = []
        self.grad_norms = {}
        self.change_norms = {}


def compare(prog: Readings, ref: Readings, small: set, limits: dict) -> dict:
    """The checks that ``limits`` names: each step's loss (``loss_rel``, the
    worst step's relative gap), the first gradient (``grad_leaf_gap``) and
    the change after the checked steps (``change_leaf_gap``), both by
    ``leaf_gap``, ``small`` (leaves whose gradient is nought to rounding)
    left out of the change."""
    n = min(len(prog.losses), len(ref.losses))
    loss_gap = max((abs(a - b) / max(abs(b), 1e-30) for a, b in
                    zip(prog.losses[:n], ref.losses[:n])), default=float("inf"))
    if n < CHECKED_STEPS:
        loss_gap = float("inf")
    values = {
        "loss_rel": loss_gap,
        "grad_leaf_gap": leaf_gap(prog.grad_norms, ref.grad_norms),
        "change_leaf_gap": leaf_gap(
            {k: v for k, v in prog.change_norms.items() if k not in small},
            {k: v for k, v in ref.change_norms.items() if k not in small})}
    return {k: {"value": v, "limit": float(limits[k])} for k, v in values.items()
            if k in limits}


def small_leaves(grad_norms: dict) -> set:
    """Leaves whose first gradient is under a thousandth of the median
    leaf's: nought to rounding, moved by round-off alone under Adam."""
    if not grad_norms:
        return set()
    med = float(np.median(list(grad_norms.values())))
    return {k for k, v in grad_norms.items() if v < 1e-3 * med}


def merge(raw: dict, overrides: dict) -> dict:
    """The configuration with a job's section overrides."""
    out = dict(raw)
    for k, v in overrides.items():
        out[k] = dict(out.get(k, {}), **v) if isinstance(v, dict) else v
    return out


class TrainingRun:
    """Set-up, the first steps, the window and the comparison of a training
    job.  A job subclass gives ``REF`` (its reference module, with
    ``template`` and ``Job``) and ``_build_program``, ``_next_batch``,
    ``_program_step``, ``_trained_leaves``, ``_ema_leaves``,
    ``_reference_steps``, ``_job_spans`` and ``_flops``."""

    REF = None

    def __init__(self, root, cell, seed: int, device, *, program: str = "port",
                 trace: bool = False):
        self.parts = Parts()
        self.seed, self.program = int(seed), program
        self.device = torch.device(device)
        torch.empty(0, device=self.device)
        self.parts.mark("device init")
        job = self.job = cell.traffic
        self._tmp = tempfile.TemporaryDirectory(prefix="bench-train-")
        tmp = Path(self._tmp.name)
        rng = np.random.default_rng(self.seed)
        rows = corpus.captions(rng, int(job["sprites"]))
        csv = corpus.write_csv(tmp / "captions.csv", rows)
        corpus.write_sprites(tmp / "images", len(rows), rng)
        (tmp / "experiment").mkdir()
        self.vocab = tmp / "experiment" / "vocab.txt"
        self.vocab_size = corpus.write_vocab(self.vocab, rows)
        job_seed = int(rng.integers(0, 2 ** 31 - 1))
        raw = merge(cell.config["config"], job.get("overrides", {}))
        raw["seed"] = job_seed
        raw["data"] = dict(raw["data"], csv_path=str(csv), image_dir=str(tmp / "images"),
                           seed=job_seed)
        raw["experiment_dir"] = str(tmp / "experiment")
        self.raw = raw
        self.batch_size = int(raw["data"]["batch_size"])
        self.parts.mark("corpus")
        self.template = self.REF.template(raw, self.vocab_size, weights.MetaGenerator())
        self.weight_seed = int(rng.integers(0, 2 ** 62))
        self.n_params = weights.count(self.template)
        self.steps = self.traced_steps = self.attempted = self.failed = 0
        self.loader_wait_s = self.window_s = 0.0
        self.batches = []            # the checked steps' batches, where the job has them
        self.prog = Readings()
        self.spans = None
        self._build_program()
        self.parts.mark("program")
        self._first_steps()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        # the checked steps drove the window's own call at its shapes: they
        # are the warm-up
        self.parts.mark("checked steps")
        self.flops_per_step = self._flops()
        self.parts.mark("flop count")
        self.parts.report(self.device)

    @property
    def steps_per_epoch(self) -> int:
        d = self.raw["data"]
        n = int(self.job["sprites"])
        return (n - int(n * d["val_split"]) - int(n * d["test_split"])) // self.batch_size

    def _bench_weights(self) -> dict:
        """{path: leaf} of the benchmark's weights, drawn from the seed."""
        return dict(tree_.items(weights.fill(self.template, self.weight_seed, self.device)))

    @staticmethod
    @torch.no_grad()
    def _copy_into(program_tree, mine: dict, prefix: str) -> None:
        """Copy the benchmark's leaves into the program's, path by path;
        raise on a shape the configuration does not give."""
        for path, leaf in tree_.items(program_tree):
            src = mine[f"{prefix}{path}"]
            if tuple(src.shape) != tuple(leaf.shape):
                raise ValueError(f"{prefix}{path}: {tuple(leaf.shape)} in the program, "
                                 f"{tuple(src.shape)} in the configuration")
            leaf.copy_(src)

    def _first_steps(self):
        """The checked steps through the window's own call and feed."""
        if self.program != "port":
            for _ in range(CHECKED_STEPS):
                self.batches.append(self._next_batch())
            return
        before = {p: t.detach().float().clone() for p, t in self._trained_leaves().items()}
        losses = []
        b2 = self.trainer.tx.b2
        for k in range(CHECKED_STEPS):
            batch = self._next_batch()
            self.batches.append(batch)
            losses.append(self._program_step(batch))
            if k == 0:
                for g in self.trainer.state.opt_state["groups"].values():
                    for path, nu in g["nu"].items():
                        self.prog.grad_norms[path] = float(
                            (nu.float().sum() / (1.0 - b2)).sqrt())
        changed = {p: t.detach().float() for p, t in self._trained_leaves().items()}
        changed.update({f"ema.{p}": t.detach().float()
                        for p, t in self._ema_leaves().items()})
        self.prog.change_norms = {p: float((t - before[p.removeprefix("ema.")]).norm())
                                  for p, t in changed.items()}
        self.prog.losses = [float(x) for x in losses]

    def _ema_leaves(self) -> dict:
        return {}

    def window(self, seconds: float, host_spans: bool = False) -> None:
        """The measured window: optimizer steps back to back, no spans (the
        loader's waits are timed in every window)."""
        if self.program != "port":
            self.window_s = seconds
            return
        self._window_steps(seconds)

    def _reference_readings(self, lowered: bool):
        """The reference's readings of the checked steps from the same
        weights and draws (with ``lowered``: fp8 operands)."""
        params = weights.separate(weights.fill(self.template, self.weight_seed, self.device))
        ctx = precision.lowered(precision.fp8) if lowered else contextlib.nullcontext()
        with precision.float32(), ctx:
            job = self.REF.Job(self.raw, params, self.vocab, self.device,
                               steps_per_epoch=self.steps_per_epoch)
            out = self._reference_steps(job)
        return out, job

    def _extra_checks(self, job) -> dict:
        return {}

    def check(self) -> dict:
        limits = self.job["limits"]
        if self.program == "control":
            self.prog, _ = self._reference_readings(lowered=True)
            self.release_program()
        ref, job = self._reference_readings(lowered=False)
        checks = compare(self.prog, ref, small_leaves(ref.grad_norms), limits)
        if self.program == "port" and set(ref.grad_norms) != set(self.prog.grad_norms):
            checks["trained_leaves"] = {"value": 1.0, "limit": 0.0}   # they differ
        checks.update(self._extra_checks(job))
        return checks


    def _loop(self, seconds: float, tracer, host=None):
        """Optimizer steps back to back for ``seconds``, under ``tracer`` if
        given: (steps completed, seconds, seconds waited on the loader).
        The window ends in a device synchronize."""
        steps, waited, losses = 0, 0.0, []
        sync = torch.cuda.synchronize if self.device.type == "cuda" else (lambda: None)
        with (tracer if tracer is not None else contextlib.nullcontext()):
            sync()
            if host is not None:
                host.start()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                tw = time.perf_counter()
                batch = self._next_batch()
                waited += time.perf_counter() - tw
                try:
                    losses.append(self._program_step(batch))
                    steps += 1
                except Exception:   # a failed step is counted, never retried
                    import traceback

                    traceback.print_exc(file=sys.stderr)
                    self.failed += 1
                self.attempted += 1
                if host is not None:
                    host.mark()
            # the losses stay on the device until the window has closed
            vals = torch.stack([torch.as_tensor(x).float().reshape(())
                                for x in losses]).cpu() if losses else None
            sync()
            wall = time.perf_counter() - t0
            if host is not None:
                host.stop()
        if vals is not None and not bool(torch.isfinite(vals).all()):
            print("error: a non-finite loss in the window", file=sys.stderr)
            self.failed += 1
        return steps, wall, waited

    def _window_steps(self, seconds: float) -> None:
        self.host = HostUse()
        self.steps, self.window_s, self.loader_wait_s = self._loop(seconds, None, self.host)
        print(f"window: {self.steps} steps of {self.batch_size} samples in "
              f"{self.window_s:.3f} s; loader waits {self.loader_wait_s:.3f} s",
              file=sys.stderr)
        self.host.report("step", sys.stderr)

    def traced(self, seconds: float, tracer) -> None:
        """A window under ``tracer`` after the measured one, with the
        benchmark's ranges around the kernels and the job's calls."""
        if self.program != "port":
            return
        self.spans = Spans()
        kernels.install(self.spans)
        self._job_spans(self.spans)
        try:
            self.traced_steps, wall, _ = self._loop(seconds, tracer)
        finally:
            self.spans.restore()
        print(f"traced window: {self.traced_steps} steps in {wall:.3f} s", file=sys.stderr)

    def units(self):
        """(work done in the measured window, in the traced one): steps."""
        return self.steps, self.traced_steps

    def release_program(self) -> None:
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
