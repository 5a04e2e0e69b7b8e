"""Text -> sprite requests from one closed-loop client.

The traffic file gives the recipe (``sampler``, ``steps``, ``guidance``,
``negative``, ``restarts``, ``restart_strength``, ``schedule``), the
caption corpus the ``mean`` negative reads (``corpus_captions``), the
warm-up requests, the traced window (``trace_seconds``), how many finished
requests the reference re-makes (``check_requests``) and the limit of each
number compared (``limits``).  The client sends each request when the one
before it has returned its image: one ``PokemonGenerator``, one request at a
time, as the app serves them.
"""

from __future__ import annotations

import contextlib
import gc
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from benchmark.counters import model as model_flops
from benchmark.harness import corpus, kernels, weights
from benchmark.harness.hostuse import HostUse
from benchmark.harness.parts import Parts
from benchmark.harness.spans import Spans
from benchmark.reference import precision, serve as ref_serve

POOL = 4096   # requests drawn per run; a window uses the first it needs


class Run:
    def __init__(self, root, cell, seed: int, device, *, program: str = "port",
                 trace: bool = False):
        self.parts = Parts()
        self.seed = int(seed)
        self.device = torch.device(device)
        torch.empty(0, device=self.device)
        self.parts.mark("device init")
        self.recipe = cell.traffic
        self.raw = dict(cell.config["config"])
        self._tmp = tempfile.TemporaryDirectory(prefix="bench-serve-")
        tmp = Path(self._tmp.name)
        rng = np.random.default_rng(self.seed)
        rows = corpus.captions(rng, int(self.recipe["corpus_captions"]))
        csv = corpus.write_csv(tmp / "captions.csv", rows)
        self.vocab = tmp / "vocab.txt"
        self.vocab_size = corpus.write_vocab(self.vocab, rows)
        self.raw["data"] = dict(self.raw["data"], csv_path=str(csv), image_dir=str(tmp))
        self.raw["experiment_dir"] = str(tmp / "experiment")
        self.requests = list(zip(corpus.prompts(rng, POOL),
                                 (int(s) for s in rng.integers(0, 2 ** 31 - 1, POOL))))
        self.parts.mark("corpus")
        self.template = ref_serve.serving_template(self.raw, self.vocab_size,
                                                   weights.MetaGenerator())
        self.weight_seed = int(rng.integers(0, 2 ** 62))
        self.n_params = weights.count(self.template)
        # leaves of their own, so that the one buffer they are drawn into is
        # freed once the program has taken its copy
        params = weights.separate(weights.fill(self.template, self.weight_seed,
                                               self.device))
        self.parts.mark("weights")
        self.program = program
        if program == "port":
            self._serve = self._port(params)
        elif program == "control":
            self._serve = self._control(params)
        else:
            raise ValueError(f"unknown program {program!r}")
        del params
        self.parts.mark("program")
        self.spans = self.host_spans = None
        self.records = []          # (index, seconds, image) of finished requests
        self._next = 0             # the next request of the pool to send
        self.traced_requests = 0
        self.attempted = self.failed = 0
        self.window_s = 0.0
        for i in range(int(self.recipe.get("warmup_requests", 1))):
            self._serve(*self.requests[-1 - i])
        self.parts.mark("warm-up")
        self.flops_per_request = self._flops()
        self.parts.mark("flop count")
        self.parts.report(self.device)

    # -- the system under test ------------------------------------------------

    def _port(self, params):
        from psg_tpu_torch.core.config import config_from_dict
        from psg_tpu_torch.serve.generator import PokemonGenerator
        from psg_tpu_torch.text.tokenizer import WordPieceTokenizer as PortTokenizer

        r = self.recipe
        self.gen = PokemonGenerator(
            config_from_dict(self.raw), tokenizer=PortTokenizer.from_vocab_file(self.vocab),
            schedule_kind=r.get("schedule", "linear"), sampler=r["sampler"],
            guidance_scale=float(r["guidance"]), negative=r["negative"], params=params,
            device=self.device)

        def serve(prompt, seed):
            img = self.gen.generate_from_text(
                prompt, num_inference_steps=int(r["steps"]), seed=seed,
                restarts=int(r["restarts"]), restart_strength=float(r["restart_strength"]))
            return np.asarray(img)

        return serve

    def _control(self, params):
        """The reference with its matmul and convolution operands in fp8, in
        the program's place."""
        with precision.float32(), precision.lowered(precision.fp8):
            ref = ref_serve.Generator(self.raw, params, self.vocab, self.recipe,
                                      self.device)

        def serve(prompt, seed):
            with precision.float32(), precision.lowered(precision.fp8):
                return ref.generate(prompt, seed)

        return serve

    # -- the window -----------------------------------------------------------

    def _loop(self, seconds: float, tracer=None, host=None, keep=None):
        """Requests back to back until ``seconds`` have passed, under
        ``tracer`` if given; ``keep(index, seconds, image, ended)`` receives
        each finished request.  Returns the requests finished."""
        done = 0
        with (tracer if tracer is not None else contextlib.nullcontext()):
            if host is not None:
                host.start()
            t0 = time.perf_counter()
            while True:
                prompt, seed = self.requests[self._next % POOL]
                ts = time.perf_counter()
                try:
                    img = self._serve(prompt, seed)
                except Exception:   # a failed request is counted, never retried
                    traceback.print_exc(file=sys.stderr)
                    img = None
                    self.failed += 1
                te = time.perf_counter()
                self.attempted += 1
                if img is not None:
                    done += 1
                    if keep is not None:
                        keep(self._next, te - ts, img, te - t0)
                    if host is not None:
                        host.mark()
                self._next += 1
                if te - t0 >= seconds:
                    break
            if host is not None:
                host.stop()
        return done

    def window(self, seconds: float, host_spans: bool = False) -> None:
        """The measured window.  With ``host_spans`` (a traced run) the
        sampler's calls are timed on the host, each ending in a device
        synchronize, and the UNet's evaluations counted."""
        import psg_tpu_torch.serve.generator as g

        if host_spans and self.program == "port":
            self.host_spans = Spans()
            self.host_spans.wrap(g, "unet_apply", "unet")
            self.host_spans.wrap(g._SAMPLERS, self.recipe["sampler"], "sampler", sync=True)

        def keep(i, s, img, ended):
            if ended <= seconds:
                self.records.append((i, s, img))

        self.host = HostUse()
        try:
            self._loop(seconds, host=self.host, keep=keep)
        finally:
            if self.host_spans is not None:
                self.host_spans.restore()
        self.window_s = seconds
        lat = sorted(s for _, s, _ in self.records)
        if lat:
            print(f"window: {len(lat)} requests completed; latency s min "
                  f"{lat[0]:.4f} median {lat[len(lat) // 2]:.4f} max {lat[-1]:.4f}",
                  file=sys.stderr)
        self.host.report("request", sys.stderr)

    def traced(self, seconds: float, tracer) -> None:
        """A window under ``tracer`` after the measured one, with the
        benchmark's ranges around the kernels, the UNet and the sampler."""
        import psg_tpu_torch.serve.generator as g

        if self.program != "port":
            return
        self.spans = Spans()
        kernels.install(self.spans)
        self.spans.wrap(g, "unet_apply", "unet", lambda *a, **k: a[1].shape[0])
        self.spans.wrap(g._SAMPLERS, self.recipe["sampler"], "sampler")
        try:
            self.traced_requests = self._loop(seconds, tracer)
        finally:
            self.spans.restore()
        print(f"traced window: {self.traced_requests} requests", file=sys.stderr)

    def units(self):
        """(work done in the measured window, in the traced one): requests."""
        return len(self.records), self.traced_requests

    def release_program(self) -> None:
        self.gen = None
        self._serve = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the comparison -------------------------------------------------------

    def check(self) -> dict:
        """The reference re-makes a sample of finished requests, drawn from
        the seed; the number compared is the largest mean absolute
        difference of a served image from the reference's, in [0, 1]."""
        n = min(int(self.recipe["check_requests"]), len(self.records))
        limit = float(self.recipe["limits"]["image_mae"])
        if n == 0:
            return {"image_mae": {"value": float("inf"), "limit": limit}}
        pick = np.random.default_rng(self.seed + 1).choice(len(self.records), n,
                                                          replace=False)
        params = weights.fill(self.template, self.weight_seed, self.device)
        with precision.float32():
            ref = ref_serve.Generator(self.raw, params, self.vocab, self.recipe, self.device)
            worst = 0.0
            for j in pick:
                i, _, img = self.records[int(j)]
                want = ref.generate(*self.requests[i % POOL])
                mae = float(np.abs(img.astype(np.float64) - want.astype(np.float64)).mean())
                worst = max(worst, mae / 255.0)
        return {"image_mae": {"value": worst, "limit": limit}}

    # -- model FLOPs ----------------------------------------------------------

    def _flops(self) -> float:
        """Operations of one request's matrix products and convolutions in
        the reference, counted on the meta device."""
        from benchmark.reference.text_encoder import text_encoder_apply
        from benchmark.reference.unet import unet_apply
        from benchmark.reference.vae import vae_decode, vae_encoder_apply

        ref = ref_serve
        cfg = ref.as_config(self.raw)
        m, s = cfg.model, cfg.data.text_len
        p = self.template
        meta = torch.device("meta")
        lat = ref.latent_size_for(cfg.data.image_size)
        spec = ref.unet_spec_from_config(cfg, lat)
        bert = ref.bert_config_for(m.bert_model, self.vocab_size)
        ids = torch.zeros((1, s), dtype=torch.long, device=meta)
        emb1 = torch.empty((1, s, m.text_embedding_dim), device=meta)
        text = model_flops.flops(lambda: text_encoder_apply(p["text"], ids, ids, bert))
        unet = model_flops.flops(lambda: unet_apply(
            p["unet"], torch.empty((2, lat, lat, m.latent_dim), device=meta),
            torch.zeros((2,), dtype=torch.int32, device=meta),
            torch.empty((2, s, m.text_embedding_dim), device=meta), spec,
            text_mask=torch.ones((2, s), dtype=torch.long, device=meta)))
        dec = model_flops.flops(lambda: vae_decode(
            p["vae"], torch.empty((1, lat, lat, m.latent_dim), device=meta), emb1,
            text_bias=torch.zeros((1, 1, 1, s), device=meta),
            image_size=cfg.data.image_size))
        enc = model_flops.flops(lambda: vae_encoder_apply(
            p["vae"]["encoder"],
            torch.empty((1, cfg.data.image_size, cfg.data.image_size, 3), device=meta)))
        r = self.recipe
        passes = 1 + int(r["restarts"])
        return text + passes * int(r["steps"]) * unet + passes * dec + int(r["restarts"]) * enc
