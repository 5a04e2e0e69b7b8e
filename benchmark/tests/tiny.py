"""Tiny stand-ins for the benchmark's configurations and cells, for the CPU
tests: the same files and harness, at widths a test process can hold."""

from __future__ import annotations

import copy
import json

from benchmark.harness import spec

# cells whose files the benchmark keeps, runner and reference included, but
# which BENCHMARK.json does not list (PERF.md says why): name -> (the
# configuration's file, the traffic's name)
KEPT = {"sd15.train.b32": ("benchmark/configs/sd15.json", "train_loader_step")}

TINY_MODEL = {"bert_model": "tiny-test", "vae_width_scale": 0.25,
              "text_embedding_dim": 48, "unet_channels": [16, 24, 32, 32],
              "num_attention_heads": 4, "time_emb_dim": 32, "num_timesteps": 50,
              "compute_dtype": "float32"}
TINY_DATA = {"image_size": 64, "text_len": 32}


def cell(root, name: str, **traffic):
    """``name``'s cell with its configuration cut to tiny widths and its
    traffic file updated by ``traffic``."""
    c = _kept(root, name) if name in KEPT else spec.resolve(root, name)
    c.config = copy.deepcopy(c.config)
    raw = c.config["config"]
    raw["model"].update(TINY_MODEL)
    raw["data"].update(TINY_DATA)
    if "sd_unet" in raw:
        raw["model"]["cross_attention_dim"] = 32
        raw["sd_unet"].update({"block_out_channels": [16, 24, 32, 32],
                               "attention_head_dim": 2, "norm_num_groups": 8,
                               "cross_attention_dim": 32})
    c.traffic = dict(copy.deepcopy(c.traffic), **traffic)
    return c


def _kept(root, name: str) -> spec.Cell:
    conf, traffic = KEPT[name]
    e2e = [m for m in spec.load(root)["end_to_end"] if "workloads" not in m]
    return spec.Cell(name, json.loads((root / conf).read_text()),
                     json.loads(spec.traffic_path(root, traffic).read_text()), 1, e2e, [])
