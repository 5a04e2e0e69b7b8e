"""One rank of the port's mesh tests (``tests/test_torch_parallel.py``).

``python tests/torch_mesh_worker.py <rank> <world> <port> <dir> <check>...``
joins a gloo group of ``world`` ranks on localhost, runs each named check
on the CPU and saves what it found to ``<dir>/<check>.rank<rank>.pt``.
Every check builds the same tiny trainers (or generator) as the test's
single-process reference, from the same config, corpus and seed, so the
test compares the two runs value by value.  The worker imports torch and
``psg_tpu_torch`` only, runs one thread, and gives every collective a
timeout.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from psg_tpu_torch.core import tree  # noqa: E402
from psg_tpu_torch.core.config import Config  # noqa: E402

CAPTIONS = ["a small green creature with leaves", "a red fire lizard with a flame",
            "a blue water turtle", "a yellow electric mouse"]
GLOBAL_BATCH = 4
TIMEOUT_S = 240


def tiny_config(exp, corpus, **extra) -> Config:
    """tests/test_torch_train_stage2.py's tiny config, batch 4."""
    cfg = Config()
    cfg.experiment_dir = str(exp)
    cfg.model.bert_model = "tiny-test"
    cfg.model.vae_width_scale = 0.25
    cfg.model.text_embedding_dim = 48
    cfg.model.unet_channels = (16, 24, 32, 32)
    cfg.model.num_attention_heads = 4
    cfg.model.time_emb_dim = 32
    cfg.model.num_timesteps = 50
    cfg.data.csv_path, cfg.data.image_dir = str(corpus[0]), str(corpus[1])
    cfg.data.image_size = 64
    cfg.data.batch_size = GLOBAL_BATCH
    cfg.data.text_len = 32
    cfg.data.num_workers = 1
    cfg.training.diffusion_epochs = 1
    cfg.training.vae_epochs = 1
    cfg.training.final_epochs = 2
    cfg.training.phase1_epochs = 1
    cfg.training.sample_every = 1000
    cfg.optimization.ema_decay = 0.99
    cfg.extra = dict(extra)
    return cfg


def global_batch(tokenizer, seed: int = 0):
    """A global batch of 4 made with numpy: images, caption ids and masks
    (the SD trainer's bare-description ids too)."""
    rng = np.random.RandomState(seed)
    ids, mask = tokenizer.encode_batch(CAPTIONS, 32)
    desc_ids, desc_mask = tokenizer.encode_batch([c.split(" with ")[0] for c in CAPTIONS], 32)
    return {"image": rng.uniform(-1, 1, (GLOBAL_BATCH, 64, 64, 3)).astype(np.float32),
            "text_ids": ids, "text_mask": mask, "desc_ids": desc_ids, "desc_mask": desc_mask}


def corpus_of(root: Path):
    return root / "corpus" / "captions.csv", root / "corpus" / "images"


def snapshot(t) -> dict:
    """Detached CPU copies of a tree's tensors, by path."""
    return {p: x.detach().float().cpu().clone() for p, x in tree.items(t)}


# ---------------------------------------------------------------------------
# checks; each returns a dict the test compares with its single-process run
# ---------------------------------------------------------------------------


def whole(trainer, t):
    """A tree of the trainer's params' paths, gathered whole on a mesh."""
    mr = getattr(trainer, "mesh_run", None)
    return mr.gather(t) if mr is not None else t


def stage2_step(trainer, batch, draws=None) -> dict:
    """One stage-2 step: loss, gradients, then params and EMA after it; then
    the validation loss over a batch whose last row is padding."""
    b = trainer._batch(batch)
    loss, grads = trainer._grads(b, draws=draws)
    out = {"loss": float(loss), "grads": snapshot(whole(trainer, grads))}
    stats = trainer._apply_update(loss, grads)
    out.update(grad_norm=float(stats["grad_norm"]),
               params=snapshot(whole(trainer, trainer.state.params)),
               ema=snapshot(whole(trainer, trainer.state.ema)),
               val=float(trainer._eval(trainer._batch(batch), 3)["loss"]))
    return out


def stage2_trainer(root: Path, exp: str, mesh, rule_min: int = 640, device="cpu"):
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

    extra = {"snr_gamma": 5.0, "cond_dropout": 0.5, "tp_min_channels": rule_min}
    return DiffusionTrainer(tiny_config(root / exp, corpus_of(root), **extra), None,
                            experiment_name="m", device=device, mesh=mesh)


def step_parts(trainer, batch, grads_fn, update, evaluate) -> dict:
    """One step of any trainer (``grads_fn(batch)``, then ``update(parts,
    grads)``): its loss parts, gradients, params after it, and
    ``evaluate(batch)``'s loss after it."""
    b = trainer._batch(batch)
    parts, grads = grads_fn(b)
    if not isinstance(parts, dict):
        parts = {"loss": parts}
    out = {"parts": {k: float(v) for k, v in parts.items()},
           "grads": snapshot(whole(trainer, grads))}
    stats = update(parts, grads)
    out.update(grad_norm=float(stats["grad_norm"]),
               params=snapshot(whole(trainer, trainer.state.params)),
               val=float(evaluate(trainer._batch(batch))))
    return out


def mesh_of(data: int, model: int):
    from psg_tpu_torch.parallel import make_mesh
    from psg_tpu_torch.parallel.mesh import mesh_shape

    mesh = make_mesh(data=data, model=model)
    assert mesh_shape(mesh) == {"data": data, "model": model}
    return mesh


CHECKS = {}


def check(fn):
    CHECKS[fn.__name__] = fn
    return fn


@check
def stage2_dp(root, rank):
    """(2, 1): a stage-2 step, validation, then the best checkpoint; the
    same best again with async writes (rank 0 writes, every rank waits),
    which every rank then restores; then async writes that fail on rank 0,
    whose error every rank must raise, at the next save and at ``wait()``,
    once, and a sync write that fails on rank 0, which every rank raises at
    that save."""
    import shutil

    from psg_tpu_torch.core.checkpoint import CheckpointManager
    from psg_tpu_torch.train.common import agree

    t = stage2_trainer(root, "exp_dp", mesh_of(2, 1))
    out = stage2_step(t, global_batch(t.tokenizer))
    assert t.save_checkpoint(0, 0.5)
    out["best"] = str(t.ckpt.best_path)
    t.ckpt = CheckpointManager(root / "exp_dp_async", t.STAGE, 5, True, writer=rank == 0,
                               sync=agree)
    assert t.save_checkpoint(0, 0.5)
    t.ckpt.wait()
    out["async_best"] = str(t.ckpt.best_path)
    live = {"params": snapshot(t.state.params), "ema": snapshot(t.state.ema),
            "mu": snapshot(t.state.opt_state["groups"]["unet"]["mu"]), "step": t.state.step}
    t.state = t._fresh_state(tree.map(torch.zeros_like, t.state.params), step=0,
                             rng=t.state.rng)
    t.load_checkpoint()
    out["restored"] = {"params": snapshot(t.state.params), "ema": snapshot(t.state.ema),
                       "mu": snapshot(t.state.opt_state["groups"]["unet"]["mu"]),
                       "step": t.state.step}
    out["live"] = live

    def failing(name, async_writes):
        bad = root / f"exp_dp_{name}{rank}"
        m = CheckpointManager(bad, t.STAGE, 5, async_writes, writer=rank == 0, sync=agree)
        if rank == 0:                  # rank 0's writes cannot land: its directory is a file
            shutil.rmtree(bad)
            bad.write_text("a file where the checkpoint directory was")
        return m

    def raised(fn):
        try:
            fn()
        except Exception as e:
            return f"{type(e).__name__}: {str(e)[:48]} <- {type(e.__cause__).__name__}"
        return None

    t.ckpt = failing("bad", True)
    out["failed_write"] = {"first": raised(lambda: t.save_checkpoint(0, 0.4)),
                           "save": raised(lambda: t.save_checkpoint(0, 0.3)),
                           "second": raised(lambda: t.save_checkpoint(0, 0.2)),
                           "wait": raised(t.ckpt.wait), "again": raised(t.ckpt.wait)}
    t.ckpt = failing("bad_sync", False)
    out["failed_write"].update(sync=raised(lambda: t.save_checkpoint(0, 0.4)),
                               sync_again=raised(lambda: t.save_checkpoint(0, 0.3)))
    return out


@check
def stage2_jax(root, rank):
    """(2, 1): the JAX mesh trainer's params, frozen parts and draws."""
    from psg_tpu_torch.models import bridge
    from psg_tpu_torch.nn.layers import prepare_weights

    given = torch.load(root / "jax_step.pt", weights_only=False)
    t = stage2_trainer(root, "exp_jax", mesh_of(2, 1))
    t.frozen = prepare_weights(bridge.fit(t.frozen, given["frozen"]))
    t.state = t._fresh_state(given["params"], step=0, rng=t.state.rng)
    for k, v in given["options"].items():
        setattr(t, k, v)
    return stage2_step(t, given["batch"], given["draws"])


@check
def stage2_tp(root, rank):
    """(2, 2): a TP step with the rule at 32 channels, the local shards'
    shapes, the best checkpoint written from the mesh, and a resume onto
    the mesh from it."""
    t = stage2_trainer(root, "exp_tp", mesh_of(2, 2), rule_min=32)
    shards = {p: tuple(x.shape) for p, x in tree.items(t.state.params)}
    moments = {p: tuple(x.shape) for p, x in t.state.opt_state["groups"]["unet"]["mu"].items()}
    ema = {p: tuple(x.shape) for p, x in tree.items(t.state.ema)}
    out = stage2_step(t, global_batch(t.tokenizer))
    out.update(shards=shards, moments=moments, ema_shards=ema,
               dims=dict(t.state.layout.dims))
    assert t.save_checkpoint(0, 0.5)
    out["best"] = str(t.ckpt.best_path)
    fresh = stage2_trainer(root, "exp_tp", mesh_of(2, 2), rule_min=32)
    fresh.load_checkpoint(str(t.ckpt.best_path))
    out["resumed"] = {name: all(torch.equal(a, b) for a, b in zip(
        tree.leaves(getattr(fresh.state, name)), tree.leaves(getattr(t.state, name))))
        for name in ("params", "ema")}
    out["resumed_step"] = fresh.state.step
    return out


@check
def stage1_dp(root, rank):
    from psg_tpu_torch.train.stage1_vae import VAETrainer

    t = VAETrainer(tiny_config(root / "exp_s1", corpus_of(root)), "m", device="cpu",
                   mesh=mesh_of(2, 1))
    return step_parts(t, global_batch(t.tokenizer), lambda b: t._grads(b, 0.01),
                      lambda p, g: t._apply_update(p, g, 0.01),
                      lambda b: t._eval(b, 3, 0.01)["total_loss"])


@check
def stage3_dp(root, rank):
    from psg_tpu_torch.train.stage3_final import FinalTrainer

    t = FinalTrainer(tiny_config(root / "exp_s3", corpus_of(root)), None, None, "m",
                     device="cpu", mesh=mesh_of(2, 1))
    t.switch_to_joint_training()
    return step_parts(t, global_batch(t.tokenizer), t._grads, t._apply_update,
                      lambda b: t._eval(b, 3)["total_loss"])


def sd_config(root, exp):
    """tests/test_torch_train_stage2_sd.py's tiny SD config (training mode
    'full', so every part gets a gradient)."""
    cfg = tiny_config(root / exp, corpus_of(root))
    cfg.model.cross_attention_dim = 48
    cfg.model.freeze_encoder = cfg.model.freeze_decoder = False
    return cfg


@check
def sd_dp(root, rank):
    from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer

    t = SDDiffusionTrainer(sd_config(root, "exp_sd"), None, "m", device="cpu",
                           mesh=mesh_of(2, 1))
    return step_parts(t, global_batch(t.tokenizer), t._grads,
                      lambda p, g: t._apply_update(p["loss"], g),
                      lambda b: t._eval(b, 3)["loss"])


def generator(root, mesh=None, **extra):
    from psg_tpu_torch.serve.generator import PokemonGenerator
    from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

    cfg = tiny_config(root / "exp_gen", corpus_of(root), tp_min_channels=32, **extra)
    vocab = REPO / "experiments/evidence_r5c_vae/vocab.txt"
    return PokemonGenerator(cfg, tokenizer=WordPieceTokenizer.from_vocab_file(vocab),
                            sampler="ddim", guidance_scale=2.0, device="cpu", mesh=mesh)


def generate(gen) -> dict:
    """n = 3 (padded on a 2-row 'data' axis): DDIM with fused CFG, and the
    DDPM sampler from retrieval with a restart pass (per-step draws)."""
    prompts = ["a green leaf creature", "a red fire lizard", "a blue water turtle"]
    return {"ddim": gen.generate_batch(prompts, 3, seed=5),
            "ddpm": gen.generate_batch(prompts, 3, seed=6, sampler="ddpm",
                                       init="retrieval", restarts=1)}


@check
def generate_dp(root, rank):
    return generate(generator(root, mesh_of(2, 1)))


@check
def generate_tp(root, rank):
    gen = generator(root, mesh_of(1, 2))
    out = generate(gen)
    out["sharded"] = len(gen.mesh_run.layout.dims)
    return out


PLACEMENT_MIN = {"unet": 24, "sd_unet": 64, "wide": 640}


def placement_trees():
    """The trees whose placements the test holds against JAX's: the tiny
    UNet, the tiny SD UNet, and a few leaves around 640 channels."""
    from psg_tpu_torch.models.sd_unet import SDUNetSpec, sd_unet_init
    from psg_tpu_torch.models.unet import UNetSpec, unet_init

    gen = torch.Generator().manual_seed(0)
    unet = unet_init(gen, UNetSpec(text_dim=48, time_emb_dim=32, channels=(16, 24, 32, 32),
                                   spatial=(9, 5, 3, 2)))
    wide = {"lin_out": {"w": torch.zeros(645, 1280)}, "lin_odd": {"w": torch.zeros(1280, 645)},
            "lin_in": {"w": torch.zeros(645, 8)}, "conv": {"w": torch.zeros(1280, 645, 3, 3)},
            "conv_in": {"w": torch.zeros(8, 1280, 1, 1)}, "norm": {"scale": torch.zeros(1280)}}
    return {"unet": unet, "sd_unet": sd_unet_init(gen, SDUNetSpec.tiny_test(text_dim=48)),
            "wide": wide}


@check
def placements(root, rank):
    """On a (1, 2) mesh: ``param_shardings`` under ``unet_tp_rules`` for
    each tree, as {path: sharded dim or None}."""
    from psg_tpu_torch.parallel import param_shardings, unet_tp_rules

    mesh = mesh_of(1, 2)
    out = {}
    for name, params in placement_trees().items():
        sh = param_shardings(params, mesh, unet_tp_rules(PLACEMENT_MIN[name]))
        out[name] = {}
        for path, leaf in tree.items(params):
            node = sh
            for k in path.split("."):
                node = node[int(k)] if isinstance(node, list) else node[k]
            assert node[0].is_replicate()
            out[name][path] = node[1].dim if node[1].is_shard() else None
    return out


def main() -> None:
    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    out_dir = Path(sys.argv[4])
    torch.set_num_threads(1)
    sys.modules.setdefault("torch.utils.tensorboard", None)   # no TensorBoard import
    from psg_tpu_torch.parallel import initialize_distributed

    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=TIMEOUT_S)
    for name in sys.argv[5:]:
        t0 = time.time()
        result = CHECKS[name](out_dir, rank)
        result["seconds"] = time.time() - t0
        torch.save(result, out_dir / f"{name}.rank{rank}.pt")
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
