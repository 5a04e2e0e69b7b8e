"""Driver entry points (the port's twin of ``__graft_entry__.py``).

- ``entry()``: one forward of the flagship model, the 655M-parameter
  text-conditioned UNet at full width, batch 4, bf16 compute, on the card;
  returns the predicted noise ``[4, 27, 27, 8]``.
- ``dryrun_multichip(n)``: ``n`` gloo processes on the CPU as an
  ('data', 'model') mesh, ``(n/2, 2)`` when ``n`` is even and at least 4,
  else ``(n, 1)``; each runs one step of every stage (1: VAE + text, 2: the
  UNet's diffusion loss, 3: the text encoder with CLIP) on its rows of the
  batch with the state placed by ``parallel.shard_state`` (the TP rule at
  32 channels, so the tiny widths shard), then a DPM-Solver++ chain of 8
  steps and the VAE decode; then the stage-2 trainer on a synthetic corpus
  must place its state as ``shard_state`` does.

``python -m psg_tpu_torch.graft_entry`` runs ``entry()`` on the card;
``python -m psg_tpu_torch.graft_entry --dryrun N`` runs the dry run.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
_TIMEOUT_S = 600


def entry(device=None) -> torch.Tensor:
    """The full-width UNet forward at batch 4 in bf16 (weights drawn from
    seed 0, inputs from seed 1, as the JAX entry's): ``[4, 27, 27, 8]``."""
    from psg_tpu_torch.models.unet import UNetSpec, unet_apply, unet_init
    from psg_tpu_torch.nn.layers import prepare_weights
    from psg_tpu_torch.serve.generator import resolve_device

    dev = resolve_device(device)
    spec = UNetSpec(text_dim=768, num_heads=4)
    params = prepare_weights(unet_init(torch.Generator(device=dev).manual_seed(0), spec),
                             torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    b = 4
    latent = torch.randn((b, 27, 27, 8), generator=gen, device=dev)
    text = torch.randn((b, 128, 768), generator=gen, device=dev)
    t = torch.full((b,), 500, dtype=torch.int32, device=dev)
    mask = torch.ones((b, 128), dtype=torch.int32, device=dev)
    with torch.no_grad():
        return unet_apply(params, latent, t, text, spec, text_mask=mask, dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# the multi-process dry run
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int) -> str:
    """Spawn the ``n_devices`` ranks of the dry run and wait for them (each
    with a timeout); raise if any fails.  Returns rank 0's summary line."""
    from psg_tpu_torch.data.synthetic import write_sprite_corpus

    port = _free_port()
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        write_sprite_corpus(Path(tmp) / "corpus", n=12, seed=0, size=64)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(REPO), os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "psg_tpu_torch.graft_entry", "--dryrun-rank", str(r),
             str(n_devices), str(port), tmp], cwd=str(REPO), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"dryrun_multichip: ranks {bad} failed:\n"
                               + "\n".join(o[-3000:] for o in outs))
    line = [ln for ln in outs[0].splitlines() if ln.startswith("dryrun_multichip ok")]
    if not line:
        raise RuntimeError(f"dryrun_multichip: rank 0 printed no result:\n{outs[0][-3000:]}")
    print(line[-1], flush=True)
    return line[-1]


def _dryrun_rank(rank: int, world: int, port: int, tmp: str) -> None:
    """One rank: every stage's step on the mesh, the sampling chain, and the
    trainer's placements against ``shard_state``'s."""
    import dataclasses

    from psg_tpu_torch.core import draws as draws_
    from psg_tpu_torch.core import tree
    from psg_tpu_torch.core.config import Config
    from psg_tpu_torch.diffusion.sampling import dpmpp_2m_sample
    from psg_tpu_torch.diffusion.schedule import make_schedule
    from psg_tpu_torch.models.bert import BertConfig
    from psg_tpu_torch.models.clip import ClipConfig, clip_alignment_loss, clip_init
    from psg_tpu_torch.models.losses import kl_divergence, l1_loss, mse_loss, smooth_l1_loss
    from psg_tpu_torch.models.text_encoder import text_encoder_apply, text_encoder_init
    from psg_tpu_torch.models.unet import UNetSpec, text_bias_from_mask, unet_apply, unet_init
    from psg_tpu_torch.models.vae import reparameterize, vae_decode, vae_encoder_apply, vae_init
    from psg_tpu_torch.parallel import initialize_distributed, make_mesh, shard_state
    from psg_tpu_torch.parallel.mesh import mesh_shape
    from psg_tpu_torch.parallel.sharding import unet_tp_rules
    from psg_tpu_torch.train.common import MeshRun
    from psg_tpu_torch.train.optim import build_optimizer
    from psg_tpu_torch.train.state import TrainState

    torch.set_num_threads(1)
    sys.modules.setdefault("torch.utils.tensorboard", None)
    initialize_distributed(f"127.0.0.1:{port}", world, rank, device="cpu",
                           timeout_s=_TIMEOUT_S)
    model_axis = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(data=world // model_axis, model=model_axis)
    rule = unet_tp_rules(min_channels=32)        # tiny widths still shard
    text_dim, image_size, latent_size, latent_dim = 32, 64, 9, 8
    bert_cfg, clip_cfg = BertConfig.tiny_test(), ClipConfig.tiny_test()
    spec = UNetSpec(text_dim=text_dim, time_emb_dim=32, channels=(16, 32, 64, 64),
                    num_heads=2, spatial=(9, 5, 3, 2))
    batch = 2 * mesh.size(0)
    gen = torch.Generator().manual_seed(0)
    unet_params = unet_init(gen, spec)
    vae_params = vae_init(gen, latent_dim, text_dim, 0.25)
    text_params = text_encoder_init(gen, bert_cfg, text_dim)
    clip_params = clip_init(gen, clip_cfg)
    schedule = make_schedule(50, 1e-4, 0.02, "cosine")
    rng = np.random.RandomState(0)
    host = {"image": torch.from_numpy(
                rng.randn(batch, image_size, image_size, 3).astype(np.float32)),
            "text_ids": torch.zeros((batch, 16), dtype=torch.long),
            "text_mask": torch.ones((batch, 16), dtype=torch.long)}
    opt_cfg = dataclasses.replace(Config().optimization, learning_rate=1e-4)

    def run_stage(params, loss_fn, seed):
        """One AdamW step of ``loss_fn(params, rows, draws)`` on the mesh
        with the state placed by ``shard_state``."""
        params = tree.map(lambda t: t.detach().requires_grad_(True), params)
        tx = build_optimizer(opt_cfg, {"all": {"lr_schedule": lambda c: 1e-4,
                                               "max_grad_norm": None}},
                             tree.map(lambda _: "all", params))
        state = shard_state(TrainState(0, params, tx.init(params),
                                       torch.Generator().manual_seed(seed)), mesh, rule)
        run = MeshRun(mesh, params, rule)
        rows = run.local(host)
        draws, _, whole = run.step_inputs(state, rows["image"].shape[0], None)
        loss = loss_fn(whole, rows, draws)
        paths, leaves = zip(*tree.items(whole))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = run.reduce_grads(paths, [g if g is not None else torch.zeros_like(p)
                                         for g, p in zip(grads, leaves)])
        it = iter(grads)
        tx.update(state.params, tree.map(lambda _: next(it), state.params), state.opt_state,
                  layout=state.layout)
        loss = float(run.mean(loss.detach()))
        assert np.isfinite(loss), f"non-finite loss {loss}"
        return state, run, loss

    def s1_loss(p, b, draws):
        emb = text_encoder_apply(p["text"], b["text_ids"], b["text_mask"], bert_cfg)
        mu, logvar = vae_encoder_apply(p["vae"]["encoder"], b["image"])
        latent = reparameterize(draws, mu, logvar)
        recon = vae_decode(p["vae"], latent, emb, text_bias=text_bias_from_mask(b["text_mask"]),
                           image_size=image_size)
        return l1_loss(recon, b["image"]) + 1e-3 * kl_divergence(mu, logvar)

    s1_state, s1_run, s1 = run_stage({"vae": vae_params, "text": text_params}, s1_loss, 7)
    frozen = s1_run.gather(s1_state.params)
    frozen = tree.map(lambda t: t.detach(), frozen)

    def s2_loss(p, b, draws):
        with torch.no_grad():
            emb = text_encoder_apply(frozen["text"], b["text_ids"], b["text_mask"], bert_cfg)
            mu, logvar = vae_encoder_apply(frozen["vae"]["encoder"], b["image"])
            latent = reparameterize(draws, mu, logvar).clamp(-3.0, 3.0)
            t = draws_.randint(draws, 0, 50, (latent.shape[0],))
            noise = draws_.randn(draws, latent.shape)
            noisy = schedule.add_noise(latent, noise, t)
        pred = unet_apply(p, noisy, t, emb, spec, text_mask=b["text_mask"])
        return smooth_l1_loss(pred, noise, beta=0.1)

    s2_state, s2_run, s2 = run_stage(unet_params, s2_loss, 8)

    def s3_loss(p, b, draws):
        emb = text_encoder_apply(p, b["text_ids"], b["text_mask"], bert_cfg)
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(frozen["vae"]["encoder"], b["image"])
            latent = reparameterize(draws, mu, logvar)
        recon = vae_decode(frozen["vae"], latent, emb,
                           text_bias=text_bias_from_mask(b["text_mask"]), image_size=image_size)
        gen_loss = l1_loss(recon, b["image"]) + 0.1 * mse_loss(recon, b["image"])
        clip = clip_alignment_loss(clip_params, recon, b["text_ids"], b["text_mask"], clip_cfg)
        return gen_loss + 0.1 * clip

    _, _, s3 = run_stage(frozen["text"], s3_loss, 9)

    # the sampling chain with the stage-2 UNet gathered whole, this rank's rows
    unet = s2_run.gather(s2_state.params)
    draws, (ids, mask) = s2_run.split_rows(torch.Generator().manual_seed(10), batch,
                                           host["text_ids"], host["text_mask"])
    with torch.no_grad():
        emb = text_encoder_apply(frozen["text"], ids, mask, bert_cfg)
        latents = dpmpp_2m_sample(
            lambda x, t: unet_apply(unet, x, t, emb, spec, text_mask=mask), schedule, draws,
            shape=(ids.shape[0], latent_size, latent_size, latent_dim),
            num_inference_steps=8, clip_x0=3.0)
        imgs = vae_decode(frozen["vae"], latents, emb, text_bias=text_bias_from_mask(mask),
                          image_size=image_size)
    imgs = s2_run.gather_rows(imgs, batch)
    assert tuple(imgs.shape) == (batch, image_size, image_size, 3)
    assert bool(torch.isfinite(imgs).all())

    # the stage-2 trainer on this mesh places its state as shard_state does
    from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

    cfg = Config()
    cfg.experiment_dir = str(Path(tmp) / "exp")
    m = cfg.model
    m.bert_model, m.vae_width_scale, m.text_embedding_dim = "tiny-test", 0.25, text_dim
    m.unet_channels, m.num_attention_heads, m.time_emb_dim = spec.channels, spec.num_heads, 32
    cfg.data.csv_path = str(Path(tmp) / "corpus" / "captions.csv")
    cfg.data.image_dir = str(Path(tmp) / "corpus" / "images")
    cfg.data.image_size, cfg.data.batch_size, cfg.data.text_len = image_size, batch, 16
    cfg.data.num_workers = 1
    cfg.extra = {"tp_min_channels": 32}
    trainer = DiffusionTrainer(cfg, None, experiment_name="dryrun", device="cpu", mesh=mesh)
    unet_t = trainer.mesh_run.gather(trainer.state.params)
    probe = shard_state(TrainState(0, unet_t, trainer.tx.init(unet_t), None), mesh, rule)
    got = {p: tuple(x.shape) for p, x in tree.items(trainer.state.params)}
    want = {p: tuple(x.shape) for p, x in tree.items(probe.params)}
    assert got == want and trainer.state.layout.dims == probe.layout.dims, \
        "trainer/dryrun sharding mismatch"
    assert model_axis == 1 or trainer.state.layout.dims, \
        "trainer produced no model-sharded params on a TP mesh"
    mu = trainer.state.opt_state["groups"]["unet"]["mu"]
    assert all(tuple(mu[p].shape) == want[p] for p in want), "Adam moments not TP-sharded"
    if rank == 0:
        print("trainer sharding parity: ok")
        print(f"dryrun_multichip ok: mesh={mesh_shape(mesh)} batch={batch} "
              f"losses s1={s1:.4f} s2={s2:.4f} s3={s3:.4f} sample={tuple(imgs.shape)} "
              f"sharded={len(trainer.state.layout.dims)}", flush=True)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--dryrun-rank"]:
        _dryrun_rank(int(args[1]), int(args[2]), int(args[3]), args[4])
    elif args[:1] == ["--dryrun"]:
        dryrun_multichip(int(args[1]))
    else:
        out = entry()
        print(f"entry ok: {tuple(out.shape)} finite={bool(torch.isfinite(out).all())}")
