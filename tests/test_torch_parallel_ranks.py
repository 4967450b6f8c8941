"""The ranks of the port's parallel parity tests, and the cases they share
with the one process they are held against.

Each case is a function of a mesh: with ``None`` it runs the one-process
port on the global batch, with a mesh it runs this rank's part of the same
step, and either way it returns the whole result (every rank's parts
joined). ``tests/test_torch_parallel.py`` and
``tests/test_torch_parallel_entries.py`` launch this file as gloo ranks
with torchrun's environment::

    RANK=r WORLD_SIZE=n MASTER_ADDR=127.0.0.1 MASTER_PORT=p \\
        python tests/test_torch_parallel_ranks.py <out dir> <group>

and compare what rank 0 saves under ``<out dir>/<case>.pt`` with the
case run in the test's own process. Only torch, numpy and the port are
imported here.
"""
from __future__ import annotations

import copy
import json
import math
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist

from diff_foley_tpu_torch.diffusion.latent_diffusion import (LatentDiffusion,
                                                              LDMConfig)
from diff_foley_tpu_torch.models.cavp import CAVPConfig, CAVPModel
from diff_foley_tpu_torch.models.cavp.layers import BatchNorm2d
from diff_foley_tpu_torch.models.unet import ClassifierBackbone, UNetConfig
from diff_foley_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from diff_foley_tpu_torch.parallel import collectives
from diff_foley_tpu_torch.parallel import sharding_rules as rules
from diff_foley_tpu_torch.parallel.mesh import make_mesh, shard_batch
from diff_foley_tpu_torch.parallel.sharding_rules import gather_tp
from diff_foley_tpu_torch.train import classifier as tclf
from diff_foley_tpu_torch.train import losses
from diff_foley_tpu_torch.train import stage1_cavp as ts1
from diff_foley_tpu_torch.train import stage2_ldm as ts2
from diff_foley_tpu_torch.train.vae import VAETrainConfig, VAETrainer
from diff_foley_tpu_torch.train.vae_losses import BatchNorm, VAELossConfig

UNET_KW = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,), num_heads=4, context_dim=24)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
CLF_KW = dict(out_channels=1, model_channels=32, num_res_blocks=1,
              channel_mult=(1, 2), attention_resolutions=(2,), num_heads=4,
              context_dim=512)
CAVP_KW = dict(video_stage_blocks=(1, 1, 1, 1), video_base_channels=8,
               spec_channels=(8, 8, 16, 16, 32, 32), pool_kernel=4)
B = 4            # the global batch (two rows a rank on two ranks)
# the FSDP threshold the stage-2 cases run at (``stage2_trainer`` sets
# the rule's constant around the split): most of the tiny model's leaves
# split
FSDP_MIN = 256
CLIP = 2


@torch.no_grad()
def randomize_(module: torch.nn.Module, seed: int):
    """Seeded weights with no zero layer: lecun-normal kernels, biases and
    norm scales spread around 0 and 1."""
    g = torch.Generator().manual_seed(seed)
    for name, p in module.named_parameters():
        r = torch.randn(p.shape, generator=g, dtype=torch.float64)
        if p.dim() >= 2:
            p.copy_(r / math.sqrt(p[0].numel()))
        elif name.endswith("weight"):
            p.copy_(1.0 + 0.1 * r)
        else:
            p.copy_(0.1 * r)
    return module


def rows(mesh, batch):
    return batch if mesh is None else shard_batch(mesh, batch)


def _np(t):
    return t.detach().cpu().double().numpy()


# ---- stage 2 --------------------------------------------------------------

def stage2_batch(step: int) -> dict:
    data = np.random.default_rng(100 + step)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    return {"z_mu": t(data.standard_normal((B, 8, 16, 4))),
            "z_sigma": t(data.uniform(0.1, 0.5, (B, 8, 16, 4))),
            "video_feat": t(data.standard_normal((B, 8, 512)))}


def stage2_trainer(mesh, fsdp=False, accum=1):
    ldm = LatentDiffusion(LDMConfig(
        unet=UNetConfig(**UNET_KW), vae=VAEConfig(**VAE_KW),
        cond_embed_dim=24, cond_seq_len=8))
    randomize_(ldm, 1)
    cfg = ts2.Stage2TrainConfig(base_lr=1e-3, warmup_steps=0, use_ema=True,
                                ema_decay=0.9, grad_clip=0.5,
                                accum_steps=accum)
    trainer = ts2.Stage2Trainer(ldm, cfg, mesh=mesh, fsdp=fsdp)
    saved, rules.FSDP_MIN_SIZE = rules.FSDP_MIN_SIZE, FSDP_MIN
    try:
        return trainer, trainer.init_train_state(None, "cpu")
    finally:
        rules.FSDP_MIN_SIZE = saved


def whole_grads(trainer, state) -> dict:
    out = {}
    for k, p in state.params.items():
        g = p.grad
        if trainer.layout is not None:
            g = trainer.layout.gather(k, g)
        if trainer.specs is not None:
            g = gather_tp(trainer.specs, k, g, trainer.mesh)
        out[k] = _np(g)
    return out


def case_stage2(mesh, fsdp=False, accum=1, steps=2):
    """``steps`` calls (AdamW moves every ``accum``-th): the metrics and
    the masters' gradients of each call, and the whole state after."""
    trainer, state = stage2_trainer(mesh, fsdp, accum)
    gen = torch.Generator().manual_seed(6)
    out = {"metrics": [], "grads": []}
    for step in range(steps):
        m = trainer.train_step(state, rows(mesh, stage2_batch(step)), gen)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grads"].append(whole_grads(trainer, state))
    out["eval"] = {k: float(v) for k, v in trainer.eval_step(
        state, rows(mesh, stage2_batch(9)),
        torch.Generator().manual_seed(9)).items()}
    out["state"] = trainer.state_dict(state)
    return out


def case_stage2_restore(mesh):
    """The FSDP state after one step, gathered, loaded back into fresh
    parts and gathered again; then one more step from it."""
    trainer, state = stage2_trainer(mesh, fsdp=True)
    gen = torch.Generator().manual_seed(6)
    trainer.train_step(state, rows(mesh, stage2_batch(0)), gen)
    # copies: the whole tensors of unsplit leaves are the live ones
    saved = copy.deepcopy(trainer.state_dict(state))
    fresh, fresh_state = stage2_trainer(mesh, fsdp=True)
    fresh.load_state_dict(fresh_state, saved)
    reloaded = copy.deepcopy(fresh.state_dict(fresh_state))
    m = fresh.train_step(fresh_state, rows(mesh, stage2_batch(1)), gen)
    return {"saved": saved, "reloaded": reloaded,
            "metrics": {k: float(v) for k, v in m.items()}}


# ---- the other trainers ---------------------------------------------------

def case_vae(mesh):
    """Two VAE steps with the GAN term on: metrics, both models'
    gradients of step 1 and the PatchGAN's running statistics."""
    trainer = VAETrainer(VAEConfig(**VAE_KW), VAETrainConfig(
        lr=1e-3, loss=VAELossConfig(disc_start=0)), mesh=mesh)
    state = trainer.init_train_state(3, "cpu")
    gen = torch.Generator().manual_seed(7)
    data = np.random.default_rng(8)
    out = {"metrics": []}
    for step in range(2):
        x = torch.from_numpy(data.uniform(size=(B, 32, 32, 3)).astype(
            np.float32))
        m = trainer.train_step(state, rows(mesh, x), generator=gen)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if step == 0:
            out["grads"] = {
                **{f"vae.{k}": _np(p.grad)
                   for k, p in state.vae.named_parameters()},
                **{f"disc.{k}": _np(p.grad)
                   for k, p in state.disc.named_parameters()}}
        out[f"stats{step}"] = {k: _np(v) for k, v in
                               state.disc.named_buffers()}
    return out


def case_classifier(mesh):
    trainer = tclf.ClassifierTrainer(
        UNetConfig(**CLF_KW), AutoencoderKL(VAEConfig(**VAE_KW)),
        tclf.ClassifierTrainConfig(lr=1e-3), cond_seq_len=40, mesh=mesh)
    randomize_(trainer.model, 4)
    state = trainer.init_train_state(None, "cpu")
    data = np.random.default_rng(9)
    t = lambda a: torch.from_numpy(a.astype(np.float32))
    batch = {"z_mu": t(data.standard_normal((B, 8, 16, 4))),
             "z_sigma": t(data.uniform(0.1, 0.5, (B, 8, 16, 4))),
             "video_feat": t(data.standard_normal((B, 32, 512))),
             "labels": torch.tensor([1, 0, 1, 0])}
    m = trainer.train_step(state, rows(mesh, batch),
                           torch.Generator().manual_seed(10))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: _np(p.grad) for k, p in state.params.items()}}


class CAVPModel64(CAVPModel):
    """The towers computing in float64 (ReLU kinks would split fp32)."""

    compute_dtype = torch.float64


def cavp_batch(seed: int, k=None) -> dict:
    data = np.random.default_rng(seed)
    lead = (B,) if k is None else (k, B)
    return {"video": torch.from_numpy(data.uniform(
                size=lead + (CLIP, 4, 32, 32, 3))),
            "spec": torch.from_numpy(data.uniform(
                size=lead + (CLIP, 128, 64)))}


def case_cavp(mesh):
    """A float64 train step with dropout, then an accumulated step (K 2):
    the metrics, the gradients and the BatchNorm statistics after each."""
    model = randomize_(CAVPModel64(CAVPConfig(**CAVP_KW, axis_name="data")),
                       11).double().train()
    trainer = ts1.Stage1Trainer(model, ts1.Stage1TrainConfig(
        lr=1e-3, warmup_steps=0, clip_num=CLIP), mesh=mesh)
    params = dict(model.named_parameters())
    state = ts1.CAVPTrainState(0, params, ts1.make_optimizer(
        trainer.cfg, params), None, ts1.batch_stats(model))
    gen = torch.Generator().manual_seed(12)
    out = {}
    batch = cavp_batch(13)
    m = trainer.train_step(state, rows(mesh, batch), gen)
    out["step"] = {"metrics": {k: float(v) for k, v in m.items()},
                   "grads": {k: _np(p.grad) for k, p in params.items()},
                   "stats": {k: _np(v) for k, v in state.batch_stats.items()}}
    micro = cavp_batch(14, k=2)
    if mesh is not None:
        micro = {k: v[:, mesh.rows(B)] for k, v in micro.items()}
    m = trainer.accum_train_step(state, micro, gen)
    out["accum"] = {"metrics": {k: float(v) for k, v in m.items()},
                    "grads": {k: _np(p.grad) for k, p in params.items()},
                    "stats": {k: _np(v) for k, v in
                              state.batch_stats.items()}}
    return out


def case_cavp_towers(mesh):
    """One float64 train step of the other towers at ``cli.train_cavp``'s
    ``--tiny`` cut (i3d × resnet50, every norm a BatchNorm, no dropout):
    the metrics, the gradients and the BatchNorm statistics after it."""
    from diff_foley_tpu_torch.cli.train_cavp import TINY_TOWERS

    model = randomize_(CAVPModel64(CAVPConfig(
        video_arch="i3d", spec_arch="resnet50", axis_name="data",
        video_tower=TINY_TOWERS["i3d"], spec_tower=TINY_TOWERS["resnet50"])),
        16).double().train()
    trainer = ts1.Stage1Trainer(model, ts1.Stage1TrainConfig(
        lr=1e-3, warmup_steps=0, clip_num=CLIP), mesh=mesh)
    params = dict(model.named_parameters())
    state = ts1.CAVPTrainState(0, params, ts1.make_optimizer(
        trainer.cfg, params), None, ts1.batch_stats(model))
    data = np.random.default_rng(17)
    batch = {"video": torch.from_numpy(data.uniform(
                 size=(B, CLIP, 4, 32, 32, 3))),
             "spec": torch.from_numpy(data.uniform(
                 size=(B, CLIP, 128, 256)))}
    m = trainer.train_step(state, rows(mesh, batch))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: _np(p.grad) for k, p in params.items()},
            "stats": {k: _np(v) for k, v in state.batch_stats.items()}}


# ---- the building blocks --------------------------------------------------

def contrastive_inputs():
    data = np.random.default_rng(15)
    feats = []
    for _ in range(2):
        f = data.standard_normal((B * CLIP, 16))
        feats.append(f / np.linalg.norm(f, axis=1, keepdims=True))
    return feats


def case_contrastive(mesh):
    """clip_loss and intra_contrast_loss over the gathered batch: the
    loss, the feature gradients (every rank's, joined, over the data
    degree: the ``grad_mean_`` convention) and logit_scale's."""
    group = None if mesh is None else mesh.data_group
    n = collectives.size(group)
    out = {}
    for name in ("clip", "intra"):
        v, s = (torch.from_numpy(f) for f in contrastive_inputs())
        v, s = (rows(mesh, t).clone().requires_grad_(True) for t in (v, s))
        scale = torch.tensor(1 / 0.07, dtype=torch.float64,
                             requires_grad=True)
        gv = collectives.all_gather_with_grad(v, group)
        gs = collectives.all_gather_with_grad(s, group)
        loss = (losses.clip_loss(gv, gs, scale) if name == "clip" else
                losses.intra_contrast_loss(gv, gs, scale,
                                           clip_num=CLIP)["total_loss"])
        loss.backward()
        out[name] = {"loss": float(loss.detach()),
                     "scale_grad": float(scale.grad),
                     "v_grad": _np(collectives.all_gather(v.grad, group) / n),
                     "s_grad": _np(collectives.all_gather(s.grad, group) / n)}
    return out


def case_batchnorm(mesh):
    """The CAVP and the PatchGAN BatchNorm in train mode on the global
    batch's statistics: outputs, input and parameter gradients of
    Σ y·g (g a fixed tensor), running statistics."""
    group = None if mesh is None else mesh.data_group
    data = np.random.default_rng(16)
    x = torch.from_numpy(data.standard_normal((B * 2, 6, 5, 5)))
    g = torch.from_numpy(data.standard_normal((B * 2, 6, 5, 5)))
    out = {}
    for name, cls in (("cavp", BatchNorm2d), ("patchgan", BatchNorm)):
        bn = randomize_(cls(6), 17).double()
        if cls is BatchNorm2d:
            bn.train()
        collectives.sync_batchnorm_(bn, group)
        xi = rows(mesh, x).clone().requires_grad_(True)
        y = bn(xi) if cls is BatchNorm2d else bn(xi, train=True)
        (y * rows(mesh, g)).sum().backward()
        wg, bg = bn.weight.grad.clone(), bn.bias.grad.clone()
        if group is not None:
            dist.all_reduce(wg, group=group)
            dist.all_reduce(bg, group=group)
        out[name] = {"y": _np(collectives.all_gather(y, group)),
                     "x_grad": _np(collectives.all_gather(xi.grad, group)),
                     "w_grad": _np(wg), "b_grad": _np(bg),
                     "mean": _np(bn.running_mean),
                     "var": _np(bn.running_var)}
    return out


# ---- the entries ----------------------------------------------------------

def tiny_pipeline(mesh):
    from diff_foley_tpu_torch.pipeline import DiffFoleyPipeline

    ldm = randomize_(LatentDiffusion(LDMConfig(
        unet=UNetConfig(**UNET_KW),
        vae=VAEConfig(ch=32, ch_mult=(1, 1, 1, 1), num_res_blocks=1),
        cond_embed_dim=24)), 18)
    clf = randomize_(ClassifierBackbone(UNetConfig(**CLF_KW)), 19)
    return DiffFoleyPipeline(ldm, clf, device="cpu", mesh=mesh)


def gen_config(**kw):
    from diff_foley_tpu_torch.pipeline import GenerationConfig

    return GenerationConfig(**{**dict(steps=2, sample_num=2, gl_iters=2,
                                      cfg_scale=4.5, classifier_scale=50.0),
                               **kw})


def case_generate(mesh):
    """``generate`` over 3 windows (padded to 4 on two ranks) and
    ``inpaint`` over 3, each from a seed."""
    from diff_foley_tpu_torch.pipeline import continuation_mask

    pipe = tiny_pipeline(mesh)
    data = np.random.default_rng(20)
    feats = data.standard_normal((3 * 32 + 5, 512)).astype(np.float32)
    known = data.uniform(0.2, 0.8, (128, 3 * 512)).astype(np.float32)
    out = {"generate": pipe.generate(feats, seed=3, gen=gen_config()),
           "inpaint": pipe.inpaint(feats, known,
                                   continuation_mask(3 * 512, 700), seed=4,
                                   gen=gen_config(sampler="ddim"))}
    return out


def case_serving(mesh):
    """One request of 3 windows through a meshed engine (its bucket
    rounded up to 4 on two ranks), then the same bucketed call made
    directly: rank 0 serves, the other ranks follow."""
    from diff_foley_tpu_torch.serving import BatchingEngine, follow

    pipe = tiny_pipeline(mesh)
    gen = gen_config(sample_num=1, return_spec=False, wav_dtype="int16")
    feats = np.random.default_rng(21).standard_normal(
        (3 * 32, 512)).astype(np.float32)
    if mesh is None or mesh.rank == 0:
        engine = BatchingEngine(pipe, gen, max_batch_windows=3,
                                max_wait_ms=1.0, seed=5)
        req = engine.enqueue(feats)
        req.event.wait(300)
        engine.stop()
        if req.error:
            raise RuntimeError(req.error)
        run = [req.seed, req.bucket, engine.max_windows]
        calls = None
    else:
        calls = follow(pipe)
        run = [None, None, None]
    if mesh is not None:
        shared = [run]
        dist.broadcast_object_list(shared, src=0)
        run = shared[0]
    direct = pipe.generate(feats, run[0], gen, bucket_windows=run[1])
    return {"served": req.result if (mesh is None or mesh.rank == 0)
            else None, "direct": direct["wav"][0], "seed": run[0],
            "bucket": run[1], "max_windows": run[2], "follower_calls": calls}


def case_align_acc(mesh, root):
    """Ragged align-acc: 7 rows in batches of 3, 3 and 1."""
    from diff_foley_tpu_torch.eval.align_acc import alignment_accuracy

    clf = tclf.AlignmentClassifier(UNetConfig(**CLF_KW), 40)
    clf.load_state_dict(torch.load(root / "align_clf.pt"))
    vae = AutoencoderKL(VAEConfig(ch=32, ch_mult=(1, 2, 4, 4),
                                  num_res_blocks=1))
    vae.load_state_dict(torch.load(root / "align_vae.pt"))
    b = dict(np.load(root / "align_batches.npz"))
    stream = ({k: v[i:i + 3] for k, v in b.items()} for i in range(0, 7, 3))
    return {"acc": alignment_accuracy(stream, clf, vae, mesh=mesh,
                                      device="cpu")}


def case_clis(mesh, root):
    """The five trainer CLIs at two ranks (rank 0 writes the logdirs), a
    resume of the two-rank stage-2 logdir at two ranks, and a two-rank
    stage-2 run that one rank's SIGUSR1 checkpoints."""
    from diff_foley_tpu_torch.cli import (train_cavp, train_classifier,
                                          train_sound_vae, train_stage2,
                                          train_vae)

    cfg = json.loads((root / "clis.json").read_text())
    for name, main in (("stage2", train_stage2.main),
                       ("vae", train_vae.main),
                       ("classifier", train_classifier.main),
                       ("cavp", train_cavp.main),
                       ("sound_vae", train_sound_vae.main)):
        main(cfg[name]["ranks"])
    if mesh.rank == 0:
        shutil.copytree(root / "logs2" / "stage2",
                        root / "logs2" / "stage2_resumed")
    dist.barrier()
    train_stage2.main(cfg["stage2"]["resume"])
    # a SIGUSR1 that rank 1 alone sees, during step 2: the ranks agree on
    # it, so both join the (collective) FSDP save at step 2's boundary
    step = ts2.Stage2Trainer.train_step

    def signalled(self, state, *a, **k):
        if mesh.rank == 1 and state.step == 1:
            os.kill(os.getpid(), signal.SIGUSR1)
        return step(self, state, *a, **k)

    ts2.Stage2Trainer.train_step = signalled
    try:
        train_stage2.main(cfg["stage2"]["preempt"])
    finally:
        ts2.Stage2Trainer.train_step = step
    return {}


GROUPS = {
    "trainers": [("stage2_ddp", lambda m: case_stage2(m)),
                 ("stage2_fsdp", lambda m: case_stage2(m, True, accum=2,
                                                        steps=4)),
                 ("stage2_tp", None), ("stage2_restore", case_stage2_restore),
                 ("vae", case_vae), ("classifier", case_classifier),
                 ("cavp", case_cavp), ("cavp_towers", case_cavp_towers),
                 ("contrastive", case_contrastive),
                 ("batchnorm", case_batchnorm)],
    "composition": [("stage2_fsdp_tp", None)],
    "entries": [("generate", case_generate), ("serving", case_serving),
                ("align_acc", None), ("clis", None)],
}


def launch(out: pathlib.Path, group: str, n: int, timeout: float = 240):
    """Run ``group``'s cases on ``n`` gloo ranks (a free localhost port
    from binding port 0, one intra-op thread each) → the ranks' exit codes
    and the errors they wrote."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = str(pathlib.Path(__file__).resolve().parents[1])
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [repo] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(out), group], env=env,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
    try:
        errs = [p.communicate(timeout=timeout)[1].decode()[-4000:]
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    return [p.returncode for p in procs], errs


def main(out: pathlib.Path, group: str) -> None:
    from diff_foley_tpu_torch.parallel.distributed import init_distributed

    torch.set_num_threads(1)
    info = init_distributed("cpu")
    rank, world = info["process_index"], info["process_count"]
    for name, fn in GROUPS[group]:
        if name == "stage2_tp":        # data 1 × model 2
            result = case_stage2(make_mesh(1, world))
        elif name == "stage2_fsdp_tp":  # data 2 × model 2
            result = case_stage2(make_mesh(world // 2, 2), True)
        elif name in ("align_acc", "clis"):
            result = globals()[f"case_{name}"](make_mesh(), out)
        else:
            result = fn(make_mesh())
        if rank == 0:
            torch.save(result, out / f"{name}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    out_dir, group_name = pathlib.Path(sys.argv[1]), sys.argv[2]
    try:
        main(out_dir, group_name)
    except Exception:
        (out_dir / f"error.rank{os.environ['RANK']}.txt").write_text(
            traceback.format_exc())
        raise
