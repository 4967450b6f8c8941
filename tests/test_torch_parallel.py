"""The port's parallelism on the CPU: the sharding rules against the JAX
package's, leaf for leaf; then two gloo ranks against the one-process port
(which tests/test_torch_{stage2,vae_train,classifier,stage1}.py hold
against JAX) for the stage-2 DDP, FSDP (accumulated) and TP steps, an FSDP
checkpoint restored at one and at two ranks, the VAE step with the
cross-rank PatchGAN BatchNorm, the classifier step, the CAVP step (float64,
plain and accumulated) with the gathered contrastive loss and cross-rank
BatchNorm, and the two building blocks alone; four ranks (data 2 × model 2)
for FSDP × TP.

The ranks run ``tests/test_torch_parallel_ranks.py``, launched once per
group for the whole file; every case there is a function of the mesh, run here
with ``None`` for the one-process result. Limits: losses and metrics
within 1e-5; gradients per leaf before the optimizer within 1e-5 of the
leaf's rms (float64), in the fp32 trainers of the leaf's max|g| (the
batch split changes the fp32 summation order: up to 1.7e-5 of rms, 5.4e-6
of max in stage 2, 1.05e-5 of rms in the VAE's first conv), a leaf
under 1e-5 of the largest leaf's max|g| being analytically zero (rounding
noise, as tests/test_torch_stage2.py picks them out) and held to 1e-5 of
that max; BatchNorm statistics within 1e-6. Adam's first step is ≈
lr·sign(g): after it the parameters, and so the gradients, of two runs
differ at the elements whose gradient is within rounding of zero, so
only calls before the first update compare gradients.
"""
import datetime
import importlib.util
import os
import pathlib
import socket

import jax
import numpy as np
import pytest
import torch

from diff_foley_tpu_torch.parallel import distributed as tdist
from diff_foley_tpu_torch.parallel import sharding_rules as rules
from diff_foley_tpu_torch.parallel.mesh import Mesh
from diff_foley_tpu_torch.utils.convert import from_jax_params

HERE = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "torch_parallel_ranks", HERE / "test_torch_parallel_ranks.py")
ranks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks)

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)


def _launch(tmp_path_factory, group, n):
    out = tmp_path_factory.mktemp(f"{group}{n}")
    rcs, errs = ranks.launch(out, group, n)
    assert rcs == [0] * n, "\n".join(
        (out / f"error.rank{r}.txt").read_text()
        if (out / f"error.rank{r}.txt").exists() else errs[r]
        for r in range(n))
    return lambda name: torch.load(out / f"{name}.pt", weights_only=False)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _launch(tmp_path_factory, "trainers", 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _launch(tmp_path_factory, "composition", 4)


@pytest.fixture(scope="module")
def one_stage2():
    return ranks.case_stage2(None)


def close_metrics(got: dict, ref: dict, tol=1e-5):
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= tol * max(1.0, abs(ref[k])), \
            (k, got[k], ref[k])


def close_leaves(got: dict, ref: dict, tol=1e-5, scale="rms"):
    assert set(got) == set(ref)
    top = max(float(np.abs(r).max()) for r in ref.values())
    for k, r in ref.items():
        assert got[k].shape == r.shape, k
        size = (float(np.sqrt(np.mean(np.square(r)))) if scale == "rms"
                else float(np.abs(r).max()))
        if float(np.abs(r).max()) <= 1e-5 * top:   # analytically zero
            size = top
        err = float(np.abs(got[k] - r).max())
        assert err <= tol * max(size, 1e-30), (k, err, size)


# ---- the rules, against JAX ----------------------------------------------

def _jax_tiny_ldm_params():
    from diff_foley_tpu.diffusion import latent_diffusion as jld
    from diff_foley_tpu.models.unet import UNetConfig as JUNetConfig
    from diff_foley_tpu.models.vae import VAEConfig as JVAEConfig

    ldm = jld.LatentDiffusion(jld.LDMConfig(
        unet=JUNetConfig(**ranks.UNET_KW), vae=JVAEConfig(**ranks.VAE_KW),
        cond_embed_dim=24, cond_seq_len=8))
    shapes = jax.eval_shape(ldm.init_params, jax.random.PRNGKey(0))
    return {part: jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes[part]["params"])
        for part in ("unet", "cond")}


def _jax_specs(tree, spec_tree) -> dict:
    """{port name: the flax-layout spec as a tuple} of a JAX spec tree:
    each leaf is tagged with its index and converted by the port's own
    converter, whose names are the port's."""
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    tags = jax.tree_util.tree_unflatten(treedef, [
        np.full(np.shape(l), i, np.float32) for i, l in enumerate(leaves)])
    specs = jax.tree_util.tree_leaves(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))
    out = {}
    for part in ("unet", "cond"):
        for k, t in from_jax_params(tags[part]).items():
            i = int(t.reshape(-1)[0])
            spec = tuple(specs[i].spec)
            out[f"{part}.{k}"] = spec + (None,) * (np.ndim(leaves[i])
                                                  - len(spec))
    return out


@pytest.mark.parametrize("tp", [False, True])
def test_fsdp_and_tp_rules_match_jax_leaf_for_leaf(eight_devices, tp):
    # data 4 × model 2 on the 8 emulated devices: which leaves the JAX
    # rules split, and on which flax-layout dim, for every leaf of a tiny
    # LDM (``fsdp_shardings`` alone as the CLI's --fsdp, and composed with
    # ``param_shardings`` as the JAX dry run composes them)
    from diff_foley_tpu.parallel import mesh as jmesh
    from diff_foley_tpu.parallel import sharding_rules as jrules
    from diff_foley_tpu_torch.diffusion.latent_diffusion import (
        LatentDiffusion, LDMConfig)
    from diff_foley_tpu_torch.models.unet import UNetConfig
    from diff_foley_tpu_torch.models.vae import VAEConfig

    tree = _jax_tiny_ldm_params()
    mesh = jmesh.make_mesh(4, 2, devices=eight_devices)
    base = jrules.param_shardings(tree, mesh) if tp else None
    for min_size in (rules.FSDP_MIN_SIZE, ranks.FSDP_MIN):
        expect = _jax_specs(tree, jrules.fsdp_shardings(
            tree, mesh, min_size=min_size, base_specs=base))
        port = LatentDiffusion(LDMConfig(
            unet=UNetConfig(**ranks.UNET_KW), vae=VAEConfig(**ranks.VAE_KW),
            cond_embed_dim=24, cond_seq_len=8))
        shapes = {k: p.shape for k, p in port.named_parameters()
                  if k.startswith(("unet.", "cond."))}
        got = rules.param_specs(shapes, 4, tp=tp, fsdp=True,
                                min_size=min_size)
        assert set(got) == set(expect)
        assert {k: s.flax for k, s in got.items()} == expect
        split = [k for k, s in got.items() if s.fsdp_dim is not None]
        assert split and (not tp or any(s.tp_dim is not None
                                        for s in got.values()))
    # a square Dense, where the torch layout would break the tie the other
    # way: the data axis lands on the flax (in, out) kernel's out dim,
    # torch dim 0
    sq = got["unet.down_1_0_attn.block0.attn1.to_out.weight"]
    assert sq.flax == (("model", "data") if tp else (None, "data"))
    assert sq.fsdp_dim == 0 and sq.tp_dim == (1 if tp else None)


def test_fsdp_splits_masters_moments_and_ema_alike():
    # the trainer's FSDP state on data 4 (a rank's view; no collective
    # runs in init): AdamW's μ and ν and the EMA take the masters' parts,
    # which are the JAX rule's split of the whole tensors
    trainer, state = ranks.stage2_trainer(
        Mesh({"data": 4, "model": 1}, 1, 1, 0), fsdp=True)
    specs = trainer.specs
    for i, (k, p) in enumerate(state.params.items()):
        whole = list(trainer.full[k].shape)
        d = specs[k].fsdp_dim
        if d is not None:
            whole[d] //= 4
        assert list(p.shape) == whole, k
        for t in (state.opt.mu[i], state.opt.nu[i], state.ema.params[k]):
            assert t.shape == p.shape, k
    assert sum(s.fsdp_dim is not None for s in specs.values()) > 10


# ---- two ranks against one process ----------------------------------------

def close_stage2(got: dict, ref: dict, before_update: int = 1):
    """Every call's metrics and the EMA evaluation; the gradients of the
    calls before AdamW's first update."""
    assert len(got["metrics"]) == len(ref["metrics"])
    for g, r in zip(got["metrics"], ref["metrics"]):
        close_metrics(g, r)
    for g, r in list(zip(got["grads"], ref["grads"]))[:before_update]:
        close_leaves(g, r, scale="max")
    close_metrics(got["eval"], ref["eval"])


def test_stage2_ddp_two_ranks_equal_one_process(two, one_stage2):
    close_stage2(two("stage2_ddp"), one_stage2)


def test_stage2_fsdp_accumulated_two_ranks_equal_one_process(two):
    # K = 2: AdamW moves at calls 2 and 4, each rank's gradients reduced
    # at every call; grad_norm is the norm of the parts' squares summed
    ref = ranks.case_stage2(None, accum=2, steps=4)
    got = two("stage2_fsdp")
    close_stage2(got, ref, before_update=2)
    assert got["state"]["opt"]["count"] == ref["state"]["opt"]["count"] == 2
    assert got["state"]["ema"]["num_updates"] == 2
    for k, r in ref["state"]["params"].items():
        assert got["state"]["params"][k].shape == r.shape, k


def test_stage2_tp_two_ranks_equal_one_process(two, one_stage2):
    # data 1 × model 2: the attention at 2 heads a rank, the feed-forward
    # and the time embedding split by the JAX rules
    close_stage2(two("stage2_tp"), one_stage2)


def test_stage2_fsdp_tp_four_ranks_equal_one_process(four, one_stage2):
    close_stage2(four("stage2_fsdp_tp"), one_stage2)


def test_fsdp_checkpoint_restores_at_one_and_two_ranks(two):
    got = two("stage2_restore")
    saved, reloaded = got["saved"], got["reloaded"]
    flat = lambda sd: {**{f"p.{k}": v for k, v in sd["params"].items()},
                       **{f"mu.{i}": v for i, v in
                          enumerate(sd["opt"]["mu"])},
                       **{f"nu.{i}": v for i, v in
                          enumerate(sd["opt"]["nu"])},
                       **{f"ema.{k}": v for k, v in
                          sd["ema"]["params"].items()}}
    # two ranks: the parts cut from the whole state join back bit for bit
    assert all(torch.equal(flat(reloaded)[k], v)
               for k, v in flat(saved).items())
    # one rank: the whole state loads, and its next step is the ranks'
    trainer, state = ranks.stage2_trainer(None, fsdp=True)
    trainer.load_state_dict(state, saved)
    assert all(torch.equal(flat(trainer.state_dict(state))[k], v)
               for k, v in flat(saved).items())
    # the generator as the ranks left it after step 0's draws
    gen = torch.Generator().manual_seed(6)
    first, first_state = ranks.stage2_trainer(None, fsdp=True)
    first.train_step(first_state, ranks.stage2_batch(0), gen)
    m = trainer.train_step(state, ranks.stage2_batch(1), gen)
    close_metrics({k: float(v) for k, v in m.items()}, got["metrics"])


def test_vae_two_ranks_cross_rank_batchnorm(two):
    got, ref = two("vae"), ranks.case_vae(None)
    for g, r in zip(got["metrics"], ref["metrics"]):
        close_metrics(g, r)
    # step 1's gradients and the statistics its discriminator forwards
    # took, both before any update (step 2's follow updated parameters)
    close_leaves(got["grads"], ref["grads"], scale="max")
    for k, r in ref["stats0"].items():
        np.testing.assert_allclose(got["stats0"][k], r, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_classifier_two_ranks_equal_one_process(two):
    got, ref = two("classifier"), ranks.case_classifier(None)
    close_metrics(got["metrics"], ref["metrics"])
    close_leaves(got["grads"], ref["grads"], scale="max")


@pytest.fixture(scope="module")
def one_cavp():
    return ranks.case_cavp(None)


@pytest.mark.parametrize("kind", ["step", "accum"])
def test_cavp_two_ranks_float64_equal_one_process(two, one_cavp, kind):
    # float64 towers on both sides (fp32 ReLU kinks would split them),
    # dropout on in the plain step; the accumulated step gathers every
    # micro-batch's features in rank order
    got, ref = two("cavp")[kind], one_cavp[kind]
    close_metrics(got["metrics"], ref["metrics"])
    close_leaves(got["grads"], ref["grads"])
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_cavp_towers_two_ranks_float64_equal_one_process(two):
    # the other towers (i3d × resnet50, tiny): their BatchNorms take the
    # two ranks' statistics and the loss every rank's features
    got, ref = two("cavp_towers"), ranks.case_cavp_towers(None)
    close_metrics(got["metrics"], ref["metrics"])
    close_leaves(got["grads"], ref["grads"])
    assert ref["stats"]
    for k, r in ref["stats"].items():
        np.testing.assert_allclose(got["stats"][k], r, rtol=1e-6, atol=1e-6,
                                   err_msg=k)


def test_gathered_contrastive_loss_matches_jax_global_batch(two):
    # every rank computes the global loss; its feature gradients are the
    # data degree × its rows' share (the grad_mean_ convention), so the
    # joined gradients over 2 are JAX's gradient of the global-batch loss
    import jax.numpy as jnp

    from diff_foley_tpu.train import losses as jlosses

    got = two("contrastive")
    v, s = (jnp.asarray(f, jnp.float32) for f in ranks.contrastive_inputs())
    scale = jnp.float32(1 / 0.07)
    fns = {"clip": jlosses.clip_loss,
           "intra": lambda a, b, c: jlosses.intra_contrast_loss(
               a, b, c, clip_num=ranks.CLIP)["total_loss"]}
    for name, fn in fns.items():
        loss, (gv, gs, gc) = jax.value_and_grad(fn, argnums=(0, 1, 2))(
            v, s, scale)
        assert got[name]["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert got[name]["scale_grad"] == pytest.approx(float(gc), rel=1e-4,
                                                        abs=1e-6)
        close_leaves({"v": got[name]["v_grad"], "s": got[name]["s_grad"]},
                     {"v": np.asarray(gv, np.float64),
                      "s": np.asarray(gs, np.float64)}, tol=1e-4)
    ref = ranks.case_contrastive(None)
    for name in fns:
        close_metrics({k: got[name][k] for k in ("loss", "scale_grad")},
                      {k: ref[name][k] for k in ("loss", "scale_grad")},
                      tol=1e-12)
        close_leaves({k: got[name][k] for k in ("v_grad", "s_grad")},
                     {k: ref[name][k] for k in ("v_grad", "s_grad")},
                     tol=1e-12)


@pytest.mark.parametrize("kind", ["cavp", "patchgan"])
def test_cross_rank_batchnorm_equals_the_global_batch(two, kind):
    got, ref = two("batchnorm")[kind], ranks.case_batchnorm(None)[kind]
    close_leaves({k: got[k] for k in ("y", "x_grad", "w_grad", "b_grad")},
                 {k: ref[k] for k in ("y", "x_grad", "w_grad", "b_grad")})
    for k in ("mean", "var"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)


def test_init_distributed_alone_and_without_its_peer(monkeypatch):
    # no environment: a process alone, no group; an environment that names
    # a group that cannot form (rank 1 of 2, nobody at the address) raises
    for var in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "SLURM_PROCID"):
        monkeypatch.delenv(var, raising=False)
    info = tdist.init_distributed("cpu")
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert not torch.distributed.is_initialized() and tdist.is_master()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(port))
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError):
        tdist.init_distributed("cpu", timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tdist.init_distributed()


def test_meshed_serving_failure_is_raised_not_hidden(monkeypatch):
    # a follower re-raises a failed announced call; rank 0's engine reports
    # its failure, then refuses later calls without another collective
    from types import SimpleNamespace

    from diff_foley_tpu_torch import serving
    from diff_foley_tpu_torch.pipeline import WINDOW_FEATS

    class Failing:
        mesh = SimpleNamespace(shape={"data": 2, "model": 1})

        def generate(self, *args):
            raise ValueError("out of memory on this rank")

    incoming = iter([("generate", ()), None])
    monkeypatch.setattr(serving.dist, "broadcast_object_list",
                        lambda msg, src: msg.__setitem__(0, next(incoming)))
    monkeypatch.setattr(serving.dist, "get_rank", lambda: 1)
    with pytest.raises(RuntimeError, match="call 1 .generate. failed") as e:
        serving.follow(Failing())
    assert isinstance(e.value.__cause__, ValueError)

    sent = []
    monkeypatch.setattr(serving.dist, "broadcast_object_list",
                        lambda msg, src: sent.append(msg[0]))
    engine = serving.BatchingEngine(Failing(), max_wait_ms=1.0)
    feats = np.zeros((WINDOW_FEATS, 512), np.float32)
    errors = []
    for _ in range(2):
        req = engine.enqueue(feats)
        assert req.event.wait(10)
        errors.append(req.error)
    engine.stop()
    assert "out of memory on this rank" in errors[0]
    assert "stopped after a failed call" in errors[1]
    assert [m[0] for m in sent] == ["generate"]   # no later collective
