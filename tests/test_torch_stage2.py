"""The PyTorch port's stage-2 training against the JAX package's, on the
CPU: ``p_losses`` on both batch branches, two train steps (metrics, the
gradients before AdamW, the updated float32 masters, the EMA),
``accum_steps=2``, mixed precision, the learning-rate schedules,
``ema_update``, ``SpecFeatDataset`` and ``DevicePrefetcher``.

Both sides start from the same seeded weights (``random_flax_params``:
a fresh flax init zeroes the output layers, and every gradient behind
them would be zero). One jitted JAX step runs at the JAX package's tiny
stage-2 config in float32; the port takes the t, noise, keep mask and
posterior ε that JAX's key splits give (``fold_in(rng, step)`` → split →
``p_losses``' four-way split) through ``draws``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diff_foley_tpu.data import ldm_dataset as jds
from diff_foley_tpu.diffusion import latent_diffusion as jld
from diff_foley_tpu.models.unet import UNetConfig as JUNetConfig
from diff_foley_tpu.models.vae import VAEConfig as JVAEConfig
from diff_foley_tpu.train import stage2_ldm as js2
from diff_foley_tpu.utils import ema as jema
from diff_foley_tpu.utils import lr_schedules as jlr
from diff_foley_tpu_torch.data import ldm_dataset as tds
from diff_foley_tpu_torch.data import loader as tloader
from diff_foley_tpu_torch.diffusion import latent_diffusion as tld
from diff_foley_tpu_torch.models.unet import UNetConfig
from diff_foley_tpu_torch.models.vae import VAEConfig
from diff_foley_tpu_torch.train import stage2_ldm as ts2
from diff_foley_tpu_torch.utils import ema as tema
from diff_foley_tpu_torch.utils import lr_schedules as tlr
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

UNET_KW = dict(model_channels=32, num_res_blocks=1, channel_mult=(1, 2),
               attention_resolutions=(2,), num_heads=4, context_dim=24)
VAE_KW = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1)
LDM_KW = dict(cond_embed_dim=24, cond_seq_len=8)
B, LR, DECAY = 2, 1e-4, 0.99
LATENT = (B, 16, 32, 4)
STEPS = 2


def jax_ldm():
    return jld.LatentDiffusion(jld.LDMConfig(
        unet=JUNetConfig(**UNET_KW), vae=JVAEConfig(**VAE_KW), **LDM_KW))


def port_ldm(tree, vae_tree):
    ldm = tld.LatentDiffusion(tld.LDMConfig(
        unet=UNetConfig(**UNET_KW), vae=VAEConfig(**VAE_KW), **LDM_KW))
    ldm.unet.load_state_dict(from_jax_params(tree["unet"]), strict=True)
    ldm.cond.load_state_dict(from_jax_params(tree["cond"]), strict=True)
    ldm.vae.load_state_dict(from_jax_params(vae_tree), strict=True)
    return ldm


def replay_draws(rng, step, b=B, latent=LATENT, p_drop=0.2):
    """The JAX step's draws at ``step``: fold_in → split (encode, loss) →
    the loss key's four-way split (t, noise, keep, dropout)."""
    k_enc, k_loss = jax.random.split(jax.random.fold_in(rng, step))
    k_t, k_noise, k_drop, _ = jax.random.split(k_loss, 4)
    t = jax.random.randint(k_t, (b,), 0, 1000)
    noise = jax.random.normal(k_noise, latent, jnp.float32)
    keep = jax.random.uniform(k_drop, (b, 1, 1)) >= p_drop
    eps = jax.random.normal(k_enc, latent, jnp.float32)
    as_t = lambda a: torch.from_numpy(np.array(a))
    return {"t": as_t(t).long(), "noise": as_t(noise), "keep": as_t(keep),
            "eps": as_t(eps)}, k_loss


def named(tree) -> dict:
    """{"unet.*"/"cond.*": tensor} of a JAX {unet, cond} tree."""
    tree = jax.tree_util.tree_map(np.asarray, tree)
    return {f"{part}.{k}": v for part in ("unet", "cond")
            for k, v in from_jax_params(tree[part]).items()}


@pytest.fixture(scope="module")
def run():
    """Two JAX steps (one jitted function) and the port's, from the same
    state, batch and draws; p_losses on the z_mu branch at step 0."""
    ldm = jax_ldm()
    shapes = jax.eval_shape(ldm.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    random_flax_params(shapes, seed=11))
    vae_shapes = jax.eval_shape(ldm.init_vae_params, jax.random.PRNGKey(1))
    vae = jax.tree_util.tree_map(jnp.asarray,
                                 random_flax_params(vae_shapes, seed=12))
    cfg = js2.Stage2TrainConfig(base_lr=LR, warmup_steps=0, use_ema=True,
                                ema_decay=DECAY)
    tx = js2.make_optimizer(cfg)
    jstate = js2.TrainState(jnp.asarray(0, jnp.int32), params,
                            tx.init(params), jema.ema_init(params))
    data = np.random.default_rng(13)
    batches = [{"spec": data.uniform(size=(B, 32, 64, 3)).astype(np.float32),
                "video_feat": data.standard_normal((B, 8, 512)).astype(
                    np.float32)} for _ in range(2)]
    rng = jax.random.PRNGKey(3)
    jstep = jax.jit(js2.make_train_step(ldm, cfg, tx))

    # the z_mu branch: the JAX trainer's z, through a jitted p_losses
    z_mu = data.standard_normal(LATENT).astype(np.float32)
    z_sigma = data.uniform(0.1, 0.5, LATENT).astype(np.float32)
    draws0, k_loss = replay_draws(rng, 0)
    z = ldm.cfg.scale_factor * (z_mu + z_sigma * draws0["eps"].numpy())
    _, jzmu = jax.jit(ldm.p_losses)(params, jnp.asarray(z),
                                    jnp.asarray(batches[0]["video_feat"]),
                                    k_loss)

    trainer = ts2.Stage2Trainer(port_ldm(params, vae), ts2.Stage2TrainConfig(
        base_lr=LR, warmup_steps=0, use_ema=True, ema_decay=DECAY))
    state = trainer.init_train_state(None, "cpu")
    torch_batch = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}
    zmu = trainer.eval_step(state, {
        "z_mu": torch.from_numpy(z_mu), "z_sigma": torch.from_numpy(z_sigma),
        "video_feat": torch_batch(batches[0])["video_feat"]}, draws=draws0)
    before = {k: p.detach().clone() for k, p in state.params.items()}

    out = {"jmetrics": [], "metrics": [], "jmu": [], "grads": [],
           "draws": []}
    for step in range(STEPS):
        draws, _ = replay_draws(rng, step)
        jstate, m = jstep(jstate, vae, batches[0], rng)
        out["jmetrics"].append({k: float(v) for k, v in m.items()})
        out["jmu"].append(named(jstate.opt_state[0].mu))
        m = trainer.train_step(state, torch_batch(batches[0]), draws=draws)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["grads"].append({k: p.grad.clone()
                             for k, p in state.params.items()})
        out["draws"].append(draws)
    # batch 2's gradient at the initial state (the same compiled step)
    j0 = js2.TrainState(jnp.asarray(0, jnp.int32), params, tx.init(params),
                        jema.ema_init(params))
    j0, _ = jstep(j0, vae, batches[1], rng)
    return dict(out, jzmu={k: float(v) for k, v in jzmu.items()},
                zmu={k: float(v) for k, v in zmu.items()}, jstate=jstate,
                state=state, before=before, params=params, vae=vae,
                batches=[torch_batch(b) for b in batches],
                jmu_batch2=named(j0.opt_state[0].mu), rng=rng)


# Leaves whose gradient is analytically zero: the level-0 norms hold one
# channel a group (32 channels, 32 groups), so a per-channel shift in front
# of one is removed by it: the time embedding's and in_conv's bias in each
# level-0 ResBlock (before its out_norm), and the last ResBlock's output
# biases (before the UNet's out_norm). Their gradients are rounding noise
# on both sides, and Adam turns noise into steps of ±lr.
ZERO_GRAD = {f"unet.{block}.{leaf}"
             for block in ("down_0_0_res", "up_0_0_res", "up_0_1_res")
             for leaf in ("emb_dense.weight", "emb_dense.bias",
                          "in_conv.bias")} | {
    "unet.up_0_1_res.out_conv.bias", "unet.up_0_1_res.skip_conv.bias"}


def noise_leaves(grads: dict) -> set:
    """The leaves whose gradient is under 1e-5 of the largest leaf's."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if float(g.abs().max()) <= 1e-5 * top}


def grad_from_mu(mu, prev=None, b1=0.9):
    """The JAX gradient out of AdamW's first moment: m ← b1·m + (1−b1)·g."""
    return (mu - (b1 * prev if prev is not None else 0.0)) / (1 - b1)


@pytest.mark.parametrize("name", ["loss_simple", "loss_vlb", "t_mean"])
def test_p_losses_z_mu_branch_matches_jax(run, name):
    # a tiny UNet in fp32 over 2·16·32·4 latents: 1e-5 relative
    # (reached: 2.8e-7)
    ref, out = run["jzmu"][name], run["zmu"][name]
    assert np.isfinite(out) and abs(out - ref) <= 1e-5 * max(abs(ref), 1e-3)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("name", ["loss", "loss_simple", "loss_vlb",
                                  "t_mean", "grad_norm"])
def test_train_step_metrics_match_jax(run, step, name):
    # the spec branch's p_losses and the global gradient norm: fp32 sums
    # over a tiny UNet, 1e-5 relative (reached: 3.8e-7; the second step
    # from parameters one Adam step apart, as the two sides computed them)
    ref, out = run["jmetrics"][step][name], run["metrics"][step][name]
    assert np.isfinite(out) and abs(out - ref) <= 1e-5 * max(abs(ref), 1e-3)


def test_draws_cover_both_cfg_branches(run):
    keeps = torch.cat([d["keep"].flatten() for d in run["draws"]])
    assert keeps.any() and not keeps.all()


@pytest.mark.parametrize("step", range(STEPS))
def test_gradients_before_adamw_match_jax(run, step):
    # the gradients per leaf, before AdamW: every element within 1e-4 of
    # its leaf's max|g| (reached: 1.1e-5 at both steps; the second from
    # parameters one sign-like Adam step apart by rounding). The JAX
    # gradient comes out of its first moment.
    tol = 1e-4
    mu = run["jmu"][step]
    prev = run["jmu"][step - 1] if step else None
    out = run["grads"][step]
    assert set(out) == set(mu) and len(out) > 40
    refs = {k: grad_from_mu(m, prev[k] if prev else None)
            for k, m in mu.items()}
    assert noise_leaves(refs) == noise_leaves(out) == ZERO_GRAD
    worst = {}
    for k, ref in refs.items():
        assert out[k].dtype == torch.float32
        if k in ZERO_GRAD:
            continue
        scale = float(ref.abs().max())
        assert scale > 0.0, k
        worst[k] = float((out[k] - ref).abs().max()) / scale
    assert max(worst.values()) <= tol, sorted(worst.items(),
                                              key=lambda kv: -kv[1])[:3]
    assert max(worst.values()) > 0.0


def _leaves_off(out: dict, ref: dict, tol: float, steps: int):
    """Elements beyond tol·max(1, max|ref|), per leaf: Adam's first step
    is nearly lr·sign(g), so an element whose gradient lies within
    rounding of zero may step the other way; at most 2, or 1 in 10³, of a
    leaf, and none beyond 2·lr a step."""
    flipped = 0
    for k, r in ref.items():
        o = out[k].detach()
        assert o.shape == r.shape and o.dtype == torch.float32, k
        delta = (o - r).abs() / max(1.0, float(r.abs().max()))
        assert float(delta.max()) <= 2 * steps * LR * 1.01, k
        if k in ZERO_GRAD:   # noise in: held to the bound above only
            continue
        off = int((delta > tol).sum())
        assert off <= max(2, 1e-3 * delta.numel()), (k, off)
        flipped += off
    return flipped


def test_updated_masters_and_ema_match_jax(run):
    # two AdamW steps at lr 1e-4 move a leaf by at most 2e-4 (plus the
    # decay); masters and EMA within 1e-5·max(1, max|ref|) of the JAX
    # trainer's, element by element (reached: 6.5e-6), but for elements
    # whose first step took the other sign (one of 1.0 million)
    jstate, state = run["jstate"], run["state"]
    ref = named(jstate.params)
    assert _leaves_off(state.params, ref, 1e-5, STEPS) <= 5
    moved = [k for k, v in run["before"].items()
             if float((state.params[k] - v).abs().max()) > 0.5 * LR]
    assert len(moved) >= len(ref) - len(ZERO_GRAD)
    assert _leaves_off(state.ema.params, named(jstate.ema.params), 1e-5,
                       STEPS) <= 5
    assert state.ema.num_updates == int(jstate.ema.num_updates) == STEPS
    assert state.step == int(jstate.step) == STEPS
    # the schedule's and the bias corrections' count
    assert state.opt.count == int(jstate.opt_state[0].count) == STEPS
    ema_moved = max(float((state.ema.params[k] - run["before"][k]).abs()
                          .max()) for k in ref)
    assert 0.0 < ema_moved < max(float((state.params[k] - run["before"][k])
                                       .abs().max()) for k in ref)


def test_adam_moments_match_jax(run):
    # the first moment after two steps: 0.1·g₂ + 0.09·g₁, per leaf within
    # 1e-4 of its max (reached: 1.2e-5)
    mu = run["jmu"][-1]
    for k, m in zip(run["state"].params, run["state"].opt.mu):
        if k in ZERO_GRAD:
            continue
        scale = float(mu[k].abs().max())
        assert float((m - mu[k]).abs().max()) <= 1e-4 * scale, k


def test_accum_steps_two_is_one_update_with_the_mean_gradient(run):
    # MultiSteps: the first call only accumulates; the second updates
    # with the running mean of both gradients, and the EMA steps once
    # (the JAX package's accumulation test, tests/test_train_stage2.py)
    trainer = ts2.Stage2Trainer(
        port_ldm(run["params"], run["vae"]),
        ts2.Stage2TrainConfig(base_lr=LR, warmup_steps=0, use_ema=True,
                              ema_decay=DECAY, accum_steps=2))
    state = trainer.init_train_state(None, "cpu")
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    draws = run["draws"][0]
    trainer.train_step(state, run["batches"][0], draws=draws)
    assert all(torch.equal(state.params[k], p0[k]) for k in p0)
    assert state.ema.num_updates == 0 and state.opt.count == 0
    assert state.opt.mini_step == 1
    trainer.train_step(state, run["batches"][1], draws=draws)
    assert state.ema.num_updates == 1 and state.opt.count == 1
    assert state.opt.mini_step == 0 and state.step == 2
    # mu after one update is 0.1·mean(g₁, g₂): against the JAX gradients
    # of both batches at the initial state, 1e-4 of each leaf's max
    # (reached: 8.6e-6)
    for k, m in zip(state.params, state.opt.mu):
        if k in ZERO_GRAD:
            continue
        ref = 0.5 * (run["jmu"][0][k] + run["jmu_batch2"][k])
        assert float((m - ref).abs().max()) <= 1e-4 * float(
            ref.abs().max()), k
    # the update is AdamW's first step with that gradient:
    # p − lr·(g/(|g| + ε) + wd·p), within 1e-5 (reached: 9.6e-8, no
    # element off)
    expect = {}
    for k, m in zip(state.params, state.opt.mu):
        g = 10.0 * m
        expect[k] = p0[k] - LR * (g / (g.abs() + 1e-8) + 0.01 * p0[k])
    assert _leaves_off(state.params, expect, 1e-5, 1) <= 2
    assert all(torch.equal(state.opt.acc[i], torch.zeros_like(a))
               for i, a in enumerate(state.opt.acc))


def test_mixed_precision_keeps_float32_masters(run):
    # bf16 compute on fp32 masters: the gradients land on the fp32
    # leaves, the masters and the second moment stay fp32, mu_dtype
    # bfloat16 gives a bf16 first moment, and the loss stays within 0.5%
    # of the fp32 loss (bf16 rounding of a tiny UNet, same draws; reached:
    # 0.05%)
    ldm = port_ldm(run["params"], run["vae"])
    trainer = ts2.Stage2Trainer(ldm, ts2.Stage2TrainConfig(
        base_lr=LR, warmup_steps=0, use_ema=True,
        compute_dtype="bfloat16", mu_dtype="bfloat16"))
    state = trainer.init_train_state(None, "cpu")
    p0 = {k: p.detach().clone() for k, p in state.params.items()}
    m = trainer.train_step(state, run["batches"][0], draws=run["draws"][0])
    assert ldm.unet.cfg.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in ldm.vae.parameters())
    ref = run["jmetrics"][0]["loss"]
    assert abs(float(m["loss"]) - ref) <= 0.005 * ref
    own = dict(ldm.named_parameters())
    for k, p in state.params.items():
        assert own[k] is p and p.dtype == torch.float32, k
        assert p.grad is not None and p.grad.dtype == torch.float32, k
        assert float(p.grad.abs().max()) > 0.0, k
        assert not torch.equal(p, p0[k]), k
    assert {m.dtype for m in state.opt.mu} == {torch.bfloat16}
    assert {v.dtype for v in state.opt.nu} == {torch.float32}
    assert {e.dtype for e in state.ema.params.values()} == {torch.float32}
    # the bf16 gradient is the fp32 one to within bf16's rounding: 0.1 of
    # each leaf's max (reached: 0.049)
    g32 = run["grads"][0]
    for k, p in state.params.items():
        if k in ZERO_GRAD:
            continue
        scale = float(g32[k].abs().max())
        assert float((p.grad - g32[k]).abs().max()) <= 0.1 * scale, k


STEPS_AT = [0, 1, 5, 99, 100, 101, 999, 1000, 1001, 5000, 10**6]


@pytest.mark.parametrize("name,kw", [
    ("lambda_linear", dict(base_lr=1e-4, warm_up_steps=1000)),
    ("lambda_linear", dict(base_lr=2e-4, warm_up_steps=100, f_start=0.1,
                           f_max=1.0, f_min=0.5, cycle_length=5000)),
    ("const_lr", dict(base_lr=3e-4, warmup_steps=100)),
    ("const_lr_cooldown", dict(base_lr=3e-4, warmup_steps=100,
                               total_steps=5000, cooldown_steps=1000,
                               cooldown_power=2.0, cooldown_end_lr=1e-5)),
    ("lambda_warmup_cosine", dict(base_lr=1e-3, warm_up_steps=100,
                                  lr_min=0.1, lr_max=1.0, lr_start=0.01,
                                  max_decay_steps=5000)),
    ("cosine_with_warmup", dict(base_lr=5e-4, warmup_steps=100,
                                total_steps=5000)),
])
def test_lr_schedules_match_jax(name, kw):
    # float32 on the JAX side, float64 here: 1e-6 relative
    ours, ref = getattr(tlr, name)(**kw), getattr(jlr, name)(**kw)
    for s in STEPS_AT:
        r = float(ref(jnp.asarray(s, jnp.int32)))
        assert isinstance(ours(s), float)
        assert abs(ours(s) - r) <= 1e-6 * max(abs(r), 1e-12), (s, ours(s), r)


def test_ema_update_matches_jax():
    # three updates of a numpy tree (fp32 and fp16 leaves): the decay's
    # warmup (1+n)/(10+n), then the cap; each leaf keeps its dtype
    rng = np.random.default_rng(17)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float16)}
    jstate = jema.ema_init(jax.tree_util.tree_map(jnp.asarray, tree))
    state = tema.ema_init({k: torch.from_numpy(v) for k, v in tree.items()})
    assert all(state.params[k].data_ptr() != 0 for k in tree)
    for i, decay in enumerate((0.9999, 0.9999, 0.2)):
        new = {k: (v + rng.standard_normal(v.shape)).astype(v.dtype)
               for k, v in tree.items()}
        jstate = jema.ema_update(
            jstate, jax.tree_util.tree_map(jnp.asarray, new), decay)
        tema.ema_update(state, {k: torch.from_numpy(v)
                                for k, v in new.items()}, decay)
    assert state.num_updates == int(jstate.num_updates) == 3
    for k in tree:
        ref = np.asarray(jstate.params[k])
        out = state.params[k].numpy()
        assert out.dtype == ref.dtype == tree[k].dtype
        np.testing.assert_allclose(out.astype(np.float64), ref, rtol=0,
                                   atol=1e-6 if k == "a" else 2e-3)


def test_ema_init_copies():
    p = {"w": torch.ones(3)}
    state = tema.ema_init(p)
    p["w"].add_(1.0)
    assert torch.equal(state.params["w"], torch.ones(3))


def _write_pairs(root, rng, split="Train", n=4):
    (root / split / "audio_npy_spec").mkdir(parents=True)
    (root / "CAVP_feat" / split).mkdir(parents=True)
    ids = [f"vid{i}" for i in range(n)]
    (root / f"{split}.txt").write_text("\n".join(ids) + "\n")
    for i, name in enumerate(ids):
        np.save(root / split / "audio_npy_spec" / f"{name}_mel.npy",
                rng.uniform(size=(128, 300 + 170 * i)).astype(np.float32))
        np.savez(root / "CAVP_feat" / split / f"{name}.npz",
                 feat=rng.standard_normal((20 + 9 * i, 512)).astype(
                     np.float32))


@pytest.mark.parametrize("kw", [dict(), dict(alignment_labels=True),
                                dict(tile_channels=False)])
def test_spec_feat_dataset_equals_jax_bit_for_bit(tmp_path, kw):
    _write_pairs(tmp_path, np.random.default_rng(19))
    labels = kw.pop("alignment_labels", False)
    make = lambda mod: mod.SpecFeatDataset.from_split_file(
        str(tmp_path), "train", mod.LDMDataConfig(**kw),
        alignment_labels=labels, seed=7)
    td, jd = make(tds), make(jds)
    assert td.spec_paths == jd.spec_paths and td.feat_paths == jd.feat_paths
    branches = set()
    for epoch in (0, 1, 2):
        td.set_epoch(epoch)
        jd.set_epoch(epoch)
        for i in range(len(td)):
            a, b = td[i], jd[i]
            assert set(a) == set(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
            rng = np.random.default_rng(np.random.SeedSequence([7, epoch, i]))
            branches.add(float(rng.uniform()) < 0.5)
            spec_shape = (128, 512, 3) if kw.get("tile_channels", True) \
                else (128, 512)
            assert a["spec"].shape == spec_shape
            assert a["video_feat"].shape == (32, 512)
    assert branches == {True, False}   # both the mix and the single crop


def test_device_prefetcher_on_cpu_orders_casts_and_raises():
    batches = [{"x": np.full((2, 3), i, np.float32),
                "n": np.arange(2, dtype=np.int32) + i} for i in range(5)]
    got = list(tloader.DevicePrefetcher(iter(batches), device="cpu",
                                        cast_dtype=torch.bfloat16))
    assert [int(b["x"][0, 0]) for b in got] == list(range(5))
    assert all(b["x"].dtype == torch.bfloat16 and b["n"].dtype == torch.int32
               for b in got)
    plain = next(iter(tloader.DevicePrefetcher(iter(batches), device="cpu")))
    assert plain["x"].dtype == torch.float32

    def failing():
        yield batches[0]
        raise ValueError("bad item")

    it = iter(tloader.DevicePrefetcher(failing(), device="cpu"))
    assert int(next(it)["x"][0, 0]) == 0
    with pytest.raises(RuntimeError, match="prefetch failed") as e:
        next(it)
    assert isinstance(e.value.__cause__, ValueError)
    # a consumer that stops early releases the feeder
    endless = ({"x": np.zeros(1, np.float32)} for _ in iter(int, 1))
    for i, _ in enumerate(tloader.DevicePrefetcher(endless, device="cpu")):
        if i == 3:
            break
