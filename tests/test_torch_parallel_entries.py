"""The port's meshed entries on the CPU, two gloo ranks against the
one-process port: the five trainer CLIs (rank 0 writing the logdirs; a
stage-2 ``--fsdp`` checkpoint written at two ranks resumed at two and at
one), ragged align-acc against the JAX package's 2-device mesh,
``generate``/``inpaint``, and a served batch replayed against a meshed
direct ``generate``; the loaders' per-rank splits.

The ranks run ``tests/test_torch_parallel_ranks.py`` (group "entries"),
launched once for the file; the inputs they read (the CLIs' data and
arguments, align-acc's weights and batches) are written here first. Each
CLI's data holds one global batch, so that its rows at two ranks are the
one-process batch's. Limits: metrics within 1e-5; specs within 1e-5
(reached: 7.4e-6); waveforms within 1e-4 of their peak: Griffin-Lim
amplifies the specs' rounding (a rank samples 4 rows where one process
samples 6), 2.9e-5 of the peak at worst.
"""
import importlib.util
import json
import os
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from diff_foley_tpu_torch.cli import (train_cavp, train_classifier,
                                      train_sound_vae, train_stage2,
                                      train_vae)
from diff_foley_tpu_torch.data import cavp_shards
from diff_foley_tpu_torch.data.ldm_dataset import (LDMDataConfig,
                                                   SpecFeatDataset)
from diff_foley_tpu_torch.data.loader import PrefetchLoader
from diff_foley_tpu_torch.utils.convert import from_jax_params
from diff_foley_tpu_torch.utils.init import random_flax_params
from test_torch_stage1 import write_shards
from test_torch_stage2_cli import write_pairs

HERE = pathlib.Path(__file__).resolve().parent
_spec = importlib.util.spec_from_file_location(
    "torch_parallel_ranks", HERE / "test_torch_parallel_ranks.py")
ranks = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ranks)

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per xdist worker: six workers of eight threads
    # each on eight cores spin against one another
    torch.set_num_threads(1)

ALIGN_VAE_KW = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1)
SMALL = ["--device", "cpu", "--log-every", "1", "--data-duration", "1.0",
         "--data-truncate", "8192"]


def _cli_args(root: pathlib.Path, logs: str, batch: int) -> dict:
    """Each CLI's arguments at ``batch`` rows a process (2 at two ranks,
    4 alone), logging into ``root/logs``."""
    log = lambda name: ["--logdir", str(root / logs / name)]
    stage2 = (["--data-dir", str(root / "pairs"), "--tiny",
               "--batch-size", str(batch), "--warmup-steps", "0",
               "--use-ema"] + SMALL + log("stage2"))
    return {
        "stage2": stage2 + ["--max-steps", "2"],
        "vae": (["--spec-dir", str(root / "specs"), "--tiny",
                 "--batch-size", str(batch // 2), "--max-steps", "2",
                 "--disc-start", "0"] + SMALL + log("vae")),
        "classifier": (["--data-dir", str(root / "pairs"), "--tiny",
                        "--batch-size", str(batch), "--max-steps", "2"]
                       + SMALL + log("classifier")),
        "cavp": (["--train-shards", str(root / "shards" / "shard-*.tar"),
                  "--tiny", "--device", "cpu", "--batch-size",
                  str(batch), "--clip-num", "2", "--epochs", "1",
                  "--steps-per-epoch", "1", "--log-every", "1",
                  "--warmup", "1"] + log("cavp")),
        # the shortest crop the default STFT losses take
        "sound_vae": (["--wav-dir", str(root / "wavs"), "--device", "cpu",
                       "--window", "36864", "--batch-size", str(batch // 2),
                       "--steps", "2", "--channels", "4", "--z-channels",
                       "8", "--disc-start", "0", "--log-every", "1"]
                      + log("sound_vae")),
        "stage2_resume": stage2 + ["--max-steps", "3", "--resume"],
    }


def _align_inputs(root: pathlib.Path) -> dict:
    """The JAX classifier and VAE (seeded weights) and 7 ragged rows;
    the port's state dicts of the same weights."""
    from diff_foley_tpu.models.unet import UNetConfig as JUNetConfig
    from diff_foley_tpu.models.vae import AutoencoderKL as JAutoencoderKL
    from diff_foley_tpu.models.vae import VAEConfig as JVAEConfig
    from diff_foley_tpu.train import classifier as jclf

    jtrainer = jclf.ClassifierTrainer(
        backbone_cfg=JUNetConfig(**ranks.CLF_KW),
        vae=JAutoencoderKL(JVAEConfig(**ALIGN_VAE_KW)), cond_seq_len=40)
    shapes = jax.eval_shape(jtrainer.init_params, jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    random_flax_params(shapes, seed=31))
    vae_shapes = jax.eval_shape(lambda k: jtrainer.vae.init(
        k, jnp.zeros((1, 64, 128, 3))), jax.random.PRNGKey(1))
    vae = jax.tree_util.tree_map(jnp.asarray,
                                 random_flax_params(vae_shapes, seed=32))
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    torch.save({f"{part}.{k}": v for part in ("backbone", "cond")
                for k, v in from_jax_params(np_tree(params)[part]).items()},
               root / "align_clf.pt")
    torch.save(from_jax_params(np_tree(vae)), root / "align_vae.pt")
    data = np.random.default_rng(33)
    batches = {"spec": data.uniform(size=(7, 64, 128, 3)).astype(np.float32),
               "video_feat": data.standard_normal((7, 32, 512)).astype(
                   np.float32)}
    np.savez(root / "align_batches.npz", **batches)
    return dict(jtrainer=jtrainer, params=params, vae=vae, batches=batches)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("entries")
    write_pairs(root / "pairs", n=4, frames=40, feats=3)
    (root / "specs").mkdir()
    rng = np.random.default_rng(34)
    for i in range(2):
        np.save(root / "specs" / f"c{i}.npy",
                rng.uniform(size=(128, 40)).astype(np.float32))
    (root / "shards").mkdir()
    write_shards(root / "shards", n_shards=2, per_shard=2)   # 2 a rank
    (root / "wavs").mkdir()
    for i, amp in enumerate((300, 3000, 9000)):   # rows far apart
        wavfile.write(str(root / "wavs" / f"w{i}.wav"), 16000, np.clip(
            rng.normal(size=40000) * amp, -32768, 32767).astype(np.int16))
    two = _cli_args(root, "logs2", 2)
    (root / "clis.json").write_text(json.dumps({
        name: {"ranks": two[name]} for name in
        ("stage2", "vae", "classifier", "cavp", "sound_vae")} | {
        "stage2": {"ranks": two["stage2"] + ["--fsdp"],
                   "resume": [a.replace(str(root / "logs2" / "stage2"),
                                        str(root / "logs2" /
                                            "stage2_resumed"))
                              for a in two["stage2_resume"]] + ["--fsdp"],
                   "preempt": [a.replace(str(root / "logs2" / "stage2"),
                                         str(root / "logs2" /
                                             "stage2_preempt"))
                               for a in two["stage2_resume"]
                               if a != "--resume"] + ["--fsdp"]}}))
    align = _align_inputs(root)
    rcs, errs = ranks.launch(root, "entries", 2)
    assert rcs == [0, 0], "\n".join(
        (root / f"error.rank{r}.txt").read_text()
        if (root / f"error.rank{r}.txt").exists() else errs[r]
        for r in range(2))
    load = lambda name: torch.load(root / f"{name}.pt", weights_only=False)
    return dict(root=root, load=load, align=align)


def rows(logdir: pathlib.Path) -> list:
    # the wall-clock columns differ from run to run
    return [{k: v for k, v in json.loads(line).items()
             if k not in ("step_s", "time")}
            for line in (logdir / "metrics.jsonl").read_text().splitlines()]


def close_rows(got: list, ref: list, tol=1e-5):
    assert len(got) == len(ref) and got
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert abs(g[k] - r[k]) <= tol * max(1.0, abs(r[k])), \
                (k, g[k], r[k])


@pytest.mark.parametrize("name", ["stage2", "vae", "classifier",
                                  "sound_vae"])
def test_trainer_clis_two_ranks_equal_one_process(run, name):
    # one process at twice the batch a process takes at two ranks; the
    # two-rank stage-2 run splits its state (--fsdp), the one-process run
    # does not. The waveform VAE's mel L2 term is a root of the global
    # batch's mean: the ranks' roots of their own means miss
    # freq_domain_loss by 7.3e-4 here (the rows differ in loudness)
    root = run["root"]
    one = _cli_args(root, "logs1", 4)
    main = {"stage2": train_stage2.main, "vae": train_vae.main,
            "classifier": train_classifier.main,
            "sound_vae": train_sound_vae.main}[name]
    main(one[name])
    close_rows(rows(root / "logs2" / name), rows(root / "logs1" / name))
    ckpts = sorted(os.listdir(root / "logs2" / name / "ckpt"))
    assert ckpts == sorted(os.listdir(root / "logs1" / name / "ckpt"))


def test_cavp_cli_two_ranks_equal_the_global_batch(run):
    # each rank reads its shard; the step is the one-process step on the
    # two ranks' samples in rank order (the CLI's model, config and seeds)
    from diff_foley_tpu_torch.models.cavp import CAVPConfig, CAVPModel
    from diff_foley_tpu_torch.train.stage1_cavp import (Stage1TrainConfig,
                                                        Stage1Trainer)

    root = run["root"]
    args = train_cavp.parse_args(_cli_args(root, "logs2", 2)["cavp"])
    scfg = cavp_shards.CAVPShardConfig(clip_num=2)
    shards = train_cavp.expand_braces(args.train_shards)
    samples = [s for r in range(2) for s in list(cavp_shards.iter_shards(
        shards, seed=args.seed, epoch=0, cfg=scfg, process_index=r,
        process_count=2))[:args.batch_size]]
    batch = {k: torch.from_numpy(np.stack([s[k] for s in samples]))
             for k in ("video", "spec")}
    model = CAVPModel(CAVPConfig(
        embed_dim=args.embed_dim, video_stage_blocks=(1, 1, 1, 1),
        video_base_channels=16, spec_channels=(8, 8, 8, 8, 8, 8)))
    trainer = Stage1Trainer(model, Stage1TrainConfig(
        lr=args.lr, warmup_steps=args.warmup, clip_num=2,
        intra_weight=args.intra_weight))
    state = trainer.init_train_state(args.seed, "cpu")
    m = trainer.train_step(state, batch,
                           torch.Generator().manual_seed(args.seed + 1))
    got = rows(root / "logs2" / "cavp")
    assert [r["step"] for r in got] == [1]
    close_rows([{k: v for k, v in got[0].items() if k != "step"}],
               [{f"train/{k}": float(v) for k, v in m.items()}])


def test_fsdp_checkpoint_of_two_ranks_resumes_at_two_and_at_one(run):
    # step 3 from the two-rank step-2 checkpoint (whole tensors at any
    # world size): resumed at two ranks with --fsdp, and at one rank
    # (the state not split at all), from one state to one result
    root = run["root"]
    shutil.copytree(root / "logs2" / "stage2", root / "logs1" / "resumed")
    one = _cli_args(root, "logs1", 4)
    state = train_stage2.main([a.replace(str(root / "logs1" / "stage2"),
                                         str(root / "logs1" / "resumed"))
                               for a in one["stage2_resume"]])
    assert state.step == 3 and state.opt.count == 3
    step = lambda d, s: [r for r in rows(root / d) if r["step"] == s]
    got = step("logs2/stage2_resumed", 3)
    close_rows(got, step("logs1/resumed", 3))
    # the resumed logdirs kept steps 1–2 of the run they continue
    for d in ("logs2/stage2_resumed", "logs1/resumed"):
        assert step(d, 2) == step("logs2/stage2", 2)


def test_a_signal_on_one_rank_checkpoints_all_ranks(run):
    # rank 1 alone saw SIGUSR1 during step 2 of 3: the ranks agreed on it
    # and saved at step 2's boundary together (a rank alone in the FSDP
    # join would hang), then at the end
    ckpt = run["root"] / "logs2" / "stage2_preempt" / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["step_2.pt", "step_3.pt"]
    saved = torch.load(ckpt / "step_2.pt")["state"]
    assert saved["step"] == 2 and saved["opt"]["count"] == 2
    ref = torch.load(run["root"] / "logs2" / "stage2" / "ckpt" /
                     "step_2.pt")["state"]
    for k, v in ref["params"].items():   # the same run's step 2
        assert torch.equal(saved["params"][k], v), k


def test_loaders_split_disjointly_over_ranks(run):
    root = run["root"]
    ds = SpecFeatDataset.from_split_file(
        str(root / "pairs"), "train",
        cfg=LDMDataConfig(duration=1.0, truncate=8192))
    seen = []
    for r in range(2):
        loader = PrefetchLoader(ds, 1, seed=0, process_index=r,
                                process_count=2)
        seen.append([tuple(np.asarray(b["video_feat"]).ravel()[:4])
                     for b in loader.epoch(0)])
    assert len(seen[0]) == len(seen[1]) == 2
    assert not set(seen[0]) & set(seen[1])
    shards = sorted(str(p) for p in (root / "shards").glob("*.tar"))
    keys = [[s["key"] if "key" in s else s["spec"].tobytes()
             for s in cavp_shards.iter_shards(
                 shards, cfg=cavp_shards.CAVPShardConfig(clip_num=2),
                 process_index=r, process_count=2)] for r in range(2)]
    assert len(keys[0]) == len(keys[1]) == 2
    assert not set(keys[0]) & set(keys[1])


def test_align_acc_ragged_two_ranks_equals_jax_mesh(run, eight_devices):
    # 7 rows in batches of 3, 3, 1 over two ranks: each batch padded to a
    # multiple of 2 and masked, the counts summed over the data group
    from diff_foley_tpu.eval import align_acc as jacc
    from diff_foley_tpu.parallel import mesh as jmesh

    a = run["align"]
    stream = lambda: ({k: v[i:i + 3] for k, v in a["batches"].items()}
                      for i in range(0, 7, 3))
    ref = jacc.alignment_accuracy(
        stream(), a["jtrainer"], a["params"], a["jtrainer"].vae, a["vae"],
        mesh=jmesh.make_mesh(2, 1, devices=eight_devices[:2]))
    got = run["load"]("align_acc")["acc"]
    one = ranks.case_align_acc(None, run["root"])["acc"]
    assert got == ref == one and 0.0 < got < 1.0


def _close_outputs(got: dict, ref: dict):
    assert set(got) == set(ref)
    np.testing.assert_allclose(got["spec"], ref["spec"], rtol=0, atol=1e-5)
    peak = float(np.abs(ref["wav"]).max())
    np.testing.assert_allclose(got["wav"], ref["wav"], rtol=0,
                               atol=1e-4 * peak)


@pytest.fixture(scope="module")
def one_generate():
    return ranks.case_generate(None)


@pytest.mark.parametrize("entry", ["generate", "inpaint"])
def test_generate_and_inpaint_two_ranks_equal_one_process(run, one_generate,
                                                          entry):
    # 3 windows × 2 samples, padded to 4 windows on two ranks; every draw
    # (x_T, DDIM's forward noise, Griffin-Lim's phase) is the whole
    # stream's, each rank keeping its rows
    got = run["load"]("generate")[entry]
    ref = one_generate[entry]
    assert got["wav"].shape == ref["wav"].shape == (2, 3 * 131072)
    _close_outputs(got, ref)


def test_served_batch_replays_a_meshed_direct_generate(run):
    # the cap 3 rounds up to 4 on two ranks, so the 3-window request runs
    # in bucket 4: bit for bit the meshed direct call with its seed, and
    # the one-process call at that bucket within the limits
    got = run["load"]("serving")
    assert got["max_windows"] == got["bucket"] == 4
    np.testing.assert_array_equal(got["served"], got["direct"])
    pipe = ranks.tiny_pipeline(None)
    feats = np.random.default_rng(21).standard_normal(
        (3 * 32, 512)).astype(np.float32)
    gen = ranks.gen_config(sample_num=1, return_spec=False,
                           wav_dtype="int16")
    ref = pipe.generate(feats, got["seed"], gen, bucket_windows=4)["wav"][0]
    assert got["served"].shape == ref.shape == (3 * 131072,)
    # the waveforms' limit, plus one int16 step where the rounding
    # straddles a level
    served, ref = (w.astype(np.float64) / 32767.0 for w in (got["served"],
                                                            ref))
    assert float(np.abs(served - ref).max()) <= (
        1e-4 * float(np.abs(ref).max()) + 1.0 / 32767.0)
