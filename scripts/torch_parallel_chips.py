"""``cli.train_stage2`` of the PyTorch port on four GPUs against one GPU.

    python scripts/torch_parallel_chips.py

Runs of the stage-2 CLI on the same seeded (mel spec, CAVP feature) pairs,
seeds and arguments (bf16 on fp32 masters, EMA, the full ``LDM_UNET`` and
cond encoder against the frozen ``SD_VAE``, four steps): one process at the
global batch of 16, then ``torchrun --nproc-per-node 4`` at 4 rows a
process, data-parallel and with ``--fsdp``, and last the ``--fsdp`` run's
logdir resumed at four processes for two more steps. The data holds
exactly one global batch, so every epoch the four ranks' rows are the one
process's batch. Prints each run's per-step metrics, warm step seconds and
peak device memory per rank, the FSDP split, the relative differences of
the metrics against the one-process run, the card's name and power limit,
and as the last line a JSON summary (written also to
``chiprun_out/torch_parallel_chips.json``).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NPROC = 4
STEPS = 4
RESUMED_STEPS = 2
BATCH = 16   # global


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def write_data(root: str, items: int, frames: int) -> None:
    """Seeded pairs in the reference layout (the smoke's writer)."""
    from chip_smoke import write_pairs

    write_pairs(root, n=items, frames=frames, feats=40)


def run(cmd: list, env: dict, timeout: float) -> tuple:
    t0 = time.perf_counter()
    p = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=timeout)
    seconds = time.perf_counter() - t0
    if p.returncode:
        sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
        raise SystemExit(f"{' '.join(cmd[:6])} … exited {p.returncode}")
    return p.stdout, seconds


def main() -> int:
    import torch

    if torch.cuda.device_count() < NPROC:
        print(f"needs {NPROC} GPUs, found {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    out_dir = os.path.join(REPO, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    summary = {"nproc": NPROC, "steps": STEPS, "global_batch": BATCH,
               "runs": {}}
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        write_data(data, BATCH, 600)
        common = ["--data-dir", data, "--base-lr", "1e-4",
                  "--warmup-steps", "0", "--use-ema", "--log-every", "1",
                  "--save-every", "1000000", "--mixed-precision"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(var, None)
        cli = ["-m", "diff_foley_tpu_torch.cli.train_stage2"]
        torchrun = lambda: [sys.executable, "-m", "torch.distributed.run",
                            "--nproc-per-node", str(NPROC),
                            "--master-addr", "127.0.0.1", "--master-port",
                            str(free_port())]
        per_rank = ["--batch-size", str(BATCH // NPROC)]
        steps = lambda n: ["--max-steps", str(n)]
        # name: (command, logdir); the resumed run continues "fsdp"'s
        runs = {"one": (lambda: [sys.executable] + cli + [
                            "--batch-size", str(BATCH)] + steps(STEPS),
                        "one"),
                "ddp": (lambda: torchrun() + cli + per_rank + steps(STEPS),
                        "ddp"),
                "fsdp": (lambda: torchrun() + cli + per_rank + steps(STEPS)
                         + ["--fsdp"], "fsdp"),
                "fsdp_resumed": (lambda: torchrun() + cli + per_rank
                                 + steps(STEPS + RESUMED_STEPS)
                                 + ["--fsdp", "--resume"], "fsdp")}
        for name, (cmd, logs) in runs.items():
            logdir = os.path.join(root, logs)
            stdout, seconds = run(cmd() + common + ["--logdir", logdir],
                                  dict(env, CUDA_VISIBLE_DEVICES=",".join(
                                      map(str, range(NPROC))))
                                  if name != "one" else
                                  dict(env, CUDA_VISIBLE_DEVICES="0"),
                                  timeout=1200)
            rows = [json.loads(line) for line in open(
                os.path.join(logdir, "metrics.jsonl"))]
            if name == "fsdp_resumed":
                rows = rows[STEPS:]   # the logdir's rows go on
                if [r["step"] for r in rows] != list(range(
                        STEPS + 1, STEPS + RESUMED_STEPS + 1)):
                    raise SystemExit(f"the resumed run logged steps "
                                     f"{[r['step'] for r in rows]}")
            peaks = [float(m) for m in re.findall(
                r"peak device memory ([0-9.]+) GiB", stdout)]
            fsdp = re.findall(r"FSDP: .*", stdout)
            if name != "fsdp":   # a full-width checkpoint is 13.8 GB
                shutil.rmtree(logdir)
            summary["runs"][name] = {
                "call_s": seconds, "rows": rows,
                "warm_step_s": min(r["step_s"] for r in rows[1:]),
                "peak_mem_GiB_per_rank": peaks, "fsdp": fsdp[:1]}
            print(f"{name}: {seconds:.1f} s, warm step "
                  f"{summary['runs'][name]['warm_step_s']:.4f} s, peak GiB "
                  f"per rank {peaks}, {fsdp[:1]}; metrics {json.dumps(rows)}")
    one = summary["runs"]["one"]["rows"]
    for name in ("ddp", "fsdp"):
        rows = summary["runs"][name]["rows"]
        summary["runs"][name]["rel_diff_vs_one"] = {
            k: max(abs(r[k] - o[k]) / max(abs(o[k]), 1e-30)
                   for r, o in zip(rows, one))
            for k in one[0] if k.startswith("train/")}
        print(f"{name} against one process, relative Δ by metric: "
              + json.dumps(summary["runs"][name]["rel_diff_vs_one"]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    summary["cards"] = card
    print("; ".join(card))
    with open(os.path.join(out_dir, "torch_parallel_chips.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}
                     | {"runs": {n: {k: v for k, v in r.items()
                                     if k != "rows"}
                                 for n, r in summary["runs"].items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
