"""Batch mel-format interop (``diff_foley_tpu/cli/transform_spec.py``): a
folder of generated ``.npy`` specs → the SpecVQGAN metric toolchain's
format (80-mel/22.05 kHz), or back.

Usage:
  python -m diff_foley_tpu_torch.cli.transform_spec --input generate_folder/ \\
      --output save_folder/ [--direction to_specvqgan] \\
      [--split 4 --node 1] [--workers 8]

``--split/--node`` shards the sorted file list for multi-node runs: node k
of ``split`` takes files [k·⌈N/split⌉, (k+1)·⌈N/split⌉). ``--workers``
converts in a process pool. Host numpy and scipy only: no device.
"""
from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", required=True, help="folder of .npy specs")
    p.add_argument("--output", required=True)
    p.add_argument("--direction", choices=("to_specvqgan", "to_native"),
                   default="to_specvqgan",
                   help="to_specvqgan: 128-mel/16k → 80-mel/22.05k; "
                        "to_native: the inverse")
    p.add_argument("--split", type=int, default=1)
    p.add_argument("--node", type=int, default=0)
    p.add_argument("--workers", type=int, default=0,
                   help="process-pool size; 0 = in-process serial")
    return p.parse_args(argv)


def _convert_one(job):
    """Top-level so it pickles into worker processes."""
    import numpy as np

    from ..eval.spec_transform import (spec_16k128_to_22k80,
                                       spec_22k80_to_16k128)

    src, dst, direction = job
    try:
        spec = np.load(src)
        fn = (spec_16k128_to_22k80 if direction == "to_specvqgan"
              else spec_22k80_to_16k128)
        np.save(dst, fn(spec))
        return os.path.basename(src), True, ""
    except Exception as e:   # one failed file is reported, not fatal
        return os.path.basename(src), False, str(e)


def main(argv=None):
    args = parse_args(argv)
    if not 0 <= args.node < args.split:
        raise SystemExit(f"--node {args.node} out of range for --split "
                         f"{args.split}")
    os.makedirs(args.output, exist_ok=True)
    names = sorted(f for f in os.listdir(args.input) if f.endswith(".npy"))
    chunk = -(-len(names) // args.split) if names else 0
    names = names[args.node * chunk:min((args.node + 1) * chunk, len(names))]
    jobs = [(os.path.join(args.input, n), os.path.join(args.output, n),
             args.direction) for n in names]

    if args.workers > 0 and len(jobs) > 1:
        # submit + as_completed: a worker that dies fails its own file,
        # and the rest of the report survives. Spawned workers: a fork
        # would copy a caller's threads (torch's, a server's)
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        results = []
        with ProcessPoolExecutor(
                max_workers=args.workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futs = {pool.submit(_convert_one, j): j for j in jobs}
            for fut in as_completed(futs):
                try:
                    results.append(fut.result())
                except Exception as e:
                    results.append((os.path.basename(futs[fut][0]), False,
                                    f"worker died: {e}"))
    else:
        results = [_convert_one(j) for j in jobs]

    errs = [(n, msg) for n, ok, msg in results if not ok]
    print(f"converted {len(results) - len(errs)}/{len(results)} specs "
          f"({args.direction}, node {args.node}/{args.split})")
    for n, msg in errs:
        print(f"  FAILED {n}: {msg}")
    return 1 if errs else 0


if __name__ == "__main__":
    raise SystemExit(main())
