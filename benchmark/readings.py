"""The readings a cell's limits are set from, on the card:

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3 \
        [--control | --witness]

For each seed, the program's compared numbers from a short run of the
cell's own runner at its own load (``--seconds``, default 3: long enough
to pass the sampled frames), or with ``--control`` the control's (the
reference in float8 in the program's place, on the pool's requests), or
for a train cell with ``--witness`` the reference's against itself on
inputs perturbed far under bfloat16's rounding (``compare.witness``), in
one process; one JSON line a seed."""
from __future__ import annotations

import argparse
import importlib
import json
import time

import torch

from . import compare, generator, manifest, train


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--perturb", type=float, default=1e-6,
                    help="the witness's relative perturbation of the inputs")
    args = ap.parse_args(argv)
    spec = manifest.cell(args.workload)
    config, traffic = spec["config"], spec["traffic"]
    device = torch.device("cuda", 0)
    runner = importlib.import_module(f"benchmark.{traffic['runner']}")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        notes = []
        if args.witness:
            pool = generator.make_pool(seed, traffic)
            numbers, notes = compare.witness(
                pool, train.labels(pool, config, device), config, seed,
                device, traffic["checked_steps"], args.perturb)
        elif not args.control:
            out = runner.run(spec, seed, args.seconds, False,
                             time.perf_counter(), device)
            numbers, notes = out["compared"], out["stderr"]
        elif traffic["runner"] == "serve":
            pool = generator.make_pool(seed, traffic)
            numbers = compare.serve_numbers(
                [(i, None, None, None, None, None) for i in range(len(pool))],
                pool, config, traffic, seed, device, control=True)
        else:
            pool = generator.make_pool(seed, traffic)
            numbers, notes = compare.train_numbers(
                None, pool, train.labels(pool, config, device), config, seed,
                device, traffic["checked_steps"], control=True)
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control,
                          "witness": args.witness and args.perturb,
                          "numbers": numbers,
                          "notes": notes,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
