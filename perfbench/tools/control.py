"""Readings that a cell's correctness limit is set from, on the card.

For each seed: one run of the cell (set-up, warm-up, a short window at the
cell's own load, the sample of finished requests), then the reference over
the served tokens in float32.  On a seed of ``--control-seeds`` the
reference runs again in TF32 in the program's place (the control), and
``checks`` and ``correct`` judge the control's numbers (the program's own
go under ``program``); on a seed of ``--fault-seeds`` an altered token is
planted under the timed path (``tools/faults.py``).  One JSON line a run:
the numbers compared, their checks, ``correct``, and how many tokens were
compared.  All runs share one process.

    python3 perfbench/tools/control.py --workload <cell> --seconds 10 \
        --seeds 11,12,13 [--control-seeds 14,15] [--fault-seeds 16]
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--layers", type=int, default=0,
                   help="cut the configuration to this many layers (tests)")
    args = p.parse_args(argv)
    import torch

    from perfbench.harness import bench
    from perfbench.tools.faults import alter_tokens

    spec = bench.from_bench(args.workload)
    if args.layers:
        spec.config["model"]["num_layers"] = args.layers

    def seeds(arg):
        return [int(x) for x in arg.split(",") if x]

    runs = ([(s, "program") for s in seeds(args.seeds)]
            + [(s, "control") for s in seeds(args.control_seeds)]
            + [(s, "fault") for s in seeds(args.fault_seeds)])
    for seed, mode in runs:
        t = time.perf_counter()
        out = bench.run(spec, seed, args.seconds, False, "cuda", t,
                        control=mode == "control",
                        on_engine=alter_tokens if mode == "fault" else None)
        print(json.dumps({
            "seed": seed, "mode": mode,
            "checks": {k: v["value"] for k, v in out["checks"].items()},
            "program": out.get("program"),
            "correct": out["correct"], "compared": out["compared"],
            "metrics": out["metrics"], "wall_s": time.perf_counter() - t,
            "kind": torch.cuda.get_device_name()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
