"""Run one cell of the benchmark of ``repro_torch`` (the PyTorch and CUDA
port) once, on the card of the machine it starts on.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is the
result, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (with ``--trace 1`` also ``busy_s`` and
``window_s`` of the profiled slice), with ``--trace 1`` a ``breakdown``,
and last the numbers compared, each with its limit (``checks``), which are
also the last lines of standard error.  With no usable card, or with a
module of JAX or of the JAX package loaded, it prints no result and exits
with a code other than 0.

The kernels build into ``build/repro_torch/`` inside the checkout, so only
the first run of a checkout compiles them.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ["REPRO_TORCH_BUILD_DIR"] = str(ROOT / "build" / "repro_torch")
# one process with one compute thread: the host side of serving is a single
# Python thread, and idle pool threads spinning beside it only add noise
os.environ["OMP_NUM_THREADS"] = "1"

ORDER = ("correct", "attempted", "failed", "metrics", "device", "breakdown",
         "tracing", "load", "compared", "checks")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)

    from perfbench.harness import bench, guard

    spec = bench.from_bench(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < spec.chips:
        print(f"perfbench: the cell needs {spec.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out = bench.run(spec, args.seed, args.seconds, bool(args.trace), "cuda",
                    T_START)
    found = guard.banned()
    if found:
        print("perfbench: modules of JAX or the JAX package are loaded: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps({k: out[k] for k in ORDER if k in out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
