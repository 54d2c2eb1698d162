"""Smoke-size copies of the benchmark's configurations and mixes, for the
CPU tests: every width cut so that a run takes seconds on the CPU."""
from __future__ import annotations

import time

from perfbench.harness import bench
from perfbench.harness import cell as C

DENSE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
             head_dim=16, d_ff=128, vocab_size=256)
MOE = dict(num_experts=4, top_k=2, d_expert=32, capacity_factor=2.0)


def config(name: str) -> dict:
    b = C.load_bench()
    cfg = C.config(b, name)
    cfg["model"].update(DENSE)
    if cfg["model"].get("moe"):
        cfg["model"]["moe"].update(MOE)
        cfg["model"]["d_ff"] = MOE["d_expert"]
    cfg["quant"]["group_size"] = 32
    return cfg


def mix(name: str) -> dict:
    m = C.mix(name)
    m["engine"].update(batch_size=4, max_seq=96)
    m["prompt_len"] = {"dist": "lognormal", "median": 16, "sigma": 0.6,
                       "min": 4, "max": 40}
    m["output_len"] = {"dist": "lognormal", "median": 8, "sigma": 0.6,
                       "min": 2, "max": 20}
    m["max_total"] = 96
    m["block"] = 8
    return m


def spec(workload: str) -> bench.Run:
    """A cell of BENCHMARK.json at smoke size."""
    b = C.load_bench()
    w = C.workload(b, workload)
    return bench.Run(config(w["config"]), mix(w["traffic"]), workload,
                     1, C.end_to_end(b, workload), C.per_layer(b, workload))


def run(workload: str, *, seed: int = 2 ** 31 + 17, seconds: float = 1.5,
        trace: bool = False, on_engine=None, run_spec=None,
        control: bool = False) -> dict:
    return bench.run(run_spec or spec(workload), seed, seconds, trace,
                     "cpu", time.perf_counter(), on_engine=on_engine,
                     control=control)
