"""The dry-run's roofline tables from ``results/dryrun_torch/*.json`` (port
of ``scripts/roofline_table.py``).  Usage:

    PYTHONPATH=src python -m repro_torch.launch.roofline_table [DIR]
    PYTHONPATH=src python -m repro_torch.launch.roofline_table --compact [DIR]
    PYTHONPATH=src python -m repro_torch.launch.roofline_table \
        --compare REFERENCE_CELL.json PORT_CELL.json

The terms are analytic, from the H100 SXM data sheet's constants
(``launch/roofline.py``), not measured.  Memory per device is the
arguments' local shards only: the port has no counterpart of XLA's temp
bytes.
"""
from __future__ import annotations

import glob
import json
import sys
from pathlib import Path


def load(directory: str = "results/dryrun_torch"):
    rows = []
    for f in sorted(glob.glob(f"{directory}/*.json")):
        d = json.loads(Path(f).read_text())
        if not d.get("tag"):
            rows.append(d)
    return rows


def fmt(v, n=3):
    return f"{v:.{n}g}" if isinstance(v, (int, float)) else str(v)


def table(rows, mesh: str) -> str:
    out = ["| arch | shape | step | t_comp (s) | t_mem (s) | t_coll (s) | "
           "bottleneck | useful/counted | roofline frac | args/dev |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for d in rows:
        if d["mesh"] != mesh:
            continue
        if d.get("skipped"):
            out.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | "
                       f"SKIP | — | — | {d.get('reason', '')[:40]} |")
            continue
        if not d.get("ok"):
            out.append(f"| {d['arch']} | {d['shape']} | — | — | — | — | "
                       f"FAIL | — | — | {d.get('error', '')[:60]} |")
            continue
        r = d["roofline"]
        args_b = d["memory"]["argument_size_in_bytes"] / 2 ** 30
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['step']} | "
            f"{fmt(r['t_compute_s'])} | {fmt(r['t_memory_s'])} | "
            f"{fmt(r['t_collective_s'])} | {r['bottleneck']} | "
            f"{fmt(r['useful_flops_ratio'])} | "
            f"{fmt(r['roofline_fraction'])} | {args_b:.2f} GiB |")
    return "\n".join(out)


SHAPE_ORDER = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SHORT = {"compute": "comp", "memory": "mem", "collective": "coll"}


def compact(rows, meshes=("single", "multi")) -> str:
    """One line per (arch, mesh), one column per shape: ``t_compute /
    t_memory / t_collective`` seconds, the bottleneck and the arguments'
    GiB a device; SKIP, or FAIL with its error's type."""
    out = ["| arch (mesh) | " + " | ".join(SHAPE_ORDER) + " |",
           "|---|" + "---|" * len(SHAPE_ORDER)]
    cells = {(d["arch"], d["mesh"], d["shape"]): d for d in rows}
    for mesh in meshes:
        for arch in sorted({d["arch"] for d in rows if d["mesh"] == mesh}):
            line = []
            for shape in SHAPE_ORDER:
                d = cells.get((arch, mesh, shape))
                if d is None:
                    line.append("—")
                elif d.get("skipped"):
                    line.append("SKIP")
                elif not d.get("ok"):
                    line.append("FAIL " + d.get("error", "").split(":")[0])
                else:
                    r = d["roofline"]
                    gib = d["memory"]["argument_size_in_bytes"] / 2 ** 30
                    line.append(f"{fmt(r['t_compute_s'])} / "
                                f"{fmt(r['t_memory_s'])} / "
                                f"{fmt(r['t_collective_s'])} "
                                f"{SHORT[r['bottleneck']]}, {gib:.2f}")
            out.append(f"| {arch} ({mesh}) | " + " | ".join(line) + " |")
    return "\n".join(out)


def compare(ref: dict, port: dict) -> str:
    """One cell side by side: the reference's dry-run record
    (``repro.launch.dryrun``) and the port's, both counts put through the
    port's H100 constants (the reference's collective bytes at the
    InfiniBand rate, as the port's are when no axis is known)."""
    from repro_torch.launch import roofline as RL

    def terms(d):
        r = d["roofline"]
        rl = RL.Roofline(flops=r["flops"], hbm_bytes=r["hbm_bytes"],
                         coll_bytes=r["coll_bytes"], chips=r["chips"],
                         model_flops=r["model_flops"],
                         weight_stream_bytes=r["weight_stream_bytes"],
                         model_shards=r["model_shards"],
                         coll_by_axis=r.get("coll_by_axis"),
                         link_bw=r.get("link_bw"))
        return rl

    a, b = terms(ref), terms(port)
    rows = [("FLOPs (global)", a.flops, b.flops),
            ("bytes (global)", a.hbm_bytes, b.hbm_bytes),
            ("collective bytes / device", a.coll_bytes / a.chips,
             b.coll_bytes / b.chips),
            ("argument bytes / device",
             ref["memory"].get("argument_size_in_bytes"),
             port["memory"].get("argument_size_in_bytes")),
            ("t_compute (s)", a.t_compute, b.t_compute),
            ("t_memory (s)", a.t_memory, b.t_memory),
            ("t_collective (s)", a.t_collective, b.t_collective)]
    out = [f"| {ref['arch']} × {ref['shape']} × {ref['mesh']} | reference "
           "| port |", "|---|---|---|"]
    out += [f"| {n} | {fmt(x, 4)} | {fmt(y, 4)} |" for n, x, y in rows]
    out.append(f"| collectives by kind / device | "
               f"{ref.get('collectives_per_device')} | "
               f"{port.get('collectives_per_device')} |")
    return "\n".join(out)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--compact"]:
        print(compact(load(argv[1] if argv[1:] else "results/dryrun_torch")))
        return
    if argv[:1] == ["--compare"]:
        print(compare(json.loads(Path(argv[1]).read_text()),
                      json.loads(Path(argv[2]).read_text())))
        return
    rows = load(argv[0] if argv else "results/dryrun_torch")
    print("### Single-pod mesh (16×16 = 256 GPUs)\n")
    print(table(rows, "single"))
    print("\n### Multi-pod mesh (2×16×16 = 512 GPUs)\n")
    print(table(rows, "multi"))
    ok = [d for d in rows if d.get("ok") and not d.get("skipped")]
    fails = [d for d in rows if not d.get("ok")]
    skips = [d for d in rows if d.get("skipped")]
    print(f"\ncells: {len(ok)} OK, {len(skips)} skipped per assignment, "
          f"{len(fails)} failed")


if __name__ == "__main__":
    main()
