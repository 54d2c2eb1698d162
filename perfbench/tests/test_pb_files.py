"""A configuration, a traffic mix with a loop of its own and a per-layer
metric added as files (with their entries in BENCHMARK.json) are found and
run with no edit."""
import json
import shutil
from pathlib import Path

from perfbench.harness import bench
from perfbench.harness import cell as C
from perfbench.tests import smoke

REPO = Path(__file__).resolve().parents[2]


def test_new_files_alone(tmp_path):
    (tmp_path / "perfbench").mkdir()
    for sub in ("configs", "traffic", "metrics", "loops"):
        shutil.copytree(REPO / "perfbench" / sub, tmp_path / "perfbench" / sub)
    b = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = smoke.config("starcoder2-15b")
    cfg["name"] = cfg["model"]["name"] = "tiny-coder"
    (tmp_path / "perfbench/configs/tiny-coder.json").write_text(
        json.dumps(cfg))
    mix = smoke.mix("chat-backlog")
    mix.update(name="tiny-mix", loop="tiny-loop")
    # a loop of its own: the backlog's, counting its feeds in the mix
    (tmp_path / "perfbench/loops/tiny-loop.py").write_text(
        (REPO / "perfbench/loops/backlog.py").read_text()
        .replace("def feed(loop, now: float):",
                 "def feed(loop, now: float):\n"
                 "    loop.mix[\"feeds\"] = loop.mix.get(\"feeds\", 0) + 1"))
    (tmp_path / "perfbench/traffic/tiny-mix.json").write_text(
        json.dumps(mix))
    (tmp_path / "perfbench/metrics/steps_seen.tiny.py").write_text(
        "def read(rec):\n    return float(len(rec.steps))\n")
    b["configs"].append({"name": "tiny-coder", "source": "a test",
                         "file": "perfbench/configs/tiny-coder.json",
                         "reduced": [], "why": "a test"})
    b["workloads"].append({"name": "tiny-coder.tiny-mix",
                           "config": "tiny-coder", "traffic": "tiny-mix",
                           "chips": 1, "why": "a test"})
    b["per_layer"].append({"name": "steps_seen.tiny", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "engine", "moves": "tpot_p90_ms",
                           "workloads": ["tiny-coder.tiny-mix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    spec = bench.from_bench("tiny-coder.tiny-mix", root=tmp_path)
    assert spec.config["name"] == "tiny-coder"
    assert spec.mix["name"] == "tiny-mix"
    assert [m["name"] for m in spec.per_layer] == ["steps_seen.tiny"]
    assert {m["name"] for m in spec.e2e} == {"tpot_p90_ms", "setup_s"}
    out = smoke.run("", run_spec=spec, trace=True)
    assert out["correct"]
    assert spec.mix["feeds"] > 0
    assert out["metrics"]["steps_seen.tiny"]["value"] > 0
    out = smoke.run("", run_spec=spec, seconds=6.0)
    assert set(out["metrics"]) == {"tpot_p90_ms", "setup_s"}


def test_cells_and_metrics_by_name():
    b = C.load_bench()
    for w in b["workloads"]:
        C.config(b, w["config"])
        C.loop_kind(C.mix(w["traffic"])["loop"])
        for m in C.per_layer(b, w["name"]):
            assert callable(C.reader(m["name"]))
        assert "setup_s" in {m["name"] for m in C.end_to_end(b, w["name"])}
