"""The port's examples and trace viewer on the CPU, their work cut down:

- ``repro_torch.examples.quickstart``: PTQ, the logit error and a greedy
  continuation through the contiguous cache;
- ``quantize_and_serve``: quantize on load, boot again from the saved
  artifact, serve fp and W4A16;
- ``multiarch_ptq``: its architectures are the reference example's (the
  first ten of the reference's registry, by name), two of them quantized;
- ``train_small``: the loss falls, and the second run resumes from the
  first's checkpoint for 10 more steps;
- ``launch.trace_viewer``: the export has its preempt → resume flow events,
  and its (phase, name) pairs are the reference script's on the same
  arguments;
- every one of them defaults to the card and raises without one.
"""
import importlib
import importlib.util
import json
import math
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
MODULES = ["repro_torch.examples.quickstart",
           "repro_torch.examples.quantize_and_serve",
           "repro_torch.examples.multiarch_ptq",
           "repro_torch.examples.train_small",
           "repro_torch.launch.trace_viewer"]


def test_quickstart_cpu():
    from repro_torch.examples import quickstart

    out = quickstart.main(["--device", "cpu", "--new-tokens", "3"])
    assert len(out["tokens"]) == 4
    assert math.isfinite(out["rel_logit_err"]) and out["rel_logit_err"] < 1
    assert out["quant_bytes"] < out["fp_bytes"]


def test_quantize_and_serve_cpu(tmp_path):
    from repro_torch.examples import quantize_and_serve

    out = quantize_and_serve.main([
        "--device", "cpu", "--requests", "3", "--max-tokens", "3",
        "--artifact", str(tmp_path / "ptq")])
    assert (tmp_path / "ptq" / "meta.json").exists()
    for tag in ("fp", "w4a16"):
        assert out[tag]["completed"] == 3
        assert all(1 <= len(o) <= 3 for o in out[tag]["outputs"])


def test_multiarch_ptq_cpu():
    from repro.configs import ARCH_IDS as REF_ARCH_IDS
    from repro_torch.examples import multiarch_ptq

    assert multiarch_ptq.ARCHS == tuple(REF_ARCH_IDS[:10])
    reps = multiarch_ptq.main(["--device", "cpu", "--archs",
                               "llama3.2-3b,rwkv6-7b"])
    assert list(reps) == ["llama3.2-3b", "rwkv6-7b"]
    assert all(r.quant_bytes < r.fp_bytes for r in reps.values())


def test_train_small_cpu(tmp_path, capsys):
    from repro_torch.examples import train_small

    out = train_small.main(["--device", "cpu", "--steps", "12", "--batch",
                            "4", "--seq", "32", "--ckpt-dir",
                            str(tmp_path)])
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["losses"]) == 12 and len(out["resumed"]) == 10
    assert "[resume] restored step 12" in capsys.readouterr().out


def _ref_trace_viewer():
    spec = importlib.util.spec_from_file_location(
        "_ref_trace_viewer", ROOT / "scripts" / "trace_viewer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_trace_viewer_matches_reference_events(tmp_path):
    from repro.serving.trace import to_chrome_trace as j_to_chrome_trace
    from repro_torch.launch import trace_viewer
    from repro_torch.serving.trace import to_chrome_trace

    eng = trace_viewer.drive_traced_engine(requests=6, device="cpu")
    evs = to_chrome_trace(eng.trace, n_slots=eng.B)["traceEvents"]
    flows = [e for e in evs if e["ph"] in ("s", "f")]
    assert flows and {e["ph"] for e in flows} == {"s", "f"}
    jeng = _ref_trace_viewer().drive_traced_engine(requests=6)
    jevs = j_to_chrome_trace(jeng.trace, n_slots=jeng.B)["traceEvents"]
    assert {(e["ph"], e["name"]) for e in evs} == \
        {(e["ph"], e["name"]) for e in jevs}
    out = tmp_path / "trace.json"
    assert trace_viewer.main(["--device", "cpu", "--out", str(out),
                              "--summary"]) == 0
    assert json.loads(out.read_text())["traceEvents"]


@pytest.mark.parametrize("name", MODULES)
def test_examples_default_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run on it")
    mod = importlib.import_module(name)
    argv = ["--out", str(tmp_path / "t.json")] if name.endswith(
        "trace_viewer") else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
