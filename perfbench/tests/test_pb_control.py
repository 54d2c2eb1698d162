"""The control: the reference at the next lower precision, TF32.  On the
CPU the operands are rounded to TF32; on the card cuBLAS's TF32 mode runs
(the ``cuda`` test, at full width and two layers)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench.harness.cell import ROOT
from perfbench.reference import model as R
from perfbench.tests import smoke


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -10),
                      1 + 2 ** -12, 3.14159265])
    got = R._to_tf32(x)
    want = torch.tensor([1.0, 1.0, 1 + 2 ** -9, -(1 + 2 ** -10), 1.0,
                         3.140625])
    assert torch.equal(got, want)


def test_control_departs_from_the_reference_on_the_cpu():
    c = smoke.config("starcoder2-15b")
    rng = np.random.default_rng(1)
    seqs = [rng.integers(2, 256, size=48)]
    picks = [np.arange(48)]
    f32 = R.logits_at(c, 7, seqs, picks, "cpu")[0]
    tf = R.logits_at(c, 7, seqs, picks, "cpu", precision="tf32")[0]
    rel = ((tf - f32).abs().max() / f32.abs().max()).item()
    assert 1e-5 < rel < 1e-1


def test_the_control_is_judged_and_fails_on_the_cpu():
    spec = smoke.spec("starcoder2-15b.code-backlog")
    out = smoke.run("", run_spec=spec, control=True)
    assert not out["correct"]
    mine, ctl = out["program"], out["compared"]["numbers"]
    for k in ("logit_err", "logit_err_req_p90", "logit_err_mid"):
        assert ctl[k] > 30 * mine[k], k
    assert out["checks"]["logit_err"]["value"] == ctl["logit_err"]
    assert ctl["logit_err"] > out["checks"]["logit_err"]["limit"]


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = subprocess.run(
        [sys.executable, "perfbench/tools/control.py", "--workload",
         "starcoder2-15b.code-backlog", "--seconds", "4", "--layers", "2",
         "--seeds", "2147483701,2147483702",
         "--control-seeds", "2147483701,2147483702,2147483703"],
        capture_output=True, text=True, timeout=1500, cwd=ROOT,
        env=dict(os.environ, REPRO_TORCH_BUILD_DIR=str(
            ROOT / "build" / "repro_torch")))
    assert res.returncode == 0, res.stderr[-3000:]
    rows = [json.loads(x) for x in res.stdout.splitlines()
            if x.startswith("{")]
    assert [r["mode"] for r in rows] == ["program"] * 2 + ["control"] * 3
    assert all(r["correct"] for r in rows[:2])
    assert not any(r["correct"] for r in rows[2:])
