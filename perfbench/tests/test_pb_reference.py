"""The plain reference against the port at smoke sizes on the CPU (a test
of the reference; the reference itself imports nothing of the port), and
the weights' shapes, the quantized leaves and the RTN round trip, which
both sides must share."""
import numpy as np
import pytest
import torch

from perfbench.harness import program
from perfbench.harness.cell import ROOT, config as cfg_file, load_bench
from perfbench.reference import model as R
from perfbench.reference.rtn import fake_quant
from perfbench.tests import smoke

NAMES = ("starcoder2-15b", "granite-moe-1b-a400m")


@pytest.mark.parametrize("name", NAMES)
def test_shapes_match_the_ports_tree_at_full_size(name):
    from repro_torch.models import api

    c = cfg_file(load_bench(), name)
    cfg = program.model_config(c)
    groups = program.weight_groups(api.init_model(cfg, device="meta"))
    m = c["model"]
    assert groups["embed"] == R.embed_shapes(m)
    assert groups["head"] == R.head_shapes(m)
    assert len(groups) == m["num_layers"] + 2
    for i in range(m["num_layers"]):
        assert groups[f"layers.{i}"] == R.layer_shapes(m)


@pytest.mark.parametrize("name", NAMES)
def test_quantized_leaves_and_rtn(name):
    from repro_torch.core.quantize import QuantizedTensor, dequantize

    c = smoke.config(name)
    cfg = program.model_config(c)
    params = program.build_params(c, cfg, 2 ** 31 + 3, "cpu")
    flat = program._flatten(params["layers"][1])
    q = sorted(p for p, v in flat.items() if isinstance(v, QuantizedTensor))
    assert q == sorted(R.quantized_leaves(c["model"]))
    # the reference's round trip is the port's, bit for bit
    from perfbench.harness.weights import make_group
    w = make_group(2 ** 31 + 3, "layers.1", R.layer_shapes(c["model"]), "cpu")
    for p in q:
        assert torch.equal(fake_quant(w[p], 32),
                           dequantize(flat[p], torch.float32)), p


@pytest.mark.parametrize("name", NAMES)
def test_reference_matches_the_ports_plain_forward(name):
    from repro_torch.models import api

    c = smoke.config(name)
    cfg = program.model_config(c)
    seed = 2 ** 31 + 99
    params = program.build_params(c, cfg, seed, "cpu")
    rng = np.random.default_rng(0)
    seqs = [rng.integers(2, 256, size=n) for n in (37, 64)]
    picks = [np.arange(n) for n in (37, 64)]
    ref = R.logits_at(c, seed, seqs, picks, "cpu")
    for s, r in zip(seqs, ref):
        got = api.forward_fn(params, {"tokens": torch.as_tensor(
            s[None], dtype=torch.int32)}, cfg)[0]
        scale = r.abs().max()
        assert (got - r).abs().max() / scale < 1e-5


def test_reference_imports_nothing_of_the_program():
    src = [(ROOT / "perfbench/reference" / f).read_text()
           for f in ("model.py", "rtn.py", "__init__.py")]
    src.append((ROOT / "perfbench/harness/weights.py").read_text())
    for s in src:
        for bad in ("repro_torch", "import repro", "from repro", "jax"):
            assert bad not in s
