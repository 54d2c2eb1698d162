"""The engine on the card: its decode step runs as one CUDA graph
(``serving/decode_graph.py``), and preemption swaps through pinned host
buffers.  Smoke configs quantized on the card (f32, G=16): codellama-7b
(fp and int8 pools), granite-moe-1b-a400m, deepseek-v2-236b (fp and int8
latent pools).

- a replay's logits equal, bit for bit, an eager ``api.decode_paged_fn`` of
  the same inputs on a copy of the pools taken before the replay, and the
  pools it writes equal the copy's;
- the launch counters after N replays equal N times one eager step's;
- a tight pool (preempting, swapping) gives the roomy pool's tokens.

Marked ``cuda``: skipped where there is no GPU.  Run on the GPU machine with
``python -m pytest -m cuda tests/test_torch_cuda_engine.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.configs.base import QuantConfig
from repro_torch.core.calibration import synthetic_calibration_set
from repro_torch.device import strict_fp32_matmul
from repro_torch.models import api
from repro_torch.serving.engine import Request, ServingEngine, load_or_quantize

pytestmark = pytest.mark.cuda

CONFIGS = {"codellama": ("codellama-7b", False),
           "codellama_int8": ("codellama-7b", True),
           "granite": ("granite-moe-1b-a400m", False),
           "deepseek": ("deepseek-v2-236b", False),
           "deepseek_int8": ("deepseek-v2-236b", True)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    strict_fp32_matmul()
    return torch.device("cuda")


_PARAMS = {}


def _quantized(arch, dev):
    if arch not in _PARAMS:
        cfg = get_config(arch, smoke=True).with_(dtype="float32")
        params = api.init_model(cfg, seed=0, device=dev)
        calib = synthetic_calibration_set(cfg, n_seqs=2, seq_len=24)
        _PARAMS[arch] = (cfg, load_or_quantize(
            params, cfg, calib, QuantConfig(group_size=16))[0])
    return _PARAMS[arch]


def _requests(vocab, n, max_tokens, seed=5):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, prompt=rng.integers(
        2, vocab, (3, 7, 10, 5)[i % 4]).astype(np.int32),
        max_tokens=max_tokens) for i in range(n)]


def _clone(pools):
    return {"layers": [{k: t.clone() for k, t in lp.items()}
                       for lp in pools["layers"]]}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_replay_equals_eager_step(dev, name):
    arch, kvq = CONFIGS[name]
    cfg, params = _quantized(arch, dev)
    cfg = cfg.with_(kv_quant=kvq)
    eng = ServingEngine(params, cfg, batch_size=3, max_seq=32, page_size=4,
                        device=dev)
    for r in _requests(cfg.vocab_size, 3, 12):
        eng.submit(r)
    while eng.decode_graph.replays < 2:
        eng.step()
    dec = [i for i in eng._active_slots() if eng.pos[i] >= eng.pref_target[i]]
    assert dec
    tok, pos, tbl = eng._decode_inputs(dec)
    pools = _clone(eng.pools)
    K.reset_launch_counts()
    with torch.no_grad():
        eager = api.decode_paged_fn(
            params, {"token": eng._tensor(tok), "position": eng._tensor(pos)},
            pools, eng._tensor(tbl), cfg)[0]
    torch.cuda.synchronize()
    per_step = K.launch_counts()
    assert per_step == eng.decode_graph.per_replay
    assert per_step["w4a16_matmul"] > 0
    K.reset_launch_counts()
    n = 3
    for _ in range(n):
        logits = eng.decode_graph(tok, pos, tbl)
    torch.cuda.synchronize()
    assert K.launch_counts() == {k: n * v for k, v in per_step.items()}
    assert torch.equal(logits, eager)
    for lp, lc in zip(eng.pools["layers"], pools["layers"]):
        for k in lp:
            assert torch.equal(lp[k], lc[k]), k
    eng.run_until_drained()
    assert eng.decode_graph.replays == eng.stats.steps + n


@pytest.mark.parametrize("name", ["codellama", "codellama_int8",
                                  "deepseek"])
def test_tight_pool_matches_roomy_pool_on_the_card(dev, name):
    arch, kvq = CONFIGS[name]
    cfg, params = _quantized(arch, dev)
    cfg = cfg.with_(kv_quant=kvq)
    outs, stats = [], []
    for num_pages in (None, 1 + 7):
        eng = ServingEngine(params, cfg, batch_size=3, max_seq=24,
                            page_size=4, num_pages=num_pages, device=dev)
        reqs = _requests(cfg.vocab_size, 6, 12)
        for r in reqs:
            eng.submit(r)
        stats.append(eng.run_until_drained())
        eng.pager.check_invariants()
        assert eng.pager.free_pages == eng.pager.num_pages - 1
        assert eng.decode_graph.replays == eng.stats.steps
        outs.append([r.output for r in reqs])
    roomy, tight = stats
    assert roomy.preemptions == 0 and tight.preemptions >= 2
    assert tight.resumes == tight.preemptions
    assert tight.swapped_out_bytes == tight.swapped_in_bytes > 0
    assert outs[0] == outs[1]


def _prefix_waves(vocab, seed=7):
    """Two waves behind one 12-token (3-page) shared prefix; wave 2 opens
    with the bare prefix, a page-aligned full match (COW)."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(2, vocab, 12).astype(np.int32)
    w1 = [np.concatenate([sys_p, rng.integers(2, vocab, n).astype(np.int32)])
          for n in (3, 5, 2)]
    w2 = [sys_p.copy(), w1[0].copy(),
          rng.integers(2, vocab, 19).astype(np.int32)]
    return w1, w2


@pytest.mark.parametrize("name", ["codellama", "codellama_int8",
                                  "deepseek"])
def test_prefix_cache_under_the_graph_equals_cold_run(dev, name):
    """The prefix cache on the card: cached prefix pages read by K3 / B9,
    a COW copy into the pools the decode graph holds, a one-token chunk
    behind a full prefix; the tokens equal the cache-off run's and the
    decode still replays one graph, once a step."""
    arch, kvq = CONFIGS[name]
    cfg, params = _quantized(arch, dev)
    cfg = cfg.with_(kv_quant=kvq)
    outs, engs = [], []
    for cache in (False, True):
        eng = ServingEngine(params, cfg, batch_size=2, max_seq=32,
                            page_size=4, num_pages=11, prefix_cache=cache,
                            device=dev)
        out = []
        for wave in _prefix_waves(cfg.vocab_size):
            reqs = [Request(uid=len(out) + i, prompt=p, max_tokens=5)
                    for i, p in enumerate(wave)]
            for r in reqs:
                eng.submit(r)
            eng.run_until_drained()
            out += [r.output for r in reqs]
        eng.pager.check_invariants()
        assert eng.decode_graph.replays == eng.stats.steps
        outs.append(out)
        engs.append(eng)
    cold, warm = engs
    assert outs[0] == outs[1]
    assert warm.stats.prefix_hits >= 2 and warm.stats.cow_copies >= 1
    assert warm.stats.prefilled_tokens < cold.stats.prefilled_tokens


def test_decode_launch_fault_skips_one_replay(dev):
    """A ``decode_launch`` fault at step 3 launches nothing: the graph
    replays once a decode step that ran, the launch counters equal one
    replay's counts per replay plus the prefill chunks', and the tokens
    equal the unfaulted run's."""
    from repro_torch.serving.faults import FaultPlan, FaultSpec

    cfg, params = _quantized("codellama-7b", dev)
    runs = []
    for faulted in (False, True):
        plan = (FaultPlan([FaultSpec("decode_launch", step=3, times=1)])
                if faulted else None)
        eng = ServingEngine(params, cfg, batch_size=3, max_seq=32,
                            page_size=4, fault_plan=plan, device=dev)
        reqs = _requests(cfg.vocab_size, 3, 8)
        K.reset_launch_counts()
        for r in reqs:
            eng.submit(r)
        st = eng.run_until_drained()
        torch.cuda.synchronize()
        counts = K.launch_counts()
        g = eng.decode_graph
        assert g.replays == st.steps
        nl = cfg.num_layers
        assert counts["gqa_paged_decode"] == nl * st.steps
        assert counts["gqa_paged_prefill"] == nl * st.prefill_batches
        assert counts["w4a16_matmul"] == 7 * nl * (st.steps
                                                   + st.prefill_batches)
        runs.append((st, [r.output for r in reqs], plan))
    (st0, out0, _), (st1, out1, plan) = runs
    assert plan.injected["decode_launch"] == 1
    assert st1.retries == 1 and out1 == out0
    assert st1.steps == st0.steps
