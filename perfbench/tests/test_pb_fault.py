"""A whole run on the CPU, past the harness's look for a card: sound, it
comes out correct; with a served token altered where it is produced, it
does not."""
from perfbench.tests import smoke
from perfbench.tools.faults import alter_tokens

CELLS = ("starcoder2-15b.code-backlog", "granite-moe-1b-a400m.chat-backlog")


def test_sound_runs_are_correct():
    for cell in CELLS:
        out = smoke.run(cell)
        assert out["correct"], (cell, out["checks"])
        assert out["compared"]["tokens"] > 0
        assert out["checks"]["gap"]["value"] < 1e-3
        for k in ("logit_err", "logit_err_req_p90", "logit_err_mid"):
            assert out["compared"]["numbers"][k] < 1e-4, (cell, k)


def test_an_altered_token_is_caught():
    for cell in CELLS:
        out = smoke.run(cell, on_engine=alter_tokens)
        assert not out["correct"], cell
        for k, c in out["checks"].items():
            if k not in ("failed", "short"):
                assert c["value"] > c["limit"], (cell, k)


def test_a_traced_run_with_an_altered_token_is_caught():
    out = smoke.run(CELLS[0], trace=True, on_engine=alter_tokens)
    assert not out["correct"]
