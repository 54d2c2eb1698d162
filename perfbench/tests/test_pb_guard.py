"""The import check: what the harness loads holds no module of JAX or of
the JAX package, compared by whole top-level names."""
import subprocess
import sys

from perfbench.harness import guard
from perfbench.harness.cell import ROOT


def test_names_compare_whole():
    assert guard.banned(["repro_torch.serving.engine", "numpy"]) == []
    assert guard.banned(["repro.models.api", "repro_torch"]) == ["repro"]
    assert guard.banned(["jax._src.core", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert guard.banned(["jaxtyping", "reproducible"]) == []


def test_a_run_loads_none():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from perfbench.tests import smoke\n"
        "from perfbench.harness import guard\n"
        "import perfbench.tools.control\n"
        "out = smoke.run('granite-moe-1b-a400m.chat-backlog', trace=True)\n"
        "assert out['correct']\n"
        "print('BANNED', guard.banned())\n" % (str(ROOT), str(ROOT / "src")))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "BANNED []" in res.stdout
