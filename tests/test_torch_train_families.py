"""Port parity of the training loss across the model families, on each
family's f32 smoke config against the JAX package on the same weights and
the reference's synthetic batch (batch 2, 16 tokens):

- ``api.loss_fn`` and its gradients against
  ``jax.value_and_grad(api.loss_fn)`` for granite (the MoE aux loss
  included), deepseek (MLA and shared experts), zamba2 (the hybrid stack,
  remat per Mamba2 block and per group), rwkv6, whisper (``frames``) and
  qwen2-vl (``embeds``): loss rtol 1e-5; each gradient leaf within 1e-4 of
  its own L2 norm plus 1e-6 of the whole gradient's (a key bias's gradient
  is zero in exact arithmetic, so both packages return rounding noise
  there);
- the grad guard: a loss that reaches a kernel wrapper with operands that
  require grad raises, as the reference cannot differentiate either: under
  ``attn_impl="flash"`` (the reference's ``flash_interpret``, whose
  ``pallas_call`` has no transpose rule) and with a quantized weight (the
  reference refuses the int4 codes' integer leaves).  Without grad the same
  forward runs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import quantize as JQ
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import api as japi
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.models import api as tapi
from repro_torch.models import convert
from repro_torch.train import trainer as TTR

# (arch, remat): zamba2 checks the hybrid's nested remat
FAMILIES = [("granite-moe-1b-a400m", False), ("deepseek-v2-236b", False),
            ("zamba2-7b", True), ("rwkv6-7b", False),
            ("whisper-medium", False), ("qwen2-vl-7b", False)]
N_EMBEDS = 4


def _setup(arch):
    jcfg = j_get_config(arch, smoke=True).with_(dtype="float32")
    tcfg = get_config(arch, smoke=True).with_(dtype="float32")
    jp = japi.init_model(jax.random.PRNGKey(0), jcfg)
    batch = JSyntheticTokens(JDataConfig(vocab_size=jcfg.vocab_size,
                                         seq_len=16, global_batch=2),
                             jcfg).batch_at(1)
    if arch.startswith("qwen2-vl"):
        batch["embeds"] = jnp.asarray(np.random.default_rng(0).standard_normal(
            (2, N_EMBEDS, jcfg.d_model)).astype(np.float32))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jcfg, tcfg, jp, batch, tb


@pytest.mark.parametrize("arch,remat", FAMILIES)
def test_loss_and_grads_match_reference(arch, remat):
    jcfg, tcfg, jp, batch, tb = _setup(arch)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(p, b, jcfg, backend="xla", remat=remat)))(
            jp, batch)
    tl, tg = TTR.value_and_grad(
        lambda p, b: tapi.loss_fn(p, b, tcfg, remat=remat),
        convert.from_reference(jax.tree.map(np.asarray, jp)), tb)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    want = T.leaves(convert.from_reference(jax.tree.map(np.asarray, jg)))
    total = float(torch.sqrt(sum(w.double().square().sum() for w in want)))
    assert len(tg) == len(want)
    for i, (a, b) in enumerate(zip(tg, want)):
        err = float((a.double() - b.double()).norm())
        assert err <= 1e-4 * float(b.double().norm()) + 1e-6 * total, \
            f"{arch} grad leaf {i}: {err:.3g}"


def test_moe_aux_loss_enters_the_loss():
    """granite's loss is the cross entropy plus 0.01 times the aux loss
    summed over layers, as the reference's."""
    from repro.models import lm as JLM
    from repro_torch.models import lm as TLM

    jcfg, tcfg, jp, batch, tb = _setup("granite-moe-1b-a400m")
    _, jaux = JLM.lm_forward(jp, batch["tokens"], jcfg, backend="xla")
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    logits, aux = TLM.lm_forward_aux(tp, tb["tokens"], tcfg)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(aux) > 0
    loss = tapi.loss_fn(tp, tb, tcfg)
    ce = TLM.cross_entropy(logits, tb["labels"])
    assert float(loss) == pytest.approx(float(ce + 0.01 * aux), rel=1e-6)


def test_grad_guard_flash_attention():
    jcfg, tcfg, jp, batch, tb = _setup("granite-moe-1b-a400m")
    # the reference cannot differentiate its flash kernel either
    with pytest.raises(Exception):
        jax.value_and_grad(japi.loss_fn)(
            jp, batch, jcfg.with_(attn_impl="flash_interpret"),
            backend="xla")
    fcfg = tcfg.with_(attn_impl="flash")
    tp = convert.from_reference(jax.tree.map(np.asarray, jp))
    with pytest.raises(RuntimeError, match="flash_attention.*requires grad"):
        TTR.value_and_grad(lambda p, b: tapi.loss_fn(p, b, fcfg), tp, tb)
    with torch.no_grad():
        assert torch.isfinite(tapi.loss_fn(tp, tb, fcfg))
    # grad mode on but nothing requiring grad: the forward runs too
    assert torch.isfinite(tapi.loss_fn(tp, tb, fcfg))


def test_grad_guard_quantized_weight():
    jcfg, tcfg, jp, batch, tb = _setup("codellama-7b")
    wq = jp["layers"]["mixer"]["wq"]["w"]
    jq = dict(jp, layers=dict(jp["layers"], mixer=dict(
        jp["layers"]["mixer"], wq={"w": JQ.quantize(wq, 16)})))
    with pytest.raises(TypeError):
        jax.value_and_grad(japi.loss_fn)(jq, batch, jcfg, backend="xla")
    tp = convert.from_reference(jax.tree.map(np.asarray, jq))
    with pytest.raises(RuntimeError, match="w4a16_matmul.*requires grad"):
        TTR.value_and_grad(lambda p, b: tapi.loss_fn(p, b, tcfg), tp, tb)
    with torch.no_grad():
        assert torch.isfinite(tapi.loss_fn(tp, tb, tcfg))
