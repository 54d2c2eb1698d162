"""The feed-forward part of a dense decoder block: the SwiGLU MLP or the
GELU (tanh) MLP, with biases where the configuration has ``attn_bias``."""
import torch.nn.functional as F

from perfbench.reference.model import lin, linear_shapes


def mlp_shapes(m: dict):
    d, f, b = m["d_model"], m["d_ff"], bool(m.get("attn_bias", False))
    if m.get("mlp", "swiglu") == "swiglu":
        return {**linear_shapes("mlp.gate", d, f, False),
                **linear_shapes("mlp.up", d, f, False),
                **linear_shapes("mlp.down", f, d, False)}
    return {**linear_shapes("mlp.up", d, f, b),
            **linear_shapes("mlp.down", f, d, b)}


def mlp(m, w, x, pr):
    if m.get("mlp", "swiglu") == "swiglu":
        return lin(w, "mlp.down", F.silu(lin(w, "mlp.gate", x, pr))
                   * lin(w, "mlp.up", x, pr), pr)
    return lin(w, "mlp.down", F.gelu(lin(w, "mlp.up", x, pr),
                                     approximate="tanh"), pr)
