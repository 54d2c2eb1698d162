"""Op list of a dense decoder block (GQA attention, then a SwiGLU or GELU
MLP): the 4-bit projections every token goes through, ``(name, Ci,
Co)``."""


def w4_linears(m: dict):
    d, h, hkv = m["d_model"], m["num_heads"], m["num_kv_heads"]
    dh = m.get("head_dim") or d // h
    f = m["d_ff"]
    out = [("wq", d, h * dh), ("wk", d, hkv * dh), ("wv", d, hkv * dh),
           ("wo", h * dh, d)]
    if m.get("mlp", "swiglu") == "swiglu":
        out += [("gate", d, f), ("up", d, f)]
    else:
        out += [("up", d, f)]
    return out + [("down", f, d)]


def expert_linears(m: dict):
    """No routed experts: ``(experts, experts per token, [(name, Ci,
    Co)])``."""
    return 0, 0, []


def fp_linears(m: dict):
    """Unquantized projections inside a block, ``(name, Ci, Co)``."""
    return []
