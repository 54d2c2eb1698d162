"""Op list of a MoE decoder block (GQA attention, then a softmax router over
SwiGLU experts, top-k).  The attention projections are 4-bit and every token
goes through them; each token goes through its top-k experts' 4-bit
``gate``, ``up`` and ``down``; the router stays f32."""
from perfbench.roofline import dense


def w4_linears(m: dict):
    return [op for op in dense.w4_linears(m)
            if op[0] in ("wq", "wk", "wv", "wo")]


def expert_linears(m: dict):
    moe = m["moe"]
    d, fe = m["d_model"], moe["d_expert"]
    return moe["num_experts"], moe["top_k"], [
        ("gate", d, fe), ("up", d, fe), ("down", fe, d)]


def fp_linears(m: dict):
    return [("router", m["d_model"], m["moe"]["num_experts"])]
