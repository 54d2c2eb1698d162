"""The feed-forward part of a MoE decoder block: a softmax router, the
top-k experts by probability (lower index first on ties), their weights
renormalized to sum 1, every routed token computed (no capacity drop),
each a SwiGLU expert."""
import torch
import torch.nn.functional as F

from perfbench.reference.model import lin, linear_shapes


def mlp_shapes(m: dict):
    d, e, fe = m["d_model"], m["moe"]["num_experts"], m["moe"]["d_expert"]
    return {**linear_shapes("mlp.router", d, e, False),
            "mlp.experts.gate": (e, d, fe), "mlp.experts.up": (e, d, fe),
            "mlp.experts.down": (e, fe, d)}


def mlp(m, w, x, pr):
    moe = m["moe"]
    k = moe["top_k"]
    probs = torch.softmax(lin(w, "mlp.router", x, pr), dim=-1)
    gw, ge = torch.sort(probs, dim=-1, descending=True, stable=True)
    gw, ge = gw[:, :k], ge[:, :k]
    gw = gw / torch.clamp_min(gw.sum(-1, keepdim=True), 1e-9)
    y = torch.zeros_like(x)
    for e in range(moe["num_experts"]):
        tok, slot = torch.nonzero(ge == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        hid = (F.silu(pr.mm(xe, w["mlp.experts.gate"][e]))
               * pr.mm(xe, w["mlp.experts.up"][e]))
        y.index_add_(0, tok, pr.mm(hid, w["mlp.experts.down"][e])
                     * gw[tok, slot][:, None])
    return y
