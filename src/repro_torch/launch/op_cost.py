"""Analytic op cost of one step (port of ``repro/launch/jaxpr_cost.py``).

:class:`OpCost` is a ``TorchDispatchMode``: run a step under it, on meta
tensors (nothing is computed or allocated), and it counts every ATen op the
step dispatches, as the reference walks the step's jaxpr:

- FLOPs: ``mm`` / ``bmm`` / ``addmm`` / ``baddbmm`` (and ``mv`` / ``dot``)
  at ``2·batch·m·n·k``; a two-operand ``torch.einsum`` that contracts
  nothing (an outer or batched product, which PyTorch runs as ``mul``) as
  the dot JAX lowers it to, ``2 · output elements``; a convolution at ``2 · out elements · kernel
  elements past the first two dims``, and 1 flop an element for the
  elementwise set;
- bytes only at materialisation points: dot operands (at their effective
  width, below) and results, gathers and index reads ×2 of their output,
  and index writes / scatters / copies into a slice ×2 of their update;
  fused elementwise chains are not counted.

The effective stream width of a tensor propagates through the fusible
chains (casts, ``mul`` / ``add`` / ``sub``, views, ``clone``, ``cat``): a
cast chain from an int8 source streams 1 B an element, and the nibble ops
(``&``, ``|``, ``>>`` on a byte tensor) halve it, so a dequantized int4
weight reaches its dot at 0.5 B an element.  One deliberate difference: a
float counts at the width the card reads, not capped at 2 bytes as the
reference caps it for a TPU that fuses f32 converts (the port serves f32
on the H100).

The port's layers are a Python loop and ``torch.utils.checkpoint``
recomputes a block's forward inside the backward, so layers and remat are
counted as they run: no trip-count multiplier.  The numbers are GLOBAL
when the step runs on unsharded tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.weak import WeakIdKeyDictionary

DOTS = {"mm", "bmm", "addmm", "baddbmm", "mv", "dot"}
#: every op name whose FLOPs are dot FLOPs (the reference's dot_general)
DOT_NAMES = DOTS | {"einsum"}
FLOP_ELEMENTWISE = {
    "add", "mul", "sub", "div", "maximum", "minimum", "exp", "log", "tanh",
    "sigmoid", "rsqrt", "sqrt", "pow",
}
# ops through which the effective stream width propagates (they fuse into
# the consumer: a cast/mul chain from an int8 source streams 1 B/elt)
_CHAIN = {
    "_to_copy", "mul", "add", "sub", "expand", "view", "_unsafe_view",
    "reshape", "permute", "transpose", "t", "squeeze", "unsqueeze",
    "clone", "cat", "alias", "detach",
}
# nibble unpack: lo/hi halves share one packed-byte read → width halves
_NIBBLE = {"bitwise_and", "bitwise_or", "bitwise_right_shift", "__rshift__",
           "__and__", "__or__"}
GATHERS = {"index", "index_select", "gather", "embedding"}
WRITES = {"index_put", "index_copy", "index_add", "scatter", "scatter_add",
          "index_fill", "masked_scatter"}


def _name(func) -> str:
    n = func._overloadpacket.__name__
    return n[:-1] if n.endswith("_") and not n.startswith("__") else n


def _numel(t: torch.Tensor) -> int:
    return t.numel()


def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x):
    return [a for a in tree_flatten(x)[0] if isinstance(a, torch.Tensor)]


def _dot_flops(name: str, args) -> int:
    if name in ("addmm", "baddbmm"):
        args = args[1:]
    a, b = args[0], args[1]
    if name == "dot":
        return 2 * a.shape[0]
    if name == "mv":
        return 2 * a.shape[0] * a.shape[1]
    batch = a.shape[0] if name in ("bmm", "baddbmm") else 1
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    return 2 * batch * m * n * k


class OpCost(TorchDispatchMode):
    """Counts FLOPs and materialised bytes of every op dispatched under
    it (see the module docstring); ``by_op`` holds FLOPs and
    ``bytes_by_op`` bytes for each op name."""

    def __init__(self):
        super().__init__()
        self._quiet = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op: Dict[str, float] = {}
        self.bytes_by_op: Dict[str, float] = {}
        self._eff = WeakIdKeyDictionary()

    def _base(self, t: torch.Tensor) -> float:
        return float(t.element_size())

    def eff(self, t: torch.Tensor) -> float:
        """The effective stream width of ``t`` in bytes an element."""
        return self._eff.get(t, self._base(t))

    def _add(self, name: str, flops: float, nbytes: float) -> None:
        if self._quiet:
            return
        self.flops += flops
        self.bytes += nbytes
        if flops:
            self.by_op[name] = self.by_op.get(name, 0.0) + flops
        if nbytes:
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nbytes

    def _io_bytes(self, ins, outs) -> float:
        return (sum(_numel(t) * self.eff(t) for t in ins)
                + sum(_bytes(t) for t in outs))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        try:
            name = _name(func)
        except AttributeError:       # higher-order ops carry no packet
            return out
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        o0 = outs[0] if outs else None
        if name in _CHAIN and o0 is not None and ins:
            same = [self.eff(t) for t in ins if t.shape == o0.shape]
            effs = same or [self.eff(t) for t in ins]
            self._eff[o0] = min(min(effs), self._base(o0))
        elif name in _NIBBLE and o0 is not None and ins \
                and ins[0].element_size() == 1:
            self._eff[o0] = min(self.eff(t) for t in ins) / 2.0
        if name in DOTS:
            mats = ins[1:3] if name in ("addmm", "baddbmm") else ins[:2]
            self._add(name, _dot_flops(name, args),
                      self._io_bytes(mats, outs))
        elif name == "convolution":
            ker = args[1]
            flops = 2 * _numel(o0) * int(torch.Size(ker.shape[2:]).numel())
            self._add(name, flops, self._io_bytes(ins, outs))
        elif name in GATHERS:
            self._add(name, 0, 2 * sum(_bytes(t) for t in outs))
        elif name in WRITES:
            self._add(name, 0, 2 * _bytes(ins[-1]))
        elif name == "copy" and args[0]._is_view():
            self._add("copy_slice", 0, 2 * _bytes(args[1]))
        elif name in FLOP_ELEMENTWISE and o0 is not None:
            self._add(name, _numel(o0), 0)
        return out


def _outer_einsum(eq: str, n_ops: int) -> bool:
    """A two-operand einsum whose every input index reaches the output."""
    if n_ops != 2 or "..." in eq or "->" not in eq:
        return False
    ins, out = eq.replace(" ", "").split("->")
    return set(ins.replace(",", "")) <= set(out)


def _counted_einsum(cost: OpCost, einsum):
    """``torch.einsum`` that counts an outer product (see
    :func:`_outer_einsum`) as one dot of ``cost``, its inner ``mul`` left
    out, and each of its gradients as one more.  It replaces
    ``torch.einsum`` itself while :func:`op_cost` runs, so that the
    recomputed forward of a checkpointed block, which runs with no
    ``TorchFunctionMode``, is counted too."""

    def counted(eq, *ops):
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        if not isinstance(eq, str) or not _outer_einsum(eq, len(ops)):
            return einsum(eq, *ops)
        cost._quiet += 1
        try:
            out = einsum(eq, *ops)
        finally:
            cost._quiet -= 1
        cost._add("einsum", 2 * _numel(out), cost._io_bytes(ops, [out]))
        grads = [t for t in ops if t.requires_grad]
        if grads and out.requires_grad:
            # the backward's products: one dot per operand that takes a
            # gradient (JAX transposes a dot into dots; PyTorch's mul
            # backward is mul and sum)
            def backward_dots(g, n=_numel(out)):
                cost._add("einsum", 2 * n * len(grads),
                          sum(cost._io_bytes([g, t], [t]) for t in grads))

            out.register_hook(backward_dots)
        return out

    return counted


def op_cost(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` under :class:`OpCost`; returns
    ``{"flops", "bytes", "by_op", "bytes_by_op", "out"}``."""
    c = OpCost()
    einsum = torch.einsum
    torch.einsum = _counted_einsum(c, einsum)
    try:
        with c:
            out = fn(*args, **kwargs)
    finally:
        torch.einsum = einsum
    return {"flops": c.flops, "bytes": c.bytes, "by_op": dict(c.by_op),
            "bytes_by_op": dict(c.bytes_by_op), "out": out}
