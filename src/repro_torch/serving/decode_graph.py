"""The engine's decode step as one CUDA graph (port of the reference's
jitted, pool-donating ``_decode``, ``repro/serving/engine.py``).

The step has static shapes: all B rows launch, rows that do not decode point
at the trash page, and every kernel writes the pools in place.  So it is
captured once per engine and replayed: before each replay the token,
position and table tensors the graph reads are filled in place from pinned
host copies, and the logits come out in the graph's own output tensor.
Sampling stays outside the graph.

Capture happens at the first decode step, after one eager warm-up on a side
stream that fills the lazy state the step reads (the built kernel libraries,
the rope tables, the SM count).  During warm-up and capture every row points
at the trash page (position 0, token 0), so their dummy writes land in page 0
only.  The state leaves add named inputs, filled the same way before each
replay and all zero during warm-up and capture.  A hybrid stack's step
reads an ``active[B]`` mask and updates the fixed-rows state it holds in
place; an SSM recurrence has no trash page, so warm-up and capture run with
every row inactive and leave every slot's state as it was.  An
encoder-decoder's step reads each row's encoder page table and valid
encoder rows (``enc_table[B, P]``, ``enc_len[B]``); warm-up and capture
point them at the trash page with 0 rows, which the model clamps to one
masked zero row, so the softmax stays finite.  A replay runs no Python, so
the wrappers' launch counters see the capture only: the graph takes back
the warm-up's and the capture's launches and adds the launches of one step
at every replay.  A call stages its inputs and replays in the engine's host
phases ``decode.stage`` and ``decode.launch`` (``serving/trace.py:span``),
counted into the enclosing engine step; the wait for the last step's input
copies is the span ``sync.decode.copied``.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.serving.kv_cache import TRASH_PAGE
from repro_torch.serving.trace import ENCLOSING, span


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One stream per device for every engine's warm-up and capture: each
    new stream that runs a cuBLAS call gets a cuBLAS workspace that lives as
    long as the process."""
    return torch.cuda.Stream(device)


class DecodeGraph:
    """One captured decode step: ``step(token[B, 1], position[B],
    table[B, P], *extra)`` → logits ``[B, V]``, writing the pools (and a
    hybrid stack's fixed rows) in place.  ``extra`` maps each further input's
    name to its (shape, dtype), in the step's argument order."""

    def __init__(self, step: Callable, batch: int, pages: int,
                 device: torch.device, extra: dict):
        self.step = step
        self.device = device
        self.token = torch.zeros(batch, 1, dtype=torch.int32, device=device)
        self.position = torch.zeros(batch, dtype=torch.int32, device=device)
        self.table = torch.zeros(batch, pages, dtype=torch.int32,
                                 device=device)
        self.extra = {n: torch.zeros(shape, dtype=dt, device=device)
                      for n, (shape, dt) in extra.items()}
        self._host = [torch.zeros(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in self.inputs]
        self._copied: Optional[torch.cuda.Event] = None  # host copies read
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.per_replay: dict = {}      # kernel launches of one replay
        self.replays = 0

    @property
    def inputs(self) -> tuple:
        """The graph's input tensors, in the step's argument order."""
        return (self.token, self.position, self.table,
                *self.extra.values())

    def _capture(self) -> None:
        before = K.launch_counts()
        self.token.zero_()
        self.position.zero_()
        self.table.fill_(TRASH_PAGE)
        for t in self.extra.values():   # no row active, page 0 (the trash
            t.zero_()                   # page), 0 encoder rows
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(*self.inputs)
        cur.wait_stream(side)
        warm = K.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self.logits = self.step(*self.inputs)
        after = K.launch_counts()
        self.per_replay = {n: after[n] - warm[n] for n in after}
        K.add_launch_counts({n: before[n] - after[n] for n in after})
        self.graph = graph

    def __call__(self, *arrays: np.ndarray) -> torch.Tensor:
        """Replay the step on these host inputs, in :attr:`inputs` order
        (capturing it first on the first call); the logits stay valid until
        the next call."""
        if self.graph is None:
            with span("engine.decode.launch", ENCLOSING, key="decode.launch"):
                self._capture()
        with span("engine.decode.stage", ENCLOSING, key="decode.stage"):
            if self._copied is not None:
                # the last step's copies are done
                with span("sync.decode.copied", ENCLOSING):
                    self._copied.synchronize()
            for host, dev, a in zip(self._host, self.inputs, arrays,
                                    strict=True):
                host.numpy()[...] = a
                dev.copy_(host, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        with span("engine.decode.launch", ENCLOSING, key="decode.launch"):
            self.graph.replay()
        K.add_launch_counts(self.per_replay)
        self.replays += 1
        return self.logits
