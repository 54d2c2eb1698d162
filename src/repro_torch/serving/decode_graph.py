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
only.  A replay runs no Python, so the wrappers' launch counters see the
capture only: the graph takes back the warm-up's and the capture's launches
and adds the launches of one step at every replay.
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import kernels as K
from repro_torch.serving.kv_cache import TRASH_PAGE


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """One stream per device for every engine's warm-up and capture: each
    new stream that runs a cuBLAS call gets a cuBLAS workspace that lives as
    long as the process."""
    return torch.cuda.Stream(device)


class DecodeGraph:
    """One captured decode step: ``step(token[B, 1], position[B],
    table[B, P])`` → logits ``[B, V]``, writing the pools in place."""

    def __init__(self, step: Callable, batch: int, pages: int,
                 device: torch.device):
        self.step = step
        self.device = device
        self.token = torch.zeros(batch, 1, dtype=torch.int32, device=device)
        self.position = torch.zeros(batch, dtype=torch.int32, device=device)
        self.table = torch.zeros(batch, pages, dtype=torch.int32,
                                 device=device)
        self._host = [torch.zeros(t.shape, dtype=t.dtype, pin_memory=True)
                      for t in (self.token, self.position, self.table)]
        self._copied: Optional[torch.cuda.Event] = None  # host copies read
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.logits: Optional[torch.Tensor] = None
        self.per_replay: dict = {}      # kernel launches of one replay
        self.replays = 0

    def _capture(self) -> None:
        before = K.launch_counts()
        self.token.zero_()
        self.position.zero_()
        self.table.fill_(TRASH_PAGE)
        cur = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.step(self.token, self.position, self.table)
        cur.wait_stream(side)
        warm = K.launch_counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            self.logits = self.step(self.token, self.position, self.table)
        after = K.launch_counts()
        self.per_replay = {n: after[n] - warm[n] for n in after}
        K.add_launch_counts({n: before[n] - after[n] for n in after})
        self.graph = graph

    def __call__(self, token: np.ndarray, position: np.ndarray,
                 table: np.ndarray) -> torch.Tensor:
        """Replay the step on these inputs (capturing it first on the first
        call); the logits stay valid until the next call."""
        if self.graph is None:
            self._capture()
        if self._copied is not None:
            self._copied.synchronize()    # the last step's copies are done
        for host, dev, a in zip(self._host,
                                (self.token, self.position, self.table),
                                (token, position, table)):
            host.numpy()[...] = a
            dev.copy_(host, non_blocking=True)
        self._copied = torch.cuda.Event()
        self._copied.record()
        self.graph.replay()
        K.add_launch_counts(self.per_replay)
        self.replays += 1
        return self.logits
