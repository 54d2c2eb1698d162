"""Multi-pod dry-run on fake ranks (port of ``repro/launch/dryrun.py``):
every (arch × shape × mesh) cell's step runs on meta tensors, so nothing is
computed or allocated, and its roofline terms come out.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

Each cell makes two passes:

1. ``launch/op_cost.py`` counts FLOPs and bytes over the UNSHARDED step
   (global numbers, the reference's pre-partitioning jaxpr), with the mesh
   installed as the hint mesh, so the MoE dispatches in blocks as the
   reference's traced step does;
2. params, optimizer state, cache and batch become meta ``DTensor`` s on a
   fake process group of 256 (512) ranks with the rules' placements
   (``sharding/rules.py``), and the step runs under
   ``launch/comm_bytes.py``, which sums the collectives ``DTensor``'s
   sharding propagation runs (GSPMD's part in the reference).

A train cell counts one microbatch and multiplies by the microbatch count:
the reference scans its microbatches and its cost walk multiplies by the
trip count; layers and remat need no multiplier (a Python loop).  Memory
per device is the bytes of the arguments' local shards; there is no
counterpart of XLA's temp bytes, and the record leaves them ``None``.  A
step that dispatches more than a pass's op budget is recorded as FAIL with
that reason, as is any error (an op ``DTensor`` has no sharding strategy
for, among them).  Results are cached as JSON per cell under
``results/dryrun_torch/``; reruns skip completed cells.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree as T
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import (SHAPES, SHAPES_BY_NAME, QuantConfig,
                                     TrainConfig)
from repro_torch.core.apply import quantize_params
from repro_torch.launch import comm_bytes as CB
from repro_torch.launch import op_cost as OC
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (axis_sizes, make_fake_mesh,
                                     production_shape)
from repro_torch.models import api
from repro_torch.optim import adamw
from repro_torch.sharding import hints, rules
from repro_torch.train import trainer

# the reference's ten assigned archs (the codellama configs are extras)
ASSIGNED = tuple(a for a in ARCH_IDS if not a.startswith("codellama"))
# ops a pass may dispatch before the cell is recorded as FAIL
OP_BUDGET = 3_000_000
SHARD_OP_BUDGET = 4_000_000


class SkipCell(Exception):
    pass


class OpBudget(RuntimeError):
    pass


class _Budget(TorchDispatchMode):
    """Raises :class:`OpBudget` past ``limit`` dispatched ops."""

    def __init__(self, limit: int):
        super().__init__()
        self.limit, self.n = limit, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        if self.n > self.limit:
            raise OpBudget(f"the step dispatches more than {self.limit} ops "
                           "in one pass")
        return func(*args, **(kwargs or {}))


_aten = torch.ops.aten
_WRITES = {_aten.index_put_.default, _aten.index_copy_.default,
           _aten._index_put_impl_.default, _aten.index_add_.default,
           _aten.scatter_add_.default}


class _Fallback(TorchDispatchMode):
    """What GSPMD partitions and ``DTensor`` refuses, done as GSPMD would
    on the meta step: a gather along a sharded (or partial) dim is a masked
    gather and an all-reduce (:func:`_masked_gather`); an index write into
    a sharded tensor, or a slice copy ``DTensor`` refuses, lands where the
    rows live (:meth:`_write`: the updates gathered, nothing written, the
    tensors are meta); an in-place op on a plain tensor the step made gets
    its sharded operands gathered; the embedding's masked partial is
    reduced where it is made; and any other op whose sharding propagation
    fails (a view that splits a sharded dim unevenly) has its operands
    gathered, one sharded mesh dim at a time, until it runs.  The
    collectives go through the counter below this mode; ``used`` counts
    each op that needed this."""

    def __init__(self):
        super().__init__()
        self.used = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor, Replicate

        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        if func is _aten.gather.default and isinstance(args[0], DTensor) \
                and any(p.is_shard(args[1] % args[0].ndim) or p.is_partial()
                        for p in args[0].placements):
            self.used[str(func)] = self.used.get(str(func), 0) + 1
            return _masked_gather(*args)
        if func is _aten.copy_.default:
            # a slice write (a prefill's rows into the cache the step makes,
            # which the reference's out_shardings lay out as the rows): each
            # rank writes the rows it holds, no collective
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError, AssertionError):
                self.used[str(func)] = self.used.get(str(func), 0) + 1
                return args[0]
        if isinstance(args[0], torch.Tensor) \
                and not isinstance(args[0], DTensor) \
                and func._schema.arguments[0].is_write:
            # an in-place op on a tensor the step made itself (a counter,
            # a slot map) from sharded operands: gather them
            self.used[str(func)] = self.used.get(str(func), 0) + 1

            def full(a):
                if isinstance(a, (list, tuple)):
                    return type(a)(full(t) for t in a)
                return a.full_tensor() if isinstance(a, DTensor) else a

            return func(*(full(a) for a in args), **kwargs)
        if func in _WRITES and isinstance(args[0], DTensor):
            self.used[str(func)] = self.used.get(str(func), 0) + 1
            return self._write(args)
        if func is _aten.embedding.default:
            # a vocab-sharded lookup leaves a masked partial sum that DTensor
            # can reduce only once: reduce it where it is made, as GSPMD's
            # masked gather does
            out = func(*args, **kwargs)
            pl = [Replicate() if p.is_partial() else p for p in out.placements]
            return out.redistribute(out.device_mesh, pl)
        while True:
            try:
                return func(*args, **kwargs)
            except (RuntimeError, NotImplementedError) as e:
                # a sharding propagation failure, or a view whose sharded
                # dim DTensor splits unevenly across more ranks than rows
                if "shard" not in str(e).lower() \
                        and "invalid for input of size" not in str(e):
                    raise
                name = str(func)
                self.used[name] = self.used.get(name, 0) + 1
                args, done = self._gather_one(args, DTensor, Replicate)
                if not done:
                    raise

    @staticmethod
    def _write(args):
        """An index or slice write into a sharded tensor lands where its
        rows live (GSPMD's partitioned scatter): the indices and updates
        are gathered, the target keeps its placements."""
        from torch.distributed.tensor import DTensor, Replicate

        for a in args[1:]:
            for t in (a if isinstance(a, (list, tuple)) else (a,)):
                if isinstance(t, DTensor):
                    t.redistribute(t.device_mesh,
                                   [Replicate()] * t.device_mesh.ndim)
        return args[0]

    @staticmethod
    def _gather_one(args, DTensor, Replicate):
        """``args`` with the last non-replicated mesh dim of the first
        ``DTensor`` that has one replicated; (args, whether one was)."""
        out = list(args)
        for i, a in enumerate(out):
            if isinstance(a, DTensor):
                pl = list(a.placements)
                for d in reversed(range(len(pl))):
                    if not pl[d].is_replicate():
                        pl[d] = Replicate()
                        out[i] = a.redistribute(a.device_mesh, pl)
                        return tuple(out), True
        return tuple(out), False


def _masked_gather(x, dim, index, sparse_grad=False):
    """``gather`` along a dim ``x`` shards (a vocab-sharded cross-entropy's
    gold logit): each rank gathers the rows it holds and the partial sums
    are all-reduced, GSPMD's masked gather; ``DTensor``'s own masked
    partial takes 2-D inputs only."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    dim %= x.ndim
    mesh = x.device_mesh
    if any(p.is_partial() for p in x.placements):   # reduce-scatter first
        x = x.redistribute(mesh, [Shard(dim) if p.is_partial() else p
                                  for p in x.placements])
    idx_pl = [Replicate() if p.is_shard(dim) or p.is_partial() else p
              for p in x.placements]
    if isinstance(index, DTensor):
        index = index.redistribute(mesh, idx_pl)
        local = index.to_local()
    else:
        local = index
    out_pl = [Partial() if p.is_shard(dim) else p for p in idx_pl]
    out = DTensor.from_local(torch.empty(local.shape, dtype=x.dtype,
                                         device="meta"), mesh, out_pl,
                             run_check=False, shape=index.shape,
                             stride=index.stride())
    return out.redistribute(mesh, idx_pl)


class Cell:
    """One built cell: ``parts`` is a list of (fn, args, specs, repeat) the
    step is made of (a train step: one microbatch's gradients, repeated,
    then the update); ``args`` are meta tensors, ``specs`` their spec
    trees."""

    def __init__(self, parts, meta, cfg, shape, fp_params, w_tree, w_reads,
                 step_args=None):
        self.parts, self.meta = parts, meta
        # the step's own arguments and their specs (the reference's jitted
        # step's), for the bytes a device holds: the parts' unless given
        self.step_args = step_args or parts[0][1:3]
        self.cfg, self.shape = cfg, shape
        self.fp_params, self.w_tree, self.w_reads = fp_params, w_tree, w_reads


def build_cell(arch: str, shape_name, mesh, *, quantized: bool = True,
               train_cfg: TrainConfig | None = None,
               kv_quant: bool = False, smoke: bool = False) -> Cell:
    """One cell's parts on meta tensors; ``shape_name`` names one of
    ``SHAPES`` or is a ``ShapeConfig`` (``smoke`` takes the smoke config:
    the tests' cells)."""
    cfg = get_config(arch, smoke=smoke)
    if kv_quant:
        cfg = cfg.with_(kv_quant=True)
    shape = (SHAPES_BY_NAME[shape_name] if isinstance(shape_name, str)
             else shape_name)
    shape_name = shape.name
    ok, why = api.supports_shape(cfg, shape)
    if not ok:
        raise SkipCell(why)
    # microbatch so per-device live activations fit: one sample per data
    # row per microstep (global/16 grad-accum steps)
    tc = train_cfg or TrainConfig(
        remat="block", microbatch=max(1, shape.global_batch // 16))
    params = api.init_model(cfg, device="meta")
    batch = api.input_specs(cfg, shape)
    bspecs = rules.batch_specs(batch, mesh)
    if shape.kind == "train":
        n = tc.microbatch or 1
        pspecs = rules.param_specs(params, mesh, cfg)
        opt = adamw.init_opt_state(params, tc)
        ospecs = rules.opt_specs(opt, pspecs, mesh)
        mb = trainer._split_microbatches(batch, n)[0]
        loss_fn = trainer.make_loss_fn(cfg, tc)
        acc = T.map_leaves(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                                 device="meta"), params)

        def grads(params, mb, acc):
            return trainer.accumulate_microbatch(loss_fn, params, mb,
                                                 T.leaves(acc), n)

        def update(params, acc, opt):
            return adamw.adamw_update(params, acc, opt, tc)

        # the f32 gradient accumulators are sharded as the moments are
        # (ZeRO): each microbatch's data-partial gradients reduce-scatter
        # into them
        aspecs = rules.opt_specs(adamw.OptState(None, acc, acc), pspecs,
                                 mesh).mu
        parts = [(grads, (params, mb, acc),
                  (pspecs, rules.batch_specs(mb, mesh), aspecs), n),
                 (update, (params, acc, opt), (pspecs, aspecs, ospecs), 1)]
        meta = {"step": "train_step"}
        return Cell(parts, dict(meta, arch=arch, shape=shape_name,
                                quantized=False, microbatch=n),
                    cfg, shape, params, params, 3.0 * n,
                    step_args=((params, opt, batch),
                               (pspecs, ospecs, bspecs)))
    qparams = api.init_model(cfg, device="meta")
    if quantized:
        qparams = quantize_params(qparams, cfg, QuantConfig())[0]
    pspecs = rules.param_specs(qparams, mesh, cfg)
    if shape.kind == "prefill":
        smax = shape.seq_len

        def prefill(params, batch):
            return api.prefill_fn(params, batch, cfg, smax)

        parts = [(prefill, (qparams, batch), (pspecs, bspecs), 1)]
        meta = {"step": "prefill_step"}
    else:
        cache = api.cache_specs(cfg, shape)
        cspecs = rules.cache_specs_tree(cache, mesh)

        def serve(params, cache, batch):
            return api.decode_fn(params, batch, cache, cfg)

        parts = [(serve, (qparams, cache, batch), (pspecs, cspecs, bspecs),
                  1)]
        meta = {"step": "serve_step"}
    meta.update(arch=arch, shape=shape_name, quantized=quantized)
    return Cell(parts, meta, cfg, shape, params, qparams, 1.0)


def local_shape(shape, spec, mesh):
    """The local shard's shape of a tensor of ``shape`` under ``spec``."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, e in enumerate(spec):
        for a in (e if isinstance(e, tuple) else (e,) if e else ()):
            out[i] //= sizes[a]
    return out


def arg_bytes_per_device(args, specs, mesh) -> int:
    total = 0

    def add(t, spec):
        nonlocal total
        n = 1
        for d in local_shape(t.shape, spec, mesh):
            n *= d
        total += n * t.element_size()

    for a, s in zip(args, specs):
        rules.map_specs(add, a, s)
    return total


def to_dtensors(args, specs, mesh):
    """Meta ``DTensor`` s of ``args`` with the placements of ``specs``."""
    from torch.distributed.tensor import DTensor

    def one(t, spec):
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, rules.placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    return tuple(rules.map_specs(one, a, s) for a, s in zip(args, specs))


def cost_pass(cell: Cell, hint, budget: int | None = None):
    """Pass 1: global FLOPs and bytes of the unsharded step."""
    budget = budget or OP_BUDGET
    flops = nbytes = 0.0
    by_op, bytes_by_op = {}, {}
    with hints.hint_mesh(hint), _Budget(budget):
        for fn, args, _, rep in cell.parts:
            c = OC.op_cost(fn, *args)
            flops += rep * c["flops"]
            nbytes += rep * c["bytes"]
            for k, v in c["by_op"].items():
                by_op[k] = by_op.get(k, 0.0) + rep * v
            for k, v in c["bytes_by_op"].items():
                bytes_by_op[k] = bytes_by_op.get(k, 0.0) + rep * v
    return {"flops": flops, "bytes": nbytes, "by_op": by_op,
            "bytes_by_op": bytes_by_op}


def shard_pass(cell: Cell, mesh, budget: int | None = None):
    """Pass 2: per-device collective bytes by kind and by mesh axis, and
    the ops that needed :class:`_Fallback`'s gathers."""
    from torch.distributed.tensor.experimental import implicit_replication

    budget = budget or SHARD_OP_BUDGET
    by_kind, by_axis, fallbacks, by_op = {}, {}, {}, {}
    with hints.hint_mesh(mesh), implicit_replication():
        for fn, args, specs, rep in cell.parts:
            dargs = to_dtensors(args, specs, mesh)
            with _Budget(budget), CB.CommBytes() as cb, _Fallback() as fb:
                fn(*dargs)
            for k, v in cb.bytes.items():
                by_kind[k] = by_kind.get(k, 0.0) + rep * v
            for k, v in cb.by_axis(mesh).items():
                by_axis[k] = by_axis.get(k, 0.0) + rep * v
            for k, v in fb.used.items():
                fallbacks[k] = fallbacks.get(k, 0) + rep * v
            for k, v in cb.by_op.items():
                by_op[k] = by_op.get(k, 0.0) + rep * v
    return by_kind, by_axis, fallbacks, by_op


def run_cell(arch: str, shape_name, mesh_kind: str, out_dir: Path,
             *, force: bool = False, quantized: bool = True, tag: str = "",
             kv_quant: bool = False, mesh_shape=None,
             smoke: bool = False) -> dict:
    """Build, count and record one cell (``mesh_shape``: a
    ``launch.mesh.MeshShape`` in place of ``mesh_kind``'s production
    shape)."""
    if not isinstance(shape_name, str):
        shape_cfg, shape_name = shape_name, shape_name.name
    else:
        shape_cfg = shape_name
    name = f"{arch}__{shape_name}__{mesh_kind}" + (f"__{tag}" if tag else "")
    out_path = out_dir / f"{name}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())

    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag}
    t0 = time.time()
    try:
        shape = mesh_shape or production_shape(mesh_kind == "multi")
        cell = build_cell(arch, shape_cfg, shape, quantized=quantized,
                          kv_quant=kv_quant, smoke=smoke)
        rec.update(cell.meta)
        cost = cost_pass(cell, shape)
        t1 = time.time()
        mesh = make_fake_mesh(shape)
        coll, coll_axis, fallbacks, coll_op = shard_pass(cell, mesh)
        t2 = time.time()
        chips = shape.size
        args_b = arg_bytes_per_device(*cell.step_args, shape)
        wsb = RL.weight_stream_bytes(cell.w_tree) * cell.w_reads
        ntot, nemb = RL.count_params(cell.fp_params)
        mf = RL.model_flops_estimate(cell.cfg, cell.shape, ntot, nemb)
        sizes = axis_sizes(shape)
        link = RL.axis_link_bw(sizes)
        for key in coll_axis:   # a group over several axes: its slowest
            link.setdefault(key, min(link[a] for a in key.split("+")))
        rl = RL.Roofline(flops=cost["flops"], hbm_bytes=cost["bytes"],
                         coll_bytes=sum(coll.values()) * chips, chips=chips,
                         model_flops=mf, weight_stream_bytes=wsb,
                         model_shards=sizes["model"],
                         coll_by_axis={a: b * chips
                                       for a, b in coll_axis.items()},
                         link_bw=link)
        rec.update(
            ok=True, cost_s=round(t1 - t0, 1), shard_s=round(t2 - t1, 1),
            chips=chips, cost_op_global=cost,
            memory={"argument_size_in_bytes": args_b,
                    "temp_size_in_bytes": None},
            collectives_per_device=coll,
            collectives_per_device_by_axis=coll_axis,
            collectives_per_device_by_op=coll_op,
            gather_fallbacks=fallbacks,
            n_params=ntot, n_embed_params=nemb, roofline=rl.to_dict())
    except SkipCell as e:
        rec.update(ok=True, skipped=True, reason=str(e))
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-3000:])
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--fp16-weights", action="store_true",
                    help="serve cells with unquantized weights (ablation)")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = ASSIGNED if (args.all or not args.arch) else [args.arch]
    shapes = ([s.name for s in SHAPES] if (args.all or not args.shape)
              else [args.shape])
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    n_ok = n_fail = 0
    for mk in meshes:
        for a in archs:
            for s in shapes:
                rec = run_cell(a, s, mk, out_dir, force=args.force,
                               tag=args.tag, kv_quant=args.kv_quant,
                               quantized=not args.fp16_weights)
                status = ("SKIP" if rec.get("skipped")
                          else "OK" if rec.get("ok") else "FAIL")
                extra = ""
                if rec.get("ok") and not rec.get("skipped"):
                    rl = rec["roofline"]
                    extra = (f" bottleneck={rl['bottleneck']}"
                             f" frac={rl['roofline_fraction']:.3f}"
                             f" cost={rec['cost_s']}s shard={rec['shard_s']}s")
                elif not rec.get("ok"):
                    extra = " " + rec.get("error", "")[:120]
                print(f"[{status}] {a} × {s} × {mk}{extra}", flush=True)
                n_ok += rec.get("ok", False)
                n_fail += not rec.get("ok", False)
    print(f"done: {n_ok} ok, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
