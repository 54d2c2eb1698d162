"""The system under test, as the benchmark drives it: ``repro_torch``'s
serving engine over seeded weights quantized by the port's RTN.

This is the one harness module that imports the program.  The weights'
tree shape is the one ``api.init_model(cfg, device="meta")`` declares; each
group of leaves is filled by ``harness.weights`` on the device and each
layer is quantized in place by ``core.apply.rtn_baseline`` as soon as it is
made, so the set-up peak stays near the served size.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from perfbench.harness.weights import make_group


def model_config(config: dict):
    """The port's ``ModelConfig`` from a configuration file's ``model``."""
    from repro_torch.configs.base import MoEConfig, ModelConfig

    m = dict(config["model"])
    if m.get("moe"):
        m["moe"] = MoEConfig(**m["moe"])
    return ModelConfig(**m).check()


def _flatten(node, prefix: str = "") -> Dict[str, Any]:
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out.update(_flatten(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: node}


def _unflatten(flat: Dict[str, Any]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split(".")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def weight_groups(meta) -> Dict[str, Dict[str, Tuple[int, ...]]]:
    """The meta tree's leaves by weight group: ``embed``, ``head`` (final
    norm and output projection) and ``layers.<i>`` (paths relative to the
    layer), each ``{dotted path: shape}``."""
    groups: Dict[str, Dict[str, Tuple[int, ...]]] = {}
    for key, node in meta.items():
        if key == "layers":
            for i, layer in enumerate(node):
                groups[f"layers.{i}"] = {p: tuple(t.shape) for p, t in
                                         _flatten(layer).items()}
            continue
        g = "embed" if key == "embed" else "head"
        groups.setdefault(g, {}).update(
            {p: tuple(t.shape) for p, t in _flatten(node, f"{key}.").items()})
    return groups


@torch.no_grad()
def build_params(config: dict, cfg, seed: int, device):
    """Seeded f32 weights in the port's tree, every layer quantized to
    4-bit codes (``rtn_baseline`` at the configuration's group size)."""
    from repro_torch.configs.base import QuantConfig
    from repro_torch.core.apply import rtn_baseline
    from repro_torch.models import api

    qcfg = QuantConfig(group_size=int(config["quant"]["group_size"]))
    groups = weight_groups(api.init_model(cfg, device="meta"))
    params: Dict[str, Any] = {"layers": []}
    for g in ("embed", "head"):
        params.update(_unflatten(make_group(seed, g, groups[g], device)))
    for i in range(cfg.num_layers):
        layer = _unflatten(make_group(seed, f"layers.{i}",
                                      groups[f"layers.{i}"], device))
        rtn_baseline({"layers": [layer]}, cfg, qcfg)
        params["layers"].append(layer)
    return params


def build_engine(params, cfg, engine_args: dict, seed: int, device):
    """The engine with the mix's arguments, every other one the port's
    default, and an EOS id no token can take, so every request emits
    exactly its drawn output length.  On a card every kernel library is
    built (or found built) first: built lazily, the decode kernel would
    compile after the first requests' first tokens and stretch their
    time per token in a checkout's first run."""
    from repro_torch.serving.engine import ServingEngine

    if torch.device(device).type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()
    return ServingEngine(params, cfg, eos_id=-1, seed=seed, device=device,
                         **engine_args)


def request(item, due: float):
    from repro_torch.serving.engine import Request

    return Request(uid=item.uid, prompt=item.prompt,
                   max_tokens=item.max_tokens, arrival_t=due)


def api_module():
    from repro_torch.models import api

    return api
