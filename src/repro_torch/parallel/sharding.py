"""Sharding rules: parameter/activation specs for the production mesh.

The port of the JAX package's ``repro.parallel.sharding``, rule for rule.
Parallelism dimensions supported:

  * **DP**  — batch over ``("pod", "data")`` (the pod axis is pure data
    parallel across pods; gradient reduction crosses the inter-node hop).
  * **TP**  — attention heads / FFN hidden / expert dim over ``"model"``
    (Megatron layout: column-parallel in, row-parallel out).
  * **EP**  — MoE experts over ``"model"``.
  * **FSDP** — optionally shard the non-TP weight axis over ``"data"``
    (ZeRO-3-like; DTensor all-gathers on use).

A spec is this module's :class:`P`: per tensor dim ``None``, a mesh axis
name, or a tuple of names (one tensor dim over several mesh dims, major
to minor), as JAX's ``PartitionSpec`` holds them. The rules read only the
mesh's axis names and sizes, so they run on a :class:`DeviceMesh` or on a
shape-only :class:`AbstractMesh` (the counterpart of
``jax.sharding.AbstractMesh``), which needs no process group.

The reference keys its rules on pytree paths whose layers are stacked on
leading axes (scanned over, never sharded); the port has one module per
layer, so a port weight's spec is the reference leaf's without those
leading ``None``\\ s. Rules are keyed on the weight's name; a routed
expert is told by its module's type (:class:`~repro_torch.models.ffn.MoE`,
whose ``shared`` FFN is a plain :class:`~repro_torch.models.ffn.FFN`).
Anything unmatched is replicated.

:func:`placements` turns a spec into DTensor placements, and
:func:`distribute` places a model's weights, a cache or a batch on a
mesh as DTensors built from each rank's local shard (the counterpart of
``named`` plus ``jit(in_shardings=...)``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn

__all__ = ["P", "AbstractMesh", "ShardingConfig", "param_specs", "batch_specs",
           "cache_specs", "data_axes", "sanitize", "placements", "distribute",
           "distribute_tensor", "local_shape"]


class P(tuple):
    """A partition spec: one entry per tensor dim, each ``None``, a mesh
    axis name or a tuple of names. Compares equal to the tuple of its
    entries (so ``P(None, "model") == (None, "model")``). A tuple of one
    name is that name, as JAX's ``PartitionSpec`` normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            (e[0] if len(e) == 1 else tuple(e)) if isinstance(e, (tuple, list)) else e
            for e in entries))

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh of named axes and sizes with no devices: what the rules read
    (``mesh_dim_names`` and ``shape``, as a ``DeviceMesh`` has them)."""

    shape: tuple
    mesh_dim_names: tuple


@dataclass(frozen=True)
class ShardingConfig:
    mode: str = "fsdp_tp"     # "tp" | "fsdp_tp" | "dp"
    tp_axis: str = "model"
    fsdp_axis: str = "data"   # weights' non-TP dim sharded here in fsdp_tp
    shard_kv: bool = True     # shard KV projections when heads divide tp size


def _sizes(mesh) -> dict:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def data_axes(mesh) -> tuple:
    """Batch axes: ('pod', 'data') on the multi-pod mesh, ('data',) single."""
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _axis_size(sizes: dict, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(sizes[a] for a in entry)
    return sizes[entry]


def sanitize(spec, shape, mesh) -> P:
    """Drop sharding on any dim the mesh axes do not divide (the reference's
    ``jit`` in_shardings require exact divisibility; e.g. mamba2's vocab
    50280 is not divisible by 16 — its embedding falls back to
    model-sharding the d_model dim via the rules, or replication here)."""
    sizes = _sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    return P(*(entry if dim % _axis_size(sizes, entry) == 0 else None
               for dim, entry in zip(shape, entries)))


def param_specs(model: nn.Module, cfg, mesh,
                sharding: ShardingConfig | None = None) -> dict:
    """``{parameter name: P}`` for every weight of ``model`` (an ``LM`` on
    any device, ``meta`` included), by the reference's rules."""
    from ..models.ffn import MoE

    sh = sharding or ShardingConfig()
    sizes = _sizes(mesh)
    tp = sh.tp_axis if sh.tp_axis in sizes else None
    fsdp = (sh.fsdp_axis if sh.mode == "fsdp_tp" and sh.fsdp_axis in sizes else None)
    if sh.mode == "dp":
        tp = fsdp = None
    tp_size = sizes[tp] if tp else 1
    ep_ok = cfg.n_experts % tp_size == 0 if cfg.n_experts else False
    kv_ok = sh.shard_kv and cfg.n_kv_heads % tp_size == 0

    def tail_for(name: str, is_expert: bool):
        if name in ("embed", "unembed"):
            return (tp, None)
        if name == "wq":
            return (fsdp, tp)
        if name in ("wk", "wv"):
            return (fsdp, tp if kv_ok else None)
        if name == "wo":
            return (tp, fsdp)
        if name in ("w_uk", "w_uv", "w_uq"):
            return (None, tp)
        if name in ("w_dkv", "w_dq"):
            return (fsdp, None)
        if is_expert and name in ("w_gate", "w_up"):
            # EP over "model" when E divides; else TP the hidden dim so
            # the model axis is never wasted (mixtral: E=8 < 16).
            return (tp, fsdp, None) if ep_ok else (None, fsdp, tp)
        if is_expert and name == "w_down":
            return (tp, None, fsdp) if ep_ok else (None, tp, fsdp)
        if name in ("w_gate", "w_up"):
            return (fsdp, tp)
        if name == "w_down":
            return (tp, fsdp)
        if name == "router":
            return (None, None)
        if name in ("w_z", "w_x"):
            return (fsdp, tp)
        if name in ("w_b", "w_c", "w_dt"):
            return (fsdp, None)
        if name == "out_proj":
            return (tp, fsdp)
        if name == "conv_x":
            return (None, tp)
        if name in ("conv_b", "conv_c"):
            return (None, None)
        return None

    specs = {}
    for mod_name, module in model.named_modules():
        is_expert = isinstance(module, MoE)
        for name, w in module.named_parameters(recurse=False):
            shape = tuple(w.shape)
            tail = tail_for(name, is_expert)
            if tail is None or len(shape) < len(tail):
                spec = P(*([None] * len(shape)))
            else:
                spec = P(*([None] * (len(shape) - len(tail)) + list(tail)))
                # vocab not divisible by tp (mamba2/seamless): shard d_model instead
                if name in ("embed", "unembed") and shape[0] % max(1, tp_size) != 0:
                    spec = P(None, tp)
                spec = sanitize(spec, shape, mesh)
            specs[f"{mod_name}.{name}" if mod_name else name] = spec
    return specs


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _dp_size(mesh) -> tuple[tuple, int]:
    dp = data_axes(mesh)
    sizes = _sizes(mesh)
    return dp, math.prod(sizes[a] for a in dp) if dp else 1


def batch_specs(mesh, batch):
    """Input batch: leading batch dim over the data axes, rest replicated.

    Batches too small to split over the data axes (long-context decode at
    global_batch=1) stay replicated."""
    dp, dp_size = _dp_size(mesh)

    def spec_of(path, leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return P()
        lead = dp if dp and leaf.shape[0] % dp_size == 0 else None
        return P(lead, *([None] * (nd - 1)))

    return _map(spec_of, batch)


def _ssm_heads(cfg) -> int:
    return cfg.ssm_heads or (cfg.ssm_expand * cfg.d_model // max(1, cfg.ssm_head_dim))


def cache_specs(cfg, mesh, cache, sharding: ShardingConfig | None = None):
    """Decode-cache sharding: batch over data axes, heads over model.

    Cache leaves: stacked (L, B, T, Hkv, Dh) or MLA (L, B, T, r) or SSM
    (L, B, nh, hd, n) / conv (L, B, w, dim); ``pos`` (a Python int in the
    port's cache) replicated.
    """
    sh = sharding or ShardingConfig()
    sizes = _sizes(mesh)
    tp = sh.tp_axis if sh.tp_axis in sizes else None
    tp_size = sizes[tp] if tp else 1
    dp, dp_size = _dp_size(mesh)
    kv_ok = sh.shard_kv and cfg.n_kv_heads % tp_size == 0
    nh_ok = cfg.ssm_head_dim and _ssm_heads(cfg) % tp_size == 0
    kv_tail = (dp, None, tp if kv_ok else None, None)       # (B, T, Hkv, Dh)
    tails = {
        "k": kv_tail, "v": kv_tail, "attn_k": kv_tail, "attn_v": kv_tail,
        "ckv": (dp, None, None),                            # (B, T, r)
        "krope": (dp, None, None),
        "state": (dp, tp if nh_ok else None, None, None),   # (B, nh, hd, n)
        "conv_x": (dp, None, tp if nh_ok else None),        # (B, w, dim)
        "conv_b": (dp, None, None),
        "conv_c": (dp, None, None),
    }

    def spec_of(path, leaf):
        name = path[-1] if path else ""
        shape = tuple(getattr(leaf, "shape", ()))
        if name == "pos" or len(shape) == 0:
            return P()
        tail = tails.get(name)
        if tail is None or len(shape) < len(tail):
            lead0 = dp if dp and shape[0] % dp_size == 0 else None
            return sanitize(P(lead0, *([None] * (len(shape) - 1))), shape, mesh)
        lead = len(shape) - len(tail)
        tail = list(tail)
        if not (dp and shape[lead] % dp_size == 0):
            tail[0] = None
            # long-context single-sequence decode: shard the KV time axis
            # over the data axes instead (context-parallel cache).
            if name in ("k", "v", "attn_k", "attn_v", "ckv", "krope") \
                    and shape[lead + 1] % max(1, dp_size) == 0:
                tail[1] = dp
        return sanitize(P(*([None] * lead + tail)), shape, mesh)

    return _map(spec_of, cache)


# ---------------------------------------------------------------------------
# Placement on a DeviceMesh
# ---------------------------------------------------------------------------

def placements(spec, mesh) -> list:
    """DTensor placements for ``spec`` on ``mesh``, one per mesh dim: a mesh
    dim that a tensor dim is sharded over is ``Shard(that dim)``, every
    other ``Replicate()``. A tuple entry shards one tensor dim over several
    mesh dims, major to minor as JAX reads it; DTensor splits a tensor dim
    over mesh dims in mesh order, so the tuple must name them in that
    order (``data_axes`` does), and any other order raises. A mesh dim of
    size 1 splits nothing and is ``Replicate()`` (DTensor refuses some
    views of a dim "sharded" one way, such as a batch of 1 on a 1x1
    mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    sizes = tuple(mesh.shape)
    out, seen = [Replicate() for _ in names], set()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: {spec} shards dim {dim} over {axes}, "
                             f"not in the mesh's order {names}")
        for i in idx:
            if i in seen:
                raise ValueError(f"placements: mesh axis {names[i]!r} used twice in {spec}")
            seen.add(i)
            if sizes[i] > 1:
                out[i] = Shard(dim)
    return out


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor laid out by
    ``spec`` (every sharded dim divides evenly: :func:`sanitize`)."""
    sizes = _sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n = _axis_size(sizes, entry)
        if dim % n:
            raise ValueError(f"local_shape: dim {dim} of {tuple(shape)} does not "
                             f"split over {entry} ({n})")
        out.append(dim // n)
    return tuple(out)


def _local_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of ``t``: on ``meta`` an empty tensor of the local
    shape (nothing is copied), else a view of ``t`` cut by the rank's mesh
    coordinate, major axis first."""
    if t.device.type == "meta":
        return torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")
    names = tuple(mesh.mesh_dim_names)
    sizes = _sizes(mesh)
    coord = mesh.get_coordinate()
    out = t
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)
        index = 0
        for a in axes:
            index = index * sizes[a] + coord[names.index(a)]
        n = out.shape[dim] // _axis_size(sizes, entry)
        out = out.narrow(dim, index * n, n)
    return out


def distribute_tensor(t: torch.Tensor, spec, mesh):
    """``t`` as a DTensor on ``mesh`` laid out by ``spec``, built from this
    rank's shard of it (no collective; every rank holds ``t``, or ``t`` is
    on ``meta``)."""
    from torch.distributed.tensor import DTensor

    spec = sanitize(spec, t.shape, mesh)
    local = _local_shard(t, spec, mesh)
    if t.device.type != "meta":
        local = local.contiguous()
    stride = [1] * t.dim()        # the global tensor's, contiguous as its shards are
    for i in range(t.dim() - 2, -1, -1):
        stride[i] = stride[i + 1] * t.shape[i + 1]
    return DTensor.from_local(local, mesh, placements(spec, mesh), run_check=False,
                              shape=t.shape, stride=tuple(stride))


def distribute(target, specs, mesh):
    """Place ``target`` on ``mesh`` by ``specs``.

    A model (``nn.Module``) with ``specs`` from :func:`param_specs`: each
    weight is replaced in place by a DTensor parameter of the same
    ``requires_grad``, and the model is returned. A tree (the cache, a
    batch: dicts and lists of tensors) with a matching tree of specs: a new
    tree of DTensors; leaves that are not tensors (the cache's ``pos``)
    are kept as they are."""
    if isinstance(target, nn.Module):
        for name, spec in specs.items():
            mod_name, _, leaf = name.rpartition(".")
            module = target.get_submodule(mod_name) if mod_name else target
            w = getattr(module, leaf)
            d = distribute_tensor(w.detach(), spec, mesh)
            setattr(module, leaf, nn.Parameter(d, requires_grad=w.requires_grad))
        return target

    def place(path, leaf):
        spec = specs
        for k in path:
            spec = spec[k]
        return distribute_tensor(leaf, spec, mesh) if isinstance(leaf, torch.Tensor) else leaf

    return _map(place, target)
