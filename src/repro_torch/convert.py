"""Carry state from the JAX package's objects into the port's.

The counterpart of loading a reference model's weights: a test builds a
cluster and synchronizes it with the reference, then hands the same state
to both engines; or it draws kernel inputs once and hands the same
tensors to both packages (:func:`tensors_from_reference`); or it loads
the reference's model weights into the port's ``LM``
(:func:`params_from_reference`, and back with :func:`params_to_reference`). The reference's objects are read duck-typed, as plain
numbers and numpy arrays (clock parameters, ``net.t``, the RNG's
``bit_generator.state``, a clock's random-walk state and drift path, the
sync models, an op's cost parameters and AR(1) state), so this module
imports nothing of the reference package.

An op's epoch-bias cache is not carried: it is keyed by the reference's
net object. A converted op draws its bias from the converted net's RNG on
first use, as the reference op does for a net it has not seen.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .core.clocks import DriftPath, LinearModel, SimClock
from .core.mpi_ops import SimCollective, SimCompositeOp
from .core.simnet import ClockParams, NetParams, SimNet
from .core.sync.base import SyncResult

__all__ = ["clock_from_reference", "net_from_reference", "sync_from_reference", "op_from_reference",
           "tensors_from_reference", "params_from_reference", "params_to_reference"]


def _fields(cls, obj) -> dict:
    """The init fields of dataclass ``cls``, read by name from ``obj``."""
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)
            if f.init}


def _rng_from_reference(rng) -> np.random.Generator:
    out = np.random.default_rng()
    out.bit_generator.state = copy.deepcopy(rng.bit_generator.state)
    return out


def clock_from_reference(c) -> SimClock:
    """A port :class:`SimClock` in the state of the reference clock ``c``:
    its parameters, the lazy walk's stream position and last sample, and
    its drift path (nodes and stream) when one is active."""
    out = SimClock(offset=float(c.offset), skew=float(c.skew),
                   rw_sigma=float(c.rw_sigma),
                   scale_error=float(c.scale_error), seed=int(c.seed))
    out._rng = _rng_from_reference(c._rng)
    out._rw_t, out._rw_x = float(c._rw_t), float(c._rw_x)
    path = c._path
    if path is not None:
        out._path = DriftPath(sigma=float(path.sigma), dt=float(path.dt),
                              rng=_rng_from_reference(path.rng),
                              t=np.array(path.t, dtype=np.float64),
                              x=np.array(path.x, dtype=np.float64))
    return out


def net_from_reference(net) -> SimNet:
    """A port :class:`SimNet` in the state of the reference ``net``: clocks
    (random walks included), per-host true times, message count and the
    RNG's position."""
    out = SimNet(net.p, net=NetParams(**_fields(NetParams, net.net)),
                 clocks=ClockParams(**_fields(ClockParams, net.clock_params)))
    out.clocks = [clock_from_reference(c) for c in net.clocks]
    out.t = np.array(net.t, dtype=np.float64)
    out.msg_count = int(net.msg_count)
    out.rng = _rng_from_reference(net.rng)
    return out


def sync_from_reference(sync) -> SyncResult:
    """A port :class:`SyncResult` with the reference's drift models,
    initial times and bookkeeping."""
    return SyncResult(
        algorithm=str(sync.algorithm),
        models=[LinearModel(float(m.slope), float(m.intercept))
                for m in sync.models],
        initial_times=[float(t) for t in sync.initial_times],
        duration=float(sync.duration),
        n_messages=int(sync.n_messages),
        params=dict(sync.params),
    )


def op_from_reference(op) -> SimCollective:
    """A port cost model with the reference op's parameters and AR(1)
    state; composites convert term by term."""
    terms = getattr(op, "terms", None)
    if terms:
        kw = _fields(SimCollective, op)
        out = SimCompositeOp(**kw, terms=tuple(
            (op_from_reference(sub), float(ms), float(ps))
            for sub, ms, ps in terms))
        out.rank_imbalance = float(op.rank_imbalance)
    else:
        out = SimCollective(**_fields(SimCollective, op))
    out._ar_state = float(op._ar_state)
    return out


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.array(a)                     # a writable copy: torch shares its memory
    if a.dtype.name == "bfloat16":      # numpy has no bf16; f32 holds it exactly
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def tensors_from_reference(arrays, device, dtype=None):
    """The reference's arrays (numpy, or anything ``np.asarray`` reads, in
    model layout) as the port's tensors on ``device``, in the same
    structure: one array, a sequence, or a dict of them.

    Values are carried exactly: bfloat16 arrays go through float32, which
    holds them. ``dtype``, when given, converts afterwards.
    """
    if isinstance(arrays, dict):
        return {k: _tensor(a, device, dtype) for k, a in arrays.items()}
    if isinstance(arrays, (list, tuple)):
        return type(arrays)(_tensor(a, device, dtype) for a in arrays)
    return _tensor(arrays, device, dtype)


# ---------------------------------------------------------------------------
# Model weights
# ---------------------------------------------------------------------------

#: ``ModuleList`` children whose reference leaves carry a leading layer axis
#: (the reference stacks them for ``lax.scan``): a hybrid block's inner SSM
#: layers and the encoder's blocks; ``segments`` is a list of such stacks.
_STACKED = ("inner", "segment")


def _take(tree: dict, j: int) -> dict:
    return {k: _take(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}


def _load(module, tree: dict, device, done: set, prefix: str) -> None:
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if key == "segments":
            if len(val) != len(module.segments):
                raise ValueError(f"params_from_reference: {len(val)} segments, the "
                                 f"port's plan has {len(module.segments)}")
            for i, (seg, sub) in enumerate(zip(module.segments, val)):
                _load_stack(seg, sub, device, done, f"{name}.{i}.")
        elif key in _STACKED:
            _load_stack(getattr(module, key), val, device, done, f"{name}.")
        elif isinstance(val, dict):
            _load(getattr(module, key), val, device, done, f"{name}.")
        else:
            param = getattr(module, key, None)
            t = _tensor(val, device, None)
            if param is None or t.shape != param.shape or t.dtype != param.dtype:
                want = None if param is None else (tuple(param.shape), param.dtype)
                raise ValueError(f"params_from_reference: {name} is "
                                 f"{(tuple(t.shape), t.dtype)}, the port has {want}")
            param.copy_(t)
            done.add(name)


def _load_stack(modules, tree: dict, device, done: set, prefix: str) -> None:
    counts = {np.shape(a)[0] for a in _leaves(tree)}
    if counts != {len(modules)}:
        raise ValueError(f"params_from_reference: {prefix} stacks {counts} layers, "
                         f"the port has {len(modules)}")
    for j, m in enumerate(modules):
        _load(m, _take(tree, j), device, done, f"{prefix}{j}.")


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


@torch.no_grad()
def params_from_reference(cfg, tree: dict, device="cuda"):
    """The port's :class:`~repro_torch.models.LM` for ``cfg`` (the port's
    :class:`~repro_torch.models.ModelConfig`) holding the reference's
    ``init_params`` pytree ``tree``, given as nested dicts and lists of
    numpy arrays. The stacked layer axis is split into the port's module
    lists: ``segments``, a hybrid block's ``inner`` stack and
    the encoder's ``segment``. Values are carried exactly (bf16 through
    f32); a key, shape or type the port does not have, or a port weight
    the tree does not set, raises."""
    from .models.lm import LM

    model = LM(cfg, device)
    done: set = set()
    _load(model, tree, device, done, "")
    missing = sorted(n for n, _ in model.named_parameters() if n not in done)
    if missing:
        raise ValueError(f"params_from_reference: the tree sets no {missing}")
    return model


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes      # numpy's bfloat16, as the reference's arrays carry it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}


def _dump(module) -> dict:
    out = {name: _array(p) for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if name == "segments":
            out[name] = [_stack([_dump(b) for b in seg]) for seg in child]
        elif name in _STACKED:
            out[name] = _stack([_dump(m) for m in child])
        else:
            out[name] = _dump(child)
    return out


def params_to_reference(model) -> dict:
    """The inverse of :func:`params_from_reference`: ``model``'s weights as
    the reference's pytree (nested dicts and lists of numpy arrays, layers
    stacked on a leading axis). bf16 weights come back as ``ml_dtypes``'
    bfloat16, the type the reference's arrays carry."""
    return _dump(model)
