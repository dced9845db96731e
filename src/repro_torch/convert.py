"""Carry state from the JAX package's objects into the port's.

The counterpart of loading a reference model's weights: a test builds a
cluster and synchronizes it with the reference, then hands the same state
to both engines; or it draws kernel inputs once and hands the same
tensors to both packages (:func:`tensors_from_reference`); or it loads
the reference's model weights into the port's ``LM``
(:func:`params_from_reference`, and back with :func:`params_to_reference`),
or a whole train state, weights, AdamW moments and step count
(:func:`train_state_from_reference`, :func:`train_state_to_reference`).
The reference's objects are read duck-typed, as plain
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
           "tensors_from_reference", "params_from_reference", "params_to_reference",
           "named_to_reference", "train_state_tree", "load_train_state", "train_state_from_reference",
           "train_state_to_reference"]


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
    if isinstance(a, torch.Tensor):
        t = a
    else:
        a = np.array(a)                 # a writable copy: torch shares its memory
        if a.dtype.name == "bfloat16":  # numpy has no bf16; f32 holds it exactly
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
# Model weights and train states
# ---------------------------------------------------------------------------

#: ``ModuleList`` children whose reference leaves carry a leading layer axis
#: (the reference stacks them for ``lax.scan``): a hybrid block's inner SSM
#: layers and the encoder's blocks; ``segments`` is a list of such stacks.
_STACKED = ("inner", "segment")


def _take(tree: dict, j: int) -> dict:
    return {k: _take(v, j) if isinstance(v, dict) else v[j] for k, v in tree.items()}


def _load(module, tree: dict, done: set, prefix: str, put) -> None:
    """Walk the reference-layout ``tree`` against ``module``: for each leaf,
    ``put(name, param, value)`` with the port's parameter name (as
    ``named_parameters`` gives it), the parameter (None where the port has
    none) and the leaf's value, one layer's slice of a stacked leaf."""
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if key == "segments":
            if len(val) != len(module.segments):
                raise ValueError(f"weights: {len(val)} segments, the port's plan "
                                 f"has {len(module.segments)}")
            for i, (seg, sub) in enumerate(zip(module.segments, val)):
                _load_stack(seg, sub, done, f"{name}.{i}.", put)
        elif key in _STACKED:
            _load_stack(getattr(module, key), val, done, f"{name}.", put)
        elif isinstance(val, dict):
            _load(getattr(module, key), val, done, f"{name}.", put)
        else:
            put(name, getattr(module, key, None), val)
            done.add(name)


def _load_stack(modules, tree: dict, done: set, prefix: str, put) -> None:
    counts = {np.shape(a)[0] for a in _leaves(tree)}
    if counts != {len(modules)}:
        raise ValueError(f"weights: {prefix} stacks {counts} layers, the port "
                         f"has {len(modules)}")
    for j, m in enumerate(modules):
        _load(m, _take(tree, j), done, f"{prefix}{j}.", put)


def _leaves(tree: dict):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _load_all(model, tree: dict, put, what: str) -> None:
    """:func:`_load` over the whole model; raises unless every weight was
    set."""
    done: set = set()
    _load(model, tree, done, "", put)
    missing = sorted(n for n, _ in model.named_parameters() if n not in done)
    if missing:
        raise ValueError(f"{what}: the tree sets no {missing}")


def _into_params(device):
    def put(name, param, val):
        t = _tensor(val, device, None)
        if param is None or t.shape != param.shape or t.dtype != param.dtype:
            want = None if param is None else (tuple(param.shape), param.dtype)
            raise ValueError(f"weights: {name} is {(tuple(t.shape), t.dtype)}, "
                             f"the port has {want}")
        param.copy_(t)
    return put


def _into(moments: dict, device):
    def put(name, param, val):
        t = _tensor(val, device, torch.float32)
        if name not in moments or t.shape != moments[name].shape:
            raise ValueError(f"moments: {name} is {tuple(t.shape)}, the port's "
                             f"weight is {None if param is None else tuple(param.shape)}")
        moments[name].copy_(t)
    return put


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
    _load_all(model, tree, _into_params(device), "params_from_reference")
    return model


def _array(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes      # numpy's bfloat16, as the reference's arrays carry it

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def _dump(module, leaf, prefix: str = "") -> dict:
    """``module``'s weights in the reference's layout, each leaf
    ``leaf(name, param)`` (a CPU tensor), layers stacked on a leading
    axis."""
    out = {name: leaf(f"{prefix}{name}", p)
           for name, p in module.named_parameters(recurse=False)}
    for name, child in module.named_children():
        if name == "segments":
            out[name] = [_stack([_dump(b, leaf, f"{prefix}{name}.{i}.{j}.")
                                 for j, b in enumerate(seg)])
                         for i, seg in enumerate(child)]
        elif name in _STACKED:
            out[name] = _stack([_dump(m, leaf, f"{prefix}{name}.{j}.")
                                for j, m in enumerate(child)])
        else:
            out[name] = _dump(child, leaf, f"{prefix}{name}.")
    return out


def _stack(trees: list) -> dict:
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy on the host: the caller may keep it while the weight moves."""
    return t.detach().to("cpu", copy=True)


def params_to_reference(model) -> dict:
    """The inverse of :func:`params_from_reference`: ``model``'s weights as
    the reference's pytree (nested dicts and lists of numpy arrays, layers
    stacked on a leading axis). bf16 weights come back as ``ml_dtypes``'
    bfloat16, the type the reference's arrays carry."""
    return _map(_array, _dump(model, lambda name, p: _host(p)))


def named_to_reference(model, named: dict) -> dict:
    """Tensors keyed by ``model``'s parameter names (its gradients, an
    optimizer's moments) in the reference's layout of the weights, layers
    stacked on a leading axis; every leaf a copy on the host."""
    return _dump(model, lambda name, p: _host(named[name]))


def train_state_tree(state: dict) -> dict:
    """A train state (``{"params": model, "opt": {"m", "v", "count"}}``)
    in the reference's layout: ``{"opt": {"count", "m", "v"}, "params"}``,
    the moments shaped as the weights, layers stacked on a leading axis,
    every leaf a copy on the host (a CPU tensor). Flattened with sorted
    keys, its leaves come in the reference's order, which is what the
    checkpoint store writes."""
    model, opt = state["params"], state["opt"]
    return {"opt": {"count": _host(opt["count"]),
                    "m": named_to_reference(model, opt["m"]),
                    "v": named_to_reference(model, opt["v"])},
            "params": _dump(model, lambda name, p: _host(p))}


@torch.no_grad()
def load_train_state(state: dict, tree: dict) -> None:
    """Copy ``tree`` (the layout of :func:`train_state_tree`; tensors or
    numpy arrays) into ``state`` in place: the model's parameters, the
    moments and the count stay the same tensors, so whatever holds them
    stays tied to them. A weight or moment the tree does not set, or one
    of another shape or type, raises."""
    model, opt = state["params"], state["opt"]
    device = opt["count"].device
    _load_all(model, tree["params"], _into_params(device), "load_train_state")
    for key in ("m", "v"):
        _load_all(model, tree["opt"][key], _into(opt[key], device), "load_train_state")
    opt["count"].copy_(_tensor(tree["opt"]["count"], device, torch.int32))


def train_state_from_reference(cfg, tree: dict, device="cuda") -> dict:
    """The port's train state holding the reference's ``{"params",
    "opt": {"m", "v", "count"}}`` pytree (numpy arrays): the weights as
    :func:`params_from_reference` carries them, the moments and the count
    beside them."""
    from .launch.steps import init_train_state

    state = init_train_state(params_from_reference(cfg, tree["params"], device))
    load_train_state(state, tree)
    return state


def train_state_to_reference(state: dict) -> dict:
    """The inverse of :func:`train_state_from_reference`: the reference's
    train-state pytree, numpy arrays (bf16 as ``ml_dtypes``')."""
    return _map(_array, train_state_tree(state))
