"""Carry state from the JAX package's objects into the port's.

The counterpart of loading a reference model's weights: a test builds a
cluster and synchronizes it with the reference, then hands the same state
to both engines; or it draws kernel inputs once and hands the same
tensors to both packages (:func:`tensors_from_reference`). The reference's objects are read duck-typed, as plain
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
           "tensors_from_reference"]


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
