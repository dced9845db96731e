"""Per-device cost of one step, counted op by op as it runs.

The counterpart of the JAX package's ``repro.launch.hlo_analysis``, which
parses the optimized HLO of the per-device SPMD program. Eager PyTorch has
no HLO: :func:`analyze_step` runs the step once under a
``TorchDispatchMode`` and counts what rank 0 of the mesh executes, on
DTensors over a fake process group and ``meta`` tensors as well as on
real ones:

  * **FLOPs**: ``torch.utils.flop_counter``'s per-op formulas (matrix
    products, convolutions, attention), as the reference counts ``dot``
    ops. Under DTensor each op is seen twice: once on ``FakeTensor``\\ s,
    DTensor's sharding propagation, and once on the local shards. Only
    the local ops count; counting both would double the FLOPs and make
    them global.
  * **Bytes accessed**: the input and output bytes of every local op that
    touches memory (views, ``empty*``, ``detach`` and the like do not).
    Eager runs no fusions, so each op is one access, where the reference
    counts an XLA fusion once: the port's memory term is an upper bound
    beside the reference's.
  * **Collectives**: the operand bytes of each ``_c10d_functional``
    collective, under the reference's names (``all_reduce`` ->
    ``all-reduce``, ``all_gather_into_tensor`` -> ``all-gather``,
    ``reduce_scatter_tensor`` -> ``reduce-scatter``, ``all_to_all_single``
    -> ``all-to-all``).
  * **Memory**: ``argument_bytes``, the exact sum of the arguments' local
    shards; ``peak_bytes``, the arguments plus the most bytes of storage
    that ops of the step held alive at once, tracked storage by storage.
    On ``meta`` nothing is allocated, so it is a prediction (the card's
    caching allocator rounds and keeps more).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["OpCost", "analyze_step", "COLLECTIVES"]

#: ``_c10d_functional`` op -> the reference's (HLO) name
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_NOT_COLLECTIVES = {"wait_tensor", "_wrap_tensor_autograd"}

_NO_ACCESS = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "lift_fresh", "_local_scalar_dense", "wait_tensor", "set_",
    "resize_", "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
}


@dataclass
class OpCost:
    """Per-device counts of one step (the fields of the reference's
    ``HloCost``, with the memory the reference reads from
    ``memory_analysis``)."""

    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_ops: dict = field(default_factory=dict)
    collective_bytes_by_op: dict = field(default_factory=dict)
    argument_bytes: int = 0
    peak_bytes: int = 0
    warnings: list = field(default_factory=list)


def _local(t):
    """The local shard of a DTensor, ``t`` otherwise."""
    return t.to_local() if hasattr(t, "to_local") else t


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    def __init__(self, cost: OpCost, argument_storages: set):
        super().__init__()
        self.cost = cost
        self.args = argument_storages
        self.live: dict = {}          # storage key -> bytes, alive, not an argument
        self.live_bytes = 0
        self.high = 0

    def _release(self, key):
        self.live_bytes -= self.live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.args or key in self.live:
            return
        self.live[key] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.high = max(self.high, self.live_bytes)
        weakref.finalize(st, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs it; its local ops come back here
        out = func(*args, **kwargs)
        ins = [a for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                 # DTensor's sharding propagation
        cost = self.cost
        name = func.overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            nbytes = sum(_nbytes(t) for t in ins)
            cost.collective_bytes += nbytes
            cost.collective_ops[kind] = cost.collective_ops.get(kind, 0) + 1
            cost.collective_bytes_by_op[kind] = cost.collective_bytes_by_op.get(kind, 0) + nbytes
        elif ns in ("_c10d_functional", "_dtensor") and name not in _NOT_COLLECTIVES:
            cost.warnings.append(f"collective {func} not counted")
        from torch.utils.flop_counter import flop_registry

        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            cost.flops += float(formula(*args, **kwargs, out_val=out))
        if not func.is_view and name not in _NO_ACCESS:
            cost.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


def analyze_step(fn, *args, **kwargs) -> tuple[OpCost, object]:
    """Run ``fn(*args, **kwargs)`` once and count its per-device cost;
    returns ``(cost, fn's result)``. ``args`` may hold models, dicts and
    lists of (D)Tensors: their local shards are the arguments whose bytes
    ``argument_bytes`` sums (each storage once)."""
    cost = OpCost()
    storages = {}

    def note(t):
        t = _local(t)
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            storages.setdefault(st._cdata, st.nbytes())

    for a in tree_leaves((args, kwargs)):
        if isinstance(a, torch.nn.Module):
            for p in a.parameters():
                note(p)
            for b in a.buffers():
                note(b)
        elif isinstance(a, torch.Tensor):
            note(a)
    cost.argument_bytes = int(sum(storages.values()))
    counter = _Counter(cost, set(storages))
    with counter:
        result = fn(*args, **kwargs)
    cost.peak_bytes = cost.argument_bytes + counter.high
    return cost, result
