"""Roofline terms of one step on the card (the counterpart of the JAX
package's ``repro.launch.roofline``).

The counts come from :mod:`repro_torch.launch.op_analysis`, which runs
the step op by op; the reference parses them from compiled HLO text. So
``parse_collectives`` has no counterpart here: ``analyze_step`` counts
the collectives' operand bytes as the step issues them.

Terms (seconds, per device == per-step wall-clock lower bound), against
:class:`~repro_torch.launch.mesh.H100`:

  compute    = flops_per_device / dense bf16 peak
  memory     = bytes_per_device / HBM bandwidth
  collective = collective_bytes_per_device / inter-node NIC bandwidth

The collective term takes one link per hop, the reference's conservative
case. On DGX H100 nodes of 8 GPUs a 16-wide ``model`` axis spans two
nodes, so every axis of the production meshes crosses the 50 GB/s NIC,
the slower of the links it uses (NVLink gives 450 GB/s each way inside a
node).
"""

from __future__ import annotations

from dataclasses import dataclass

from .mesh import H100

__all__ = ["RooflineReport", "roofline_from_cost", "HW"]

HW = H100


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_ops: dict
    collective_bytes_by_op: dict
    memory_per_device: dict            # argument and peak bytes (op_analysis)
    model_flops_global: float          # 6*N*D (train) or 2*N*D
    model_params: int
    compile_seconds: float = 0.0       # the step's analysed run, wall

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / HW.PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HW.HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / HW.NIC_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_bound(self) -> float:
        """Roofline step time: the dominant term (optimistic overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        counted_global = self.flops_per_device * self.chips
        return self.model_flops_global / counted_global if counted_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the cards' peak the *useful* model FLOPs achieve at
        the rooflined step time."""
        denom = self.step_time_bound * self.chips * HW.PEAK_FLOPS_BF16
        return self.model_flops_global / denom if denom else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_ops": self.collective_ops,
            "collective_bytes_by_op": self.collective_bytes_by_op,
            "memory_per_device": self.memory_per_device,
            "model_flops_global": self.model_flops_global,
            "model_params": self.model_params,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "compile_seconds": self.compile_seconds,
        }


def roofline_from_cost(cost, *, arch: str, shape: str, mesh_desc: str, chips: int,
                       model_flops_global: float, model_params: int,
                       compile_seconds: float = 0.0) -> RooflineReport:
    """A report from :func:`~repro_torch.launch.op_analysis.analyze_step`'s
    :class:`~repro_torch.launch.op_analysis.OpCost`."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_desc, chips=chips,
        flops_per_device=float(cost.flops), bytes_per_device=float(cost.bytes_accessed),
        collective_bytes_per_device=float(cost.collective_bytes),
        collective_ops=dict(cost.collective_ops),
        collective_bytes_by_op=dict(cost.collective_bytes_by_op),
        memory_per_device={"argument_bytes": int(cost.argument_bytes),
                           "peak_bytes": int(cost.peak_bytes),
                           "temp_bytes": int(cost.peak_bytes - cost.argument_bytes)},
        model_flops_global=model_flops_global, model_params=model_params,
        compile_seconds=compile_seconds)
