"""Step functions, their abstract inputs, meshes and the dry run (the port
of ``repro.launch``): ``steps`` (train, prefill, decode and their inputs on
``meta``), ``mesh`` (production and local meshes, the ``H100`` record, a
fake world), ``op_analysis`` and ``roofline`` (per-device counts and their
terms), ``report`` (the tables) and ``dryrun`` (``python -m
repro_torch.launch.dryrun``)."""

from .mesh import H100, fake_world, make_local_mesh, make_production_mesh
from .steps import (
    abstract_cache,
    abstract_params,
    abstract_train_state,
    init_train_state,
    input_specs,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)

__all__ = ["init_train_state", "make_train_step", "make_prefill_step",
           "make_decode_step", "input_specs", "abstract_params",
           "abstract_train_state", "abstract_cache", "H100",
           "make_production_mesh", "make_local_mesh", "fake_world"]
