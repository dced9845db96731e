"""The port's model configs (``repro_torch.configs``) against the JAX
package's: every ``CONFIG`` and ``SMOKE`` record field by field (``dtype``
as a string), the analytic parameter counts, the segment plans and the
input shapes. All exact."""

import dataclasses

import pytest

import repro.configs as ref_configs
import repro_torch.configs as port_configs
from repro.models.lm import n_attn_apps as ref_n_attn_apps
from repro.models.lm import segment_plan as ref_plan
from repro_torch.models.lm import n_attn_apps, segment_plan

ARCHS = ref_configs.ARCHS
RECORDS = [(arch, kind) for arch in ARCHS for kind in ("CONFIG", "SMOKE")]


def _pair(arch, kind):
    get = "get_config" if kind == "CONFIG" else "get_smoke"
    return getattr(ref_configs, get)(arch), getattr(port_configs, get)(arch)


def test_registry_lists_the_same_architectures():
    assert port_configs.ARCHS == ARCHS
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")


@pytest.mark.parametrize("arch,kind", RECORDS, ids=[f"{a}-{k}" for a, k in RECORDS])
def test_record_equals_the_reference(arch, kind):
    ref, port = _pair(arch, kind)
    a, b = dataclasses.asdict(ref), dataclasses.asdict(port)
    assert a == b
    assert str(ref.jdtype) == str(port.torch_dtype).removeprefix("torch.")
    assert ref.hd == port.hd
    assert list(ref.global_flags()) == list(port.global_flags())
    assert dataclasses.asdict(ref.scaled(n_layers=2)) == dataclasses.asdict(port.scaled(n_layers=2))


@pytest.mark.parametrize("arch,kind", RECORDS, ids=[f"{a}-{k}" for a, k in RECORDS])
def test_param_counts_equal_the_reference(arch, kind):
    ref, port = _pair(arch, kind)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch,kind", RECORDS, ids=[f"{a}-{k}" for a, k in RECORDS])
def test_segment_plan_equals_the_reference(arch, kind):
    ref, port = _pair(arch, kind)
    want = [dataclasses.asdict(s) for s in ref_plan(ref)]
    got = [dataclasses.asdict(s) for s in segment_plan(port)]
    assert got == want
    assert n_attn_apps(port) == ref_n_attn_apps(ref)


def test_shapes_equal_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in port_configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    for arch in ARCHS:
        ref, port = _pair(arch, "CONFIG")
        assert port_configs.applicable_shapes(port) == ref_configs.applicable_shapes(ref)


@pytest.mark.parametrize("name", ["CONFIG", "SMOKE"])
def test_paper_suite_equals_the_reference(name):
    """``repro_torch.configs.paper``'s ``PaperSuite`` records, field by
    field."""
    import repro.configs.paper as ref_paper
    import repro_torch.configs.paper as paper

    port, ref = getattr(paper, name), getattr(ref_paper, name)
    fields = [f.name for f in dataclasses.fields(paper.PaperSuite)]
    assert fields == [f.name for f in dataclasses.fields(ref_paper.PaperSuite)]
    for f in fields:
        assert getattr(port, f) == getattr(ref, f), f
    assert paper.PaperSuite() == paper.CONFIG
