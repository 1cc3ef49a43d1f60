"""The port's `configs` (a pure-Python copy) against the reference: every
registered config and its `reduce_config` are equal dataclasses, with
equal `_param_shapes` and parameter counts; the shape suites and the
`ParallelConfig` defaults are equal too."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.archs import ALL_ARCHS  # noqa: E402
from repro_torch.configs import base as port_base  # noqa: E402


def test_registries_equal():
    assert port_base.list_configs() == ref_base.list_configs()
    assert sorted(ALL_ARCHS) == port_base.list_configs()


@pytest.mark.parametrize("name", ALL_ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_config_equal(name, reduced):
    want = ref_base.get_config(name)
    got = port_base.get_config(name)
    if reduced:
        want, got = ref_base.reduce_config(want), port_base.reduce_config(got)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert port_base._param_shapes(got) == ref_base._param_shapes(want)
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert ([s.name for s in port_base.applicable_shapes(got)]
            == [s.name for s in ref_base.applicable_shapes(want)])
    assert port_base.skipped_shapes(got) == ref_base.skipped_shapes(want)


def test_shapes_and_parallel_defaults_equal():
    assert ({k: dataclasses.asdict(v) for k, v in port_base.SHAPES.items()}
            == {k: dataclasses.asdict(v)
                for k, v in ref_base.SHAPES.items()})
    assert (dataclasses.asdict(port_base.ParallelConfig())
            == dataclasses.asdict(ref_base.ParallelConfig()))


def test_unknown_arch_raises():
    with pytest.raises(KeyError):
        port_base.get_config("no-such-arch")
