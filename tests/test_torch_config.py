"""The port's `config.py` and `faults.py` (numpy copies) against the
reference: `to_params()` key by key (same keys, dtypes and values) over
`paper_configs(2|4|8)` x `POLICY_PRESETS` x the fault scenarios of
`benchmarks/paper_fig_fault.py`, the 768-policy grid, and the same
constructions raising `ValueError`."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmarks.paper_fig_fault import _fault_grid  # noqa: E402
from repro.core.smla import policies as ref_policies  # noqa: E402
from repro.core.smla.config import (ControllerPolicy,  # noqa: E402
                                    StackConfig, paper_configs)
from repro.core.smla.faults import FaultConfig  # noqa: E402
from repro_torch.core.smla import config as port_config  # noqa: E402
from repro_torch.core.smla import faults as port_faults  # noqa: E402
from torch_parity import port_fault, port_policy, port_stack  # noqa: E402


def _assert_params_equal(got, want, where):
    assert sorted(got) == sorted(want), where
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, f"{where}:{k} {g.dtype} != {w.dtype}"
        np.testing.assert_array_equal(g, w, err_msg=f"{where}:{k}")


@pytest.mark.parametrize("layers", [2, 4, 8])
def test_to_params_policy_and_fault_grid(layers):
    faults = [f for f in _fault_grid()
              if all(i < layers for i in f.dead_layers + f.weak_ranks)
              and len(f.dead_layers) < layers]
    n = 0
    for cname, sc in paper_configs(layers).items():
        for pol in ref_policies.POLICY_PRESETS.values():
            for fc in faults:
                ref = dataclasses.replace(sc, policy=pol, faults=fc)
                got = port_stack(ref)
                where = f"L{layers}/{cname}|{pol.tag}%{fc.tag}"
                _assert_params_equal(got.to_params(), ref.to_params(), where)
                _assert_params_equal(got.to_params(layers + 1),
                                     ref.to_params(layers + 1), where)
                assert got.fault_layout()["survivors"] == \
                    ref.fault_layout()["survivors"]
                assert got.unit_ns == ref.unit_ns
                assert got.peak_bandwidth_gbps == ref.peak_bandwidth_gbps
                n += 1
    assert n == 5 * len(ref_policies.POLICY_PRESETS) * len(faults)
    got_cfgs = port_config.paper_configs(layers)
    assert sorted(got_cfgs) == sorted(paper_configs(layers))
    for name, sc in paper_configs(layers).items():
        assert got_cfgs[name] == port_stack(sc)


def test_policy_grid_tags():
    ref = ControllerPolicy.grid()
    got = port_config.ControllerPolicy.grid()
    assert len(got) == len(ref) == 768
    assert [p.tag for p in got] == [p.tag for p in ref]
    assert [port_policy(p) for p in ref] == got
    pins = dict(row=1, write_drain=[0, 2])
    assert [p.tag for p in port_config.ControllerPolicy.grid(**pins)] == \
        [p.tag for p in ControllerPolicy.grid(**pins)]
    for f in _fault_grid():
        assert port_fault(f).tag == f.tag


@pytest.mark.parametrize("kwargs", [
    dict(layers=0), dict(banks_per_rank=0), dict(io_bits=0),
    dict(base_freq_mhz=0.0), dict(request_bytes=8, io_bits=128),
    dict(t_rcd_ns=-1.0), dict(t_xsr_ns=-0.5),
])
def test_stack_constructions_raise(kwargs):
    with pytest.raises(ValueError):
        StackConfig(**kwargs)
    with pytest.raises(ValueError):
        port_config.StackConfig(**kwargs)


@pytest.mark.parametrize("kwargs", [
    dict(retention_derate=3), dict(ecc_rate=0.7), dict(dead_layers=(-1,)),
])
def test_fault_constructions_raise(kwargs):
    with pytest.raises(ValueError):
        FaultConfig(**kwargs)
    with pytest.raises(ValueError):
        port_faults.FaultConfig(**kwargs)


def test_fault_validation_against_stack_raises():
    for kw in (dict(dead_layers=(4,)), dict(dead_layers=(0, 1, 2, 3))):
        with pytest.raises(ValueError):
            StackConfig(layers=4, faults=FaultConfig(**kw))
        with pytest.raises(ValueError):
            port_config.StackConfig(layers=4,
                                    faults=port_faults.FaultConfig(**kw))
    with pytest.raises(ValueError):
        ControllerPolicy.grid(bogus=1)
    with pytest.raises(ValueError):
        port_config.ControllerPolicy.grid(bogus=1)
    with pytest.raises(ValueError):
        port_config.StackConfig().to_params(n_ranks_max=1)
