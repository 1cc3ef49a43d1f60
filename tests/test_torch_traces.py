"""The port's `traces.py` (numpy copy) against the reference: every trace
function array-equal per seed over all 31 `WORKLOADS`."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core.smla import traces as ref  # noqa: E402
from repro_torch.core.smla import traces as port  # noqa: E402


def _eq(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_workload_table():
    assert port.WORKLOADS == [port.WorkloadSpec(**w.__dict__)
                              for w in ref.WORKLOADS]
    assert len(port.WORKLOADS) == 31


@pytest.mark.parametrize("seed", [0, 13])
def test_trace_functions_over_all_workloads(seed):
    for i, (w_ref, w_port) in enumerate(zip(ref.WORKLOADS, port.WORKLOADS)):
        args = (seed + i, 64, 4, 2)
        _eq(port.synthetic_trace(seed + i, w_port, 64, 4, 2),
            ref.synthetic_trace(seed + i, w_ref, 64, 4, 2))
        _eq(port.core_traces(seed, [w_port, w_port], 48, 8, 2),
            ref.core_traces(seed, [w_ref, w_ref], 48, 8, 2))
        _eq(port.lm_serving_trace(*args), ref.lm_serving_trace(*args))
    skewed = (ref.WorkloadSpec("skew", 10.0, 0.5, bank_spread=0.3),
              port.WorkloadSpec("skew", 10.0, 0.5, bank_spread=0.3))
    _eq(port.synthetic_trace(seed, skewed[1], 50, 2, 4),
        ref.synthetic_trace(seed, skewed[0], 50, 2, 4))


def test_pad_and_stack():
    a = ref.core_traces(1, ref.WORKLOADS[:2], 30, 4, 2)
    b = ref.core_traces(2, ref.WORKLOADS[2:4], 20, 4, 2)
    _eq(port.pad_traces(b, 30), ref.pad_traces(b, 30))
    _eq(port.stack_traces([a, b]), ref.stack_traces([a, b]))
    with pytest.raises(ValueError):
        port.pad_traces(a, 10)


@pytest.mark.parametrize("arrival,cv2", [("poisson", 1.0), ("gamma", 4.0),
                                         ("gamma", 1.0)])
def test_traffic_mix_arrival_gaps(arrival, cv2):
    m_ref = ref.TrafficMix("t", arrival=arrival, cv2=cv2)
    m_port = port.TrafficMix("t", arrival=arrival, cv2=cv2)
    np.testing.assert_array_equal(
        port.arrival_gaps(np.random.default_rng(5), m_port, 100),
        ref.arrival_gaps(np.random.default_rng(5), m_ref, 100))
    for bad in (dict(arrival="uniform"), dict(prefill_frac=1.0),
                dict(cv2=0.0)):
        with pytest.raises(ValueError):
            ref.TrafficMix("t", **bad)
        with pytest.raises(ValueError):
            port.TrafficMix("t", **bad)
