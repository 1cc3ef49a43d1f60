"""The port's int8 gradient compression (``train/compression.py``) against
the reference's, same inputs: `quantize`'s int8 values bit-identical (both
round half to even), its scales rtol 1e-6; `dequantize` and
`encode_error` rtol 1e-6; the round trip within half a quantisation step
per element (the reference test's bound, tests/test_collectives.py:82).
The ring itself is held in ``test_torch_collectives.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train import compression as RC  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402


def _inputs(case):
    """(x float32 numpy, block) of a case; "reference" is the reference
    test's x = 3 normal(PRNGKey(0), (5000,)) at block 256."""
    if case == "reference":
        return np.array(jax.random.normal(jax.random.PRNGKey(0),
                                          (5000,)) * 3), 256
    rng = np.random.default_rng(7)
    if case == "default_block":
        return rng.standard_normal(3 * 1024).astype(np.float32) * 0.01, 1024
    if case == "ragged":                           # padded to the block
        return rng.standard_normal(1000).astype(np.float32), 1024
    if case == "zeros_and_halves":
        # a zero block (scale 0 -> the 1e-12 floor) and values landing on
        # .5 steps, where round-half-to-even decides
        x = np.zeros(512, np.float32)
        x[256:] = (np.arange(256, dtype=np.float32) - 128) / 2
        x[256] = 127.0
        return x, 256
    raise ValueError(case)


CASES = ["reference", "default_block", "ragged", "zeros_and_halves"]


@pytest.mark.parametrize("case", CASES)
def test_quantize_matches_reference(case):
    x, block = _inputs(case)
    wq, ws, wt = RC.quantize(jnp.asarray(x), block=block)
    gq, gs, gt = C.quantize(torch.from_numpy(x), block=block)
    assert gt == wt and gq.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("case", CASES)
def test_dequantize_and_encode_error_match_reference(case):
    x, block = _inputs(case)
    wq, ws, wt = RC.quantize(jnp.asarray(x), block=block)
    got = C.dequantize(torch.from_numpy(np.asarray(wq)),
                       torch.from_numpy(np.asarray(ws)), wt)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(RC.dequantize(wq, ws, wt)),
                               rtol=1e-6, atol=0)
    if block == C.BLOCK:
        wv, we = RC.encode_error(jnp.asarray(x))
        gv, ge = C.encode_error(torch.from_numpy(x))
        np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-6,
                                   atol=0)
        np.testing.assert_allclose(ge.numpy(), np.asarray(we), rtol=1e-6,
                                   atol=1e-6 * float(np.abs(x).max()))
        np.testing.assert_array_equal((gv + ge).numpy(), x)


@pytest.mark.parametrize("case", CASES)
def test_round_trip_within_half_a_step(case):
    """The reference test's bounds: each element within half its block's
    quantisation step; re-quantising the round trip moves it by at most
    half the largest step."""
    x, block = _inputs(case)
    t = torch.from_numpy(x)
    q, s, n = C.quantize(t, block=block)
    back = C.dequantize(q, s, n)
    per_elem = s.repeat_interleave(block)[:n]
    assert bool(((back - t).abs() <= per_elem * 0.5 + 1e-6).all())
    q2, s2, _ = C.quantize(back, block=block)
    back2 = C.dequantize(q2, s2, n)
    assert float((back2 - back).abs().max()) <= float(s.max()) * 0.5 + 1e-6


def test_wire_bytes_of_a_block():
    """int8 mantissas and one float32 scale per 1024 values: 1028 bytes
    for 4096 of float32, 3.98x fewer."""
    q, s, _ = C.quantize(torch.ones(1 << 17))
    wire = q.numel() * q.element_size() + s.numel() * s.element_size()
    assert wire == 128 * 1028
    assert 3.9 < (4 << 17) / wire < 4.0
