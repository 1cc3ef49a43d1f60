"""The port's int32 torch policy helpers against the reference's jnp
helpers on random inputs (made with numpy from a seed), under every
selector value: same values, int32 where the reference is int32."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.smla import policies as ref  # noqa: E402
from repro_torch.core.smla import policies as port  # noqa: E402

QT, R, B = 16, 4, 2

#: every 7th combination of the selectors (7 is prime to every axis
#: length, so each value of each selector appears)
SELECTORS = [dict(zip(("sched_sel", "row_sel", "ref_sel", "drain_sel",
                       "sr_sel", "post_sel", "clk_sel", "ooo_sel"), v))
             for v in itertools.product((0, 1), (0, 1), (0, 1), (0, 1, 2),
                                        (0, 1), (0, 1), (0, 1),
                                        (0, 1, 2, 3))][::7]


def _views(sel):
    params = {k: np.int32(v) for k, v in sel.items()}
    params["degrade_sel"] = np.int32(0)
    pol_ref = ref.selector_view({k: jnp.asarray(v) for k, v in params.items()})
    pol_port = port.selector_view({k: torch.tensor(v)
                                   for k, v in params.items()})
    return pol_ref, pol_port


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if want.dtype != np.bool_:
        assert got.dtype == np.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_constants():
    assert port.BIG == int(ref.BIG) == 2**30
    assert port.OOO_ROW_BONUS == int(ref.OOO_ROW_BONUS)
    assert port.OOO_DIR_BONUS == int(ref.OOO_DIR_BONUS)
    assert port.DEBT_CAP == ref.DEBT_CAP
    assert port.SELECTOR_KEYS == ref.SELECTOR_KEYS
    assert port.t_rfc_per_bank(13) == ref.t_rfc_per_bank(13)
    for args in ((32, 2, 8, 1), (8, 1, 8, 4), (1, 1, 1, 1), (64, 8, 8, 2)):
        assert port.drain_watermarks(*args) == ref.drain_watermarks(*args)
    for presets in ("POLICY_PRESETS", "REFRESH_PRESETS"):
        got, want = getattr(port, presets), getattr(ref, presets)
        assert list(got) == list(want)
        assert [p.tag for p in got.values()] == [p.tag for p in want.values()]
    assert list(port.non_default_presets()) == list(ref.non_default_presets())


@pytest.mark.parametrize("seed", [0])
def test_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    for sel in SELECTORS:
        pr, pp = _views(sel)
        for k in pr:
            assert bool(pp[k]) == bool(pr[k]), k
        qv = rng.random(QT) < 0.7
        qphase = rng.integers(0, 5, QT).astype(np.int32)
        qwr = rng.random(QT) < 0.4
        qr = rng.integers(0, R, QT).astype(np.int32)
        qb = rng.integers(0, B, QT).astype(np.int32)
        hit = rng.random(QT) < 0.5
        dwr = rng.random(QT) < 0.3
        dmatch = rng.random(QT) < 0.5
        ref_due = rng.random(R) < 0.5
        ref_bank = rng.integers(0, B, R).astype(np.int32)
        draining = np.bool_(rng.random() < 0.5)
        n_wq = np.int32(rng.integers(0, 12))
        any_read = np.bool_(rng.random() < 0.5)
        t = {k: torch.from_numpy(np.asarray(v)) for k, v in dict(
            qv=qv, qphase=qphase, qwr=qwr, qr=qr, qb=qb, hit=hit, dwr=dwr,
            dmatch=dmatch, ref_due=ref_due, ref_bank=ref_bank,
            draining=draining, n_wq=n_wq,
            any_read=any_read).items()}
        _same(port.schedule_bonus(pp, t["hit"], t["dwr"]),
              ref.schedule_bonus(pr, hit, dwr))
        _same(port.ooo_schedule_bonus(pp, t["hit"], t["dmatch"]),
              ref.ooo_schedule_bonus(pr, hit, dmatch))
        _same(port.ooo_transfer_bonus(pp, t["hit"], t["dmatch"]),
              ref.ooo_transfer_bonus(pr, hit, dmatch))
        _same(port.refresh_demand(pp, t["draining"], t["qv"], t["qphase"],
                                  t["qwr"], t["qr"], R),
              ref.refresh_demand(pr, draining, qv, qphase, qwr, qr, R))
        _same(port.cas_refresh_block(pp, t["ref_due"], t["ref_bank"],
                                     t["qr"], t["qb"]),
              ref.cas_refresh_block(pr, ref_due, ref_bank, qr, qb))
        _same(port.refresh_bank_mask(pp, t["ref_bank"], B),
              jnp.broadcast_to(ref.refresh_bank_mask(pr, ref_bank, B),
                               (R, B)))
        _same(port.write_eligible(pp, t["draining"], t["n_wq"],
                                  t["any_read"], 3),
              ref.write_eligible(pr, draining, n_wq, any_read, 3))
        _same(port.update_drain_state(t["draining"], t["n_wq"], 8, 3),
              ref.update_drain_state(draining, n_wq, 8, 3))
        row, ready, t_rp = (np.int32(rng.integers(0, 4096)),
                            np.int32(rng.integers(0, 5000)), np.int32(11))
        for g, w in zip(port.issue_row_update(pp, torch.tensor(row),
                                              torch.tensor(ready),
                                              torch.tensor(t_rp)),
                        ref.issue_row_update(pr, row, ready, t_rp)):
            _same(g, w)
        _same(port.write_recovery_extra(pp, torch.tensor(t_rp)),
              ref.write_recovery_extra(pr, t_rp))
        t_refi, t_rfc = np.int32(rng.integers(0, 7000)), np.int32(104)
        en = np.bool_(t_refi > 0)
        for g, w in zip(port.refresh_timings(pp, torch.tensor(t_refi),
                                             torch.tensor(t_rfc), B,
                                             torch.tensor(en)),
                        ref.refresh_timings(pr, t_refi, t_rfc, B, en)):
            _same(g, w)


def test_segment_sum_empty_segments_are_zero():
    vals = torch.tensor([[True, False, True]])
    seg = torch.tensor([[0, 0, 3]], dtype=torch.int32)
    out = port.segment_sum(vals, seg, 5)
    assert out.dtype == torch.int32
    assert out.tolist() == [[1, 0, 0, 1, 0]]
