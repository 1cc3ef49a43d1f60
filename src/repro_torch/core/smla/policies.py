"""Controller policy as int32 torch selectors (port of
``repro.core.smla.policies``).

Each controller choice is an integer selector carried per cell in the
engine's params (``sched_sel``, ``row_sel``, ``ref_sel``, ``drain_sel``,
``sr_sel``, ``post_sel``, ``clk_sel``, ``ooo_sel``, plus the provenance
selector ``degrade_sel``).  `selector_view` turns them into boolean
tensors once per simulation; the helpers below branch on those tensors
with ``torch.where``, never in Python, so one batch mixes every policy of
the cross-product.

Shapes: the helpers broadcast.  The batched engine hands in selector
views shaped ``(N, 1)`` (one per cell, broadcasting over the window axis)
and per-entry arrays shaped ``(N, QT)``; an unbatched caller may pass 0-d
selectors and 1-D entries.  Every integer result is int32, exactly as in
the reference; the *default* selector value reduces to the pre-policy
engine arithmetic bit-for-bit.

Score encoding (int32-safe): the schedule score is ``bonus - qarr`` with
``qarr < horizon < 2**30``.  A row hit adds ``BIG`` (2**30) under FR-FCFS;
a write during a drain-when-full burst adds ``BIG + BIG//2`` (fits int32)
so draining writes outrank even row-hit reads, as real write bursts do.
"""
from __future__ import annotations

import torch

from repro_torch.core.smla.config import (ControllerPolicy, LayerClockPolicy,
                                          OooSelect, RefreshGranularity,
                                          RefreshPostpone, RowPolicy,
                                          SchedPolicy, SelfRefreshPolicy,
                                          WriteDrainPolicy)

#: score/sentinel magnitude shared with the engine and the CUDA kernel
#: (``csrc/smla_cycle.cuh``) — the int32 score encoding depends on it
#: staying 2**30.
BIG = 2**30

#: params keys carrying the policy selectors, in to_params order.
SELECTOR_KEYS = ("sched_sel", "row_sel", "ref_sel", "drain_sel",
                 "sr_sel", "post_sel", "clk_sel", "degrade_sel", "ooo_sel")

#: out-of-order window bonuses (`OooSelect`), additive on top of
#: `schedule_bonus`: a row-group match adds BIG>>2, a direction-batch
#: match BIG>>3.  Worst-case total score stays int32-safe
#: (1.5*BIG drain + 0.375*BIG ooo = 1.875*BIG < 2**31).
OOO_ROW_BONUS = BIG >> 2
OOO_DIR_BONUS = BIG >> 3

#: JEDEC maximum number of postponed refresh commands per rank.
DEBT_CAP = 8


def t_rfc_per_bank(t_rfc):
    """JEDEC-style per-bank refresh occupancy: tRFCpb ~= tRFC/2 (rounded
    up).  Works on int tensors and Python ints alike (floor division)."""
    return (t_rfc + 1) // 2


def drain_watermarks(q_size: int, n_cores: int, mshr: int,
                     window: int = 1) -> tuple[int, int]:
    """(high, low) write-drain watermarks: 3/4 and 1/4 of the reachable
    queue occupancy min(q_size, n_cores * mshr * window)."""
    cap = max(min(q_size, n_cores * mshr * window), 1)
    return max((3 * cap) // 4, 1), cap // 4


# ----------------------------------------------------------------------------
# named presets (the benchmark / test policy axis)
# ----------------------------------------------------------------------------

#: the paper's fixed controller — the engine's bit-identical default
PAPER_DEFAULT = ControllerPolicy()

#: one single-axis flip per policy dimension plus the all-flipped corner
POLICY_PRESETS: dict[str, ControllerPolicy] = {
    "default": PAPER_DEFAULT,
    "fcfs": ControllerPolicy(scheduler=SchedPolicy.FCFS),
    "closed_page": ControllerPolicy(row=RowPolicy.CLOSED_PAGE),
    "per_bank_refresh": ControllerPolicy(
        refresh_gran=RefreshGranularity.PER_BANK),
    "drain_when_full": ControllerPolicy(
        write_drain=WriteDrainPolicy.DRAIN_WHEN_FULL),
    "opportunistic_drain": ControllerPolicy(
        write_drain=WriteDrainPolicy.OPPORTUNISTIC),
    "self_refresh": ControllerPolicy(
        self_refresh=SelfRefreshPolicy.ENABLED),
    "postpone_8x": ControllerPolicy(
        ref_postpone=RefreshPostpone.POSTPONE_8X),
    "layer_gated": ControllerPolicy(
        layer_clock=LayerClockPolicy.GATED),
    "ooo_rowdir": ControllerPolicy(ooo=OooSelect.ROW_DIR),
    "all_flipped": ControllerPolicy(
        scheduler=SchedPolicy.FCFS, row=RowPolicy.CLOSED_PAGE,
        refresh_gran=RefreshGranularity.PER_BANK,
        write_drain=WriteDrainPolicy.OPPORTUNISTIC,
        self_refresh=SelfRefreshPolicy.ENABLED,
        ref_postpone=RefreshPostpone.POSTPONE_8X),
}

#: the refresh/power corner of the cross-product, as one named axis
REFRESH_PRESETS: dict[str, ControllerPolicy] = {
    "default": PAPER_DEFAULT,
    "self_refresh": POLICY_PRESETS["self_refresh"],
    "postpone_8x": POLICY_PRESETS["postpone_8x"],
    "sr_postpone": ControllerPolicy(
        self_refresh=SelfRefreshPolicy.ENABLED,
        ref_postpone=RefreshPostpone.POSTPONE_8X),
    "pb_postpone": ControllerPolicy(
        refresh_gran=RefreshGranularity.PER_BANK,
        ref_postpone=RefreshPostpone.POSTPONE_8X),
}


def non_default_presets() -> dict[str, ControllerPolicy]:
    return {k: v for k, v in POLICY_PRESETS.items() if not v.is_default}


# ----------------------------------------------------------------------------
# boolean views of the selectors (one call per simulation, shared by stages)
# ----------------------------------------------------------------------------

def selector_view(params: dict) -> dict:
    """Boolean views of the selectors the engine stages branch on, shaped
    like the selector tensors in `params`."""
    ooo = params["ooo_sel"]
    return {
        "fcfs": params["sched_sel"] == int(SchedPolicy.FCFS),
        "closed_page": params["row_sel"] == int(RowPolicy.CLOSED_PAGE),
        "per_bank": params["ref_sel"] == int(RefreshGranularity.PER_BANK),
        "drain_full": params["drain_sel"]
        == int(WriteDrainPolicy.DRAIN_WHEN_FULL),
        "drain_opp": params["drain_sel"]
        == int(WriteDrainPolicy.OPPORTUNISTIC),
        "sr": params["sr_sel"] == int(SelfRefreshPolicy.ENABLED),
        "postpone": params["post_sel"] == int(RefreshPostpone.POSTPONE_8X),
        "clk_gated": params["clk_sel"] == int(LayerClockPolicy.GATED),
        # row grouping (ROW_GROUP | ROW_DIR) and direction batching
        # (DIR_BATCH | ROW_DIR) — both False under IN_ORDER
        "ooo_row": (ooo == int(OooSelect.ROW_GROUP))
        | (ooo == int(OooSelect.ROW_DIR)),
        "ooo_dir": (ooo == int(OooSelect.DIR_BATCH))
        | (ooo == int(OooSelect.ROW_DIR)),
    }


def refresh_timings(pol: dict, t_refi, t_rfc, banks: int,
                    refresh_en) -> tuple:
    """(t_refi_eff, t_rfc_eff) for the selected refresh granularity:
    per-bank fires `banks` times as often for tRFCpb; all-bank keeps the
    historical values."""
    per_bank = pol["per_bank"]
    t_refi_eff = torch.where(per_bank & refresh_en,
                             torch.clamp_min(t_refi // banks, 1), t_refi)
    t_rfc_eff = torch.where(per_bank, t_rfc_per_bank(t_rfc), t_rfc)
    return t_refi_eff, t_rfc_eff


def refresh_bank_mask(pol: dict, ref_bank, banks: int):
    """(..., R, B) mask of banks a starting refresh covers: the whole rank
    (all-bank) or only the round-robin target bank (per-bank)."""
    one_hot = (torch.arange(banks, dtype=torch.int32, device=ref_bank.device)
               == ref_bank[..., None])
    return one_hot | ~pol["per_bank"][..., None]


def segment_sum(values, segments, n_segments: int):
    """int32 `jax.ops.segment_sum` over the last axis: an empty segment
    sums to 0."""
    out = torch.zeros(values.shape[:-1] + (n_segments,), dtype=torch.int32,
                      device=values.device)
    return out.scatter_add_(-1, segments.long(), values.to(torch.int32))


def refresh_demand(pol: dict, draining, qv, qphase, qwr, qr, n_ranks: int):
    """(..., R) mask: does rank r have demand a postponed refresh would
    serve sooner?  Any valid entry, except writes held by an unarmed
    drain-when-full policy."""
    held_wr = pol["drain_full"] & ~draining
    counted = qv & (qphase >= 1) & ~(qwr & held_wr)
    return segment_sum(counted, qr, n_ranks) > 0


def cas_refresh_block(pol: dict, ref_due, ref_bank, qr, qb):
    """Entry mask: new CAS issue blocked because the entry's target is
    draining for a due refresh (whole rank all-bank, target bank
    per-bank)."""
    qr = qr.long()
    return (torch.gather(ref_due, -1, qr)
            & ((qb == torch.gather(ref_bank, -1, qr)) | ~pol["per_bank"]))


def schedule_bonus(pol: dict, hit, drain_write):
    """Per-entry int32 score bonus: FR-FCFS boosts row hits by BIG; a write
    in a drain-when-full burst outranks everything (BIG + BIG//2)."""
    bonus = (hit & ~pol["fcfs"]).to(torch.int32) * BIG
    return torch.where(drain_write, BIG + (BIG >> 1), bonus)


def ooo_schedule_bonus(pol: dict, hit, dir_match):
    """Additive CAS-selection bonus of the OoO window selection;
    identically zero under IN_ORDER."""
    return ((pol["ooo_row"] & hit).to(torch.int32) * OOO_ROW_BONUS
            + (pol["ooo_dir"] & dir_match).to(torch.int32) * OOO_DIR_BONUS)


def ooo_transfer_bonus(pol: dict, whit, dir_match):
    """Additive bus-grant bonus of the OoO window selection; identically
    zero under IN_ORDER."""
    return ooo_schedule_bonus(pol, whit, dir_match)


def write_eligible(pol: dict, draining, n_wq, any_read, lo: int):
    """May waiting writes issue this cycle?  INLINE always;
    DRAIN_WHEN_FULL during a burst or when no read is issuable;
    OPPORTUNISTIC above the low watermark or when no read is issuable."""
    full = draining | ~any_read
    opp = (n_wq >= lo) | ~any_read
    return torch.where(pol["drain_full"], full, opp | ~pol["drain_opp"])


def update_drain_state(draining, n_wq, hi: int, lo: int):
    """Drain-burst hysteresis: arm at the high watermark, disarm at the
    low one."""
    return (n_wq >= hi) | ((n_wq > lo) & draining)


def issue_row_update(pol: dict, row, ready, t_rp):
    """(new_bank_row, new_bank_busy) for the issued access' bank:
    open-page keeps the row open; closed-page auto-precharges."""
    closed = pol["closed_page"]
    new_row = torch.where(closed, -1, row)
    new_busy = ready + closed.to(torch.int32) * t_rp
    return new_row, new_busy


def write_recovery_extra(pol: dict, t_rp):
    """Closed-page writes auto-precharge after write recovery: tRP on top
    of tWR.  Zero under open-page."""
    return pol["closed_page"].to(torch.int32) * t_rp
