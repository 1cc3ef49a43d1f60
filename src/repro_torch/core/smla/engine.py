"""Cycle-level 3D-stacked DRAM simulator in PyTorch (port of
``repro.core.smla.engine``).

Time unit: one *fast cycle* = 1 / (L * F)  (1.25 ns for the paper's 4-layer,
200 MHz Wide-IO baseline) — every Table-2 quantity is an integer multiple.

The per-cycle step is the reference's fixed pipeline of stage functions
(`_STAGES`):

    refresh -> enqueue -> schedule -> transfer -> retire -> progress -> power

Each stage is written here once more over a *leading cell axis*: where the
JAX package runs one cell's `_sim_core` under ``vmap``, every state tensor
here is ``(N, ...)`` with ``N`` stacked cells, per-cell scalars are kept
as ``(N, 1)`` so they broadcast over the window axis, and every integer
is int32 exactly where the reference is.  ``jax.ops.segment_*`` become
``scatter_add_`` (rank segments, empty ones sum to 0) or reductions over
the window reshaped ``(N, n_cores, Wd)`` (core segments, never empty).
The bus-grant loop of `_stage_transfer` is written over all groups at
once; the ECC re-read cadence, which sees the grants of the groups before
it in the same cycle, reads an exclusive prefix sum of the grants, so the
reference's group order is kept.

Chunked execution with per-cell early exit: the loop runs ``chunk``-cycle
chunks; at each chunk boundary a cell whose cores all finished their
fixed work and whose refresh debt is zero stops (``loop_cond`` of the
reference) and its state freezes, exactly as JAX's batched
``while_loop`` freezes each cell under ``vmap``; ``chunks_run`` counts
the chunks each cell ran.  Cycles at or past the horizon are exact no-ops
in the reference and are simply not run.

`_sim_core` is the **plain PyTorch version** of the CUDA kernel in
``core/smla/cuda_engine.py`` (the counterpart of the reference's Pallas
``sim_cell_blocks``).  Both start from `_prepare` and finish through
`_metrics`, so the float formulas of the metrics exist once.  Dispatch is
by device: `batched_simulate` and `simulate` call the kernel's wrapper,
which runs the kernel for CUDA tensors and this plain version for CPU
tensors.  ``SimOptions(device="cuda")`` without a card raises; nothing
ever falls back to the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.smla import policies
from repro_torch.core.smla.config import StackConfig
from repro_torch.core.smla.policies import BIG

#: fast cycles per early-exit chunk; ``chunk=None`` disables chunking (one
#: chunk spanning the whole horizon — the full-horizon reference run).
DEFAULT_CHUNK = 1024

#: ``SimOptions.chunk`` sentinel: let the executor pick the width —
#: ``sweep.run_sweep`` derives one per makespan bucket (its ladder),
#: ``simulate``/``batched_simulate`` fall back to ``DEFAULT_CHUNK``.
AUTO = "auto"

I32 = torch.int32
F32 = torch.float32
INT32_MIN = -2**31


@dataclasses.dataclass(frozen=True)
class SimOptions:
    """The execution surface of the cycle engine, in one hashable value.

    horizon    fast-cycle horizon (safety net; the chunked engine exits at
               the measured makespan).
    chunk      early-exit chunk width: int pins a width, ``None`` disables
               chunking (one full-horizon chunk), ``AUTO`` (default) lets
               the executor pick — per-bucket ladder in
               ``sweep.run_sweep``, ``DEFAULT_CHUNK`` elsewhere.
    validate   check the outputs: every float metric finite, every
               cycle/event counter non-negative; a violated guard raises
               ``ValueError`` naming the metric.  Results are identical
               either way.
    device     where the simulation runs: ``"cuda"`` (default) runs the
               CUDA kernel (`cuda_engine.sim_cell_blocks`), ``"cpu"`` the
               plain PyTorch version.  ``"cuda"`` without a card raises.

    The reference's ``backend``, ``interpret`` and ``compile_cache_dir``
    have no counterpart: dispatch is by device, and PyTorch runs eagerly
    with no compiled executables to cache (the kernel library is built
    once and cached on disk by `cuda_engine`).
    """
    horizon: int
    chunk: int | None | str = AUTO
    validate: bool = False
    device: str = "cuda"

    def __post_init__(self):
        if not (self.chunk is None or self.chunk == AUTO
                or isinstance(self.chunk, (int, np.integer))):
            raise ValueError(f"chunk={self.chunk!r}: want int, None or "
                             f"{AUTO!r}")
        if (isinstance(self.chunk, (int, np.integer))
                and not isinstance(self.chunk, bool) and int(self.chunk) < 1):
            raise ValueError(f"chunk={self.chunk!r}: want >= 1")
        if int(self.horizon) < 1:
            raise ValueError(f"horizon={self.horizon!r}: want >= 1")
        if str(self.device).split(":")[0] not in ("cpu", "cuda"):
            raise ValueError(f"device={self.device!r}: want 'cuda' or 'cpu'")

    def with_chunk(self, chunk: int | None) -> "SimOptions":
        return dataclasses.replace(self, chunk=chunk)

    def resolved(self) -> "SimOptions":
        """AUTO chunk -> DEFAULT_CHUNK (single-batch executors; the sweep
        resolves AUTO per makespan bucket before it gets here)."""
        if self.chunk == AUTO:
            return dataclasses.replace(self, chunk=DEFAULT_CHUNK)
        return self

    def torch_device(self) -> torch.device:
        """The device, checked: a CUDA device without a card raises."""
        dev = torch.device(self.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"SimOptions(device={self.device!r}) but no CUDA device is "
                f"available; pass device='cpu' to run the plain PyTorch "
                f"version")
        return dev


def _require_options(options, fn_name: str) -> SimOptions:
    if not isinstance(options, SimOptions):
        raise TypeError(f"{fn_name}: pass SimOptions(horizon=..., ...) "
                        f"(got {type(options).__name__})")
    return options


def effective_chunk(horizon: int, chunk: int | None) -> int:
    """The chunk width actually used for `horizon`: clamped to
    [1, horizon]; None means one full-horizon chunk."""
    return horizon if chunk is None else max(1, min(int(chunk), horizon))


def n_chunks(horizon: int, chunk: int | None) -> int:
    """Maximum chunk-loop iterations for (horizon, chunk): the bound
    `chunks_run` reaches when early exit never engages."""
    return -(-horizon // effective_chunk(horizon, chunk))


@dataclasses.dataclass(frozen=True)
class CoreParams:
    mshr: int = 8
    inst_window: float = 128.0   # instruction-window runahead
    inst_per_fast_cycle: float = 12.0   # 3-wide * 3.2GHz * 1.25ns
    #: controller request-queue credit cap; total window occupancy across
    #: cores never exceeds it.
    q_size: int = 32
    #: tagged transaction-window depth multiplier: each core owns a
    #: private segment of min(mshr * window, q_size) entries.
    window: int = 1


def window_depth(core: CoreParams) -> int:
    """Per-core window segment size Wd = min(mshr * window, q_size)."""
    return min(core.mshr * max(int(core.window), 1), core.q_size)


# ----------------------------------------------------------------------------
# inputs: per-cell context shared by the plain version and the kernel
# ----------------------------------------------------------------------------

def _prepare(params: dict, traces: dict, core: CoreParams,
             banks: int) -> dict:
    """Everything the cycle stages read, derived once from the stacked
    params (leading cell axis ``N``) and traces ``(N, C, M)``.

    Per-cell scalars come out ``(N, 1)``, per-rank vectors ``(N, R)``.
    The derivations are the reference's `_sim_core` preamble: refresh
    timings under the refresh granularity, the weak-retention derate, the
    clock-gated transfer durations, the staggered first refresh deadline,
    and traces normalised (rank mod n_ranks, bank mod B, wr as bool,
    inst as float32)."""
    N, C, M = traces["inst"].shape
    R = params["dur"].shape[1]
    B = banks
    Wd = window_depth(core)

    def col(k):
        return params[k].to(I32).reshape(N, 1)

    pol = {k: v.reshape(N, 1) for k, v in
           policies.selector_view(params).items()}
    n_ranks = col("n_ranks")
    t_refi, t_rfc = col("t_refi"), col("t_rfc")
    refresh_en = t_refi > 0
    t_refi_eff, t_rfc_eff = policies.refresh_timings(pol, t_refi, t_rfc, B,
                                                     refresh_en)
    derate = params["ref_derate"].to(I32)
    t_refi_eff = torch.where((derate > 1) & refresh_en,
                             torch.clamp_min(
                                 t_refi_eff // torch.clamp_min(derate, 1), 1),
                             t_refi_eff)
    dur = params["dur"].to(I32)
    dur_eff = torch.where(pol["clk_gated"], dur * params["clk_div"].to(I32),
                          dur)
    ranks = torch.arange(R, dtype=I32, device=dur.device)
    nr1 = torch.clamp_min(n_ranks, 1)
    ref_next0 = (t_refi_eff * (ranks % nr1 + 1)) // nr1
    wq_hi, wq_lo = policies.drain_watermarks(core.q_size, C, core.mshr,
                                             core.window)
    rank = traces["rank"].to(I32) % n_ranks[..., None]
    bank = traces["bank"].to(I32) % B
    wr = traces["wr"].to(I32) != 0
    group = params["group_of_rank"].to(I32)
    grp = group.gather(1, rank.flatten(1).long()).view(N, C, M)
    # what enqueue copies into a window entry: its int32 fields (rank,
    # bank, row, rank*B+bank, bus group, then wr) and the int64 gather
    # indices (rank, rank*B+bank, group)
    rb = rank * B + bank
    tr_f = torch.stack([rank, bank, traces["row"].to(I32), rb, grp,
                        wr.to(I32)], -1)
    tr_l = torch.stack([rank, rb, grp], -1).long()
    dev = dur.device
    return {
        "N": N, "C": C, "M": M, "R": R, "B": B, "Wd": Wd, "QT": C * Wd,
        "core": core, "pol": pol, "wq_hi": wq_hi, "wq_lo": wq_lo,
        "n_req": col("n_req"), "n_ranks": n_ranks,
        "t_rcd": col("t_rcd"), "t_rp": col("t_rp"), "t_cl": col("t_cl"),
        "t_wr": col("t_wr"), "t_wtr": col("t_wtr"), "t_pd": col("t_pd"),
        "t_sr": col("t_sr"), "t_xsr": col("t_xsr"),
        "L": col("layers"), "slotted": params["slotted"].reshape(N, 1),
        "ecc_every": col("ecc_every"),
        "refresh_en": refresh_en, "t_refi_eff": t_refi_eff,
        "t_rfc_eff": t_rfc_eff, "dur": dur_eff,
        "group_of_rank": group,
        "real_rank": ranks < n_ranks, "ref_next0": ref_next0,
        "traces": {"inst": traces["inst"].to(F32), "rank": rank,
                   "bank": bank, "row": traces["row"].to(I32), "wr": wr},
        "tr_f": tr_f, "tr_l": tr_l,
        "pol_g": {k: v[..., None] for k, v in pol.items()},
        # index ranges (no cell axis): window slots, banks, groups
        "ar": (torch.arange(C * Wd, device=dev),
               torch.arange(R * B, device=dev),
               torch.arange(R, dtype=I32, device=dev)[:, None]),
    }


# ----------------------------------------------------------------------------
# pipeline stages: (st, aux, t, ctx) -> None, updating `st`/`aux` in place.
# Every cell of a batch is at the same cycle: `t` is that cycle as a 0-d
# int32 tensor (cheaper in elementwise ops than a Python scalar), and
# aux["cid"] the core whose turn it is to enqueue.
# ----------------------------------------------------------------------------

def _cnt(mask):
    """int32 count of True along the last axis, as a (N, 1) column."""
    return mask.sum(-1, keepdim=True, dtype=I32)


# window entry fields copied from the trace at enqueue: int32 columns of
# st["qf"] and their int64 index mirrors in st["ql"]
_QR, _QB, _QROW, _QRB, _QG = range(5)
_LR, _LRB, _LG = range(3)


def _stage_refresh(st, aux, t, ctx):
    """Refresh before issue: a due rank (all-bank) or its round-robin
    target bank (per-bank) drains, then refreshes for tRFC; under JEDEC 8x
    postponing a due refresh defers while demand is queued and owed ones
    pull in while the rank is drained (see the reference's docstring)."""
    N, R, B, pol = ctx["N"], ctx["R"], ctx["B"], ctx["pol"]
    qv, qphase, ql = st["qv"], st["qphase"], st["ql"]
    bank_busy = st["bank_busy"]
    ref_next, ref_bank = st["ref_next"], st["ref_bank"]
    ref_debt, in_sr = st["ref_debt"], st["in_sr"]
    t_rfc_eff, t_refi_eff = ctx["t_rfc_eff"], ctx["t_refi_eff"]
    work_left = aux["work_left"]

    ref_due = ctx["refresh_en"] & (ref_next <= t) & ctx["real_rank"] & ~in_sr
    demand = policies.refresh_demand(pol, st["draining"], qv, qphase,
                                     st["qwr"], ql[..., _LR], R)
    postpone = (pol["postpone"] & ref_due & demand
                & (ref_debt < policies.DEBT_CAP))
    ref_debt = ref_debt + postpone
    ref_next = torch.where(postpone, ref_next + t_refi_eff, ref_next)
    ref_due = ref_due & ~postpone

    # all-bank: the whole rank idle, nothing issued in flight; per-bank:
    # only the target bank
    in_flight_rb = (policies.segment_sum(qv & (qphase >= 2), ql[..., _LRB],
                                         R * B) > 0).view(N, R, B)
    bank_free = bank_busy <= t
    can_ab = bank_free.all(-1) & ~in_flight_rb.any(-1)
    tgt = ref_bank.long()[..., None]
    can_pb = (bank_free.gather(2, tgt)[..., 0]
              & ~in_flight_rb.gather(2, tgt)[..., 0])
    can_start = torch.where(pol["per_bank"], can_pb, can_ab)
    start_sched = ref_due & can_start
    # drain-aware pull-in of an owed refresh (needs the absence of demand)
    pull = (pol["postpone"] & (ref_debt > 0) & ~demand & ~ref_due
            & can_start & ~in_sr)
    ref_start = start_sched | pull
    ref_debt = ref_debt - pull.to(I32)

    covered = ref_start[..., None] & policies.refresh_bank_mask(pol, ref_bank,
                                                                B)
    until = (t + t_rfc_eff)[..., None]
    st["bank_busy"] = torch.where(covered, until, bank_busy)
    st["bank_row"] = st["bank_row"].masked_fill(covered, -1)   # rows close
    ref_until = torch.where(covered, until, st["ref_until"])
    st["ref_until"] = ref_until
    st["ref_next"] = torch.where(start_sched, ref_next + t_refi_eff,
                                 ref_next)
    st["ref_bank"] = torch.where(ref_start & pol["per_bank"],
                                 (ref_bank + 1) % B, ref_bank)
    # per-cycle accrual while work remains: one count per refresh event
    # in progress (a rank all-bank, a bank per-bank)
    in_ref = ref_until > t
    in_ref_all = in_ref.all(-1)
    n_ref_ev = torch.where(pol["per_bank"], _cnt(in_ref.flatten(1)),
                           _cnt(in_ref_all))
    st["refresh_cycles"] += n_ref_ev * work_left
    st["ref_rank_blocked"] += _cnt(in_ref_all & ctx["real_rank"]
                                   & work_left)
    st["ref_postponed"] += _cnt(postpone & work_left)
    st["ref_pulled_in"] += _cnt(pull & work_left)
    # ungated structural bound: debt only decays once work is done
    st["ref_debt_max"] = torch.maximum(st["ref_debt_max"],
                                       ref_debt.amax(-1, keepdim=True))
    st["ref_debt"] = ref_debt
    aux["ref_due"] = ref_due
    aux["ref_target"] = ref_bank          # pre-increment round-robin target


def _stage_enqueue(st, aux, t, ctx):
    """Round-robin one core per cycle into its private window segment,
    first free slot, tag = program-order index.  A full segment, exhausted
    credit or full MSHR file stalls the core; nothing is dropped."""
    N, Wd, core = ctx["N"], ctx["Wd"], ctx["core"]
    n_req = ctx["n_req"]
    cid = aux["cid"]
    nxt = st["c_next"][:, cid:cid + 1]
    idx = torch.minimum(nxt, n_req - 1).long()
    inst = ctx["traces"]["inst"][:, cid].gather(1, idx)
    fields = ctx["tr_f"][:, cid].gather(
        1, idx[..., None].expand(N, 1, ctx["tr_f"].shape[-1]))
    index = ctx["tr_l"][:, cid].gather(
        1, idx[..., None].expand(N, 1, ctx["tr_l"].shape[-1]))

    qv = st["qv"]
    seg = qv[:, cid * Wd:(cid + 1) * Wd]
    free_slot = cid * Wd + torch.argmin(seg.to(I32), -1, keepdim=True)
    do_enq = ((nxt < n_req) & (inst <= st["c_inst"][:, cid:cid + 1])
              & (st["c_out"][:, cid:cid + 1] < core.mshr * core.window)
              & (_cnt(qv) < core.q_size) & ~qv.gather(1, free_slot))
    put = (ctx["ar"][0] == free_slot) & do_enq
    put3 = put[..., None]
    st["qv"] = qv | put
    st["qtag"] = torch.where(put, nxt, st["qtag"])
    st["qf"] = torch.where(put3, fields[..., :-1], st["qf"])
    st["ql"] = torch.where(put3, index, st["ql"])
    st["qinst"] = torch.where(put, inst, st["qinst"])
    st["qarr"] = st["qarr"].masked_fill(put, t)
    st["qphase"] = st["qphase"].masked_fill(put, 1)
    st["qwr"] = torch.where(put, fields[..., -1] != 0, st["qwr"])
    st["whit"] = st["whit"] & ~put
    st["c_next"][:, cid:cid + 1] += do_enq
    st["c_out"][:, cid:cid + 1] += do_enq


def _stage_schedule(st, aux, t, ctx):
    """One CAS per cycle over the whole window: candidates are phase-1
    entries whose bank is free and not blocked by a due refresh; the
    write-drain policy gates writes, the scheduler and OoO bonuses rank
    them (first index wins ties), the row policy updates the bank."""
    pol = ctx["pol"]
    qv, qarr, qphase, qwr = st["qv"], st["qarr"], st["qphase"], st["qwr"]
    qf, ql = st["qf"], st["ql"]
    qrow, rb_l = qf[..., _QROW], ql[..., _LRB]
    bank_busy, bank_row = st["bank_busy"], st["bank_row"]
    work_left = aux["work_left"]

    b_busy = bank_busy.flatten(1).gather(1, rb_l) <= t
    ref_blk = policies.cas_refresh_block(pol, aux["ref_due"],
                                         aux["ref_target"], ql[..., _LR],
                                         qf[..., _QB])
    in_sr_q = st["in_sr"].gather(1, ql[..., _LR])
    cand0 = qv & (qphase == 1) & b_busy & ~ref_blk & ~in_sr_q

    # drain hysteresis arms on whole-queue write occupancy; opportunistic
    # eligibility reads the waiting backlog
    wq = qv & qwr
    n_wq_wait = _cnt(wq & (qphase == 1))
    draining = policies.update_drain_state(st["draining"], _cnt(wq),
                                           ctx["wq_hi"], ctx["wq_lo"])
    st["n_drain_bursts"] += work_left & draining & ~st["draining"]
    st["draining"] = draining
    any_read = (cand0 & ~qwr).any(-1, keepdim=True)
    wr_ok = policies.write_eligible(pol, draining, n_wq_wait, any_read,
                                    ctx["wq_lo"])
    cand = cand0 & (~qwr | wr_ok)

    open_row = bank_row.flatten(1).gather(1, rb_l)
    hit = open_row == qrow
    closed = open_row < 0
    drain_write = pol["drain_full"] & draining & qwr
    dir_match = qwr == st["grp_last_wr"].gather(1, ql[..., _LG])
    score = (policies.schedule_bonus(pol, hit, drain_write)
             + policies.ooo_schedule_bonus(pol, hit, dir_match)
             - qarr).masked_fill_(~cand, -BIG)
    pick = torch.argmax(score, -1, keepdim=True)
    can_issue = cand.gather(1, pick)
    hit_p, closed_p = hit.gather(1, pick), closed.gather(1, pick)
    t_cl, t_rcd, t_rp = ctx["t_cl"], ctx["t_rcd"], ctx["t_rp"]
    lat = torch.where(hit_p, t_cl,
                      torch.where(closed_p, t_rcd + t_cl, t_rp + t_rcd + t_cl))
    ready = t + lat
    new_row, new_busy = policies.issue_row_update(pol, qrow.gather(1, pick),
                                                  ready, t_rp)
    at_rb = ((ctx["ar"][1] == rb_l.gather(1, pick))
             & can_issue).view_as(bank_busy)
    st["bank_busy"] = torch.where(at_rb, new_busy[..., None], bank_busy)
    st["bank_row"] = torch.where(at_rb, new_row[..., None], bank_row)
    at_q = (ctx["ar"][0] == pick) & can_issue
    st["qphase"] = qphase.masked_fill(at_q, 2)
    st["qready"] = torch.where(at_q, ready, st["qready"])
    st["whit"] = torch.where(at_q, hit_p, st["whit"])
    st["n_act"] += can_issue & ~hit_p
    st["n_row_hit"] += can_issue & hit_p
    st["n_conflict"] += can_issue & ~hit_p & ~closed_p


def _stage_transfer(st, aux, t, ctx):
    """Bus grant: one transfer start per group per cycle, written over all
    groups at once (axis 1 below).  Slotted (cascaded SLR) ranks start
    only in their time slot; a refreshing bank transfers nothing; reads
    wait out the group's write-to-read window; writes keep their bank
    busy tWR past the last beat; every ``ecc_every``-th grant that is a
    read is re-read.  Padded groups never match an entry; each group owns
    its ranks, so two groups never pick one entry or one bank."""
    R, B, pol = ctx["R"], ctx["B"], ctx["pol"]
    qv, qarr, qwr, qf, ql = st["qv"], st["qarr"], st["qwr"], st["qf"], st["ql"]
    rb_l = ql[..., _LRB]
    grp_busy, grp_wr_until = st["grp_busy"], st["grp_wr_until"]
    work_left = aux["work_left"]
    ar_qt, ar_rb, ar_g = ctx["ar"]

    qphase = st["qphase"].masked_fill(
        qv & (st["qphase"] == 2) & (st["qready"] <= t), 3)
    L = ctx["L"]
    slot_match = (qf[..., _QR] % L) == (t % L)
    base = (qv & (qphase == 3) & (~ctx["slotted"] | slot_match)
            & (st["ref_until"].flatten(1).gather(1, rb_l) <= t))
    base3 = base[:, None, :] & (qf[..., _QG][:, None, :] == ar_g)
    wtr_ok = qwr[:, None, :] | (grp_wr_until <= t)[..., None]
    cand3 = base3 & wtr_ok & (grp_busy <= t)[..., None]     # (N, G, QT)
    dir_match = qwr[:, None, :] == st["grp_last_wr"][..., None]
    score3 = (policies.ooo_transfer_bonus(ctx["pol_g"],
                                          st["whit"][:, None, :], dir_match)
              - qarr[:, None, :]).masked_fill_(~cand3, -BIG)
    p3 = torch.argmax(score3, -1)                            # (N, G)
    go = cand3.gather(2, p3[..., None])[..., 0]
    wr_p = qwr.gather(1, p3)
    # ECC cadence: the grant counter as each group sees it, i.e. after
    # the grants of the groups before it in this cycle
    go_i = go.to(I32)
    n_before = st["n_grants"] + torch.cumsum(go_i, -1, dtype=I32) - go_i
    ecc = ctx["ecc_every"]
    reread = go & ~wr_p & (n_before % ecc == ecc - 1)
    dur_p = ctx["dur"].gather(1, ql[..., _LR].gather(1, p3))
    d = dur_p + dur_p * reread
    go_wr = go & wr_p
    done = t + d

    at_q = (ar_qt == p3[..., None]) & go[..., None]          # (N, G, QT)
    granted = at_q.any(1)
    st["qphase"] = qphase.masked_fill(granted, 4)
    st["qdone"] = torch.where(granted, (at_q * done[..., None]).sum(
        1, dtype=I32), st["qdone"])
    # write recovery (plus the closed-page auto-precharge) on the bank
    at_rb = (ar_rb == rb_l.gather(1, p3)[..., None]) & go_wr[..., None]
    wr_free = done + ctx["t_wr"] + policies.write_recovery_extra(
        pol, ctx["t_rp"])
    bump = (at_rb * wr_free[..., None]).masked_fill_(~at_rb,
                                                     INT32_MIN).amax(1)
    st["bank_busy"] = torch.maximum(st["bank_busy"], bump.view(-1, R, B))
    st["grp_busy"] = torch.where(go, done, grp_busy)
    st["grp_wr_until"] = torch.where(go_wr, done + ctx["t_wtr"],
                                     grp_wr_until)
    st["grp_last_wr"] = torch.where(go, wr_p, st["grp_last_wr"])
    # turnaround stall: bus free, nothing granted, a read blocked only by
    # the write-to-read window
    stall = (grp_busy <= t) & ~go & (base3 & ~wtr_ok).any(-1)
    st["wtr_stall"] += _cnt(stall & work_left)
    st["n_ecc_reread"] += _cnt(reread)
    st["bus_cycles"] += (d * go).sum(-1, keepdim=True, dtype=I32)
    st["wr_bus_cycles"] += (d * go_wr).sum(-1, keepdim=True, dtype=I32)
    st["n_grants"] += _cnt(go)
    st["n_slot_grants"] += _cnt(go & slot_match.gather(1, p3))


def _stage_retire(st, aux, t, ctx):
    """Completed transfers retire out of order; tags and MSHRs free.
    `n_ooo_retire` counts retires ahead of an older same-core tag (the
    core segments are the window reshaped (N, C, Wd), never empty)."""
    N, C, Wd = ctx["N"], ctx["C"], ctx["Wd"]
    qv = st["qv"]
    fin = qv & (st["qphase"] == 4) & (st["qdone"] <= t)
    fin_core = fin.view(N, C, Wd)
    fin_per_core = fin_core.sum(-1, dtype=I32)
    st["served"] += fin_per_core
    # segment max of where(fin, t, -1)
    st["c_finish"] = torch.where(fin_core.any(-1),
                                 torch.clamp_min(st["c_finish"], t),
                                 st["c_finish"])
    st["c_out"] -= fin_per_core
    st["n_wr"] += _cnt(fin & st["qwr"])
    rem_tag = st["qtag"].masked_fill(fin | ~qv, BIG).view(N, C, Wd)
    ooo = fin_core & (rem_tag.amin(-1, keepdim=True)
                      < st["qtag"].view(N, C, Wd))
    st["n_ooo_retire"] += _cnt(ooo.flatten(1))
    st["qv"] = qv & ~fin
    st["qphase"] = st["qphase"].masked_fill(fin, 0)


def _stage_progress(st, aux, t, ctx):
    """Core progress: the oldest outstanding instruction per core limits
    the runahead window; a core's counter freezes once its work is
    done."""
    N, C, Wd, core = ctx["N"], ctx["C"], ctx["Wd"], ctx["core"]
    n_req = ctx["n_req"]
    oldest = torch.clamp_max(
        st["qinst"].masked_fill(~st["qv"], 1e30).view(N, C, Wd).amin(-1),
        1e30)
    c_inst, c_next = st["c_inst"], st["c_next"]
    window_ok = (c_inst - oldest) < core.inst_window
    nxt = ctx["traces"]["inst"].gather(
        2, torch.minimum(c_next, n_req - 1).long()[..., None])[..., 0]
    nxt_inst = nxt.masked_fill(c_next >= n_req, 1e30)
    advance = window_ok & (st["served"] < n_req)
    st["c_inst"] = torch.minimum(
        torch.where(advance, c_inst + core.inst_per_fast_cycle, c_inst),
        nxt_inst)


def _stage_power(st, aux, t, ctx):
    """Power-down and self-refresh residency: a real rank idle t_pd cycles
    counts in power-down; under the self-refresh policy a rank idle t_sr
    cycles with no refresh debt self-refreshes until a request targets it,
    whose exit charges t_xsr."""
    R, pol = ctx["R"], ctx["pol"]
    work_left = aux["work_left"]
    pending = policies.segment_sum(st["qv"], st["ql"][..., _LR], R) > 0
    rank_idle = ((st["bank_busy"] <= t).all(-1) & ~pending
                 & ctx["real_rank"])
    idle_since = st["idle_since"].masked_fill(~rank_idle, t + 1)
    st["idle_since"] = idle_since
    idle_for = t - idle_since
    enter = (pol["sr"] & rank_idle & (idle_for >= ctx["t_sr"])
             & (st["ref_debt"] == 0))
    exit_ = st["in_sr"] & pending
    in_sr = (st["in_sr"] | enter) & ~exit_
    st["bank_busy"] = torch.where(
        exit_[..., None],
        torch.maximum(st["bank_busy"], (t + ctx["t_xsr"])[..., None]),
        st["bank_busy"])
    st["ref_next"] = torch.where(exit_, t + ctx["t_xsr"] + ctx["t_refi_eff"],
                                 st["ref_next"])
    st["in_sr"] = in_sr
    st["n_sr_exit"] += _cnt(exit_ & work_left)
    st["sr_cycles"] += _cnt(in_sr & work_left)
    in_pd = rank_idle & (idle_for >= ctx["t_pd"]) & ~in_sr
    st["pd_cycles"] += _cnt(in_pd & work_left)


#: the controller pipeline, in execution order (order is load-bearing:
#: the golden grid pins the exact cycle-level semantics it produces)
_STAGES = (_stage_refresh, _stage_enqueue, _stage_schedule,
           _stage_transfer, _stage_retire, _stage_progress, _stage_power)

#: per-cell int32 counters of the final state, in the order the CUDA
#: kernel writes them (``enum Out`` in ``csrc/smla_cycle.cuh``); the
#: metrics read only these plus the per-core served / c_finish / c_inst.
SUMMARY_INT = ("n_act", "n_conflict", "n_row_hit", "bus_cycles",
               "wr_bus_cycles", "n_wr", "refresh_cycles",
               "ref_rank_blocked", "ref_postponed", "ref_pulled_in",
               "ref_debt_max", "ref_debt_end", "pd_cycles", "sr_cycles",
               "n_sr_exit", "n_drain_bursts", "n_grants", "n_slot_grants",
               "n_ecc_reread", "wtr_stall", "n_ooo_retire", "n_enqueued",
               "n_outstanding", "chunks_run")

#: the per-cell counters of the state (each a (N, 1) int32 column)
_COUNTERS = tuple(k for k in SUMMARY_INT
                  if k not in ("ref_debt_end", "n_enqueued", "n_outstanding",
                               "chunks_run"))


def _init_state(ctx: dict) -> dict:
    N, C, R, B, QT = ctx["N"], ctx["C"], ctx["R"], ctx["B"], ctx["QT"]
    dev = ctx["n_req"].device

    def z(*shape, dtype=I32):
        return torch.zeros((N,) + shape, dtype=dtype, device=dev)

    st = {k: z(QT) for k in ("qtag", "qarr", "qphase", "qready", "qdone")}
    st["qf"] = z(QT, 5)
    st["ql"] = z(QT, 3, dtype=torch.int64)
    st.update({k: z(QT, dtype=torch.bool) for k in ("qv", "qwr", "whit")})
    st["qinst"] = z(QT, dtype=F32)
    st.update(bank_busy=z(R, B), bank_row=torch.full((N, R, B), -1,
                                                     dtype=I32, device=dev),
              ref_until=z(R, B))
    st.update({k: z(R) for k in ("grp_busy", "grp_wr_until", "ref_bank",
                                 "ref_debt", "idle_since")})
    st.update(grp_last_wr=z(R, dtype=torch.bool),
              in_sr=z(R, dtype=torch.bool),
              ref_next=ctx["ref_next0"].clone())
    st["draining"] = z(1, dtype=torch.bool)
    st["c_inst"] = z(C, dtype=F32)
    st.update({k: z(C) for k in ("c_next", "c_out", "served", "c_finish")})
    st.update({k: z(1) for k in _COUNTERS})
    return st


def _running(st: dict, ctx: dict) -> torch.Tensor:
    """(N,) the reference's ``loop_cond`` work predicate: some core still
    owes requests, or a postponed refresh is still owed."""
    return ((st["served"] < ctx["n_req"]).any(-1)
            | (st["ref_debt"] > 0).any(-1))


def _summary(st: dict, chunks_run: torch.Tensor) -> dict:
    """The final state reduced to what `_metrics` reads — exactly what the
    CUDA kernel writes back."""
    out = {k: st[k][:, 0] for k in _COUNTERS}
    out["ref_debt_end"] = st["ref_debt"].sum(-1, dtype=I32)
    out["n_enqueued"] = st["c_next"].sum(-1, dtype=I32)
    out["n_outstanding"] = st["qv"].sum(-1, dtype=I32)
    out["chunks_run"] = chunks_run
    out.update(served=st["served"], c_finish=st["c_finish"],
               c_inst=st["c_inst"])
    return out


def _sim_core(params: dict, traces: dict, horizon: int, core: CoreParams,
              banks: int, chunk: int | None = None) -> dict:
    """The plain PyTorch version: a stacked batch of cells (leading axis on
    every params/traces leaf) simulated cycle by cycle in torch ops on
    whatever device the tensors live on.  Returns the metrics dict with a
    leading cell axis.

    A chunk runs only the cells still running at its start (the others
    are frozen, as under the reference's batched ``while_loop``); cycles
    at or past the horizon are not run (the reference gates them to
    no-ops)."""
    with torch.inference_mode():
        return _sim_core_run(params, traces, horizon, core, banks, chunk)


def _sim_core_run(params, traces, horizon, core, banks, chunk):
    ctx = _prepare(params, traces, core, banks)
    st = _init_state(ctx)
    chunk_c = effective_chunk(horizon, chunk)
    dev = ctx["n_req"].device
    chunks_run = torch.zeros(ctx["N"], dtype=I32, device=dev)
    for k in range(n_chunks(horizon, chunk)):
        running = _running(st, ctx)
        live = running.nonzero()[:, 0]
        if live.numel() == 0:
            break
        chunks_run += running.to(I32)
        whole = live.numel() == ctx["N"]
        sub_st = st if whole else {name: v[live] for name, v in st.items()}
        sub_ctx = ctx if whole else _select_cells(ctx, live)
        for t in range(k * chunk_c, min((k + 1) * chunk_c, horizon)):
            aux = {"work_left": (sub_st["served"]
                                 < sub_ctx["n_req"]).any(-1, keepdim=True),
                   "cid": t % ctx["C"]}
            t_dev = torch.tensor(t, dtype=I32, device=dev)
            for stage in _STAGES:
                stage(sub_st, aux, t_dev, sub_ctx)
        if not whole:
            for name, v in sub_st.items():
                st[name][live] = v
    return _metrics(params, ctx, _summary(st, chunks_run), horizon)


def _select_cells(ctx: dict, idx: torch.Tensor) -> dict:
    """`ctx` restricted to the cells `idx` (tensors with a cell axis are
    indexed; Python values are kept)."""
    out = {}
    for k, v in ctx.items():
        if isinstance(v, torch.Tensor):
            out[k] = v[idx]
        elif isinstance(v, dict):
            out[k] = {k2: v2[idx] for k2, v2 in v.items()}
        else:
            out[k] = v
    out["N"] = int(idx.numel())
    return out


def _metrics(params: dict, ctx: dict, fin: dict, horizon: int) -> dict:
    """The metrics dict from the final-state summary `fin` (`_summary`'s
    keys).  Shared by the plain version and the CUDA kernel's wrapper, so
    the float formulas exist once; the order of every float operation is
    the reference's."""
    N, C = ctx["N"], ctx["C"]
    served, c_finish, c_inst = fin["served"], fin["c_finish"], fin["c_inst"]
    n_req = ctx["n_req"]
    unit_ns = params["unit_ns"].to(F32).reshape(N, 1)
    t_ns = horizon * unit_ns                                   # (N, 1)
    complete = served >= n_req
    finish_ns = torch.clamp_min(c_finish, 1) * unit_ns
    total_inst = ctx["traces"]["inst"].gather(
        2, (n_req - 1).long()[..., None].expand(N, C, 1))[..., 0]
    ipc = torch.where(complete, total_inst / (finish_ns * 3.2),
                      c_inst / (t_ns * 3.2))
    makespan_ns = torch.where(complete, finish_ns, t_ns).amax(-1)
    unit = unit_ns[:, 0]
    bw = (served.sum(-1, dtype=I32) * params["request_bytes"].to(F32)
          / makespan_ns)
    makespan_cycles = makespan_ns / unit
    n_ranks_f = params["n_ranks"].to(F32)
    denom = torch.clamp_min(makespan_cycles * n_ranks_f, 1.0)
    n_groups_f = torch.clamp_min(params["n_groups"].to(I32), 1).to(F32)
    return {
        "ipc": ipc,
        "served": served,
        "complete": complete,
        "bandwidth_gbps": bw,
        "n_act": fin["n_act"],
        "n_row_conflicts": fin["n_conflict"],
        "n_wr": fin["n_wr"],
        "bus_cycles": fin["bus_cycles"],
        "wr_bus_cycles": fin["wr_bus_cycles"],
        "refresh_cycles": fin["refresh_cycles"],
        "ref_rank_blocked_cycles": fin["ref_rank_blocked"],
        "ref_postponed": fin["ref_postponed"],
        "ref_pulled_in": fin["ref_pulled_in"],
        "ref_debt_max": fin["ref_debt_max"],
        "ref_debt_end": fin["ref_debt_end"],
        "pd_cycles": fin["pd_cycles"],
        "pd_frac": fin["pd_cycles"].to(F32) / denom,
        "sr_cycles": fin["sr_cycles"],
        "sr_frac": fin["sr_cycles"].to(F32) / denom,
        "n_sr_exit": fin["n_sr_exit"],
        "n_drain_bursts": fin["n_drain_bursts"],
        "n_grants": fin["n_grants"],
        "n_slot_grants": fin["n_slot_grants"],
        "n_ecc_reread": fin["n_ecc_reread"],
        "degrade_sel": params["degrade_sel"].to(I32),
        "n_row_hit": fin["n_row_hit"],
        "wtr_stall_cycles": fin["wtr_stall"],
        "n_ooo_retire": fin["n_ooo_retire"],
        "n_enqueued": fin["n_enqueued"],
        "n_outstanding": fin["n_outstanding"],
        "bus_util": fin["bus_cycles"] / torch.clamp_min(
            makespan_cycles * n_groups_f, 1),
        "horizon_ns": t_ns[:, 0],
        "makespan_ns": makespan_ns,
        "inst": c_inst,
        # diagnostic: chunks actually executed; the only metric that may
        # differ across chunk widths
        "chunks_run": fin["chunks_run"],
    }


# ----------------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------------

#: params every dict must carry; used to default legacy inputs.
_TIMING_DEFAULTS = ("t_wr", "t_wtr", "t_refi", "t_rfc", "t_pd", "t_sr",
                    "t_xsr", "ecc_every")

#: timing keys whose legacy default is "never" (BIG), not "disabled" (0).
_NEVER_DEFAULTS = ("t_pd", "t_sr", "ecc_every")


def _with_wr(traces: dict) -> dict:
    """Default a missing write field to all-reads."""
    if "wr" in traces:
        return traces
    t = dict(traces)
    t["wr"] = torch.zeros(t["inst"].shape, dtype=I32,
                          device=t["inst"].device)
    return t


def _with_timing_defaults(params: dict) -> dict:
    """Default missing write/refresh timings to 0 (disabled), missing
    idleness thresholds and ECC cadence to effectively-never, missing
    policy selectors to the paper's controller, and missing per-rank
    dividers/derates to ones: a legacy params dict reproduces the
    pre-write-era, pre-policy engine exactly."""
    missing = [k for k in _TIMING_DEFAULTS if k not in params]
    missing += [k for k in policies.SELECTOR_KEYS if k not in params]
    need_div = "clk_div" not in params
    need_derate = "ref_derate" not in params
    if not missing and not need_div and not need_derate:
        return params
    p = dict(params)
    ref = p["t_cl"]
    for k in missing:
        fill = BIG if k in _NEVER_DEFAULTS else 0
        p[k] = torch.full(ref.shape, fill, dtype=I32, device=ref.device)
    if need_div:
        p["clk_div"] = torch.ones(p["dur"].shape, dtype=I32,
                                  device=ref.device)
    if need_derate:
        p["ref_derate"] = torch.ones(p["dur"].shape, dtype=I32,
                                     device=ref.device)
    return p


#: metrics SimOptions(validate=True) guards
_VALIDATE_FINITE = ("bandwidth_gbps", "ipc", "bus_util", "pd_frac",
                    "sr_frac", "makespan_ns")
_VALIDATE_NONNEG = ("makespan_ns", "served", "bus_cycles", "wr_bus_cycles",
                    "refresh_cycles", "pd_cycles", "sr_cycles", "n_grants",
                    "n_act", "n_wr", "n_ecc_reread", "ref_debt_end",
                    "n_row_hit", "wtr_stall_cycles", "n_ooo_retire",
                    "chunks_run")


def _validate_metrics(out: dict) -> None:
    """NaN / negative-cycle guards over a metrics dict; raises
    ``ValueError`` naming the first failing metric."""
    for k in _VALIDATE_FINITE:
        if not bool(torch.isfinite(out[k]).all()):
            raise ValueError(f"validate: non-finite {k}")
    for k in _VALIDATE_NONNEG:
        if not bool((out[k] >= 0).all()):
            raise ValueError(f"validate: negative {k}")


def _on_device(tree: dict, dev: torch.device) -> dict:
    return {k: torch.as_tensor(v).to(dev) for k, v in tree.items()}


def batched_simulate(params: dict, traces: dict, options: SimOptions,
                     core: CoreParams, banks: int) -> dict:
    """Run a stacked batch of cells: every leaf has a leading cell axis.
    Leaves may be numpy arrays or tensors; they are moved to
    ``options.device``.  The multi-device sharded paths of the reference
    have nothing to map to on one card and are not ported."""
    from repro_torch.core.smla import cuda_engine    # lazy: imports us back
    options = _require_options(options, "batched_simulate").resolved()
    return run_batch(cuda_engine.sim_cell_blocks, params, traces, options,
                     core, banks, options.chunk)


def run_batch(launch, params: dict, traces: dict, options: SimOptions,
              core: CoreParams, banks: int, chunk) -> dict:
    """`batched_simulate` with the launch (`cuda_engine.sim_cell_blocks`'s
    signature) and the chunk (one width, or one per cell) given."""
    dev = options.torch_device()
    out = launch(_with_timing_defaults(_on_device(params, dev)),
                 _with_wr(_on_device(traces, dev)),
                 horizon=int(options.horizon), core=core, banks=banks,
                 chunk=chunk)
    if options.validate:
        _validate_metrics(out)
    return out


def simulate(stack: StackConfig, traces: dict, options: SimOptions,
             core: CoreParams = CoreParams()) -> dict:
    """traces: dict of (C, n_req) arrays (inst f32; rank/bank/row i32;
    optional wr i32, defaulting to all-reads).  Returns the metrics dict
    of one cell (scalars / per-core tensors on ``options.device``)."""
    options = _require_options(options, "simulate")
    n_req = np.shape(traces["inst"])[1]
    params = stack.to_params()
    params["n_req"] = np.int32(n_req)
    out = batched_simulate(
        {k: np.asarray(v)[None] for k, v in params.items()},
        {k: np.asarray(v)[None] for k, v in traces.items()},
        options, core, stack.banks_per_rank)
    return {k: v[0] for k, v in out.items()}
