"""SMLA stack configuration — the paper's §7 Table 2/3 parameters.

All three IO models (Baseline Wide-IO, Dedicated-IO, Cascaded-IO) and both
rank organisations (MLR, SLR) are described by one `StackConfig`.

Time unit convention: the simulator works in integer *fast cycles*, where one
fast cycle = 1 / (layers × base_freq).  For the paper's 4-layer, 200 MHz
baseline this is 1.25 ns — every quantity in the paper's Table 2 is an exact
integer multiple of it (20 ns = 16, 5 ns = 4, 16.25 ns = 13, ...).
"""
from __future__ import annotations

import dataclasses
import enum
import itertools

import numpy as np

from repro_torch.core.smla.faults import ECC_OFF, DegradeMode, FaultConfig


class IOModel(enum.IntEnum):
    BASELINE = 0      # conventional Wide-IO: one layer drives the bus at F
    DEDICATED = 1     # Dedicated-IO: W/L TSVs per layer at L*F
    CASCADED = 2      # Cascaded-IO: time-multiplexed full bus at L*F


class RankOrg(enum.IntEnum):
    MLR = 0           # Multi-Layer Rank: all layers form one rank
    SLR = 1           # Single-Layer Rank: each layer is a rank


# ----------------------------------------------------------------------------
# controller policy (the paper fixes FR-FCFS / open-page / all-bank refresh;
# these selectors open the policy cross-product the engine can sweep as
# *traced* integers — changing a policy never recompiles)
# ----------------------------------------------------------------------------

class SchedPolicy(enum.IntEnum):
    FR_FCFS = 0       # row hits first, then oldest (the paper's controller)
    FCFS = 1          # strictly oldest-first, row state ignored


class RowPolicy(enum.IntEnum):
    OPEN_PAGE = 0     # rows stay open after access (the paper's controller)
    CLOSED_PAGE = 1   # auto-precharge after every access; zero row hits


class RefreshGranularity(enum.IntEnum):
    ALL_BANK = 0      # per-rank all-bank refresh: whole rank drains + blacks out
    PER_BANK = 1      # round-robin per-bank refresh; other banks keep serving
                      # (NOM-style inter-bank window, arXiv:2004.09923)


class WriteDrainPolicy(enum.IntEnum):
    INLINE = 0        # writes compete with reads immediately (the paper)
    DRAIN_WHEN_FULL = 1   # hold writes until a high watermark, then drain
                          # (writes prioritised) down to the low watermark
    OPPORTUNISTIC = 2     # issue writes above the low watermark or whenever
                          # no read is issuable (bus would otherwise idle)


class SelfRefreshPolicy(enum.IntEnum):
    OFF = 0           # power-down is the deepest rank state (the paper)
    ENABLED = 1       # a rank idle past sr_idle_ns enters self-refresh:
                      # deeper than power-down (clock stopped, retention
                      # current only), tREFI deadlines suspend while inside,
                      # exit charges t_xsr before the rank serves again


class RefreshPostpone(enum.IntEnum):
    STRICT = 0        # refresh on deadline (the paper's controller)
    POSTPONE_8X = 1   # JEDEC-style 8x postpone: a due refresh defers while
                      # demand is queued (per-rank debt counter, cap 8) and
                      # owed refreshes pull in during idle or write-drain
                      # shadow windows (drain-aware refresh scheduling)


class LayerClockPolicy(enum.IntEnum):
    UNIFORM = 0       # every layer IO link at its IO-model clock (the paper)
    GATED = 1         # DVFS-style per-layer clock gating tied to placement:
                      # a Dedicated-IO SLR layer's private link drops to the
                      # Cascaded-IO tier clock for that layer (divide-by-two
                      # counters, §4.2.1) — standby energy falls to the
                      # cascaded level, upper-layer transfers stretch by the
                      # divider.  A no-op (divider 1) wherever layers do not
                      # own private links (BASELINE, MLR) or already run the
                      # tier clocks (CASCADED).


class OooSelect(enum.IntEnum):
    """Out-of-order selection over the tagged transaction window.

    The engine's datapath is a per-core tagged window (depth
    ``CoreParams.window * mshr``, static like ``q_size``); this selector
    decides which in-flight entries the scheduler and the bus favour
    beyond plain age order.  IN_ORDER reproduces the FR-FCFS engine
    exactly — with ``window=1`` it is the bit-identical historical
    controller."""
    IN_ORDER = 0      # age order only (the historical FR-FCFS datapath)
    ROW_GROUP = 1     # prefer entries hitting the currently open row, and
                      # complete row-hit transfers ahead of bank cycles
    DIR_BATCH = 2     # group reads vs writes per bus group to amortise the
                      # tWTR write-to-read turnaround
    ROW_DIR = 3       # both: row grouping + direction batching


@dataclasses.dataclass(frozen=True)
class ControllerPolicy:
    """One point of the controller-policy cross-product.

    The default value reproduces the paper's fixed controller exactly —
    the engine is bit-identical to the pre-policy implementation under it.
    """
    scheduler: SchedPolicy = SchedPolicy.FR_FCFS
    row: RowPolicy = RowPolicy.OPEN_PAGE
    refresh_gran: RefreshGranularity = RefreshGranularity.ALL_BANK
    write_drain: WriteDrainPolicy = WriteDrainPolicy.INLINE
    self_refresh: SelfRefreshPolicy = SelfRefreshPolicy.OFF
    ref_postpone: RefreshPostpone = RefreshPostpone.STRICT
    layer_clock: LayerClockPolicy = LayerClockPolicy.UNIFORM
    ooo: OooSelect = OooSelect.IN_ORDER

    @property
    def is_default(self) -> bool:
        return self == ControllerPolicy()

    @property
    def tag(self) -> str:
        """Compact cell-name suffix, e.g. 'fcfs-closed-pb-oppdrain'.

        The two refresh/power axes append ``-sr`` / ``-post8`` only when
        non-default, so every pre-existing policy keeps its historical tag
        (cell names in benchmark JSON stay comparable across commits)."""
        if self.is_default:
            return "default"
        sched = {SchedPolicy.FR_FCFS: "frfcfs", SchedPolicy.FCFS: "fcfs"}
        row = {RowPolicy.OPEN_PAGE: "open", RowPolicy.CLOSED_PAGE: "closed"}
        ref = {RefreshGranularity.ALL_BANK: "ab",
               RefreshGranularity.PER_BANK: "pb"}
        drain = {WriteDrainPolicy.INLINE: "inline",
                 WriteDrainPolicy.DRAIN_WHEN_FULL: "fulldrain",
                 WriteDrainPolicy.OPPORTUNISTIC: "oppdrain"}
        parts = [sched[self.scheduler], row[self.row],
                 ref[self.refresh_gran], drain[self.write_drain]]
        if self.self_refresh == SelfRefreshPolicy.ENABLED:
            parts.append("sr")
        if self.ref_postpone == RefreshPostpone.POSTPONE_8X:
            parts.append("post8")
        if self.layer_clock == LayerClockPolicy.GATED:
            parts.append("clkgate")
        if self.ooo != OooSelect.IN_ORDER:
            parts.append({OooSelect.ROW_GROUP: "ooo-row",
                          OooSelect.DIR_BATCH: "ooo-dir",
                          OooSelect.ROW_DIR: "ooo-rowdir"}[self.ooo])
        return "-".join(parts)

    @classmethod
    def grid(cls, **pins) -> list["ControllerPolicy"]:
        """The full controller cross-product — the policy-search axis for
        large sweeps (2 schedulers x 2 row policies x 2 refresh
        granularities x 3 drain policies x 2 self-refresh x 2 postpone x
        2 layer clocks x 4 OoO selections = 768 policies; every selector
        is traced, so the whole axis reuses one compile per shape
        group).  Keyword pins fix
        an axis to one value or a subset, shrinking the grid:
        ``grid(row=RowPolicy.OPEN_PAGE, write_drain=[WriteDrainPolicy.
        INLINE, WriteDrainPolicy.OPPORTUNISTIC])``.  Enumeration order is
        deterministic (itertools.product over field declaration order),
        so derived cell names round-trip across runs — the sweep
        journal's keys depend on it."""
        fields = dataclasses.fields(cls)
        axes = []
        for f in fields:
            if f.name in pins:
                v = pins.pop(f.name)
                axes.append(list(v) if isinstance(v, (list, tuple))
                            else [v])
            else:
                axes.append(list(type(f.default)))
        if pins:
            raise ValueError(f"unknown policy axes: {sorted(pins)}; "
                             f"valid: {[f.name for f in fields]}")
        return [cls(**dict(zip((f.name for f in fields), combo)))
                for combo in itertools.product(*axes)]


@dataclasses.dataclass(frozen=True)
class StackConfig:
    """One 3D-stacked DRAM channel (paper Table 2 global parameters)."""
    layers: int = 4                 # stacked DRAM dies
    banks_per_rank: int = 2         # paper: 2 banks/rank
    io_bits: int = 128              # TSV data bus width per channel
    base_freq_mhz: float = 200.0    # Wide-IO baseline IO clock (F)
    request_bytes: int = 64         # cache-line request size
    io_model: IOModel = IOModel.BASELINE
    rank_org: RankOrg = RankOrg.SLR
    # DRAM core (analog-domain) timings in ns — frequency independent (§2.2).
    t_rcd_ns: float = 13.75
    t_rp_ns: float = 13.75
    t_cl_ns: float = 13.75
    # Write path (JEDEC Wide-IO / LPDDR2-class values): write recovery keeps
    # the bank busy after the last data beat; write-to-read turnaround blocks
    # the next read start on the same bus group.
    t_wr_ns: float = 15.0
    t_wtr_ns: float = 7.5
    # Refresh: one all-bank refresh per rank every tREFI, occupying the rank
    # for tRFC and closing its rows.  `refresh=False` disables it exactly
    # (every refresh code path in the engine becomes a no-op).
    refresh: bool = True
    t_refi_ns: float = 7800.0       # 64 ms / 8192 rows
    t_rfc_ns: float = 130.0         # Wide-IO 1Gb-class all-bank refresh
    # Power-down: a rank with no open activity for `pd_idle_ns` is counted
    # in power-down (Table 1's 0.24 mA state) until its next use.
    pd_idle_ns: float = 30.0
    # Self-refresh (active only under SelfRefreshPolicy.ENABLED): a rank
    # idle past `sr_idle_ns` drops below power-down into self-refresh —
    # clock stopped, retention current only (energy.SR_MA), external tREFI
    # deadlines suspended.  The next request to the rank first pays the
    # JEDEC-style exit latency `t_xsr_ns` (~tRFC + 7.5 ns re-lock).
    sr_idle_ns: float = 250.0
    t_xsr_ns: float = 137.5
    vdd: float = 1.2
    # Controller policy (scheduler x row policy x refresh granularity x
    # write drain).  The default reproduces the paper's fixed controller;
    # every selector is *traced* by the engine, so sweeping the policy
    # cross-product reuses the same compiled program.
    policy: ControllerPolicy = ControllerPolicy()
    # Fault axis (core/smla/faults.py): dead layers, stuck TSV groups,
    # weak-retention derating, transient-error rate, and the degradation
    # mode — all lowered into *traced* params by `fault_layout` /
    # `to_params`, so the fault x degradation cross-product never adds a
    # compile.  The clean default reproduces the fault-free stack
    # bit-for-bit.
    faults: FaultConfig = FaultConfig()

    def __post_init__(self):
        # eager validation: clear ValueErrors at construction time instead
        # of cryptic traced-shape errors mid-compile
        if self.layers < 1:
            raise ValueError(f"layers={self.layers}: want >= 1")
        if self.banks_per_rank < 1:
            raise ValueError(
                f"banks_per_rank={self.banks_per_rank}: want >= 1")
        if self.io_bits < 1 or self.request_bytes < 1:
            raise ValueError(
                f"io_bits={self.io_bits}, request_bytes="
                f"{self.request_bytes}: want >= 1")
        if self.base_freq_mhz <= 0:
            raise ValueError(
                f"base_freq_mhz={self.base_freq_mhz}: want > 0")
        if self.request_bytes * 8 < self.io_bits:
            raise ValueError(
                f"request_bytes={self.request_bytes} smaller than one "
                f"bus beat (io_bits={self.io_bits})")
        for f in ("t_rcd_ns", "t_rp_ns", "t_cl_ns", "t_wr_ns", "t_wtr_ns",
                  "t_refi_ns", "t_rfc_ns", "pd_idle_ns", "sr_idle_ns",
                  "t_xsr_ns"):
            if getattr(self, f) < 0:
                raise ValueError(
                    f"{f}={getattr(self, f)}: negative timing")
        self.faults.validate_for(self.layers)

    # ---- derived quantities -------------------------------------------------
    @property
    def fast_freq_mhz(self) -> float:
        """The L*F IO clock SMLA runs at (= F for the baseline's data rate)."""
        return self.base_freq_mhz * self.layers

    @property
    def unit_ns(self) -> float:
        """One fast cycle in ns — the simulator's integer time unit."""
        return 1e3 / self.fast_freq_mhz

    @property
    def n_ranks(self) -> int:
        if self.io_model == IOModel.BASELINE:
            return self.layers          # Wide-IO: each layer its own rank (Table 2)
        return 1 if self.rank_org == RankOrg.MLR else self.layers

    @property
    def banks_total(self) -> int:
        return self.n_ranks * self.banks_per_rank

    @property
    def request_beats_full_bus(self) -> int:
        """Beats needed for one request on the full-width bus."""
        return (self.request_bytes * 8) // self.io_bits

    def transfer_cycles(self, rank: int = 0) -> int:
        """Bus occupancy (fast cycles) for one 64B request — paper Table 2.

        BASELINE          : 4 beats at F      -> 4*L fast cycles (20 ns)
        DEDICATED/CASC MLR: 4 beats at L*F    -> 4 fast cycles   (5 ns)
        DEDICATED SLR     : 16 beats (W/L bus) at L*F -> 16      (20 ns)
        CASCADED SLR      : (beats-1)*L + 1 + rank               (16.25 ns
                            bottom ... 20 ns top: slots + cut-through hops;
                            avg 18.1 ns = paper Table 2 footnote)
        """
        beats = self.request_beats_full_bus
        if self.io_model == IOModel.BASELINE:
            return beats * self.layers
        if self.rank_org == RankOrg.MLR:
            return beats
        if self.io_model == IOModel.DEDICATED:
            return beats * self.layers   # narrow dedicated group, same 20 ns
        # CASCADED SLR: rank r uses slot r of every L-cycle rotation; the
        # transfer spans (beats-1) rotations plus the final slot, and layer
        # r's data takes r cut-through hops to reach the bottom (SS4.2.1).
        return (beats - 1) * self.layers + 1 + rank

    @property
    def survivor_layers(self) -> tuple[int, ...]:
        """Physical indices of layers with usable IO (not killed, not
        behind a stuck TSV group), in chain order."""
        dead = self.faults.effective_dead(self.layers)
        return tuple(l for l in range(self.layers) if l not in dead)

    def fault_layout(self) -> dict:
        """The degraded IO layout after applying `self.faults` under its
        degradation mode — the single source of truth `to_params` and
        `analytic._timing_view` both lower from.

        Returns {n_ranks, dur, n_groups, group_of_rank, slotted,
        ref_derate, ecc_every, survivors}: the *effective* rank count and
        per-rank transfer durations (np.int64 (n_ranks,)), bus grouping,
        the cascaded-SLR slotting flag, the per-rank JEDEC tREFI derating
        vector, the re-read cadence (0 = off), and the surviving physical
        layer indices.  With zero effective faults this is exactly the
        clean layout for every degradation mode — bit-identity of the
        fault-free path is a tested invariant.

        Degradation semantics (faults.DegradeMode):
        * RETIME   — the cascaded chain keeps its L-slot rotation with
          dead slots idling (aggregate slotted bandwidth falls L'/L;
          surviving rank r sits r re-bonded cut-through hops from the
          IO); shared-bus MLR spreads the same beats over the survivors
          at proportionally reduced IO frequency (ceil(beats*L/L')).
        * REMAP    — dedicated-IO fallback where per-layer TSV groups
          exist (SLR): each survivor owns a wider W/L' private group
          (beats*L' cycles, no slotting); shared-bus organisations have
          nothing to remap and degrade as under RETIME.
        * COLLAPSE — baseline single-layer access: the bottom survivor
          drives the full-width bus at F (beats*L cycles).
        """
        flt = self.faults
        survivors = self.survivor_layers
        Lp, L = len(survivors), self.layers
        beats = self.request_beats_full_bus
        slr = self.rank_org == RankOrg.SLR
        per_layer_ranks = self.io_model == IOModel.BASELINE or slr

        if Lp == L:                         # clean: the historical layout
            R = self.n_ranks
            dur = np.array([self.transfer_cycles(r) for r in range(R)],
                           np.int64)
            grouped = (self.io_model != IOModel.BASELINE and slr)
            slotted = (self.io_model == IOModel.CASCADED and slr and R > 1)
        elif flt.degrade == DegradeMode.COLLAPSE:
            R = 1
            dur = np.array([beats * L], np.int64)
            grouped, slotted = False, False
        elif not per_layer_ranks:           # MLR: one rank, shared bus
            R = 1
            grouped, slotted = False, False
            if self.io_model == IOModel.BASELINE:
                d = beats * L
            else:                           # retimed chain over L' layers
                d = -(-beats * L // Lp)
            dur = np.array([d], np.int64)
        elif self.io_model == IOModel.BASELINE:
            R = Lp                          # shared full bus, fewer ranks
            dur = np.full(R, beats * L, np.int64)
            grouped, slotted = False, False
        elif flt.degrade == DegradeMode.REMAP:
            R = Lp                          # W/L' private groups at L*F
            dur = np.full(R, beats * Lp, np.int64)
            grouped, slotted = True, False
        elif self.io_model == IOModel.DEDICATED:
            R = Lp                          # survivors keep W/L groups
            dur = np.full(R, beats * L, np.int64)
            grouped, slotted = True, False
        else:                               # RETIME cascaded SLR
            R = Lp                          # L-rotation, dead slots idle
            dur = np.array([(beats - 1) * L + 1 + r for r in range(R)],
                           np.int64)
            grouped, slotted = True, R > 1

        group_of_rank = (np.arange(R, dtype=np.int32) if grouped
                         else np.zeros(R, np.int32))
        # JEDEC 2x/4x tREFI derating for weak-retention layers, mapped
        # through the survivor renumbering; a single-rank layout derates
        # when any of the layers it spans is weak.
        weak = set(flt.weak_ranks) & set(survivors)
        derate = np.ones(R, np.int32)
        if weak:
            if R == len(survivors):
                for r, phys in enumerate(survivors[:R]):
                    if phys in weak:
                        derate[r] = flt.retention_derate
            elif R == 1 and flt.degrade == DegradeMode.COLLAPSE \
                    and Lp < L:
                if survivors[0] in weak:
                    derate[0] = flt.retention_derate
            else:                           # one rank spanning the stack
                derate[0] = flt.retention_derate
        return {"n_ranks": R, "dur": dur,
                "n_groups": R if grouped else 1,
                "group_of_rank": group_of_rank, "slotted": slotted,
                "ref_derate": derate, "ecc_every": flt.ecc_every,
                "survivors": survivors}

    def layer_freq_mhz(self, layer: int) -> float:
        """Per-layer IO clock (§4.2.1).

        BASELINE: every layer at F.  DEDICATED: every layer at L*F.
        CASCADED: lower half at L*F, next quarter at L*F/2, ... top at F
        (divide-by-two clock counters).
        """
        if self.io_model == IOModel.BASELINE:
            return self.base_freq_mhz
        if self.io_model == IOModel.DEDICATED:
            return self.fast_freq_mhz
        L = self.layers
        f = self.fast_freq_mhz
        # Walk the power-of-two tiers from the bottom: layers [0, L/2) at L*F,
        # [L/2, 3L/4) at L*F/2, ..., topmost layer at F.
        remaining, lo = L, 0
        while remaining > 1:
            half = remaining // 2
            if layer < lo + half or f == self.base_freq_mhz:
                return f
            lo += half
            remaining -= half
            f = max(f / 2.0, self.base_freq_mhz)
        return max(f, self.base_freq_mhz)

    def clock_dividers(self) -> np.ndarray:
        """Per-rank transfer-duration multipliers under
        `LayerClockPolicy.GATED` (ones under UNIFORM).

        Gating only has a target where a layer owns a private IO link:
        Dedicated-IO SLR.  There, rank r's link clock drops from L*F to
        the Cascaded-IO tier clock for layer r (divide-by-two counters),
        so its transfer duration stretches by fast_freq / tier_freq —
        [1, 1, 2, 4] for the paper's 4-layer stack.  BASELINE and MLR
        share one bus (no per-layer domain to gate) and CASCADED already
        runs the tier clocks by construction: divider 1 everywhere."""
        R = self.n_ranks
        if (self.policy.layer_clock != LayerClockPolicy.GATED
                or self.io_model != IOModel.DEDICATED
                or self.rank_org != RankOrg.SLR):
            return np.ones(R, np.int64)
        tiers = dataclasses.replace(self, io_model=IOModel.CASCADED)
        return np.array([int(round(self.fast_freq_mhz
                                   / tiers.layer_freq_mhz(r)))
                         for r in range(R)], np.int64)

    def effective_layer_freq_mhz(self, layer: int) -> float:
        """`layer_freq_mhz` after per-layer clock gating: the frequency
        the energy model prices the layer's standby current at."""
        div = self.clock_dividers()
        d = int(div[layer]) if layer < div.size else 1
        return self.layer_freq_mhz(layer) / d

    @property
    def peak_bandwidth_gbps(self) -> float:
        """Peak data bandwidth in GB/s (paper Table 2: 3.2 base / 12.8 SMLA)."""
        eff_freq = (self.base_freq_mhz if self.io_model == IOModel.BASELINE
                    else self.fast_freq_mhz)
        return self.io_bits / 8 * eff_freq * 1e6 / 1e9

    def ns_to_cycles(self, ns: float) -> int:
        return int(round(ns / self.unit_ns))

    def to_params(self, n_ranks_max: int | None = None) -> dict:
        """Numeric per-config quantities for the engine's traced step.

        Everything the cycle simulator needs at runtime, as numpy scalars /
        arrays so heterogeneous configs can be padded to a common rank axis
        (`n_ranks_max`) and stacked into one batched run.  Padded `dur` /
        `group_of_rank` entries are never referenced: trace ranks are taken
        mod `n_ranks`, and no valid queue entry maps to a padded bus group.

        Faults are lowered *here*, Python-side, through `fault_layout`:
        the degraded rank count, durations, grouping, slotting, per-rank
        refresh derating and ECC cadence are all traced data in the same
        padded shapes, so the fault x degradation cross-product (like the
        policy cross-product) never adds a compile.  The padded rank axis
        defaults to the *physical* rank count, so toggling faults on a
        config never changes its static shapes either.
        """
        lay = self.fault_layout()
        R = lay["n_ranks"]
        Rm = self.n_ranks if n_ranks_max is None else n_ranks_max
        if Rm < R:
            raise ValueError(f"n_ranks_max={Rm} < n_ranks={R}")
        dur = np.zeros(Rm, np.int32)
        dur[:R] = lay["dur"]
        # per-layer clock-gating dividers (ones unless GATED on dedicated
        # SLR), mapped through the survivor renumbering when each
        # survivor is its own rank; padded ranks get 1 so padded dur
        # stays untouched
        clk_div = np.ones(Rm, np.int32)
        div_full = self.clock_dividers()
        if R == len(lay["survivors"]) and div_full.size == self.layers:
            clk_div[:R] = div_full[np.array(lay["survivors"])]
        else:
            clk_div[:R] = div_full[:R]
        # bus groups: which ranks contend on the same bus resource
        n_groups = lay["n_groups"]
        if n_groups == 1:
            group_of_rank = np.zeros(Rm, np.int32)
        else:   # SLR dedicated (true groups) or cascaded (disjoint slots)
            group_of_rank = np.arange(Rm, dtype=np.int32)
        slotted = lay["slotted"]
        ref_derate = np.ones(Rm, np.int32)
        ref_derate[:R] = lay["ref_derate"]
        return {
            "t_rcd": np.int32(self.t_rcd),
            "t_rp": np.int32(self.t_rp),
            "t_cl": np.int32(self.t_cl),
            "t_wr": np.int32(self.t_wr),
            "t_wtr": np.int32(self.t_wtr),
            "t_refi": np.int32(self.t_refi),
            "t_rfc": np.int32(self.t_rfc),
            "t_pd": np.int32(self.t_pd),
            "t_sr": np.int32(self.t_sr),
            "t_xsr": np.int32(self.t_xsr),
            "layers": np.int32(self.layers),
            "n_ranks": np.int32(R),
            "n_groups": np.int32(n_groups),
            "dur": dur,
            "group_of_rank": group_of_rank,
            "slotted": np.bool_(slotted),
            "unit_ns": np.float32(self.unit_ns),
            "request_bytes": np.float32(self.request_bytes),
            # controller-policy selectors — traced, never part of the
            # compile key (see core/smla/policies.py)
            "sched_sel": np.int32(int(self.policy.scheduler)),
            "row_sel": np.int32(int(self.policy.row)),
            "ref_sel": np.int32(int(self.policy.refresh_gran)),
            "drain_sel": np.int32(int(self.policy.write_drain)),
            "sr_sel": np.int32(int(self.policy.self_refresh)),
            "post_sel": np.int32(int(self.policy.ref_postpone)),
            "clk_sel": np.int32(int(self.policy.layer_clock)),
            "ooo_sel": np.int32(int(self.policy.ooo)),
            "clk_div": clk_div,
            # fault axes (core/smla/faults.py) — traced like the policy
            # selectors: per-rank JEDEC tREFI derating, the ECC re-read
            # cadence (ECC_OFF = never), and the degradation-mode
            # selector (provenance: surfaces in the metrics dict so
            # sweep rows are self-describing)
            "ref_derate": ref_derate,
            "ecc_every": (np.int32(lay["ecc_every"]) if lay["ecc_every"]
                          else ECC_OFF),
            "degrade_sel": np.int32(int(self.faults.degrade)),
        }

    @property
    def t_rcd(self) -> int:
        return self.ns_to_cycles(self.t_rcd_ns)

    @property
    def t_rp(self) -> int:
        return self.ns_to_cycles(self.t_rp_ns)

    @property
    def t_cl(self) -> int:
        return self.ns_to_cycles(self.t_cl_ns)

    @property
    def t_wr(self) -> int:
        return self.ns_to_cycles(self.t_wr_ns)

    @property
    def t_wtr(self) -> int:
        return self.ns_to_cycles(self.t_wtr_ns)

    @property
    def t_refi(self) -> int:
        """Refresh interval in fast cycles; 0 means refresh disabled."""
        return self.ns_to_cycles(self.t_refi_ns) if self.refresh else 0

    @property
    def t_rfc(self) -> int:
        return self.ns_to_cycles(self.t_rfc_ns)

    @property
    def t_pd(self) -> int:
        return self.ns_to_cycles(self.pd_idle_ns)

    @property
    def t_sr(self) -> int:
        """Self-refresh entry threshold in fast cycles."""
        return self.ns_to_cycles(self.sr_idle_ns)

    @property
    def t_xsr(self) -> int:
        """Self-refresh exit latency in fast cycles."""
        return self.ns_to_cycles(self.t_xsr_ns)


# The paper's evaluated configurations (Table 2), as a registry.
def paper_configs(layers: int = 4) -> dict[str, StackConfig]:
    return {
        "baseline": StackConfig(layers=layers, io_model=IOModel.BASELINE,
                                rank_org=RankOrg.SLR),
        "dedicated_mlr": StackConfig(layers=layers, io_model=IOModel.DEDICATED,
                                     rank_org=RankOrg.MLR),
        "dedicated_slr": StackConfig(layers=layers, io_model=IOModel.DEDICATED,
                                     rank_org=RankOrg.SLR),
        "cascaded_mlr": StackConfig(layers=layers, io_model=IOModel.CASCADED,
                                    rank_org=RankOrg.MLR),
        "cascaded_slr": StackConfig(layers=layers, io_model=IOModel.CASCADED,
                                    rank_org=RankOrg.SLR),
    }
