"""DRAM energy model — the paper's Table 1 / Fig. 10 decomposition into
clock-coupled and clock-decoupled current, with per-layer frequency domains.

Calibration: piecewise-linear interpolation THROUGH the paper's exact
Table 1 points (mA / nJ at 200/400/800/1600 MHz) — the published currents
are not linear in frequency (+1.15 mA per step to 800, +2.30 to 1600), so a
linear fit would misreproduce the table; interpolation is exact at the
published frequencies and linear between them (extrapolated at the ends).

Per-layer frequencies come from StackConfig.layer_freq_mhz:
  baseline F everywhere; Dedicated-IO L*F everywhere; Cascaded-IO tiers
  {L*F, ..., 2F, F} — the paper's §4.2 energy optimisation.

Units: mA * V * ns = pJ.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.smla.config import IOModel, StackConfig

_FREQS = np.array([200.0, 400.0, 800.0, 1600.0])
PD_MA = 0.24
#: self-refresh retention current (mA).  The paper's Table 1 stops at
#: power-down; self-refresh is the deeper clock-stopped state (the per-
#: layer IO clock domain is gated entirely, only the internal refresh
#: oscillator and cell retention draw), modelled Table-1-style as a
#: frequency-independent constant below the 0.24 mA power-down row.
SR_MA = 0.18
_PRE_STBY = np.array([4.24, 5.39, 6.54, 8.84])     # paper Table 1
_ACT_STBY = np.array([7.33, 8.50, 9.67, 12.0])
_E_ACTPRE = np.array([1.36, 1.37, 1.38, 1.41])
E_RD_NJ = 1.93
E_WR_NJ = 1.33


def _interp(f: float, ys: np.ndarray) -> float:
    if f <= _FREQS[0]:
        slope = (ys[1] - ys[0]) / (_FREQS[1] - _FREQS[0])
        return float(ys[0] + slope * (f - _FREQS[0]))
    if f >= _FREQS[-1]:
        slope = (ys[-1] - ys[-2]) / (_FREQS[-1] - _FREQS[-2])
        return float(ys[-1] + slope * (f - _FREQS[-1]))
    return float(np.interp(f, _FREQS, ys))


def standby_current_ma(freq_mhz: float, active: bool) -> float:
    return _interp(freq_mhz, _ACT_STBY if active else _PRE_STBY)


def act_pre_energy_nj(freq_mhz: float) -> float:
    return _interp(freq_mhz, _E_ACTPRE)


def table1(freqs=(200, 400, 800, 1600)) -> dict:
    """Reproduce the paper's Table 1 rows (exact at the published points)."""
    return {
        "Power-Down Current (mA)": [PD_MA for _ in freqs],
        "Self-Refresh Current (mA)": [SR_MA for _ in freqs],
        "Precharge-Standby Current (mA)":
            [round(standby_current_ma(f, False), 2) for f in freqs],
        "Active-Standby Current (mA)":
            [round(standby_current_ma(f, True), 2) for f in freqs],
        "Active-Precharge wo Standby (nJ)":
            [round(act_pre_energy_nj(f), 2) for f in freqs],
        "Read wo Standby (nJ)": [E_RD_NJ for _ in freqs],
        "Write wo Standby (nJ)": [E_WR_NJ for _ in freqs],
    }


@dataclasses.dataclass(frozen=True)
class EnergyBreakdown:
    standby_nj: float
    ops_nj: float

    @property
    def total_nj(self) -> float:
        return self.standby_nj + self.ops_nj


def energy_from_metrics(stack: StackConfig, metrics: dict,
                        n_wr: int | None = None,
                        pd_frac: float | None = None,
                        sr_frac: float | None = None,
                        price_refresh: bool = False) -> EnergyBreakdown:
    """EnergyBreakdown for one simulated cell's metrics dict (engine or
    sweep output): energy over the fixed-work makespan, with the measured
    bus utilisation splitting active- vs precharge-standby, the measured
    write count pricing E_WR vs E_RD, and the measured power-down /
    self-refresh residencies pricing the 0.24 mA power-down and the
    deeper SR_MA retention state.  ECC re-reads (the fault axis'
    transient-error pricing) are charged as extra reads — zero on a
    clean stack, so the default decomposition is unchanged.  The
    explicit `n_wr` / `pd_frac` / `sr_frac` arguments exist only to
    override the metrics (e.g. what-if analyses); by default all come
    out of the simulation.

    `price_refresh=True` additionally prices the measured refresh
    residency (`refresh_cycles`, which JEDEC tREFI derating of
    weak-retention ranks multiplies) at active-standby current instead
    of folding it into the background split — opt-in so every
    historical figure keeps its decomposition."""
    act_frac = float(np.clip(np.asarray(metrics["bus_util"]), 0.0, 1.0))
    if n_wr is None:
        n_wr = int(np.asarray(metrics.get("n_wr", 0)))
    if pd_frac is None:
        pd_frac = float(np.asarray(metrics.get("pd_frac", 0.0)))
    if sr_frac is None:
        sr_frac = float(np.asarray(metrics.get("sr_frac", 0.0)))
    n_served = int(np.asarray(metrics["served"]).sum())
    n_ecc = int(np.asarray(metrics.get("n_ecc_reread", 0)))
    ref_frac = 0.0
    if price_refresh:
        mk_cycles = float(metrics["makespan_ns"]) / stack.unit_ns
        r_eff = max(stack.fault_layout()["n_ranks"], 1)
        ref_frac = (float(np.asarray(metrics.get("refresh_cycles", 0)))
                    / max(mk_cycles * r_eff, 1.0))
    return stack_energy(stack, float(metrics["makespan_ns"]),
                        int(metrics["n_act"]),
                        n_served - n_wr + n_ecc,
                        act_frac, n_wr, pd_frac=pd_frac, sr_frac=sr_frac,
                        ref_frac=ref_frac)


def stack_energy(stack: StackConfig, horizon_ns: float, n_act: int,
                 n_rd: int, active_frac: float, n_wr: int = 0,
                 pd_frac: float = 0.0, sr_frac: float = 0.0,
                 vdd: float | None = None,
                 ref_frac: float = 0.0) -> EnergyBreakdown:
    """Total stack energy over a simulated window.

    standby: per-layer clock-coupled current at that layer's frequency.
    `sr_frac` of the window (the engine's measured self-refresh rank
    residency) draws only the retention current SR_MA; `pd_frac` draws
    the Table-1 power-down current; `ref_frac` (opt-in, see
    `energy_from_metrics(price_refresh=True)`) draws active-standby
    while a refresh is in progress; the remainder splits between active-
    and precharge-standby by `active_frac` (measured bus utilisation,
    capped at the share not in a deep state).  ops: frequency-decoupled
    ACT/RD/WR energy — identical across IO models, as the paper observes
    (§8.4).

    Fault awareness: a layer in `stack.faults.dead_layers` is physically
    gone and draws nothing; a layer behind a stuck TSV group is alive —
    its die keeps refreshing and drawing standby current even though its
    data path is unusable (the cost of a stuck group over a dead die).
    """
    v = stack.vdd if vdd is None else vdd
    sr = float(np.clip(sr_frac, 0.0, 1.0))
    pd = min(float(np.clip(pd_frac, 0.0, 1.0)), 1.0 - sr)
    ref = min(float(np.clip(ref_frac, 0.0, 1.0)), 1.0 - pd - sr)
    act = min(float(np.clip(active_frac, 0.0, 1.0)), 1.0 - pd - sr - ref)
    pre = max(1.0 - sr - pd - ref - act, 0.0)
    dead = set(stack.faults.dead_layers)
    standby = 0.0
    for layer in range(stack.layers):
        if layer in dead:
            continue
        # gating-aware: under LayerClockPolicy.GATED a dedicated-SLR
        # layer's clock-coupled current is priced at its gated tier clock
        f = stack.effective_layer_freq_mhz(layer)
        i_ma = (sr * SR_MA + pd * PD_MA
                + (act + ref) * standby_current_ma(f, True)
                + pre * standby_current_ma(f, False))
        standby += i_ma * v * horizon_ns * 1e-3          # pJ -> nJ
    ops = (n_act * act_pre_energy_nj(stack.base_freq_mhz)
           + n_rd * E_RD_NJ + n_wr * E_WR_NJ)
    return EnergyBreakdown(standby_nj=float(standby), ops_nj=float(ops))
