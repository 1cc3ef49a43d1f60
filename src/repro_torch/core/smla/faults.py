"""Fault injection & graceful degradation for the SMLA stack.

Cascaded-IO's 4X bandwidth claim rests on a coordination chain across all
stacked layers — so a single dead layer, stuck TSV group, or
weak-retention rank is exactly the failure class a 3D-stacked interface
must degrade through gracefully (TSV defects and thermally-driven
retention derating are first-order HMC concerns, arXiv:1706.02725; the
datacenter-sizing question of arXiv:1608.07485 is as much "what happens
when hardware degrades under load" as peak bandwidth).  This module
defines the fault axes and the degradation responses; `StackConfig`
carries a `FaultConfig` and lowers it into the engine's *traced* params
(`StackConfig.fault_layout` / `to_params`), so the whole
fault x degradation x policy cross-product sweeps with zero extra
compiles — identically to the controller-policy axes.

Fault axes
----------
* ``dead_layers``   — per-layer kill set: the die is gone.  No IO, no
  refresh, no standby draw (energy.py excludes it).
* ``stuck_groups``  — TSV stuck-at faults on a layer's IO group: the
  layer's data path is unusable, but the die itself is alive — it still
  refreshes and draws standby current.  For IO purposes the layer joins
  the effective-dead set; the degradation mode decides the response.
* ``weak_ranks``    — weak-retention layers: their refresh interval is
  derated by ``retention_derate`` (JEDEC-style 2x/4x tREFI shortening —
  the thermally-derated rows of arXiv:1706.02725), lowered into the
  per-rank traced ``ref_derate`` vector.
* ``ecc_rate``      — transient (soft) error rate per read burst, priced
  as ECC re-read overhead: every ``round(1/rate)``-th granted read
  re-occupies its bus group for a second transfer (detect-and-re-read),
  lowered into the traced scalar ``ecc_every``.

Degradation modes (`DegradeMode`, traced as ``degrade_sel``)
-----------------------------------------------------------
* ``RETIME``   — re-time the Cascaded-IO chain over the surviving L'
  layers: the L-slot rotation keeps its period, dead layers' slots idle,
  so aggregate slotted bandwidth falls proportionally (L'/L) while each
  surviving rank keeps its clean per-request timing; shared-bus
  organisations (MLR) spread the same beats over the survivors
  (``ceil(beats*L/L')`` — proportionally reduced IO frequency).
* ``REMAP``    — fall back to Dedicated-IO style private groups: the
  dead layer's TSVs are reassigned to the survivors, each of which now
  owns a wider W/L' group (``beats*L'`` cycles per request, no slotting).
  Only meaningful where per-layer TSV groups exist (SLR dedicated /
  cascaded); shared-bus organisations degrade as under RETIME.
* ``COLLAPSE`` — collapse to baseline single-layer access: one surviving
  rank drives the full-width bus at F (``beats*L`` cycles per request).

With zero effective faults every mode reproduces the clean layout
bit-for-bit (the golden grid passes UNREGENERATED), and
`analytic.estimate_service_cycles` stays a true upper bound under every
fault preset (tests/test_faults.py).
"""
from __future__ import annotations

import dataclasses
import enum

import numpy as np

#: traced ``ecc_every`` value meaning "never" — same magnitude as
#: `policies.BIG` (grant counters stay far below 2**30), duplicated here
#: so config/faults never import policies (policies imports config).
ECC_OFF = np.int32(2**30)

#: allowed JEDEC-style tREFI derating factors (1 = nominal, 2x/4x =
#: shortened interval for weak-retention ranks)
RETENTION_DERATES = (1, 2, 4)


class DegradeMode(enum.IntEnum):
    RETIME = 0     # re-time the cascaded chain over surviving layers
    REMAP = 1      # dedicated-IO fallback, dead TSV group reassigned
    COLLAPSE = 2   # baseline single-layer access


_MODE_TAG = {DegradeMode.RETIME: "retime", DegradeMode.REMAP: "remap",
             DegradeMode.COLLAPSE: "collapse"}


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """One point of the fault axis.  The default is the clean stack —
    every consumer reproduces the historical behaviour bit-for-bit
    under it."""
    dead_layers: tuple[int, ...] = ()
    stuck_groups: tuple[int, ...] = ()
    weak_ranks: tuple[int, ...] = ()
    retention_derate: int = 2          # applied to weak_ranks only
    ecc_rate: float = 0.0              # transient errors per read burst
    degrade: DegradeMode = DegradeMode.RETIME

    def __post_init__(self):
        # normalise the index sets (sorted, deduped tuples) so equal
        # fault configs hash/compare equal regardless of construction
        for f in ("dead_layers", "stuck_groups", "weak_ranks"):
            object.__setattr__(self, f,
                               tuple(sorted(set(int(i) for i in
                                                getattr(self, f)))))
        if self.retention_derate not in RETENTION_DERATES:
            raise ValueError(
                f"retention_derate={self.retention_derate}: JEDEC derating "
                f"must be one of {RETENTION_DERATES}")
        if not 0.0 <= self.ecc_rate <= 0.5:
            raise ValueError(
                f"ecc_rate={self.ecc_rate}: want a probability in "
                f"[0, 0.5] (above 0.5 the re-read model is meaningless)")
        object.__setattr__(self, "degrade", DegradeMode(self.degrade))
        for f in ("dead_layers", "stuck_groups", "weak_ranks"):
            bad = [i for i in getattr(self, f) if i < 0]
            if bad:
                raise ValueError(f"{f}={getattr(self, f)}: negative layer "
                                 f"index {bad[0]}")

    def validate_for(self, layers: int) -> None:
        """Eager range checks against the owning stack's layer count —
        a clear ValueError at construction instead of a cryptic traced
        shape error mid-compile."""
        for f in ("dead_layers", "stuck_groups", "weak_ranks"):
            mask = getattr(self, f)
            if any(i >= layers for i in mask):
                raise ValueError(
                    f"{f}={mask} wider than the stack: layer index "
                    f">= layers={layers}")
        if len(self.effective_dead(layers)) >= layers:
            raise ValueError(
                f"dead_layers={self.dead_layers} + stuck_groups="
                f"{self.stuck_groups} kill all {layers} layers; at least "
                f"one layer must survive")

    def effective_dead(self, layers: int) -> frozenset:
        """Layers with no usable IO: killed dies plus dies behind a
        stuck TSV group (the die is alive — it refreshes and draws
        standby current — but its data path is gone)."""
        return frozenset(i for i in self.dead_layers + self.stuck_groups
                         if i < layers)

    @property
    def ecc_every(self) -> int:
        """Every Nth granted read pays a re-read; 0 = off (lowered to
        the traced ``ECC_OFF`` sentinel by `to_params`)."""
        if self.ecc_rate <= 0.0:
            return 0
        return max(int(round(1.0 / self.ecc_rate)), 2)

    @property
    def is_clean(self) -> bool:
        return (not self.dead_layers and not self.stuck_groups
                and not self.weak_ranks and self.ecc_rate == 0.0)

    @property
    def tag(self) -> str:
        """Compact cell-name suffix, e.g. 'kill3+weak0x4-retime'."""
        if self.is_clean:
            return "clean"
        parts = []
        if self.dead_layers:
            parts.append("kill" + "".join(str(i) for i in self.dead_layers))
        if self.stuck_groups:
            parts.append("stuck" + "".join(str(i)
                                           for i in self.stuck_groups))
        if self.weak_ranks:
            parts.append("weak"
                         + "".join(str(i) for i in self.weak_ranks)
                         + f"x{self.retention_derate}")
        if self.ecc_rate > 0.0:
            parts.append(f"ecc{self.ecc_rate:g}")
        return "+".join(parts) + "-" + _MODE_TAG[self.degrade]
