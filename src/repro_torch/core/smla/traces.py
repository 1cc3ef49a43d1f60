"""Synthetic memory-request traces.

The paper drives its simulator with Pin traces of 31 SPEC CPU2006 / TPC /
STREAM applications.  Those traces are not available offline, so we generate
parameterised synthetic stand-ins spanning the same characteristics space:
MPKI (memory intensity), row-buffer locality, bank/rank spread, and write
fraction.  The workload suite below covers the paper's reported MPKI range
(<1 up to >50, Fig. 11/14); per-"application" results are therefore
qualitative stand-ins while suite-average trends are the comparison target
(EXPERIMENTS.md §Paper).

Trace format: int32 arrays (n_req,) per field + float32 instruction index.
The `wr` field marks write requests (0 = read, 1 = write); it is drawn
*after* every other field from the same generator, so a trace with
`write_frac=0` is bit-identical (inst/rank/bank/row) to one generated
before writes existed.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    mpki: float          # misses per kilo-instruction
    row_hit: float       # P(next access falls in the open row)
    bank_spread: float = 1.0   # 1 = uniform banks; <1 = favours few banks
    write_frac: float = 0.0    # P(request is a write)


# 31 stand-ins spanning the paper's workload space (SPEC/TPC/STREAM-like).
# Write fractions follow the usual workload-class shapes: SPEC-like mixes
# around 15-35% writes, STREAM-triad-like 1/3, TPC-like update-heavy ~40%.
WORKLOADS: list[WorkloadSpec] = [
    WorkloadSpec("low.01", 0.3, 0.70, write_frac=0.15),
    WorkloadSpec("low.02", 0.5, 0.60, write_frac=0.25),
    WorkloadSpec("low.03", 0.8, 0.55, write_frac=0.20),
    WorkloadSpec("low.04", 1.1, 0.65, write_frac=0.30),
    WorkloadSpec("low.05", 1.6, 0.50, write_frac=0.15),
    WorkloadSpec("low.06", 2.2, 0.60, write_frac=0.25),
    WorkloadSpec("low.07", 3.0, 0.45, write_frac=0.20),
    WorkloadSpec("mid.01", 4.0, 0.55, write_frac=0.30),
    WorkloadSpec("mid.02", 5.0, 0.40, write_frac=0.15),
    WorkloadSpec("mid.03", 6.5, 0.50, write_frac=0.25),
    WorkloadSpec("mid.04", 8.0, 0.35, write_frac=0.20),
    WorkloadSpec("mid.05", 10.0, 0.45, write_frac=0.30),
    WorkloadSpec("mid.06", 12.0, 0.30, write_frac=0.15),
    WorkloadSpec("mid.07", 14.0, 0.40, write_frac=0.25),
    WorkloadSpec("mid.08", 16.0, 0.35, write_frac=0.20),
    WorkloadSpec("mid.09", 18.0, 0.50, write_frac=0.30),
    WorkloadSpec("high.01", 20.0, 0.30, write_frac=0.15),
    WorkloadSpec("high.02", 23.0, 0.45, write_frac=0.25),
    WorkloadSpec("high.03", 26.0, 0.25, write_frac=0.20),
    WorkloadSpec("high.04", 29.0, 0.40, write_frac=0.30),
    WorkloadSpec("high.05", 32.0, 0.30, write_frac=0.15),
    WorkloadSpec("high.06", 35.0, 0.50, write_frac=0.25),
    WorkloadSpec("high.07", 38.0, 0.25, write_frac=0.20),
    WorkloadSpec("high.08", 41.0, 0.35, write_frac=0.30),
    WorkloadSpec("high.09", 44.0, 0.30, write_frac=0.15),
    WorkloadSpec("high.10", 47.0, 0.20, write_frac=0.25),
    WorkloadSpec("stream.1", 50.0, 0.85, write_frac=1 / 3),
    WorkloadSpec("stream.2", 55.0, 0.80, write_frac=1 / 3),
    WorkloadSpec("stream.3", 60.0, 0.90, write_frac=1 / 3),
    WorkloadSpec("tpc.1", 22.0, 0.15, write_frac=0.40),
    WorkloadSpec("tpc.2", 28.0, 0.10, write_frac=0.40),
]


def synthetic_trace(seed: int, spec: WorkloadSpec, n_req: int,
                    n_ranks: int, n_banks: int, n_rows: int = 4096) -> dict:
    """One core's request stream."""
    rng = np.random.default_rng(seed)
    mean_gap = 1000.0 / spec.mpki
    gaps = rng.exponential(mean_gap, size=n_req) + 1.0
    inst = np.cumsum(gaps).astype(np.float32)

    rank = rng.integers(0, n_ranks, size=n_req)
    if spec.bank_spread >= 1.0:
        bank = rng.integers(0, n_banks, size=n_req)
    else:
        p = np.exp(-np.arange(n_banks) / max(spec.bank_spread * n_banks, .5))
        bank = rng.choice(n_banks, size=n_req, p=p / p.sum())
    row = np.empty(n_req, np.int64)
    cur = rng.integers(0, n_rows, size=(n_ranks, n_banks))
    stay = rng.random(n_req) < spec.row_hit
    fresh = rng.integers(0, n_rows, size=n_req)
    # Per-(rank,bank) forward fill of the open-row register: request i's
    # row is the most recent non-stay `fresh` draw targeting its bank, or
    # the bank's initial `cur` if none precedes it.  Vectorised per bank
    # key (<= n_ranks*n_banks maximum.accumulate passes) instead of one
    # Python iteration per request — draw order above is untouched, so
    # the stream is bit-identical to the historical loop on every seed.
    key = rank * n_banks + bank
    for k in np.unique(key):
        m = key == k
        g_stay = stay[m]
        seen = np.where(~g_stay, np.arange(g_stay.size), -1)
        last = np.maximum.accumulate(seen)
        start = cur[k // n_banks, k % n_banks]
        row[m] = np.where(last >= 0,
                          fresh[m][np.maximum(last, 0)], start)
    # writes LAST: the draw must not perturb inst/rank/bank/row streams.
    wr = (rng.random(n_req) < spec.write_frac).astype(np.int32)
    return {"inst": inst,
            "rank": rank.astype(np.int32),
            "bank": bank.astype(np.int32),
            "row": row.astype(np.int32),
            "wr": wr}


def core_traces(seed: int, specs: list[WorkloadSpec], n_req: int,
                n_ranks: int, n_banks: int) -> dict:
    """Stack per-core traces -> dict of (C, n_req) arrays."""
    ts = [synthetic_trace(seed + 97 * i, s, n_req, n_ranks, n_banks)
          for i, s in enumerate(specs)]
    return {k: np.stack([t[k] for t in ts]) for k in ts[0]}


def pad_traces(traces: dict, n_req_max: int) -> dict:
    """Pad every (C, n_req) field to (C, n_req_max) along the request axis.

    The engine reads requests only up to the cell's traced `n_req`, so the
    pad values (edge-replicated) are never consumed.
    """
    n_req = traces["inst"].shape[1]
    if n_req == n_req_max:
        return traces
    if n_req > n_req_max:
        raise ValueError(f"trace has {n_req} requests > pad {n_req_max}")
    pad = ((0, 0), (0, n_req_max - n_req))
    return {k: np.pad(v, pad, mode="edge") for k, v in traces.items()}


def stack_traces(trace_list: list[dict]) -> dict:
    """Stack per-cell (C, n_req) trace dicts -> (N, C, n_req_max) arrays,
    padding heterogeneous request counts to the longest."""
    n_req_max = max(t["inst"].shape[1] for t in trace_list)
    padded = [pad_traces(t, n_req_max) for t in trace_list]
    return {k: np.stack([t[k] for t in padded]) for k in padded[0]}


def lm_serving_trace(seed: int, n_req: int, n_ranks: int, n_banks: int,
                     kv_fraction: float = 0.7,
                     kv_write_frac: float = 0.1,
                     n_rows: int = 4096) -> dict:
    """A trace shaped like LM decode traffic: long sequential KV-cache
    sweeps (high row locality) interleaved with weight streaming — used to
    drive the simulator from this framework's own workloads.

    Decode writes are the per-token K/V appends: `kv_write_frac` of requests
    are writes, and they land on a monotonically advancing append row (the
    KV tail), giving the write stream the near-perfect spatial locality real
    KV caches have rather than uniform-random write addresses.
    """
    spec = WorkloadSpec("lm.decode", 45.0, 0.9 * kv_fraction + 0.05,
                        write_frac=kv_write_frac)
    t = synthetic_trace(seed, spec, n_req, n_ranks, n_banks, n_rows=n_rows)
    # retarget writes at the KV append tail: consecutive writes walk forward
    # one row every `n_banks` appends (row granularity >> one K/V entry).
    w = np.flatnonzero(t["wr"])
    if w.size:
        rng = np.random.default_rng(seed + 1)
        base = int(rng.integers(0, n_rows))
        t["row"][w] = (base + np.arange(w.size) // max(n_banks, 1)) % n_rows
    return t


# ----------------------------------------------------------------------------
# serving traffic classes (the serve<->sim bridge's parameter axis)
# ----------------------------------------------------------------------------

ARRIVALS = ("poisson", "gamma")


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """One parameterised LM-serving traffic class for the serve<->sim
    bridge (`repro.serve.bridge`): how a request stream captured from the
    serving engine is scaled out into many simulated users.

    prefill_frac  share of *tokens* processed in prefill bursts (prompt
                  ingestion arrives as one clump of requests) vs stepwise
                  decode; 0.05 is a decode-dominated chat tail, 0.5 a
                  summarisation-style ingest-heavy front.
    arrival       inter-arrival process of token boundaries per tenant:
                  "poisson" (exponential gaps) or "gamma" (same mean,
                  tunable burstiness).
    cv2           squared coefficient of variation of the gamma gaps
                  (1.0 == poisson); >1 clumps tokens into bursts — the
                  multi-tenant interference case NOM-style inter-bank
                  windows (arXiv:2004.09923) are designed around.
    n_tenants     simulated users interleaved at the controller; each
                  tenant is one core row of the trace with its own
                  disjoint KV row region.
    intensity     token arrivals per kilo-instruction, per tenant (each
                  token then expands to its profile's worth of memory
                  requests, so the MPKI-equivalent is intensity x
                  requests-per-token).  ~1.0 sits near the arrival/
                  service knee of the reduced-model profile, where the
                  arrival process actually shapes bandwidth.
    """
    name: str
    prefill_frac: float = 0.2
    arrival: str = "poisson"
    cv2: float = 1.0
    n_tenants: int = 4
    intensity: float = 40.0

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival={self.arrival!r} not in {ARRIVALS}")
        if not 0.0 < self.prefill_frac < 1.0:
            raise ValueError(f"prefill_frac={self.prefill_frac} not in (0,1)")
        if self.cv2 <= 0 or self.n_tenants < 1 or self.intensity <= 0:
            raise ValueError(f"invalid TrafficMix: {self}")


def arrival_gaps(rng: np.random.Generator, mix: TrafficMix,
                 n: int) -> np.ndarray:
    """Per-token inter-arrival gaps (instructions) for one tenant.

    Mean gap is 1000/intensity either way; "gamma" reshapes the same mean
    into bursts (shape 1/cv2, scale mean*cv2 — variance cv2 * mean^2),
    reducing to the exponential draw exactly when cv2 == 1."""
    mean = 1000.0 / mix.intensity
    if mix.arrival == "poisson" or mix.cv2 == 1.0:
        return rng.exponential(mean, size=n) + 1.0
    return rng.gamma(1.0 / mix.cv2, mean * mix.cv2, size=n) + 1.0
