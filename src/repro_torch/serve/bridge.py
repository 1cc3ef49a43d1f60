"""Serve<->sim bridge: drive the SMLA cycle engine with memory-request
streams captured from the serving engine (port of
``repro/serve/bridge.py``: numpy, copied as it is, on top of this
package's ``core/smla/traces.py``; the observer's tensors are read back to
the host with `_host`).

The repo's two halves finally talk (ROADMAP "close the serve↔sim loop"):

1. **Capture** — `capture_generate` instruments `Engine.generate`'s
   prefill/decode path (via its observer hook) and records, per step and
   per lane/tenant: whether the lane was still live, how many tokens its
   KV cache appended, and its context length.  Nothing about the serving
   loop is re-implemented here — the observer sees the real path.
2. **Lower** — `captured_trace` turns one captured run into the cycle
   engine's trace format (`{inst, rank, bank, row, wr}` int32/(f32)
   arrays of shape (n_lanes, n_req)): per-token KV-append *writes* are
   exact (one write request per token appended for a live lane, landing
   on the lane's monotonically advancing KV-tail row — never sampled),
   while the weight-stream and KV-read request streams are *strided*
   (one trace request stands for `read_stride` underlying 64B lines) so
   trace length stays bounded without touching the write invariants.
3. **Scale out** — `StreamProfile.from_capture` reduces the capture to
   per-token request rates, and `mix_trace` synthesises arbitrarily long
   multi-tenant traces from that measured profile under a
   `traces.TrafficMix` (prefill/decode token ratio, Poisson/Gamma bursty
   arrivals, tenant interleaving) — millions of simulated users from one
   small captured run.

Address model: the row space [0, n_rows) is split into equal regions —
region 0 holds the streamed weights (all tenants sweep it round-robin
across every rank/bank: weights are striped stack-wide), region 1+i is
tenant i's private KV arena on its affine rank (i mod n_ranks), where
appends walk the tail row forward one row per `n_banks` tokens exactly
like `traces.lm_serving_trace`.  Lanes finishing early are padded to the
common request count with trailing weight re-reads (reads only — write
counts stay exact); the engine consumes one fixed `n_req` per core.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.smla.traces import TrafficMix, arrival_gaps

#: one memory request moves one cache line
REQUEST_BYTES = 64

#: target read:write request ratio when `read_stride` is derived
#: automatically — keeps captured traces write-visible (~10% writes,
#: the `lm_serving_trace` regime) instead of drowned in weight sweeps
AUTO_READS_PER_WRITE = 8.0

_DTYPE_BYTES = {"float32": 4, "float16": 2, "bfloat16": 2, "int8": 1}


def _dtype_bytes(cfg) -> int:
    return _DTYPE_BYTES.get(getattr(cfg, "dtype", "bfloat16"), 2)


# ----------------------------------------------------------------------------
# capture
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StepEvents:
    """One observed serving step (prefill or a single decode)."""
    kind: str               # "prefill" | "decode"
    live: np.ndarray        # (B,) bool — lane had NOT emitted EOS before
    appended: np.ndarray    # (B,) int — KV tokens appended this step
    lengths: np.ndarray     # (B,) int — per-lane context length after


@dataclasses.dataclass
class CapturedStream:
    """Per-step memory-request events captured from one `Engine.generate`.

    `steps[0]` is the prefill (prompt ingestion: a burst of per-token KV
    appends plus one weight sweep); each further entry is one decode step
    (one KV append per lane, a weight sweep, and a KV read sweep over the
    lane's current context).
    """
    cfg: object             # the serving ModelConfig (sizes the streams)
    steps: list[StepEvents]

    @property
    def n_lanes(self) -> int:
        return int(self.steps[0].lengths.shape[0])

    @property
    def prompt_tokens(self) -> np.ndarray:
        """(B,) prompt tokens ingested at prefill."""
        return self.steps[0].appended

    @property
    def decode_steps(self) -> list[StepEvents]:
        return [s for s in self.steps if s.kind == "decode"]

    @property
    def live_decode_tokens(self) -> np.ndarray:
        """(B,) tokens decoded while the lane was live — the tokens whose
        KV appends are real traffic (frozen-lane appends are an artifact
        of synchronous batching and are not counted)."""
        out = np.zeros(self.n_lanes, np.int64)
        for s in self.decode_steps:
            out += np.where(s.live, s.appended, 0)
        return out

    def weight_bytes(self) -> int:
        """Bytes streamed per full forward pass (all params once)."""
        return int(self.cfg.n_params() * _dtype_bytes(self.cfg))

    def kv_bytes_per_token(self) -> int:
        """K+V bytes one cached token occupies across all layers."""
        hd = self.cfg.resolved_head_dim
        return int(2 * self.cfg.n_layers * self.cfg.n_kv_heads * hd
                   * _dtype_bytes(self.cfg))


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a numpy array."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def capture_generate(eng, batch, max_new_tokens: int):
    """Run `eng.generate` with the capture observer attached.

    Returns ``(generated_tokens, CapturedStream)`` — the tokens are
    exactly what an unobserved `generate` call would produce."""
    steps: list[StepEvents] = []
    prev = {"lengths": None}

    def observer(kind, *, done, lengths):
        lengths = _host(lengths).astype(np.int64)
        last = prev["lengths"]
        appended = lengths.copy() if last is None else lengths - last
        prev["lengths"] = lengths
        steps.append(StepEvents(kind, ~_host(done), appended, lengths))

    out = eng.generate(batch, max_new_tokens, observer=observer)
    return out, CapturedStream(cfg=eng.cfg, steps=steps)


# ----------------------------------------------------------------------------
# lowering: capture -> cycle-engine trace
# ----------------------------------------------------------------------------

def _regions(n_rows: int, n_lanes: int) -> tuple[int, np.ndarray]:
    """(region_size, (n_lanes,) KV base rows); region 0 is the weights."""
    region = max(n_rows // (n_lanes + 1), 2)
    bases = region * (1 + np.arange(n_lanes, dtype=np.int64))
    return region, np.minimum(bases, n_rows - region)


def _auto_stride(cap: CapturedStream) -> int:
    """Stride so the lowered trace carries ~AUTO_READS_PER_WRITE reads
    per exact KV-append write."""
    n_steps = max(len(cap.decode_steps), 1)
    writes = int(cap.prompt_tokens.sum() + cap.live_decode_tokens.sum())
    mean_ctx = float(np.mean([s.lengths.mean() for s in cap.decode_steps])
                     if cap.decode_steps else cap.prompt_tokens.mean())
    read_bytes = ((n_steps + 1) * cap.weight_bytes()
                  + n_steps * cap.n_lanes * mean_ctx
                  * cap.kv_bytes_per_token())
    raw_reads = read_bytes / REQUEST_BYTES
    return max(1, int(round(raw_reads
                            / (AUTO_READS_PER_WRITE * max(writes, 1)))))


def captured_trace(cap: CapturedStream, n_ranks: int, n_banks: int,
                   n_rows: int = 4096, *, read_stride: int | None = None,
                   inst_per_token: float = 25.0) -> dict:
    """Lower a captured stream into one engine trace (lane = core row).

    Writes are exact — one per token appended for a live lane (prompt
    tokens at prefill, one per live lane per decode step), on the lane's
    monotone KV-tail row.  Reads are strided by `read_stride` (derived
    when None): the weight sweep round-robins rank/bank over region 0,
    the KV read sweep walks the lane's region.  All requests of one step
    share that step's arrival index (`inst_per_token` instructions per
    decode step; prefill bursts at t=0) — serving steps are bursts, not
    smooth arrivals.
    """
    stride = _auto_stride(cap) if read_stride is None else int(read_stride)
    region, kv_base = _regions(n_rows, cap.n_lanes)
    w_reqs_step = max(int(round(cap.weight_bytes() / REQUEST_BYTES
                                / stride / cap.n_lanes)), 1)
    kvb = cap.kv_bytes_per_token()

    lanes = [{k: [] for k in ("inst", "rank", "bank", "row", "wr")}
             for _ in range(cap.n_lanes)]
    wptr = np.zeros(cap.n_lanes, np.int64)     # weight-sweep pointer
    kvrd = np.zeros(cap.n_lanes, np.int64)     # kv-read sweep pointer
    appended = np.zeros(cap.n_lanes, np.int64)  # exact KV appends so far
    t_now = 0.0
    for s in cap.steps:
        for i in range(cap.n_lanes):
            if not s.live[i]:
                continue
            ln = lanes[i]

            def emit(rank, bank, row, wr, ln=ln):
                ln["inst"].append(t_now)
                ln["rank"].append(int(rank) % n_ranks)
                ln["bank"].append(int(bank) % n_banks)
                ln["row"].append(int(min(row, n_rows - 1)))
                ln["wr"].append(wr)

            # weight stream: this lane's share of the stack-wide sweep
            for _ in range(w_reqs_step):
                p = int(wptr[i])
                emit(p % n_ranks, (p // n_ranks) % n_banks,
                     (p // (n_ranks * n_banks)) % region, 0)
                wptr[i] += 1
            # KV read sweep over the lane's current context (decode only)
            if s.kind == "decode":
                n_kv = int(round(s.lengths[i] * kvb / REQUEST_BYTES
                                 / stride))
                for _ in range(n_kv):
                    p = int(kvrd[i])
                    emit(i, p % n_banks,
                         kv_base[i] + (p // n_banks) % region, 0)
                    kvrd[i] += 1
            # exact per-token KV-append writes at the lane's tail
            for _ in range(int(s.appended[i])):
                a = int(appended[i])
                emit(i, a % n_banks,
                     kv_base[i] + min(a // n_banks, region - 1), 1)
                appended[i] += 1
        t_now += inst_per_token

    # equalise lanes: the engine consumes a single n_req per core, so pad
    # short (early-EOS) lanes with trailing weight re-reads — reads only,
    # the write counts above stay exact
    n_req = max(len(ln["inst"]) for ln in lanes)
    for i, ln in enumerate(lanes):
        while len(ln["inst"]) < n_req:
            p = int(wptr[i])
            ln["inst"].append(t_now)
            ln["rank"].append(p % n_ranks)
            ln["bank"].append((p // n_ranks) % n_banks)
            ln["row"].append(int((p // (n_ranks * n_banks)) % region))
            ln["wr"].append(0)
            wptr[i] += 1
    return {
        "inst": np.array([ln["inst"] for ln in lanes], np.float32),
        "rank": np.array([ln["rank"] for ln in lanes], np.int32),
        "bank": np.array([ln["bank"] for ln in lanes], np.int32),
        "row": np.array([ln["row"] for ln in lanes], np.int32),
        "wr": np.array([ln["wr"] for ln in lanes], np.int32),
    }


# ----------------------------------------------------------------------------
# scale-out: measured profile x TrafficMix -> synthetic serving traces
# ----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamProfile:
    """Per-token request rates measured from a capture (post-stride).

    One decode token costs `weight_reads + kv_reads` read requests and
    exactly one KV-append write; one prefill token costs `weight_reads`
    reads (prompt ingestion re-streams the weights but has no context to
    re-read) plus its append write."""
    weight_reads: float          # strided weight-read requests per token
    kv_reads: float              # strided KV-read requests per decode token
    prompt_tokens: float         # mean prompt length observed
    decode_tokens: float         # mean live decode tokens per lane
    read_stride: int

    @classmethod
    def from_capture(cls, cap: CapturedStream,
                     read_stride: int | None = None) -> "StreamProfile":
        stride = (_auto_stride(cap) if read_stride is None
                  else int(read_stride))
        w = max(cap.weight_bytes() / REQUEST_BYTES / stride
                / cap.n_lanes, 1.0)
        mean_ctx = float(np.mean([s.lengths.mean()
                                  for s in cap.decode_steps])
                         if cap.decode_steps
                         else cap.prompt_tokens.mean())
        kv = mean_ctx * cap.kv_bytes_per_token() / REQUEST_BYTES / stride
        return cls(weight_reads=float(w), kv_reads=float(kv),
                   prompt_tokens=float(cap.prompt_tokens.mean()),
                   decode_tokens=float(max(cap.live_decode_tokens.mean(),
                                           1.0)),
                   read_stride=stride)


def _rate_counts(rate: float, n: int) -> np.ndarray:
    """Deterministic per-token integer counts averaging `rate` (fractional
    accumulation — no RNG draw, so rates do not perturb arrival streams)."""
    edges = np.floor(rate * np.arange(n + 1)).astype(np.int64)
    return np.diff(edges)


def mix_trace(seed: int, mix: TrafficMix, prof: StreamProfile, n_req: int,
              n_ranks: int, n_banks: int, n_rows: int = 4096) -> dict:
    """Synthesise an (n_tenants, n_req) engine trace for one traffic class.

    Each tenant replays sessions shaped by the measured profile: a prompt
    of ~`prof.prompt_tokens` tokens ingested as one prefill burst, then a
    decode phase sized so prefill tokens are `mix.prefill_frac` of the
    session.  Token boundaries arrive via `traces.arrival_gaps` (Poisson
    or bursty Gamma); all requests of one token — and the whole prefill
    burst — share the boundary's arrival index.  Addresses follow the
    captured layout: shared weight region swept round-robin, per-tenant
    KV arenas with monotone-within-session append tails.
    """
    P = max(int(round(prof.prompt_tokens)), 1)
    f = mix.prefill_frac
    D = max(int(round(P * (1.0 - f) / f)), 1)
    sess_tok = P + D
    region, kv_base = _regions(n_rows, mix.n_tenants)

    out = {k: np.empty((mix.n_tenants, n_req),
                       np.float32 if k == "inst" else np.int32)
           for k in ("inst", "rank", "bank", "row", "wr")}
    for ten in range(mix.n_tenants):
        rng = np.random.default_rng(seed + 1009 * ten)
        # enough whole sessions to cover n_req requests
        req_per_sess = (sess_tok * (1 + prof.weight_reads)
                        + D * prof.kv_reads)
        n_sess = int(np.ceil(n_req / max(req_per_sess, 1.0))) + 1
        n_tok = n_sess * sess_tok
        tok_in_sess = np.tile(np.arange(sess_tok, dtype=np.int64), n_sess)
        is_prefill = tok_in_sess < P
        # arrivals: one gap per token boundary; intra-prefill gaps are
        # zeroed so a prompt lands as one burst at its session start
        gaps = arrival_gaps(rng, mix, n_tok)
        gaps = np.where(is_prefill & (tok_in_sess > 0), 0.0, gaps)
        tok_inst = np.cumsum(gaps).astype(np.float32)
        # per-token request counts from the measured profile
        n_w = _rate_counts(prof.weight_reads, n_tok)
        n_kv = np.where(is_prefill, 0, _rate_counts(prof.kv_reads, n_tok))
        n_tot = n_w + n_kv + 1                       # +1 KV-append write
        total = int(n_tot.sum())

        inst = np.repeat(tok_inst, n_tot)
        tok_of = np.repeat(np.arange(n_tok, dtype=np.int64), n_tot)
        # request kind layout within a token: weight reads, kv reads, then
        # the append write last (the token's KV exists only after compute)
        off = np.arange(total, dtype=np.int64) \
            - np.repeat(np.cumsum(n_tot) - n_tot, n_tot)
        is_wr = off == (n_tot[tok_of] - 1)
        is_kvr = ~is_wr & (off >= n_w[tok_of])
        assert total >= n_req, (total, n_req)

        # addresses: three independent sweep pointers, as in the capture
        w_ptr = np.cumsum(~is_wr & ~is_kvr) - 1
        kv_ptr = np.cumsum(is_kvr) - 1
        ap_tok = tok_in_sess[tok_of]                 # resets per session
        rank = np.where(is_wr | is_kvr, ten % n_ranks,
                        w_ptr % n_ranks).astype(np.int64)
        bank = np.where(is_wr, ap_tok % n_banks,
                        np.where(is_kvr, kv_ptr % n_banks,
                                 (w_ptr // n_ranks) % n_banks))
        row = np.where(
            is_wr, kv_base[ten] + np.minimum(ap_tok // n_banks, region - 1),
            np.where(is_kvr, kv_base[ten] + (kv_ptr // n_banks) % region,
                     (w_ptr // (n_ranks * n_banks)) % region))
        sl = slice(0, n_req)
        out["inst"][ten] = inst[sl]
        out["rank"][ten] = rank[sl].astype(np.int32)
        out["bank"][ten] = bank[sl].astype(np.int32)
        out["row"][ten] = np.minimum(row[sl], n_rows - 1).astype(np.int32)
        out["wr"][ten] = is_wr[sl].astype(np.int32)
    return out
