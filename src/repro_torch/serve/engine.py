"""Serving engine: batched prefill + decode with MLR/SLR placement policies
(port of ``repro/serve/engine.py``).

Rank-organisation mapping (paper §5 -> serving), on a ('pod', 'data',
'model') mesh:

* **MLR** (multi-layer rank): every request is striped across ALL ranks
  of 'model': params TP-sharded over 'model' (and FSDP-sharded over
  'data'), KV heads over 'model', the batch over ('pod', 'data').
* **SLR** (single-layer rank): the 'model' axis becomes extra request
  parallelism: params replicated over 'model' (FSDP gathering only), the
  batch and its cache over ('pod', 'data', 'model').

Same hardware, scheduling choice only: the paper's MLR/SLR trade-off.
``benchmarks/serve_policies.py`` measures both (the collective bytes per
decoded token that the port issues).

With a mesh (a ``DeviceMesh`` over the whole process group, every rank
calling the same methods) each rank keeps its shards of the params as
plain local tensors (``partitioning.local_shard``), cuts its requests and
their cache out of the global batch (`batch_dp_axes`; a batch that does
not divide stays whole on every rank), runs the transformer's sharded
path (``models.common.MeshContext``: every collective issued through
``core/collectives.py`` and counted in `Engine.log`) and returns the
whole batch's tokens on every rank.  The reference places only the
params and leaves the batch and cache to GSPMD; the values are the same,
the communication schedule is the port's own.  The transformer families
serve on a mesh; the others raise (``models.check_mesh``).  Without a
mesh both policies are the one-device path.

The engine runs on ``cuda`` unless the caller passes ``device="cpu"``;
CUDA without a card raises.  With ``ParallelConfig(attn_impl="pallas")``
prefill goes through the flash-attention kernel and every decode step
through the flash-decode kernel (their plain versions on the CPU), on
each rank's own heads on a mesh.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, _param_shapes
from repro_torch.core import partitioning as part
from repro_torch.core.comm import axis_sizes
from repro_torch.models import check_mesh
from repro_torch.models import common as cm
from repro_torch.models import get_model
from repro_torch.models.transformer import logits_fn


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 2048
    policy: str = "mlr"            # mlr | slr
    temperature: float = 0.0       # 0 = greedy
    eos_id: int = -1               # -1 = never stop


def _slr_param_specs(pspecs):
    """Drop 'model' from every param spec (replicate over the model axis)."""
    return part.strip_axis(pspecs, "model")


def batch_dp_axes(policy: str) -> tuple[str, ...]:
    return (("pod", "data", "model") if policy == "slr"
            else ("pod", "data"))


def param_specs(cfg: ModelConfig, policy: str, mesh) -> dict:
    """The filtered specs of `cfg`'s params on `mesh` under `policy`."""
    shapes = cm.unflatten_paths({k: torch.empty(s, device="meta") for k, s
                                 in _param_shapes(cfg).items()})
    specs = part.param_specs(shapes, mesh)
    return _slr_param_specs(specs) if policy == "slr" else specs


def make_serve_fns(cfg: ModelConfig, pcfg: ParallelConfig, scfg: ServeConfig,
                   mesh=None):
    """Returns (prefill_fn, decode_fn, specs or None).  Without a mesh (or
    one whose axes are all of size 1), the one-device functions and None;
    with one, functions that take this rank's blocks and a
    ``common.MeshContext`` as ``mesh=``, and ``{"params": the filtered
    param specs of the policy}``."""
    if scfg.policy not in ("mlr", "slr"):
        raise ValueError(f"ServeConfig.policy {scfg.policy!r}: want 'mlr' "
                         f"or 'slr'")
    model = get_model(cfg)
    sharded = check_mesh(cfg, mesh)

    def prefill_fn(params, batch, cache, **kw):
        cache, last_hidden = model.prefill(params, batch, cache, cfg, pcfg,
                                           **kw)
        return cache, logits_fn(params, last_hidden, cfg, **kw)

    def decode_fn(params, tokens, cache, **kw):
        return model.decode(params, tokens, cache, cfg, pcfg, **kw)

    if not sharded:
        return prefill_fn, decode_fn, None
    return prefill_fn, decode_fn, {"params": param_specs(cfg, scfg.policy,
                                                         mesh)}


class Engine:
    """Minimal batched-request engine: aligned prefill + stepwise decode.

    Requests are grouped into aligned batches (per-lane cache lengths);
    the scheduler is deliberately simple and synchronous, as in the
    reference.  The params (the whole tree, on every rank) are cut to this
    rank's shards under the policy's specs where there is a mesh, cast to
    the compute dtype once, here (`common.cast_weights`: the same numbers
    the reference's cast at use gives), and moved to `device`.
    """

    def __init__(self, cfg: ModelConfig, pcfg: ParallelConfig,
                 scfg: ServeConfig, params, mesh=None, device="cuda"):
        self.cfg, self.pcfg, self.scfg = cfg, pcfg, scfg
        self.device = cm.check_device(device)
        self.model = get_model(cfg)
        self.prefill_fn, self.decode_fn, specs = make_serve_fns(
            cfg, pcfg, scfg, mesh)
        self.ctx = None
        if specs is not None:
            # apply the placement the specs encode: MLR keeps the params
            # TP-sharded over 'model', SLR replicates them there (and its
            # cache keeps every KV head of its own requests)
            tp = axis_sizes(mesh).get("model", 1) \
                if scfg.policy == "mlr" else 1
            cspecs = self.model.cache_specs(cfg, pcfg, False, tp)
            if scfg.policy == "slr":
                cspecs = part.strip_axis(cspecs, "model")
            self._cache_specs = cspecs
            self.ctx = cm.MeshContext(mesh, specs["params"],
                                      batch_dp_axes(scfg.policy))
            # copies: the caller's whole tree is not held by the shards
            params = cm.map_tree(
                lambda t: t.clone(memory_format=torch.contiguous_format),
                part.shard_tree(params, specs["params"], mesh))
        self.params = cm.cast_weights(params, cfg, self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(0)

    @property
    def log(self):
        """The ``CommLog`` of every collective this engine issued (None
        without a mesh)."""
        return None if self.ctx is None else self.ctx.log

    def _sample(self, logits):
        if self.scfg.temperature == 0.0:
            # first index on ties, as jnp.argmax
            return torch.argmax(logits[:, -1], dim=-1)[:, None]
        probs = torch.softmax(logits[:, -1] / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.gen)

    def _batch(self, batch) -> dict:
        return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                   else v).to(self.device)
                for k, v in batch.items()}

    def _mesh_for(self, batch: dict):
        """(this rank's requests of `batch`, the context of their run): the
        batch cut over the policy's axes (positions (3, B, S) on dim 1),
        whole where B does not divide by them, and the cache's specs with
        the same batch entry."""
        cfg, mesh = self.cfg, self.ctx.mesh
        b = batch["tokens"].shape[0]
        entry = part.filter_spec((batch_dp_axes(self.scfg.policy),), (b,),
                                 mesh)[0]
        kv = (cfg.n_layers, b, self.scfg.max_seq, cfg.n_kv_heads,
              cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv, "pos": (), "lengths": (b,)}
        cspecs = {k: part.filter_spec(
            tuple(entry if e == cm.dp_axes() else e for e in spec),
            shapes[k], mesh) for k, spec in self._cache_specs.items()}
        ctx = dataclasses.replace(self.ctx, batch_axes=part.entry_axes(entry),
                                  cache_specs=cspecs)
        local = {k: part.local_shard(v, (None, entry) if k == "positions"
                                     else (entry,), mesh)
                 for k, v in batch.items()}
        return local, ctx

    @torch.inference_mode()
    def generate(self, batch, max_new_tokens: int, observer=None):
        """batch: model inputs incl. tokens (B, S_prompt) (tensors or numpy
        arrays; on a mesh, the whole batch on every rank).  Returns (B, <=
        max_new_tokens) generated ids, int32, on the engine's device (on a
        mesh, the whole batch on every rank).

        Lanes that have emitted `eos_id` are *frozen*: every subsequent
        position in that lane is `eos_id`, never a live sample.  The loop
        stops early once all lanes are done (on a mesh, all lanes of every
        rank: one collective per step decides it, so every rank runs the
        same steps), and the last token is never fed back (its KV would
        never be read), so `max_new_tokens` tokens take `max_new_tokens -
        1` decode calls.

        `observer`, when given, is called once after prefill and once
        after every decode step as ``observer(kind, done=<pre-step (B,)
        finished mask>, lengths=<post-step per-lane cache lengths>)`` (on a
        mesh, this rank's lanes); the serve<->sim bridge
        (`repro_torch.serve.bridge`) uses it."""
        batch = self._batch(batch)
        kw, b = {}, batch["tokens"].shape[0]
        if self.ctx is not None:
            batch, kw["mesh"] = self._mesh_for(batch)
        eos = self.scfg.eos_id
        cache = self.model.init_cache(self.cfg, b, self.scfg.max_seq,
                                      self.pcfg, device=self.device, **kw)
        cache, logits = self.prefill_fn(self.params, batch, cache, **kw)
        done = torch.zeros(cache["lengths"].shape, dtype=torch.bool,
                           device=self.device)
        if observer is not None:
            observer("prefill", done=done, lengths=cache["lengths"])
        tok = self._sample(logits).to(torch.int32)
        outs = []
        for _ in range(max_new_tokens):
            if eos >= 0:
                tok = torch.where(done[:, None], torch.full_like(tok, eos),
                                  tok)
            outs.append(tok)
            if eos >= 0:
                done = done | (tok[:, 0] == eos)
                if (kw["mesh"].all_done(done) if kw else bool(done.all())):
                    break
            if len(outs) == max_new_tokens:
                break            # the last token's KV is never consumed
            cache, logits = self.decode_fn(self.params, tok, cache, **kw)
            if observer is not None:
                observer("decode", done=done, lengths=cache["lengths"])
            tok = self._sample(logits).to(torch.int32)
        out = torch.cat(outs, dim=1)
        return kw["mesh"].gather(out, 0, kw["mesh"].batch_axes) if kw else out
