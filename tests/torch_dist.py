"""Helpers of the port's distributed CPU tests: `spawn` runs a rank body in
n processes of one gloo process group, and the rank bodies of
``test_torch_collectives.py``, ``test_torch_train_pod.py`` and
``test_torch_serve_mesh.py`` live here.
Imports torch, numpy and ``repro_torch`` only: the ranks never load JAX.

Every rank body takes (rank, n, *args) and returns a dict of numpy
arrays, which `spawn` hands back per rank.  The process group rendezvous
through a file under the test's temporary directory (``file://``), so the
suite's parallel workers cannot clash on ports.
"""
from __future__ import annotations

import dataclasses
import datetime
import pathlib

import numpy as np
import torch

#: rank bodies wait at most this long in any collective
TIMEOUT_S = 300


def spawn(body, n: int, tmp_dir, *args) -> list[dict]:
    """Run ``body(rank, n, *args)`` in `n` spawned processes of one gloo
    group; returns each rank's dict of arrays, in rank order.  A rank that
    raises fails the spawn."""
    import torch.multiprocessing as mp
    tmp = pathlib.Path(tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    mp.spawn(_entry, args=(n, f"file://{tmp}/init", str(tmp), body, args),
             nprocs=n)
    out = []
    for r in range(n):
        with np.load(tmp / f"rank{r}.npz") as z:
            out.append({k: z[k] for k in z.files})
    return out


def _entry(rank, n, init, out_dir, body, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=n,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        res = body(rank, n, *args)
        np.savez(pathlib.Path(out_dir) / f"rank{rank}.npz", **res)
    finally:
        dist.destroy_process_group()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


# ----------------------------------------------------------------------------
# test_torch_collectives
# ----------------------------------------------------------------------------


def tree_of(ref: dict, n: int, r: int) -> dict:
    """Rank r's tree of the reference test's leaves (the reference's
    ``tree_*`` arrays, (n*k, ...) split over the ranks on dim 0)."""
    def part(key):
        a = torch.from_numpy(ref[f"tree_{key}"])
        k = a.shape[0] // n
        return a[r * k:(r + 1) * k].clone()
    return {"a": part("a"), "b": {"c": part("c")}, "d": part("d"),
            "f": part("f")}


def collectives_rank(rank: int, n: int, ref_path: str) -> dict:
    """8 ranks: every primitive at n = 8 on the whole group and at n = 4
    on the 'pod' groups of a (2, 4) ('data', 'pod') mesh, on the
    reference's inputs; `tree_sync` in every mode at n = 4, and
    `pod_sync_wrap` in "auto" and "dedicated"; the CommLog of one cascaded
    all-reduce; the benchmark's rows;
    DTensor placements on a (2, 2, 2) mesh; `local_batch`."""
    import torch.distributed as dist

    from repro_torch.benchmarks import collective_schedules
    from repro_torch.core import collectives as C
    from repro_torch.core import partitioning as part
    from repro_torch.launch.mesh import axis_group, axis_sizes, make_test_mesh
    from repro_torch.models.common import flatten_paths
    from repro_torch.train.compression import compressed_ring_all_reduce

    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    assert n == 8
    mesh8 = make_test_mesh((8,), ("pod",), device_type="cpu")
    mesh24 = make_test_mesh((2, 4), ("data", "pod"), device_type="cpu")
    out = {}
    for k, mesh in ((8, mesh8), (4, mesh24)):
        g = axis_group(mesh, "pod")
        r = dist.get_rank(g)
        out[f"rank{k}"] = np.asarray(r)
        x = torch.from_numpy(ref[f"x{k}"][r])
        out[f"ag_c{k}"] = _np(C.cascaded_all_gather(x, g))
        out[f"ag_d{k}"] = _np(C.dedicated_all_gather(x, g))
        out[f"ar_c{k}"] = _np(C.cascaded_all_reduce(x, g))
        out[f"ar_d{k}"] = _np(C.dedicated_all_reduce(x, g))
        out[f"rs{k}"] = _np(C.cascaded_reduce_scatter(
            torch.from_numpy(ref[f"blocks{k}"][r]), g))
        out[f"cr{k}"] = _np(compressed_ring_all_reduce(
            torch.from_numpy(ref[f"flat{k}"][r]), g))

    g4 = axis_group(mesh24, "pod")
    r4 = dist.get_rank(g4)
    tree = tree_of(ref, 4, r4)
    for mode in C.MODES:
        for name, leaf in flatten_paths(C.tree_sync(tree, g4, mode)).items():
            out[f"tree_{mode}_{name}"] = _np(leaf)

    def grad_fn(params, batch):
        return (torch.tensor(1.0 + r4), {"m": torch.tensor(float(r4))}), tree

    for mode in ("auto", "dedicated"):
        (loss, metrics), grads = C.pod_sync_wrap(grad_fn, mesh24, mode)(
            None, {})
        out[f"wrap_{mode}_loss"] = _np(loss)
        out[f"wrap_{mode}_m"] = _np(metrics["m"])
        for name, leaf in flatten_paths(grads).items():
            out[f"wrap_{mode}_{name}"] = _np(leaf)

    log = C.CommLog()
    C.cascaded_all_reduce(torch.from_numpy(ref["x4"][r4]), g4, log)
    out["log_cascaded"] = np.array([log.ops, log.hops, log.wire_bytes,
                                    log.staged_bytes])
    log = C.CommLog()
    C.dedicated_all_reduce(torch.from_numpy(ref["x4"][r4]), g4, log)
    out["log_dedicated"] = np.array([log.ops, log.hops, log.wire_bytes,
                                     log.staged_bytes])

    rows = collective_schedules.measure(g4, torch.device("cpu"))
    out["bench_wire"] = np.array([row["wire_bytes_per_dev"] for row in rows])
    out["bench_ops"] = np.array([row["collective_ops"] for row in rows])
    out["bench_hops"] = np.array([row["permute_hops"] for row in rows])
    out["bench_transport"] = np.array([row["transport"] for row in rows])

    mesh222 = make_test_mesh((2, 2, 2), ("pod", "data", "model"),
                             device_type="cpu")
    out["mesh222_sizes"] = np.array(list(axis_sizes(mesh222).values()))
    out["placements"] = np.array([
        repr(part.placements(spec, mesh222)) for spec in
        ((None, ("data", "model")), ("data", "model"), ("model", None),
         (), (None, None, "pod"))])
    try:
        part.placements((("model", "data"),), mesh222)
        out["placements_order_error"] = np.asarray(False)
    except ValueError:
        out["placements_order_error"] = np.asarray(True)

    batch = {"tokens": torch.arange(8 * 3).reshape(8, 3),
             "positions": torch.arange(3 * 8 * 3).reshape(3, 8, 3)}
    for name, leaf in C.local_batch(batch, mesh24).items():
        out[f"local_{name}"] = _np(leaf)
    return out


# ----------------------------------------------------------------------------
# test_torch_train_pod
# ----------------------------------------------------------------------------

#: (label, cross_pod_sync, grad_compression) of the pod train tests
POD_MODES = (("auto", "auto", "none"), ("cascaded", "cascaded", "none"),
             ("dedicated", "dedicated", "none"),
             ("int8", "cascaded", "int8"))
POD_LR = 1e-3


def pod_cfg():
    """Reduced tinyllama-1.1b in float32 (both packages' parity dtype)."""
    from repro_torch.configs import get_config, reduce_config
    return dataclasses.replace(reduce_config(get_config("tinyllama-1.1b")),
                               dtype="float32")


def train_pod_rank(rank: int, n: int, ref_path: str) -> dict:
    """One rank of a ('pod',) mesh of n: from the reference's initial
    state, two steps of `make_train_step(..., mesh)` on this rank's share
    of the reference's global batch (`local_batch`), in every mode of
    POD_MODES; per mode the losses, grad norms, learning rates and the
    final state (``checkpoint._flatten`` names, '/' as '~')."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.convert import state_from_reference
    from repro_torch.core.collectives import local_batch
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.step import make_train_step

    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    cfg = pod_cfg()
    init = {k[len("init"):].replace("~", "/"): v for k, v in ref.items()
            if k.startswith("init")}
    mesh = make_test_mesh((n,), ("pod",), device_type="cpu")
    batch = local_batch({"tokens": torch.from_numpy(ref["tokens"]),
                         "labels": torch.from_numpy(ref["labels"])}, mesh)
    out = {"local_tokens": _np(batch["tokens"])}
    for label, sync, comp in POD_MODES:
        pcfg = ParallelConfig(moe_impl="dense", remat="full",
                              cross_pod_sync=sync, grad_compression=comp)
        step = make_train_step(cfg, pcfg, mesh=mesh, lr=POD_LR)
        state = state_from_reference(init, cfg)
        losses, gnorms, lrs = [], [], []
        for _ in range(2):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
        out[f"{label}_loss"] = np.array(losses)
        out[f"{label}_gnorm"] = np.array(gnorms)
        out[f"{label}_lr"] = np.array(lrs)
        for name, v in ckpt._flatten(state).items():
            out[f"{label}|{name.replace('/', '~')}"] = _np(v)
    return out


# ----------------------------------------------------------------------------
# test_torch_serve_mesh
# ----------------------------------------------------------------------------

#: the archs served on the (2, 2) ('data', 'model') mesh, and the run
SERVE_ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "qwen2-vl-72b")
SERVE_B, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_SEQ = 4, 8, 12, 32


def serve_cfg(arch: str):
    """Reduced `arch` in float32 (both packages' parity dtype)."""
    from repro_torch.configs import get_config, reduce_config
    return dataclasses.replace(reduce_config(get_config(arch)),
                               dtype="float32")


def serve_batch(cfg) -> dict:
    """SERVE_B prompts of SERVE_PROMPT tokens from numpy seed 2; the VLM's
    (3, B, S) M-RoPE positions with three distinct streams and a
    per-request offset, so a cut on the wrong dim would show."""
    b, s = SERVE_B, SERVE_PROMPT
    out = {"tokens": np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s), dtype=np.int32)}
    if cfg.family == "vlm":
        t = np.arange(s, dtype=np.int32)
        streams = np.stack([t, t // 2, t % 4])[:, None, :]
        out["positions"] = (streams + 3 * np.arange(
            b, dtype=np.int32)[None, :, None]).astype(np.int32)
    return out


class Float32Cache:
    """A model module whose ``init_cache`` makes every float tensor of the
    cache float32 (the model writes and reads the cache in its dtype), so
    float32 runs are held without the bf16 cache's rounding, which turns
    float32 summation-order noise into whole bf16 steps."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init_cache(self, *args, **kw):
        return {k: v.float() if torch.is_tensor(v) and v.is_floating_point()
                else v for k, v in self._model.init_cache(*args, **kw).items()}


def serve_mesh_rank(rank: int, n: int, ref_path: str) -> dict:
    """4 ranks of a (2, 2) ('data', 'model') mesh: each of SERVE_ARCHS
    from the reference's params under MLR and SLR through
    ``Engine(..., mesh=...)`` (moe_impl "shard_map": experts over
    'model'), with attn_impl "chunked" (the reference's) and "pallas"
    (the kernels' plain versions; also one process, no mesh, as policy
    "one"): the tokens, each decode step's logits of this rank's lanes
    and their rows, the local ``attn.wq`` shard's shape, all with a
    float32 cache (`Float32Cache`); EOS runs; and the
    expert-parallel block on the reference's inputs (the batch whole, as
    on the reference's (1, 2) mesh), its output and kept (token, expert)
    assignments, plain and under the probe weights."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.convert import params_from_reference
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import common as cm
    from repro_torch.models import moe
    from repro_torch.serve.engine import Engine, ServeConfig

    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    mesh = make_test_mesh((2, 2), ("data", "model"), device_type="cpu")
    out = {}

    def serve(arch, impl, policy, eos=-1):
        cfg = serve_cfg(arch)
        params = params_from_reference(
            {k.split("|", 1)[1]: v for k, v in ref.items()
             if k.startswith(arch + "|")}, cfg)
        pcfg = ParallelConfig(attn_impl=impl, moe_impl="shard_map",
                              remat="none")
        one = policy == "one"
        eng = Engine(cfg, pcfg, ServeConfig(
            max_seq=SERVE_MAX_SEQ, policy="mlr" if one else policy,
            eos_id=eos), params, mesh=None if one else mesh, device="cpu")
        eng.model = Float32Cache(eng.model)
        steps, decode = [], eng.decode_fn

        def recorded(*a, **k):
            cache, logits = decode(*a, **k)
            steps.append(_np(logits[:, 0]))
            return cache, logits

        eng.decode_fn = recorded
        toks = eng.generate(serve_batch(cfg), SERVE_NEW)
        i, k = (0, 1) if eng.ctx is None else eng.ctx.block(
            eng.ctx.batch_axes)
        lanes = SERVE_B // k
        key = f"{arch}|{impl}|{policy}|{eos}"
        out[f"{key}|tokens"] = _np(toks)
        out[f"{key}|logits"] = np.stack(steps)
        out[f"{key}|rows"] = np.arange(i * lanes, (i + 1) * lanes)
        out[f"{key}|steps"] = np.asarray(len(steps))
        if eng.ctx is not None:
            out[f"{key}|wq"] = np.array(
                eng.params["layers"]["attn"]["wq"].shape)

    for arch in SERVE_ARCHS:
        for policy in ("mlr", "slr"):
            serve(arch, "chunked", policy)
        for policy in ("one", "mlr", "slr"):
            serve(arch, "pallas", policy)
    for policy in ("mlr", "slr"):
        serve(SERVE_ARCHS[0], "chunked", policy, int(ref["eos"]))

    ecfg = ep_cfg()
    ctx = cm.MeshContext(mesh, {})
    e_local = -(-ecfg.moe.n_experts // 2)
    x = torch.from_numpy(ref["ep_x"])
    t = x.shape[0] * x.shape[1]
    cap = moe.capacity(t, ecfg.moe.experts_per_token, ecfg.moe.n_experts,
                       ecfg.moe.capacity_factor)
    ids = torch.from_numpy(ref["ep_ids"]).long()
    st, sk, _, keep, _ = moe.ep_plan(ids.reshape(t, -1), ctx.coords["model"],
                                     e_local, cap)
    out["ep_kept"] = np.stack([_np(st[keep]), _np(sk[keep])
                               + ctx.coords["model"] * e_local], 1)
    out["ep_cap"] = np.asarray(cap)
    for kind in ("rand", "probe"):
        experts = {w: torch.from_numpy(ref[f"ep_{kind}_{w}"])
                   for w in ("w_gate", "w_up", "w_down")}
        out[f"ep_{kind}_out"] = _np(moe._moe_ep_block(
            x, torch.from_numpy(ref["ep_w"]), ids, experts, ecfg, ctx))
    return out


def ep_cfg():
    """Reduced granite-moe-3b-a800m in float32 with capacity factor 1, so
    the reference test's skewed routing overflows an expert's buffer."""
    cfg = serve_cfg("granite-moe-3b-a800m")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
