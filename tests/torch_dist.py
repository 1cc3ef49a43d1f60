"""Helpers of the port's distributed CPU tests: `spawn` runs a rank body in
n processes of one gloo process group, and the rank bodies of
``test_torch_collectives.py`` and ``test_torch_train_pod.py`` live here.
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
