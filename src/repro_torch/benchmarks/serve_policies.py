"""MLR vs. SLR serving placement (port of ``benchmarks/serve_policies.py``;
paper §5 mapped to decode serving): reduced tinyllama-1.1b served through
``Engine(..., mesh=...)`` on a (2, 2) ('data', 'model') mesh of 4 ranks
under both policies, and the collectives each decode step issues.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_policies \
        [--device cuda|cpu] [--full]

Columns: ``batch_shards`` the ranks the batch is cut over (MLR: 'data';
SLR: 'data' x 'model'); ``collective_bytes_per_tok`` the bytes one rank
put on the wire in the decode steps of one `generate` (``CommLog``: a
fused all-gather counts (n-1) x its input, an all-reduce 2(n-1)/n x its
bytes) over the tokens those steps decoded; ``collective_ops`` the
communication calls one rank issued per decode step (each a fused
collective of ``core/collectives.py``); ``step_ms_host`` one decode
step's wall time on rank 0's host clock (the card synchronised), after a
warm-up run.  The
counts are what the port issues, checked against `decode_comm`, the
schedule written out from the shapes; they are not the reference's HLO
numbers (its last column prints ``n_computations``), another quantity by
design.

``--full`` serves ARCH at its published size (22 layers, seed-0 weights
made on the card) in place of the reduced config, the reference's
benchmark shape otherwise.

``--device cuda`` (the default) runs NCCL, one card per rank, where 4
cards are visible; with fewer, NCCL refuses two ranks on one device, so
the 4 ranks share card 0 on gloo and every transfer goes through host
memory (``core.comm.stages_on_host``): those wall times are not NVLink
figures, and the ``# transport:`` line says which ran.  ``--device cpu``
runs gloo on the host.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import numpy as np
import torch

ARCH = "tinyllama-1.1b"
MESH = ((2, 2), ("data", "model"))
RANKS = 4
#: requests, prompt tokens, new tokens, cache length (the reference
#: lowers one decode step of a batch of 8 over a 64-token cache)
BATCH, PROMPT, NEW, MAX_SEQ = 8, 16, 4, 64
HEADER = ("policy,batch_shards,collective_bytes_per_tok,collective_ops,"
          "step_ms_host")


def decode_comm(cfg, sizes: dict, batch: int, policy: str) -> tuple[int, int]:
    """(wire bytes, calls) one rank issues in one decode step of a batch of
    `batch` requests of `cfg` (a transformer family) on a mesh of `sizes`
    under `policy`, from the shapes: the schedule of ``models.transformer``
    and ``models.common.MeshContext`` written out.  Per step: the
    embedding's gathers of token ids and feature blocks; per layer the FSDP
    gather of each weight over its non-'model' axes (in the dtype the
    engine holds it: norms and the router float32, the rest the compute
    dtype), one float32 (B, 1, d) sum over 'model' after each row-parallel
    product (``wo``, ``w_down``) and, for the MoE FFN, the gather of the
    activations onto the expert block (SLR) and its float32 sum over
    'model'; the head's FSDP gather and a gather of the logits over
    'model', or the tied head's gather of hidden rows and its float32 sums
    over the feature axes."""
    from repro_torch.configs.base import _param_shapes
    from repro_torch.core import partitioning as part
    from repro_torch.core.comm import MeshShape
    from repro_torch.models import common as cm
    from repro_torch.models.common import flatten_paths
    from repro_torch.serve.engine import batch_dp_axes, param_specs

    mesh = MeshShape(tuple(sizes), tuple(sizes.values()))
    specs = flatten_paths(param_specs(cfg, policy, mesh))
    shapes = _param_shapes(cfg)
    act = torch.empty((), dtype=cm.compute_dtype(cfg)).element_size()
    bax = part.entry_axes(part.filter_spec((batch_dp_axes(policy),),
                                           (batch,), mesh)[0])
    b_l = batch // math.prod(sizes[a] for a in bax)
    d = cfg.d_model
    wire = ops = 0

    def gather(nbytes, axes):
        nonlocal wire, ops
        for a in reversed(tuple(axes)):
            if sizes.get(a, 1) > 1:
                wire += (sizes[a] - 1) * nbytes
                ops += 1
                nbytes *= sizes[a]
        return nbytes

    def reduce(nbytes, axes):
        nonlocal wire, ops
        for a in axes:
            if sizes.get(a, 1) > 1:
                wire += round(2 * (sizes[a] - 1) / sizes[a] * nbytes)
                ops += 1

    def width(path):
        leaf = path.split(".")[-1]
        keep = cm._is_norm(path) or leaf in cm._FLOAT32_LEAVES
        return 4 if keep else act

    feat = part.entry_axes(specs["embed.tokens"][1])
    shared = tuple(a for a in bax if a in feat)
    rows = gather(b_l * 4, shared) // 4                 # int32 token ids
    gather(rows * d // math.prod(sizes[a] for a in feat) * act, feat)
    per_layer_wire, per_layer_ops = wire, ops
    for path, spec in specs.items():
        if not path.startswith("layers."):
            continue
        loc = part.local_shape(shapes[path], spec, mesh)[1:]
        nbytes = math.prod(loc) * width(path)
        for entry in spec[1:]:
            axes = part.entry_axes(entry)
            if axes and "model" not in axes:
                nbytes = gather(nbytes, axes)
    if "model" in part.entry_axes(specs["layers.attn.wo"][1]):
        reduce(b_l * d * 4, ("model",))
    if cfg.family == "moe":
        if sizes.get("model", 1) > 1:
            dp = tuple(a for a in cm.dp_axes() if sizes.get(a, 1) > 1)
            dp = dp if batch % math.prod(sizes[a] for a in dp) == 0 else ()
            t_block = batch // math.prod(sizes[a] for a in dp)
            if bax[:len(dp)] == dp and bax != dp:     # onto the block
                gather(b_l * d * act, bax[len(dp):])
            reduce(t_block * d * 4, ("model",))
            if not bax and dp:                        # back from it
                gather(t_block * d * 4, dp)
    elif "model" in part.entry_axes(specs["layers.mlp.w_down"][1]):
        reduce(b_l * d * 4, ("model",))
    layer_wire, layer_ops = wire - per_layer_wire, ops - per_layer_ops
    wire += (cfg.n_layers - 1) * layer_wire
    ops += (cfg.n_layers - 1) * layer_ops
    v = cfg.vocab_size
    if cfg.tie_embeddings:
        h_rows = gather(b_l * d * act, shared) // (d * act)
        reduce(h_rows * v * 4, feat)
    else:
        spec = specs["head.w"]
        loc = part.local_shape(shapes["head.w"], spec, mesh)
        gather(math.prod(loc) * act, part.entry_axes(spec[0]))
        gather(b_l * loc[1] * 4, part.entry_axes(spec[1]))
    return wire, ops


def measure(mesh, device, policies=("mlr", "slr"),
            full: bool = False) -> list[dict]:
    """Run inside every rank of `mesh`: reduced ARCH (`full`: its
    published size) from seed-0 weights,
    BATCH prompts of PROMPT tokens, NEW greedy tokens through `Engine`
    under each policy, after a warm-up `generate` (kernel builds, the
    groups' first collectives); the decode steps' ``CommLog`` (read in
    the observer after prefill and after the last step) and wall time.
    Raises where the bytes or calls differ from `decode_comm`.  One dict
    per policy."""
    import torch.distributed as dist

    from repro_torch.configs import ParallelConfig, get_config, reduce_config
    from repro_torch.core.comm import axis_sizes
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(ARCH) if full else reduce_config(get_config(ARCH))
    pcfg = ParallelConfig(attn_impl="pallas" if full else "chunked",
                          moe_impl="shard_map", remat="none")
    params = transformer.init(0, cfg, device=device if full else "cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (BATCH, PROMPT),
                                               dtype=np.int32)
    sizes = axis_sizes(mesh)
    rows = []
    for policy in policies:
        eng = Engine(cfg, pcfg, ServeConfig(max_seq=MAX_SEQ, policy=policy),
                     params, mesh=mesh, device=device)
        marks = []

        def observer(kind, *, done, lengths):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            marks.append((time.perf_counter(), eng.log.ops,
                          eng.log.wire_bytes, eng.log.staged_bytes))

        eng.generate({"tokens": prompt}, 2)   # warm-up: builds, first calls
        dist.barrier()
        eng.generate({"tokens": prompt}, NEW, observer=observer)
        steps = len(marks) - 1
        ops = (marks[-1][1] - marks[0][1]) / steps
        wire = marks[-1][2] - marks[0][2]
        want_wire, want_ops = decode_comm(cfg, sizes, BATCH, policy)
        if wire != want_wire * steps or ops != want_ops:
            raise RuntimeError(f"serve_policies: {policy}: {wire / steps} B "
                               f"and {ops} calls per step, the schedule "
                               f"says {want_wire} and {want_ops}")
        bax = eng.ctx.batch_axes
        rows.append({
            "policy": policy, "arch": cfg.name, "layers": cfg.n_layers,
            "batch_shards": math.prod(sizes[a] for a in bax),
            "collective_bytes_per_tok": wire / (steps * BATCH),
            "collective_ops": ops,
            "step_ms_host": (marks[-1][0] - marks[0][0]) / steps * 1e3,
            "staged_bytes_per_step": (marks[-1][3] - marks[0][3]) / steps,
            "transport": transport(marks[-1][3] - marks[0][3])})
    return rows


def transport(staged: int) -> str:
    """The backend that moved the bytes, and "host-staged" where they went
    through host memory on their way."""
    import torch.distributed as dist
    backend = dist.get_backend()
    return f"{backend}, host-staged" if staged else backend


def format_rows(rows: list[dict]) -> list[str]:
    out = [HEADER]
    out += [f"{r['policy']},{r['batch_shards']},"
            f"{r['collective_bytes_per_tok']:.3e},{r['collective_ops']:g},"
            f"{r['step_ms_host']:.2f}" for r in rows]
    out.append("# MLR: all ranks of 'model' serve every token (params "
               "TP-sharded); SLR: params replicated over 'model', the batch "
               "over every axis -- the paper's rank trade-off")
    out.append("# transport: " + "; ".join(sorted({r["transport"]
                                                   for r in rows})))
    out.append(f"# {rows[0]['arch']}, {rows[0]['layers']} layers")
    return out


def _rank(rank: int, world: int, init: str, backend: str, device: str,
          shared: bool, out_path: str, full: bool) -> None:
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_test_mesh
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0 if shared else rank)
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = make_test_mesh(*MESH, device_type=dev.type)
        rows = measure(mesh, dev, full=full)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def run(device: str = "cuda", full: bool = False) -> list[dict]:
    """Spawn RANKS processes and return rank 0's rows.  On cards: NCCL,
    one card per rank, where RANKS cards are visible, else gloo with every
    rank on card 0 and each transfer staged through host memory (the
    rows' ``transport`` says so); no card raises.  ``device="cpu"``: gloo
    on the host."""
    import torch.multiprocessing as mp

    from repro_torch.models.common import check_device
    dev = check_device(device)
    shared = dev.type == "cuda" and torch.cuda.device_count() < RANKS
    backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rows.json")
        mp.spawn(_rank, args=(RANKS, f"file://{d}/init", backend, dev.type,
                              shared, out, full), nprocs=RANKS)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help=f"{ARCH} at its published size")
    args = ap.parse_args(argv)
    print("\n".join(format_rows(run(args.device, args.full))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
