"""MLR vs. SLR serving placement (port of ``benchmarks/serve_policies.py``;
paper §5 mapped to decode serving): reduced tinyllama-1.1b served through
``Engine(..., mesh=...)`` on a (2, 2) ('data', 'model') mesh of 4 ranks
under both policies, and the collectives each decode step issues.

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_policies \
        [--device cuda|cpu] [--full] [--arch A] [--mesh 2x2|1x4] \
        [--prompt P] [--new N] [--policies mlr,slr]

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

``--full`` serves the arch at its published size (seed-0 weights drawn
on the card a leaf at a time and kept on the host, `host_params`) in
place of the reduced config, the reference's benchmark shape otherwise.
The other options change the arch (default tinyllama-1.1b), the mesh's
('data', 'model') sizes, the prompt and new tokens (the cache
holds at least MAX_SEQ positions), and the policies: for example
phi3-medium-14b on a (1, 4) mesh, whose 10 KV heads do not divide
'model', takes the sequence-sharded cache.

``--device cuda`` (the default) runs NCCL, one card per rank, where 4
cards are visible; with fewer, NCCL refuses two ranks on one device, so
the 4 ranks share card 0 on gloo and every transfer goes through host
memory (``core.comm.stages_on_host``): those wall times are not NVLink
figures, and the ``# transport:`` line says which ran.  ``--device cpu``
runs gloo on the host.
"""
from __future__ import annotations

import argparse
import dataclasses
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


def decode_comm(cfg, sizes: dict, batch: int, policy: str, *,
                max_seq: int | None = None, long_ctx: bool = False,
                splits: int = 1) -> tuple[int, int]:
    """(wire bytes, calls) one rank issues in one decode step of a batch of
    `batch` requests of `cfg` (any family) on a mesh of `sizes` under
    `policy`, from the shapes: the schedule of the family's module and
    ``models.common.MeshContext`` written out.  The cache is laid out by
    the family's ``cache_specs`` (`long_ctx`: the long-context layout)
    and filtered on a cache of `max_seq` positions (None: a length every
    cut divides).

    Per step: the embedding's gathers of token ids and feature blocks;
    the FSDP gather of each weight over its non-'model' axes at use (in
    the dtype the engine holds it: norms, the router and the SSM's
    float32 leaves float32, the rest the compute dtype), per layer of
    the stack, once for zamba's shared block, and for whisper's decoder
    without the cross K/V projections (its cross K/V come from the
    cache); one float32 (B, 1, d) sum over 'model' after each
    row-parallel product.  Attention on whole heads (KV heads that do
    not divide 'model', or a sequence-sharded cache) first gathers the
    q, k and v column blocks over 'model' (the cross-attention q alone),
    and over a sequence-sharded cache gathers every rank's float32
    partials (B, Hkv, S, G, 2 + hd) over the cache's sequence axes, S
    the decode's `splits` per rank (1 for the plain path and for
    whisper's cross cache).  RWKV-6: the receptance's gather over
    'model'; where the WKV state is cut over its k dim, the fused gather
    of r, k and v over 'model' and the float32 (B, 1, d) sum of the
    partial y.  Mamba2: the gathers of the packed projection and of the
    conv's channels over 'model', the gated norm's float32 (B, 1, 1)
    sum; where the SSM state is cut over P, the gather of the normed
    channels (B, 1, d_in / M) over 'model' that relays them into
    ``w_out``'s rows.  The MoE FFN: the gather of the activations onto
    the expert block (SLR) and its float32 sum over 'model'.  The head's FSDP
    gather and a gather of the logits over 'model', or the tied head's
    gather of hidden rows and its float32 sums over the feature axes."""
    from repro_torch.configs.base import _param_shapes
    from repro_torch.core import partitioning as part
    from repro_torch.core.comm import MeshShape
    from repro_torch.models import common as cm
    from repro_torch.models import get_model
    from repro_torch.models.common import flatten_paths
    from repro_torch.serve.engine import batch_dp_axes, param_specs

    mesh = MeshShape(tuple(sizes), tuple(sizes.values()))
    specs = flatten_paths(param_specs(cfg, policy, mesh))
    shapes = _param_shapes(cfg)
    act = torch.empty((), dtype=cm.compute_dtype(cfg)).element_size()
    entry = part.filter_spec((batch_dp_axes(policy),), (batch,), mesh)[0]
    bax = part.entry_axes(entry)
    b_l = batch // math.prod(sizes[a] for a in bax)
    d, hd, m = cfg.d_model, cfg.resolved_head_dim, sizes.get("model", 1)
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

    def cut(path, dim):
        return "model" in part.entry_axes(specs[path][dim])

    def fsdp(prefix, skip=()):
        for path, spec in specs.items():
            if not path.startswith(prefix) or path in skip:
                continue
            loc = part.local_shape(shapes[path], spec, mesh)[1:]
            nbytes = math.prod(loc) * width(path)
            for e in spec[1:]:
                axes = part.entry_axes(e)
                if axes and "model" not in axes:
                    nbytes = gather(nbytes, axes)

    # the cache's layout, as the engine makes it
    model = get_model(cfg)
    cspecs = model.cache_specs(cfg, None, long_ctx,
                               m if policy == "mlr" else 1)
    if policy == "slr":
        cspecs = part.strip_axis(cspecs, "model")
    cshapes = model.cache_shapes(cfg, batch,
                                 max_seq or math.prod(sizes.values()))
    cspecs = {k: part.filter_spec(tuple(entry if e == cm.dp_axes() else e
                                        for e in spec), cshapes[k], mesh)
              for k, spec in cspecs.items()}

    def seq(key):
        return part.entry_axes(cspecs[key][2]) if key in cspecs else ()

    def attention(prefix, seq_axes, n_splits, projected=("wq", "wk", "wv")):
        hq, hkv = cfg.n_heads, cfg.n_kv_heads
        if seq_axes or (cut(prefix + ".wq", -1) and hkv % m):
            for w in projected:                 # whole heads
                if cut(f"{prefix}.{w}", -1):
                    heads = hq if w == "wq" else hkv
                    gather(b_l * heads * hd // m * act, ("model",))
            if seq_axes:                        # every rank's partials
                gather(b_l * hq * n_splits * (2 + hd) * 4, seq_axes)
        if cut(prefix + ".wo", -2):
            reduce(b_l * d * 4, ("model",))

    def mlp(prefix):
        if cut(prefix + ".w_down", -2):
            reduce(b_l * d * 4, ("model",))

    feat = part.entry_axes(specs["embed.tokens"][1])
    shared = tuple(a for a in bax if a in feat)
    rows = gather(b_l * 4, shared) // 4                 # int32 token ids
    gather(rows * d // math.prod(sizes[a] for a in feat) * act, feat)

    layer_from = (wire, ops)
    if cfg.family == "encdec":
        cross = ("dec.cross_attn.wk", "dec.cross_attn.wv")
        fsdp("dec.", cross)
        attention("dec.self_attn", seq("k"), splits)
        attention("dec.cross_attn", seq("cross_k"), 1, ("wq",))
        mlp("dec.mlp")
    else:
        fsdp("layers.")
    if cfg.family == "ssm":
        h = cfg.ssm.n_ssm_heads
        if cut("layers.tmix.w_r", -1) and h % m:    # the k-cut state
            gather(b_l * 3 * d // m * act, ("model",))  # r, k, v whole
            if (d // h) % m == 0:
                reduce(b_l * d * 4, ("model",))         # the partial y
        if cut("layers.tmix.w_o", -2):
            reduce(b_l * d * 4, ("model",))
        if cut("layers.cmix.w_v", -2):
            reduce(b_l * d * 4, ("model",))
        if cut("layers.cmix.w_r", -1):
            gather(b_l * d // m * act, ("model",))
    elif cfg.family == "hybrid":
        ssm = cfg.ssm
        ch = 2 * d + 2 * ssm.n_groups * ssm.state_dim
        if cut("layers.mamba.w_in", -1):
            gather(b_l * (2 * d + ch + ssm.n_ssm_heads) // m * act,
                   ("model",))
        if cut("layers.mamba.conv", -1):
            gather(b_l * ch // m * act, ("model",))
        if cut("layers.mamba.w_out", -2):
            h, p_head = ssm.n_ssm_heads, 2 * d // ssm.n_ssm_heads
            if h % m == 0 or p_head % m == 0:
                reduce(b_l * 4, ("model",))             # the gated norm
            if h % m and p_head % m == 0:               # the P-cut state
                gather(b_l * 2 * d // m * act, ("model",))  # y relaid
            reduce(b_l * d * 4, ("model",))
    elif cfg.family in ("dense", "vlm", "moe"):
        attention("layers.attn", seq("k"), splits)
    if cfg.family == "moe":
        if m > 1:
            dp = tuple(a for a in cm.dp_axes() if sizes.get(a, 1) > 1)
            dp = dp if batch % math.prod(sizes[a] for a in dp) == 0 else ()
            t_block = batch // math.prod(sizes[a] for a in dp)
            if bax[:len(dp)] == dp and bax != dp:     # onto the block
                gather(b_l * d * act, bax[len(dp):])
            reduce(t_block * d * 4, ("model",))
            if not bax and dp:                        # back from it
                gather(t_block * d * 4, dp)
    elif cfg.family in ("dense", "vlm"):
        mlp("layers.mlp")
    layer_wire, layer_ops = wire - layer_from[0], ops - layer_from[1]
    wire += (cfg.n_layers - 1) * layer_wire
    ops += (cfg.n_layers - 1) * layer_ops
    if cfg.family == "hybrid":              # the shared block: its weights
        fsdp("shared.")                     # once per step, every site
        for _ in range(cfg.n_layers // cfg.attn_every):
            attention("shared.attn", seq("k"), splits)
            mlp("shared.mlp")
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


@dataclasses.dataclass(frozen=True)
class Shape:
    """What `measure` serves: `arch` (reduced unless ``full``), a mesh of
    `mesh` ('data', 'model'), `batch` prompts of `prompt` tokens, `new`
    greedy tokens, a cache of `max_seq` positions, under `policies`."""
    arch: str = ARCH
    mesh: tuple = MESH[0]
    batch: int = BATCH
    prompt: int = PROMPT
    new: int = NEW
    max_seq: int = MAX_SEQ
    policies: tuple = ("mlr", "slr")


def host_params(cfg, device, block=None) -> dict:
    """Seed-0 params of `cfg` drawn on `device` one leaf at a time (the
    draws of ``models.common.init_from_shapes``, which takes the leaves in
    sorted order from one generator) and kept on the host in the dtype the
    engine casts them to (`common.cast_weights`): a published-size model
    whose float32 tree would not fit beside its shards on the card.
    `block`, where given, maps (path, leaf) to the part of the leaf to
    keep (a rank's block, ``partitioning.local_shard``; for an engine
    built with ``local=True``)."""
    from repro_torch.configs.base import _param_shapes
    from repro_torch.models import common as cm
    gen = torch.Generator(device=device).manual_seed(0)
    flat = {}
    for path, shape in sorted(_param_shapes(cfg).items()):
        leaf = cm.flatten_paths(cm.init_from_shapes(gen, {path: shape},
                                                    device))[path]
        if block is not None:
            leaf = block(path, leaf)
        keep = cm._is_norm(path) or path.split(".")[-1] in \
            cm._FLOAT32_LEAVES
        flat[path] = (leaf if keep else cm.cast(leaf, cfg)).cpu()
        del leaf
    return cm.unflatten_paths(flat)


def decode_splits(cfg, sizes: dict, batch: int, policy: str, max_seq: int,
                  device) -> int:
    """The split kernel's splits per rank in a decode step over a
    sequence-sharded KV cache (MLR over a 'model' axis that the KV heads
    do not divide): ``kernel.split_plan`` of the rank's block on the
    card, 1 on the plain path; 1 where the cache is not cut so."""
    m = sizes.get("model", 1)
    if device.type != "cuda" or policy != "mlr" or cfg.family == "ssm" \
            or cfg.n_kv_heads % m == 0:
        return 1
    from repro_torch.kernels.decode_attention import kernel as dec_kernel
    b_l = batch // sizes.get("data", 1) if batch % sizes.get(
        "data", 1) == 0 else batch
    return dec_kernel.split_plan(max_seq // m, b_l, cfg.n_kv_heads,
                                 dec_kernel.sm_count(device.index or 0))[0]


def measure(mesh, device, shape: Shape = Shape(),
            full: bool = False) -> list[dict]:
    """Run inside every rank of `mesh`: `shape`'s arch, reduced (`full`: at
    its published size, its params made by `host_params`) from seed-0
    weights, its prompts and greedy tokens through `Engine` under each
    policy, after a warm-up `generate` (kernel builds, the groups' first
    collectives); the decode steps' ``CommLog`` (read in the observer
    after prefill and after the last step) and wall time.  Raises where
    the bytes or calls differ from `decode_comm`.  One dict per
    policy."""
    import torch.distributed as dist

    from repro_torch.configs import ParallelConfig, get_config, reduce_config
    from repro_torch.core.comm import axis_sizes
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(shape.arch) if full else reduce_config(
        get_config(shape.arch))
    pcfg = ParallelConfig(attn_impl="pallas" if full else "chunked",
                          moe_impl="shard_map", remat="none")
    params = host_params(cfg, device) if full else get_model(cfg).init(
        0, cfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                               (shape.batch, shape.prompt),
                                               dtype=np.int32)
    sizes = axis_sizes(mesh)
    rows = []
    for policy in shape.policies:
        eng = Engine(cfg, pcfg, ServeConfig(max_seq=shape.max_seq,
                                            policy=policy),
                     params, mesh=mesh, device=device)
        marks = []

        def observer(kind, *, done, lengths):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            marks.append((time.perf_counter(), eng.log.ops,
                          eng.log.wire_bytes, eng.log.staged_bytes))

        eng.generate({"tokens": prompt}, 2)   # warm-up: builds, first calls
        dist.barrier()
        eng.generate({"tokens": prompt}, shape.new, observer=observer)
        steps = len(marks) - 1
        ops = (marks[-1][1] - marks[0][1]) / steps
        wire = marks[-1][2] - marks[0][2]
        want_wire, want_ops = decode_comm(
            cfg, sizes, shape.batch, policy, max_seq=shape.max_seq,
            splits=decode_splits(cfg, sizes, shape.batch, policy, shape.max_seq,
                                 device))
        if wire != want_wire * steps or ops != want_ops:
            raise RuntimeError(f"serve_policies: {policy}: {wire / steps} B "
                               f"and {ops} calls per step, the schedule "
                               f"says {want_wire} and {want_ops}")
        bax = eng.ctx.batch_axes
        rows.append({
            "policy": policy, "arch": cfg.name, "layers": cfg.n_layers,
            "mesh": list(shape.mesh),
            "batch_shards": math.prod(sizes[a] for a in bax),
            "collective_bytes_per_tok": wire / (steps * shape.batch),
            "collective_ops": ops,
            "step_ms_host": (marks[-1][0] - marks[0][0]) / steps * 1e3,
            "staged_bytes_per_step": (marks[-1][3] - marks[0][3]) / steps,
            "transport": transport(marks[-1][3] - marks[0][3])})
        del eng
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
          shared: bool, out_path: str, shape: Shape,
          full: bool) -> None:
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
        mesh = make_test_mesh(shape.mesh, MESH[1], device_type=dev.type)
        rows = measure(mesh, dev, shape, full=full)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(rows, f)
    finally:
        dist.destroy_process_group()


def run(device: str = "cuda", full: bool = False,
        shape: Shape = Shape()) -> list[dict]:
    """Spawn RANKS processes serving `shape` and return rank 0's rows.  On
    cards: NCCL,
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
                              shared, out, shape, full), nprocs=RANKS)
        with open(out) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help="the arch at its published size")
    ap.add_argument("--arch", default=ARCH)
    ap.add_argument("--mesh", default="x".join(map(str, MESH[0])),
                    help="'data' x 'model' sizes, 4 ranks in all (2x2, 1x4)")
    ap.add_argument("--prompt", type=int, default=PROMPT)
    ap.add_argument("--new", type=int, default=NEW)
    ap.add_argument("--policies", default="mlr,slr")
    args = ap.parse_args(argv)
    mesh = tuple(int(n) for n in args.mesh.split("x"))
    if len(mesh) != 2 or math.prod(mesh) != RANKS:
        ap.error(f"--mesh {args.mesh}: want two sizes of product {RANKS}")
    shape = Shape(args.arch, mesh, BATCH, args.prompt, args.new,
                  max(MAX_SEQ, args.prompt + args.new),
                  tuple(args.policies.split(",")))
    print("\n".join(format_rows(run(args.device, args.full, shape))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
