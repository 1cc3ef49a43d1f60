"""Shared model primitives: norms, init, dtype policy (port of
``repro/models/common.py``).

Parameters are stored float32 and cast to the compute dtype (bf16) at use,
as in the reference.  `cast_weights` makes those casts once, ahead of
serving: it rounds exactly the leaves the model casts at use, so every
number is the same as casting at each use.  Parameter trees are plain
nested dicts whose flattened key paths match
``configs.base._param_shapes`` exactly.

Sharded execution (`MeshContext`): on a mesh each rank holds plain
local tensors, its block of every global leaf (``partitioning.
local_shard``), and the model code is handed a `MeshContext` as its
``mesh=`` keyword (``None``: one device, the code as it is without a
mesh).  The reference's sharding helpers become explicit operations on
it: its ``filter_spec`` is ``partitioning.filter_spec`` on the context's
mesh, its ``dp_axes`` the context's `batch_axes` (the serving policy's
batch cut), and its ``shard`` constraints, which GSPMD turns into
collectives, are two operations issued in the open: the FSDP gather of a
leaf over its 'data' (and 'pod') entries, layer by layer at use
(`MeshContext.fsdp`), and the 'model'-axis sum of a row-parallel product
(`MeshContext.sum`).  The reshards of the reference's ``embed_lookup``
become `embed_lookup`'s gathers of token ids and feature blocks.  Every
collective goes through ``core/collectives.py`` and is counted in the
context's ``CommLog``.

Training runs the same code under autograd: the gathers, sums and
reduce-scatters are ``collectives.all_gather`` / ``all_reduce`` /
``reduce_scatter``, whose backwards are their adjoints over the ranks
(the FSDP gather's is the reduce-scatter of the weight's gradient onto
this rank's shard), so a rank's gradients are those of its own share of
the loss; ``train/step.py`` scales the loss and sums the replicated
leaves' gradients to match.  Sequence parallelism (``seq_parallel``,
the training layout of ``pcfg.seq_shard_activations``): a stack's
residual stream is this rank's block of the sequence (`seq_view`,
`seq_rows`); a block gathers its input's sequence over 'model'
(`seq_join`), and its tensor-parallel exit (`MeshContext.tp_out`) is a
reduce-scatter over the sequence in place of the all-reduce; a block
whose output is whole over 'model' keeps its rows (`seq_leave`).
"""
from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

Params = Any  # nested dict of tensors

# ----------------------------------------------------------------------------
# dtype policy
# ----------------------------------------------------------------------------

PARAM_DTYPE = torch.float32

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def cast(x, cfg):
    return x.to(compute_dtype(cfg))


def _is_norm(path: str) -> bool:
    leaf = path.split(".")[-1]
    return "norm" in leaf or leaf in ("scale", "ln_x")


#: leaves the models read in float32 besides the norms: RWKV6's bonus u,
#: the MoE router (the reference routes in float32) and Mamba2's A_log, D
#: and dt_bias (the reference reads them with ``.astype(float32)``)
_FLOAT32_LEAVES = ("bonus", "router", "A_log", "D", "dt_bias")


def cast_weights(params: Params, cfg, device=None) -> Params:
    """The tree on `device` (default: where it is) with every weight the
    model casts at use (projections, MLP and experts, token-shift mixes,
    Mamba2's conv, embedding table, head) already in the compute dtype;
    norm scales and `_FLOAT32_LEAVES`, which the models read in float32,
    stay float32."""
    tree: dict = {}
    for path, leaf in flatten_paths(params).items():
        leaf = leaf.to(device) if device is not None else leaf
        keep = _is_norm(path) or path.split(".")[-1] in _FLOAT32_LEAVES
        _set(tree, path, leaf if keep else cast(leaf, cfg))
    return tree


def check_device(device) -> torch.device:
    """`device` as a ``torch.device``; CUDA without a card raises (there is
    no silent CPU path)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no CUDA device is "
                           f"available; pass device='cpu' to run the plain "
                           f"PyTorch versions")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"device={str(device)!r}: want 'cuda' or 'cpu'")
    return dev


# ----------------------------------------------------------------------------
# initialisation
# ----------------------------------------------------------------------------


def _trunc_normal(gen, shape, device) -> torch.Tensor:
    x = torch.empty(shape, dtype=PARAM_DTYPE, device=device)
    return torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=gen)


def init_dense(gen, shape, device, in_axis: int = -2) -> torch.Tensor:
    """Truncated-normal fan-in init (stddev 1/sqrt(fan_in), cut at 3σ)."""
    std = 1.0 / math.sqrt(shape[in_axis])
    return _trunc_normal(gen, shape, device).mul_(std)


def init_embed(gen, shape, device) -> torch.Tensor:
    return _trunc_normal(gen, shape, device).mul_(0.02)


def init_from_shapes(gen: torch.Generator, shapes: dict[str, tuple[int, ...]],
                     device="cuda") -> Params:
    """Build a nested param dict from a flat {dotted.path: shape} table,
    with the reference's distributions: ones for norms and Mamba2's D,
    log U[1, 16] for its A_log, softplus^-1 of exp U[log 1e-3, log 1e-1]
    for its dt_bias, 0.5 for RWKV6's token-shift mixes (``mu``) and bonus,
    0.02 x truncated normal for the embedding, fan-in truncated normal for
    dense weights.  `gen` draws on `device`.  JAX's random bits cannot be
    reproduced, so parity tests load the reference's params (`convert`)."""
    dev = check_device(device)
    tree: dict = {}
    for path, shape in sorted(shapes.items()):
        leaf_name = path.split(".")[-1]
        if _is_norm(path) or leaf_name == "D":
            val = torch.ones(shape, dtype=PARAM_DTYPE, device=dev)
        elif leaf_name == "A_log":
            val = torch.empty(shape, dtype=PARAM_DTYPE, device=dev).uniform_(
                1.0, 16.0, generator=gen).log_()
        elif leaf_name == "dt_bias":
            dt = torch.empty(shape, dtype=PARAM_DTYPE, device=dev).uniform_(
                math.log(1e-3), math.log(1e-1), generator=gen).exp_()
            val = dt + torch.log(-torch.expm1(-dt))
        elif leaf_name in ("mu", "bonus"):
            val = torch.full(shape, 0.5, dtype=PARAM_DTYPE, device=dev)
        elif leaf_name == "tokens" or path.startswith("embed"):
            val = init_embed(gen, shape, dev)
        else:
            val = init_dense(gen, shape, dev)
        _set(tree, path, val)
    return tree


def _set(tree: dict, path: str, val) -> None:
    parts = path.split(".")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = val


def get_path(tree: dict, path: str):
    for p in path.split("."):
        tree = tree[p]
    return tree


def flatten_paths(tree, prefix: str = "") -> dict[str, Any]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_paths(v, name))
        else:
            out[name] = v
    return out


def leaves(tree) -> list:
    """The leaves of nested dicts in JAX's order (``jax.tree.leaves``:
    keys sorted at every level)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    return [tree]


def map_tree(fn, *trees):
    """`fn` over the leaves of nested dicts of one structure, as
    ``jax.tree.map`` (called in `leaves` order)."""
    if isinstance(trees[0], dict):
        return {k: map_tree(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def unflatten_paths(flat: dict[str, Any]) -> Params:
    tree: dict = {}
    for path, v in flat.items():
        _set(tree, path, v)
    return tree


# ----------------------------------------------------------------------------
# norms / products
# ----------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x, scale, eps: float = 1e-5):
    """Scale-only layer norm in float32, in x's dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, unbiased=False, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def sinusoidal_positions(seq: int, dim: int, offset: int = 0,
                         device="cpu") -> torch.Tensor:
    """(seq, dim) float32 sinusoidal absolute positions (whisper-style):
    sin of the first dim/2 bands, then cos."""
    pos = torch.arange(seq, device=device)[:, None] + offset
    half = dim // 2
    freq = torch.exp(-math.log(10_000.0)
                     * torch.arange(half, dtype=torch.float32, device=device)
                     / max(half - 1, 1))
    ang = pos.float() * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def matmul(x, w):
    """``x @ w`` in JAX's promoted type (bf16 with float32 -> float32)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def matmul_f32(x, w):
    """``x @ w`` with float32 operands and result: the reference's
    ``preferred_element_type=float32`` product of (possibly bf16) inputs
    (a product of two bf16 values is exact in float32)."""
    return torch.matmul(x.float(), w.float())


# ----------------------------------------------------------------------------
# sharded execution: one rank's view of the mesh
# ----------------------------------------------------------------------------


def dp_axes() -> tuple[str, str]:
    """Mesh axes carrying the batch (data-parallel) dimension."""
    return ("pod", "data")


def entry_axes(entry) -> tuple[str, ...]:
    """The axes one spec entry names, major first (``None``: none)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block_index(axes, coord: dict, sizes: dict) -> tuple[int, int]:
    """(index, count) of the block that `coord` ({axis: index}) holds of
    a dim cut over `axes`, the first axis major; an axis missing from
    `sizes` counts as size 1."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * sizes.get(a, 1) + coord.get(a, 0)
        n *= sizes.get(a, 1)
    return idx, n


@dataclasses.dataclass
class MeshContext:
    """What a model call needs on one rank of a ``DeviceMesh``: `specs`,
    the filtered spec tree of the local param shards it is given (MLR:
    ``partitioning.param_specs``; SLR: the same with 'model' stripped);
    `batch_axes`, the axes the batch dim is cut over (the policy's,
    filtered; ``()`` where the batch stays replicated); `cache_specs`,
    the filtered specs of the KV cache's leaves; `log`, the ``CommLog``
    every collective of the calls is counted in.  Axis sizes, this rank's
    coordinates and the groups of the axes of size > 1 are read once."""
    mesh: Any
    specs: Params
    batch_axes: tuple = ()
    cache_specs: dict | None = None
    log: Any = None
    #: training: the residual stream may be cut over the sequence on
    #: 'model' (`seq_view` decides per stack); `sp_boundary` "op" or "layer"
    seq_parallel: bool = False
    sp_boundary: str = "op"
    #: training: the MoE router's load-balance statistics are summed over
    #: the batch's 'data' cut (the reference's whole-batch aux loss)
    train: bool = False
    #: set on a `seq_view`: this stack's residual is cut over the sequence
    seq_cut: bool = False

    def __post_init__(self):
        from repro_torch.core.comm import (CommLog, axis_coords, axis_group,
                                           axis_sizes)
        self.sizes = axis_sizes(self.mesh)
        self.coords = axis_coords(self.mesh)
        self.groups = {a: axis_group(self.mesh, a)
                       for a, n in self.sizes.items() if n > 1}
        self.batch_axes = tuple(a for a in self.batch_axes
                                if self.sizes.get(a, 1) > 1)
        if self.log is None:
            self.log = CommLog()

    def size(self, axes) -> int:
        return math.prod(self.sizes.get(a, 1) for a in axes)

    def spec(self, path: str) -> tuple:
        """The filtered spec of the param leaf at dotted `path`."""
        return get_path(self.specs, path)

    def block(self, axes) -> tuple[int, int]:
        """(index, count) of this rank's block of a dim cut over `axes`,
        the first axis major."""
        return block_index(axes, self.coords, self.sizes)

    def rows(self, x, axes):
        """This rank's block of `x`'s leading dim cut over `axes`."""
        i, n = self.block(axes)
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    def gather(self, x, dim: int, axes):
        """The blocks of a dim cut over `axes` (first major) joined on `dim`,
        from every rank that differs from this one on those axes: one
        fused all-gather per axis of size > 1, the minor axis first (its
        backward: the reduce-scatter of the gradient's blocks)."""
        from repro_torch.core.collectives import all_gather
        dim = dim % x.dim()
        for a in reversed(tuple(axes)):
            if self.sizes.get(a, 1) > 1:
                parts = all_gather(x, self.groups[a], self.log)
                x = parts.movedim(0, dim).flatten(dim, dim + 1)
        return x

    def sum(self, x, axes):
        """`x` summed over the ranks of `axes`: one fused all-reduce per
        axis of size > 1 (its backward: the all-reduce of the
        gradient)."""
        from repro_torch.core.collectives import all_reduce
        for a in axes:
            if self.sizes.get(a, 1) > 1:
                x = all_reduce(x, self.groups[a], self.log)
        return x

    def scatter(self, x, dim: int, axes):
        """`x` summed over the ranks of `axes`, of which this rank keeps its
        block of `dim` (cut over `axes`, the first major): one fused
        reduce-scatter per axis of size > 1, the major axis first (its
        backward: the all-gather of the gradient)."""
        from repro_torch.core.collectives import reduce_scatter
        dim = dim % x.dim()
        for a in axes:
            n = self.sizes.get(a, 1)
            if n > 1:
                blocks = x.unflatten(dim, (n, x.shape[dim] // n))
                x = reduce_scatter(blocks.movedim(dim, 0).contiguous(),
                                   self.groups[a], self.log)
        return x

    def max(self, x, axes):
        """`x`'s elementwise max over the ranks of `axes` (no gradient): one
        fused all-reduce per axis of size > 1."""
        from repro_torch.core.collectives import dedicated_all_reduce
        for a in axes:
            if self.sizes.get(a, 1) > 1:
                x = dedicated_all_reduce(x, self.groups[a], self.log, "max")
        return x

    def tp_out(self, partial):
        """The exit of a tensor-parallel block, the float32 partial product
        of this rank's share: summed over 'model', or, where the stack's
        residual is cut over the sequence (`seq_cut`), reduce-scattered
        over it (dim 1) so this rank keeps its block."""
        if self.seq_cut:
            return self.scatter(partial, 1, ("model",))
        return self.sum(partial, ("model",))

    def view(self, seq_cut: bool) -> "MeshContext":
        """This context with `seq_cut` set (the same groups and log)."""
        out = copy.copy(self)
        out.seq_cut = seq_cut
        return out

    def fsdp(self, leaf, spec: tuple):
        """The FSDP gather at use: `leaf` (a local shard under `spec`) with
        every dim cut over axes other than 'model' gathered whole, so it
        is left cut over 'model' alone (its tensor-parallel block).  A dim
        cut over 'model' and another axis at once raises (only the
        embedding table is, and `embed_lookup` reads it as it lies)."""
        for d, entry in enumerate(spec):
            axes = entry_axes(entry)
            if not axes or axes == ("model",):
                continue
            if "model" in axes:
                raise ValueError(f"MeshContext.fsdp: dim {d} of {spec} is "
                                 f"cut over 'model' and {axes}")
            leaf = self.gather(leaf, d, axes)
        return leaf

    def all_done(self, done) -> bool:
        """True where every lane of every rank is done (`done`: this
        rank's (B,) mask): one fused all-reduce of the live lanes' count
        over every rank (the mesh spans the process group), so every rank
        takes the same branch."""
        import torch.distributed as dist

        from repro_torch.core.collectives import dedicated_all_reduce
        live = (~done).sum().to(torch.int32).reshape(1)
        return int(dedicated_all_reduce(live, dist.group.WORLD,
                                        self.log)[0]) == 0


def row_parallel(x, w, mesh: MeshContext):
    """``x @ w`` of a row-parallel block (`x`'s columns and `w`'s rows are
    this rank's share): the float32 partial product summed over 'model'
    (reduce-scattered over the sequence where it is cut,
    `MeshContext.tp_out`), then rounded once to the product's dtype, as
    the whole product is."""
    out = mesh.tp_out(matmul_f32(x, w))
    return out.to(torch.promote_types(x.dtype, w.dtype))


# ----------------------------------------------------------------------------
# sequence parallelism (training)
# ----------------------------------------------------------------------------


def seq_view(mesh, s: int):
    """The context a stack of sequence length `s` runs its layers under:
    `mesh` with ``seq_cut`` where sequence parallelism is on and 'model'
    divides `s`; `mesh` itself otherwise (and ``None`` without one)."""
    if mesh is None or not mesh.seq_parallel:
        return mesh
    m = mesh.size(("model",))
    return mesh.view(m > 1 and s % m == 0)


def seq_rows(x, mesh):
    """This rank's block of `x`'s sequence (dim 1) where the stack's
    residual is cut; `x` otherwise."""
    if mesh is None or not mesh.seq_cut:
        return x
    i, n = mesh.block(("model",))
    k = x.shape[1] // n
    return x[:, i * k:(i + 1) * k]


def seq_join(x, mesh):
    """The whole sequence from this rank's block, gathered over 'model'
    (a block's entry, the stack's end), where the residual is cut; `x`
    otherwise."""
    if mesh is None or not mesh.seq_cut:
        return x
    return mesh.gather(x, 1, ("model",))


def seq_leave(y, x, mesh):
    """A block's output `y` on the residual `x`'s rows: as it is where its
    exit reduce-scattered it (or nothing is cut), this rank's rows where
    it is whole over 'model'."""
    if mesh is None or not mesh.seq_cut or y.shape[1] == x.shape[1]:
        return y
    return seq_rows(y, mesh)


def embed_lookup(table, tokens, cfg, mesh: MeshContext):
    """The token table's rows on a rank of a mesh.  The table is
    feature-sharded (``embed.tokens``: vocab whole, d cut over its
    entry's axes), as in the reference, so the lookup is local; this rank
    gathers the token ids of every rank it shares a feature cut with that
    holds other requests (the batch axes the feature entry also names),
    looks them all up in its feature block, gathers the feature blocks
    and keeps its own requests' rows: ids and (B, S, d) activations move,
    never the table."""
    feat = entry_axes(mesh.spec("embed.tokens")[1])
    shared = tuple(a for a in mesh.batch_axes if a in feat)
    x = F.embedding(mesh.gather(tokens, 0, shared), cast(table, cfg))
    return mesh.rows(mesh.gather(x, -1, feat), shared)


def tied_logits(table, hidden, cfg, mesh: MeshContext):
    """``hidden @ table.T`` in float32 on a rank of a mesh, the table
    feature-sharded: the hidden rows of every rank that shares this
    rank's feature cut are gathered, multiplied by this rank's feature
    block of the table, the float32 partial logits summed over the
    feature axes, and this rank's rows kept."""
    feat = entry_axes(mesh.spec("embed.tokens")[1])
    shared = tuple(a for a in mesh.batch_axes if a in feat)
    h = mesh.gather(hidden, 0, shared)
    i, n = mesh.block(feat)
    k = h.shape[-1] // n
    part = matmul_f32(h[..., i * k:(i + 1) * k], cast(table, cfg).T)
    return mesh.rows(mesh.sum(part, feat), shared)
