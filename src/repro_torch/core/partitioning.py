"""Logical-axis partitioning rules: param/batch/cache trees -> specs (port
of ``repro/core/partitioning.py``).

One canonical rule table maps parameter leaf paths (the dotted names of
``models.common.flatten_paths``) to specs written for the full production
mesh ('pod', 'data', 'model').  `filter_spec` then restricts every spec to
the actual mesh (dropping absent axes and non-divisible shardings), so the
same rules serve the 512-rank layout, small test meshes and one card.

A spec is a tuple with one entry per tensor dim, each ``None``, an axis
name or a tuple of axis names, as ``jax.sharding.PartitionSpec`` is; the
trees of specs are nested dicts shaped as the trees they describe.  A mesh
is anything `core.comm.axis_sizes` reads.  `placements` turns a spec on
a ``DeviceMesh`` into DTensor placements.

Sharded execution keeps plain local tensors: `local_shard` cuts a rank's
block out of a global leaf under a filtered spec (`shard_tree` over a
tree), and `assemble` puts the blocks of every rank back together (its
inverse, for tests).  A dim sharded over several axes is cut with the
first axis of its entry major, as JAX cuts it (and as `placements`
requires them in the mesh's order).

Scheme: Megatron TP over 'model', FSDP (params, grads and optimizer state
sharded) over 'data', pure replication over 'pod' (gradients reduced
across pods by ``core/collectives.py``).
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.core.comm import axis_coords, axis_sizes
from repro_torch.models.common import (block_index, entry_axes, flatten_paths,
                                       map_tree, unflatten_paths)

DP = ("pod", "data")
FSDP = "data"          # parameter-sharding axis
TP = "model"

# (regex on the leaf path, spec WITHOUT the stacked leading dim).
# embed.tokens is feature-sharded (vocab replicated), as in the reference.
_RULES: list[tuple[str, tuple]] = [
    (r"embed\.tokens$",            (None, (FSDP, TP))),
    (r"head\.w$",                  (FSDP, TP)),
    (r"(attn|self_attn|cross_attn)\.(wq|wk|wv)$", (FSDP, TP)),
    (r"(attn|self_attn|cross_attn)\.wo$",         (TP, FSDP)),
    (r"(q_norm|k_norm)$",          ()),
    (r"mlp\.(w_gate|w_up)$",       (FSDP, TP)),
    (r"mlp\.w_down$",              (TP, FSDP)),
    (r"moe\.router$",              (FSDP, None)),
    (r"experts\.(w_gate|w_up)$",   (TP, FSDP, None)),
    (r"experts\.w_down$",          (TP, None, FSDP)),
    # rwkv6
    (r"tmix\.w_(r|k|v|g)$",        (FSDP, TP)),
    (r"tmix\.w_o$",                (TP, FSDP)),
    (r"tmix\.w_decay$",            (FSDP, None)),
    (r"tmix\.w_decay2$",           (None, FSDP)),
    (r"tmix\.(mu|bonus|ln_x)$",    ()),
    (r"cmix\.w_(k|r)$",            (FSDP, TP)),
    (r"cmix\.w_v$",                (TP, FSDP)),
    (r"cmix\.mu$",                 ()),
    # mamba2
    (r"mamba\.w_in$",              (FSDP, TP)),
    (r"mamba\.conv$",              (None, TP)),
    (r"mamba\.w_out$",             (TP, FSDP)),
    (r"mamba\.(A_log|D|dt_bias|norm)$", ()),
    # norms & anything residual-shaped
    (r"(norm|scale|ln)",           ()),
]

_STACKED_PREFIXES = ("layers.", "enc.", "dec.", "shared.")


def spec_for_param(path: str, ndim: int) -> tuple:
    stacked = path.startswith(_STACKED_PREFIXES) and not path.endswith(
        "final_norm")
    base = next((spec for pat, spec in _RULES if re.search(pat, path)), ())
    entries = ((None,) if stacked else ()) + base
    entries = entries + (None,) * (ndim - len(entries))
    return entries[:ndim]


def filter_spec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Restrict spec to mesh axes; drop non-divisible shardings."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        axes = tuple(a for a in axes if a in sizes and sizes[a] > 1)
        prod = math.prod(sizes[a] for a in axes) if axes else 1
        if dim % prod != 0:
            axes = ()
        out.append(axes if len(axes) > 1 else (axes[0] if axes else None))
    return tuple(out)


def _map_paths(fn, tree: Any) -> Any:
    """`fn(path, leaf)` over a nested dict's leaves, the same nesting out."""
    return unflatten_paths({p: fn(p, leaf)
                            for p, leaf in flatten_paths(tree).items()})


def param_specs(params: Any, mesh) -> Any:
    """Tree of tensors (any leaves with ``.shape``) -> tree of specs."""
    return _map_paths(lambda path, leaf: filter_spec(
        spec_for_param(path, len(leaf.shape)), tuple(leaf.shape), mesh),
        params)


def config_specs(cfg, mesh) -> Any:
    """The filtered specs of `cfg`'s params on `mesh`, from the config's
    global shapes (``configs.base._param_shapes``): no tensor needed,
    whatever a rank holds."""
    from repro_torch.configs.base import _param_shapes
    return unflatten_paths({path: filter_spec(
        spec_for_param(path, len(shape)), tuple(shape), mesh)
        for path, shape in _param_shapes(cfg).items()})


def param_shardings(params: Any, device_mesh) -> Any:
    return shardings(param_specs(params, device_mesh), device_mesh)


def batch_specs(batch: Any, mesh) -> Any:
    """tokens/labels (B,S) over dp; positions (3,B,S); enc_embed (B,F,d)."""
    def one(name, leaf):
        nd = len(leaf.shape)
        spec = ((None, DP, None) if name == "positions"
                else (DP,) + (None,) * (nd - 1))
        return filter_spec(spec, tuple(leaf.shape), mesh)
    return _map_paths(one, batch)


def tree_specs(tree: Any, spec_map: dict, mesh) -> Any:
    """Apply a {top_level_key: spec} map (e.g. cache specs) with
    filtering."""
    return _map_paths(lambda path, leaf: filter_spec(
        spec_map.get(path.split(".")[0], ()), tuple(leaf.shape), mesh), tree)


def placements(spec: tuple, device_mesh) -> list:
    """DTensor placements of `spec` on `device_mesh` (anything with
    ``mesh_dim_names``): per mesh dim, ``Shard(d)`` where tensor dim d's
    entry names it, else ``Replicate()``.  A dim sharded over several
    axes must name them in the mesh's order (DTensor shards a dim over
    mesh dims left to right); every axis named must be in the mesh
    (filter the spec first)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"placements: {spec} names {missing}, not in "
                             f"the mesh's {names}")
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"placements: dim {d} of {spec} is sharded "
                             f"over {axes}, not in the mesh's order {names}")
        for j in idx:
            out[j] = Shard(d)
    return out


def shardings(tree_of_specs: Any, device_mesh) -> Any:
    """Tree of specs -> tree of placements lists on `device_mesh`."""
    return map_tree(lambda s: placements(s, device_mesh), tree_of_specs)


def strip_axis(tree_of_specs: Any, axis: str = "model") -> Any:
    """Remove one mesh axis from every spec (e.g. disable TP: params
    replicated over 'model')."""
    def strip(spec):
        out = []
        for e in spec:
            if e == axis:
                out.append(None)
            elif isinstance(e, tuple):
                kept = tuple(a for a in e if a != axis)
                out.append(kept if len(kept) > 1 else
                           (kept[0] if kept else None))
            else:
                out.append(e)
        return tuple(out)
    return map_tree(strip, tree_of_specs)


# ----------------------------------------------------------------------------
# local shards of global leaves
# ----------------------------------------------------------------------------


def local_shape(shape, spec: tuple, mesh) -> tuple[int, ...]:
    """The shape of one rank's block of a leaf of `shape` under `spec` (a
    filtered spec: every dim divides by its axes' sizes)."""
    sizes = axis_sizes(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n = math.prod(sizes[a] for a in entry_axes(entry))
        if dim % n:
            raise ValueError(f"local_shape: dim {dim} of {tuple(shape)} does "
                             f"not divide over {entry} ({n}); filter the "
                             f"spec first")
        out.append(dim // n)
    return tuple(out)


def local_shard(leaf, spec: tuple, mesh, coord: dict | None = None):
    """The block of the global `leaf` that the rank at `coord` ({axis:
    index}; default: this rank's, `core.comm.axis_coords`) holds under the
    filtered `spec`: a view, on the leaf's device."""
    sizes = axis_sizes(mesh)
    coord = axis_coords(mesh) if coord is None else coord
    local = local_shape(tuple(leaf.shape), spec, mesh)
    out = leaf
    for d, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            i, _ = block_index(axes, coord, sizes)
            out = out.narrow(d, i * local[d], local[d])
    return out


def shard_tree(tree: Any, specs: Any, mesh, coord: dict | None = None) -> Any:
    """`local_shard` over a tree and its tree of specs."""
    coord = axis_coords(mesh) if coord is None else coord
    return map_tree(lambda leaf, spec: local_shard(leaf, spec, mesh, coord),
                    tree, specs)


def mesh_coords(mesh) -> list[dict]:
    """Every rank's coordinate of `mesh`, in row-major order."""
    sizes = axis_sizes(mesh)
    coords = [{}]
    for a, n in sizes.items():
        coords = [dict(c, **{a: i}) for c in coords for i in range(n)]
    return coords


def assemble(blocks: list, spec: tuple, mesh):
    """The global leaf from every rank's block (`blocks[j]` the block of
    ``mesh_coords(mesh)[j]``), the inverse of `local_shard`; raises where
    two ranks that hold the same block disagree, or a block is missing."""
    import torch
    sizes = axis_sizes(mesh)
    coords = mesh_coords(mesh)
    shape = list(blocks[0].shape)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    glob = [dim * math.prod(sizes[a] for a in entry_axes(e))
            for dim, e in zip(shape, entries)]
    out = torch.empty(glob, dtype=blocks[0].dtype)
    seen = torch.zeros(glob, dtype=torch.bool)
    for c, blk in zip(coords, blocks):
        view, mask = out, seen
        for d, e in enumerate(entries):
            axes = entry_axes(e)
            if axes:
                i, _ = block_index(axes, c, sizes)
                view = view.narrow(d, i * shape[d], shape[d])
                mask = mask.narrow(d, i * shape[d], shape[d])
        blk = blk.detach().cpu()
        if bool(mask.any()) and not torch.equal(view, blk):
            raise ValueError(f"assemble: ranks that share a block of {spec} "
                             f"disagree (rank {c})")
        view.copy_(blk)
        mask.fill_(True)
    if not bool(seen.all()):
        raise ValueError(f"assemble: the blocks do not cover the leaf "
                         f"({spec})")
    return out


def assemble_tree(trees: list, specs: Any, mesh) -> Any:
    """`assemble` over trees of blocks, one per rank in `mesh_coords`
    order."""
    return map_tree(lambda spec, *blocks: assemble(list(blocks), spec, mesh),
                    specs, *trees)
