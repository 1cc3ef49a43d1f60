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

Scheme: Megatron TP over 'model', FSDP (params, grads and optimizer state
sharded) over 'data', pure replication over 'pod' (gradients reduced
across pods by ``core/collectives.py``).
"""
from __future__ import annotations

import math
import re
from typing import Any

from repro_torch.core.comm import axis_sizes
from repro_torch.models.common import flatten_paths, map_tree, unflatten_paths

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
