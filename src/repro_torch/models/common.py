"""Shared model primitives: norms, init, dtype policy (port of
``repro/models/common.py``).

Parameters are stored float32 and cast to the compute dtype (bf16) at use,
as in the reference.  `cast_weights` makes those casts once, ahead of
serving: it rounds exactly the leaves the model casts at use, so every
number is the same as casting at each use.  Parameter trees are plain
nested dicts whose flattened key paths match
``configs.base._param_shapes`` exactly.

The reference's sharding helpers (``shard``, ``filter_spec``, the
reshards inside ``embed_lookup``) have no counterpart here: on one card
they are the identity.
"""
from __future__ import annotations

import math
from typing import Any

import torch

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
