"""The port's partition rules (``core/partitioning.py``) and meshes
(``launch/mesh.py``) against the reference's.

Every parameter path of every arch of ``configs.archs`` at full size gets
the reference's spec (``tuple(PartitionSpec)``) on the meshes (16, 16)
and (2, 16, 16) (the production layouts), (2, 2), and (4,) over 'pod' and
over 'data'.  The reference reads only a mesh's axis names and sizes, so
its side takes a JAX ``AbstractMesh``, the port's a `MeshShape` (no
process group), and the reference's param trees are ``jax.eval_shape``
of its own init, the port's meta tensors of ``_param_shapes``.  Also
`batch_specs` (positions, enc_embed), `tree_specs`, `strip_axis`,
`state_specs` and `placements`' rules; placements on a real DeviceMesh are
held in ``test_torch_collectives.py``.  Then the local shards of sharded
execution: `local_shard` and its inverse `assemble` round-trip every
arch's param tree on four meshes, no process group needed (a rank's
coordinate is given)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, AxisType  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import models as ref_models  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import partitioning as RP  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402
from repro_torch.configs.archs import ALL_ARCHS  # noqa: E402
from repro_torch.configs.base import _param_shapes  # noqa: E402
from repro_torch.core import partitioning as part  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.common import flatten_paths, unflatten_paths  # noqa: E402
from repro_torch.train.optimizer import AdamWState  # noqa: E402
from repro_torch.train.step import TrainState, state_specs  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "4pod": ((4,), ("pod",)),
          "4data": ((4,), ("data",))}


def _meshes(key):
    shape, names = MESHES[key]
    return (AbstractMesh(shape, names, axis_types=(AxisType.Auto,) *
                         len(names)),
            mesh_mod.make_test_mesh(shape, names))


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch):
    cfg = ref_get_config(arch)
    return jax.eval_shape(lambda: ref_models.get_model(cfg).init(
        jax.random.PRNGKey(0), cfg))


def _port_shapes(arch):
    return unflatten_paths({k: torch.empty(s, device="meta") for k, s
                            in _param_shapes(get_config(arch)).items()})


def _ref_flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in kp): v
            for kp, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda s: isinstance(s, P))[0]}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_specs_match_reference(arch, mesh):
    rmesh, pmesh = _meshes(mesh)
    want = _ref_flat(RP.param_specs(_ref_shapes(arch), rmesh))
    got = flatten_paths(part.param_specs(_port_shapes(arch), pmesh))
    assert set(got) == set(want)
    for path, spec in want.items():
        assert got[path] == tuple(spec), (path, got[path], spec)


def test_spec_for_param_representative_paths():
    """The reference test's paths (tests/test_partitioning.py:16-32), and
    every one equal to the reference's own answer."""
    cases = [("layers.attn.wq", 3), ("layers.attn.wo", 3),
             ("layers.attn.q_norm", 2), ("layers.mlp.w_down", 3),
             ("embed.tokens", 2), ("head.w", 2),
             ("layers.moe.experts.w_gate", 4), ("layers.moe.router", 3),
             ("layers.tmix.w_o", 3), ("layers.mamba.w_in", 3),
             ("layers.mamba.A_log", 2), ("final_norm.scale", 1),
             ("shared.attn.wq", 3), ("enc.final_norm", 1),
             ("dec.self_attn.wk", 3), ("unknown.leaf", 2)]
    for path, nd in cases:
        assert part.spec_for_param(path, nd) == tuple(
            RP.spec_for_param(path, nd)), path
    assert part.spec_for_param("layers.attn.wq", 3) == (None, "data",
                                                       "model")
    assert part.spec_for_param("embed.tokens", 2) == (None,
                                                      ("data", "model"))


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (8, 8)), (("data", "model"), (8, 6)),
    (("pod", "model"), (8, 8)), ((("pod", "data"), None), (8, 4)),
    ((("data", "model"),), (6,)), ((("data", "model"),), (16, 3)),
    ((), (4, 4)), (("data",), ())])
def test_filter_spec_matches_reference(spec, shape):
    rmesh = AbstractMesh((2, 4), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    pmesh = mesh_mod.make_test_mesh((2, 4))
    assert part.filter_spec(spec, shape, pmesh) == tuple(
        RP.filter_spec(P(*spec), shape, rmesh))


@pytest.mark.parametrize("mesh", list(MESHES))
def test_batch_specs_match_reference(mesh):
    rmesh, pmesh = _meshes(mesh)
    shapes = {"tokens": (64, 16), "labels": (64, 16),
              "positions": (3, 64, 16), "enc_embed": (64, 30, 8),
              "odd": (6, 5)}
    want = RP.batch_specs({k: jax.ShapeDtypeStruct(s, np.float32)
                           for k, s in shapes.items()}, rmesh)
    got = part.batch_specs({k: torch.empty(s, device="meta")
                            for k, s in shapes.items()}, pmesh)
    assert got == {k: tuple(v) for k, v in want.items()}


def test_tree_specs_and_strip_axis_match_reference():
    rmesh, pmesh = _meshes("2x16x16")
    spec_map = {"k": (None, ("pod", "data"), "model", None),
                "v": (None, ("pod", "data"), "model", None)}
    tree = {"k": (4, 32, 16, 8), "v": (4, 32, 16, 8), "pos": (32,)}
    want = RP.tree_specs({k: jax.ShapeDtypeStruct(s, np.float32)
                          for k, s in tree.items()},
                         {k: P(*v) for k, v in spec_map.items()}, rmesh)
    got = part.tree_specs({k: torch.empty(s, device="meta")
                           for k, s in tree.items()}, spec_map, pmesh)
    assert got == {k: tuple(v) for k, v in want.items()}
    specs = part.param_specs(_port_shapes("qwen3-moe-30b-a3b"), pmesh)
    rspecs = RP.param_specs(_ref_shapes("qwen3-moe-30b-a3b"), rmesh)
    for axis in ("model", "data"):
        want = _ref_flat(RP.strip_axis(rspecs, axis))
        got = flatten_paths(part.strip_axis(specs, axis))
        assert got == {k: tuple(v) for k, v in want.items()}, axis


def test_state_specs_mirror_param_specs():
    pmesh = mesh_mod.make_test_mesh((2, 2))
    params = _port_shapes("tinyllama-1.1b")
    st = state_specs(TrainState(step=torch.zeros(()), params=params,
                                opt=AdamWState(m=params, v=params)), pmesh)
    pspecs = part.param_specs(params, pmesh)
    assert st.step == () and st.params == pspecs
    assert st.opt.m == pspecs and st.opt.v == pspecs
    assert st.params["layers"]["attn"]["wq"] == (None, "data", "model")


def test_meshes_without_a_process_group():
    """No process group: the mesh is its axis names and sizes; `axis_sizes`
    reads it, a JAX mesh and the production layouts alike."""
    m = mesh_mod.make_production_mesh(multi_pod=True)
    assert isinstance(m, mesh_mod.MeshShape)
    assert mesh_mod.axis_sizes(m) == {"pod": 2, "data": 16, "model": 16}
    assert mesh_mod.dp_size(m) == 32
    assert mesh_mod.dp_size(mesh_mod.make_production_mesh()) == 16
    assert mesh_mod.dp_size(mesh_mod.make_test_mesh((4,), ("pod",))) == 4
    assert mesh_mod.axis_sizes(_meshes("2x2")[0]) == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="no process group"):
        mesh_mod.axis_group(m, "pod")
    with pytest.raises(ValueError, match="differ in length"):
        mesh_mod.make_test_mesh((2, 2), ("pod",))


class _Mesh:
    mesh_dim_names = ("pod", "data", "model")


def test_placements_rules():
    """Shard(d) per mesh dim that spec dim d names, Replicate elsewhere;
    a dim over several axes in mesh order; unknown axes and reversed order
    raise."""
    from torch.distributed.tensor import Replicate, Shard
    assert part.placements((None, ("data", "model")), _Mesh()) == [
        Replicate(), Shard(1), Shard(1)]
    assert part.placements(("model", "pod"), _Mesh()) == [
        Shard(1), Replicate(), Shard(0)]
    with pytest.raises(ValueError, match="mesh's order"):
        part.placements((("model", "data"),), _Mesh())
    with pytest.raises(ValueError, match="not in the mesh"):
        part.placements(("expert",), _Mesh())
    tree = {"a": ("data",), "b": {"c": ()}}
    assert part.shardings(tree, _Mesh()) == {
        "a": [Replicate(), Shard(0), Replicate()],
        "b": {"c": [Replicate()] * 3}}


# ----------------------------------------------------------------------------
# local shards (sharded execution) and their inverse
# ----------------------------------------------------------------------------

SHARD_MESHES = {"2x2": ((2, 2), ("data", "model")),
                "1x4": ((1, 4), ("data", "model")),
                "4x1": ((4, 1), ("data", "model")),
                "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}


@pytest.mark.parametrize("mesh", list(SHARD_MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_local_shard_round_trips(arch, mesh):
    """Every rank's `local_shard` of every leaf of the arch's reduced param
    tree (distinct values) goes back to the tree exactly (`assemble`:
    ranks holding one block agree, every element covered); the ranks hold
    each element as many times as the axes the spec leaves out replicate
    it; the shapes, and the full-size tree's, are what `filter_spec`
    implies."""
    import math
    pmesh = mesh_mod.make_test_mesh(*SHARD_MESHES[mesh])
    sizes = mesh_mod.axis_sizes(pmesh)
    n_ranks = math.prod(sizes.values())
    cfg = reduce_config(get_config(arch))
    tree = unflatten_paths({
        k: torch.arange(math.prod(s), dtype=torch.float32).reshape(s)
        for k, s in _param_shapes(cfg).items()})
    specs = part.param_specs(tree, pmesh)
    coords = part.mesh_coords(pmesh)
    assert len(coords) == n_ranks and coords[1] != coords[0]
    shards = [part.shard_tree(tree, specs, pmesh, c) for c in coords]
    back = flatten_paths(part.assemble_tree(shards, specs, pmesh))
    flat, fspecs = flatten_paths(tree), flatten_paths(specs)
    for path, leaf in flat.items():
        assert torch.equal(back[path], leaf), path
        used = math.prod(sizes[a] for e in fspecs[path]
                         for a in part.entry_axes(e))
        held = sum(flatten_paths(s)[path].numel() for s in shards)
        assert held == leaf.numel() * n_ranks // used, path
    full = _port_shapes(arch)
    fspecs = flatten_paths(part.param_specs(full, pmesh))
    for path, leaf in flatten_paths(full).items():
        want = tuple(dim // math.prod(sizes[a] for a in part.entry_axes(e))
                     for dim, e in zip(leaf.shape, fspecs[path] + (None,) *
                                       (leaf.dim() - len(fspecs[path]))))
        got = part.local_shard(leaf, fspecs[path], pmesh, coords[-1]).shape
        assert tuple(got) == want == part.local_shape(
            tuple(leaf.shape), fspecs[path], pmesh), path


def test_local_shard_cuts_multi_axis_entries_major_first():
    """A dim over ('data', 'model') is cut data-major, as JAX cuts it (the
    embedding table's feature dim); a dim over 'pod' and 'data' the same;
    blocks that disagree, or do not cover the leaf, raise in `assemble`."""
    pmesh = mesh_mod.make_test_mesh((2, 2, 2), ("pod", "data", "model"))
    x = torch.arange(3 * 8).reshape(3, 8)
    spec = (None, ("data", "model"))
    for c in part.mesh_coords(pmesh):
        i = 2 * c["data"] + c["model"]
        assert torch.equal(part.local_shard(x, spec, pmesh, c),
                           x[:, 2 * i:2 * i + 2])
    y = torch.arange(8 * 2).reshape(8, 2)
    c = {"pod": 1, "data": 0, "model": 1}
    assert torch.equal(part.local_shard(y, (("pod", "data"),), pmesh, c),
                       y[4:6])
    blocks = [part.local_shard(x, spec, pmesh, c)
              for c in part.mesh_coords(pmesh)]
    bad = [b.clone() for b in blocks]
    bad[-1] += 1                          # (1, 1, 1): a copy of (0, 1, 1)
    with pytest.raises(ValueError, match="disagree"):
        part.assemble(bad, spec, pmesh)
    with pytest.raises(ValueError, match="does not divide"):
        part.local_shape((3, 6), spec, pmesh)
    with pytest.raises(ValueError, match="no process group"):
        part.local_shard(x, spec, pmesh)
