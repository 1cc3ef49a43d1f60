"""The port's cross-pod collectives (``core/collectives.py``, the int8 ring
of ``train/compression.py``) against the reference's, same inputs.

The reference runs as its own tests run it: a subprocess with 8 forced
host devices, its ring under ``shard_map`` on ('pod',) meshes of 4 and 8
devices, every output saved to an ``.npz``.  The port runs in one spawn of
8 gloo ranks (``tests/torch_dist.py``): n = 8 on the whole group, n = 4 on
the two 'pod' groups of a (2, 4) ('data', 'pod') mesh (so group ranks and
global ranks differ on one of them), each rank holding the reference's
shard of its group rank.

Tolerances: the rings add in the reference's order, so the all-gathers,
the reduce-scatter and the cascaded all-reduce are bit-identical; the
fused sums (the backend's own order) and the int8 ring rtol 1e-6 of the
reference's; the int8 ring also within the reference test's 6 * scale of
the mean."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess_jax  # noqa: E402

import torch_dist  # noqa: E402

REF = r'''
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, AxisType
from repro.core import collectives as C
from repro.train.compression import compressed_ring_all_reduce

out = {}

def sm(mesh, fn, x):
    """fn on each device's shard x[i] (leading dim split), stacked."""
    f = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                              in_specs=P("pod"), out_specs=P("pod")))
    return np.asarray(f(jnp.asarray(x)))

for n in (4, 8):
    mesh = jax.make_mesh((n,), ("pod",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:n])
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, 5, 3)).astype(np.float32)
    blocks = rng.standard_normal((n, n, 2, 3)).astype(np.float32)
    flat = rng.standard_normal((n, 1000)).astype(np.float32)
    out.update({f"x{n}": x, f"blocks{n}": blocks, f"flat{n}": flat})
    with jax.set_mesh(mesh):
        out[f"ag_c{n}"] = sm(mesh, lambda v: C.cascaded_all_gather(v, "pod"), x)
        out[f"ag_d{n}"] = sm(mesh, lambda v: C.dedicated_all_gather(v, "pod"), x)
        out[f"ar_c{n}"] = sm(mesh, lambda v: C.cascaded_all_reduce(v, "pod"), x)
        out[f"ar_d{n}"] = sm(mesh, lambda v: C.dedicated_all_reduce(v, "pod"), x)
        out[f"rs{n}"] = sm(mesh, lambda v: C.cascaded_reduce_scatter(v, "pod"),
                           blocks)
        out[f"cr{n}"] = sm(mesh, lambda v: compressed_ring_all_reduce(v, "pod"),
                           flat)

# tree_sync on the reference test's tree (tests/test_collectives.py:46-79),
# plus leaves whose leading dim divides by 4 and so take the ring
mesh = jax.make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,),
                     devices=jax.devices()[:4])
x = jax.random.normal(jax.random.PRNGKey(0), (4, 1000))
rng = np.random.default_rng(1)
tree = {"a": x, "b": {"c": x[:, :17] * 3},
        "d": jnp.asarray(rng.standard_normal((32, 50)).astype(np.float32)),
        "f": jnp.asarray(rng.standard_normal((48,)).astype(np.float32))}
out.update({"tree_a": np.asarray(tree["a"]), "tree_c": np.asarray(tree["b"]["c"]),
            "tree_d": np.asarray(tree["d"]), "tree_f": np.asarray(tree["f"])})
with jax.set_mesh(mesh):
    specs = jax.tree.map(lambda _: P("pod"), tree)
    for mode in ("cascaded", "dedicated", "cascaded_int8"):
        got = jax.jit(jax.shard_map(
            lambda t: C.tree_sync(t, "pod", mode=mode, mean=True),
            mesh=mesh, in_specs=(specs,), out_specs=specs))(tree)
        out[f"tree_{mode}_a"] = np.asarray(got["a"])
        out[f"tree_{mode}_b.c"] = np.asarray(got["b"]["c"])
        out[f"tree_{mode}_d"] = np.asarray(got["d"])
        out[f"tree_{mode}_f"] = np.asarray(got["f"])
np.savez(OUT, **out)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the port's 8 ranks' outputs)."""
    d = tmp_path_factory.mktemp("collectives")
    ref_path = d / "ref.npz"
    run_subprocess_jax(f"OUT = {str(ref_path)!r}\n" + REF, n_devices=8)
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    ranks = torch_dist.spawn(torch_dist.collectives_rank, 8, d / "ranks",
                             str(ref_path))
    return ref, ranks


def _per_group_rank(ranks, n):
    """One rank's outputs for each group rank 0..n-1 of an n-group (for
    n = 4, each from both groups of the (2, 4) mesh)."""
    return [[r for r in ranks if int(r[f"rank{n}"]) == g] for g in range(n)]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.int32)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("what", ["ag_c", "rs", "ar_c"])
def test_ring_bit_identical_to_reference(runs, what, n):
    """Ring all-gather, reduce-scatter and all-reduce (padded: 15
    elements per rank), the reference's order of adds: same bits."""
    ref, ranks = runs
    for g, group in enumerate(_per_group_rank(ranks, n)):
        assert group, g
        for r in group:
            got, want = r[f"{what}{n}"], ref[f"{what}{n}"][g]
            assert got.shape == want.shape, (what, n, g)
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("n", [4, 8])
def test_dedicated_all_gather_equals_reference(runs, n):
    ref, ranks = runs
    for g, group in enumerate(_per_group_rank(ranks, n)):
        for r in group:
            np.testing.assert_array_equal(r[f"ag_d{n}"], ref[f"ag_d{n}"][g])
            np.testing.assert_array_equal(r[f"ag_d{n}"], r[f"ag_c{n}"])


@pytest.mark.parametrize("n", [4, 8])
def test_dedicated_all_reduce_matches_psum(runs, n):
    """The backend's fused sum against ``psum``: rtol 1e-6, plus 1e-6 of
    the result's max |value| where the summands cancel (gloo adds in
    another order: 1.19e-7 apart on a sum of 0.086 whose summands are
    ~1-2, half an ulp of theirs)."""
    ref, ranks = runs
    for g, group in enumerate(_per_group_rank(ranks, n)):
        for r in group:
            want = ref[f"ar_d{n}"][g]
            np.testing.assert_allclose(r[f"ar_d{n}"], want, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [4, 8])
def test_compressed_ring_matches_reference(runs, n):
    """The int8 ring: rtol 1e-6 of the reference's output, and its mean
    within the reference test's 6 * scale (scale max |x| / 127) of the
    true mean."""
    ref, ranks = runs
    flat = ref[f"flat{n}"]
    scale = float(np.abs(flat).max()) / 127
    mean = flat.astype(np.float64).mean(0)
    for g, group in enumerate(_per_group_rank(ranks, n)):
        for r in group:
            got = r[f"cr{n}"]
            np.testing.assert_allclose(got, ref[f"cr{n}"][g], rtol=1e-6,
                                       atol=1e-6 * float(np.abs(
                                           ref[f"cr{n}"]).max()))
            assert float(np.abs(got / n - mean).max()) < 6 * scale


@pytest.mark.parametrize("mode", ["cascaded", "dedicated", "cascaded_int8"])
def test_tree_sync_matches_reference(runs, mode):
    """`tree_sync` (mean) on the reference test's tree and two leaves that
    take the ring: the ring leaves bit-identical in cascaded mode, every
    leaf rtol 1e-6 of the reference's, and within the reference test's
    bounds of the true mean (1e-5; int8 6 * scale)."""
    ref, ranks = runs
    full = {"a": ref["tree_a"], "b.c": ref["tree_c"], "d": ref["tree_d"],
            "f": ref["tree_f"]}
    for g, group in enumerate(_per_group_rank(ranks, 4)):
        for r in group:
            for name, x in full.items():
                k = x.shape[0] // 4
                want = ref[f"tree_{mode}_{name}"][g * k:(g + 1) * k]
                got = r[f"tree_{mode}_{name}"]
                assert got.shape == want.shape, name
                if mode == "cascaded" and name in ("d", "f"):
                    np.testing.assert_array_equal(_bits(got), _bits(want))
                np.testing.assert_allclose(
                    got, want, rtol=1e-6,
                    atol=1e-6 * float(np.abs(want).max()))
                mean = x.reshape(4, k, *x.shape[1:]).astype(
                    np.float64).mean(0)
                bound = (6 * float(np.abs(x).max()) / 127
                         if mode == "cascaded_int8" else 1e-5)
                assert float(np.abs(got - mean).max()) < bound, name


def test_auto_sync_is_dedicated(runs):
    """`pod_sync_wrap` in "auto" (the reference leaves it to GSPMD) syncs
    as in "dedicated", bit for bit: the gradients equal `tree_sync`'s
    fused mean, the loss and metrics are the mean over the 4 ranks."""
    _, ranks = runs
    for r in ranks:
        for key in ("loss", "m", "a", "b.c", "d", "f"):
            np.testing.assert_array_equal(r[f"wrap_auto_{key}"],
                                          r[f"wrap_dedicated_{key}"])
        for name in ("a", "b.c", "d", "f"):
            np.testing.assert_array_equal(r[f"wrap_auto_{name}"],
                                          r[f"tree_dedicated_{name}"])
        np.testing.assert_allclose(r["wrap_auto_loss"], 2.5, rtol=1e-7)
        np.testing.assert_allclose(r["wrap_auto_m"], 1.5, rtol=1e-7)


def test_comm_log_counts(runs):
    """The cascaded all-reduce of 15 floats over 4 ranks (padded to 16):
    6 hops of 4 floats; the fused one: one op, 2(n-1)/n x 60 bytes."""
    _, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r["log_cascaded"], [6, 6, 6 * 16, 0])
        np.testing.assert_array_equal(r["log_dedicated"], [1, 0, 90, 0])


def test_collective_schedules_rows(runs):
    """The benchmark's wire bytes per device, x (4, 2^17) float32 over 4
    ranks: ring and fused 2(n-1)/n x 512 KiB = 786432; the int8 ring 6
    hops x (32768 int8 + 32 float32 scales) = 197376."""
    _, ranks = runs
    for r in ranks:
        np.testing.assert_array_equal(r["bench_wire"],
                                      [786432, 786432, 197376])
        np.testing.assert_array_equal(r["bench_ops"], [6, 1, 6])
        np.testing.assert_array_equal(r["bench_hops"], [6, 0, 6])
        assert list(r["bench_transport"]) == ["gloo"] * 3


def test_schedules_ask_for_the_card_by_default(monkeypatch):
    """`collective_schedules.run` and its ``__main__`` with no device
    named go to the card and raise where there is none; they never fall
    back to the CPU."""
    from repro_torch.benchmarks import collective_schedules
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collective_schedules.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        collective_schedules.main([])


@pytest.mark.parametrize("cards,backend,shared", [(1, "gloo", True),
                                                  (3, "gloo", True),
                                                  (4, "nccl", False)])
def test_schedules_transport_by_card_count(monkeypatch, cards, backend,
                                           shared):
    """On cards the 4 ranks run NCCL, one card each, where 4 are visible;
    with fewer they share card 0 on gloo (NCCL refuses two ranks on one
    device).  The spawn is recorded, not run."""
    import json

    import torch.multiprocessing as mp

    from repro_torch.benchmarks import collective_schedules
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    seen = {}

    def spawn(fn, args, nprocs):
        seen.update(args=args, nprocs=nprocs)
        with open(args[-1], "w") as f:
            json.dump([{"schedule": "cascaded"}], f)

    monkeypatch.setattr(mp, "spawn", spawn)
    assert collective_schedules.run() == [{"schedule": "cascaded"}]
    world, _, got_backend, device, got_shared, _ = seen["args"]
    assert (world, seen["nprocs"], device) == (4, 4, "cuda")
    assert (got_backend, got_shared) == (backend, shared)


def test_ranks_agree(runs):
    """Every rank of a group ends with the same all-reduced bits."""
    _, ranks = runs
    for key in ("ar_c8", "ar_d8", "cr8"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], ranks[0][key])


def test_placements_on_device_mesh(runs):
    """DTensor placements of filtered specs on a (2, 2, 2) ('pod', 'data',
    'model') DeviceMesh."""
    _, ranks = runs
    from torch.distributed.tensor import Replicate, Shard
    want = [[Replicate(), Shard(1), Shard(1)],
            [Replicate(), Shard(0), Shard(1)],
            [Replicate(), Replicate(), Shard(0)],
            [Replicate(), Replicate(), Replicate()],
            [Shard(2), Replicate(), Replicate()]]
    for r in ranks:
        np.testing.assert_array_equal(r["mesh222_sizes"], [2, 2, 2])
        assert list(r["placements"]) == [repr(w) for w in want]
        assert bool(r["placements_order_error"])


def test_local_batch_cuts_over_pod(runs):
    """`local_batch` on the (2, 4) ('data', 'pod') mesh cuts the batch
    over ('pod', 'data'), 'pod' major, as the reference's batch specs
    do: the rank at pod g and data j (world rank 4j + g) takes row 2g + j
    of tokens and of positions' dim 1."""
    _, ranks = runs
    tokens = np.arange(24).reshape(8, 3)
    positions = np.arange(72).reshape(3, 8, 3)
    for i, r in enumerate(ranks):
        g, j = int(r["rank4"]), i // 4
        row = 2 * g + j
        np.testing.assert_array_equal(r["local_tokens"],
                                      tokens[row:row + 1])
        np.testing.assert_array_equal(r["local_positions"],
                                      positions[:, row:row + 1])
