"""The sharded train step on a ('data', 'model') and a ('pod', 'data',
'model') mesh (``train/step.py``: FSDP with ZeRO-3 AdamW over 'data',
tensor parallelism over 'model' with autograd through the collectives,
sequence-parallel residuals, the vocab-parallel loss) against the
reference's own sharded step, and the elastic restore of a checkpoint
saved from the (2, 2) mesh onto (4, 1) and (1, 4).

The reference runs as tests/test_collectives.py:99-133 runs it: a
subprocess with 4 forced host devices, reduced tinyllama-1.1b (float32
here), ``PRNGKey(0)`` params and the ``PRNGKey(1)`` tokens (B 8 x S 32),
lr 1e-3, two steps of ``jax.jit(make_train_step(cfg, pcfg, mesh))`` on
each mesh of ``torch_dist.MESH_CASES``: (2, 2) with sequence parallelism
under ``sp_boundary`` "op" and "layer" and without it, (2, 1, 2) in
"cascaded" and "dedicated".  The port takes the reference's initial
state, cut into each rank's shards (``step.shard_state``), on 4 gloo
ranks of one spawn, each rank its share of the batch over ('pod',
'data') (``collectives.local_batch``); the ranks' shards are assembled
here (``partitioning.assemble``, which also holds ranks that share a
block to the same bits).

Bounds, those of tests/test_torch_train_pod.py: per step the loss and
grad norm rtol 1e-5, lr 1e-7; after two steps m and v within 5e-5 of
each leaf's max |value|, params within 0.05 x the larger learning rate
of the two steps (the schedule's warmup: 2e-5)."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess_jax  # noqa: E402

import torch_dist  # noqa: E402
from repro_torch.core import partitioning as part  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

REF = r'''
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_config, reduce_config, ParallelConfig
from repro.core import partitioning as part
from repro.train import checkpoint as ckpt
from repro.train.step import init_state, make_train_step, state_specs

cfg = dataclasses.replace(reduce_config(get_config("tinyllama-1.1b")),
                          dtype="float32")
tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, 64)
batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)}
out = {"tokens": np.asarray(batch["tokens"]),
       "labels": np.asarray(batch["labels"])}
init = init_state(jax.random.PRNGKey(0), cfg)
for k, v in ckpt._flatten(init).items():
    out["init" + k.replace("/", "~")] = np.asarray(v)
for label, shape, axes, sp, bound, sync in CASES:
    mesh = jax.make_mesh(shape, axes, axis_types=(AxisType.Auto,) * len(axes))
    pcfg = ParallelConfig(moe_impl="dense", remat="full", cross_pod_sync=sync,
                          seq_shard_activations=sp, sp_boundary=bound)
    with jax.set_mesh(mesh):
        sspec = state_specs(jax.eval_shape(lambda: init), mesh)
        state = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), init, sspec)
        bs = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), batch, part.batch_specs(batch, mesh))
        step = jax.jit(make_train_step(cfg, pcfg, mesh=mesh, lr=LR))
        ms = []
        for _ in range(2):
            state, m = step(state, bs)
            ms.append([float(m[k]) for k in ("loss", "grad_norm", "lr")])
    out[f"{label}|metrics"] = np.array(ms)
    for k, v in ckpt._flatten(state).items():
        out[f"{label}|{k.replace('/', '~')}"] = np.asarray(v)
np.savez(OUT, **out)
'''

LABELS = [c[0] for c in torch_dist.MESH_CASES]
SHAPES = {c[0]: (c[1], c[2]) for c in torch_dist.MESH_CASES}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the port's 4 ranks' outputs, the
    checkpoint directory the ranks saved into)."""
    d = tmp_path_factory.mktemp("train_mesh")
    ref_path = d / "ref.npz"
    run_subprocess_jax(f"OUT = {str(ref_path)!r}\n"
                       f"CASES = {torch_dist.MESH_CASES!r}\n"
                       f"LR = {torch_dist.MESH_LR!r}\n" + REF, n_devices=4)
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    ranks = torch_dist.spawn(torch_dist.train_mesh_rank, 4, d / "ranks",
                             str(ref_path), str(d / "ckpt"))
    return ref, ranks, d / "ckpt"


def _names(ref, label):
    return sorted(k[len(label) + 1:] for k in ref
                  if k.startswith(f"{label}|.") and "|m1|" not in k)


def _assembled(ranks, key, name, whole, mesh):
    """The whole leaf `name` (its full shape `whole`) from the ranks'
    shards under `key`, cut by its spec on `mesh`."""
    spec = ckpt.leaf_spec(name.replace("~", "/"), whole, mesh)
    return part.assemble([torch.from_numpy(np.asarray(r[f"{key}|{name}"]))
                          for r in ranks], spec, mesh).numpy()


@pytest.mark.parametrize("label", LABELS)
def test_sharded_step_matches_reference(runs, label):
    """Two steps on the mesh of `label`: the loss and grad norm (the
    clip's norm of the sharded gradients) each step rtol 1e-5, lr 1e-7;
    the assembled params 0.05 x lr, m and v 5e-5 of each leaf's max."""
    ref, ranks, _ = runs
    got, want = ranks[0][f"{label}|metrics"], ref[f"{label}|metrics"]
    rel = np.abs(got - want) / np.abs(want)
    assert (rel[:, :2] < 1e-5).all(), (got, want)
    assert (rel[:, 2] < 1e-7).all(), (got, want)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{label}|metrics"], got)
    lr_max = float(want[:, 2].max())
    mesh = make_test_mesh(*SHAPES[label])
    names = _names(ref, label)
    assert names and set(names) == set(_names(ranks[0], label))
    for name in names:
        w = ref[f"{label}|{name}"]
        g = _assembled(ranks, label, name, w.shape, mesh)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name.startswith(".params"):
            assert np.abs(g - w).max() <= 0.05 * lr_max, name
        elif name != ".step":
            assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max(), name
        else:
            assert int(g) == int(w) == 2


@pytest.mark.parametrize("label", LABELS)
def test_ranks_hold_only_their_shards(runs, label):
    """ZeRO-3: every rank's params, m and v are its blocks under the
    param rules, 1/'data' of each leaf cut over 'data' (the embedding's
    features, cut over ('data', 'model'), 1/4 on (2, 2)); a replicated
    leaf is whole."""
    from repro_torch.models.common import entry_axes
    ref, ranks, _ = runs
    mesh = make_test_mesh(*SHAPES[label])
    sizes = part.axis_sizes(mesh)
    cut = 0
    for name in _names(ref, label):
        whole = ref[f"{label}|{name}"].shape
        spec = ckpt.leaf_spec(name.replace("~", "/"), whole, mesh)
        want = part.local_shape(whole, spec, mesh)
        for r in ranks:
            assert r[f"{label}|{name}"].shape == want, (name, spec)
        for d, entry in enumerate(spec):
            axes = entry_axes(entry)
            if "data" in axes:
                cut += 1
                n = int(np.prod([sizes[a] for a in axes]))
                assert want[d] * n == whole[d] and n >= sizes["data"]
    assert cut > 0 or sizes.get("data", 1) == 1


@pytest.mark.parametrize("label", LABELS)
def test_commlog_equals_the_count_from_the_shapes(runs, label):
    """Every rank's CommLog over the two steps: calls and wire bytes equal
    to twice ``collective_schedules.train_step_comm`` (the 'pod' sync
    is not logged there)."""
    from repro_torch.benchmarks.collective_schedules import train_step_comm
    from repro_torch.configs import ParallelConfig
    _, ranks, _ = runs
    _, shape, axes, sp, bound, _ = next(c for c in torch_dist.MESH_CASES
                                        if c[0] == label)
    want = train_step_comm(torch_dist.pod_cfg(), ParallelConfig(
        seq_shard_activations=sp, sp_boundary=bound),
        dict(zip(axes, shape)), 8, 32)
    for r in ranks:
        assert list(r[f"{label}|comm"]) == [2 * want["ops"],
                                            2 * want["wire_bytes"]]


@pytest.mark.parametrize("label", [c[0] for c in torch_dist.COMM_CASES])
def test_commlog_count_follows_dtype_and_tied_head(runs, label):
    """One step of reduced tinyllama-1.1b in bfloat16 and of qwen3-0.6b,
    whose tied head is cut over 'model' by vocab (the table gathered over
    its feature axes, no full-vocab logits): every rank's calls and wire
    bytes equal ``collective_schedules.train_step_comm``."""
    from repro_torch.benchmarks.collective_schedules import train_step_comm
    from repro_torch.configs import ParallelConfig, get_config, reduce_config
    _, ranks, _ = runs
    _, arch, dtype = next(c for c in torch_dist.COMM_CASES if c[0] == label)
    cfg = dataclasses.replace(reduce_config(get_config(arch)), dtype=dtype)
    want = train_step_comm(cfg, ParallelConfig(remat="full"),
                           {"data": 2, "model": 2}, 8, 32)
    for r in ranks:
        assert list(r[f"{label}|comm"]) == [want["ops"], want["wire_bytes"]]


def test_sharded_global_norm_counts_each_block_once(runs):
    """The sharded tree's global norm (each leaf's squares summed over the
    axes that cut it, replicated leaves once) equals the whole tree's."""
    _, ranks, _ = runs
    for r in ranks:
        assert abs(float(r["norm_sharded"]) - float(r["norm_whole"])) \
            <= 1e-6 * float(r["norm_whole"])


def test_sp_and_schedules_agree(runs):
    """Sequence parallelism on ("op", "layer") and off give the same
    losses up to float32 summation order (rtol 1e-6)."""
    _, ranks, _ = runs
    base = ranks[0]["nosp|metrics"][:, 0]
    for label in ("sp", "layer", "pod_cascaded", "pod_dedicated"):
        np.testing.assert_allclose(ranks[0][f"{label}|metrics"][:, 0], base,
                                   rtol=1e-6)


@pytest.mark.parametrize("shape", torch_dist.RESTORE_SHAPES)
def test_elastic_restore_across_meshes(runs, shape):
    """The checkpoint saved from the (2, 2) mesh holds the assembled
    state's full logical arrays (rank 0 wrote them), and restores onto
    (4, 1) and (1, 4) with identical logical values."""
    _, ranks, d = runs
    step = ckpt.latest_step(str(d))
    assert step == 2
    mesh22 = make_test_mesh((2, 2))
    mesh = make_test_mesh(shape)
    key = f"restore{shape[0]}x{shape[1]}"
    with open(d / f"step_{step:08d}" / "manifest.json") as f:
        manifest = json.load(f)
    for name, meta in manifest["leaves"].items():
        disk = np.load(d / f"step_{step:08d}" / meta["file"])
        tilde = name.replace("/", "~")
        np.testing.assert_array_equal(
            _assembled(ranks, "sp", tilde, disk.shape, mesh22), disk,
            err_msg=name)
        np.testing.assert_array_equal(
            _assembled(ranks, key, tilde, disk.shape, mesh), disk,
            err_msg=name)


def test_launcher_sharded_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train
    --distributed --layout sharded --model-size 2 --device cpu
    --smoke``: 4 gloo ranks train reduced tinyllama-1.1b on a (2, 2)
    ('data', 'model') mesh; rank 0 alone logs, and its bytes and calls
    per step (bfloat16) equal ``collective_schedules.train_step_comm``."""
    import os
    import pathlib
    import re
    import subprocess
    import sys

    from repro_torch.benchmarks.collective_schedules import train_step_comm
    from repro_torch.configs import get_config, reduce_config
    from repro_torch.launch.train import PCFG
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--distributed", "--layout", "sharded", "--model-size", "2",
           "--arch", "tinyllama-1.1b", "--smoke", "--device", "cpu",
           "--steps", "2", "--batch", "8", "--seq", "16"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("ranks=4 mesh={'data': 2, 'model': 2}") == 1, \
        r.stdout
    assert r.stdout.count("final loss") == 1
    got = re.search(r"per rank per step: (\d+) B on the wire, \d+ B "
                    r"staged, (\d+) calls", r.stdout)
    want = train_step_comm(reduce_config(get_config("tinyllama-1.1b")),
                           dataclasses.replace(PCFG, moe_impl="shard_map"),
                           {"data": 2, "model": 2}, 8, 16)
    assert got and [int(got[1]), int(got[2])] == [want["wire_bytes"],
                                                  want["ops"]], r.stdout


def test_launcher_mesh_rule():
    """The reference launcher's 'model': the largest of 16, 8, 4, 2, 1
    dividing the ranks and the heads (src/repro/launch/train.py:57-66)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import model_size
    cfg = get_config("tinyllama-1.1b")            # 32 heads
    assert [model_size(w, cfg) for w in (1, 2, 4, 6, 8, 16, 32, 48)] == \
        [1, 2, 4, 2, 8, 16, 16, 16]
    assert model_size(4, torch_dist.pod_cfg()) == 4   # the reduced 4 heads
