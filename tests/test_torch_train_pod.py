"""The data-parallel train step over a ('pod',) mesh (``train/step.py``
with ``core/collectives.pod_sync_wrap``) against the reference's, and the
launcher's ``--distributed`` under ``torchrun``.

The reference runs as its own tests run it: a subprocess with 4 forced
host devices, its ``make_train_step`` on a ('pod',) mesh of 4, reduced
tinyllama-1.1b in float32, ``PRNGKey(0)`` params and the ``PRNGKey(1)``
tokens of tests/test_collectives.py:99 (B 8 x S 32), lr 1e-3, two steps
in each of "auto" (GSPMD's reduction), "cascaded", "dedicated" and
"cascaded" + int8.  The port takes the reference's initial state
(``convert.state_from_reference``) on 4 gloo ranks of one spawn, each
rank its quarter of the batch (``collectives.local_batch``).

Bounds, those of tests/test_torch_train.py: per step the loss and grad
norm rtol 1e-5; after two steps m and v within 5e-5 of each leaf's max,
params within 0.05 x the largest learning rate the two steps took (the
schedule's warmup: 1e-5 and 2e-5); every rank's state the same bits;
each mode's losses within 2e-3 of "auto" (the reference's own bound,
tests/test_collectives.py:130)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import run_subprocess_jax  # noqa: E402

import torch_dist  # noqa: E402
from repro_torch.configs import ParallelConfig  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]

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
mesh = jax.make_mesh((4,), ("pod",), axis_types=(AxisType.Auto,))
tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 32), 0, 64)
batch = {"tokens": tokens, "labels": jnp.roll(tokens, -1, 1)}
out = {"tokens": np.asarray(batch["tokens"]),
       "labels": np.asarray(batch["labels"])}
init = init_state(jax.random.PRNGKey(0), cfg)
for k, v in ckpt._flatten(init).items():
    out["init" + k.replace("/", "~")] = np.asarray(v)
for label, sync, comp in MODES:
    pcfg = ParallelConfig(moe_impl="dense", remat="full", cross_pod_sync=sync,
                          grad_compression=comp)
    with jax.set_mesh(mesh):
        sspec = state_specs(jax.eval_shape(lambda: init), mesh)
        state = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), init, sspec)
        bs = jax.tree.map(lambda x, s: jax.device_put(
            x, NamedSharding(mesh, s)), batch, part.batch_specs(batch, mesh))
        step = jax.jit(make_train_step(cfg, pcfg, mesh=mesh, lr=LR))
        losses, gnorms, lrs = [], [], []
        for _ in range(2):
            state, m = step(state, bs)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
    out[f"{label}_loss"] = np.array(losses)
    out[f"{label}_gnorm"] = np.array(gnorms)
    out[f"{label}_lr"] = np.array(lrs)
    for k, v in ckpt._flatten(state).items():
        out[f"{label}|{k.replace('/', '~')}"] = np.asarray(v)
np.savez(OUT, **out)
'''

LABELS = [m[0] for m in torch_dist.POD_MODES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the port's 4 ranks' outputs)."""
    d = tmp_path_factory.mktemp("train_pod")
    ref_path = d / "ref.npz"
    run_subprocess_jax(f"OUT = {str(ref_path)!r}\n"
                       f"MODES = {torch_dist.POD_MODES!r}\n"
                       f"LR = {torch_dist.POD_LR!r}\n" + REF, n_devices=4)
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    ranks = torch_dist.spawn(torch_dist.train_pod_rank, 4, d / "ranks",
                             str(ref_path))
    return ref, ranks


def _rel(got, want):
    return np.abs(np.asarray(got) - want) / np.abs(want)


@pytest.mark.parametrize("label", LABELS)
def test_pod_train_step_matches_reference(runs, label):
    ref, ranks = runs
    got = ranks[0]
    assert (_rel(got[f"{label}_loss"], ref[f"{label}_loss"]) < 1e-5).all()
    assert (_rel(got[f"{label}_gnorm"], ref[f"{label}_gnorm"]) < 1e-5).all()
    assert (_rel(got[f"{label}_lr"], ref[f"{label}_lr"]) < 1e-7).all()
    lr_max = float(ref[f"{label}_lr"].max())
    names = [k for k in ref if k.startswith(f"{label}|")]
    assert names and set(names) == {k for k in got
                                    if k.startswith(f"{label}|")}
    for name in names:
        g, w = got[name], ref[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if "|.params~" in name:
            assert np.abs(g - w).max() <= 0.05 * lr_max, name
        elif not name.endswith("|.step"):
            assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max(), name
        else:
            assert int(g) == int(w) == 2


@pytest.mark.parametrize("label", ["cascaded", "dedicated", "int8"])
def test_modes_within_reference_bound_of_auto(runs, label):
    ref, ranks = runs
    for side in (ref, ranks[0]):
        assert np.abs(side[f"{label}_loss"] - side["auto_loss"]).max() < 2e-3
    # the float32 ring and the fused sum agree far closer than that
    if label != "int8":
        assert (_rel(ranks[0][f"{label}_loss"],
                     ranks[0]["auto_loss"]) < 1e-6).all()


def test_ranks_hold_the_same_state(runs):
    """Every rank makes the same update: params, m and v equal bit for bit
    across the ranks, each rank on its own quarter of the batch."""
    _, ranks = runs
    for i, r in enumerate(ranks):
        np.testing.assert_array_equal(r["local_tokens"],
                                      runs[0]["tokens"][2 * i:2 * i + 2])
        for k, v in ranks[0].items():
            if "|" in k or k.endswith("_loss") or k.endswith("_gnorm"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)


def test_mesh_with_data_or_model_axis_raises():
    """A mesh with 'data' or 'model' > 1 takes the sharded step: without a
    process group (a `MeshShape`) it raises the error of
    `test_pod_mesh_without_process_group_raises`; on a process group
    (one rank of torch's fake backend) it builds, its batch cut over the
    ('pod', 'data') axes of size > 1."""
    cfg = torch_dist.pod_cfg()
    for shape, axes in (((2, 2), ("data", "model")),
                        ((2, 4), ("pod", "data")),
                        ((2, 1, 2), ("pod", "data", "model"))):
        with pytest.raises(ValueError, match="no process group"):
            make_train_step(cfg, ParallelConfig(),
                            mesh=mesh_mod.make_test_mesh(shape, axes))
        with torch_dist.fake_mesh(shape, 0, axes) as mesh:
            step = make_train_step(cfg, ParallelConfig(), mesh=mesh)
            assert step.ctx.sizes == dict(zip(axes, shape))
            assert step.ctx.batch_axes == tuple(
                a for a, n in zip(axes, shape) if a != "model" and n > 1)


def test_pod_mesh_without_process_group_raises():
    """A 'pod' axis of size > 1 needs ranks: a `MeshShape` has none."""
    with pytest.raises(ValueError, match="no process group"):
        make_train_step(torch_dist.pod_cfg(), ParallelConfig(),
                        mesh=mesh_mod.make_test_mesh((4,), ("pod",)))


def test_pod_mesh_of_one_is_the_single_device_step():
    """'pod' of size 1 (and 'data'/'model' of 1): no sync, the plain
    step, bit for bit."""
    from repro_torch.train.step import init_state
    cfg = torch_dist.pod_cfg()
    state = init_state(0, cfg, device="cpu")
    rng = np.random.default_rng(0)
    tok = rng.integers(0, cfg.vocab_size, (2, 16), dtype=np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
    pcfg = ParallelConfig(moe_impl="dense")
    _, m1 = make_train_step(cfg, pcfg)(state, batch)
    _, m2 = make_train_step(cfg, pcfg, mesh=mesh_mod.make_test_mesh(
        (1, 1, 1), ("pod", "data", "model")))(state, batch)
    assert float(m1["loss"]) == float(m2["loss"])
    assert float(m1["grad_norm"]) == float(m2["grad_norm"])


@pytest.mark.parametrize("sync,comp", [("cascaded", "none"),
                                       ("auto", "int8")])
def test_launcher_distributed_under_torchrun(tmp_path, sync, comp):
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.train
    --distributed --device cpu --smoke``: 4 gloo ranks train reduced
    tinyllama-1.1b; rank 0 alone logs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
           "--distributed", "--arch", "tinyllama-1.1b", "--smoke",
           "--device", "cpu", "--steps", "2", "--batch", "8", "--seq", "16",
           "--cross-pod-sync", sync, "--grad-compression", comp]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("ranks=4") == 1, r.stdout
    assert f"cross_pod_sync={sync}" in r.stdout
    assert r.stdout.count("final loss") == 1
