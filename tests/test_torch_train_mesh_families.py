"""Every family's sharded train step (``train/step.py`` on a ('data',
'model') mesh) against the reference's unsharded step: granite-moe (its
experts over 'model', ``moe._moe_expert_parallel``, the router's aux loss
over the whole batch), qwen2-vl (M-RoPE positions cut with the batch),
rwkv6 on its heads (2, 2) and with its WKV state cut over k (1, 4),
zamba2 on its SSM heads (2, 2) and with its SSM state cut over P (1, 4),
and whisper-base (encoder and decoder), each with sequence-parallel
residuals on and off (``torch_dist.TRAIN_FAMILY_CASES``).

The reference runs in this process: reduced configs in float32 (the
expert tests' ``ep_cfg`` for granite-moe), ``PRNGKey(0)`` params, attn
"chunked", moe "dense", remat "none", lr 1e-3, two jitted steps on the
whole batch (``torch_dist.train_family_batch``: ``models.make_batch``).  The port takes the
reference's initial state, cut into each rank's shards, on 4 gloo ranks
of one spawn, attn "pallas" (the CUDA kernels' plain versions: flash
forward and backward, WKV6 on the head-cut layout), moe "shard_map".
granite-moe trains one row of 16 tokens per 'data' rank, so each
expert's buffer holds all t x k assignments and nothing is dropped: the
expert-parallel step is then the reference's dense one.

Bounds, those of tests/test_torch_train_pod.py and
tests/test_torch_train_families.py: per step the loss and grad norm rtol
1e-5, lr 1e-7; after two steps m and v within 5e-5 of each leaf's max
|value|, params within 0.05 x the larger learning rate (2e-5), a param
element whose reference gradient is float32 noise in either step (at
most 1e-5 of its leaf's max |g|) left out of the param bound and
printed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist  # noqa: E402
from repro.configs import ParallelConfig as RefPCfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.train import checkpoint as ref_ckpt  # noqa: E402
from repro.train.step import init_state as ref_init_state  # noqa: E402
from repro.train.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch.core import partitioning as part  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.optimizer import AdamWConfig  # noqa: E402

#: the reference's step without remat: the same values as "full" (its
#: recompute changes no number here) in ~60% of the compile time
REF_PCFG = RefPCfg(attn_impl="chunked", moe_impl="dense", remat="none")
CASES = {c[0]: c for c in torch_dist.TRAIN_FAMILY_CASES}
#: a reference gradient element at most this fraction of its leaf's max
#: |g| is float32 noise (tests/test_torch_train_families.py)
NOISE = 1e-5


def _ref_cfg(arch, overrides):
    """The reference's counterpart of ``torch_dist.train_family_cfg``."""
    cfg = dataclasses.replace(ref_reduce(ref_get_config(arch)),
                              dtype="float32")
    if arch == "granite-moe-3b-a800m":
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    return torch_dist.with_overrides(cfg, overrides)


def _flat(state):
    return {k: np.asarray(v) for k, v in ref_ckpt._flatten(state).items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs by case name, the port's 4 ranks')."""
    d = tmp_path_factory.mktemp("train_mesh_families")
    ref, npz = {}, {}
    done = {}
    for name, arch, ov, _, b, s in torch_dist.TRAIN_FAMILY_CASES:
        key = (arch, tuple(sorted(ov.items())), b, s)
        if key not in done:
            cfg = _ref_cfg(arch, ov)
            batch = torch_dist.train_family_batch(cfg, b, s)
            state = ref_init_state(jax.random.PRNGKey(0), cfg)
            init = _flat(state)
            step = jax.jit(ref_make_step(cfg, REF_PCFG,
                                         lr=torch_dist.FAMILY_LR))
            ms, m1 = [], None
            for i in range(2):
                state, m = step(state, jax.tree.map(jnp.asarray, batch))
                ms.append([float(m[k]) for k in ("loss", "grad_norm",
                                                  "lr")])
                if i == 0:
                    m1 = {k: v for k, v in _flat(state).items()
                          if k.startswith(".opt/.m/")}
            done[key] = {"init": init, "metrics": np.array(ms), "m1": m1,
                         "final": _flat(state)}
        ref[name] = done[key]
        for k, v in done[key]["init"].items():
            npz[f"{name}|init{k.replace('/', '~')}"] = v
    np.savez(d / "ref.npz", **npz)
    ranks = torch_dist.spawn(torch_dist.train_families_rank, 4, d / "ranks",
                             str(d / "ref.npz"))
    print(f"train_families_rank: {float(ranks[0]['seconds']):.1f} s of "
          f"rank 0's work")
    return ref, ranks


def _step_grads(m1, final):
    """Each step's clipped gradient by m leaf: from AdamW's m after the
    first step and after the second (m' = b1 m + (1 - b1) g)."""
    b1 = AdamWConfig().b1
    return [{k: v / (1 - b1) for k, v in m1.items()},
            {k: (final[k] - b1 * m1[k]) / (1 - b1) for k in m1}]


@pytest.mark.parametrize("sp", ["sp", "nosp"])
@pytest.mark.parametrize("name", list(CASES))
def test_family_step_matches_reference(runs, name, sp):
    """Two sharded steps of `name`, sequence parallelism `sp`: the loss
    and grad norm rtol 1e-5 and lr 1e-7 each step (every rank the same
    numbers); the assembled params (0.05 x lr, noise elements left out),
    m and v (5e-5 of each leaf's max); every rank holds its shards."""
    refs, ranks = runs
    ref = refs[name]
    key = f"{name}|{sp}"
    got, want = ranks[0][f"{key}|metrics"], ref["metrics"]
    rel = np.abs(got - want) / np.abs(want)
    assert (rel[:, :2] < 1e-5).all(), (got, want)
    assert (rel[:, 2] < 1e-7).all(), (got, want)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{key}|metrics"], got)
    lr_max = float(want[:, 2].max())
    mesh = make_test_mesh(CASES[name][3])
    ref_g = _step_grads(ref["m1"], ref["final"])
    for leaf, w in ref["final"].items():
        tilde = leaf.replace("/", "~")
        spec = ckpt.leaf_spec(leaf, w.shape, mesh)
        local = part.local_shape(w.shape, spec, mesh)
        assert all(r[f"{key}|{tilde}"].shape == local for r in ranks), leaf
        g = part.assemble([torch.from_numpy(r[f"{key}|{tilde}"])
                           for r in ranks], spec, mesh).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, leaf
        if leaf.startswith(".params/"):
            mk = ".opt/.m/" + leaf[len(".params/"):]
            noise = np.zeros(w.shape, bool)
            for step_g in ref_g:
                gr = np.abs(step_g[mk])
                noise |= gr <= NOISE * gr.max()
            diff = np.abs(g - w)
            assert diff[~noise].max(initial=0.0) <= 0.05 * lr_max, leaf
            for j in zip(*np.nonzero(noise & (diff > 0.05 * lr_max))):
                print(f"{key} {leaf}{list(map(int, j))}: param diff "
                      f"{diff[j] / lr_max:.4f} x lr, a noise gradient")
        elif leaf != ".step":
            assert np.abs(g - w).max() <= 5e-5 * np.abs(w).max(), leaf
        else:
            assert int(g) == int(w) == 2


@pytest.mark.parametrize("name", list(CASES))
def test_sequence_parallel_on_and_off_agree(runs, name):
    """The same losses and grad norms with the residual cut over the
    sequence and without, up to float32 summation order (rtol 1e-6)."""
    _, ranks = runs
    np.testing.assert_allclose(ranks[0][f"{name}|sp|metrics"][:, :2],
                               ranks[0][f"{name}|nosp|metrics"][:, :2],
                               rtol=1e-6)


def test_moe_case_drops_nothing():
    """granite-moe's expert buffers on the (2, 2) mesh take every
    assignment: capacity t x k at one row of 16 tokens per 'data' rank."""
    _, arch, ov, shape, b, s = CASES["granite-moe"]
    cfg = torch_dist.train_family_cfg(arch, ov)
    t = (b // shape[0]) * s
    k = cfg.moe.experts_per_token
    assert moe.capacity(t, k, cfg.moe.n_experts,
                        cfg.moe.capacity_factor) == t * k
