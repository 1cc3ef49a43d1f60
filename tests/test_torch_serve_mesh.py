"""Serving on a (2, 2) ('data', 'model') mesh: the port's
``Engine(..., mesh=...)`` under MLR and SLR against the reference's
unsharded ``Engine``, and the port's expert-parallel MoE against the
reference's own ``_moe_shard_map``.

The reference side runs here: reduced tinyllama-1.1b, granite-moe-3b-a800m
and qwen2-vl-72b in float32 from ``PRNGKey(0)`` params, attn_impl
"chunked", greedy, with each decode step's logits recorded, and a
float32 KV cache in place of the bf16 one (on both sides: the bf16
cache turns float32 summation-order noise into whole bf16 steps, ~2e-4
of max |logit| where one lands); its
expert-parallel block runs in one ``run_subprocess_jax`` call with 2
host devices on a (1, 2) mesh.  The port runs in one spawn of 4 gloo ranks
(`torch_dist.serve_mesh_rank`), the params carried over with
``convert.params_from_reference``, attn_impl "chunked" and moe_impl
"shard_map" (experts over 'model').  The path the card runs, attn_impl
"pallas" (the kernels' plain versions here), is held the same way
against the port's own one-process engine: its attention skips the
reference's bf16 rounding of the probabilities before the product with
V, so it sits ~3e-3 of max |logit| from the reference's chunked path
with or without a mesh (``tests/test_torch_{flash,decode}_attention.py``
hold the kernels themselves to the reference's).

Bounds: greedy tokens equal; float32 decode logits within 1e-5 of max
|ref| at each step (the largest gap measured is printed: ``-s``); MLR's
``attn.wq`` shards narrower than the leaf on 'model', SLR's whole; an
EOS run stops at the same step on every rank, the reference's; the kept
(token, expert) assignments of a capacity that drops some equal the
reference's, and the expert block's output within 1e-5 of max |ref|."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import run_subprocess_jax  # noqa: E402

import torch_dist  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.configs import ParallelConfig as RefPCfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import ParallelConfig, get_config  # noqa: E402
from repro_torch.configs import reduce_config  # noqa: E402
from repro_torch.core.comm import MeshShape  # noqa: E402
from repro_torch.models import check_mesh, transformer  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

ARCHS = torch_dist.SERVE_ARCHS
B, NEW = torch_dist.SERVE_B, torch_dist.SERVE_NEW
LOGIT_TOL = 1e-5

EP_REF = r'''
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import ParallelConfig, get_config, reduce_config
from repro.launch import compat
from repro.models.moe import _moe_shard_map

base = dataclasses.replace(reduce_config(get_config("granite-moe-3b-a800m")),
                           dtype="float32")
cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                        capacity_factor=1.0))
z = dict(np.load(IN))
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = {}
with jax.set_mesh(mesh):
    am = compat.get_abstract_mesh()
    fn = jax.jit(lambda x, w, ids, experts: _moe_shard_map(
        x, w, ids, experts, cfg, ParallelConfig(moe_impl="shard_map"), am))
    for kind in ("rand", "probe"):
        experts = {w: jnp.asarray(z[f"ep_{kind}_{w}"])
                   for w in ("w_gate", "w_up", "w_down")}
        out[kind] = np.asarray(fn(jnp.asarray(z["ep_x"]),
                                  jnp.asarray(z["ep_w"]),
                                  jnp.asarray(z["ep_ids"]), experts))
np.savez(OUT, **out)
'''


def _ref_cfg(arch):
    return dataclasses.replace(ref_reduce(ref_get_config(arch)),
                               dtype="float32")


class _Float32Cache:
    """The reference's model module with a float32 cache."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init_cache(self, *args, **kw):
        return self._model.init_cache(*args, dtype=jnp.float32, **kw)


def _ref_serve(arch):
    """The reference's unsharded engine of `arch` (a float32 cache) and a
    greedy run of NEW tokens, ``run(eos_id) -> (tokens, each decode
    step's logits (B, V))``; its flat params.  Every run reuses the
    engine's compiled functions."""
    cfg = _ref_cfg(arch)
    params = ref_models.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    eng = RefEngine(cfg, RefPCfg(attn_impl="chunked", moe_impl="dense",
                                 remat="none"),
                    RefServeConfig(max_seq=torch_dist.SERVE_MAX_SEQ), params)
    eng.model = _Float32Cache(eng.model)
    steps, decode = [], eng.decode_fn

    def recorded(p, t, c):
        c, logits = decode(p, t, c)
        steps.append(np.asarray(logits[:, 0]))
        return c, logits

    eng.decode_fn = recorded
    batch = {k: jnp.asarray(v) for k, v in
             torch_dist.serve_batch(cfg).items()}

    def run(eos=-1):
        steps.clear()
        eng.scfg = dataclasses.replace(eng.scfg, eos_id=eos)
        return np.asarray(eng.generate(batch, NEW)), np.stack(steps)

    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(params).items()}
    return run, flat


def _eos_token(toks):
    """A token that every lane of the first half of the batch (the MLR
    lanes of 'data' rank 0) emits before the last step, at different
    steps, and no lane of the second half emits: some ranks' lanes are
    all done while the others' are not, so a rank that stopped on its
    own lanes would leave the others' next collective hanging.  None
    where there is none."""
    half = toks.shape[0] // 2
    for v in np.unique(toks):
        first = [np.flatnonzero(row == v) for row in toks]
        if all(len(f) for f in first[:half]) and \
                not any(len(f) for f in first[half:]):
            steps = [int(f[0]) for f in first[:half]]
            if max(steps) < toks.shape[1] - 1 and len(set(steps)) > 1:
                return int(v)
    return None


def _ep_inputs(cfg):
    """The expert block's inputs (B 2 x S 32 tokens, top-2 of 8 experts):
    routing skewed so expert 0 takes ~80 of the 128 assignments, over a
    capacity of 32; random float32 experts, and the probe experts under
    which output column e is positive exactly where (token, e) was kept
    (x > 0, gate and up weights positive, expert e's down projection the
    unit column e)."""
    rng = np.random.default_rng(5)
    e, k, d, f = (cfg.moe.n_experts, cfg.moe.experts_per_token, cfg.d_model,
                  cfg.moe.d_ff_expert)
    b, s = 2, 32
    t = b * s
    ids = np.zeros((t, k), np.int32)
    for i in range(t):
        first = 0 if rng.random() < 0.6 else int(rng.integers(1, e))
        second = int(rng.choice([x for x in range(e) if x != first]))
        ids[i] = (first, second)
    down = np.zeros((e, f, d), np.float32)
    for j in range(e):
        down[j, :, j] = 1.0
    return {"ep_x": rng.uniform(0.5, 1.0, (b, s, d)).astype(np.float32),
            "ep_w": rng.uniform(0.1, 1.0, (b, s, k)).astype(np.float32),
            "ep_ids": ids.reshape(b, s, k),
            "ep_rand_w_gate": rng.standard_normal((e, d, f), np.float32) / 8,
            "ep_rand_w_up": rng.standard_normal((e, d, f), np.float32) / 8,
            "ep_rand_w_down": rng.standard_normal((e, f, d), np.float32) / 8,
            "ep_probe_w_gate": np.full((e, d, f), 0.01, np.float32),
            "ep_probe_w_up": np.full((e, d, f), 0.01, np.float32),
            "ep_probe_w_down": down}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_mesh")
    ref, want, runs = {}, {}, {}
    for arch in ARCHS:
        runs[arch], flat = _ref_serve(arch)
        want[arch] = runs[arch]()
        ref.update({f"{arch}|{k}": v for k, v in flat.items()})
    eos = _eos_token(want[ARCHS[0]][0])
    assert eos is not None, "no token ends half the lanes mid-run"
    want["eos"] = runs[ARCHS[0]](eos)
    ep = _ep_inputs(torch_dist.ep_cfg())
    np.savez(tmp / "ep_in.npz", **ep)
    run_subprocess_jax(f"IN = {str(tmp / 'ep_in.npz')!r}\n"
                       f"OUT = {str(tmp / 'ep_ref.npz')!r}\n" + EP_REF,
                       n_devices=2)
    with np.load(tmp / "ep_ref.npz") as z:
        want["ep"] = {k: z[k] for k in z.files}
    np.savez(tmp / "ref.npz", eos=np.asarray(eos), **ref, **ep)
    got = torch_dist.spawn(torch_dist.serve_mesh_rank, 4, tmp / "spawn",
                           str(tmp / "ref.npz"))
    return got, want, eos, ep


def _held(got, toks, logits, key, rows_of=None):
    """Every rank's tokens equal `toks`; its decode logits the rows of its
    lanes of `logits` (or of ``rows_of(rank)``), within LOGIT_TOL of max
    |ref| at each step; returns the largest gap over max |ref|."""
    worst = 0.0
    for j, r in enumerate(got):
        np.testing.assert_array_equal(r[f"{key}|tokens"], toks)
        want = logits[:, r[f"{key}|rows"]] if rows_of is None else \
            rows_of(j, r[f"{key}|rows"])
        assert r[f"{key}|logits"].shape == want.shape
        gap = np.abs(r[f"{key}|logits"] - want).max(axis=(1, 2))
        scale = np.abs(want).max(axis=(1, 2))
        assert (gap <= LOGIT_TOL * scale).all(), (gap, scale)
        worst = max(worst, float((gap / scale).max()))
    return worst


@pytest.mark.parametrize("policy", ["mlr", "slr"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_engine_matches_reference(runs, arch, policy):
    """Every rank returns the reference's greedy tokens for the whole
    batch; each rank's decode logits equal the reference's rows of its
    lanes within 1e-5 of max |ref|."""
    got, want, _, _ = runs
    toks, logits = want[arch]
    worst = _held(got, toks, logits, f"{arch}|chunked|{policy}|-1")
    print(f"{arch} {policy}: decode logits within {worst:.2e} of max |ref|")


@pytest.mark.parametrize("policy", ["mlr", "slr"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_kernel_path_matches_one_process(runs, arch, policy):
    """attn_impl "pallas" (flash-attention on each rank's heads in
    prefill, flash-decode on its KV heads each step) on the mesh against
    the port's one-process engine on the same params and batch: the same
    tokens (the reference's), logits within 1e-5 of max |one process|."""
    got, want, _, _ = runs
    one = f"{arch}|pallas|one|-1"
    np.testing.assert_array_equal(got[0][f"{one}|tokens"], want[arch][0])
    worst = _held(got, want[arch][0], None, f"{arch}|pallas|{policy}|-1",
                  lambda j, rows: got[j][f"{one}|logits"][:, rows])
    print(f"{arch} {policy} pallas: decode logits within {worst:.2e} of "
          f"max |one process|")


@pytest.mark.parametrize("arch", ARCHS)
def test_mlr_shards_wq_over_model_and_slr_does_not(runs, arch):
    """The placement each policy encodes is applied (the reference's
    tests/test_serve.py:106-137): under MLR some rank's ``attn.wq`` is
    narrower than the global leaf on its 'model' dim, under SLR none is."""
    got, _, _, _ = runs
    cfg = reduce_config(get_config(arch))
    cols = cfg.n_heads * cfg.resolved_head_dim
    mlr = [tuple(r[f"{arch}|chunked|mlr|-1|wq"]) for r in got]
    slr = [tuple(r[f"{arch}|chunked|slr|-1|wq"]) for r in got]
    assert any(s[2] < cols for s in mlr)
    assert all(s[2] == cols for s in slr)
    assert all(s == (cfg.n_layers, cfg.d_model // 2, cols // 2) for s in mlr)


@pytest.mark.parametrize("policy", ["mlr", "slr"])
def test_eos_stops_every_rank_at_the_same_step(runs, policy):
    """eos_id set to a token that ends the lanes of half the ranks mid-run
    (under SLR at a different step on each of them) and no lane of the
    others: every rank runs the reference's number of decode steps and
    returns its tokens, EOS-frozen lanes included."""
    got, want, eos, _ = runs
    toks, logits = want["eos"]
    key = f"{ARCHS[0]}|chunked|{policy}|{eos}"
    assert (toks[:B // 2] == eos).any(1).all()
    for r in got:
        np.testing.assert_array_equal(r[f"{key}|tokens"], toks)
        assert int(r[f"{key}|steps"]) == logits.shape[0] == NEW - 1


def test_expert_parallel_matches_reference_shard_map(runs):
    """The expert block on 2 'model' ranks against the reference's
    ``_moe_shard_map`` on a (1, 2) mesh: under a capacity that drops
    assignments, the kept (token, expert) set bit-identical (each rank's
    own plan, and the probe's positive columns on both sides), the
    output within 1e-5 of max |ref|."""
    got, want, _, ep = runs
    ref = want["ep"]
    t, k = ep["ep_ids"].shape[0] * ep["ep_ids"].shape[1], ep["ep_ids"].shape[2]
    ref_kept = {tuple(x) for x in np.argwhere(ref["probe"].reshape(t, -1)
                                              [:, :8] > 0)}
    assert len(ref_kept) < t * k                        # some were dropped
    plan = {tuple(x) for r in got for x in r["ep_kept"]}
    assert plan == ref_kept
    for r in got:
        probe = {tuple(x) for x in np.argwhere(
            r["ep_probe_out"].reshape(t, -1)[:, :8] > 0)}
        assert probe == ref_kept
        scale = np.abs(ref["rand"]).max()
        assert np.abs(r["ep_rand_out"] - ref["rand"]).max() <= 1e-5 * scale
    assert int(got[0]["ep_cap"]) == 32


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b", "whisper-base"])
def test_mesh_refused_for_unported_families(arch):
    """A mesh with 'data' or 'model' > 1 given to a family with no sharded
    path raises, in `check_mesh` and the engine, never runs replicated;
    those families' cache_specs raise too."""
    cfg = reduce_config(get_config(arch))
    mesh = MeshShape(("data", "model"), (2, 2))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        check_mesh(cfg, mesh)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Engine(cfg, ParallelConfig(), ServeConfig(), {}, mesh=mesh,
               device="cpu")
    from repro_torch.models import get_model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model(cfg).cache_specs(cfg, ParallelConfig(), False, 2)
    assert check_mesh(cfg, MeshShape(("pod",), (1,))) is False


def test_heads_that_do_not_divide_and_long_ctx_raise():
    """MLR over a 'model' axis that does not divide the q or KV heads, and
    the reference's long-context cache layout, raise."""
    cfg = dataclasses.replace(reduce_config(get_config("tinyllama-1.1b")),
                              n_heads=6, n_kv_heads=3)
    params = transformer.init(0, cfg, device="cpu")
    for sizes in ((1, 2), (1, 4)):
        mesh = MeshShape(("data", "model"), sizes)
        with pytest.raises(NotImplementedError, match="do not divide"):
            Engine(cfg, ParallelConfig(), ServeConfig(), params, mesh=mesh,
                   device="cpu")
    with pytest.raises(NotImplementedError, match="long-context"):
        transformer.cache_specs(cfg, ParallelConfig(), True, 1)
    rcfg = ref_reduce(ref_get_config("tinyllama-1.1b"))
    want = RT.cache_specs(rcfg, RefPCfg(), False, 2)
    got = transformer.cache_specs(reduce_config(get_config("tinyllama-1.1b")),
                                  ParallelConfig(), False, 2)
    assert got == {k: tuple(v) for k, v in want.items()}
