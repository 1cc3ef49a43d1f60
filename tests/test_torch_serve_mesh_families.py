"""Serving every family on a ('data', 'model') mesh: the port's
``Engine(..., mesh=...)`` for RWKV-6, Zamba2 and Whisper under MLR and
SLR on a (2, 2) mesh, transformers whose q or KV heads do not divide
'model' on a (1, 4) one (the sequence-sharded KV cache: each rank's
partial softmax state over its block of positions, merged across
ranks), RWKV-6 and Zamba2 whose SSM heads do not divide 'model' on a
(1, 4) one (the WKV state cut over its k dim, the SSM state over P:
the reduced 2 heads, and 6 heads at d 96 whose blocks straddle heads),
and the long-context layout (the sequence over ('data',
'model') at batch 1) through the models' own prefill and decode, all
against the reference's unsharded calls.

The reference side runs here: reduced configs in float32 from
``PRNGKey(0)`` params (the head counts of `torch_dist.FAMILY_CASES`
replaced on both sides), attn_impl "chunked", greedy, a float32 cache
(the bf16 cache turns float32 summation-order noise into whole bf16
steps), each decode step's logits recorded.  The port runs in one spawn
of 4 gloo ranks (`torch_dist.serve_families_rank`), the params carried
over with ``convert.params_from_reference``; attn_impl "pallas" (the
kernels' plain versions here) is held against the port's own
one-process engine, as ``test_torch_serve_mesh.py`` holds it.

Bounds: greedy tokens equal; float32 decode logits within 1e-5 of max
|ref| at each step (the largest gap is printed: ``-s``); every decode
step's ``CommLog`` bytes and calls equal to
``serve_policies.decode_comm``.  The spawn's worker time (the slowest
rank's seconds) is printed."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_dist  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.configs import ParallelConfig as RefPCfg  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduce_config as ref_reduce  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.benchmarks.serve_policies import decode_comm  # noqa: E402

CASES = torch_dist.FAMILY_CASES
LONG = torch_dist.LONG_CASES
LOGIT_TOL = 1e-5


class _Float32Cache:
    """The reference's model module with a float32 cache."""

    def __init__(self, model):
        self._model = model

    def __getattr__(self, name):
        return getattr(self._model, name)

    def init_cache(self, *args, **kw):
        return self._model.init_cache(*args, dtype=jnp.float32, **kw)


def _ref_run(cfg, b):
    """The reference's unsharded engine of `cfg` (a float32 cache): the
    tokens of a greedy run of FAM_NEW, each decode step's logits (steps,
    B, V), and the flat params."""
    params = ref_models.get_model(cfg).init(jax.random.PRNGKey(0), cfg)
    eng = RefEngine(cfg, RefPCfg(attn_impl="chunked", remat="none"),
                    RefServeConfig(max_seq=torch_dist.FAM_MAX_SEQ), params)
    eng.model = _Float32Cache(eng.model)
    steps, decode = [], eng.decode_fn

    def recorded(p, t, c):
        c, logits = decode(p, t, c)
        steps.append(np.asarray(logits[:, 0]))
        return c, logits

    eng.decode_fn = recorded
    batch = {k: jnp.asarray(v)
             for k, v in torch_dist.family_batch(cfg, b).items()}
    toks = np.asarray(eng.generate(batch, torch_dist.FAM_NEW))
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(params).items()}
    return (toks, np.stack(steps)), flat


def _ref_cfg(arch, overrides=None):
    cfg = dataclasses.replace(ref_reduce(ref_get_config(arch)),
                              dtype="float32")
    return torch_dist.with_overrides(cfg, overrides or {})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_families")
    want, flat = {}, {}
    for name, arch, ov, _, _ in CASES:
        want[name], params = _ref_run(_ref_cfg(arch, ov), torch_dist.FAM_B)
        flat.update({f"{name}|{k}": v for k, v in params.items()})
    for arch in LONG:
        want[f"long|{arch}"], params = _ref_run(_ref_cfg(arch), 1)
        flat.update({f"long|{arch}|{k}": v for k, v in params.items()})
    np.savez(tmp / "ref.npz", **flat)
    got = torch_dist.spawn(torch_dist.serve_families_rank, 4,
                           tmp / "spawn", str(tmp / "ref.npz"))
    print(f"serve_families spawn: worker time "
          f"{max(float(r['seconds']) for r in got):.2f} s per rank")
    return got, want


def _held(got, key, toks, logits):
    """Every rank's tokens equal `toks`; its decode logits the rows of its
    lanes of `logits` within LOGIT_TOL of max |ref| at each step; returns
    the largest gap over max |ref|."""
    worst = 0.0
    for r in got:
        np.testing.assert_array_equal(r[f"{key}|tokens"], toks)
        want = logits[:, r[f"{key}|rows"]]
        assert r[f"{key}|logits"].shape == want.shape
        gap = np.abs(r[f"{key}|logits"] - want).max(axis=(1, 2))
        scale = np.abs(want).max(axis=(1, 2))
        assert (gap <= LOGIT_TOL * scale).all(), (gap, scale)
        worst = max(worst, float((gap / scale).max()))
    return worst


def _comm_held(got, key, cfg, shape, policy, batch, long_ctx=False):
    """Every decode step of every rank put `decode_comm`'s bytes and
    calls on the wire."""
    want = decode_comm(cfg, dict(zip(("data", "model"), shape)), batch,
                       policy, max_seq=torch_dist.FAM_MAX_SEQ,
                       long_ctx=long_ctx)
    for r in got:
        steps = {tuple(int(x) for x in s) for s in r[f"{key}|comm"]}
        assert steps == {want}, (steps, want)
    return want


def _port_cfg(arch, overrides):
    return torch_dist.with_overrides(torch_dist.serve_cfg(arch), overrides)


@pytest.mark.parametrize("case", [(c[0], p) for c in CASES for p in c[4]],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_sharded_engine_matches_reference(runs, case):
    """Every rank returns the reference's greedy tokens for the whole
    batch; each rank's decode logits equal the reference's rows of its
    lanes within 1e-5 of max |ref|; each decode step's collectives are
    `decode_comm`'s."""
    got, want = runs
    name, policy = case
    _, arch, ov, shape, _ = next(c for c in CASES if c[0] == name)
    worst = _held(got, f"{name}|chunked|{policy}", *want[name])
    wire, calls = _comm_held(got, f"{name}|chunked|{policy}",
                             _port_cfg(arch, ov), shape, policy,
                             torch_dist.FAM_B)
    print(f"{name} {policy} on {shape}: decode logits within {worst:.2e} "
          f"of max |ref|; {wire} B in {calls} calls per step")


@pytest.mark.parametrize("name", [c[0] for c in CASES
                                  if c[1] != "rwkv6-3b"])
def test_sharded_kernel_path_matches_one_process(runs, name):
    """attn_impl "pallas" under MLR (flash-attention in prefill, the
    flash-decode split and combine at each step, across ranks over a
    sequence-sharded cache) against the port's one-process engine on the
    same params and batch: the reference's tokens, logits within 1e-5 of
    max |one process|, `decode_comm`'s collectives."""
    got, want = runs
    _, arch, ov, shape, _ = next(c for c in CASES if c[0] == name)
    one = got[0][f"{name}|pallas|one|logits"]
    np.testing.assert_array_equal(got[0][f"{name}|pallas|one|tokens"],
                                  want[name][0])
    worst = _held(got, f"{name}|pallas|mlr", want[name][0], one)
    _comm_held(got, f"{name}|pallas|mlr", _port_cfg(arch, ov), shape, "mlr",
               torch_dist.FAM_B)
    print(f"{name} pallas on {shape}: decode logits within {worst:.2e} of "
          f"max |one process|")


@pytest.mark.parametrize("arch", LONG)
def test_long_context_layout_matches_reference(runs, arch):
    """Batch 1 with the cache's sequence over ('data', 'model') on a (2, 2)
    mesh: each rank holds a quarter of the positions (the prompt spans
    two ranks' blocks), and prefill and decode through the model's own
    functions give the reference's tokens and logits."""
    got, want = runs
    key = f"long|{arch}"
    cfg = torch_dist.serve_cfg(arch)
    worst = _held(got, key, *want[key])
    for r in got:
        assert r[f"{key}|k_block"][2] == torch_dist.FAM_MAX_SEQ // 4
    _comm_held(got, key, cfg, (2, 2), "mlr", 1, long_ctx=True)
    print(f"{arch} long-context: decode logits within {worst:.2e} of max "
          f"|ref|")


# ----------------------------------------------------------------------------
# no spawn: the layouts
# ----------------------------------------------------------------------------

#: one arch of each family
FAMILY_ARCHS = ("tinyllama-1.1b", "qwen2-vl-72b", "granite-moe-3b-a800m",
                "rwkv6-3b", "zamba2-7b", "whisper-base")


@pytest.mark.parametrize("long_ctx", [False, True])
@pytest.mark.parametrize("size", [2, 4, 16])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_cache_specs_equal_reference(arch, size, long_ctx):
    """Each family's cache_specs at its published size equal the
    reference's for 'model' = `size`: every layout, rwkv6-3b's 40 heads
    over 16 (the WKV state cut over its k dim) included."""
    from repro_torch.configs import ParallelConfig, get_config
    from repro_torch.models import get_model
    cfg = get_config(arch)
    rcfg = ref_get_config(arch)
    want = ref_models.get_model(rcfg).cache_specs(rcfg, RefPCfg(), long_ctx,
                                                  size)
    got = get_model(cfg).cache_specs(cfg, ParallelConfig(), long_ctx, size)
    assert got == {k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch,heads", [("rwkv6-3b", 6), ("zamba2-7b", 6)])
@pytest.mark.parametrize("size", [4, 16])
def test_k_dim_state_layouts_raise(arch, heads, size):
    """SSM heads that do not divide 'model' (6 at d 96): cache_specs give
    the reference's layout, the WKV state cut over its k dim or the SSM
    state over P, and ``Engine`` builds under MLR on a (1, `size`) mesh
    (rank 1 of a fake process group: no collective runs), its blocks of
    the params and of the cache cut as those specs say.  The name is
    kept for the record: until Slice F3d these layouts raised."""
    from repro_torch.configs import ParallelConfig
    from repro_torch.models import get_model
    from repro_torch.serve.engine import Engine, ServeConfig
    ov = {"d_model": 96, "n_ssm_heads": heads}
    cfg, rcfg = _port_cfg(arch, ov), _ref_cfg(arch, ov)
    key = "ssm" if cfg.family == "hybrid" else "wkv"
    want = ref_models.get_model(rcfg).cache_specs(rcfg, RefPCfg(), False,
                                                  size)
    got = get_model(cfg).cache_specs(cfg, ParallelConfig(), False, size)
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got[key] == (None, ("pod", "data"), None, "model", None)
    params = get_model(cfg).init(0, cfg, device="cpu")
    with torch_dist.fake_mesh((1, size), rank=1) as mesh:
        eng = Engine(cfg, ParallelConfig(), ServeConfig(max_seq=16), params,
                     mesh=mesh, device="cpu")
        batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32)}
        _, ctx = eng._mesh_for(batch)
        cache = eng.model.init_cache(cfg, 2, 16, ParallelConfig(),
                                     device="cpu", mesh=ctx)
    shape = get_model(cfg).cache_shapes(cfg, 2, 16)[key]
    assert cache[key].shape == shape[:3] + (shape[3] // size, shape[4])
    if cfg.family == "ssm":
        tm = eng.params["layers"]["tmix"]
        assert tm["w_r"].shape == (cfg.n_layers, 96, 96 // size)
        assert tm["w_o"].shape == (cfg.n_layers, 96 // size, 96)
    else:
        mb = eng.params["layers"]["mamba"]
        assert mb["w_out"].shape == (cfg.n_layers, 192 // size, 96)
        assert mb["w_in"].shape == params["layers"]["mamba"]["w_in"].shape
