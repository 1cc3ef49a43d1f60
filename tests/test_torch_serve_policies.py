"""The port's ``benchmarks/serve_policies.py`` on the CPU: 4 gloo ranks of
a (2, 2) ('data', 'model') mesh serve reduced tinyllama-1.1b (bf16) under
MLR and SLR, and each row's bytes per decoded token and calls per decode
step equal a hand count written out here from the shapes (never read back
from the ``CommLog``).  The module's own schedule, `decode_comm`, is held
to the same hand counts for reduced tinyllama-1.1b and granite-moe-3b-a800m
(a tied head and the expert-parallel FFN), which ``chip_smoke.py`` uses at
full width, and for rwkv6-3b at its published width on a (1, 16) mesh
(the WKV state cut over its k dim).  The reference's rows (jax 0.9.0,
CPU, the same mesh) count another quantity, its compiled program's
collectives, so they are not compared."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import run as bench_run  # noqa: E402
from repro_torch.benchmarks import serve_policies  # noqa: E402
from repro_torch.configs import get_config, reduce_config  # noqa: E402

D, M = 2, 2                    # the mesh's 'data' and 'model' sizes


def hand_count(cfg, policy: str, batch: int) -> tuple[int, int]:
    """(bytes, calls) one rank sends in one decode step on the (2, 2) mesh,
    every collective over an axis of 2 ranks: an all-gather sends its
    input once, an all-reduce (2(n-1)/n) its bytes once.  bf16 weights
    and activations (2 bytes), float32 router, sums and logits, int32
    token ids."""
    a, f32 = 2, 4
    d, hd, V, L = cfg.d_model, cfg.resolved_head_dim, cfg.vocab_size, \
        cfg.n_layers
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    moe = cfg.family == "moe"
    if policy == "mlr":            # batch over 'data'; weights over 'model'
        bl, tp = batch // D, M
    else:                          # batch over 'data' x 'model'
        bl, tp = batch // (D * M), 1
    # embedding: ids over 'data', then the feature blocks (d cut over
    # ('data', 'model') under MLR, 'data' under SLR): all requests of the
    # rank's 'data' group, gathered over the feature axes minor first
    rows = bl * D
    if policy == "mlr":
        emb = [bl * 4, rows * d // (D * M) * a, rows * d // D * a]
    else:
        emb = [bl * 4, rows * d // D * a]
    # each layer: every weight gathered over 'data' (its d dim halved),
    # this rank's 'model' block of it under MLR
    layer = [d // D * q // tp * a, d // D * kv // tp * a,
             d // D * kv // tp * a, q // tp * d // D * a]
    if moe:
        e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
        el = e // M if policy == "mlr" else e
        layer += [d // D * e * f32,                     # router, float32
                  el * d // D * fe * a, el * d // D * fe * a,
                  el * fe * d // D * a]
    else:
        f = cfg.d_ff
        layer += [d // D * f // tp * a] * 2 + [f // tp * d // D * a]
    if policy == "mlr":
        layer.append(bl * d * f32)                      # after wo
        if not moe:
            layer.append(bl * d * f32)                  # after w_down
    if moe:
        if policy == "slr":
            layer.append(bl * d * a)     # rows onto the 'data' block
        layer.append(batch // D * d * f32)              # experts' sum
    if cfg.tie_embeddings:
        # hidden rows over the feature cut's batch axis ('data'), the
        # partial logits of all of them summed over the feature axes
        head = [bl * d * a] + [rows * V * f32] * (2 if policy == "mlr"
                                                  else 1)
    elif policy == "mlr":
        head = [d // D * V // M * a, bl * V // M * f32]
    else:
        head = [d // D * V * a]
    calls = len(emb) + L * len(layer) + len(head)
    return sum(emb) + L * sum(layer) + sum(head), calls


@pytest.fixture(scope="module")
def rows():
    return serve_policies.run("cpu")


def test_rows_equal_the_hand_count(rows):
    cfg = reduce_config(get_config(serve_policies.ARCH))
    assert [r["policy"] for r in rows] == ["mlr", "slr"]
    for r in rows:
        wire, calls = hand_count(cfg, r["policy"], serve_policies.BATCH)
        assert r["batch_shards"] == (2 if r["policy"] == "mlr" else 4)
        assert r["collective_bytes_per_tok"] == wire / serve_policies.BATCH
        assert r["collective_ops"] == calls
        assert r["transport"] == "gloo" and r["staged_bytes_per_step"] == 0
    # MLR: a rank gathers its 'model' block of each weight, SLR all of it
    assert rows[0]["collective_bytes_per_tok"] < \
        rows[1]["collective_bytes_per_tok"]
    text = serve_policies.format_rows(rows)
    assert text[0] == serve_policies.HEADER
    assert text[1].startswith("mlr,2,6.498e+03,23,")
    assert "# transport: gloo" in text and text[-1].endswith(", 2 layers")


@pytest.mark.parametrize("policy", ["mlr", "slr"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "granite-moe-3b-a800m"])
@pytest.mark.parametrize("batch", [8, 4])
def test_decode_comm_equals_the_hand_count(arch, policy, batch):
    """The schedule `decode_comm` writes out (which ``chip_smoke.py`` holds
    the card's CommLog to at full width) against the hand count."""
    cfg = reduce_config(get_config(arch))
    sizes = {"data": D, "model": M}
    assert serve_policies.decode_comm(cfg, sizes, batch, policy) == \
        hand_count(cfg, policy, batch)
    f32 = dataclasses.replace(cfg, dtype="float32")
    assert serve_policies.decode_comm(f32, sizes, batch, policy)[0] > \
        hand_count(cfg, policy, batch)[0]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("layers", [2, 32])
def test_decode_comm_rwkv_k_cut_at_the_published_size(layers, dtype):
    """rwkv6-3b at full width (d 2560, 40 heads of 64: 160 columns per
    rank straddle heads, so the WKV state is cut over its k dim, 4 rows
    of every head per rank) on a (1, 16) mesh under MLR, a batch of 8:
    the schedule ``chip_smoke.py``'s `serve_kdim` holds the card's
    CommLog to (2 layers), and the published depth, against a hand
    count.  No 'data' axis, so no FSDP gather; the batch is whole on
    every rank.  All-gathers over 16 send 15 x their input, all-reduces
    2 x 15 / 16 x their bytes."""
    cfg = dataclasses.replace(get_config("rwkv6-3b"), n_layers=layers,
                              dtype=dtype)
    m, b, d, f32 = 16, 8, 2560, 4
    a = 2 if dtype == "bfloat16" else 4
    gather = lambda nbytes: (m - 1) * nbytes  # noqa: E731
    reduce = lambda nbytes: 2 * (m - 1) * nbytes // m  # noqa: E731
    emb = [gather(b * d // m * a)]          # the feature blocks
    layer = [gather(b * 3 * d // m * a),    # r, k, v whole, one gather
             reduce(b * d * f32),           # the k rows' partial y
             reduce(b * d * f32),           # w_o, row-parallel
             reduce(b * d * f32),           # cmix.w_v, row-parallel
             gather(b * d // m * a)]        # cmix's receptance
    head = [gather(b * 65536 // m * f32)]   # the logits' vocab blocks
    want = (sum(emb) + layers * sum(layer) + sum(head),
            len(emb) + layers * len(layer) + len(head))
    got = serve_policies.decode_comm(cfg, {"data": 1, "model": m}, b, "mlr")
    assert got == want
    if (layers, dtype) == (2, "bfloat16"):
        assert want == (3233280, 12)


def test_in_the_ports_benches():
    """The reference lists serve_policies in its runner
    (benchmarks/run.py:32); so does the port."""
    assert "repro_torch.benchmarks.serve_policies" in bench_run.BENCHES


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-7b"])
def test_host_params_are_the_engines_cast_of_init(arch):
    """`host_params` draws a leaf at a time from one generator in sorted
    order, as ``init_from_shapes`` does for the whole tree, and keeps each
    leaf in the dtype the engine casts it to: the same numbers as the
    model's init cast by ``cast_weights``, in its dtypes."""
    from repro_torch.models import common as cm
    from repro_torch.models import get_model
    cfg = reduce_config(get_config(arch))
    want = cm.flatten_paths(cm.cast_weights(
        get_model(cfg).init(0, cfg, device="cpu"), cfg))
    got = cm.flatten_paths(serve_policies.host_params(cfg,
                                                      torch.device("cpu")))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


def test_host_params_keeps_a_block():
    """With `block`, each leaf is cut as it is drawn: a rank's blocks of
    reduced rwkv6-3b on a (1, 4) mesh under MLR, the same numbers as the
    blocks of the whole tree (what ``Engine(..., local=True)`` takes)."""
    from repro_torch.core import partitioning as part
    from repro_torch.core.comm import MeshShape
    from repro_torch.models import common as cm
    from repro_torch.serve.engine import param_specs
    cfg = reduce_config(get_config("rwkv6-3b"))
    mesh, coord = MeshShape(("data", "model"), (1, 4)), {"data": 0,
                                                          "model": 3}
    specs = cm.flatten_paths(param_specs(cfg, "mlr", mesh))
    got = cm.flatten_paths(serve_policies.host_params(
        cfg, torch.device("cpu"), block=lambda path, leaf: part.local_shard(
            leaf, specs[path], mesh, coord)))
    whole = cm.flatten_paths(serve_policies.host_params(cfg,
                                                        torch.device("cpu")))
    for k, w in whole.items():
        assert torch.equal(got[k], part.local_shard(w, specs[k], mesh,
                                                    coord)), k
    assert got["layers.tmix.w_r"].shape[-1] * 4 == cfg.d_model
