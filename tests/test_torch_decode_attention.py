"""The port's flash-decode (plain version `ref.decode_attend`, and `ops`
in the model layout on the CPU) against the reference's plain version and
its Pallas kernel in interpret mode, float32, same numpy inputs (head dim
112, zamba2-7b's, among them), with lengths that skip whole chunks: atol
1e-5 (sums in a different order).  On the CPU the port's wrapper runs
the plain version; its CUDA kernels
run only in ``chip_smoke.py``, which holds them against these plain
versions.  The split-KV arithmetic (`ref.split_partials`, whose merge
`ref.combine_splits` follows the combine kernel step for step) is held
against the reference here, and the wrapper's host side — the split
count, the memoised layout checks — is checked without a card."""
import inspect
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import kernel as RK  # noqa: E402
from repro.kernels.decode_attention import ops as RO  # noqa: E402
from repro.kernels.decode_attention import ref as RR  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as PK  # noqa: E402
from repro_torch.kernels.decode_attention import ops as PO  # noqa: E402
from repro_torch.kernels.decode_attention import ref as PR  # noqa: E402

ATOL = 1e-5
#: split partials merged vs one softmax over the whole cache, float32:
#: each split takes its own max and exps and the merge rescales by
#: exp(m - M), so the sums run in another order and round differently in
#: the last bits; relative to max |ref|
SPLIT_RTOL = 1e-6
SMAX = 512


def _inputs(seed, b, hkv, g, s, hd, lengths):
    """(B, Hkv, G, hd) q and (B, Hkv, S, hd) caches, as the kernels take
    them."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hkv, g, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, s, hd), dtype=np.float32),
            rng.standard_normal((b, hkv, s, hd), dtype=np.float32),
            np.asarray(lengths, np.int32))


def _port(q, k, v, lens):
    return PR.decode_attend(*map(torch.from_numpy, (q, k, v, lens))).numpy()


# lengths 1 and 200 skip the second (and first) 256-row chunk entirely
@pytest.mark.parametrize("hkv,g,hd", [(2, 2, 16), (1, 4, 32), (2, 1, 64),
                                      (2, 1, 112)])
def test_ref_matches_reference(hkv, g, hd):
    args = _inputs(hd + g, 3, hkv, g, 512, hd, [512, 1, 200])
    want_ref = np.asarray(RR.decode_attend(*map(jnp.asarray, args)))
    want_kernel = np.asarray(RK.decode_attention(*map(jnp.asarray, args),
                                                 bk=256, interpret=True))
    got = _port(*args)
    np.testing.assert_allclose(got, want_ref, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_kernel, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hd", [32, 112])
def test_smax_not_a_chunk_multiple_against_reference_ref(hd):
    """Smax = 300.  Held against the reference's ref.py only: its Pallas
    kernel reads n_kv = 300 // 256 = 1 chunk (kernel.py:73-74) and drops
    positions 256-299 of a lane whose length is 300."""
    args = _inputs(11, 2, 2, 2, 300, hd, [300, 257])
    got = _port(*args)
    np.testing.assert_allclose(
        got, np.asarray(RR.decode_attend(*map(jnp.asarray, args))),
        rtol=0, atol=ATOL)


def test_ops_model_layout_matches_reference_ops():
    """`ops.decode_attention` in the model layout: q (B,1,Hq,hd), caches
    (B,S,Hkv,hd), against the reference's ops (its interpret-mode
    kernel)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 512, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 512, 2, 16), dtype=np.float32)
    lens = np.array([300, 17], np.int32)
    want = np.asarray(RO.decode_attention(*map(jnp.asarray, (q, k, v, lens))))
    got = PO.decode_attention(*map(torch.from_numpy, (q, k, v, lens)))
    assert got.shape == (2, 1, 4, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_garbage_past_lengths_changes_nothing():
    q, k, v, lens = _inputs(3, 2, 2, 2, 96, 16, [40, 65])
    base = _port(q, k, v, lens)
    k2, v2 = k.copy(), v.copy()
    for b, n in enumerate(lens):
        k2[b, :, n:] = 1e4
        v2[b, :, n:] = -1e4
    np.testing.assert_array_equal(_port(q, k2, v2, lens), base)


def test_head_dims():
    """The kernels are built for head dim 112 (zamba2-7b's shared
    attention) beside the powers of two, and for no other."""
    assert PK.HEAD_DIMS == (16, 32, 64, 112, 128)
    for hd in PK.HEAD_DIMS:
        PK.check_head_dim(hd)
    with pytest.raises(ValueError, match="head dim 96"):
        PK.check_head_dim(96)


def test_kernel_wrapper_raises_on_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only: no silent CPU path."""
    q = torch.zeros((1, 1, 2, 16))
    c = torch.zeros((1, 8, 2, 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        PK.decode_attention(q, c, c, torch.ones(1, dtype=torch.int32))
    assert PK.decode_attention.launches == 0


@pytest.mark.parametrize("length", [1, 63, 64, 65, SMAX])
@pytest.mark.parametrize("n_splits", [1, 2, 5, 8])
def test_combine_splits_matches_reference(n_splits, length):
    """Split partials merged by `ref.combine_splits` against the
    reference's plain version and its interpret-mode Pallas kernel
    (Smax % 256 == 0, where that kernel is right).  The second lane is
    full, so the split count is the batch's; at 8 splits of 64 rows a
    length of 1, 63 or 64 leaves splits wholly past the first lane's
    length, which must be the empty partial."""
    args = _inputs(n_splits * 100 + length, 2, 2, 4, SMAX, 32,
                   [length, SMAX])
    rows = -(-SMAX // n_splits)
    tq, tk, tv, tl = map(torch.from_numpy, args)
    m, l, acc = PR.split_partials(tq, tk, tv, tl, rows)
    assert m.shape == (2, 2, n_splits, 4) and acc.shape[-1] == 32
    empty = [i for i in range(n_splits) if i * rows >= length]
    for i in empty:
        assert bool((m[0, :, i] == -math.inf).all())
        assert not l[0, :, i].any() and not acc[0, :, i].any()
    if n_splits == 8 and length <= 64:
        assert empty, "a split wholly past the lane's length"
    got = PR.combine_splits(m, l, acc, torch.float32).numpy()
    for want in (np.asarray(RR.decode_attend(*map(jnp.asarray, args))),
                 np.asarray(RK.decode_attention(*map(jnp.asarray, args),
                                                bk=256, interpret=True))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SPLIT_RTOL * np.abs(want).max())


def test_length_zero_gives_zeros():
    """A lane of length 0: every split empty, zeros out, as the
    reference's Pallas kernel gives (its ref.py gives the mean of V)."""
    args = _inputs(9, 2, 2, 2, SMAX, 16, [0, 70])
    m, l, acc = PR.split_partials(*map(torch.from_numpy, args), 128)
    got = PR.combine_splits(m, l, acc, torch.float32).numpy()
    assert not got[0].any()
    kern = np.asarray(RK.decode_attention(*map(jnp.asarray, args), bk=256,
                                          interpret=True))
    assert not kern[0].any()
    np.testing.assert_allclose(got[1], kern[1], rtol=0,
                               atol=SPLIT_RTOL * np.abs(kern[1]).max())


@pytest.mark.parametrize("smax", [1, 64, 300, 512, 4096])
@pytest.mark.parametrize("b,hkv", [(1, 1), (8, 4), (64, 8)])
def test_split_plan(smax, b, hkv):
    """The host's split count: whole 64-row chunks per split, every split
    starting below Smax, about two blocks per SM where the cache has the
    chunks for it; shapes only, no lengths."""
    assert "lengths" not in inspect.signature(PK.split_plan).parameters
    n_sm = 132
    splits, rows = PK.split_plan(smax, b, hkv, n_sm)
    assert rows % PK.CHUNK == 0 and rows >= PK.CHUNK
    assert (splits - 1) * rows < smax <= splits * rows
    chunks = -(-smax // PK.CHUNK)
    want = PK.BLOCKS_PER_SM * n_sm
    assert splits * b * hkv >= min(want, chunks * b * hkv)
    if (b, hkv, smax) == (8, 4, 512):        # the serving shape
        assert (splits, rows) == (8, 64)
    # a cache of no rows still launches one (empty) split per lane
    assert PK.split_plan(0, b, hkv, n_sm) == (1, PK.CHUNK)


def test_layout_checks_run_once_per_layout(monkeypatch):
    """`kernel.layout` checks a layout once; the lengths' values never
    enter it; a changed layout (a strided cache, another dtype) is
    checked anew."""
    calls = []
    monkeypatch.setattr(PK, "_LAYOUTS", {})
    monkeypatch.setattr(PK, "check_inputs", lambda *a: calls.append(a))
    monkeypatch.setattr(PK, "sm_count", lambda index: 132)

    class Lib:
        @staticmethod
        def decode_attention_smem(hd, g, cache_dtype):
            return 1024
    monkeypatch.setattr(PK, "build", lambda: Lib)
    q = torch.zeros((8, 1, 32, 64), dtype=torch.bfloat16)
    cache = torch.zeros((8, 512, 4, 64), dtype=torch.bfloat16)
    lay = PK.layout(q, cache, cache, torch.full((8,), 288, dtype=torch.int32))
    again = PK.layout(q, cache, cache, torch.ones(8, dtype=torch.int32))
    assert again is lay and len(calls) == 1
    assert lay.ints[-2:] == (8, 64)
    wide = torch.zeros((8, 512, 8, 64), dtype=torch.bfloat16)[:, :, :4]
    PK.layout(q, wide, wide, torch.ones(8, dtype=torch.int32))
    assert len(calls) == 2
    PK.layout(q.float(), cache, cache, torch.ones(8, dtype=torch.int32))
    assert len(calls) == 3


# ----------------------------------------------------------------------------
# a sequence-sharded cache: every rank's partials over its block, merged
# ----------------------------------------------------------------------------


def _ranks_gather(parts):
    """A stand-in for ``MeshContext.gather`` over R ranks: each rank's
    tensor in `parts` (filled in rank order by the caller) joined on dim
    2, whatever tensor it is handed."""
    return lambda t: torch.cat(parts, 2)


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("hkv,g,hd", [(2, 2, 16), (1, 4, 64), (2, 1, 112)])
def test_sharded_decode_matches_reference(ranks, hkv, g, hd):
    """The cache cut into `ranks` blocks of positions: each block's partial
    softmax state (one split, masked by the lanes' global lengths moved
    to its origin; a block past a lane's length the empty partial),
    gathered in rank order and merged, against the reference's plain
    decode over the whole cache (a lane of length 1, one that ends inside
    block 1, one that fills the cache)."""
    s = 256
    rows = s // ranks
    args = _inputs(7 * hd + g, 3, hkv, g, s, hd, [1, rows + 5, s])
    want = np.asarray(RR.decode_attend(*map(jnp.asarray, args)))
    q, k, v, lens = map(torch.from_numpy, args)
    packed = []
    for r in range(ranks):
        blk = slice(r * rows, (r + 1) * rows)
        m, l, acc = PR.split_partials(
            q, k[:, :, blk], v[:, :, blk],
            PR.block_lengths(lens, r * rows, rows), rows)
        packed.append(torch.cat([m[..., None], l[..., None], acc], -1))
    gather = _ranks_gather(packed)
    outs = [PR.decode_attend_sharded(q, k[:, :, r * rows:(r + 1) * rows],
                                     v[:, :, r * rows:(r + 1) * rows], lens,
                                     r * rows, gather)
            for r in range(ranks)]
    for out in outs:                 # every rank merges the same partials
        assert torch.equal(out, outs[0])
    scale = np.abs(want).max()
    np.testing.assert_allclose(outs[0].numpy(), want, rtol=0,
                               atol=SPLIT_RTOL * scale)
    # the model layout through the wrapper's CPU path: the same numbers
    qm = q.reshape(3, 1, hkv * g, hd)
    km, vm = k.transpose(1, 2), v.transpose(1, 2)
    got = PO.decode_attention_sharded(qm, km[:, :rows], vm[:, :rows], lens,
                                      0, gather)
    assert torch.equal(got.reshape(outs[0].shape), outs[0])


def test_gathered_partials_are_one_workspace():
    """`ref.gather_partials` unpacks every rank's (m, l, acc) into views of
    one flat float32 workspace, m then l then acc, the layout the combine
    kernel reads (``kernel.combine`` checks it), in rank order on the
    split dim; `block_lengths` clamps the lanes' lengths to the block."""
    b, hkv, s, g, hd = 2, 3, 2, 2, 16
    parts = [torch.randn(b, hkv, s, g, 2 + hd) for _ in range(3)]
    p0 = parts[0]
    m, l, acc = PR.gather_partials(p0[..., 0], p0[..., 1], p0[..., 2:],
                                   _ranks_gather(parts))
    n = m.numel()
    assert m.shape == l.shape == (b, hkv, 3 * s, g)
    assert acc.shape == (b, hkv, 3 * s, g, hd)
    assert m.is_contiguous() and l.data_ptr() == m.data_ptr() + 4 * n
    assert acc.data_ptr() == l.data_ptr() + 4 * n
    assert torch.equal(m[:, :, s:2 * s], parts[1][..., 0])
    assert torch.equal(acc[:, :, 2 * s:], parts[2][..., 2:])
    lens = torch.tensor([0, 5, 9, 40], dtype=torch.int32)
    assert PR.block_lengths(lens, 8, 16).tolist() == [0, 0, 1, 16]


def test_split_alone_raises_on_cpu_tensors():
    """The split kernel's wrapper takes CUDA tensors only (no fallback)."""
    q = torch.zeros(1, 1, 2, 16)
    c = torch.zeros(1, 8, 1, 16)
    with pytest.raises(ValueError):
        PK.split(q, c, c, torch.ones(1, dtype=torch.int32))
