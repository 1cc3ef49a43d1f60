"""The port's SMLA cascaded-pipeline matmul (`kernels/smla_pipe`) against
the reference, same numpy inputs: `ops.matmul_cascaded` and
`ops.matmul_dedicated` (their plain versions on the CPU) against the
reference's Pallas kernels in interpret mode at the reference test's grid
(divisible shapes: the reference drops ragged tiles and stripe tails,
ROADMAP queue 3), and against `matmul_striped` everywhere, ragged shapes
included; the striping order; the staging kernel's plain version (TF32
planes and their layout) and the 3xTF32 products' accuracy, the card
kernel's premise; the wrappers' dispatch; the benchmark.

Tolerance: 1e-5 x max |ref| for both dtypes — bf16 inputs are upcast to
float32 exactly, so only the order of the float32 sums differs; the
striping-order case (small integers) to rtol 1e-6."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.smla_pipe import kernel as SK  # noqa: E402
from repro.kernels.smla_pipe import ref as SR  # noqa: E402
from repro_torch.benchmarks import smla_pipe_bench  # noqa: E402
from repro_torch.kernels.smla_pipe import kernel as K  # noqa: E402
from repro_torch.kernels.smla_pipe import ops, ref  # noqa: E402

GRID = [(128, 256, 128, 2), (256, 512, 128, 4), (128, 512, 256, 8)]
#: ragged M, ragged N, and stripes (K/L 96, 200) that are not a multiple
#: of the reference's bk 64 or the plain versions' 128
RAGGED = [(192, 512, 128, 4), (128, 384, 192, 4), (128, 384, 128, 4),
          (70, 800, 33, 4)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(m, k, n, l, dtype, seed=0):
    """(x, w) as (jax arrays, torch tensors) of the same values: drawn in
    float32 with numpy, rounded to the dtype once."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    w = rng.standard_normal((l, k // l, n), dtype=np.float32)
    jdt, tdt = DTYPES[dtype]
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(tdt)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(tdt)
    return (jx, jw), (tx, tw)


def _close(got, want, what):
    want = np.asarray(want, np.float32)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.dtype == np.float32 and got.shape == want.shape, what
    tol = 1e-5 * float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{what}: max abs {err} > {tol}"


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n,l", GRID)
def test_grid_matches_reference_kernels(dtype, m, k, n, l):
    (jx, jw), (tx, tw) = _inputs(m, k, n, l, dtype)
    want = SR.matmul_striped(jx, jw)
    cas = SK.matmul_cascaded(jx, jw, bm=128, bn=128, bk=64, interpret=True)
    ded = SK.matmul_dedicated(jx, jw, bm=128, bn=128, bk=64, interpret=True)
    got_c, got_d = ops.matmul_cascaded(tx, tw), ops.matmul_dedicated(tx, tw)
    _close(got_c, cas, "cascaded vs the reference's kernel")
    _close(got_d, ded, "dedicated vs the reference's kernel")
    _close(got_c, want, "cascaded vs matmul_striped")
    _close(got_d, want, "dedicated vs matmul_striped")
    _close(ref.matmul_striped(tx, tw), want, "matmul_striped")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n,l", RAGGED)
def test_ragged_shapes_match_striped(dtype, m, k, n, l):
    """Where the reference's kernel leaves outputs unwritten or drops
    stripe tails, the port's plain versions (and so what its kernel is
    held to) still equal the oracle."""
    (jx, jw), (tx, tw) = _inputs(m, k, n, l, dtype, seed=1)
    want = SR.matmul_striped(jx, jw)
    for bk in (ref.BK, 64, 7):
        _close(ref.cascaded(tx, tw, bk), want, f"cascaded bk {bk}")
        _close(ref.dedicated(tx, tw, bk), want, f"dedicated bk {bk}")
    _close(ops.matmul_cascaded(tx, tw), want, "ops.matmul_cascaded")
    _close(ops.matmul_dedicated(tx, tw), want, "ops.matmul_dedicated")


def test_layer_striping_order():
    """The cascade consumes layer stripes in K order (layer 0 first)."""
    m, k, n, l = 8, 32, 8, 4
    x = np.eye(m, k, dtype=np.float32)
    w = np.arange(l * (k // l) * n, dtype=np.float32).reshape(l, k // l, n)
    want = np.asarray(SR.matmul_striped(jnp.asarray(x), jnp.asarray(w)))
    pallas = np.asarray(SK.matmul_cascaded(jnp.asarray(x), jnp.asarray(w),
                                           bm=8, bn=8, bk=8, interpret=True))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    for got in (ops.matmul_cascaded(tx, tw), ops.matmul_dedicated(tx, tw),
                ref.cascaded(tx, tw, 8)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-6)


def _counts():
    return (K.matmul_cascaded.launches, K.matmul_dedicated.launches,
            K.stage_tf32.launches, K.sum_partials.launches)


def test_dispatch_and_wrapper_checks():
    (_, _), (x, w) = _inputs(64, 128, 32, 2, "float32")
    before = _counts()
    ops.matmul_cascaded(x, w)
    ops.matmul_dedicated(x, w)
    # CPU tensors run the plain versions: no kernel launch is counted
    assert _counts() == before
    # the kernel wrappers take CUDA tensors only, and raise on anything else
    for fn in (K.matmul_cascaded, K.matmul_dedicated, K.stage_tf32):
        with pytest.raises(ValueError, match="CUDA device"):
            fn(x, w)
    with pytest.raises(ValueError, match="CUDA device"):
        K.sum_partials(torch.zeros((2, 4, 4)))
    assert _counts() == before
    with pytest.raises(ValueError, match="unsupported device"):
        ops.matmul_cascaded(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="K != L"):
        ref.cascaded(x, w[:, :10])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("m,k,n,l", [(70, 800, 33, 4), (65, 148, 33, 4),
                                     (128, 256, 128, 2)])
def test_split_tf32_planes(dtype, m, k, n, l):
    """The staging kernel's plain version: hi has 13 zero low bits, hi +
    lo is within 2^-22 of |a|, bf16 values give lo = 0, and every element
    lands where the product kernel reads it (tile, row, swizzled piece),
    with zeros in the padding."""
    (_, _), (x, w) = _inputs(m, k, n, l, dtype, seed=3)
    a = x.float()
    hi, lo = ref.split_tf32(a)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    assert bool(((hi + lo - a).abs() <= 2.0 ** -22 * a.abs()).all())
    if dtype == "bfloat16":
        assert torch.equal(hi, a) and not lo.any()

    planes = ref.stage_tf32(x, w)
    assert planes.dtype == torch.float32
    assert planes.numel() == ref.planes_numel(x, w)
    kpl = k // l
    n_k = -(-kpl // ref.CHUNK)
    n_t, mt = l * n_k, -(-m // ref.TILE_ROWS)
    nt = -(-n // ref.TILE_ROWS)
    tile = ref.TILE_ROWS * ref.CHUNK
    side = (mt + nt) * n_t * tile

    def where(row, layer, kk, row_block0):
        """Flat index of stripe element kk of `layer` in staged row `row`."""
        t = layer * n_k + kk // ref.CHUNK
        r, c = row % ref.TILE_ROWS, (kk % ref.CHUNK) // 4
        return (((row_block0 + row // ref.TILE_ROWS) * n_t + t) * tile
                + r * ref.CHUNK + 4 * (c ^ (r % 8)) + kk % 4)

    rows, layers, kks = np.meshgrid(np.arange(m), np.arange(l),
                                    np.arange(kpl), indexing="ij")
    ix = torch.from_numpy(where(rows, layers, kks, 0).reshape(-1))
    cols, layers, kks = np.meshgrid(np.arange(n), np.arange(l),
                                    np.arange(kpl), indexing="ij")
    iw = torch.from_numpy(where(cols, layers, kks, mt).reshape(-1))
    w_rows = w.float().permute(2, 0, 1)            # (N, L, K/L)
    planes_of = [(0, hi, ref.split_tf32(w_rows)[0])]
    if dtype == "float32":
        planes_of.append((side, lo, ref.split_tf32(w_rows)[1]))
    else:
        assert planes.numel() == side
    filled = torch.zeros(planes.numel(), dtype=torch.bool)
    for base, xp, wp in planes_of:
        assert torch.equal(planes[base + ix], xp.reshape(-1))
        assert torch.equal(planes[base + iw], wp.reshape(-1))
        filled[base + ix] = filled[base + iw] = True
    assert not planes[~filled].any()                 # the padding is zero


#: the 3xTF32 check's shapes: the grid, the ragged ones and the realistic
#: shape's depth (K 2048 over 4 layers) at a CPU-sized M and N
TF32_SHAPES = GRID + RAGGED + [(256, 2048, 256, 4)]


@pytest.mark.parametrize("m,k,n,l", TF32_SHAPES)
def test_three_tf32_products_meet_pipe_tol(m, k, n, l):
    """The product kernel's premise: x_hi w_hi + x_hi w_lo + x_lo w_hi of
    the staging's TF32 planes (products exact, summed here in float64)
    meets the kernel's tolerance against the reference's float32
    `matmul_striped`; one TF32 product, at the realistic depth, does
    not."""
    (jx, jw), (tx, tw) = _inputs(m, k, n, l, "float32", seed=4)
    want = SR.matmul_striped(jx, jw)
    xh, xl = (p.double() for p in ref.split_tf32(tx))
    wh, wl = (p.double() for p in ref.split_tf32(tw.reshape(k, n)))
    _close((xh @ wh + xh @ wl + xl @ wh).float(), want, "3xTF32")
    if k == 2048:
        one = (xh @ wh).float().numpy()
        err = float(np.abs(one - np.asarray(want)).max())
        assert err > 1e-5 * float(np.abs(np.asarray(want)).max())


def test_bench_runs_on_cpu(capsys):
    rows = smla_pipe_bench.run(64, 256, 48, 4, device="cpu")
    assert [r["impl"] for r in rows] == ["cascaded", "dedicated",
                                         "torch_matmul"]
    for r in rows:
        assert r["max_abs_err"] <= 1e-4 and r["ms"] > 0 and r["calls"] == 52
    assert smla_pipe_bench.main(["--device", "cpu", "--shape",
                                 "default"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == "impl,max_abs_err,ms" and "device cpu" in out[0]
    assert [line.split(",")[0] for line in out[2:]] == [
        "cascaded", "dedicated", "torch_matmul"]
