"""The port's serve<->sim bridge against the reference: from the two
packages' captures of the same serving run (float32 reduced
tinyllama-1.1b, the reference's params carried over, an eos that fires
mid-run), `captured_trace`, `StreamProfile.from_capture` and `mix_trace`
(the three traffic classes of ``benchmarks/paper_fig_serve.py``) are
equal, arrays exactly."""
import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from benchmarks.paper_fig_serve import TRAFFIC_CLASSES  # noqa: E402
from repro.configs import (ParallelConfig as RefPCfg,  # noqa: E402
                           get_config as ref_get_config,
                           reduce_config as ref_reduce)
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro.serve import bridge as ref_bridge  # noqa: E402
from repro.serve.engine import Engine as RefEngine  # noqa: E402
from repro.serve.engine import ServeConfig as RefServeConfig  # noqa: E402
from repro_torch.configs import (ParallelConfig, get_config,  # noqa: E402
                                 reduce_config)
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core.smla import traces as port_traces  # noqa: E402
from repro_torch.serve import bridge  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

EOS = 76   # lane 2 emits it at step 3, lane 0 at step 10, lanes 1 and 3 never


@pytest.fixture(scope="module")
def captures():
    rcfg = dataclasses.replace(ref_reduce(ref_get_config("tinyllama-1.1b")),
                               dtype="float32")
    cfg = dataclasses.replace(reduce_config(get_config("tinyllama-1.1b")),
                              dtype="float32")
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    flat = {k: np.asarray(v)
            for k, v in ref_common.flatten_paths(rparams).items()}
    prompt = np.random.default_rng(4).integers(0, cfg.vocab_size, (4, 8),
                                               dtype=np.int32)
    ref_eng = RefEngine(rcfg, RefPCfg(attn_impl="chunked", moe_impl="dense",
                                      remat="none"),
                        RefServeConfig(max_seq=64, eos_id=EOS), rparams)
    eng = Engine(cfg, ParallelConfig(attn_impl="pallas", moe_impl="dense",
                                     remat="none"),
                 ServeConfig(max_seq=64, eos_id=EOS),
                 params_from_reference(flat, cfg), device="cpu")
    rout, rcap = ref_bridge.capture_generate(
        ref_eng, {"tokens": jnp.asarray(prompt)}, 16)
    out, cap = bridge.capture_generate(eng, {"tokens": prompt}, 16)
    np.testing.assert_array_equal(out.numpy(), np.asarray(rout))
    live = rcap.live_decode_tokens
    assert live.min() < live.max(), "the eos must fire mid-run in a lane"
    return cap, rcap


def _equal_arrays(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_capture_equal(captures):
    cap, rcap = captures
    assert len(cap.steps) == len(rcap.steps)
    for s, r in zip(cap.steps, rcap.steps):
        assert s.kind == r.kind
        for f in ("live", "appended", "lengths"):
            np.testing.assert_array_equal(getattr(s, f), getattr(r, f))
    np.testing.assert_array_equal(cap.live_decode_tokens,
                                  rcap.live_decode_tokens)
    assert cap.weight_bytes() == rcap.weight_bytes()
    assert cap.kv_bytes_per_token() == rcap.kv_bytes_per_token()


@pytest.mark.parametrize("n_ranks,n_banks,stride", [(4, 2, None), (8, 4, 3)])
def test_captured_trace_equal(captures, n_ranks, n_banks, stride):
    cap, rcap = captures
    _equal_arrays(bridge.captured_trace(cap, n_ranks, n_banks,
                                        read_stride=stride),
                  ref_bridge.captured_trace(rcap, n_ranks, n_banks,
                                            read_stride=stride))


@pytest.mark.parametrize("mix", TRAFFIC_CLASSES, ids=lambda m: m.name)
def test_profile_and_mix_trace_equal(captures, mix):
    cap, rcap = captures
    prof = bridge.StreamProfile.from_capture(cap)
    rprof = ref_bridge.StreamProfile.from_capture(rcap)
    assert dataclasses.asdict(prof) == dataclasses.asdict(rprof)
    pmix = port_traces.TrafficMix(**dataclasses.asdict(mix))
    _equal_arrays(bridge.mix_trace(0, pmix, prof, 600, 4, 2),
                  ref_bridge.mix_trace(0, mix, rprof, 600, 4, 2))
