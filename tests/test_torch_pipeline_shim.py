"""The last shims on the port against the JAX package: the deprecated
``StreamingBasecallPipeline`` (``core/pipeline.py``) on the inputs of
``tests/test_engine.py``'s shim test, and the FM-index's host oracle
``search_np`` (``core/fm_index.py``)."""
import warnings

import jax
import numpy as np
import pytest
import torch  # noqa: F401

import torch_port_util as U
import repro_torch.engine as tengine
from repro.core import basecaller as jbc
from repro.core import fm_index as jfm
from repro.core.pipeline import PipelineConfig as JPipeCfg
from repro.core.pipeline import StreamingBasecallPipeline as JPipe
from repro_torch.core import basecaller as tbc
from repro_torch.core import fm_index as tfm
from repro_torch.core.pipeline import PipelineConfig, PipelineStats
from repro_torch.core.pipeline import StreamingBasecallPipeline

SMALL = dict(kernels=(3, 3, 1), channels=(16, 16, 5), strides=(1, 2, 1))


def _chunks():
    rng = np.random.default_rng(7)
    return [rng.normal(size=(4, 512)).astype(np.float32) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_shim():
    cfg = jbc.BasecallerConfig(**SMALL)
    params = jbc.init(jax.random.key(0), cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pipe = JPipe(params, cfg)
    out = list(pipe.run(iter(_chunks())))
    return {"out": out, "stats": pipe.stats, "warnings": caught,
            "params": tbc.load_numpy_params(jax.tree.map(np.asarray, params),
                                            U.CPU)}


def _port(jax_shim, **kw):
    with pytest.warns(DeprecationWarning, match="engine.build") as caught:
        pipe = StreamingBasecallPipeline(jax_shim["params"],
                                         tbc.BasecallerConfig(**SMALL), **kw)
    return pipe, caught


def test_shim_yields_jax_reads_and_stats(jax_shim):
    pipe, caught = _port(jax_shim, device=U.CPU)
    seen = []
    with U.one_thread():
        out = list(pipe.run(iter(_chunks()),
                            on_read=lambda t, n: seen.append(len(n))))
    assert len(out) == len(jax_shim["out"]) == 3 and seen == [4, 4, 4]
    for (tt, tl), (jt, jl) in zip(out, jax_shim["out"]):
        np.testing.assert_array_equal(tt, np.asarray(jt))
        np.testing.assert_array_equal(tl, np.asarray(jl))
    got, want = pipe.stats, jax_shim["stats"]
    assert isinstance(got, PipelineStats)
    for f in ("chunks", "device_dispatches", "bases_called", "samples_in"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.chunks == 3 and got.samples_in == 3 * 4 * 512
    assert got.bases_per_s() > 0
    # the same warning, pointing at the caller
    jw = [w for w in jax_shim["warnings"]
          if issubclass(w.category, DeprecationWarning)]
    assert len(caught) == len(jw) == 1
    assert caught[0].filename == __file__
    assert "StreamingBasecallPipeline is deprecated" in str(caught[0].message)


def test_shim_equals_the_engine(jax_shim):
    """The shim's reads are the engine's on the same chunks (JAX's own
    shim test, on the port)."""
    pipe, _ = _port(jax_shim, pipe_cfg=PipelineConfig(depth=1),
                    device=U.CPU)
    eng = tengine.build("pathogen_pipeline", params=jax_shim["params"],
                        cfg=tbc.BasecallerConfig(**SMALL), depth=1,
                        device=U.CPU)
    with U.one_thread():
        old = list(pipe.run(iter(_chunks())))
        for chunk in _chunks():
            eng.submit(chunk)
        eng.drain()
    assert len(old) == len(eng.outputs) == 3
    for (ot, ol), (nt, nl) in zip(old, eng.outputs):
        np.testing.assert_array_equal(ot, nt)
        np.testing.assert_array_equal(ol, nl)
    assert pipe._eng.device.type == "cpu"
    assert PipelineConfig() == PipelineConfig(**vars(JPipeCfg()))


def test_shim_use_kernel_asks_for_the_card(jax_shim, monkeypatch):
    """``use_kernel=True`` is the card, with no CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(jax_shim, use_kernel=True)
    with pytest.raises(ValueError, match="use_kernel=True runs the kernels"):
        StreamingBasecallPipeline(jax_shim["params"],
                                  tbc.BasecallerConfig(**SMALL),
                                  use_kernel=True, device=U.CPU)


def test_shim_runs_on_the_card_unless_asked_for_the_cpu(jax_shim,
                                                        monkeypatch):
    """As every entry point of the port, JAX's ``StreamingBasecallPipeline
    (params, cfg)`` with no device named is the card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(jax_shim)


@pytest.mark.parametrize("seed", range(3))
def test_search_np_equals_jax(seed):
    rng = np.random.default_rng(seed)
    genome = rng.integers(1, 5, 800).astype(np.int32)
    j, t = jfm.FMIndex.build(genome), tfm.FMIndex.build(genome)
    for k in (4, 8, 12):
        starts = rng.integers(0, len(genome) - k, 6)
        seeds = [genome[s:s + k] for s in starts]
        seeds += [rng.integers(1, 5, k).astype(np.int32) for _ in range(4)]
        for s in seeds:
            got, want = tfm.search_np(t, s), jfm.search_np(j, s)
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
        for s, st in zip(seeds[:6], starts):
            assert st in tfm.search_np(t, s)
