"""The paper's full-width CNN on the port against the JAX package, with the
JAX weights carried across by ``load_numpy_params``.

Logits are held at 1e-4: five stacked f32 conv layers sum in another order
in each framework."""
import jax
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.core import basecaller as jbc
from repro_torch.core import basecaller as tbc

TOL = 1e-4
CHUNK = 64


@pytest.fixture(scope="module")
def params():
    cfg = jbc.BasecallerConfig()
    jp = jbc.init(jax.random.key(0), cfg)
    tp = tbc.load_numpy_params(jax.tree.map(np.asarray, jp), U.CPU)
    return jp, tp


@pytest.fixture(scope="module")
def signal():
    return np.random.default_rng(5).standard_normal((2, 3 * CHUNK)).astype(
        np.float32)


def test_full_width_geometry(params):
    _, tp = params
    cfg = tbc.BasecallerConfig()
    assert tbc.num_params(tp) == 460_261
    assert cfg.receptive_field == jbc.BasecallerConfig().receptive_field
    assert [(s.ksize, s.stride, s.cin, s.cout, s.carry_rows)
            for s in tbc.stream_layer_specs(cfg)] == \
        [(s.ksize, s.stride, s.cin, s.cout, s.carry_rows)
         for s in jbc.stream_layer_specs(jbc.BasecallerConfig())]


def test_chunked_stream_matches_jax(params, signal):
    """apply_stream over 3 chunks at 2 lanes: logits and carries per chunk."""
    jp, tp = params
    jcfg, tcfg = jbc.BasecallerConfig(), tbc.BasecallerConfig()
    jstate = jbc.init_stream_state(jcfg, 2)
    tstate = tbc.init_stream_state(tcfg, 2, device=U.CPU)
    for lo in range(0, signal.shape[1], CHUNK):
        chunk = signal[:, lo:lo + CHUNK]
        jy, jstate = jbc.apply_stream(jp, jstate, chunk, jcfg,
                                      fabric="reference")
        ty, tstate = tbc.apply_stream(tp, tstate, U.t(chunk), tcfg)
        assert ty.shape == (2, CHUNK // tcfg.total_stride, 5)
        np.testing.assert_allclose(U.n(ty), np.asarray(jy), rtol=TOL,
                                   atol=TOL)
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(U.n(a), np.asarray(b), rtol=TOL,
                                       atol=TOL)


def test_stream_equals_whole_read(params, signal):
    """In the port, chunked streaming concatenates to the whole-read
    "stream"-padded pass."""
    _, tp = params
    cfg = tbc.BasecallerConfig()
    whole = tbc.apply(tp, U.t(signal), cfg, padding="stream")
    state = tbc.init_stream_state(cfg, 2, device=U.CPU)
    parts = []
    for lo in range(0, signal.shape[1], CHUNK):
        y, state = tbc.apply_stream(tp, state, U.t(signal[:, lo:lo + CHUNK]),
                                    cfg)
        parts.append(y)
    np.testing.assert_allclose(U.n(torch.cat(parts, 1)), U.n(whole),
                               rtol=TOL, atol=TOL)


def test_same_padding_matches_jax(params, signal):
    jp, tp = params
    want = jbc.apply(jp, signal[:, :101], jbc.BasecallerConfig(),
                     fabric="reference")
    got = tbc.apply(tp, U.t(signal[:, :101]), tbc.BasecallerConfig())
    assert got.shape == want.shape
    np.testing.assert_allclose(U.n(got), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_init_is_seeded_he_normal():
    cfg = tbc.BasecallerConfig()
    a = tbc.init(torch.Generator().manual_seed(0), cfg, device=U.CPU)
    b = tbc.init(torch.Generator().manual_seed(0), cfg, device=U.CPU)
    for name in a:
        assert torch.equal(a[name]["w"], b[name]["w"])
        assert a[name]["w"].dtype == torch.float32
    w = a["conv5"]["w"]
    assert abs(float(w.std()) - (2.0 / (9 * 192)) ** 0.5) < 2e-3
