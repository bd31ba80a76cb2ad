"""The port's serving surface (``repro_torch.serving``) on the CPU: the
``Fleet`` facade's re-exports, the ``engine.py`` alias, and the three
deprecated server shims, each warning and giving its engine's results
(JAX ``tests/test_engine.py`` and ``tests/test_fleet.py``)."""
import numpy as np
import pytest
import torch

import torch_port_util as U
import repro_torch.engine as tengine
from repro_torch.engine.lm import Request


def test_serving_reexports_the_fleet_and_the_shims():
    import repro_torch.serving as serving
    from repro_torch import fleet
    from repro_torch.serving import engine as alias
    from repro_torch.serving import legacy
    assert serving.Fleet is fleet.Fleet and serving.Tenant is fleet.Tenant
    assert serving.FleetScheduler is fleet.FleetScheduler
    for name in ("LMServer", "BasecallServer", "AdaptiveSamplingServer",
                 "Request"):
        assert getattr(serving, name) is getattr(legacy, name)
        assert getattr(alias, name) is getattr(legacy, name)
    assert serving.Request is Request


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [Request(uid=uid, prompt=rng.integers(1, vocab, 3),
                    max_new_tokens=4) for uid in range(4)]


def test_lm_server_warns_and_matches():
    """JAX's ``test_lm_server_warns_and_matches``: the shim delegates one
    to one, so steps, finished uids and tokens per request equal the
    engine's (the engine is held to JAX's in test_torch_lm_decode.py)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.registry import get_model
    from repro_torch.serving.engine import LMServer
    cfg = ARCHS["qwen3-4b"].smoke_config()
    model = get_model(cfg)
    params, _ = model.init(torch.Generator().manual_seed(0), cfg,
                           device=U.CPU)
    with pytest.warns(DeprecationWarning):
        srv = LMServer(model, params, cfg, slots=2, max_len=32,
                       device=U.CPU)
    for r in _requests(cfg.vocab_size):
        srv.submit(r)
    old_steps = srv.run_until_drained()
    eng = tengine.build("lm_decode", model=model, params=params, cfg=cfg,
                        slots=2, max_len=32, device=U.CPU)
    for r in _requests(cfg.vocab_size):
        eng.submit(r)
    report = eng.drain()
    assert old_steps == report["steps"]
    assert ([(r.uid, r.tokens_out) for r in srv.finished]
            == [(r.uid, r.tokens_out) for r in eng.finished])
    assert not srv.queue and srv.active == [None, None]



def test_basecall_server_warns_and_matches():
    from repro_torch.core import basecaller as bc
    from repro_torch.serving.legacy import BasecallServer
    cfg = bc.BasecallerConfig(kernels=(3, 3, 1), channels=(16, 16, 5),
                              strides=(1, 2, 1))
    params = bc.init(torch.Generator().manual_seed(0), cfg, device=U.CPU)
    chunks = np.random.default_rng(0).normal(size=(6, 512)).astype(
        np.float32)
    with pytest.warns(DeprecationWarning):
        srv = BasecallServer(params, cfg, batch=4, chunk=512,
                             use_kernel=True, device=U.CPU)
    old = srv.serve(chunks)
    eng = tengine.build("basecall", params=params, cfg=cfg, batch=4,
                        chunk=512, device=U.CPU)
    new = eng.serve(chunks)
    assert len(old) == len(new) == 6
    for a, b in zip(old, new):
        np.testing.assert_array_equal(a, b)
    s = srv.stats.summary()
    assert s["p99_ms"] >= s["p50_ms"] > 0
    assert srv.stats.samples == 6 * 512 and srv.stats.wall_s > 0


def test_adaptive_server_warns_and_places_every_op_on_its_device():
    from repro_torch.data import genome as G
    from repro_torch.engine.adaptive import legacy_adaptive_policy
    from repro_torch.serving.legacy import AdaptiveSamplingServer
    for flags in ((False, None), (True, None), (False, True), (True, False)):
        assert legacy_adaptive_policy(*flags, device=U.CPU) == {
            "conv1d": "reference", "banded_align": "reference"}
    ref = G.random_genome(np.random.default_rng(0), 4000)
    with pytest.warns(DeprecationWarning):
        srv = AdaptiveSamplingServer(None, None, ref, [(0, 1000)],
                                     channels=4, chunk=128, interpret=True,
                                     device=U.CPU)
    assert srv.placement == {"conv1d": "reference",
                             "banded_align": "reference"}
    rng = np.random.default_rng(1)
    for i in range(4):
        srv.submit(rng.normal(size=4 * 128).astype(np.float32), read_id=i,
                   on_target=bool(i % 2))
    rep = srv.run_until_drained()
    assert rep["completed"] == 4 == len(srv.records)
    assert srv.summary()["completed"] == 4
    assert srv.runtime is srv._eng.runtime
