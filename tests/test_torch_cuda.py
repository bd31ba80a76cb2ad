"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with the reason) where there is no CUDA
device.  Run them on a machine with an H100:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

(``--noconftest``: the suite's conftest imports JAX, which the port and
its card need not have.)
"""
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro_torch.core import basecaller as bc
from repro_torch.kernels import conv1d as kc
from repro_torch.kernels import edit_distance as ke
from repro_torch.kernels import fused_stream as kf
from repro_torch.kernels import matmul as km
from repro_torch.kernels import ref
from repro_torch.quant.core import pack_fragments

pytestmark = pytest.mark.cuda
TOL = 2e-5


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ref.full_fp32()
    return torch.device("cuda")


def _g(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("cin,cout,k,stride,t", [
    (1, 64, 5, 1, 260), (64, 96, 7, 1, 70), (96, 192, 9, 2, 135),
    (1, 5, 2, 2, 63), (3, 70, 5, 1, 61)])
def test_conv1d_kernel(dev, cin, cout, k, stride, t):
    # He-scaled weights, as the basecaller's: outputs stay O(1)
    x = torch.randn((5, t, cin), generator=_g(0)).to(dev)
    w = (torch.randn((k, cin, cout), generator=_g(1))
         * (2.0 / (k * cin)) ** 0.5).to(dev)
    b = torch.randn((cout,), generator=_g(2)).to(dev)
    before = kc.conv1d.launches
    got = kc.conv1d(x, w, b, stride=stride, activation="relu")
    assert kc.conv1d.launches == before + 1
    want = ref.conv1d(x, w, b, stride=stride, activation="relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", ["none", "relu", "squared_relu", "silu",
                                 "gelu"])
def test_matmul_kernel(dev, act):
    a = torch.randn((1000, 37), generator=_g(3)).to(dev)
    w = torch.randn((37, 5), generator=_g(4)).to(dev)
    b = torch.randn((5,), generator=_g(5)).to(dev)
    torch.testing.assert_close(km.matmul(a, w, b, activation=act),
                               ref.matmul(a, w, b, activation=act),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("band,local", [(0, False), (3, True), (32, True),
                                        (47, False)])
def test_banded_align_kernel_bitwise(dev, band, local):
    rng = np.random.default_rng(band)
    q = U.t(rng.integers(1, 5, (70, 48)).astype(np.int32)).to(dev)
    t = U.t(rng.integers(0, 5, (70, 80)).astype(np.int32)).to(dev)
    kw = dict(band=band, local=local)
    assert torch.equal(ke.banded_align(q, t, **kw),
                       ref.banded_align(q, t, **kw))


# The tick's conv2-conv5 (at 5 lanes), the variant caller's 48 -> 96, a
# ragged T_out and Cout, a Cin of 512 (K 9, stride 2) and a batch past the
# old 65,535 grid limit; tc says which kernel the shape takes.
@pytest.mark.parametrize("b,cin,cout,k,stride,t,tc", [
    (5, 64, 64, 7, 2, 261, True), (5, 64, 96, 7, 1, 134, True),
    (5, 96, 192, 9, 2, 135, True), (5, 192, 128, 9, 1, 72, True),
    (7, 48, 96, 5, 1, 37, True), (3, 16, 40, 5, 1, 150, True),
    (4, 512, 64, 9, 2, 300, True), (4, 512, 5, 9, 2, 300, False),
    (3, 1, 64, 5, 1, 260, False), (65_537, 8, 8, 5, 1, 20, True),
    (65_537, 1, 8, 5, 1, 20, False)])
def test_conv1d_variants(dev, b, cin, cout, k, stride, t, tc):
    x = torch.randn((b, t, cin), generator=_g(20)).abs().to(dev)
    w = (torch.randn((k, cin, cout), generator=_g(21))
         * (2.0 / (k * cin)) ** 0.5).to(dev)
    bias = torch.randn((cout,), generator=_g(22)).to(dev)
    before = (kc.conv1d.launches, kc.conv1d.tc_launches)
    got = kc.conv1d(x, w, bias, stride=stride, activation="relu")
    assert (kc.conv1d.launches, kc.conv1d.tc_launches) == (
        before[0] + 1, before[1] + tc)
    assert tc == kc.tensor_core_shape(cin, cout, k, stride)
    want = ref.conv1d(x, w, bias, stride=stride, activation="relu")
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)


def test_conv1d_tc_smem_matches_the_predicate(dev):
    """The wrapper's Python mirror of the tensor-core ring's size agrees
    with the kernel's own at the tick's layers."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.function("conv1d", "conv1d_tc_smem_bytes", [ctypes.c_int] * 3)
    for k, stride, cout in ((7, 2, 64), (7, 1, 96), (9, 2, 192), (9, 1, 128),
                            (5, 1, 96)):
        assert fn(k, stride, cout) == kc.tc_smem_bytes(k, stride, cout)


def test_conv1d_int8_tc_smem_matches_the_predicate(dev):
    """The same for the int8 tensor-core kernel's ring, at conv2-conv5,
    a stride of 3 and a long kernel."""
    import ctypes

    from repro_torch.kernels import _build
    fn = _build.function("conv1d", "conv1d_int8_tc_smem_bytes",
                         [ctypes.c_int] * 3)
    for k, stride, cout in ((7, 2, 64), (7, 1, 96), (9, 2, 192), (9, 1, 128),
                            (5, 3, 40), (31, 1, 96)):
        assert fn(k, stride, cout) == kc.int8_tc_smem_bytes(k, stride, cout)


# N 1, 5 (the head), 8 on the skinny kernel and 9 on the tiled one, at a
# ragged M, a K that is not a multiple of 4, and M past the old grid limit
# of 65,535 x 64 rows
@pytest.mark.parametrize("m,k,n", [
    (1001, 128, 1), (1001, 128, 5), (1001, 37, 5), (1001, 128, 8),
    (1001, 128, 9), (4_194_305, 16, 5), (4_194_305, 4, 9)])
def test_matmul_variants(dev, m, k, n):
    a = torch.randn((m, k), generator=_g(23)).to(dev)
    w = torch.randn((k, n), generator=_g(24)).to(dev)
    b = torch.randn((n,), generator=_g(25)).to(dev)
    before = (km.matmul.launches, km.matmul.skinny_launches)
    got = km.matmul(a, w, b, activation="relu")
    assert (km.matmul.launches, km.matmul.skinny_launches) == (
        before[0] + 1, before[1] + (n <= 8))
    torch.testing.assert_close(got, ref.matmul(a, w, b, activation="relu"),
                               rtol=TOL, atol=TOL)


def test_matmul_skinny_equals_tiled_bitwise(dev):
    """Both fp32 kernels sum each output's K products in ascending order
    through fmaf, so the head's logits keep their bits: the skinny
    kernel's N = 5 equals the first five columns the tiled kernel gives at
    N = 9 (the extra columns change no other column's sum)."""
    a = torch.randn((2000, 128), generator=_g(26)).to(dev)
    w = torch.randn((128, 9), generator=_g(27)).to(dev)
    b = torch.randn((9,), generator=_g(28)).to(dev)
    thin = km.matmul(a, w[:, :5].contiguous(), b[:5].contiguous())
    assert torch.equal(thin, km.matmul(a, w, b)[:, :5])


@pytest.mark.parametrize("p,m,band,local", [
    (1, 908, 908, False), (64, 2048, 64, True), (64, 2048, 64, False)])
def test_banded_align_past_shared_memory_bitwise(dev, p, m, band, local):
    rng = np.random.default_rng(m + local)
    q = rng.integers(1, 5, (p, m)).astype(np.int32)
    t = np.where(rng.random(q.shape) < 0.1, rng.integers(0, 5, q.shape),
                 q).astype(np.int32)
    q, t = U.t(q).to(dev), U.t(t).to(dev)
    kw = dict(band=band, local=local)
    before = (ke.banded_align.stripe_launches,
              ke.banded_align.scratch_launches)
    got = ke.banded_align(q, t, **kw)
    # stripes of 256 rows, their last rows handed on in shared memory
    assert (ke.banded_align.stripe_launches,
            ke.banded_align.scratch_launches) == (before[0] + 1, before[1])
    assert torch.equal(got, ref.banded_align(q, t, **kw))


@pytest.mark.parametrize("local", [False, True])
def test_banded_align_stripes_through_scratch_bitwise(dev, local):
    """Targets past 29,056 tokens: two pairs' stripe buffers no longer
    fit a block's shared memory and go through device scratch."""
    rng = np.random.default_rng(30_000 + local)
    q = rng.integers(1, 5, (3, 300)).astype(np.int32)
    t = rng.integers(0, 5, (3, 30_000)).astype(np.int32)
    t[1, 5000:5300] = q[1]                    # one pair aligns
    q, t = U.t(q).to(dev), U.t(t).to(dev)
    assert ke.plan(300, 30_000).handoff == "scratch"
    kw = dict(band=30_000 if local else 400, local=local)
    before = (ke.banded_align.stripe_launches,
              ke.banded_align.scratch_launches)
    got = ke.banded_align(q, t, **kw)
    assert (ke.banded_align.stripe_launches,
            ke.banded_align.scratch_launches) == (before[0] + 1,
                                                  before[1] + 1)
    assert torch.equal(got, ref.banded_align(q, t, **kw))


# The lane layouts around their edges: m = G R - 1, G R and G R + 1 (one
# row into a second stripe, or a wider group), and the m = 0 query.
@pytest.mark.parametrize("p,m,n,band,local", [
    (70, 47, 80, 32, True), (70, 49, 80, 32, False), (70, 255, 300, 300, True),
    (70, 256, 300, 16, False), (70, 257, 300, 300, True),
    (70, 257, 300, 20, False), (33, 11, 12, 12, False),
    (33, 13, 12, 12, True), (5, 0, 9, 4, False), (5, 0, 9, 4, True)])
def test_banded_align_lane_layouts_bitwise(dev, p, m, n, band, local):
    rng = np.random.default_rng(m * 3 + n + local)
    q = U.t(rng.integers(1, 5, (p, m)).astype(np.int32)).to(dev)
    t = U.t(rng.integers(0, 5, (p, n)).astype(np.int32)).to(dev)
    kw = dict(band=band, local=local)
    before = (ke.banded_align.launches, ke.banded_align.stripe_launches)
    got = ke.banded_align(q, t, **kw)
    assert (ke.banded_align.launches, ke.banded_align.stripe_launches) == (
        before[0] + 1, before[1] + (ke.plan(m, n).stripes > 1))
    assert torch.equal(got, ref.banded_align(q, t, **kw))


def test_levenshtein_past_shared_memory_bitwise(dev):
    rng = np.random.default_rng(1000)
    q = rng.integers(1, 5, (5, 1000)).astype(np.int32)
    t = np.where(rng.random(q.shape) < 0.2, rng.integers(1, 5, q.shape),
                 q).astype(np.int32)
    q, t = U.t(q).to(dev), U.t(t).to(dev)
    before = (ke.levenshtein.stripe_launches, ke.levenshtein.scratch_launches)
    got = ke.levenshtein(q, t)
    assert (ke.levenshtein.stripe_launches,
            ke.levenshtein.scratch_launches) == (before[0] + 1, before[1])
    assert torch.equal(got, ref.edit_distance(q, t))


def _plain_logits(cfg, params, rows, reset, conv):
    """The plain chain's logits for a fused tick's inputs."""
    rmask = reset > 0
    x = rows[..., None]
    for i, sp in enumerate(bc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = ref.matmul(x.reshape(b * t, c), p["w"][0], p["b"]).reshape(
                b, t, sp.cout)
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            x = ref.conv1d(torch.cat([carry, x], 1), p["w"], p["b"],
                           stride=sp.stride, activation=sp.activation)
    return x


# the paper CNN at a small tick and at the full tick's chunk: conv2-conv5
# on the tensor cores (3xTF32), conv1 and the head on the CUDA cores
@pytest.mark.parametrize("lanes,chunk", [(9, 64), (64, 256)])
def test_fused_kernel_equals_plain_and_unfused(dev, lanes, chunk):
    from repro_torch.core import ctc
    cfg = bc.BasecallerConfig()
    params = bc.init(_g(6), cfg, device=dev)
    rows = torch.randn((lanes, chunk), generator=_g(7)).to(dev)
    pads = torch.zeros((lanes, chunk // 4), device=dev)
    pads[3, 8:] = 1.0
    reset = torch.zeros((lanes,), device=dev)
    reset[[0, 4]] = 1.0
    conv = tuple(torch.randn((lanes, s.carry_rows, s.cin), generator=_g(8))
                 .abs().to(dev) for s in bc.stream_layer_specs(cfg))
    z = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    args = (rows, pads, reset, z + 2, z + 5, z + 1, conv, params)
    before = (kf.fused_stream_cuda.launches, kf.fused_stream_cuda.tc_launches,
              kf.fused_stream_cuda.tc_layers)
    tok, lens, lane = kf.fused_stream_cuda(*args, cfg=cfg)
    assert (kf.fused_stream_cuda.launches, kf.fused_stream_cuda.tc_launches,
            kf.fused_stream_cuda.tc_layers) == (
        before[0] + 1, before[1] + 1, before[2] + 4)
    ptok, plens, plane = kf._fused_reference(*args, cfg=cfg)
    # the plain logits' near ties (top-2 margin < 1e-4 on a real frame) may
    # flip a class; every other lane is equal
    top = torch.topk(_plain_logits(cfg, params, rows, reset, conv), 2).values
    tie = ((top[..., 0] - top[..., 1] < 1e-4) & (pads <= 0)).any(dim=1)
    if chunk == 64:     # no near tie here: every lane is held exactly
        assert not bool(tie.any())
    differ = (tok != ptok).any(dim=1) | (lens != plens)
    for key in ("prev_class", "bases", "ticks"):
        differ |= lane[key] != plane[key]
    assert not bool((differ & ~tie).any())
    for a, b in zip(lane["conv"], plane["conv"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    # the unfused kernels on the same inputs
    rmask = reset > 0
    x = rows[..., None]
    for i, sp in enumerate(bc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = km.matmul(x.reshape(b * t, c).contiguous(), p["w"][0],
                          p["b"]).reshape(b, t, sp.cout)
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            x = kc.conv1d(torch.cat([carry, x], 1).contiguous(), p["w"],
                          p["b"], stride=sp.stride, activation=sp.activation)
    utok, ulens, _ = ctc.greedy_decode_stream(x, torch.where(rmask, 0, z + 2),
                                              pads)
    assert not bool((((utok != tok).any(dim=1) | (ulens != lens))
                     & ~tie).any())


def test_fused_fp32_swizzled_layouts_at_ragged_chunk(dev):
    """A chunk whose tensor-core layers end mid-tile (t_out 34 and 17) and
    a narrow CNN whose swizzle masks are 3 and 1 (Cin 16 and 8): the plain
    version's tokens, carries within 1e-4."""
    cfg = bc.BasecallerConfig(kernels=(5, 5, 3, 1), channels=(8, 16, 24, 5),
                              strides=(1, 2, 2, 1))
    assert [kf.on_tensor_cores(sp) for sp in bc.stream_layer_specs(cfg)] == [
        False, True, True, False]
    params = bc.init(_g(9), cfg, device=dev)
    for chunk in (68, 64):
        lanes = 5
        rows = torch.randn((lanes, chunk), generator=_g(10)).to(dev)
        pads = torch.zeros((lanes, chunk // 4), device=dev)
        reset = torch.zeros((lanes,), device=dev)
        conv = tuple(torch.randn((lanes, s.carry_rows, s.cin),
                                 generator=_g(11)).abs().to(dev)
                     for s in bc.stream_layer_specs(cfg))
        z = torch.zeros((lanes,), dtype=torch.int32, device=dev)
        args = (rows, pads, reset, z, z, z, conv, params)
        tok, lens, lane = kf.fused_stream_cuda(*args, cfg=cfg)
        ptok, plens, plane = kf._fused_reference(*args, cfg=cfg)
        assert torch.equal(tok, ptok) and torch.equal(lens, plens)
        for a, b in zip(lane["conv"], plane["conv"]):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fault", ["overlap", "short"])
def test_fused_launcher_refuses_a_plan_the_kernel_cannot_use(
        dev, monkeypatch, fault):
    """The launcher holds smem_plan's offsets against the regions the
    kernel touches: an output laid over its input, or a class buffer past
    the block's shared memory, is refused before anything runs."""
    import dataclasses
    cfg = bc.BasecallerConfig()
    sound = kf.smem_plan

    def bad(*a, **kw):
        plan = sound(*a, **kw)
        if fault == "short":
            return dataclasses.replace(plan, bytes=plan.bytes - 4)
        layers = list(plan.layers)
        layers[2] = dataclasses.replace(layers[2], out_off=layers[2].in_off)
        return dataclasses.replace(plan, layers=tuple(layers))

    params = bc.init(_g(12), cfg, device=dev)
    lanes, chunk = 2, 256
    conv = tuple(torch.zeros((lanes, s.carry_rows, s.cin), device=dev)
                 for s in bc.stream_layer_specs(cfg))
    z = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    args = (torch.randn((lanes, chunk), generator=_g(13)).to(dev),
            torch.zeros((lanes, chunk // 4), device=dev),
            torch.zeros((lanes,), device=dev), z, z, z, conv, params)
    kf.fused_stream_cuda(*args, cfg=cfg)
    kf._launch_meta.cache_clear()
    monkeypatch.setattr(kf, "smem_plan", bad)
    try:
        with pytest.raises(RuntimeError, match="launch_fused_stream"):
            kf.fused_stream_cuda(*args, cfg=cfg)
    finally:
        kf._launch_meta.cache_clear()


def test_step_flowcell_goldens_on_card_equal_cpu(dev):
    import repro_torch.engine as te
    from repro_torch.data import genome as G
    from repro_torch.realtime import Decision, PolicyConfig

    def run(device, fused):
        eng = te.build(
            "adaptive_sampling", channels=8, chunk=64,
            reference=G.random_genome(np.random.default_rng(7), 6_000),
            targets=[(0, 3_000)],
            flowcell={"encoder": "step", "n_reads": 24, "read_len": (64, 128),
                      "recovery_samples": 64, "stagger_samples": 16,
                      "seed": 3},
            policy=PolicyConfig(min_prefix_bases=24, map_prefix_bases=32,
                                max_prefix_bases=96,
                                timeout_decision=Decision.ACCEPT,
                                eject_latency_samples=32),
            device=device, pipeline_depth=2, fused=fused)
        eng.drain()
        return sorted((r.read_id, r.decision.value, r.reason,
                       r.bases_at_decision, r.mapped_pos)
                      for r in eng.records)

    want = run("cpu", False)
    assert len(want) == 24
    assert run(dev, False) == want
    assert run(dev, True) == want


# ------------------------------------------------------------------ int8 ---
def _int8(shape, seed, dev):
    return torch.randint(-127, 128, shape, generator=_g(seed),
                         dtype=torch.int8).to(dev)


@pytest.mark.parametrize("cin,cout,k,stride,t", [
    (1, 64, 5, 1, 260),      # conv1: scalar path, 4-channel tile
    (64, 96, 7, 1, 70),      # the tensor cores
    (96, 192, 9, 2, 135),    # the tensor cores, strided
    (8, 70, 5, 1, 61),       # packed dp4a, Cout % 4 != 0: 1-channel tile
    (1, 5, 2, 2, 63),        # the step codec's conv1
    (6, 12, 9, 2, 61)])      # Cin % 4 != 0: scalar path
def test_conv1d_int8_kernel_bitwise(dev, cin, cout, k, stride, t):
    x, w = _int8((5, t, cin), 10, dev), _int8((k, cin, cout), 11, dev)
    before = (kc.conv1d_int8.launches, kc.conv1d_int8.tc_launches)
    got = kc.conv1d_int8(x, w, stride=stride)
    assert (kc.conv1d_int8.launches, kc.conv1d_int8.tc_launches) == (
        before[0] + 1,
        before[1] + kc.int8_tensor_core_shape(cin, cout, k, stride))
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.conv1d_int8(x, w, stride=stride))


@pytest.mark.parametrize("b,cin,t", [(2, 2048, 200), (2, 2047, 200),
                                     (65_537, 8, 20)])
def test_conv1d_int8_past_old_limits_bitwise(dev, b, cin, t):
    """Cin past one staged slice (K 9, stride 2), packed (2048) and scalar
    (2047) weights, and a batch past the old 65,535 grid limit."""
    x, w = _int8((b, t, cin), 14, dev), _int8((9, cin, 64), 15, dev)
    assert torch.equal(kc.conv1d_int8(x, w, stride=2),
                       ref.conv1d_int8(x, w, stride=2))


# The tensor-core int8 conv: Cin 32-192, Cout 8-192 (one n-tile, a block
# of 32 channels with a masked half, 64, 96), K 1-9, strides 1-3, ragged
# T_out (sub-tiles of 64 frames cut short).
@pytest.mark.parametrize("cin,cout,k,stride,t", [
    (32, 8, 1, 1, 50), (64, 64, 7, 2, 262), (64, 96, 7, 1, 134),
    (96, 192, 9, 2, 136), (192, 128, 9, 1, 72), (32, 40, 5, 2, 97),
    (96, 64, 5, 1, 64), (192, 96, 9, 2, 301), (64, 128, 1, 2, 77),
    (64, 40, 5, 3, 50)])
def test_conv1d_int8_tensor_cores_bitwise(dev, cin, cout, k, stride, t):
    x, w = _int8((5, t, cin), 16, dev), _int8((k, cin, cout), 17, dev)
    assert kc.int8_tensor_core_shape(cin, cout, k, stride)
    before = (kc.conv1d_int8.launches, kc.conv1d_int8.tc_launches)
    got = kc.conv1d_int8(x, w, stride=stride, w_fragments=pack_fragments(w))
    assert (kc.conv1d_int8.launches, kc.conv1d_int8.tc_launches) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(got, ref.conv1d_int8(x, w, stride=stride))


@pytest.mark.parametrize("b,cin,t", [(65_537, 32, 20), (2, 2048, 200)])
def test_conv1d_int8_tensor_cores_past_old_limits_bitwise(dev, b, cin, t):
    """A batch past 65,535 rows and Cin 2,048 (K 9, stride 2) on the
    tensor cores: sub-tiles ride the grid's x, the ring holds a slice."""
    x, w = _int8((b, t, cin), 18, dev), _int8((9, cin, 64), 19, dev)
    before = kc.conv1d_int8.tc_launches
    got = kc.conv1d_int8(x, w, stride=2)
    assert kc.conv1d_int8.tc_launches == before + 1
    assert torch.equal(got, ref.conv1d_int8(x, w, stride=2))


@pytest.mark.parametrize("m,k,n", [(1000, 37, 5), (300, 128, 128),
                                   (65, 5, 5), (64 * 128, 128, 5)])
def test_matmul_int8_kernel_bitwise(dev, m, k, n):
    a, b = _int8((m, k), 12, dev), _int8((k, n), 13, dev)
    before = (km.matmul_int8.launches, km.matmul_int8.skinny_launches)
    got = km.matmul_int8(a, b)
    assert (km.matmul_int8.launches, km.matmul_int8.skinny_launches) == (
        before[0] + 1, before[1] + (n <= 8))
    assert torch.equal(got, ref.matmul_int8(a, b))


# N 1..8 on the skinny kernel: K 128 (16-byte loads), 37 (a ragged tail,
# byte loads), 1, 4 (4-byte loads); each equal to the plain version and to
# the first N columns of the tiled kernel at N = 9
@pytest.mark.parametrize("k", [128, 37, 1, 4])
def test_matmul_int8_skinny_equals_tiled_bitwise(dev, k):
    a, b9 = _int8((1001, k), 16, dev), _int8((k, 9), 17, dev)
    tiled = km.matmul_int8(a, b9)
    for n in range(1, 9):
        b = b9[:, :n].contiguous()
        before = km.matmul_int8.skinny_launches
        got = km.matmul_int8(a, b)
        assert km.matmul_int8.skinny_launches == before + 1
        assert torch.equal(got, ref.matmul_int8(a, b))
        assert torch.equal(got, tiled[:, :n])


def test_matmul_int8_skinny_unaligned_base_bitwise(dev):
    """A starting one byte past a 16-byte boundary, K 128 and 64: the rows
    are not 16-byte aligned, so the kernel takes narrower loads."""
    for k in (128, 64):
        a = _int8((777 * k + 1,), 18, dev)[1:].view(777, k)
        assert a.data_ptr() % 16
        b = _int8((k, 5), 19, dev)
        assert torch.equal(km.matmul_int8(a, b), ref.matmul_int8(a, b))


@pytest.mark.parametrize("n", [5, 64])
def test_matmul_int8_past_old_grid_limit_bitwise(dev, n):
    """M = 4,194,305: past 65,535 x 64 rows, the tiled kernel's old grid
    y limit (N 64), and on the skinny kernel (N 5)."""
    a, b = _int8((4_194_305, 128), 20, dev), _int8((128, n), 21, dev)
    assert torch.equal(km.matmul_int8(a, b), ref.matmul_int8(a, b))


def _quantized_paper_cnn(dev):
    from repro_torch.engine.base import quantize_edge_params
    cfg = bc.BasecallerConfig()
    params = bc.init(_g(6), cfg, device=dev)
    for layer in params.values():
        layer["b"] = 0.1 * torch.randn(layer["b"].shape,
                                       generator=_g(14)).to(dev)
    return cfg, quantize_edge_params(params, cfg, chunk=512)


def test_fused_int8_kernel_equals_plain_and_unfused(dev):
    from repro_torch.core import ctc
    from repro_torch.kernels import ops
    cfg, params = _quantized_paper_cnn(dev)
    lanes, chunk = 9, 64
    rows = torch.randn((lanes, chunk), generator=_g(7)).to(dev)
    pads = torch.zeros((lanes, chunk // 4), device=dev)
    pads[3, 8:] = 1.0
    reset = torch.zeros((lanes,), device=dev)
    reset[[0, 4]] = 1.0
    conv = tuple(torch.randn((lanes, s.carry_rows, s.cin), generator=_g(8))
                 .abs().to(dev) for s in bc.stream_layer_specs(cfg))
    z = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    args = (rows, pads, reset, z + 2, z + 5, z + 1, conv, params)
    before = (kf.fused_stream_cuda.launches_int8,
              kf.fused_stream_cuda.tc_launches_int8,
              kf.fused_stream_cuda.tc_layers_int8)
    tok, lens, lane = kf.fused_stream_cuda(*args, cfg=cfg)
    # conv2-conv5 on the tensor cores (mma.sync s8)
    assert (kf.fused_stream_cuda.launches_int8,
            kf.fused_stream_cuda.tc_launches_int8,
            kf.fused_stream_cuda.tc_layers_int8) == (
        before[0] + 1, before[1] + 1, before[2] + 4)
    ptok, plens, plane = kf._fused_reference(*args, cfg=cfg)
    assert torch.equal(tok, ptok) and torch.equal(lens, plens)
    for key in ("prev_class", "bases", "ticks"):
        assert torch.equal(lane[key], plane[key])
    for a, b in zip(lane["conv"], plane["conv"]):
        assert torch.equal(a, b)
    # the unfused int8 kernels on the same inputs
    rmask = reset > 0
    x = rows[..., None]
    for i, sp in enumerate(bc.stream_layer_specs(cfg)):
        p = params[sp.name]
        if sp.is_head:
            b, t, c = x.shape
            x = ops.mat_mul(x.reshape(b * t, c), p["w"].head_matrix(),
                            p["b"]).reshape(b, t, sp.cout)
        else:
            carry = torch.where(rmask[:, None, None], 0.0, conv[i])
            x = ops.conv1d(torch.cat([carry, x], 1), p["w"], p["b"],
                           stride=sp.stride, padding="valid",
                           activation=sp.activation)
    utok, ulens, _ = ctc.greedy_decode_stream(
        x, torch.where(rmask, 0, z + 2), pads)
    assert torch.equal(tok, utok) and torch.equal(lens, ulens)


@pytest.mark.parametrize("chunk", [200, 260])
def test_fused_int8_tensor_cores_at_ragged_chunk(dev, chunk):
    """Chunks whose int8 tensor-core layers end mid-tile (conv2's t_out
    100 and 130, conv4's 50 and 65): tokens, counters and carries equal
    the plain version bit for bit, the logits the unfused int8 kernels'."""
    from repro_torch.kernels import ops
    cfg, params = _quantized_paper_cnn(dev)
    lanes = 5
    rows = torch.randn((lanes, chunk), generator=_g(15)).to(dev)
    pads = torch.zeros((lanes, chunk // 4), device=dev)
    reset = torch.zeros((lanes,), device=dev)
    reset[2] = 1.0
    conv = tuple(torch.randn((lanes, s.carry_rows, s.cin), generator=_g(16))
                 .abs().to(dev) for s in bc.stream_layer_specs(cfg))
    z = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    args = (rows, pads, reset, z + 1, z + 3, z, conv, params)
    before = kf.fused_stream_cuda.tc_layers_int8
    tok, lens, lane = kf.fused_stream_cuda(*args, cfg=cfg)
    assert kf.fused_stream_cuda.tc_layers_int8 == before + 4
    ptok, plens, plane = kf._fused_reference(*args, cfg=cfg)
    assert torch.equal(tok, ptok) and torch.equal(lens, plens)
    for key in ("prev_class", "bases", "ticks"):
        assert torch.equal(lane[key], plane[key])
    for a, b in zip(lane["conv"], plane["conv"]):
        assert torch.equal(a, b)
    # every layer's output (the next carry's source) is the unfused int8
    # kernels': the fused carries equal their inputs' last rows
    rmask = reset > 0
    x = rows[..., None]
    for i, sp in enumerate(bc.stream_layer_specs(cfg)):
        if sp.is_head:
            break
        p = params[sp.name]
        carry = torch.where(rmask[:, None, None], 0.0, conv[i])
        xin = torch.cat([carry, x], 1)
        assert torch.equal(lane["conv"][i], xin[:, xin.shape[1]
                                                - sp.carry_rows:])
        x = ops.conv1d(xin, p["w"], p["b"], stride=sp.stride,
                       padding="valid", activation=sp.activation)


def test_edge_int8_basecall_on_card_equals_cpu(dev):
    import repro_torch.engine as te
    cfg, params = _quantized_paper_cnn(dev)
    sig = np.random.default_rng(3).standard_normal((5, 700)).astype(
        np.float32)
    reads = {}
    for device in ("cpu", dev):
        eng = te.build("basecall", preset="edge_int8", cfg=cfg,
                       params=bc.params_to(params, device), device=device,
                       batch=4, chunk=700)
        reads[str(device)] = eng.serve(sig)
    for a, b in zip(*reads.values()):
        np.testing.assert_array_equal(a, b)


# -------------------------------------------------------- genomics slice ---
@pytest.mark.parametrize("p,m,n", [(300, 12, 12), (300, 7, 13),
                                   (300, 40, 25), (6144, 12, 12)])
def test_levenshtein_kernel_bitwise(dev, p, m, n):
    rng = np.random.default_rng(m * n)
    q = U.t(rng.integers(1, 5, (p, m)).astype(np.int32)).to(dev)
    t = U.t(rng.integers(1, 5, (p, n)).astype(np.int32)).to(dev)
    before = ke.levenshtein.launches
    got = ke.levenshtein(q, t)
    assert ke.levenshtein.launches == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.edit_distance(q, t))


def test_banded_align_firehose_shape_bitwise(dev):
    """The pathogen panel compare: reads of 256 against 512-base windows,
    local, band 512 (32 lanes x 8 rows a pair, one stripe)."""
    rng = np.random.default_rng(4)
    q = rng.integers(1, 5, (96, 256)).astype(np.int32)
    t = rng.integers(0, 5, (96, 512)).astype(np.int32)
    t[::2, 100:356] = q[::2]                  # half the pairs align
    q[5, 200:] = -1                           # a read's padded tail
    q, t = U.t(q).to(dev), U.t(t).to(dev)
    kw = dict(band=512, local=True)
    assert torch.equal(ke.banded_align(q, t, **kw),
                       ref.banded_align(q, t, **kw))


def test_pathogen_pipeline_on_card_equals_cpu(dev):
    """The small-CNN engine on the card and on the CPU: edge_int8 reads
    equal, and detect (ed and fm) equal on the reads of a known panel."""
    import repro_torch.engine as te
    from repro_torch.core import pathogen
    from repro_torch.core import pipeline
    from repro_torch.data import genome as G
    from repro_torch.engine.base import quantize_edge_params
    cfg = bc.BasecallerConfig(kernels=(3, 3, 1), channels=(16, 16, 5),
                              strides=(1, 2, 1))
    # calibrated once, on the CPU: both engines serve the same int8 params
    params = quantize_edge_params(bc.init(_g(0), cfg, device="cpu"), cfg)
    rng = np.random.default_rng(7)
    chunks = [rng.normal(size=(4, 512)).astype(np.float32) for _ in range(3)]
    panel = pathogen.Panel.build({"a": G.random_genome(rng, 2000),
                                  "b": G.random_genome(rng, 1500)})
    reads, _ = G.sample_reads(rng, panel.genomes[0], n_reads=12,
                              read_len=96, error_rate=0.03)
    barcodes = rng.integers(1, 5, (5, 12)).astype(np.int32)
    out = {}
    for device in ("cpu", dev):
        eng = te.build("pathogen_pipeline", preset="edge_int8", cfg=cfg,
                       params=params, device=device, panel=panel,
                       detect_cfg=pathogen.DetectConfig(window=128))
        for c in chunks:
            eng.submit(c)
        eng.drain()
        reps = [pathogen.detect(panel, reads, pathogen.DetectConfig(
            window=128), mode=mode, read_lens=np.full(12, 90),
            device=device) for mode in ("ed", "fm")]
        out[str(device)] = (list(eng.outputs), eng.detect(64), reps,
                            pipeline.demux_reads(reads, barcodes,
                                                 device=device))
    cpu, card = out["cpu"], out[str(dev)]
    for (a, la), (b, lb) in zip(cpu[0], card[0]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    for a, b in zip([cpu[1], *cpu[2]], [card[1], *card[2]]):
        assert a.counts == b.counts
        np.testing.assert_array_equal(a.read_assignment, b.read_assignment)
        np.testing.assert_array_equal(a.read_scores, b.read_scores)
    assert cpu[2][0].present["a"] and not cpu[2][0].present["b"]
    np.testing.assert_array_equal(cpu[3], card[3])


def test_variant_caller_on_card_within_tol(dev):
    from repro_torch.core import variant_caller as vc
    cfg = vc.CallerConfig()
    params = vc.init(_g(1), cfg, device=dev)
    wins = torch.rand((40, cfg.window, vc.N_FEATURES), generator=_g(2))
    before = kc.conv1d.launches
    gt, alt = vc.apply(params, wins.to(dev), cfg)
    assert kc.conv1d.launches == before + 2
    cpu = {k: {kk: vv.cpu() for kk, vv in v.items()}
           for k, v in params.items()}
    pgt, palt = vc.apply(cpu, wins, cfg)
    torch.testing.assert_close(gt.cpu(), pgt, rtol=TOL, atol=TOL)
    torch.testing.assert_close(alt.cpu(), palt, rtol=TOL, atol=TOL)


# ----------------------------------------------------------- LM prefill ---
def assert_flash_close(got, want, abs_attn):
    """2^-7 |want| (the output's two roundings to bf16) plus 2^-8 of the
    plain attention of |v|: twice the most that rounding P to bf16 before
    PV moves an output (chip_smoke.flash_excess)."""
    g, w = got.float(), want.float()
    bar = 2.0 ** -7 * w.abs() + 2.0 ** -8 * abs_attn.float() + 1e-30
    excess = ((g - w).abs() / bar).max().item()
    assert excess <= 1.0, (f"max |err| {(g - w).abs().max().item()} is "
                           f"{excess} x the bar")


def _bf16(shape, seed, dev, scale=1.0):
    return (torch.randn(shape, generator=_g(seed)) * scale).to(
        torch.bfloat16).to(dev)


@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 4, 2, 100, 100, 128, True),     # ragged S, GQA
    (2, 4, 4, 64, 64, 64, False),
    (1, 4, 2, 32, 160, 128, True),      # Sq < Skv: last-token alignment
    (1, 8, 2, 257, 257, 32, True),
    (1, 2, 1, 70, 90, 16, False),
    # the wgmma kernel's edges: one row past a 128-row tile, the path's
    # length, GQA 32/8, Sq < Skv across key tiles, the narrow head dims
    (1, 4, 2, 129, 129, 128, True),
    (1, 4, 2, 4096, 4096, 128, True),
    (1, 32, 8, 1000, 1000, 128, True),
    (1, 4, 2, 32, 300, 128, True),
    (1, 4, 2, 300, 300, 16, True),
    (1, 4, 2, 300, 300, 32, True),
    (1, 4, 2, 300, 300, 64, True)])
def test_flash_attention_kernel(dev, b, hq, hkv, sq, skv, d, causal):
    from repro_torch.kernels import flash_attention as kfa
    q = _bf16((b, hq, sq, d), 20, dev)
    k = _bf16((b, hkv, skv, d), 21, dev)
    v = _bf16((b, hkv, skv, d), 22, dev)
    before = kfa.flash_attention.launches
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert kfa.flash_attention.launches == before + 1
    want = ref.attention(q, k, v, causal=causal)
    assert_flash_close(got, want, ref.attention(q, k, v.abs(), causal=causal))


def _ssd_inputs(bh, t, ds, dh, dtype, dev, seed=30):
    x = (torch.randn((bh, t, dh), generator=_g(seed)) * 0.5)
    la = -torch.nn.functional.softplus(torch.randn((bh, t),
                                                   generator=_g(seed + 1)))
    b = torch.randn((bh, t, ds), generator=_g(seed + 2)) * 0.3
    c = torch.randn((bh, t, ds), generator=_g(seed + 3)) * 0.3
    return (x.to(dtype).to(dev), la.to(dev), b.to(dtype).to(dev),
            c.to(dtype).to(dev))


@pytest.mark.parametrize("bh,t,ds,dh,chunk", [
    (3, 100, 128, 64, 256),     # ragged T inside one chunk
    (2, 300, 128, 64, 64),      # five chunks, the last ragged
    (4, 512, 128, 64, 256),     # two full chunks (the parity run's shape)
    (3, 100, 32, 16, 32),       # chunk rounded up to the 64-row tile
    (2, 64, 16, 16, 32)])
def test_ssd_scan_kernel_f32(dev, bh, t, ds, dh, chunk):
    from repro_torch.kernels import ssd_scan as kssd
    args = _ssd_inputs(bh, t, ds, dh, torch.float32, dev)
    before = kssd.ssd_scan.launches
    got = kssd.ssd_scan(*args, chunk=chunk)
    assert kssd.ssd_scan.launches == before + 1
    want = ref.ssd_scan(*args)[0]
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("ds,dh", [(32, 16), (16, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_small_dims_broadcast_bc(dev, ds, dh, dtype):
    """The small (ds, dh) of ``DIMS`` with B/C one row over every head (head
    stride 0) and a ragged last chunk: within the f32 bar (bf16 plus one
    bf16 ulp of each element)."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, b, c = _ssd_inputs(5, 150, ds, dh, dtype, dev, seed=34)
    b = b[:1].expand(5, 150, ds)
    c = c[:1].expand(5, 150, ds)
    got = kssd.ssd_scan(x, la, b, c, chunk=64)
    want = ref.ssd_scan(x, la, b, c)[0]
    assert got.dtype == dtype
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=2e-4)


def test_ssd_scan_kernel_bf16_broadcast_bc(dev):
    """bf16 x/b/c with B/C broadcast over heads (a stride-0 view, as
    mamba_block passes them at batch 1): y within the f32 bar plus one
    bf16 ulp of each element (rounded once from differently ordered f32
    sums)."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, b, c = _ssd_inputs(6, 300, 128, 64, torch.bfloat16, dev)
    b = b[:1].expand(6, 300, 128)
    c = c[:1].expand(6, 300, 128)
    got = kssd.ssd_scan(x, la, b, c, chunk=256)
    want = ref.ssd_scan(x, la, b, c)[0]
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=2e-4)


@pytest.mark.parametrize("m,k,n,act,bias", [
    (300, 200, 260, "silu", False), (300, 200, 260, "none", True),
    (65, 37, 45, "none", False),        # K, N no multiple of 8
    (512, 2560, 1024, "silu", False),
    # the wgmma kernel's edges: M and N ragged to the 128 x 256 tile (but
    # 8-aligned), K no multiple of the 64-wide stage, the down GEMM's
    # width, one tile, every activation with a bias
    (200, 264, 392, "none", True), (300, 200, 256, "relu", False),
    (1024, 9728, 2560, "none", False), (64, 64, 256, "gelu", True),
    (256, 512, 264, "squared_relu", True), (130, 136, 520, "silu", True),
    (64, 0, 64, "relu", True)])         # K = 0: the bias alone, mma.sync
def test_matmul_bf16_kernel(dev, m, k, n, act, bias):
    """The wgmma kernel where TMA can address the operands (counted in
    ``wgmma_launches`` too), the mma.sync kernel elsewhere."""
    a, w = _bf16((m, k), 40, dev), _bf16((k, n), 41, dev)
    bv = _bf16((n,), 42, dev) if bias else None
    before = (km.matmul_bf16.launches, km.matmul_bf16.wgmma_launches)
    got = km.matmul_bf16(a, w, bv, activation=act)
    wgmma = int(k > 0 and k % 8 == 0 and n % 8 == 0)
    assert (km.matmul_bf16.launches, km.matmul_bf16.wgmma_launches) == (
        before[0] + 1, before[1] + wgmma)
    want = ref.matmul(a, w, bv, activation=act)
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp


def test_matmul_bf16_unaligned_base_runs_mma_sync(dev):
    """An aligned shape whose operand starts off a 16-byte boundary: TMA
    cannot address it, so the mma.sync kernel runs (and is right)."""
    a = _bf16((64 * 256 + 1,), 43, dev)[1:].view(64, 256)
    w = _bf16((256, 512), 44, dev)
    before = (km.matmul_bf16.launches, km.matmul_bf16.wgmma_launches)
    got = km.matmul_bf16(a, w)
    assert (km.matmul_bf16.launches, km.matmul_bf16.wgmma_launches) == (
        before[0] + 1, before[1])
    want = ref.matmul(a, w)
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp


_INT8_ROUTES = ("launches", "skinny_launches", "narrow_launches",
                "tc_launches")


# decode (M <= 16) on the narrow-M kernel: qwen3-4b's projections, a TP 2
# rank's, ragged to the 128-column tile and to the 32-deep step; M > 16 on
# the tiled tensor-core kernel, ragged in M, N and K; the rest on dp4a
@pytest.mark.parametrize("m,k,n,route", [
    (1, 2560, 1024, "narrow"), (8, 2560, 4096, "narrow"),
    (16, 9728, 2560, "narrow"), (8, 4864, 2560, "narrow"),
    (8, 2560, 512, "narrow"), (8, 2576, 1008, "narrow"),
    (5, 48, 16, "narrow"), (13, 4096, 2560, "narrow"),
    (17, 2560, 1024, "tc"), (32, 9728, 2560, "tc"),
    (300, 2576, 1008, "tc"), (4096, 128, 256, "tc"),
    (8, 2561, 1003, "dp4a"), (64, 2560, 1000, "dp4a")])
def test_matmul_int8_routes_bitwise(dev, m, k, n, route):
    a, b = _int8((m, k), 22, dev), _int8((k, n), 23, dev)
    assert km.route_int8(m, n, k, a.data_ptr(), b.data_ptr()) == route
    before = [getattr(km.matmul_int8, c) for c in _INT8_ROUTES]
    got = km.matmul_int8(a, b)
    ran = [getattr(km.matmul_int8, c) - v
           for c, v in zip(_INT8_ROUTES, before)]
    assert ran == [1, 0, int(route == "narrow"), int(route == "tc")]
    assert torch.equal(got, ref.matmul_int8(a, b))


def test_matmul_int8_narrow_split_rows_and_repeats_bitwise(dev):
    """The K-split partials sum exactly: a row alone equals its row in a
    call of 8 and of 16, and a second call the first, bit for bit."""
    a, b = _int8((16, 9728), 24, dev), _int8((9728, 2560), 25, dev)
    full = km.matmul_int8(a, b)
    assert torch.equal(full, km.matmul_int8(a, b))
    assert torch.equal(full[:8], km.matmul_int8(a[:8].contiguous(), b))
    for r in (0, 7, 15):
        assert torch.equal(full[r:r + 1],
                           km.matmul_int8(a[r:r + 1].contiguous(), b))


@pytest.mark.parametrize("m,k,n,act,bias", [
    (1, 2560, 9728, "silu", False), (8, 2560, 9728, "none", False),
    (8, 9728, 2560, "none", False), (16, 2560, 9728, "silu", True),
    (5, 200, 264, "gelu", True),        # ragged to the tile and the step
    (3, 64, 8, "relu", False), (12, 136, 520, "squared_relu", True)])
def test_matmul_bf16_narrow_within_one_ulp(dev, m, k, n, act, bias):
    """M <= 16 where TMA could address the operands: the narrow-M kernel
    (counted in ``narrow_launches``), within one bf16 ulp of max |out|."""
    a, w = _bf16((m, k), 45, dev), _bf16((k, n), 46, dev, scale=k ** -0.5)
    bv = _bf16((n,), 47, dev) if bias else None
    before = (km.matmul_bf16.launches, km.matmul_bf16.narrow_launches,
              km.matmul_bf16.wgmma_launches)
    got = km.matmul_bf16(a, w, bv, activation=act)
    assert (km.matmul_bf16.launches, km.matmul_bf16.narrow_launches,
            km.matmul_bf16.wgmma_launches) == (before[0] + 1, before[1] + 1,
                                               before[2])
    want = ref.matmul(a, w, bv, activation=act)
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp


@pytest.mark.parametrize("k,n", [(2560, 9728), (9728, 2560)])
def test_matmul_bf16_narrow_row_alone_equals_batch(dev, k, n):
    """The K split is a function of N and K only and the f32 partials add
    in a fixed order: a row alone equals its row in a batch of 8 (and of
    16), and a second call the first, bit for bit."""
    a, w = _bf16((16, k), 48, dev), _bf16((k, n), 49, dev, scale=k ** -0.5)
    batch = km.matmul_bf16(a[:8].contiguous(), w, activation="silu")
    assert torch.equal(batch, km.matmul_bf16(a[:8].contiguous(), w,
                                             activation="silu"))
    sixteen = km.matmul_bf16(a, w, activation="silu")
    assert torch.equal(sixteen[:8], batch)
    for r in range(8):
        alone = km.matmul_bf16(a[r:r + 1].contiguous(), w, activation="silu")
        assert torch.equal(alone, batch[r:r + 1])


def test_new_kernels_raise_on_the_wrong_cuda_type(dev):
    """A CUDA tensor of a type the kernel does not take raises; it never
    runs the plain version."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kssd
    q = torch.randn((1, 2, 16, 64), device=dev)
    launches = (kfa.flash_attention.launches, km.matmul_bf16.launches,
                kssd.ssd_scan.launches)
    with pytest.raises(TypeError):      # float32/bf16/f16 only
        kfa.flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        km.matmul_bf16(q[0, 0].half(), q[0, 0].T.half().contiguous())
    x, la, b, c = _ssd_inputs(2, 64, 128, 64, torch.float16, dev)
    with pytest.raises(TypeError):
        kssd.ssd_scan(x, la, b, c)
    assert launches == (kfa.flash_attention.launches,
                        km.matmul_bf16.launches, kssd.ssd_scan.launches)


def test_matmul_bf16_mma_sync_past_old_grid_limit(dev):
    """M = 8,388,481 with K = 12 (TMA cannot address it: the mma.sync
    kernel), past its old grid y limit of 65,535 tiles of 128 rows."""
    a, w = _bf16((8_388_481, 12), 45, dev), _bf16((12, 8), 46, dev)
    before = km.matmul_bf16.wgmma_launches
    got = km.matmul_bf16(a, w)
    assert km.matmul_bf16.wgmma_launches == before
    want = ref.matmul(a, w)
    ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
    assert float((got.float() - want.float()).abs().max()) <= ulp


def test_flash_attention_past_old_grid_limit(dev):
    """Sq = 8,388,481 query rows (past 65,535 tiles of 128) against 128
    keys, not causal: the first, middle and last 512 rows against the
    plain attention."""
    from repro_torch.kernels import flash_attention as kfa
    sq = 8_388_481
    q = _bf16((1, 1, sq, 64), 47, dev)
    k, v = _bf16((1, 1, 128, 64), 48, dev), _bf16((1, 1, 128, 64), 49, dev)
    got = kfa.flash_attention(q, k, v, causal=False)
    for a in (0, sq // 2 - 256, sq - 512):
        qq = q[:, :, a:a + 512]
        assert_flash_close(got[:, :, a:a + 512],
                           ref.attention(qq, k, v, causal=False),
                           ref.attention(qq, k, v.abs(), causal=False))


def test_ssd_scan_past_old_grid_limit(dev):
    """B * H = 65,536 heads (past the old grid y limit of 65,535), T 64,
    (ds, dh) = (16, 16), chunk 32: the first, middle and last 512 heads
    against the plain recurrence (heads are independent, so a slice of
    the inputs is exact)."""
    from repro_torch.kernels import ssd_scan as kssd
    bh = 65_536
    args = _ssd_inputs(bh, 64, 16, 16, torch.float32, dev)
    got = kssd.ssd_scan(*args, chunk=32)
    for a in (0, bh // 2 - 256, bh - 512):
        want = ref.ssd_scan(*(t[a:a + 512] for t in args))[0]
        torch.testing.assert_close(got[a:a + 512], want, rtol=2e-4,
                                   atol=2e-4)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_smoke_prefill_on_card_equals_cpu(dev, arch, batch):
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kssd
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = ARCHS[arch].smoke_config()
    params, _ = transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (batch, 100))
    want = steps.prefill(params, tok, cfg, device="cpu").float()
    counts = (kfa.flash_attention.launches, km.matmul_bf16.launches,
              kssd.ssd_scan.launches)
    got = steps.prefill(bc.params_to(params, dev), tok, cfg, device=dev)
    after = (kfa.flash_attention.launches, km.matmul_bf16.launches,
             kssd.ssd_scan.launches)
    launched = [b - a for a, b in zip(counts, after)]
    assert launched == ([4, 12, 0] if arch == "qwen3-4b" else [0, 0, 4])
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got.float().cpu() - want).abs().max()) <= 2 * ulp


def _edge_int8_step_engine(device, flowcell_seed=3):
    """A depth-2 ``edge_int8`` step-codec flowcell (the field device's
    engine) on ``device``."""
    import repro_torch.engine as te
    from repro_torch.data import genome as G
    from repro_torch.field.device import calibrated_step_params
    cfg, qparams = calibrated_step_params(128, seed=0, device=device)
    ref_genome = G.random_genome(np.random.default_rng(7), 6_000)
    return te.build(
        "adaptive_sampling", "edge_int8", params=qparams, cfg=cfg,
        reference=ref_genome, targets=[(0, 3_000)], channels=8, chunk=128,
        flowcell={"encoder": "step", "n_reads": 24, "read_len": (96, 160),
                  "seed": flowcell_seed},
        pipeline_depth=2, device=device)


def _golden(engine):
    return sorted((r.read_id, r.decision.value, r.reason,
                   r.bases_at_decision, r.mapped_pos) for r in engine.records)


def test_yield_mesh_leaves_nothing_pending_and_changes_no_decision(dev):
    plain = _edge_int8_step_engine("cuda")
    plain.drain()
    yielding = _edge_int8_step_engine("cuda")
    ticks = 0
    while yielding.step():
        yielding.suspend_tick()
        p = yielding.runtime._pending
        if p is not None:
            assert p["event"].query()       # the tick in flight is done
        ticks += 1
    yielding.flush()
    assert yielding.runtime.fused
    assert ticks > 2
    assert yielding.telemetry.counters["mesh_yields_inflight"] > 0
    assert _golden(yielding) == _golden(plain)
    assert len(_golden(plain)) == 24


def test_two_tenant_fleet_on_card_equals_solo_runs(dev):
    from repro_torch.fleet import Fleet
    from repro_torch.data.flowcell import step_encode
    solo = _edge_int8_step_engine("cuda")
    solo.drain()
    rng = np.random.default_rng(5)
    rows = [step_encode(rng.integers(1, 5, 512)) for _ in range(20)]
    import repro_torch.engine as te
    solo_bc = te.build("basecall", "default", seed=0)
    for r in rows:
        solo_bc.submit(r)
    solo_bc.drain()
    fleet = Fleet()
    fc = fleet.attach("fc", _edge_int8_step_engine("cuda"), weight=2.0)
    bc = fleet.add_tenant("bc", "basecall", "default", seed=0)
    for r in rows:
        assert bc.submit(r)
    fleet.drain()
    assert _golden(fc.engine) == _golden(solo)
    assert len(bc.outputs) == 20
    for got, want in zip(bc.outputs, solo_bc.reads):
        np.testing.assert_array_equal(got, want)
    assert (fc.engine.telemetry.fabric_counters()
            == solo.telemetry.fabric_counters())
    assert (bc.engine.telemetry.fabric_counters()
            == solo_bc.telemetry.fabric_counters())
    assert all(k.endswith(".cuda")
               for k in fc.engine.telemetry.fabric_counters()
               if k.startswith("fabric.dispatch."))
    assert fc.engine.telemetry.counters["mesh_yields_inflight"] > 0



# ---------------------- routes past bf16 wgmma and DIMS (f32, any D, ds, dh) --
def assert_flash_f32_close(got, want, abs_attn):
    """f32: ``2^-17 (|want| + P|V|)``, ~64 f32 ulps of the output, for an
    online softmax that sums in another order than the plain one."""
    g, w = got.float(), want.float()
    bar = 2.0 ** -17 * (w.abs() + abs_attn.float()) + 1e-30
    excess = ((g - w).abs() / bar).max().item()
    assert excess <= 1.0, f"f32 flash error is {excess} x the bar"


def assert_flash_f16_close(got, want, abs_attn):
    """f16: the bf16 bar scaled by f16's three more mantissa bits,
    ``2^-10 |want| + 2^-11 P|V|``."""
    g, w = got.float(), want.float()
    bar = 2.0 ** -10 * w.abs() + 2.0 ** -11 * abs_attn.float() + 1e-30
    excess = ((g - w).abs() / bar).max().item()
    assert excess <= 1.0, f"f16 flash error is {excess} x the bar"


_FLASH_BARS = {torch.float32: assert_flash_f32_close,
               torch.bfloat16: assert_flash_close,
               torch.float16: assert_flash_f16_close}


def _flash_counts(kfa):
    f = kfa.flash_attention
    return (f.launches, f.tf32x3_launches, f.tf32x3_wgmma_launches,
            f.generic_launches)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("b,hq,hkv,sq,skv,d,causal", [
    (1, 4, 2, 100, 100, 8, True), (2, 4, 4, 37, 70, 48, False),
    (1, 4, 1, 33, 130, 80, True), (1, 2, 2, 65, 65, 96, True),
    (1, 4, 2, 40, 300, 256, False), (1, 4, 2, 100, 100, 128, True),
    (1, 2, 1, 9, 9, 1, True), (1, 4, 2, 70, 90, 300, True)])
def test_flash_attention_generic_route(dev, dtype, b, hq, hkv, sq, skv, d,
                                       causal):
    """Every dtype and head dim the bf16 wgmma kernel does not take runs
    the route :func:`route` names, by counter: the 3xTF32 kernels up to D
    256 (the wgmma .tf32 one for f32 at 64 < D <= 128), the CUDA-core
    kernel past it; each within the dtype's bar of the plain attention,
    and the CUDA-core kernel, kept as the route past 256, too on the same
    inputs."""
    from repro_torch.kernels import flash_attention as kfa
    g = _g(60 + d)
    q, k, v = (torch.randn(s, generator=g).to(dtype).to(dev) for s in
               ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    path = kfa.route(dtype, d)
    assert path == ("wgmma" if dtype == torch.bfloat16 and d in
                    kfa.HEAD_DIMS else "tf32x3" if d <= 256 else "generic")
    wgmma = path == "tf32x3" and kfa.tf32x3_wgmma(q, k, v)
    assert wgmma == (dtype == torch.float32 and 64 < d <= 128)
    before = _flash_counts(kfa)
    got = kfa.flash_attention(q, k, v, causal=causal)
    assert got.dtype == dtype
    assert _flash_counts(kfa) == (
        before[0] + 1, before[1] + int(path == "tf32x3" and not wgmma),
        before[2] + int(wgmma), before[3] + int(path == "generic"))
    want = ref.attention(q, k, v, causal=causal)
    pv = ref.attention(q, k, v.abs(), causal=causal)
    _FLASH_BARS[dtype](got, want, pv)
    gen = kfa.generic(q, k, v, causal=causal)
    assert _flash_counts(kfa)[3] == before[3] + 1 + int(path == "generic")
    _FLASH_BARS[dtype](gen, want, pv)


def test_flash_generic_and_wgmma_agree_in_bf16(dev):
    """The CUDA-core and bf16 wgmma kernels on the same bf16 inputs at D =
    64 hold each other to the bf16 flash bar (so they cannot drift
    apart)."""
    from repro_torch.kernels import flash_attention as kfa
    q = _bf16((1, 8, 300, 64), 70, dev)
    k, v = _bf16((1, 2, 300, 64), 71, dev), _bf16((1, 2, 300, 64), 72, dev)
    for causal in (True, False):
        wg = kfa.flash_attention(q, k, v, causal=causal)
        gen = kfa.generic(q, k, v, causal=causal)
        assert_flash_close(gen, wg, ref.attention(q, k, v.abs(),
                                                  causal=causal))


def test_flash_tf32x3_and_wgmma_agree_in_bf16(dev):
    """The 3xTF32 (mma.sync) and bf16 wgmma kernels on the same bf16
    inputs at D = 64 hold each other to the bf16 flash bar."""
    from repro_torch.kernels import flash_attention as kfa
    q = _bf16((1, 8, 300, 64), 73, dev)
    k, v = _bf16((1, 2, 300, 64), 74, dev), _bf16((1, 2, 300, 64), 75, dev)
    for causal in (True, False):
        wg = kfa.flash_attention(q, k, v, causal=causal)
        before = kfa.flash_attention.tf32x3_launches
        tc = kfa.tf32x3(q, k, v, causal=causal)
        assert kfa.flash_attention.tf32x3_launches == before + 1
        assert_flash_close(tc, wg, ref.attention(q, k, v.abs(),
                                                 causal=causal))


@pytest.mark.parametrize("d", [68, 100, 128])
def test_flash_tf32x3_wgmma_and_mma_sync_agree_in_f32(dev, d):
    """The two 3xTF32 kernels on the same f32 inputs, each within the f32
    flash bar of the plain attention, causal with Sq < Skv."""
    from repro_torch.kernels import flash_attention as kfa
    g = _g(76 + d)
    q, k, v = (torch.randn(s, generator=g).to(dev) for s in
               ((1, 8, 200, d), (1, 2, 333, d), (1, 2, 333, d)))
    want = ref.attention(q, k, v)
    pv = ref.attention(q, k, v.abs())
    for wgmma in (True, False):
        before = _flash_counts(kfa)
        assert_flash_f32_close(kfa._tf32x3(q, k, v, True, None, wgmma),
                               want, pv)
        # each kernel counts in its own counter only
        assert _flash_counts(kfa) == (before[0] + 1,
                                      before[1] + int(not wgmma),
                                      before[2] + int(wgmma), before[3])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ds,dh", [(64, 32), (16, 64), (128, 128), (24, 40),
                                   (1, 1), (300, 33)])
def test_ssd_scan_generic_route(dev, dtype, ds, dh):
    """Every (ds, dh) outside ``DIMS`` up to (128, 128) runs the
    tensor-core passes, zero-padded to a built pair where it is not one
    (counted in ``padded_launches``), past it the recurrence kernel
    (``generic_launches``), with B/C per head and broadcast over heads,
    within the f32 SSD bar (bf16 plus one bf16 ulp), y contiguous at the
    pair's own dh; the recurrence kernel, kept as the route past (128,
    128), too on the same inputs."""
    from repro_torch.kernels import ssd_scan as kssd
    x, la, b, c = _ssd_inputs(5, 150, ds, dh, dtype, dev, seed=80)
    rtol = 2 ** -7 if dtype == torch.bfloat16 else 2e-4
    past = kssd.padded(ds, dh) is None
    assert kssd.route(ds, dh) == ("generic" if past else "tensor_cores")
    f = kssd.ssd_scan
    for bb, cc in ((b, c), (b[:1].expand(5, 150, ds),
                            c[:1].expand(5, 150, ds))):
        before = (f.launches, f.padded_launches, f.generic_launches)
        got = kssd.ssd_scan(x, la, bb, cc)
        assert (f.launches, f.padded_launches, f.generic_launches) == (
            before[0] + 1, before[1] + int(not past), before[2] + int(past))
        assert got.dtype == dtype and got.is_contiguous()
        assert tuple(got.shape) == (5, 150, dh)
        want = ref.ssd_scan(x, la, bb, cc)[0]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=2e-4)
        gen = kssd.generic(x, la, bb, cc)
        torch.testing.assert_close(gen.float(), want.float(), rtol=rtol,
                                   atol=2e-4)


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_f32_smoke_prefill_on_card_equals_cpu(dev, arch):
    """The f32 smoke configs' prefill on the card against the CPU within
    ``test_torch_lm_prefill.py``'s f32 bar (1e-4), the qwen3-4b one's
    attention on the 3xTF32 route.  Before the generic flash kernel it
    raised ``TypeError`` (bf16 only)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = dataclasses.replace(ARCHS[arch].smoke_config(), dtype="float32")
    params, _ = transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100))
    want = steps.prefill(params, tok, cfg, device="cpu")
    before = kfa.flash_attention.tf32x3_launches
    got = steps.prefill(bc.params_to(params, dev), tok, cfg, device=dev)
    assert got.dtype == torch.float32
    assert kfa.flash_attention.tf32x3_launches - before == (
        4 if arch == "qwen3-4b" else 0)
    np.testing.assert_allclose(U.n(got), U.n(want), rtol=1e-4, atol=1e-4)


def test_f32_smoke_prefill_at_head_dim_128_on_card_equals_cpu(dev):
    """qwen3-4b's smoke config in f32 at the full config's head dim 128:
    its attention runs the 3xTF32 wgmma kernel (counted), and the logits
    equal the CPU's within the f32 bar (1e-4)."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = dataclasses.replace(ARCHS["qwen3-4b"].smoke_config(),
                              dtype="float32", head_dim=128)
    params, _ = transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100))
    want = steps.prefill(params, tok, cfg, device="cpu")
    before = _flash_counts(kfa)
    got = steps.prefill(bc.params_to(params, dev), tok, cfg, device=dev)
    after = _flash_counts(kfa)
    assert (after[1] - before[1], after[2] - before[2]) == (
        0, cfg.num_layers)
    np.testing.assert_allclose(U.n(got), U.n(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- gradients --
def test_fp32_conv1d_and_matmul_carry_the_plain_gradient(dev):
    """A CUDA input that requires grad: the forward launches the kernel
    (counted), the output has a ``grad_fn``, and every gradient equals the
    CPU's plain gradient within the f32 bar (TF32 off)."""
    g = _g(90)
    x, w, b = (torch.randn(s, generator=g) for s in ((2, 130, 64),
                                                     (7, 64, 96), (96,)))
    a, m, mb = (torch.randn(s, generator=g) for s in ((300, 128), (128, 5),
                                                      (5,)))
    for fn, plain, ins, kw in (
            (kc.conv1d, ref.conv1d, (x, w, b), dict(stride=2,
                                                    activation="relu")),
            (km.matmul, ref.matmul, (a, m, mb), dict(activation="relu"))):
        cpu = [t.clone().requires_grad_() for t in ins]
        card = [t.to(dev).requires_grad_() for t in ins]
        before = fn.launches
        out = fn(*card, **kw)
        assert fn.launches == before + 1 and out.grad_fn is not None
        want = plain(*cpu, **kw)
        gout = torch.randn(want.shape, generator=g)
        out.backward(gout.to(dev))
        want.backward(gout)
        torch.testing.assert_close(out.detach().cpu(), want.detach(),
                                   rtol=TOL, atol=TOL)
        for c, d in zip(cpu, card):
            torch.testing.assert_close(d.grad.cpu(), c.grad, rtol=TOL,
                                       atol=TOL * float(c.grad.abs().max()))


def test_wrappers_without_backward_raise_on_grad(dev):
    """The int8 and integer CUDA wrappers refuse an operand that requires
    grad, before they launch; under ``torch.no_grad()`` the refusal is
    off: the same call gets past it to the operand checks (an integer
    tensor cannot require grad, so the refused operand is a float one,
    which the dtype check then rejects), and the call on valid integer
    operands launches.  (flash_attention, ssd_scan and matmul_bf16 carry
    the plain gradient: the test below.)"""
    from repro_torch.kernels import conv1d as kc
    from repro_torch.kernels import edit_distance as ked
    a = torch.randn((64, 32), device=dev, requires_grad=True)
    x = torch.randn((2, 40, 8), device=dev, requires_grad=True)
    q = torch.randn((4, 16), device=dev, requires_grad=True)
    a8, i8 = _int8((64, 32), 91, dev), _int8((32, 16), 92, dev)
    x8, w8 = _int8((2, 40, 8), 94, dev), _int8((3, 8, 16), 93, dev)
    t32 = torch.randint(0, 4, (4, 16), generator=_g(95),
                        dtype=torch.int32).to(dev)
    cases = ((km.matmul_int8, lambda: km.matmul_int8(a, i8),
              lambda: km.matmul_int8(a8, i8)),
             (kc.conv1d_int8, lambda: kc.conv1d_int8(x, w8),
              lambda: kc.conv1d_int8(x8, w8)),
             (ked.banded_align, lambda: ked.banded_align(q, q, band=2),
              lambda: ked.banded_align(t32, t32, band=2)))
    wrappers = [w for w, _, _ in cases]
    for wrapper, refused, valid in cases:
        counts = [w.launches for w in wrappers]
        with pytest.raises(RuntimeError, match="no backward"):
            refused()
        assert counts == [w.launches for w in wrappers]
        with torch.no_grad():
            with pytest.raises(TypeError, match="expected torch.int"):
                refused()
            assert counts == [w.launches for w in wrappers]
            valid()
        assert wrapper.launches == counts[wrappers.index(wrapper)] + 1
    torch.cuda.synchronize()


def _grad_case(name, dev):
    """(card call, plain version, inputs, (wrapper, counter)) of one
    training kernel's route."""
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import ssd_scan as kssd
    g = _g(94)
    kind, route = name.split(":")
    if kind == "flash":
        dtype, d = {"wgmma": (torch.bfloat16, 128),
                    "tf32x3": (torch.float32, 16),
                    "tf32x3_wgmma": (torch.float32, 128),
                    "generic": (torch.float32, 300)}[route]
        path = kfa.route(dtype, d)
        ins = [torch.randn(s, generator=g).to(dev, dtype)
               for s in ((2, 4, 70, d), (2, 2, 70, d), (2, 2, 70, d))]
        attr = {"wgmma": "launches", "tf32x3": "tf32x3_launches",
                "tf32x3_wgmma": "tf32x3_wgmma_launches",
                "generic": "generic_launches"}[route]
        return (lambda q, k, v: kfa.flash_attention(q, k, v),
                lambda q, k, v: kfa._plain(q, k, v, True, None, path), ins,
                (kfa.flash_attention, attr))
    if kind == "ssd":
        ds, dh, dtype, attr = {
            "bf16": (128, 64, torch.bfloat16, "launches"),
            "f32": (16, 16, torch.float32, "launches"),
            "padded": (64, 32, torch.float32, "padded_launches"),
            "generic": (300, 33, torch.float32, "generic_launches")}[route]
        return (lambda *a: kssd.ssd_scan(*a), kssd._plain,
                list(_ssd_inputs(6, 100, ds, dh, dtype, dev)),
                (kssd.ssd_scan, attr))
    k = {"wgmma": 256, "mma_sync": 250}[route]
    return (lambda a, b, bias: km.matmul_bf16(a, b, bias, activation="silu"),
            lambda a, b, bias: ref.matmul(a, b, bias, activation="silu"),
            [_bf16((96, k), 95, dev), _bf16((k, 64), 96, dev, k ** -0.5),
             _bf16((64,), 97, dev)],
            (km.matmul_bf16, "wgmma_launches" if route == "wgmma"
             else "launches"))


@pytest.mark.parametrize("name", [
    "flash:wgmma", "flash:tf32x3", "flash:tf32x3_wgmma", "flash:generic",
    "ssd:bf16", "ssd:f32", "ssd:padded", "ssd:generic", "gemm:wgmma",
    "gemm:mma_sync"])
def test_training_kernels_carry_the_plain_gradient(dev, name):
    """Operands that require grad: the kernel of the route launches once
    (counted), the output carries ``PlainGradBackward``, and every
    gradient, in its operand's dtype, equals plain autograd of the plain
    version on the same card inputs (the backward is that version's)."""
    call, plain, ins, (wrapper, attr) = _grad_case(name, dev)
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    before = getattr(wrapper, attr)
    out = call(*a)
    assert getattr(wrapper, attr) == before + 1
    assert type(out.grad_fn).__name__ == "PlainGradBackward"
    want = plain(*b)
    gout = torch.randn(want.shape, generator=_g(98)).to(dev, want.dtype)
    out.backward(gout)
    want.backward(gout)
    for ta, tb in zip(a, b):
        assert ta.grad.dtype == ta.dtype
        torch.testing.assert_close(ta.grad, tb.grad, rtol=0, atol=1e-5 * float(
            tb.grad.float().abs().max()))


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m"])
def test_lm_train_step_on_card_equals_cpu(dev, arch):
    """One f32 smoke train step from the same params and batch: the loss
    within 1e-5 of the CPU's and every gradient within 1e-4 of its leaf's
    largest entry; the card's updated params and moments within 1e-6 of
    each leaf's largest entry of the CPU's AdamW on the card's own
    gradients.  (Against the CPU's whole step the params could not be
    held so: AdamW's first step moves an entry by lr g / (|g| + eps),
    which the gradient's last bits decide where it is near eps.)"""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.data import tokens
    from repro_torch.models import transformer
    from repro_torch.models.registry import get_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import trainer
    from repro_torch.utils.tree import leaves, tree_map
    cfg = dataclasses.replace(ARCHS[arch].smoke_config(), dtype="float32")
    params, _ = transformer.init(_g(99), cfg, device="cpu")
    pipe = tokens.TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                      global_batch=4)
    ocfg = opt.OptimizerConfig(lr=1e-4, warmup_steps=0, total_steps=10)
    step = trainer.make_train_step(get_model(cfg).loss, cfg, ocfg)
    out = {}
    for device in ("cpu", dev):
        p = tree_map(torch.clone, bc.params_to(params, device))
        batch = tokens.batch_at_step(pipe, 0, device=device)
        _, grads = trainer.loss_and_grads(get_model(cfg).loss, p, batch,
                                          cfg)
        new, m = step({"params": p, "opt": opt.init_opt_state(p, ocfg)},
                      batch)
        out[str(device)] = (float(m["loss"]), tree_map(
            lambda t: t.cpu(), grads), [t.cpu() for t in leaves(new)])
    (cl, cg, _), (gl, gg, gnew) = out["cpu"], out[str(dev)]
    assert gl == pytest.approx(cl, rel=1e-5)
    for g, w in zip(leaves(gg), leaves(cg)):
        torch.testing.assert_close(g, w, rtol=0,
                                   atol=1e-4 * float(w.abs().max()))
    want = opt.apply_update(params, gg, opt.init_opt_state(params, ocfg),
                            ocfg)
    want = leaves({"params": want[0], "opt": want[1]})
    assert len(want) == len(gnew)
    for g, w in zip(gnew, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6 * max(
            float(w.float().abs().max()), 1e-30))


def test_lm_train_recovery_on_card_is_bitwise(dev, tmp_path):
    """``launch.train`` on the card (the qwen3-4b smoke config): a failure
    injected at step 5 and restored from step 3 gives every step's loss
    and the final state of the uninterrupted run, bit for bit."""
    from repro_torch.launch import train as launch_train
    from repro_torch.utils.tree import leaves
    argv = ["--smoke", "--steps", "8", "--ckpt-every", "3"]
    clean = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    faulty = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                       "--fail-at", "5"])
    assert faulty["restarts"] == 1
    assert clean["history"] == faulty["history"]
    for a, b in zip(leaves(clean["state"]), leaves(faulty["state"])):
        assert torch.equal(a, b)


def test_train_step_on_card_equals_cpu(dev):
    """One micro-basecaller step from the same params and batch: the
    forward on the hand conv1d kernels, the loss within 1e-5 and
    every gradient within 1e-4 of its largest entry of the CPU's (the
    card's kernels sum in another order)."""
    from repro_torch.data import nanopore
    from repro_torch.train import micro_basecaller as mb
    from repro_torch.train import optimizer as opt
    cfg = mb.DEMO_CFG
    params = bc.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = nanopore.make_ctc_batch(np.random.default_rng(0), batch=8,
                                    seq_len=30, pm=mb.DEMO_PORE)
    for qat in (False, True):
        want_l, want_g = mb.loss_and_grads(params, mb.batch_to(batch, "cpu"),
                                           cfg, qat=qat)
        before = (kc.conv1d.launches, km.matmul.launches)
        got_l, got_g = mb.loss_and_grads(bc.params_to(params, dev),
                                         mb.batch_to(batch, dev), cfg,
                                         qat=qat)
        # DEMO_CFG's three layers are convolutions (no k=1 head)
        assert kc.conv1d.launches - before[0] == 3
        assert km.matmul.launches - before[1] == 0
        assert float(got_l) == pytest.approx(float(want_l), rel=1e-5)
        for layer in want_g:
            for k in want_g[layer]:
                w = want_g[layer][k]
                torch.testing.assert_close(
                    got_g[layer][k].cpu(), w, rtol=0,
                    atol=1e-4 * float(w.abs().max()))
    ocfg = opt.OptimizerConfig(lr=3e-3, warmup_steps=20, total_steps=220,
                               weight_decay=0.0)
    card = bc.params_to(params, dev)
    p2, st, loss = mb.train_step(card, opt.init_opt_state(card, ocfg),
                                 mb.batch_to(batch, dev), cfg=cfg, ocfg=ocfg)
    assert int(st["step"]) == 1 and bool(torch.isfinite(loss))
    assert p2["conv1"]["w"].device.type == "cuda"


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_matmul_bf16_at_decode_rows(dev, m):
    """Decode's MLP GEMMs at M = the slot count: qwen3-4b's gate/up and
    down widths, each on the narrow-M kernel (counted; M <= 16 leaves the
    wgmma kernel's 128-row tile) within one bf16 ulp of the plain version;
    every row equals that row computed alone (no row reads another)."""
    for k, n, act in ((2560, 9728, "silu"), (9728, 2560, "none")):
        a, w = _bf16((m, k), 50 + m, dev), _bf16((k, n), 51, dev)
        before = (km.matmul_bf16.launches, km.matmul_bf16.narrow_launches)
        got = km.matmul_bf16(a, w, activation=act)
        assert (km.matmul_bf16.launches, km.matmul_bf16.narrow_launches) == (
            before[0] + 1, before[1] + 1)
        want = ref.matmul(a, w, activation=act)
        ulp = 2.0 ** (np.floor(np.log2(float(want.float().abs().max()))) - 7)
        assert float((got.float() - want.float()).abs().max()) <= ulp
        for r in range(m):
            one = km.matmul_bf16(a[r:r + 1].contiguous(), w, activation=act)
            assert torch.equal(one[0], got[r])


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m", "minicpm-2b"])
def test_f32_smoke_serve_step_on_card_equals_cpu(dev, arch):
    """Four decode steps of the f32 smoke config from zeroed caches, the
    two rows at different positions: logits and every cache leaf on the
    card within the port's f32 bar (1e-4) of the CPU's; the MLP on the
    fp32 ``matmul`` kernel."""
    import dataclasses

    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer
    cfg = dataclasses.replace(ARCHS[arch].smoke_config(), dtype="float32")
    params, _ = transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    dparams = bc.params_to(params, dev)
    cpu = transformer.init_cache(cfg, 2, 16, device="cpu")
    card = transformer.init_cache(cfg, 2, 16, device=dev)
    rng = np.random.default_rng(0)
    pos = torch.tensor([0, 5])
    before = km.matmul.launches
    for _ in range(4):
        tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 1)))
        with torch.inference_mode():
            want, cpu = transformer.serve_step(params, cpu, tok, pos, cfg)
            got, card = transformer.serve_step(dparams, card, tok.to(dev),
                                               pos.to(dev), cfg)
        np.testing.assert_allclose(U.n(got), U.n(want), rtol=1e-4,
                                   atol=1e-4)
        for k in cpu:
            np.testing.assert_allclose(U.n(card[k]), U.n(cpu[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=k)
        pos += 1
    mlp = 0 if arch == "mamba2-780m" else 3 * 4 * cfg.num_layers
    assert km.matmul.launches - before == mlp


@pytest.mark.parametrize("arch", ["nemotron-4-15b", "starcoder2-3b",
                                  "minicpm-2b"])
def test_dense_smoke_prefill_on_card_equals_cpu(dev, arch):
    """The three dense configs' bf16 smoke prefill on the card against
    the CPU within 2 bf16 ulps of max |logit|: their non-gated
    squared_relu and gelu epilogues, MHA and GQA, untied unembeddings."""
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = ARCHS[arch].smoke_config()
    params, _ = transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 100))
    want = steps.prefill(params, tok, cfg, device="cpu").float()
    counts = (kfa.flash_attention.launches, km.matmul_bf16.launches)
    got = steps.prefill(bc.params_to(params, dev), tok, cfg, device=dev)
    after = (kfa.flash_attention.launches, km.matmul_bf16.launches)
    gemms = 3 if cfg.mlp_gated else 2
    assert [b - a for a, b in zip(counts, after)] == [
        cfg.num_layers, gemms * cfg.num_layers]
    ulp = 2.0 ** (np.floor(np.log2(float(want.abs().max()))) - 7)
    assert float((got.float().cpu() - want).abs().max()) <= 2 * ulp
