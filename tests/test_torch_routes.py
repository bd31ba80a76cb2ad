"""Which kernel a CUDA call launches, and what a CUDA call refuses, pinned
on the CPU in pure Python (the kernels run only on the card):

* ``flash_attention.route``: bf16 at a head dim of ``HEAD_DIMS`` on the
  wgmma kernel, everything else (f32, f16, other head dims) on the generic
  one, and how many query rows a generic block takes;
* ``ssd_scan.route``: the (ds, dh) pairs of ``DIMS`` on the tensor-core
  passes, every other pair on the generic kernel, and its window;
* the wrappers with no backward refuse an operand that requires grad
  before they check or launch anything (a ``meta`` tensor stands for a
  CUDA one: the wrapper takes its card path, and would fail on the device
  check if the refusal did not come first);
* fp32 ``conv1d`` and ``matmul``'s autograd functions give the plain
  version's gradient (the kernel's forward replaced by the plain one here,
  the backward code unchanged)."""
import pytest
import torch

import torch_port_util  # noqa: F401  (torch lazy-module registries)
from repro_torch.core import basecaller as tbc
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d as kc
from repro_torch.kernels import edit_distance as ke
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import fused_stream as kf
from repro_torch.kernels import matmul as km
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as kssd


def test_flash_route_by_dtype_and_head_dim():
    for d in (16, 32, 64, 128):
        assert kfa.route(torch.bfloat16, d) == "wgmma"
        assert kfa.route(torch.float32, d) == "generic"
        assert kfa.route(torch.float16, d) == "generic"
    for d in (1, 8, 48, 80, 96, 100, 256, 4096):
        assert kfa.route(torch.bfloat16, d) == "generic"


def test_flash_generic_rows_fit_shared_memory():
    assert kfa.generic_rows(128) == kfa.GENERIC_ROWS == 8
    # bytes: K tile 32 x 65 and V tile 32 x 64 floats, each row's q,
    # output and 32 probabilities
    assert kfa.generic_smem_bytes(8, 256) == 4 * (32 * 65 + 32 * 64
                                                  + 8 * (2 * 256 + 32))
    for d in (4000, 8000, 16000, 26000):
        rows = kfa.generic_rows(d)
        assert 1 <= rows < 8
        assert kfa.generic_smem_bytes(rows, d) <= _build.SMEM_LIMIT
        assert kfa.generic_smem_bytes(rows + 1, d) > _build.SMEM_LIMIT
    assert kfa.generic_rows(30_000) == 0


def test_ssd_route_by_state_and_head_width():
    for pair in kssd.DIMS:
        assert kssd.route(*pair) == "tensor_cores"
    for pair in ((64, 32), (16, 64), (128, 128), (24, 40), (1, 1),
                 (64, 128), (256, 64)):
        assert kssd.route(*pair) == "generic"


def test_ssd_generic_window_fits_shared_memory():
    assert kssd.generic_steps(128) == kssd.GENERIC_STEPS == 32
    assert kssd.generic_smem_bytes(24, 32) == 4 * (24 * 32 + 32 * (
        32 + 2 * 24 + 1 + 8 * 32))
    for ds in (700, 1000, 1500):
        steps = kssd.generic_steps(ds)
        assert 1 <= steps < 32
        assert kssd.generic_smem_bytes(ds, steps) <= _build.SMEM_LIMIT
        assert kssd.generic_smem_bytes(ds, steps + 1) > _build.SMEM_LIMIT
    assert kssd.generic_steps(2000) == 0


def _meta(*shape, dtype=torch.float32, grad=True):
    return torch.empty(shape, dtype=dtype, device="meta", requires_grad=grad)


def _raising_calls():
    q = _meta(1, 2, 8, 16)
    x, la, b = _meta(2, 8, 16), _meta(2, 8), _meta(2, 8, 16)
    cfg = tbc.BasecallerConfig(kernels=(3, 1), channels=(8, 5),
                               strides=(1, 1))
    params = {"conv1": {"w": _meta(3, 1, 8), "b": _meta(8)},
              "conv2": {"w": _meta(1, 8, 5), "b": _meta(5)}}
    lanes = _meta(4, 16, grad=False)
    ints = torch.empty((4,), dtype=torch.int32, device="meta")
    carry = [_meta(4, 2, 1, grad=False), _meta(4, 0, 8, grad=False)]
    return {
        "flash_attention": lambda: kfa.flash_attention(q, q, q),
        "flash_attention generic": lambda: kfa.generic(q, q, q),
        "ssd_scan": lambda: kssd.ssd_scan(x, la, b, b),
        "ssd_scan generic": lambda: kssd.generic(x, la, b, b),
        "matmul_bf16": lambda: km.matmul_bf16(
            _meta(4, 8, dtype=torch.bfloat16), _meta(8, 8,
                                                     dtype=torch.bfloat16)),
        # the int8 and int32 wrappers: an integer tensor cannot require
        # grad, so a float one shows the refusal comes before the type check
        "matmul_int8": lambda: km.matmul_int8(_meta(4, 8), _meta(8, 8)),
        "conv1d_int8": lambda: kc.conv1d_int8(_meta(2, 9, 4),
                                              _meta(3, 4, 8)),
        "banded_align": lambda: ke.banded_align(_meta(2, 8), _meta(2, 8),
                                                band=2),
        "levenshtein": lambda: ke.levenshtein(_meta(2, 8), _meta(2, 8)),
        "fused_stream": lambda: kf.fused_stream_cuda(
            lanes, _meta(4, 16, grad=False), _meta(4, grad=False), ints,
            ints, ints, carry, params, cfg=cfg),
    }


@pytest.mark.parametrize("name", sorted(_raising_calls()))
def test_wrappers_without_backward_refuse_grad_before_launch(name):
    call = _raising_calls()[name]
    launches = (kfa.flash_attention.launches, kssd.ssd_scan.launches,
                km.matmul_bf16.launches, km.matmul_int8.launches,
                kc.conv1d_int8.launches, ke.banded_align.launches,
                ke.levenshtein.launches, kf.fused_stream_cuda.launches)
    with pytest.raises(RuntimeError, match="requires grad.*no backward"):
        call()
    # with autograd off the same call gets past the refusal, to the
    # wrapper's own checks (a meta tensor is no CUDA tensor)
    with torch.no_grad():
        with pytest.raises((ValueError, TypeError)):
            call()
    assert launches == (kfa.flash_attention.launches, kssd.ssd_scan.launches,
                        km.matmul_bf16.launches, km.matmul_int8.launches,
                        kc.conv1d_int8.launches, ke.banded_align.launches,
                        ke.levenshtein.launches,
                        kf.fused_stream_cuda.launches)


def test_refuse_grad_only_with_autograd_on():
    t = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError):
        _build.refuse_grad("op", None, t)
    _build.refuse_grad("op", torch.ones(3), None)
    with torch.no_grad():
        _build.refuse_grad("op", t)
    with torch.inference_mode():
        _build.refuse_grad("op", torch.ones(3))


def test_fp32_autograd_functions_give_the_plain_gradient(monkeypatch):
    """``_build.PlainGrad`` over the fp32 conv1d's and matmul's launch,
    swapped here for the plain forward: the output carries its
    ``grad_fn``, and every gradient (bias included, or None where there is
    none) equals plain autograd's bit for bit."""
    monkeypatch.setattr(kc, "_conv1d_cuda",
                        lambda x, w, b, s, a: ref.conv1d(x, w, b, stride=s,
                                                         activation=a))
    monkeypatch.setattr(km, "_matmul_cuda",
                        lambda a, b, bias, act: ref.matmul(a, b, bias,
                                                           activation=act))
    g = torch.Generator().manual_seed(0)
    cases = [
        (lambda x, w, b: kc._conv1d_cuda(x, w, b, 2, "relu"),
         lambda x, w, b: ref.conv1d(x, w, b, stride=2, activation="relu"),
         [(2, 21, 4), (5, 4, 6), (6,)]),
        (lambda x, w, b: kc._conv1d_cuda(x, w, b, 1, "none"),
         lambda x, w, b: ref.conv1d(x, w, b), [(1, 9, 3), (3, 3, 2), None]),
        (lambda a, b, bias: km._matmul_cuda(a, b, bias, "relu"),
         lambda a, b, bias: ref.matmul(a, b, bias, activation="relu"),
         [(7, 5), (5, 3), (3,)]),
    ]
    for kernel, plain, shapes in cases:
        ins = [None if s is None else torch.randn(s, generator=g)
               for s in shapes]
        a = [None if t is None else t.clone().requires_grad_() for t in ins]
        b = [None if t is None else t.clone().requires_grad_() for t in ins]
        out = _build.PlainGrad.apply(kernel, plain, *a)
        assert type(out.grad_fn).__name__ == "PlainGradBackward"
        want = plain(*b)
        gout = torch.randn(want.shape, generator=g)
        out.backward(gout)
        want.backward(gout)
        for ta, tb in zip(a, b):
            if ta is None:
                continue
            torch.testing.assert_close(ta.grad, tb.grad, rtol=0, atol=0)
