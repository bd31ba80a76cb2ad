"""Which kernel a CUDA call launches, and what a CUDA call refuses, pinned
on the CPU in pure Python (the kernels run only on the card):

* ``flash_attention.route``: bf16 at a head dim of ``HEAD_DIMS`` on the
  wgmma kernel, every other dtype and head dim up to 256 on the 3xTF32
  kernels (the head dim padded, f32 at 64 < D <= 128 on their wgmma one),
  past 256 on the CUDA-core kernel, and how much shared memory each
  takes;
* ``ssd_scan.route``: every (ds, dh) up to (128, 128) on the tensor-core
  passes at the padded instantiation, past it on the recurrence kernel,
  and what each takes of shared memory;
* the wrappers with no backward (the int8 and integer kernels and the
  fused tick) refuse an operand that requires grad before they check or
  launch anything (a ``meta`` tensor stands for a CUDA one: the wrapper
  takes its card path, and would fail on the device check if the refusal
  did not come first);
* fp32 ``conv1d`` and ``matmul``'s autograd functions, and the card paths
  of ``flash_attention`` (each route), ``ssd_scan`` (each route) and
  ``matmul_bf16``, give the plain version's gradient (the kernel's
  forward replaced by the plain one here, the backward code unchanged)."""
import re
from pathlib import Path

import pytest
import torch

import torch_port_util  # (torch lazy-module registries; TfShape)
from repro_torch.core import basecaller as tbc
from repro_torch.kernels import _build
from repro_torch.kernels import conv1d as kc
from repro_torch.kernels import edit_distance as ke
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import fused_stream as kf
from repro_torch.kernels import matmul as km
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as kssd


_FLASH_DIMS = (1, 7, 8, 9, 16, 20, 32, 48, 64, 65, 80, 96, 100, 128, 129,
               200, 256, 257, 300, 4096)


def _flash_route(dtype, d):
    if dtype == torch.bfloat16 and d in (16, 32, 64, 128):
        return "wgmma"
    return "tf32x3" if d <= 256 else "generic"


@pytest.mark.parametrize("d", _FLASH_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=str)
def test_flash_route_by_dtype_and_head_dim(dtype, d):
    assert kfa.route(dtype, d) == _flash_route(dtype, d)
    # the 3xTF32 kernels pad D to the first of 16, 32, 64, 128, 256
    pad = kfa.tf32x3_dim(d)
    if d <= 256:
        assert pad in kfa.TF32X3_DIMS and d <= pad
        assert pad == 16 or pad // 2 < d
    else:
        assert pad == 0


@pytest.mark.parametrize("d,dtype,aligned,wgmma", [
    (128, torch.float32, True, True), (68, torch.float32, True, True),
    (100, torch.float32, True, True), (64, torch.float32, True, False),
    (66, torch.float32, True, False), (130, torch.float32, True, False),
    (128, torch.float32, False, False), (128, torch.float16, True, False),
    (100, torch.bfloat16, True, False)])
def test_tf32x3_wgmma_kernel_takes_f32_at_64_to_128(d, dtype, aligned,
                                                     wgmma):
    """f32 at 64 < D <= 128, D % 4 == 0, every operand 16-byte aligned:
    the wgmma .tf32 kernel; every other 3xTF32 case the mma.sync one."""
    q = torch.zeros(1 + 4 * d, dtype=dtype)
    t = q[1:] if not aligned else q[:4 * d]
    view = t[:4 * d].view(1, 1, 4, d)
    assert kfa.tf32x3_wgmma(view, view, view) == wgmma


@pytest.mark.parametrize("dp", kfa.TF32X3_DIMS)
def test_tf32x3_block_fits_shared_memory(dp):
    """``TfShape<DP>`` as csrc/flash_attention.cu states it: the block's
    shared memory (Q, the next K and V tiles raw, the current ones' hi and
    lo planes) within the 227 KB a block may use, a warp per 16 query
    rows, whole k-steps of keys."""
    shape = torch_port_util.tf32x3_shape(dp)
    assert shape["SMEM"] <= _build.SMEM_LIMIT
    assert shape["BQ"] % 16 == 0 and shape["BK"] % 8 == 0
    assert shape["THREADS"] == shape["BQ"] // 16 * 32
    assert shape["LD"] >= dp


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


@pytest.mark.parametrize("pair,inst", [
    ((128, 64), (128, 64)), ((32, 16), (32, 16)), ((16, 16), (16, 16)),
    ((64, 32), (128, 64)), ((16, 64), (128, 64)), ((128, 128), (128, 128)),
    ((24, 40), (128, 64)), ((1, 1), (16, 16)), ((64, 128), (128, 128)),
    ((100, 17), (128, 64)), ((17, 16), (32, 16)), ((16, 17), (128, 64)),
    ((256, 64), None), ((300, 33), None), ((64, 129), None)])
def test_ssd_route_by_state_and_head_width(pair, inst):
    """Each pair runs at the smallest built pair that holds it, its own
    where it is one; past (128, 128) the recurrence."""
    assert kssd.padded(*pair) == inst
    assert kssd.route(*pair) == ("tensor_cores" if inst else "generic")
    if pair in kssd.INSTANCES:
        assert inst == pair


_POW2 = (16, 32, 64, 128)


@pytest.mark.parametrize("ds,dh", [(ds, dh) for ds in _POW2 for dh in _POW2])
def test_ssd_instantiations_fit_shared_memory(ds, dh):
    """Every pair of widths up to 128 runs at a built pair that holds it,
    and no smaller built pair does; that pair's pass-3 block at the largest
    chunk fits; only (128, 128) leaves room for one block an SM (its
    register hint 1)."""
    inst = kssd.padded(ds, dh)
    assert inst in kssd.INSTANCES and ds <= inst[0] and dh <= inst[1]
    assert all(p * q >= inst[0] * inst[1] for p, q in kssd.INSTANCES
               if ds <= p and dh <= q)
    assert kssd.out_smem_bytes(*inst, kssd.MAX_CHUNK) <= _build.SMEM_LIMIT
    two = 2 * kssd.out_smem_bytes(*inst, 256) <= _build.SMEM_LIMIT
    assert two == (inst != (128, 128))
    if inst == (128, 128):
        # ~157 KB at chunk 256
        assert kssd.out_smem_bytes(*inst, 256) == 156_672


def test_ssd_instances_match_the_source():
    """``INSTANCES`` are the pairs ``launch_dims`` in csrc/ssd_scan.cu
    dispatches on, and ``DIMS`` among them."""
    src = (Path(kssd.__file__).parent / "csrc" / "ssd_scan.cu").read_text()
    body = src[src.index("launch_dims("):src.index("// ---- the generic")]
    pairs = {(int(a), int(b)) for a, b in re.findall(
        r"if \(ds == (\d+) && dh == (\d+)\)", body)}
    assert pairs == set(kssd.INSTANCES)
    assert set(kssd.DIMS) <= pairs
    assert list(kssd.INSTANCES) == sorted(kssd.INSTANCES,
                                          key=lambda p: p[0] * p[1])


@pytest.mark.parametrize("bh,stride0", [(5, True), (5, False), (1, False)])
def test_ssd_padding_of_b_and_c(bh, stride0):
    """The wrapper's padding of B or C: zeros past ds, the values kept, and
    one row broadcast over the heads stays a stride-0 view."""
    g = torch.Generator().manual_seed(3)
    t = torch.randn(bh if stride0 else 1, 7, 24, generator=g)
    if not stride0:
        t = t.expand(bh, 7, 24)
    out = kssd._pad_bc(t, t.stride(0) if bh > 1 else 0, 128)
    assert tuple(out.shape) == (bh, 7, 128)
    assert torch.equal(out[..., :24], t)
    assert not bool(out[..., 24:].any())
    assert out.stride(1) == 128 and out.stride(2) == 1
    if not stride0 and bh > 1:
        assert out.stride(0) == 0


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
    cfg = tbc.BasecallerConfig(kernels=(3, 1), channels=(8, 5),
                               strides=(1, 1))
    params = {"conv1": {"w": _meta(3, 1, 8), "b": _meta(8)},
              "conv2": {"w": _meta(1, 8, 5), "b": _meta(5)}}
    lanes = _meta(4, 16, grad=False)
    ints = torch.empty((4,), dtype=torch.int32, device="meta")
    carry = [_meta(4, 2, 1, grad=False), _meta(4, 0, 8, grad=False)]
    return {
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
    # with autograd off the same call gets past the refusal: to the
    # wrapper's own checks (fused_stream_cuda: a meta tensor is no CUDA
    # tensor), or to the plain version that a meta tensor takes (the dry
    # run's target), whose int8 checks refuse the float operands; the
    # plain edit distance takes float tokens and gives the (P,) shape
    with torch.no_grad():
        if name == "levenshtein":
            out = call()
            assert out.device.type == "meta" and out.shape == (2,)
        else:
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


def _plain_launches(monkeypatch):
    """Every card launch of flash_attention, ssd_scan and matmul_bf16
    swapped for its plain version (what the kernel computes)."""
    monkeypatch.setattr(kfa, "_launch", lambda path, q, k, v, causal, scale:
                        kfa._plain(q, k, v, causal, scale, path))
    monkeypatch.setattr(kssd, "_launch",
                        lambda x, la, b, c, chunk: kssd._plain(x, la, b, c))
    monkeypatch.setattr(kssd, "_launch_generic", kssd._plain)
    monkeypatch.setattr(km, "_matmul_bf16_cuda",
                        lambda a, b, bias, act: ref.matmul(a, b, bias,
                                                           activation=act))


def _gradient_cases():
    """name -> (card path, its plain version, operand shapes, dtype)."""
    bf, f32 = torch.bfloat16, torch.float32
    qkv = [(2, 4, 12, 16), (2, 2, 12, 16), (2, 2, 12, 16)]     # GQA 2
    ssd = [(3, 40, 16), (3, 40), (3, 40, 32), (3, 40, 32)]

    def flash(path):
        return (lambda q, k, v: kfa._on_card(path, q, k, v, True, None),
                lambda q, k, v: kfa._plain(q, k, v, True, None, path))
    return {
        "flash_attention": (*flash("wgmma"), qkv, bf),
        "flash_attention tf32x3": (
            lambda q, k, v: kfa.tf32x3(q, k, v),
            lambda q, k, v: kfa._plain(q, k, v, True, None, "tf32x3"),
            qkv, f32),
        "flash_attention generic": (
            lambda q, k, v: kfa.generic(q, k, v, causal=False),
            lambda q, k, v: kfa._plain(q, k, v, False, None, "generic"),
            qkv, f32),
        "ssd_scan": (lambda *a: kssd._on_card(*a, 256), kssd._plain, ssd,
                     f32),
        "ssd_scan bf16": (lambda *a: kssd._on_card(*a, 256), kssd._plain,
                          ssd, bf),
        "ssd_scan generic": (kssd.generic, kssd._plain, ssd, f32),
        "matmul_bf16": (
            lambda a, b, bias: km._bf16_on_card(a, b, bias, "silu"),
            lambda a, b, bias: ref.matmul(a, b, bias, activation="silu"),
            [(24, 40), (40, 16), (16,)], bf),
    }


@pytest.mark.parametrize("name", sorted(_gradient_cases()))
def test_kernel_wrappers_give_the_plain_gradient(monkeypatch, name):
    """The card path of each training kernel, its launch swapped for the
    plain forward: the output carries ``PlainGrad``'s ``grad_fn``, no
    counter moves, and every gradient equals plain autograd's bit for bit
    in the operand's dtype (log_a float32 beside bf16 x, b, c)."""
    _plain_launches(monkeypatch)
    card, plain, shapes, dtype = _gradient_cases()[name]
    g = torch.Generator().manual_seed(0)
    ins = []
    for i, s in enumerate(shapes):
        t = torch.randn(s, generator=g)
        if name.startswith("ssd") and i == 1:
            ins.append(-torch.rand(s, generator=g))        # log_a <= 0
        else:
            ins.append(t.to(dtype))
    a = [t.clone().requires_grad_() for t in ins]
    b = [t.clone().requires_grad_() for t in ins]
    launches = (kfa.flash_attention.launches, kssd.ssd_scan.launches,
                km.matmul_bf16.launches)
    out = card(*a)
    assert type(out.grad_fn).__name__ == "PlainGradBackward"
    want = plain(*b)
    assert out.dtype == want.dtype == ins[0].dtype
    gout = torch.randn(want.shape, generator=g).to(want.dtype)
    out.backward(gout)
    want.backward(gout)
    for ta, tb in zip(a, b):
        assert ta.grad.dtype == ta.dtype
        torch.testing.assert_close(ta.grad, tb.grad, rtol=0, atol=0)
    assert launches == (kfa.flash_attention.launches, kssd.ssd_scan.launches,
                        km.matmul_bf16.launches)
