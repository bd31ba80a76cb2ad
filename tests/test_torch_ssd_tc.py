"""The arithmetic of the tensor-core SSD scan (``csrc/ssd_scan.cu``), on the
CPU.

The kernel runs every product of the chunked scan as TF32 ``mma.sync``.
Each f32 operand is split hi + lo (``ref.split_tf32``) and a product takes
the terms its operands need: a bf16 value is exact in TF32 (no lo term),
so with bf16 inputs C B^T is one product and (w B)^T X, C S_in and G' X
two; with f32 inputs every product is three.  Emulated here in float32 at
mamba2-780m's widths (ds 128, dh 64, chunk 256; T 512, 4 heads), the scan
comes within the JAX suite's 2e-4 bar of JAX's ``ssd_scan`` (the Pallas
kernel in interpret mode).  One TF32 product (hi x hi) of the f32 operands
misses that bar, so the splits are needed.  Any other pair runs the same
passes at the pair of ``INSTANCES`` that holds it, zero-padded by the
wrapper (B and C past ds, x past dh, y cropped): emulated so at (24, 40)
and (100, 17), it holds the same bar.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import fabric as jfabric
from repro.kernels import ops as jops
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as kssd

TOL = 2e-4          # the JAX suite's SSD bar (tests/test_kernels.py)
HEADS, T, DS, DH, CHUNK = 4, 512, 128, 64, 256


@functools.lru_cache(maxsize=None)
def _inputs(bf16: bool):
    """x, log_a <= 0, B, C as chip_smoke.py draws them, float32; with
    ``bf16`` x, B and C rounded to bf16 first (the path's types)."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((HEADS, T, DH)) * 0.5).astype(np.float32)
    la = -np.logaddexp(rng.standard_normal((HEADS, T)), 0).astype(
        np.float32)
    b = (rng.standard_normal((HEADS, T, DS)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((HEADS, T, DS)) * 0.3).astype(np.float32)
    if bf16:
        x, b, c = (U.n(U.t(a).to(torch.bfloat16).float()) for a in (x, b, c))
    return x, la, b, c


@functools.lru_cache(maxsize=None)
def _jax_y(bf16: bool):
    """JAX's Pallas SSD kernel in interpret mode, in float32 on the same
    values (the kernel widens bf16 inputs to float32 before any product)."""
    with jfabric.use("pallas_interpret"):
        y = jops.ssd_scan(*[jnp.asarray(a) for a in _inputs(bf16)],
                          chunk=CHUNK)
    return np.asarray(y)


def _product(a, b, a_exact, b_exact, one=False):
    """a @ b as the kernel forms it: the small terms first, lo_a hi_b (a
    split) and hi_a lo_b (b split), then hi_a hi_b; ``one``: hi_a hi_b
    alone."""
    ah, al = ref.split_tf32(a)
    bh, bl = ref.split_tf32(b)
    if one:
        return ah @ bh
    if a_exact:
        assert not bool(al.any())
    if b_exact:
        assert not bool(bl.any())
    out = torch.zeros((*a.shape[:-1], b.shape[-1]))
    if not a_exact:
        out = out + al @ bh
    if not b_exact:
        out = out + ah @ bl
    return out + ah @ bh


def _emulated_scan(x, la, b, c, exact, one=False):
    """The kernel's three passes a chunk at a time: pass 3's inter term
    from S_in and its decayed, masked G = C B^T, then G' X; pass 1's
    (w B)^T X and pass 2's state update."""
    bh, tn, dh = x.shape
    ds = b.shape[-1]
    y = torch.zeros((bh, tn, dh))
    s_in = torch.zeros((bh, ds, dh))
    for c0 in range(0, tn, CHUNK):
        xs, bs, cs = (a[:, c0:c0 + CHUNK] for a in (x, b, c))
        cum = torch.cumsum(la[:, c0:c0 + CHUNK], dim=1)
        n = cum.shape[1]
        inter = _product(cs, s_in, exact, False, one) * torch.exp(cum)[..., None]
        g = _product(cs, bs.transpose(1, 2), exact, exact, one)
        below = torch.ones((n, n), dtype=torch.bool).tril()
        seg = torch.where(below, cum[:, :, None] - cum[:, None, :], 0.0)
        g = torch.where(below, g * torch.exp(seg), 0.0)
        y[:, c0:c0 + CHUNK] = inter + _product(g, xs, False, exact, one)
        total = cum[:, -1]
        wb = bs * torch.exp(total[:, None] - cum)[..., None]
        own = _product(wb.transpose(1, 2), xs, False, exact, one)
        s_in = torch.exp(total)[:, None, None] * s_in + own
    return y


def test_bf16_values_are_exact_in_tf32():
    """A bf16 value has 8 significant bits, TF32 11: its split has no lo
    term, so a product of two bf16 operands is one TF32 MMA."""
    x, _, b, c = (U.t(a) for a in _inputs(True))
    for v in (x, b, c):
        hi, lo = ref.split_tf32(v)
        assert torch.equal(hi, v) and not bool(lo.any())
    # an f32 operand is not: the path's f32 ones (w B, S_in, G') are split
    hi, lo = ref.split_tf32(U.t(_inputs(False)[0]))
    assert bool(lo.any())


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_emulated_tensor_core_scan_holds_the_bar(bf16):
    x, la, b, c = (U.t(a) for a in _inputs(bf16))
    ref.full_fp32()
    got = _emulated_scan(x, la, b, c, exact=bf16)
    want = _jax_y(bf16)
    err = float(np.abs(U.n(got) - want).max())
    assert err <= TOL, err
    # and the port's plain version (the recurrence) on the same inputs
    plain = U.n(kssd.ssd_scan(x, la, b, c, chunk=CHUNK))
    assert float(np.abs(U.n(got) - plain).max()) <= TOL


def test_one_tf32_product_misses_the_bar():
    """hi x hi alone on the f32 inputs: the error the splits remove."""
    x, la, b, c = (U.t(a) for a in _inputs(False))
    ref.full_fp32()
    one = _emulated_scan(x, la, b, c, exact=False, one=True)
    err = float(np.abs(U.n(one) - _jax_y(False)).max())
    assert err > TOL, err


@functools.lru_cache(maxsize=None)
def _pair_inputs(ds: int, dh: int, bf16: bool):
    """The same draws at a (ds, dh) pair outside ``DIMS``."""
    rng = np.random.default_rng(22 + ds + dh)
    x = (rng.standard_normal((HEADS, T, dh)) * 0.5).astype(np.float32)
    la = -np.logaddexp(rng.standard_normal((HEADS, T)), 0).astype(
        np.float32)
    b = (rng.standard_normal((HEADS, T, ds)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((HEADS, T, ds)) * 0.3).astype(np.float32)
    if bf16:
        x, b, c = (U.n(U.t(a).to(torch.bfloat16).float()) for a in (x, b, c))
    return x, la, b, c


@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
@pytest.mark.parametrize("ds,dh", [(24, 40), (100, 17)])
def test_padded_pair_holds_the_bar(ds, dh, bf16):
    """A pair outside ``INSTANCES`` runs the passes at the pair ``padded``
    names: B and C zero past ds, x past dh, y cropped to dh.  Emulated so, the scan comes within 2e-4 of JAX's ``ssd_scan``
    (the Pallas kernel in interpret mode) at the pair itself."""
    assert kssd.route(ds, dh) == "tensor_cores"
    dsp, dhp = kssd.padded(ds, dh)
    assert (ds, dh) not in kssd.INSTANCES and (dsp, dhp) != (ds, dh)
    arrs = _pair_inputs(ds, dh, bf16)
    x, la, b, c = (U.t(a) for a in arrs)
    pad = torch.nn.functional.pad
    ref.full_fp32()
    got = _emulated_scan(pad(x, (0, dhp - dh)), la, pad(b, (0, dsp - ds)),
                         pad(c, (0, dsp - ds)), exact=bf16)
    # the padded columns of y are exact zeros, which the wrapper crops
    assert not bool(got[..., dh:].any())
    with jfabric.use("pallas_interpret"):
        want = np.asarray(jops.ssd_scan(*[jnp.asarray(a) for a in arrs],
                                        chunk=CHUNK))
    err = float(np.abs(U.n(got[..., :dh]) - want).max())
    assert err <= TOL, err
