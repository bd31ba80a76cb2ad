"""The arithmetic of the 3xTF32 flash kernels (``csrc/flash_attention.cu``
``flash_attention_tf32x3_kernel`` and its wgmma form), on the CPU.

Both products run as TF32 tensor-core MMAs.  Each f32 operand is split
hi + lo (``ref.split_tf32``) and a product takes lo hi + hi lo + hi hi; P
is always split; a bf16 or f16 operand is exact in TF32 and is not.  The
head dim is zero-padded to the kernel's width, S's small terms are summed
apart from hi hi, and each key tile's P V goes to a fresh accumulator
added to O.  Emulated here in float32 on a small qwen3-style case (GQA 2,
causal and not, Sq < Skv, D 16 and a padded 20) made from a numpy seed,
the result comes within F32_FLASH_RULE's 2^-17 (|ref| + P|V|) of JAX's
``flash_attention`` (the Pallas kernel in interpret mode); one TF32
product (hi x hi) misses that bar, so the splits are needed.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import fabric as jfabric
from repro.kernels import ops as jops
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ref

B, HQ, HKV, SQ, SKV = 1, 4, 2, 48, 80
BLOCK = 16          # the Pallas kernel's block (divides Sq and Skv)


def _bar_excess(got, want, abs_attn) -> float:
    """|got - want| over F32_FLASH_RULE's 2^-17 (|want| + P|V|): at most 1
    passes (chip_smoke.py flash_bar_excess, float32)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bar = 2.0 ** -17 * (np.abs(w) + np.asarray(abs_attn, np.float64))
    return float((np.abs(g - w) / (bar + 1e-30)).max())


@functools.lru_cache(maxsize=None)
def _inputs(d: int, bf16: bool):
    """q, k, v float32 from a numpy seed; with ``bf16`` rounded to bf16
    values first (a 16-bit operand, exact in TF32)."""
    rng = np.random.default_rng(40 + d)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, HQ, SQ, d), (B, HKV, SKV, d), (B, HKV, SKV, d))]
    if bf16:
        arrs = [U.n(U.t(a).to(torch.bfloat16).float()) for a in arrs]
    return tuple(arrs)


@functools.lru_cache(maxsize=None)
def _jax_out(d: int, bf16: bool, causal: bool):
    """JAX's flash_attention, the Pallas kernel in interpret mode, float32
    on the same values."""
    with jfabric.use("pallas_interpret"):
        before = jfabric.counters()
        out = jops.flash_attention(*[jnp.asarray(a) for a in _inputs(d, bf16)],
                                   causal=causal, block_q=BLOCK,
                                   block_k=BLOCK)
        delta = jfabric.counters_delta(before)
    assert delta.get("fabric.dispatch.flash_attention.pallas_interpret") == 1
    return np.asarray(out)


def _product(a, b, a_exact, b_exact, one):
    """(small terms, hi x hi) of a @ b as the kernel forms them: lo_a hi_b
    (a split) + hi_a lo_b (b split), and hi_a hi_b; ``one``: hi x hi
    alone."""
    ah, al = ref.split_tf32(a)
    bh, bl = ref.split_tf32(b)
    small = torch.zeros((*a.shape[:-1], b.shape[-1]))
    if one:
        return small, ah @ bh
    if a_exact:
        assert not bool(al.any())
    else:
        small = small + al @ bh
    if b_exact:
        assert not bool(bl.any())
    else:
        small = small + ah @ bl
    return small, ah @ bh


def _emulated(q, k, v, causal, exact, one=False):
    """The kernel a key tile at a time: D zero-padded to its width; S =
    (small + hi hi) * scale log2(e), masked; the online softmax in the exp2
    domain; each tile's P V (P split) into a fresh accumulator added to the
    rescaled O; one division by l."""
    ref.full_fp32()
    d = q.shape[-1]
    dp = kfa.tf32x3_dim(d)
    bk = U.tf32x3_shape(dp)["BK"]
    pad = (0, dp - d)
    group = q.shape[1] // k.shape[1]
    q, k, v = (torch.nn.functional.pad(t, pad) for t in (q, k, v))
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    sq, skv = q.shape[2], k.shape[2]
    sl2 = d ** -0.5 * math.log2(math.e)
    rows = torch.arange(sq)[:, None]
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    o = torch.zeros(q.shape)
    for k0 in range(0, skv, bk):
        kt, vt = k[:, :, k0:k0 + bk], v[:, :, k0:k0 + bk]
        small, big = _product(q, kt.transpose(-1, -2), exact, exact, one)
        t = (big + small) * sl2
        cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
        if causal:
            t = t.masked_fill(cols > rows + (skv - sq), -math.inf)
        mx = torch.maximum(m, t.amax(-1))
        alpha = torch.exp2(m - mx)
        p = torch.exp2(t - mx[..., None])
        l = alpha * l + p.sum(-1)
        m = mx
        small, big = _product(p, vt, False, exact, one)
        o = o * alpha[..., None] + (small + big)
    return (o / l[..., None])[..., :d]


def _case(d, bf16, causal, one=False):
    q, k, v = (U.t(a) for a in _inputs(d, bf16))
    got = _emulated(q, k, v, causal, exact=bf16, one=one)
    abs_attn = ref.attention(q, k, v.abs(), causal=causal)
    return U.n(got), _jax_out(d, bf16, causal), U.n(abs_attn), (q, k, v)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_values"])
@pytest.mark.parametrize("d", [16, 20])
def test_emulated_tf32x3_attention_holds_the_f32_bar(d, bf16, causal):
    got, want, abs_attn, (q, k, v) = _case(d, bf16, causal)
    assert _bar_excess(got, want, abs_attn) <= 1.0
    # and the port's plain attention on the same inputs
    plain = U.n(ref.attention(q, k, v, causal=causal))
    assert _bar_excess(got, plain, abs_attn) <= 1.0


@pytest.mark.parametrize("d", [16, 20])
def test_one_tf32_product_misses_the_bar(d):
    """hi x hi alone on the f32 inputs: the error the splits remove."""
    got, want, abs_attn, _ = _case(d, False, True, one=True)
    assert _bar_excess(got, want, abs_attn) > 1.0


def test_16_bit_operands_are_exact_in_tf32():
    """A bf16 value has 8 significant bits, TF32 11: its split has no lo
    term, so Q K^T is one product and P V two (P, f32, split); an f32
    operand is split."""
    for a in _inputs(20, True):
        hi, lo = ref.split_tf32(U.t(a))
        assert torch.equal(hi, U.t(a)) and not bool(lo.any())
    hi, lo = ref.split_tf32(U.t(_inputs(20, False)[0]))
    assert bool(lo.any())


def test_padded_head_dim_adds_only_zeros():
    """D 20 runs at the kernel's 32: the padded columns are zeros in both
    split planes of every operand, so each of their terms in every product
    is an exact zero, and the sums are those of D 20 with zeros added."""
    assert kfa.tf32x3_dim(20) == 32
    for a in _inputs(20, False):
        padded = ref.split_tf32(torch.nn.functional.pad(U.t(a), (0, 12)))
        for plane, own in zip(padded, ref.split_tf32(U.t(a))):
            assert not bool(plane[..., 20:].any())
            assert torch.equal(plane[..., :20], own)
    q, k, _ =(torch.nn.functional.pad(U.t(a), (0, 12))
               for a in _inputs(20, False))
    qh, ql = ref.split_tf32(q)
    kh, kl = ref.split_tf32(k.repeat_interleave(2, dim=1))
    for x, y in ((ql, kh), (qh, kl), (qh, kh)):
        terms = x[..., None, 20:] * y[..., None, :, 20:]
        assert not bool(terms.any())
