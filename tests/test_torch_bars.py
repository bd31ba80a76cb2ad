"""``chip_smoke.py``'s bars for the LM prefill slice, held on the CPU to
what they must pass and what they must catch.

- The flash bar (``flash_excess``) passes the kernel's own numerics (P
  rounded to bf16 before the PV product, one division by l at the end)
  and fails a causal mask shifted by one 64-key tile on the last quarter
  of the rows.
- The hidden-state bar (``rms_excess``) holds the rms of a difference to
  2^-7 of the rms of the value, whatever its scale, and fails a shift of
  a few percent.
- The SSD bound counts the least FLOP over chunk lengths.
"""
import os
import sys

import pytest
import torch

import torch_port_util  # noqa: F401  (torch lazy-module registries)
from repro_torch.kernels import ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

S, H, D, TILE = 2048, 2, 128, 64


@pytest.fixture(scope="module")
def qkv():
    g = torch.Generator().manual_seed(0)
    return [torch.randn((1, H, S, D), generator=g).bfloat16()
            for _ in range(3)]


def _kernel_numerics(q, k, v, shift_from=None):
    """Causal attention as the flash kernel rounds it; with ``shift_from``
    the rows from there on also see the next ``TILE`` keys."""
    s = (q.float() @ k.float().transpose(-1, -2)) * D ** -0.5
    rows = torch.arange(S)[:, None]
    reach = rows + (0 if shift_from is None else TILE * (rows >= shift_from))
    s = s.masked_fill(torch.arange(S)[None, :] > reach, -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    return ((p.bfloat16().float() @ v.float())
            / p.sum(-1, keepdim=True)).bfloat16()


def _abs_attn(q, k, v):
    return ref.attention(q, k, v.abs(), causal=True)


def test_flash_bar_passes_the_kernels_rounding(qkv):
    want = ref.attention(*qkv, causal=True)
    assert cs.flash_excess(_kernel_numerics(*qkv), want,
                           _abs_attn(*qkv)) <= 1.0


def test_flash_bar_catches_a_late_tile_shift(qkv):
    want = ref.attention(*qkv, causal=True)
    bad = _kernel_numerics(*qkv, shift_from=3 * S // 4)
    assert cs.flash_excess(bad, want, _abs_attn(*qkv)) > 4.0


@pytest.mark.parametrize("scale,off,want", [
    (1.0, 2 ** -7, 0.5),        # rms of the difference 2^-8, of w 1
    (8.0, 2 ** -4, 0.5),        # the same, eight times larger
    (1.0, 2 ** -5, 2.0),
])
def test_rms_excess(scale, off, want):
    w = torch.tensor([1.0, -1.0, 1.0, -1.0]) * scale
    g = w.clone()
    g[0] += off
    assert cs.rms_excess(g, w) == pytest.approx(want, rel=1e-6)


def test_rms_excess_catches_a_shift_of_a_few_percent():
    w = torch.randn(2560, generator=torch.Generator().manual_seed(1))
    assert cs.rms_excess(w.bfloat16(), w.bfloat16()) == 0.0
    assert cs.rms_excess((w * 1.03).bfloat16(), w.bfloat16()) > 1.0


@pytest.mark.parametrize("t", [1, 7, 256, 4096])
def test_ssd_flop_is_the_least_over_chunk_lengths(t):
    ds, dh = 128, 64

    def chunked(ln):
        n = -(-t // ln)
        pairs = ln * (ln + 1) // 2
        return 2 * n * (pairs * (ds + dh) + 2 * ln * ds * dh + ds * dh)
    least = cs.ssd_flop(1, t, ds, dh)
    assert least <= min(chunked(256), 5 * t * ds * dh)
    assert least == min(min(chunked(ln) for ln in range(1, min(t, 256) + 1)),
                        5 * t * ds * dh)
    assert cs.ssd_flop(48, t, ds, dh) == 48 * least
