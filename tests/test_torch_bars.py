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
- The 32,768 flash check's bands (first, middle, last rows) are the full
  attention's rows, and ``scripts/planted_faults.py``'s mutations and
  ``scripts/kernel_variants.py``'s patches apply to the kernels' sources.
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

sys.path.insert(0, os.path.join(ROOT, "scripts"))
import kernel_variants as kv  # noqa: E402
import planted_faults as pf  # noqa: E402

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


def _exp2_numerics(q, k, v):
    """Causal attention as the wgmma flash kernel rounds it: logits times
    scale * log2(e), p = exp2(t - max t) in f32, P rounded to bf16."""
    sl2 = D ** -0.5 * 1.4426950408889634
    t = (q.float() @ k.float().transpose(-1, -2)) * sl2
    t = t.masked_fill(torch.arange(S)[None, :] > torch.arange(S)[:, None],
                      -1e30)
    p = torch.exp2(t - t.amax(-1, keepdim=True))
    return ((p.bfloat16().float() @ v.float())
            / p.sum(-1, keepdim=True)).bfloat16()


def test_flash_bar_passes_the_exp2_form(qkv):
    want = ref.attention(*qkv, causal=True)
    assert cs.flash_excess(_exp2_numerics(*qkv), want,
                           _abs_attn(*qkv)) <= 1.0


@pytest.mark.parametrize("sq,skv,rows", [(64, 64, 8), (48, 80, 16),
                                         (33, 33, 4)])
def test_flash_bands_are_rows_of_the_full_attention(sq, skv, rows):
    g = torch.Generator().manual_seed(sq)
    q = torch.randn((1, 2, sq, 16), generator=g)
    k, v = (torch.randn((1, 2, skv, 16), generator=g) for _ in range(2))
    full = ref.attention(q, k, v, causal=True)
    bands = cs.flash_bands(sq, skv, rows)
    assert [b - a for a, b, _ in bands] == [rows] * 3
    assert bands[0][0] == 0 and bands[-1][1] == sq
    assert bands[1][0] <= sq // 2 < bands[1][1]
    for a, b, e in bands:
        got = ref.attention(q[:, :, a:b], k[:, :, :e], v[:, :, :e],
                            causal=True)
        torch.testing.assert_close(got, full[:, :, a:b], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("name", sorted(pf.MUTATIONS))
def test_planted_fault_applies_to_the_flash_source(name):
    path = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                        pf.FA_SRC)
    with open(path) as f:
        text = f.read()
    mutated = pf.mutate(text, name)
    assert mutated != text
    for old, new in pf.MUTATIONS[name]:
        assert new in mutated
    with pytest.raises(RuntimeError, match="found 0 times"):
        pf.mutate(mutated, name)      # each mutation applies once only


VARIANT_TABLES = {"matmul.cu": kv.GEMM, "flash_attention.cu": kv.FLASH,
                  "conv1d.cu": kv.CONV, "fused_stream.cu": kv.FUSED}


@pytest.mark.parametrize("file,name", [
    (file, n) for file, table in VARIANT_TABLES.items() for n in sorted(table)])
def test_kernel_variant_patches_apply_to_the_source(file, name):
    path = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", file)
    with open(path) as f:
        text = f.read()
    table = VARIANT_TABLES[file]
    assert kv.patch(text, name, table[name]) != text


@pytest.mark.parametrize("file,table,name", [
    (file, table, n) for file, table in (("flash_attention.cu", "FLASH_F32"),
                                         ("ssd_scan.cu", "SSD"))
    for n in sorted(getattr(kv, table))])
def test_f32_flash_and_ssd_variant_patches_apply_to_the_source(file, table,
                                                               name):
    """The 3xTF32 flash variants and the SSD ones (some a function of the
    source text) each apply once to the sound source."""
    path = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc", file)
    with open(path) as f:
        text = f.read()
    patches = getattr(kv, table)[name]
    if callable(patches):
        patches = patches(text)
    assert kv.patch(text, name, patches) != text
