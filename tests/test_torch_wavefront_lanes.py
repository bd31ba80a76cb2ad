"""The wavefront kernel's lane schedule (``csrc/banded_align.cu``), on the
CPU.

* ``edit_distance.plan``: G lanes a pair, R query rows a lane, stripes of
  G * R rows, and where a stripe hands its last row to the next, at the
  path's shapes and the limits.
* A plain-PyTorch emulation of the kernel's schedule, step by step: lane l
  computes target column s - l for its strip of R rows at step s, the cell
  above its strip arriving from lane l - 1 as a shift of the lanes' bottom
  cells, the diagonal the value that arrived a step before; stripes past
  G * R rows hand on their last row; rows past m are computed and kept out
  of the score; the band test and the local floor as the kernel applies
  them.  It equals JAX's ``banded_align`` and ``levenshtein`` run with
  ``interpret=True`` bit for bit, at the demux's, the mapper's and a
  scaled firehose's shapes, bands 0 and 3, m not a multiple of R, and m
  in several stripes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util as U
from repro.kernels import edit_distance as jed
from repro_torch.kernels import _build
from repro_torch.kernels import edit_distance as ked
from repro_torch.kernels import ref

NEG = -(1 << 20)
PAD = -(1 << 30)


def lanes(q, t, *, band, match, mismatch, gap, local, lay=None):
    """The kernel's schedule over (pairs, lanes) tensors: one loop step is
    one step of the warp, one inner iteration one row of every strip."""
    p, m = q.shape
    n = t.shape[1]
    lay = lay or ked.plan(m, n)
    g, r_rows = lay.groups, lay.rows
    h = g * r_rows
    stripes = -(-m // h) if m > h else 1
    agap = abs(gap)
    floor = 0 if local else NEG
    lane = torch.arange(g)

    def first_col(i):
        if local:
            return torch.zeros_like(i)
        return torch.where(i * agap <= band * agap, i * gap,
                           torch.full_like(i, NEG))

    def first_row(jj):
        return (0 if local else gap * jj) if jj <= band else floor

    best = torch.zeros(p, dtype=torch.int64)
    hand = None
    for k in range(stripes):
        top = k * h + lane * r_rows                      # (G,)
        i = top[:, None] + torch.arange(r_rows)[None] + 1  # (G, R)
        col = first_col(i).expand(p, g, r_rows).clone()
        qr = torch.where(i <= m, q[:, (i - 1).clamp(0, max(m - 1, 0))]
                         if m else torch.zeros(p, g, r_rows, dtype=q.dtype),
                         0)
        pen = torch.where(i <= m, 0, PAD)
        diag = first_col(top).expand(p, g).clone()
        bottom = torch.zeros(p, g, dtype=torch.int64)
        out_hand = torch.zeros(p, n, dtype=torch.int64)
        for s in range(n + g - 1 if n else 0):
            # the lanes' bottom cells shifted one lane down (shfl_up)
            up = torch.cat([bottom[:, :1], bottom[:, :-1]], dim=1)
            j = s - lane
            active = (j >= 0) & (j < n)
            tj = t[:, j.clamp(0, n - 1)]                 # (P, G)
            if s < n:
                up[:, 0] = hand[:, s] if k else first_row(s + 1)
            u, d = up, diag
            new = col.clone()
            for r in range(r_rows):
                left = col[:, :, r]
                sub = torch.where(qr[:, :, r] == tj, match, mismatch)
                x = torch.maximum(left + gap, d + sub)
                v = torch.maximum(u + gap, x)
                if local:
                    v = v.clamp_min(0)
                if band < max(m, n):
                    v = torch.where((top + r - j).abs() > band, floor, v)
                if local:
                    seen = torch.where(active, v + pen[:, r], PAD)
                    best = torch.maximum(best, seen.amax(dim=1))
                d, u = left, v
                new[:, :, r] = v
            col = torch.where(active[None, :, None], new, col)
            bottom = torch.where(active, new[:, :, -1], bottom)
            if k + 1 < stripes and active[-1]:
                out_hand[:, j[-1]] = new[:, -1, -1]
            diag = torch.where(active, up, diag)
        hand = out_hand
    if local:
        return best.int()
    if m == 0:
        return torch.full((p,), first_row(n), dtype=torch.int32)
    rel = m - 1 - (stripes - 1) * h
    return col[:, rel // r_rows, rel % r_rows].int()


def _pairs(seed, p, m, n, err=0.15):
    rng = np.random.default_rng(seed)
    q = rng.integers(1, 5, (p, m)).astype(np.int32)
    t = np.concatenate([q, rng.integers(1, 5, (p, max(n - m, 0)))],
                       axis=1)[:, :n]
    # token 0 in the targets only: the kernel's padded rows hold 0, so a
    # padded row that leaked into the score would match it
    t = np.where(rng.random(t.shape) < err, rng.integers(0, 5, t.shape),
                 t).astype(np.int32)
    t[0] = rng.integers(0, 5, n)                       # one unrelated pair
    return q, t


def _jax(q, t, **kw):
    return np.asarray(jed.banded_align(jnp.asarray(q), jnp.asarray(t),
                                       block_p=len(q), interpret=True, **kw))


@pytest.mark.parametrize("m,n,want", [
    (12, 12, (4, 3, 1, "none")),         # the demux
    (48, 80, (16, 3, 1, "none")),        # the mapper
    (256, 512, (32, 8, 1, "none")),      # the pathogen firehose
    (64, 128, (16, 4, 1, "none")),
    (13, 20, (4, 4, 1, "none")),         # 3 rows of the last strip padded
    (1, 5, (1, 1, 1, "none")),
    (0, 5, (1, 1, 1, "none")),
    (257, 40, (32, 8, 2, "shared")),
    (908, 908, (32, 8, 4, "shared")),
    (1000, 1000, (32, 8, 4, "shared")),
    (2048, 2048, (32, 8, 8, "shared")),
    (300, 29_056, (32, 8, 2, "shared")),  # 2 warps x n ints: the limit
    (300, 29_057, (32, 8, 2, "scratch")),
])
def test_plan(m, n, want):
    assert tuple(ked.plan(m, n)) == want


def test_plan_covers_every_query_length():
    for m in range(0, 700):
        g, r, stripes, handoff = ked.plan(m, 100)
        assert g & (g - 1) == 0 and 1 <= g <= ked.LANES
        assert 1 <= r <= ked.ROWS_MAX
        assert g * r * stripes >= m
        if stripes == 1:
            assert handoff == "none" and g * (r - 1) < max(m, 1)
        else:
            assert (g, r) == (ked.LANES, ked.ROWS_MAX)
            assert g * r * (stripes - 1) < m
            assert ked.WARPS * 100 * 4 <= _build.SMEM_LIMIT
            assert handoff == "shared"


@pytest.mark.parametrize("p,m,n,band,local", [
    (16, 48, 80, 32, True),        # the mapper
    (8, 64, 128, 128, True),       # a scaled firehose: band >= max(m, n)
    (8, 20, 25, 0, False),
    (8, 20, 25, 0, True),
    (8, 20, 25, 3, False),
    (8, 20, 25, 3, True),
    (8, 13, 17, 5, False),         # m not a multiple of R: padded rows
    (8, 13, 17, 5, True),
    (4, 300, 24, 300, False),      # two stripes of 256 rows
    (4, 300, 24, 16, True),
], ids=lambda v: str(v))
def test_schedule_equals_jax_banded_align(p, m, n, band, local):
    q, t = _pairs(m * 7 + n + band, p, m, n)
    kw = dict(band=band, match=2, mismatch=-4, gap=-2, local=local)
    got = U.n(lanes(U.t(q).long(), U.t(t).long(), **kw))
    np.testing.assert_array_equal(got, _jax(q, t, **kw))
    np.testing.assert_array_equal(
        got, U.n(ref.banded_align(U.t(q), U.t(t), **kw)))


@pytest.mark.parametrize("lay", [ked.Plan(4, 2, 3, "shared"),
                                 ked.Plan(2, 3, 4, "scratch"),
                                 ked.Plan(1, 1, 21, "shared")],
                         ids=["4x2", "2x3", "1x1"])
@pytest.mark.parametrize("band,local", [(3, False), (3, True), (30, False),
                                        (30, True)])
def test_schedule_in_many_stripes_equals_jax(lay, band, local):
    """Narrow layouts put a 21-row query in 3 to 21 stripes."""
    q, t = _pairs(21 + band + local, 8, 21, 26)
    kw = dict(band=band, match=2, mismatch=-4, gap=-2, local=local)
    got = U.n(lanes(U.t(q).long(), U.t(t).long(), lay=lay, **kw))
    np.testing.assert_array_equal(got, _jax(q, t, **kw))


@pytest.mark.parametrize("p,m,n", [(24, 12, 12), (8, 13, 9), (8, 40, 33)])
def test_schedule_equals_jax_levenshtein(p, m, n):
    """levenshtein is the kernel with unit costs, global and band =
    max(m, n), its distance the negated score."""
    q, t = _pairs(m + 3 * n, p, m, n, err=0.3)
    got = -U.n(lanes(U.t(q).long(), U.t(t).long(), band=max(m, n),
                     match=0, mismatch=-1, gap=-1, local=False))
    want = np.asarray(jed.levenshtein(jnp.asarray(q), jnp.asarray(t),
                                      block_p=p, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, U.n(ref.edit_distance(U.t(q), U.t(t))))


@pytest.mark.parametrize("local", [False, True])
def test_schedule_empty_query(local):
    """m = 0: the global score is the first row's last cell, the local 0."""
    t = np.ones((3, 5), np.int32)
    q = np.zeros((3, 0), np.int32)
    kw = dict(band=2, match=2, mismatch=-4, gap=-2, local=local)
    got = U.n(lanes(U.t(q).long(), U.t(t).long(), **kw))
    want = U.n(ref.banded_align(U.t(q), U.t(t), **kw))
    np.testing.assert_array_equal(got, want)
