"""Plain PyTorch versions of the kernels on the ported path.

Each function is the semantic twin of a function in ``repro/kernels/ref.py``
(the JAX package's oracles) and of a CUDA kernel in this package.  The
kernel wrappers run these for tensors on the CPU; ``chip_smoke.py`` runs
them on the card to hold each kernel against its plain version.

Float math is IEEE float32 throughout (bf16 operands are widened to
float32, summed in float32 and rounded once at the end, as JAX's
``preferred_element_type=float32``); the int8 MACs (``matmul_int8``,
``conv1d_int8``) are exact integer sums, and :func:`fma_f32` is the one
rounding of the int8 dequant epilogue.  A float32 product on the card
goes through cuBLAS, and a float32 convolution through cuDNN, which
defaults to TF32; every float function here first turns TF32 off for both
(:func:`full_fp32`), because the parity bars are float32 bars.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BIG = 2 ** 20


def full_fp32() -> None:
    """Turn TF32 off for cuBLAS products and cuDNN convolutions (both are
    process-wide PyTorch settings)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _squared_relu(x):
    return torch.square(F.relu(x))


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {
    "none": lambda x: x,
    "relu": F.relu,
    "squared_relu": _squared_relu,
    "silu": F.silu,
    "gelu": _gelu_tanh,
}
# the integer codes the CUDA kernels take for each activation
ACTIVATION_CODES = {"none": 0, "relu": 1, "squared_relu": 2, "silu": 3,
                    "gelu": 4}


def _float_only(name: str, *ts) -> None:
    for t in ts:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name}: float32 operands only, got {t.dtype} "
                            "(int8 operands: matmul_int8 / conv1d_int8)")


# ---------------------------------------------------------------- matmul ---
def matmul(a, b, bias=None, *, activation: str = "none"):
    """``activation(a @ b + bias)``: a (M, K), b (K, N), bias (N,).

    bf16 operands (``repro/kernels/ref.py::matmul``): the products summed
    in float32, bias and activation on the float32 sum, one rounding to
    bf16 at the end."""
    if a.dtype == torch.bfloat16 and b.dtype == torch.bfloat16:
        full_fp32()
        out = a.float() @ b.float()
        if bias is not None:
            out = out + bias.float()
        return ACTIVATIONS[activation](out).to(torch.bfloat16)
    _float_only("matmul", a, b, bias)
    full_fp32()
    out = a @ b
    if bias is not None:
        out = out + bias
    return ACTIVATIONS[activation](out)


# ---------------------------------------------------------------- conv1d ---
def conv1d(x, w, bias=None, *, stride: int = 1, activation: str = "none"):
    """'valid' strided conv: x (B, T, Cin), w (K, Cin, Cout) ->
    (B, T_out, Cout), as K shifted products (``repro/kernels/ref.py``)."""
    _float_only("conv1d", x, w, bias)
    full_fp32()
    ksize = w.shape[0]
    t_out = (x.shape[1] - ksize) // stride + 1
    acc = torch.zeros((x.shape[0], t_out, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for k in range(ksize):
        xk = x[:, k: k + (t_out - 1) * stride + 1: stride]
        acc = acc + torch.matmul(xk, w[k])
    if bias is not None:
        acc = acc + bias
    return ACTIVATIONS[activation](acc)


def split_tf32(v):
    """The 3xTF32 split of float32 ``v`` that the tensor-core conv makes
    (``csrc/mma.cuh`` split_tf32): ``hi`` is ``v`` rounded to tf32 (10
    explicit mantissa bits, to nearest with ties away from zero, as PTX
    ``cvt.rna.tf32.f32``), ``lo`` the same rounding of ``v - hi`` (exact in
    float32), both float32.  ``hi + lo`` is ``v`` to within 2^-22 of
    ``|v|``.  Infinities and NaNs pass through as ``hi`` (``lo`` NaN)."""
    def rna(u):
        bits = u.contiguous().view(torch.int32)
        mag = ((bits & 0x7FFFFFFF) + 0x1000) & -0x2000
        r = (mag | (bits & -0x80000000)).view(torch.float32)
        return torch.where(torch.isfinite(u), r, u)
    hi = rna(v)
    return hi, rna(v - hi)


# ------------------------------------------------------------ int8 MACs ---
def _int8_only(name: str, *ts) -> None:
    for t in ts:
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: int8 operands only, got {t.dtype}")


def _int_product(a, b):
    """int8 x int8 -> int32 product of (..., K) x (K, N).  CUDA has no int32
    matmul, so both devices run it in float64: every partial sum is an
    integer below 2**53 (at most 9 * 192 * 127**2 on the paper's CNN), so
    the float64 sums are exact in any order."""
    return torch.matmul(a.double(), b.double())


def matmul_int8(a, b):
    """a (M, K) int8 x b (K, N) int8 -> (M, N) int32."""
    _int8_only("matmul_int8", a, b)
    return _int_product(a, b).to(torch.int32)


def conv1d_int8(x, w, *, stride: int = 1):
    """'valid' strided conv, x (B, T, Cin) int8, w (K, Cin, Cout) int8 ->
    (B, T_out, Cout) int32, as K shifted products."""
    _int8_only("conv1d_int8", x, w)
    ksize = w.shape[0]
    t_out = (x.shape[1] - ksize) // stride + 1
    acc = torch.zeros((x.shape[0], t_out, w.shape[2]), dtype=torch.float64,
                      device=x.device)
    for k in range(ksize):
        xk = x[:, k: k + (t_out - 1) * stride + 1: stride]
        acc = acc + _int_product(xk, w[k])
    return acc.to(torch.int32)


def fma_f32(a, b, c=None):
    """``a * b + c`` on float32 tensors with one rounding, as CUDA's
    ``__fmaf_rn`` and the multiply-add XLA contracts under jit.

    The product of two float32 values is exact in float64.  The float64
    sum ``s`` then rounds once more to float32, which differs from one
    rounding only where ``s`` sits exactly halfway between two float32
    values while the exact sum does not (TwoSum error ``e != 0``); there
    the exact sum lies on ``e``'s side of ``s``."""
    p = a.double() * b.double()
    if c is None:
        return p.float()
    cd = c.double()
    s = p + cd
    v = s - p
    e = (p - (s - v)) + (cd - v)
    r = s.float()
    rd = r.double()
    other = torch.nextafter(r, torch.where(s > rd, torch.inf, -torch.inf)
                            .to(r.dtype))
    tie = ((rd + other.double()) * 0.5 == s) & (e != 0) & torch.isfinite(r)
    side = torch.where(e > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return torch.where(tie, side, r)


# --------------------------------------------------------- banded align ---
def banded_align(query, target, *, band: int, match: int = 2,
                 mismatch: int = -4, gap: int = -2, local: bool = False):
    """Banded Needleman-Wunsch (global) / Smith-Waterman (local) int32
    scores, (P, m) x (P, n) -> (P,).

    Same function as ``repro/kernels/ref.py::banded_align`` (cells with
    |i - j| > band are -2**20 globally, 0 locally; boundary cells are set,
    not maxed).  This version walks the anti-diagonals, vectorised over
    pairs and cells, as the TPU kernel does; the CUDA kernel walks them
    across a group of lanes, a strip of rows a lane.
    """
    if query.dtype != torch.int32 or target.dtype != torch.int32:
        raise TypeError("banded_align: int32 tokens only")
    if band < 0:
        raise ValueError(f"banded_align: band must be >= 0, got {band}")
    p, m = query.shape
    n = target.shape[1]
    dev = query.device
    neg = torch.tensor(-BIG, dtype=torch.int32, device=dev)
    floor = torch.zeros((), dtype=torch.int32, device=dev) if local else neg
    rows = torch.arange(m + 1, device=dev, dtype=torch.int32)[None, :]
    negcol = torch.full((p, 1), -BIG, dtype=torch.int32, device=dev)
    qdiag = torch.cat([torch.zeros((p, 1), dtype=torch.int32, device=dev),
                       query], dim=1)
    prev = torch.where(rows == 0, 0, neg).expand(p, m + 1).contiguous()
    prev2 = torch.full((p, m + 1), -BIG, dtype=torch.int32, device=dev)
    tdiag = torch.zeros((p, m + 1), dtype=torch.int32, device=dev)
    best = torch.zeros((p,), dtype=torch.int32, device=dev)
    for t in range(1, m + n + 1):
        t_new = target[:, min(t - 1, n - 1): min(t - 1, n - 1) + 1]
        tdiag = torch.cat([t_new, tdiag[:, :m]], dim=1)
        prev_shift = torch.cat([negcol, prev[:, :m]], dim=1)
        prev2_shift = torch.cat([negcol, prev2[:, :m]], dim=1)
        sub = torch.where(qdiag == tdiag, match, mismatch).to(torch.int32)
        new = torch.maximum(torch.maximum(prev_shift + gap, prev + gap),
                            prev2_shift + sub)
        edge0 = 0 if local else gap * t
        edge = (rows == 0) | (rows == t)
        new = torch.where(edge, torch.tensor(edge0, dtype=torch.int32,
                                             device=dev), new)
        j = t - rows
        valid = (j >= 0) & (j <= n) & ((rows - j).abs() <= band)
        new = torch.where(valid, new, floor)
        if local:
            new = torch.clamp_min(new, 0)
            best = torch.maximum(best, new.amax(dim=1))
        prev2, prev = prev, new
    return best if local else prev[:, m].contiguous()


# -------------------------------------------------------- flash attention ---
def _logits(q, k, v, causal: bool, scale):
    """Attention's float32 logits (B, Hq, Sq, Skv), scaled, the causal
    rows aligned to the last token (key j is seen by query i iff ``j <= i
    + (Skv - Sq)``) and masked to -inf, and V repeated over the query
    heads (GQA) in float32.  The heads repeat by ``expand``, whose
    gradient sums each KV head's query group by a reduction (the same
    bits on every run; ``repeat_interleave``'s scatters with atomics on
    the card)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"attention: {hq} query heads over {hkv} KV heads")
    scale = d ** -0.5 if scale is None else scale
    group = hq // hkv

    def heads(t):
        t = t.float()
        return t[:, :, None].expand(b, hkv, group, *t.shape[2:]).reshape(
            b, hq, *t.shape[2:])
    full_fp32()
    kk, vv = heads(k), heads(v)
    logits = torch.matmul(q.float(), kk.transpose(-1, -2)) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        kj = torch.arange(skv, device=q.device)[None, :]
        logits = logits.masked_fill(~(kj <= qi + (skv - sq)), -torch.inf)
    return logits, vv


def attention(q, k, v, *, causal: bool = True, scale=None):
    """Softmax attention, q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) with
    Hq % Hkv == 0 -> (B, Hq, Sq, D) in q's type
    (``repro/kernels/ref.py::attention``).

    GQA by repeating K/V; logits in float32 (:func:`_logits`); the
    float32 probabilities multiply V in float32 and the result is rounded
    once to q's type."""
    logits, vv = _logits(q, k, v, causal, scale)
    return torch.matmul(torch.softmax(logits, dim=-1), vv).to(q.dtype)


def flash(q, k, v, *, causal: bool = True, scale=None,
          p_dtype=torch.float32):
    """The function the flash kernels compute, in plain PyTorch: logits
    as :func:`attention`'s, ``P = exp(s - max s)`` rounded to ``p_dtype``
    before the product with V (the bf16 ``wgmma`` kernel rounds it to
    bf16; float32 leaves it), float32 sums, one division by ``l = sum
    exp(s - max s)`` at the end, one rounding to q's type.
    :func:`attention` (the probabilities unrounded) stays the oracle the
    card's bars measure against."""
    logits, vv = _logits(q, k, v, causal, scale)
    # the max only shifts the exponent: held constant for the gradient, as
    # jax.nn.softmax's stop_gradient
    p = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    out = torch.matmul(p.to(p_dtype).float(), vv)
    return (out / p.sum(-1, keepdim=True)).to(q.dtype)


# --------------------------------------------------------------- ssd scan ---
def ssd_scan(x, log_a, b, c, *, state0=None):
    """Mamba-2 SSD by its literal recurrence
    (``repro/kernels/ref.py::ssd_scan``), in float32:

        S_t = exp(log_a_t) S_{t-1} + b_t^T x_t,   y_t = c_t S_t

    x (BH, T, dh), log_a (BH, T), b/c (BH, T, ds); ``state0`` (BH, ds, dh)
    or zeros.  Returns ``(y (BH, T, dh) in x's type, final state (BH, ds,
    dh) float32)``."""
    bh, t, dh = x.shape
    ds = b.shape[-1]
    full_fp32()
    s = (torch.zeros((bh, ds, dh), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    xf, la = x.float(), log_a.float()
    bf, cf = b.float(), c.float()
    ys = []
    for i in range(t):
        s = (torch.exp(la[:, i])[:, None, None] * s
             + bf[:, i, :, None] * xf[:, i, None, :])
        ys.append(torch.bmm(cf[:, i, None, :], s)[:, 0])
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((bh, 0, dh), device=x.device))
    return y.to(x.dtype), s


def ssd_chunked(x, log_a, b, c, chunk: int, state0=None):
    """Chunked SSD in plain PyTorch (the jnp mirror of the Pallas kernel,
    ``repro/models/mamba2.py::ssd_chunked``), float32.  x: (BH, T, dh),
    log_a: (BH, T), b/c: (BH, T, ds); T a multiple of ``min(chunk, T)``.  Returns (y in x's type, final state
    (BH, ds, dh))."""
    bh, t, dh = x.shape
    ds = b.shape[-1]
    chunk = min(chunk, t)
    if t % chunk:
        raise ValueError(f"ssd_chunked: T={t} is not a multiple of chunk "
                         f"{chunk}")
    n = t // chunk
    full_fp32()
    xs = x.reshape(bh, n, chunk, dh).float()
    las = log_a.reshape(bh, n, chunk).float()
    bs = b.reshape(bh, n, chunk, ds).float()
    cs = c.reshape(bh, n, chunk, ds).float()
    rows = torch.arange(chunk, device=x.device)
    causal = rows[:, None] >= rows[None, :]
    s = (torch.zeros((bh, ds, dh), dtype=torch.float32, device=x.device)
         if state0 is None else state0.float())
    ys = []
    for i in range(n):
        xc, lac, bc_, cc = xs[:, i], las[:, i], bs[:, i], cs[:, i]
        cum = torch.cumsum(lac, dim=-1)                       # (BH, Lc)
        # exp only where s <= t: the masked entries are 0 either way
        seg = cum[:, :, None] - cum[:, None, :]
        decay = torch.exp(torch.where(causal, seg, -torch.inf))
        cb = torch.bmm(cc, bc_.transpose(1, 2))
        y = torch.bmm(cb * decay, xc)
        y = y + torch.bmm(cc * torch.exp(cum)[..., None], s)
        total = cum[:, -1]
        w = torch.exp(total[:, None] - cum)                   # (BH, Lc)
        s = (torch.exp(total)[:, None, None] * s
             + torch.bmm((bc_ * w[..., None]).transpose(1, 2), xc))
        ys.append(y.to(x.dtype))
    return torch.stack(ys, dim=1).reshape(bh, t, dh), s


# --------------------------------------------------------- edit distance ---
def edit_distance(query, target, q_len=None, t_len=None):
    """Batched Levenshtein distance by the row-scan DP of
    ``repro/kernels/ref.py::edit_distance``: (P, m) x (P, n) int tokens ->
    (P,) int32.  Optional per-pair lengths ``q_len`` / ``t_len`` (P,) let
    padded batches ignore the tokens past them.

    The row for target position ``j`` is ``new[i] = min(new[i-1] + 1,
    c[i])`` with ``c[i] = min(up + 1, diag + cost)``; unrolled, ``new[i] =
    i + min(new[0], min_{k < i} c[k] - k - 1)``, a running minimum over the
    row (``torch.cummin``), so each of the ``n`` rows is a few vector ops.
    Past ``q_len`` a cell copies its left neighbour, as in the JAX scan.
    Integer arithmetic: the same values as the cell-by-cell scan."""
    p, m = query.shape
    n = target.shape[1]
    dev = query.device
    query = query.to(torch.int32)
    target = target.to(torch.int32)
    q_len = (torch.full((p,), m, dtype=torch.int64, device=dev)
             if q_len is None else q_len.to(device=dev, dtype=torch.int64))
    t_len = (torch.full((p,), n, dtype=torch.int64, device=dev)
             if t_len is None else t_len.to(device=dev, dtype=torch.int64))
    idx = torch.arange(m + 1, dtype=torch.int32, device=dev)
    row = idx.expand(p, m + 1).contiguous()
    past = idx[None, 1:] > q_len[:, None]           # cell i+1 with i >= q_len
    for j in range(n):
        cost = (query != target[:, j: j + 1]).to(torch.int32)
        c = torch.minimum(row[:, 1:] + 1, row[:, :-1] + cost)   # (P, m)
        first = row[:, :1] + 1
        run = torch.cummin(torch.cat([first, c - idx[None, 1:]], dim=1),
                           dim=1).values
        new = run + idx[None, :]
        new_q = new.gather(1, q_len[:, None])
        new = torch.cat([new[:, :1], torch.where(past, new_q, new[:, 1:])],
                        dim=1)
        row = torch.where((j < t_len)[:, None], new, row)
    return row.gather(1, q_len[:, None])[:, 0].contiguous()


def edit_distance_np(q, t) -> int:
    """Single-pair classic O(mn) numpy DP, cell by cell (the JAX package's
    ``edit_distance_np``): the oracle for :func:`edit_distance`."""
    import numpy as np
    m, n = len(q), len(t)
    row = np.arange(m + 1, dtype=np.int64)
    for j in range(1, n + 1):
        prev = row.copy()
        row[0] = j
        for i in range(1, m + 1):
            row[i] = min(row[i - 1] + 1, prev[i] + 1,
                         prev[i - 1] + (q[i - 1] != t[j - 1]))
    return int(row[m])
