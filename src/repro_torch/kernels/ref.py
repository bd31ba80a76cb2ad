"""Plain PyTorch versions of the kernels on the ported path.

Each function is the semantic twin of a function in ``repro/kernels/ref.py``
(the JAX package's oracles) and of a CUDA kernel in this package.  The
kernel wrappers run these for tensors on the CPU; ``chip_smoke.py`` runs
them on the card to hold each kernel against its plain version.

Float math is IEEE float32 throughout.  A float32 product on the card
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
                            "(the int8 path is a later slice)")


# ---------------------------------------------------------------- matmul ---
def matmul(a, b, bias=None, *, activation: str = "none"):
    """``activation(a @ b + bias)``: a (M, K), b (K, N), bias (N,)."""
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


# --------------------------------------------------------- banded align ---
def banded_align(query, target, *, band: int, match: int = 2,
                 mismatch: int = -4, gap: int = -2, local: bool = False):
    """Banded Needleman-Wunsch (global) / Smith-Waterman (local) int32
    scores, (P, m) x (P, n) -> (P,).

    Same function as ``repro/kernels/ref.py::banded_align`` (cells with
    |i - j| > band are -2**20 globally, 0 locally; boundary cells are set,
    not maxed).  This version walks the anti-diagonals, vectorised over
    pairs and cells, as the TPU kernel does; the CUDA kernel walks rows.
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
