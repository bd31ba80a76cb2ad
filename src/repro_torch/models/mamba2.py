"""Mamba-2 (SSD) block, the full-sequence (prefill) path
(``repro/models/mamba2.py``).

Block layout (the Mamba-2 paper, one B/C group):
  in_proj: d -> [z (d_in), x (d_in), B (ds), C (ds), dt (heads)]
  depthwise causal conv (width 4) over [x B C]
  per-head scalar decay: log_a = -exp(A_log) * dt,  dt = softplus(dt + bias)
  y = SSD(x * dt, log_a, B, C) + D * x ;  out = out_proj(rmsnorm(y) * silu(z))

With no incoming state, ``mamba_block`` runs ``ops.ssd_scan`` (the Hopper
kernels, or the plain recurrence on the CPU) and, when asked for it
(``return_state``), forms the final state in closed form; with one, the
plain chunked scan :func:`ssd_chunked`.  A prefill discards the state, so
it skips that product (under ``jax.jit`` JAX drops it as dead code).

``mamba_decode`` is one token of the recurrence, JAX's jnp code (no
kernel): the conv window slides by one row and the float32 SSM state
takes one step, both in the caches of :func:`init_mamba_cache`.
"""
from __future__ import annotations

import torch

from repro_torch.distributed import tp
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels.ref import ssd_chunked  # noqa: F401
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense, row_dense, silu
from repro_torch.models.param import ScopedBuilder


def init_mamba(b: ScopedBuilder, cfg: ModelConfig):
    d = cfg.d_model
    di, ds, nh = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    b.param("in_proj", (d, 2 * di + 2 * ds + nh), ("embed", "ssm_inner"))
    b.param("conv_w", (cfg.ssm_conv_width, conv_dim), (None, "ssm_inner"))
    b.param("conv_b", (conv_dim,), ("ssm_inner",), init="zeros")
    b.param("A_log", (nh,), ("ssm_heads",), init="zeros", dtype=torch.float32)
    b.param("dt_bias", (nh,), ("ssm_heads",), init="zeros",
            dtype=torch.float32)
    b.param("D", (nh,), ("ssm_heads",), init="ones", dtype=torch.float32)
    b.param("norm_scale", (di,), ("ssm_inner",), init="ones",
            dtype=torch.float32)
    b.param("out_proj", (di, d), ("ssm_inner", "embed"))


def _local_dims(cfg: ModelConfig, proj_width: int) -> tuple[int, int, int]:
    """(d_inner, ssm_state, heads) from the in_proj output width:
    W = 2*di + 2*ds + nh with di = nh*dh."""
    ds, dh = cfg.ssm_state, cfg.ssm_head_dim
    nh = (proj_width - 2 * ds) // (2 * dh + 1)
    return nh * dh, ds, nh


def _split_proj(cfg: ModelConfig, proj):
    di, ds, nh = _local_dims(cfg, proj.shape[-1])
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * ds]
    dt = proj[..., -nh:]
    return z, xbc, dt


def _sum_squares(yf):
    """The sum of squares over the last dim, as two half-width sums added:
    the order of the all-reduce over two ranks, so that TP 2 gives TP 1's
    bits.  Only degree 2: at TP 4 each rank sums a quarter, and TP 4 parts
    from TP 1 at this op.  One full-width ``torch.sum``
    reassociates otherwise: at the smoke width (128) it parted from the
    two-rank sum on 44.6% of seeded rows, where XLA's order (windows of 32
    summed in turn) parts on 19.5% (``scripts/mamba_tp_parity.py``)."""
    sq = torch.square(yf)
    h = sq.shape[-1] // 2
    return (torch.sum(sq[..., :h], dim=-1, keepdim=True)
            + torch.sum(sq[..., h:], dim=-1, keepdim=True))


def _gated_rmsnorm(y, z, scale, eps: float, full_di: int):
    """RMSNorm(y) * silu(z) with the normaliser over the whole d_inner:
    under tensor parallelism a rank holds di / tp features, so its sum of
    squares is all-reduced and divided by the full width."""
    yf = y.float()
    if tp.axis() is not None and y.shape[-1] < full_di:
        ss = tp.psum(torch.sum(torch.square(yf), dim=-1, keepdim=True))
    else:
        ss = _sum_squares(yf)
    out = (yf * torch.rsqrt(ss / full_di + eps) * scale).to(y.dtype)
    return out * silu(z)


def _causal_conv(xbc, w, bias):
    """Depthwise causal conv over (B, S, C) with (K, C) weights, then
    SiLU; the K terms summed in order in the model's dtype, as JAX."""
    k = w.shape[0]
    s = xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i: i + s] * w[i] for i in range(k))
    return silu(out + bias)


def final_state(x, log_a, b):
    """The scan's final state in closed form, ``sum_t exp(cum_T - cum_t)
    b_t^T x_t`` (BH, ds, dh) float32, as ``mamba2.py:158-163`` forms it
    beside the kernel (which returns y only)."""
    ref.full_fp32()
    cum = torch.cumsum(log_a.float(), dim=1)                 # (BH, T)
    w = torch.exp(cum[:, -1:] - cum)                         # decay t -> T
    return torch.bmm((b.float() * w[..., None]).transpose(1, 2), x.float())


def mamba_block(p, x, cfg: ModelConfig, *, ssm_state=None,
                return_state: bool = False):
    """Prefill path.  x: (B, S, d) -> (y, (conv_state, ssm_state)); the
    conv state is dropped (None), as in JAX, and the SSM state is None
    unless ``return_state`` or an incoming ``ssm_state`` asks for it."""
    bsz, s, _ = x.shape
    dh = cfg.ssm_head_dim
    proj = dense(x, p["in_proj"])
    di, ds, nh = _local_dims(cfg, proj.shape[-1])
    z, xbc, dt = _split_proj(cfg, proj)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin = xbc[..., :di]
    b_in = xbc[..., di: di + ds].contiguous()
    c_in = xbc[..., di + ds:].contiguous()
    dt = torch.logaddexp(dt.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))  # softplus
    log_a = -torch.exp(p["A_log"]) * dt                      # (B, S, nh)

    xh = xin.reshape(bsz, s, nh, dh) * dt.to(xin.dtype)[..., None]
    bh = bsz * nh
    # contiguous per head (at batch 1 the reshape alone is a strided view)
    xf = xh.transpose(1, 2).reshape(bh, s, dh).contiguous()
    la = log_a.transpose(1, 2).reshape(bh, s).contiguous()
    # the heads share B/C (one group): at batch 1 a stride-0 view, which
    # the kernel reads per batch row
    bf = b_in[:, None].expand(bsz, nh, s, ds).reshape(bh, s, ds)
    cf = c_in[:, None].expand(bsz, nh, s, ds).reshape(bh, s, ds)
    if ssm_state is None:
        y = ops.ssd_scan(xf, la, bf, cf, chunk=cfg.ssm_chunk)
        s_final = final_state(xf, la, bf) if return_state else None
    else:
        y, s_final = ssd_chunked(xf, la, bf, cf, cfg.ssm_chunk,
                                 state0=ssm_state)
    y = y.reshape(bsz, nh, s, dh).transpose(1, 2)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(bsz, s, di)
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps, cfg.ssm_d_inner)
    out = row_dense(y, p["out_proj"], full_in=cfg.ssm_d_inner)
    return out, (None, s_final)


# ------------------------------------------------------------- decode ----
def init_mamba_cache(cfg: ModelConfig, batch: int, n_layers: int,
                     dtype=torch.bfloat16, *, device="cuda"):
    """``{"conv": (n_layers, batch, K - 1, conv_dim) in ``dtype``, "ssm":
    (n_layers, batch * heads, ds, dh) float32}``, zeros: the SSM state is
    float32 whatever the model's dtype.  Under tensor parallelism a rank
    carries its heads / tp heads' state (and the replicated B/C columns of
    the conv window)."""
    ds, nh = cfg.ssm_state, cfg.ssm_heads // tp.extent()
    conv_dim = nh * cfg.ssm_head_dim + 2 * ds
    return {
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv_width - 1,
                             conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((n_layers, batch * nh, ds, cfg.ssm_head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(p, x, cfg: ModelConfig, conv_state, ssm_state):
    """One-token decode.  x: (B, 1, d); conv_state: (B, K-1, conv_dim);
    ssm_state: (B*nh, ds, dh) float32.  Returns (y, new_conv, new_ssm),
    new tensors (the caller stores them).  As in JAX, ``x * dt`` and the
    state update run in float32 (a bf16 x times the float32 dt)."""
    bsz = x.shape[0]
    dh = cfg.ssm_head_dim
    proj = dense(x, p["in_proj"])
    di, ds, nh = _local_dims(cfg, proj.shape[-1])
    z, xbc_new, dt = _split_proj(cfg, proj)
    window = torch.cat([conv_state.to(x.dtype), xbc_new], dim=1)
    conv = sum(window[:, i] * p["conv_w"][i]
               for i in range(cfg.ssm_conv_width))
    xbc = silu(conv + p["conv_b"])[:, None]                  # (B, 1, conv)
    new_conv_state = window[:, 1:]
    xin = xbc[..., :di]
    b_in = xbc[..., di: di + ds]
    c_in = xbc[..., di + ds:]
    dt = torch.logaddexp(dt.float() + p["dt_bias"],
                         torch.zeros((), device=x.device))  # softplus
    a = torch.exp(-torch.exp(p["A_log"]) * dt)               # (B, 1, nh)

    xh = (xin.reshape(bsz, nh, dh) * dt[:, 0, :, None]).reshape(
        bsz * nh, dh)
    bf = b_in[:, 0][:, None].expand(bsz, nh, ds).reshape(bsz * nh, ds)
    cf = c_in[:, 0][:, None].expand(bsz, nh, ds).reshape(bsz * nh, ds)
    af = a[:, 0].reshape(bsz * nh)
    ref.full_fp32()
    new_ssm = (af[:, None, None] * ssm_state
               + bf.float()[:, :, None] * xh.float()[:, None, :])
    y = torch.bmm(cf.float()[:, None, :], new_ssm)[:, 0]    # (B*nh, dh)
    y = y.reshape(bsz, nh, dh) + (xh.reshape(bsz, nh, dh)
                                  * p["D"][None, :, None])
    y = y.reshape(bsz, 1, di).to(x.dtype)
    y = _gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps,
                       cfg.ssm_d_inner)
    out = row_dense(y, p["out_proj"], full_in=cfg.ssm_d_inner)
    return out, new_conv_state, new_ssm
