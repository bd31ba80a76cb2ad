"""Mixture-of-Experts with capacity-bounded top-k dispatch
(``repro/models/moe.py``).

Two implementations behind one init, as JAX's:

* ``dispatch``: top-k routing, each (row, choice) given a slot inside its
  own batch row's capacity slice, tokens scattered into an (E, B * cap,
  d) buffer, the experts' FFN as batched products, and the results
  gathered back and gate-combined;
* ``dense``: every expert on every token, gate-weighted (exact, no
  drops; the smoke configs' choice and the routing oracle in tests).

Router: softmax over the experts' logits in float32, top-k, the gates
renormalised over the chosen experts; a Switch-style load-balance loss
is returned beside the output.  JAX computes all of it in jnp, outside
any Pallas kernel, so here it is plain PyTorch: ``torch.einsum`` and
``torch.matmul`` (the card's cuBLAS), index scatter and gather.

Two of JAX's semantics are mirrored exactly:

* ``jax.lax.top_k`` takes the lower index first among equal values;
  ``torch.topk`` promises no order for ties, so the top k come from a
  stable descending sort.
* A token that overflows its row's capacity gets the column ``(row + 1)
  * cap``: JAX's scatter drops it only where that is out of bounds (the
  last row) and otherwise **adds** it into slot 0 of the next row's
  slice for that expert, whose output then carries it (its own gate is
  zeroed).  ROADMAP.md Queue 3 entry 8 records it for the reference's
  owners; the port scatters the same way (colliding rows add, the one
  out-of-bounds column goes to a spare column that is then cut off) and
  the gather reads zeros there.

On a data axis (``tp.data_ctx``, bound by ``trainer.mesh_loss_and_grads``)
each data rank routes its own rows, and two of JAX's global-batch
semantics cross the ranks (JAX's GSPMD step computes over the whole
batch):

* the load-balance loss ``E * sum(me * ce)`` is a product of means over
  every token, so ``me`` and ``ce`` are averaged over the data ranks
  before the product (``tp.data_mean``; the psum's backward a psum);
* the last row's overflow, which JAX adds into slot 0 of the next row's
  slice, belongs to the next data rank's first row: the spare column's
  (E, d) sum is handed on to it (``tp.from_previous_data_rank``), and its
  gradient back; the last data rank drops its own, as JAX drops the last
  row's.

On a mesh (``sharding.mesh_plan``) the experts are placed as JAX's specs
place them.  Expert parallelism (``"expert"`` over data, the expert
leaves holding E / D experts a data rank): ``moe_dispatch`` sends each
expert's (B_local * cap, d) rows to the rank that holds it and brings
the results back, by all-to-all over data (``tp.exchange_data``), after
the carried overflow has been added into column 0, so it lands in the
next row's slot 0 as before; ``moe_dense`` all-gathers the tokens and
their gate weights over data, runs them through the local experts and
reduce-scatters the gate-weighted sums (``tp.gather_data``,
``tp.scatter_data``).  The experts' ``mlp`` over the model axis: each
model rank holds ``wi``/``wi_gate`` columns and ``wo`` rows of every
local expert (and of the shared expert), and the layer's output is
summed over the model ranks once (``tp.psum``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.distributed import tp
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import ScopedBuilder

# jax.nn's activations: gelu is its tanh form, silu rounds after each op
_ACT = {
    "silu": L.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "squared_relu": lambda x: torch.square(F.relu(x)),
}


def init_moe(b: ScopedBuilder, cfg: ModelConfig):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    b.param("router", (d, e), ("embed", None), scale=0.02,
            dtype=torch.float32)
    if cfg.mlp_gated:
        b.param("wi_gate", (e, d, ff), ("expert", "embed", "mlp"))
        b.param("wi", (e, d, ff), ("expert", "embed", "mlp"))
    else:
        b.param("wi", (e, d, ff), ("expert", "embed", "mlp"))
    b.param("wo", (e, ff, d), ("expert", "mlp", "embed"))
    if cfg.moe_shared_expert:
        b.param("shared_wi_gate", (d, ff), ("embed", "mlp"))
        b.param("shared_wi", (d, ff), ("embed", "mlp"))
        b.param("shared_wo", (ff, d), ("mlp", "embed"))


def _local_experts(p, cfg: ModelConfig) -> int:
    """The experts this rank holds: all of them, or E / D under expert
    parallelism, which needs the data region of D ranks."""
    e_l = p["wo"].shape[0]
    if e_l != cfg.num_experts and e_l * tp.data_extent() != cfg.num_experts:
        raise ValueError(
            f"moe: {e_l} of {cfg.num_experts} experts on this rank, over "
            f"{tp.data_extent()} data ranks")
    return e_l


def _model_sliced(p, cfg: ModelConfig) -> bool:
    """Whether the experts' ``mlp`` is this model rank's slice (the mesh
    plan's), so the layer's output is a partial sum."""
    if p["wo"].shape[-2] == cfg.d_ff:
        return False
    if tp.axis() is None:
        raise ValueError(f"moe: experts' mlp of {p['wo'].shape[-2]} of "
                         f"{cfg.d_ff} outside a tensor-parallel context")
    return True


def _expert_ffn(p, x_ecd: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = _ACT[cfg.activation]
    h = torch.einsum("ecd,edf->ecf", x_ecd, p["wi"])
    if cfg.mlp_gated:
        h = act(torch.einsum("ecd,edf->ecf", x_ecd, p["wi_gate"])) * h
    else:
        h = act(h)
    return torch.einsum("ecf,efd->ecd", h, p["wo"])


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last dim: the k largest, ties to the
    lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(p, x_flat: torch.Tensor, cfg: ModelConfig):
    """x_flat: (T, d) -> (gates (T, k), idx (T, k), aux), all float32 but
    the int64 idx.  On a data axis ``me`` and ``ce`` are the means over
    every data rank's tokens."""
    logits = torch.matmul(x_flat.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    k = cfg.experts_per_token
    gates, idx = top_k(probs, k)
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    # Switch-style load balance: E * sum_e f_e * p_e
    e = cfg.num_experts
    me = probs.mean(dim=0)
    flat = idx.reshape(-1)
    ce = torch.zeros((e,), dtype=torch.float32, device=probs.device)
    ce = ce.index_add(0, flat, torch.full(
        flat.shape, 1.0 / (x_flat.shape[0] * k), dtype=torch.float32,
        device=probs.device))
    aux = e * torch.sum(tp.data_mean(me) * tp.data_mean(ce))
    return gates, idx, aux


def routing(idx: torch.Tensor, bsz: int, s: int, cfg: ModelConfig):
    """JAX's slot assignment from the router's ``idx`` (B * S, k): each
    (row, choice)'s ``slot`` in its expert's column of its batch row, in
    token-then-choice order, ``keep`` where it fits the row's capacity
    ``cap_row``, and the scatter column ``col = row * cap_row + min(slot,
    cap_row)``; all (B, S, k), and ``cap_row``."""
    e, k = cfg.num_experts, cfg.experts_per_token
    cap_row = max(int(s * k * cfg.moe_capacity_factor / e), 1)
    idx_r = idx.reshape(bsz, s * k)
    onehot = F.one_hot(idx_r, e)                          # (B, S*k, E)
    pos = torch.cumsum(onehot, dim=1) - onehot
    slot = torch.gather(pos, 2, idx_r[..., None])[..., 0]  # (B, S*k)
    keep = slot < cap_row
    slot_c = torch.where(keep, slot, torch.full_like(slot, cap_row))
    rows = torch.arange(bsz, device=idx.device)[:, None]
    col = rows * cap_row + slot_c
    return (slot.reshape(bsz, s, k), keep.reshape(bsz, s, k),
            col.reshape(bsz, s, k), cap_row)


def moe_dispatch(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y, aux) by capacity-bounded top-k dispatch.

    The scatter adds colliding rows (``index_put_(..., accumulate=True)``)
    into an (E, B * cap + 1, d) buffer whose last column takes the one
    out-of-bounds column JAX drops; the experts run on the first B * cap
    columns, and the gather reads a zero column appended there.  On a
    data axis the previous data rank's last column is added into column
    0, its first row's slot 0 (see the module docstring)."""
    bsz, s, d = x.shape
    xf = x.reshape(bsz * s, d)
    gates, idx, aux = _router(p, xf, cfg)
    e, k = cfg.num_experts, cfg.experts_per_token
    _, keep, col, cap_row = routing(idx, bsz, s, cfg)
    gates = gates.reshape(bsz, s, k) * keep
    idx_bsk = idx.reshape(bsz, s, k)
    n = bsz * cap_row
    # send: token rows into (E, B*cap, d); colliding rows add
    x_e = torch.zeros((e, n + 1, d), dtype=x.dtype, device=x.device)
    x_e = x_e.index_put((idx_bsk, col), x[:, :, None].expand(bsz, s, k, d),
                        accumulate=True)
    if tp.data_splits_batch():
        carried = tp.from_previous_data_rank(x_e[:, n])      # (E, d)
        x_e = torch.cat([x_e[:, :1] + carried[:, None], x_e[:, 1:n]], dim=1)
    else:
        x_e = x_e[:, :n]
    e_l = _local_experts(p, cfg)
    if e_l == e:
        y_e = _expert_ffn(p, x_e, cfg)
    else:
        # each expert's rows to its rank: (D, E_l, n, d) from the D ranks
        dd = e // e_l
        x_l = tp.exchange_data(x_e).reshape(dd, e_l, n, d)
        x_l = x_l.transpose(0, 1).reshape(e_l, dd * n, d)
        y_l = _expert_ffn(p, x_l, cfg).reshape(e_l, dd, n, d)
        y_e = tp.exchange_data(y_l.transpose(0, 1).reshape(e, n, d))
    # receive: each choice's row, zeros past the buffer, gate-combined
    y_e = F.pad(y_e, (0, 0, 0, 1))
    y_tk = y_e[idx_bsk, col]                                # (B, S, k, d)
    y = torch.einsum("bskd,bsk->bsd", y_tk, gates.to(y_tk.dtype))
    return _finish(p, x, y, cfg), aux


def moe_dense(p, x: torch.Tensor, cfg: ModelConfig):
    """Every expert on every token, gate-weighted (exact, smoke scale)."""
    bsz, s, d = x.shape
    xf = x.reshape(bsz * s, d)
    gates, idx, aux = _router(p, xf, cfg)
    w = torch.zeros((xf.shape[0], cfg.num_experts), dtype=x.dtype,
                    device=x.device)
    w = w.scatter_add(1, idx, gates.to(x.dtype))
    e_l = _local_experts(p, cfg)
    if e_l != cfg.num_experts:
        # every data rank's tokens through this rank's experts
        lo = tp.data_index() * e_l
        xf, w = tp.gather_data(xf), tp.gather_data(w)[:, lo: lo + e_l]
    act = _ACT[cfg.activation]
    h = torch.einsum("td,edf->tef", xf, p["wi"])
    if cfg.mlp_gated:
        h = act(torch.einsum("td,edf->tef", xf, p["wi_gate"])) * h
    else:
        h = act(h)
    y_all = torch.einsum("tef,efd->ted", h, p["wo"])          # (T, E, d)
    y = torch.einsum("ted,te->td", y_all, w)
    if e_l != cfg.num_experts:
        y = tp.scatter_data(y)       # this rank's tokens, every expert's sum
    return _finish(p, x, y.reshape(bsz, s, d), cfg), aux


def _finish(p, x, y, cfg: ModelConfig) -> torch.Tensor:
    """The routed experts' ``y`` plus the shared expert's, summed over the
    model ranks where the experts' mlp is sliced."""
    if cfg.moe_shared_expert:
        y = y + _shared(p, x, cfg)
    return tp.psum(y) if _model_sliced(p, cfg) else y


def _shared(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    act = _ACT[cfg.activation]
    h = act(torch.matmul(x, p["shared_wi_gate"])) * torch.matmul(
        x, p["shared_wi"])
    return torch.matmul(h, p["shared_wo"])


def moe(p, x: torch.Tensor, cfg: ModelConfig):
    """The config's implementation: ``(y, aux)``."""
    if cfg.moe_impl == "dense":
        return moe_dense(p, x, cfg)
    return moe_dispatch(p, x, cfg)
