"""mamba2-780m's float32 decode at tensor-parallel degree 2 against degree
1, JAX beside the port, on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/mamba_tp_parity.py

Prints, as JSON lines:

- ``part: logits``: JAX's worst |TP 2 - TP 1| logit over 6 steps, from JAX's
  own parity script run as ``tests/test_tensor_parallel.py`` runs it (two
  virtual CPU devices), beside the port's (two gloo ranks against one
  process), each step's worst and the ratio to JAX's elementwise bar
  ``1e-5 + 1e-5 |TP 1|``.
- ``part: ops``: at decode step 3, for each layer, the two row-parallel ops
  of the Mamba-2 block, the gated RMSNorm (its sum of squares all-reduced
  under TP) and ``out_proj`` (its partial products all-reduced), each run
  at TP 1 and at TP 2 on the same inputs (the port's TP 1 inputs of that
  step), in JAX (jitted, ``shard_map`` over two devices) and in the port
  (two gloo ranks): the worst |TP 2 - TP 1| of each op's output in each
  framework.  The first op where the port's two runs part by more than
  JAX's is the one to look at.
- ``part: reduction``: the gated RMSNorm's sum of squares over 20,000
  seeded rows of the smoke width (128): the share of rows whose TP 2 sum
  (two half-width sums added, as the all-reduce adds them) differs from
  the TP 1 sum, in JAX (jitted) and in the port (``mamba2._sum_squares``,
  the gated RMSNorm's order, and one full-width ``torch.sum`` for comparison).

Nothing here is timed; the ranks run one thread each.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))
sys.path.insert(0, os.path.join(HERE, "..", "tests"))

from repro_torch.distributed import tp  # noqa: E402
from repro_torch.models import mamba2  # noqa: E402

ARCH = "mamba2-780m"
STEPS = 6
STEP = 2          # decode step 3
TOL = 1e-5        # JAX's bar, tests/test_tensor_parallel.py


def _recorded(rec: list):
    """Wrap the block's gated RMSNorm and row-parallel ``out_proj`` so that
    every call's inputs and output go into ``rec``, in call order; returns
    the function that puts the originals back."""
    norm, row = mamba2._gated_rmsnorm, mamba2.row_dense

    def gnorm(y, z, scale, eps, full_di):
        out = norm(y, z, scale, eps, full_di)
        rec.append(("gated_rmsnorm", (y.clone(), z.clone()), out.clone()))
        return out

    def row_dense(x, w, *, full_in):
        out = row(x, w, full_in=full_in)
        rec.append(("out_proj", (x.clone(),), out.clone()))
        return out

    def restore():
        mamba2._gated_rmsnorm, mamba2.row_dense = norm, row

    mamba2._gated_rmsnorm, mamba2.row_dense = gnorm, row_dense
    return restore


def _decode(world: int, tree):
    import torch_tp_cases as cases
    from repro_torch.models.param import load_numpy_params
    eng = cases.engine(ARCH, world, load_numpy_params(tree, "cpu"))
    return cases.decode_logits(eng, STEPS), eng.params


def _step_records(rec, layers: int):
    """The records of decode step ``STEP``: two ops a layer."""
    per_step = 2 * layers
    return rec[STEP * per_step:(STEP + 1) * per_step]


def _replay(params, records, cfg):
    """Each recorded op again, on the given inputs (this rank's slices
    under TP): the outputs, in order."""
    out = []
    for i, (name, ins, _) in enumerate(records):
        p = {k: v[i // 2] for k, v in params["blocks"]["l0"]["mamba"].items()}
        if name == "gated_rmsnorm":
            y, z = ins
            got = mamba2._gated_rmsnorm(y, z, p["norm_scale"], cfg.norm_eps,
                                        cfg.ssm_d_inner)
        else:
            got = mamba2.row_dense(ins[0], p["out_proj"],
                                   full_in=cfg.ssm_d_inner)
        out.append(got.numpy())
    return out


def rank_main(rank: int, world: int, tree, inputs) -> dict:
    """One tensor-parallel rank: the TP 2 decode, then each op of step 3
    on this rank's slice of the TP 1 inputs."""
    import torch_tp_cases as cases
    torch.set_num_threads(1)
    logits, params = _decode(world, tree)
    cfg = cases.config(ARCH)
    half = cfg.ssm_d_inner // world
    cols = slice(rank * half, (rank + 1) * half)
    local = [(name, tuple(torch.from_numpy(t[..., cols]) for t in ins), None)
             for name, ins in inputs]
    with torch.no_grad(), tp.axis_ctx("model", world):
        ops = _replay(params, local, cfg)
    return {"logits": logits, "ops": ops}


def _jax_ops(jparams, inputs, cfg):
    """JAX's gated RMSNorm and row-parallel ``out_proj`` on the same inputs
    at TP 1 and at TP 2 (jitted; ``shard_map`` over two devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.distributed import sharding as shardlib
    from repro.distributed import tp as jtp
    from repro.launch.mesh import make_mesh
    from repro.models import mamba2 as jm
    from repro.models.layers import row_dense
    mesh = make_mesh((1, 2), ("data", "model"))
    eps, di = cfg.norm_eps, cfg.ssm_d_inner

    def norm(y, z, s):
        return jm._gated_rmsnorm(y, z, s, eps, di)

    def proj(x, w):
        return row_dense(x, w, full_in=di)

    def sharded(fn, specs):
        def body(*a):
            with jtp.axis_ctx("model", 2):
                return fn(*a)
        return jax.jit(shardlib.shard_map_compat(
            body, mesh, in_specs=specs, out_specs=P()))

    norm2 = sharded(lambda y, z, s: jtp.all_gather_last(norm(y, z, s)),
                    (P(None, None, "model"), P(None, None, "model"),
                     P("model")))
    proj2 = sharded(proj, (P(None, None, "model"), P("model", None)))
    out = []
    for i, (name, ins) in enumerate(inputs):
        p = {k: v[i // 2] for k, v in jparams["blocks"]["l0"]["mamba"].items()}
        a = [jnp.asarray(t) for t in ins]
        if name == "gated_rmsnorm":
            one = jax.jit(norm)(*a, p["norm_scale"])
            two = norm2(*a, p["norm_scale"])
        else:
            one = jax.jit(proj)(a[0], p["out_proj"])
            two = proj2(a[0], p["out_proj"])
        out.append((np.asarray(one), np.asarray(two)))
    return out


def _reduction_shares(width: int = 128, rows: int = 20_000) -> dict:
    """How often a two-rank sum of squares differs from the one-rank sum,
    in JAX and in the port (see the module docstring)."""
    import jax
    import jax.numpy as jnp
    y = (np.random.default_rng(1).standard_normal((rows, width)) * 3
         ).astype(np.float32)
    h = width // 2
    ssq = jax.jit(lambda v: jnp.sum(jnp.square(v), axis=-1))
    jax_one = np.asarray(ssq(y))
    jax_two = np.asarray(ssq(y[:, :h])) + np.asarray(ssq(y[:, h:]))
    t = torch.from_numpy(y)

    def full(v):
        return torch.sum(torch.square(v), dim=-1, keepdim=True)

    port_two = full(t[:, :h]) + full(t[:, h:])
    return {"width": width, "rows": rows,
            "jax_rows_differ": float(np.mean(jax_one != jax_two)),
            "port_full_sum_rows_differ": float(
                (full(t) != port_two).float().mean()),
            "port_gated_rmsnorm_rows_differ": float(
                (mamba2._sum_squares(t) != port_two).float().mean())}


def _worst(a, b):
    d = np.abs(a - b)
    return float(d.max()), float((d / (TOL + TOL * np.abs(a))).max())


def main() -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import dataclasses
    import jax
    import test_tensor_parallel as jtest
    from repro.configs import ARCHS as JARCHS
    from repro.models import transformer as jtr
    from repro_torch.distributed import launch

    jax_parity = jtest._run_twodev(jtest._PARITY_SCRIPT.format(src=jtest.SRC))
    jcfg = dataclasses.replace(JARCHS[ARCH].smoke_config(), dtype="float32")
    jparams, _ = jtr.init(jax.random.key(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)

    torch.set_num_threads(1)
    rec: list = []
    restore = _recorded(rec)
    one, _ = _decode(1, tree)
    restore()
    records = _step_records(rec, jcfg.num_layers)
    inputs = [(name, tuple(t.numpy() for t in ins)) for name, ins, _ in
              records]
    ranks = launch.run(rank_main, 2, args=(tree, inputs), threads=1,
                       timeout_s=300)
    steps = [_worst(a, b) for a, b in zip(one, ranks[0]["logits"])]
    print(json.dumps({
        "part": "logits", "arch": ARCH, "steps": STEPS,
        "jax_worst": jax_parity[f"{ARCH}/f32"]["worst"],
        "jax_allclose_1e-5": jax_parity[f"{ARCH}/f32"]["allclose"],
        "port_worst": max(w for w, _ in steps),
        "port_over_bar": max(r for _, r in steps),
        "port_by_step": [{"worst": w, "over_bar": r} for w, r in steps],
        "ranks_agree": all(np.array_equal(a, b) for a, b in
                           zip(ranks[0]["logits"], ranks[1]["logits"]))}))

    jops = _jax_ops(jparams, inputs, jcfg)
    rows = []
    for i, ((name, _, port_one), (jone, jtwo)) in enumerate(
            zip(records, jops)):
        port_two = ranks[0]["ops"][i]
        if name == "gated_rmsnorm":   # each rank holds its half
            port_two = np.concatenate([r["ops"][i] for r in ranks], -1)
        rows.append({"layer": i // 2, "op": name,
                     "jax_tp2_vs_tp1": _worst(jone, jtwo)[0],
                     "port_tp2_vs_tp1": _worst(port_one.numpy(),
                                               port_two)[0],
                     "port_tp1_vs_jax_tp1": _worst(jone,
                                                   port_one.numpy())[0],
                     "max_abs": float(np.abs(jone).max())})
    print(json.dumps({"part": "ops", "step": STEP + 1, "rows": rows}))
    print(json.dumps({"part": "reduction", **_reduction_shares()}))


if __name__ == "__main__":
    main()
