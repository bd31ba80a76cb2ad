"""The dry run's cells under context-parallel attention, the
sequence-sharded decode beside tensor-parallel heads and JAX's ``--opt``
rule set, at smoke size on meta tensors (no ranks, no card).

On a 2x2 layout: the ``act_seq`` config's (minicpm-2b's smoke config with
3 heads, ``torch_mesh_cases.cp_config``) train, prefill and decode cells,
and jamba's B 1 decode (``kv_seq`` over (data, model) beside its
tensor-parallel heads), trace ``ok``; rank 0's param and moment bytes
equal JAX's spec arithmetic (``steps.state_bytes``); the context-parallel
cells record the sequence all-gathers, the decode caches hold S / n
positions of every KV head.  ``make_rules(opt=True)`` sets JAX's two
rules, never ``act_seq`` beside ``act_heads_q``; ``--opt`` records carry
``opt: true``; ``launch.train``'s plan for minicpm-2b at ``--mesh 1x8``
(36 heads over 8) gathers the attention leaves whole.
"""
import dataclasses

import pytest

import torch_port_util as U  # noqa: F401  (torch lazy-module registries)
import torch_mesh_cases as cases
from repro.configs import ARCHS as JARCHS
from repro.configs.shapes import ShapeCell as JShape
from repro.launch import steps as jsteps
from repro_torch.configs import ARCHS, SHAPES, ShapeCell
from repro_torch.launch import dryrun, steps
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_mesh

MINICPM, JAMBA = "minicpm-2b", "jamba-v0.1-52b"
SEQ, BATCH = 32, 4
CP_SPEC = dataclasses.replace(ARCHS[MINICPM], smoke_config=cases.cp_config)
LAYOUT = make_mesh((2, 2), ("data", "model"))
CELLS = {"cp train": (CP_SPEC, ShapeCell("t", "train", SEQ, BATCH)),
         "cp prefill": (CP_SPEC, ShapeCell("p", "prefill", SEQ, BATCH)),
         "cp decode": (CP_SPEC, ShapeCell("d", "decode", 2 * SEQ, BATCH)),
         "jamba decode B1": (ARCHS[JAMBA],
                             ShapeCell("d", "decode", 2 * SEQ, 1))}


def _built(name):
    spec, shape = CELLS[name]
    arch = MINICPM if spec is CP_SPEC else JAMBA
    return steps.build_cell(arch, spec, shape, LAYOUT, smoke=True)


@pytest.mark.parametrize("name", list(CELLS))
def test_cells_trace_with_jax_state_bytes(name):
    cell = _built(name)
    kind = CELLS[name][1].kind
    rules = cell.rules
    if name.startswith("cp"):
        assert (rules["act_seq"], rules["act_heads_q"]) == ("model", None)
    else:
        assert rules["kv_seq"] == ("data", "model")
    traced = steps.lower_cell(cell)
    assert traced.peak_bytes > 0
    sb = steps.state_bytes(cell)
    assert sb["rank0"] == sb["spec"]
    gathers = traced.cost.collective_ops.get("all-gather", 0)
    if name.startswith("cp") and kind != "decode":
        # k, v and the output over the sequence, each attention layer
        layers = cell.cfg.num_layers
        assert gathers >= 3 * layers * (2 if kind == "train" else 1)
    if kind == "decode":
        cfg = cell.cfg
        cache = cell.args[1]
        n = 2 if name.startswith("cp") else 4
        rows = BATCH // 2 if name.startswith("cp") else 1
        assert tuple(cache["k"].shape[2:]) == (rows, 2 * SEQ // n,
                                               cfg.kv_dim)


def test_opt_rules_equal_jax():
    """``make_rules(opt=True)`` equals JAX's on the same stand-in mesh for
    every arch and shape: ``kv_seq`` over model for a decode,
    ``act_heads_q`` where the heads divide model, and ``act_seq`` never
    beside it."""
    sizes = {"data": 8, "model": 8}
    stand_in = type("M", (), {"shape": sizes})()
    for arch, spec in ARCHS.items():
        cfg, jcfg = spec.config(), JARCHS[arch].config()
        for name, shape in SHAPES.items():
            jshape = JShape(name, shape.kind, shape.seq_len,
                            shape.global_batch)
            for opt in (False, True):
                got = steps.make_rules(spec, stand_in, shape, cfg, opt=opt)
                want = jsteps.make_rules(JARCHS[arch], stand_in, jshape,
                                         jcfg, opt=opt)
                assert got == want, (arch, name, opt)
                assert not (got["act_seq"] and got["act_heads_q"])


def test_opt_records_carry_opt():
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", "1x2", smoke=True,
                          opt=True)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["opt"] is True
    assert rec["state_bytes"]["rank0"] == rec["state_bytes"]["spec"]
    plain = dryrun.run_cell("qwen3-4b", "prefill_32k", "1x2", smoke=True)
    assert plain["opt"] is False


def test_launch_train_plans_minicpm_at_model_8():
    """``launch.train --mesh 1x8 --arch minicpm-2b``: 36 heads do not
    divide 8, so the rules map ``act_seq`` to model and the plan gathers
    the attention leaves whole (it raised before), while the MLP keeps
    its Megatron slice (5,760 / 8)."""
    args = launch_train.parser().parse_args(
        ["--arch", MINICPM, "--mesh", "1x8", "--seq-len", "512"])
    cfg = launch_train._config(args)
    assert launch_train.mesh_rules(args, cfg)["act_seq"] == "model"
    plan = launch_train._plan(args, cfg)
    wq = plan.flat["blocks/l0/attn/wq"]
    assert (wq.model_dim, wq.rule, wq.gather_model) == (2, None, True)
    wi = plan.flat["blocks/l0/mlp/wi"]
    assert wi.rule is not None and not wi.gather_model
    assert wi.rule.local_width(8) == 720
