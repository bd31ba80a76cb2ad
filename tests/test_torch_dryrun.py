"""The port's dry run (``launch.steps`` cells traced on meta tensors by
``analysis.cost``) against JAX's (``repro.launch.steps`` lowered and
compiled on the CPU, ``analysis.hlo``).

At a 1x1 mesh, on the smoke configs' prefill and decode cells: the traced
dot FLOPs within 2% of ``analyze_hlo``'s (each cell's ratio printed), and
the argument and output bytes equal to ``memory_analysis()``'s.  On a
mesh: the recorded collectives of a 2x2 qwen3-4b cell by the ring model
worked by hand, the recording refusing CPU and CUDA tensors, the minicpm
cell that needs JAX's context-parallel attention traced (it was skipped
before the port had it); the ZeRO-3 gathers and reduce-scatters of a 2x1
nemotron-4-15b cell and the all-to-alls of llama4's expert-parallel
dispatch by the ring model.  Meta tensors reach only the kernels' plain
versions.  The CLI writes a report that ``analysis.report`` reads.
"""
import numpy as np
import pytest
import torch

import torch_port_util as U
import jax
import jax.numpy as jnp
from repro.analysis.hlo import analyze_hlo
from repro.configs import ARCHS as JARCHS
from repro.configs.shapes import ShapeCell as JShape
from repro.launch import steps as jsteps
from repro.launch.mesh import make_mesh as jmesh
from repro.models import mamba2 as jmamba2
from repro_torch.analysis import report
from repro_torch.configs import ARCHS
from repro_torch.configs.shapes import ShapeCell
from repro_torch.distributed import tp
from repro_torch.analysis import cost
from repro_torch.core import basecaller as tbc
from repro_torch.kernels import (conv1d, edit_distance, fabric,
                                 flash_attention, fused_stream, matmul, ops,
                                 ssd_scan)
from repro_torch.realtime import runtime
from repro_torch.utils.tree import tree_map
from repro_torch.launch import dryrun, steps
from repro_torch.launch.mesh import make_mesh

ARCH_CELLS = ("qwen3-4b", "grok-1-314b", "mamba2-780m", "whisper-medium")
BATCH, SEQ = 2, 64
KINDS = ("prefill", "decode")
FLOP_TOL = 0.02
# XLA's memory_analysis() counts a tuple result's index table, 8 bytes a
# leaf, in output_size_in_bytes; a one-array result has none
XLA_TUPLE_ENTRY = 8


def _shape(kind):
    return ShapeCell(f"{kind}_smoke", kind, SEQ, BATCH)


@pytest.fixture(scope="module")
def cells():
    """Each (arch, kind): JAX's compiled cell (FLOPs, memory analysis,
    result leaves) and the port's traced one, built once."""
    jm = jmesh((1, 1), ("data", "model"))
    pm = make_mesh((1, 1), ("data", "model"))
    out = {}
    with U.one_thread():
        for arch in ARCH_CELLS:
            for kind in KINDS:
                sh = _shape(kind)
                jcell = jsteps.build_cell(
                    arch, JARCHS[arch], JShape(sh.name, kind, SEQ, BATCH), jm,
                    smoke=True)
                comp = jsteps.lower_cell(jcell).compile()
                leaves = jax.tree.leaves(jax.eval_shape(jcell.fn, *jcell.args))
                port = steps.lower_cell(steps.build_cell(
                    arch, ARCHS[arch], sh, pm, smoke=True))
                out[arch, kind] = {
                    "flops": analyze_hlo(comp.as_text(), 1).flops,
                    "memory": comp.memory_analysis(),
                    "leaves": len(leaves), "port": port}
    return out


def _jax_ssd_chunked_flops(cfg) -> float:
    """JAX's CPU lowering of its chunked SSD (``mamba2.ssd_chunked``, what
    its prefill runs off the TPU) alone, at the smoke cell's shapes, for
    every layer."""
    bh = BATCH * cfg.ssm_heads
    sds = jax.ShapeDtypeStruct
    fn = jax.jit(lambda x, la, b, c: jmamba2.ssd_chunked(
        x, la, b, c, cfg.ssm_chunk)[0])
    dt = jnp.bfloat16
    comp = fn.lower(sds((bh, SEQ, cfg.ssm_head_dim), dt),
                    sds((bh, SEQ), jnp.float32),
                    sds((bh, SEQ, cfg.ssm_state), dt),
                    sds((bh, SEQ, cfg.ssm_state), dt)).compile()
    return analyze_hlo(comp.as_text(), 1).flops * cfg.num_layers


@pytest.mark.parametrize("arch", ARCH_CELLS)
@pytest.mark.parametrize("kind", KINDS)
def test_flops_within_2pct_of_jax(cells, arch, kind):
    c = cells[arch, kind]
    port = c["port"].cost
    ratio = port.flops / c["flops"]
    print(f"{arch} {kind}: port/JAX FLOPs = {ratio:.6f}")
    if arch == "mamba2-780m" and kind == "prefill":
        # ssd_scan: on meta its plain version is the chunked form at the
        # kernel's chunk, kernel_chunk(32, 64) = 64 (the smoke config's
        # 32 rounded up to the 64-row tile); JAX's CPU prefill runs its
        # chunked form at 32, so the L^2 terms differ.  The rest of the
        # cell is held to 2%.
        cfg = JARCHS[arch].smoke_config()
        jax_rest = c["flops"] - _jax_ssd_chunked_flops(cfg)
        rest = port.flops - port.flops_by_kernel["ssd_scan"]
        print(f"{arch} {kind} without ssd_scan: {rest / jax_rest:.6f}")
        assert port.flops_by_kernel["ssd_scan"] > 0
        assert abs(rest / jax_rest - 1) <= FLOP_TOL
        return
    assert abs(ratio - 1) <= FLOP_TOL


@pytest.mark.parametrize("arch", ARCH_CELLS)
@pytest.mark.parametrize("kind", KINDS)
def test_argument_and_output_bytes_equal_jax(cells, arch, kind):
    c = cells[arch, kind]
    port, ma = c["port"], c["memory"]
    # both count the arguments the step reads: jit prunes unused ones, the
    # trace counts those an op reads (whisper's decode leaves the encoder)
    assert port.argument_bytes == ma.argument_size_in_bytes
    table = XLA_TUPLE_ENTRY * c["leaves"] if c["leaves"] > 1 else 0
    assert port.output_bytes + table == ma.output_size_in_bytes
    assert port.alias_bytes == ma.alias_size_in_bytes
    assert port.peak_bytes >= port.argument_bytes + port.output_bytes \
        - port.alias_bytes


def test_mesh_all_reduces_follow_the_ring_model():
    """qwen3-4b smoke prefill on a 2x2 mesh: rank 0 holds B / 2 rows and
    its model-axis slice; the vocab-parallel embedding, each layer's
    attention output and MLP down projection all-reduce its (rows, S, d)
    activations over the model axis (2 ranks), and the last token's logits
    are all-gathered.  Ring model: an all-reduce puts 2 (g-1)/g of its
    result on the wire, an all-gather (g-1)/g."""
    d, m = 2, 2
    cfg = ARCHS["qwen3-4b"].smoke_config()
    cell = steps.build_cell("qwen3-4b", ARCHS["qwen3-4b"],
                            ShapeCell("p", "prefill", SEQ, 4), make_mesh(
                                (d, m), ("data", "model")), smoke=True)
    cost = steps.lower_cell(cell).cost
    rows = 4 // d
    act = rows * SEQ * cfg.d_model * 2                     # bf16
    n_ar = 1 + 2 * cfg.num_layers
    assert cost.collective_ops == {"all-reduce": n_ar, "all-gather": 1}
    assert cost.wire_bytes["all-reduce"] == n_ar * 2 * (m - 1) / m * act
    logits = rows * 1 * cfg.vocab_size * 2                 # gathered
    assert cost.wire_bytes["all-gather"] == (m - 1) / m * logits
    assert cost.total_wire_bytes == sum(cost.wire_bytes.values())


def test_zero3_gathers_and_scatters_follow_the_ring_model():
    """nemotron-4-15b smoke train on a 2x1 mesh (``fsdp``: every leaf
    split over data): each leaf is all-gathered where it is used, once a
    step (no remat), and its gradient reduce-scattered; ring model: an
    all-gather puts (g-1)/g of its result on the wire, a reduce-scatter
    (g-1) of its result (the rank's block).  Beside them two all-reduces
    over data: the loss and the clip norm's squares.  Rank 0's params
    and moments are JAX's spec arithmetic, byte for byte."""
    g = 2
    cell = steps.build_cell("nemotron-4-15b", ARCHS["nemotron-4-15b"],
                            ShapeCell("t", "train", SEQ, 4),
                            make_mesh((g, 1), ("data", "model")),
                            smoke=True)
    params = {k: t for k, _, t in tp._flatten_with_keys(
        cell.args[0]["params"])}
    assert all(cell.plan.flat[k].data_dim is not None for k in params)
    local = sum(t.numel() * t.element_size() for t in params.values())
    cost = steps.lower_cell(cell).cost
    # a block's leaves gathered a block at a time
    n = sum(cell.cfg.num_blocks if k.startswith("blocks/") else 1
            for k in params)
    assert cost.collective_ops == {"all-gather": n, "reduce-scatter": n,
                                   "all-reduce": 2}
    assert cost.wire_bytes["all-gather"] == (g - 1) / g * g * local
    assert cost.wire_bytes["reduce-scatter"] == (g - 1) * local
    sb = steps.state_bytes(cell)
    assert sb["rank0"] == sb["spec"] > local


def test_expert_parallel_dispatch_exchanges_follow_the_ring_model():
    """llama4's smoke dispatch on a 2x1 mesh: its 8 experts 4 a data
    rank, each MoE layer sends the experts' rows out and the results back
    by all-to-all over data, and the backward does both again; ring
    model: (g-1)/g of the buffer on the wire."""
    import dataclasses
    g = 2
    spec = dataclasses.replace(ARCHS["llama4-maverick-400b-a17b"],
                               smoke_config=lambda: dataclasses.replace(
                                   ARCHS["llama4-maverick-400b-a17b"]
                                   .smoke_config(), moe_impl="dispatch"))
    cell = steps.build_cell("llama4-maverick-400b-a17b", spec,
                            ShapeCell("t", "train", SEQ, 4),
                            make_mesh((g, 1), ("data", "model")),
                            smoke=True)
    cfg = cell.cfg
    wi = [p for k, p in cell.plan.flat.items() if k.endswith("moe/wi")]
    assert wi and all(p.experts and p.data_dim == 1 for p in wi)
    layers = cfg.num_blocks * sum(s.ff == "moe" for s in cfg.block_pattern)
    cost = steps.lower_cell(cell).cost
    assert cost.collective_ops["all-to-all"] == 4 * layers
    cap = max(int(SEQ * cfg.experts_per_token * cfg.moe_capacity_factor
                  / cfg.num_experts), 1)
    buf = cfg.num_experts * (4 // g) * cap * cfg.d_model * 2     # bf16
    assert cost.wire_bytes["all-to-all"] == 4 * layers * (g - 1) / g * buf


def test_recording_refuses_cpu_and_cuda_tensors():
    from torch._subclasses import FakeTensorMode
    with FakeTensorMode():
        on_card = torch.empty(4, device="cuda")     # a CUDA tensor's shape
    assert on_card.device.type == "cuda"
    mesh = make_mesh((1, 2), ("data", "model"))
    with tp.recording(mesh) as (bound, record):
        grp = bound.group("model")
        with pytest.raises(RuntimeError, match="a cpu tensor"):
            tp.psum(torch.ones(4), grp)
        with pytest.raises(RuntimeError, match="a cuda tensor"):
            tp.psum(on_card, grp)
        with tp.axis_ctx("model", 2, group=grp):
            with pytest.raises(RuntimeError, match="a cpu tensor"):
                tp.all_gather_last(torch.ones(2, 3))
            got = tp.all_gather_last(torch.empty(2, 3, device="meta"))
        assert got.shape == (2, 6) and got.device.type == "meta"
        assert record == [("all-gather", 2 * 2 * 3 * 4, 2)]
    # outside it a recorded group has nothing to record into
    with pytest.raises(RuntimeError, match="outside tp.recording"):
        tp.psum(torch.empty(3, device="meta"), grp)


def test_minicpm_at_model_8_is_skipped_for_act_seq():
    """The cell JAX runs with context-parallel attention (its 4 smoke heads
    do not divide 8) was skipped for it; the port now has it, and the
    cell traces ``ok`` under the ``act_seq`` rule, with rank 0's state
    bytes equal to JAX's spec arithmetic."""
    rec = dryrun.run_cell("minicpm-2b", "prefill_32k", "1x8", smoke=True)
    assert rec["status"] == "ok", rec.get("reason", rec.get("error"))
    assert rec["state_bytes"]["rank0"] == rec["state_bytes"]["spec"]


def _fused_tick(device, lanes=4, chunk=32):
    """The fused flowcell tick's arguments: a narrow basecaller's params,
    its lane state and one chunk of rows, made on the CPU and moved to
    ``device``."""
    cfg = tbc.BasecallerConfig(kernels=(5, 7, 1), channels=(8, 16, 5),
                               strides=(1, 2, 1))
    params = tbc.init(torch.Generator().manual_seed(0), cfg, device=U.CPU)
    lane = runtime.init_lane_state(cfg, lanes, device=U.CPU)
    rows = torch.randn(lanes, chunk, generator=torch.Generator()
                       .manual_seed(1))
    pads = torch.zeros(lanes, chunk // cfg.total_stride)
    reset = torch.ones(lanes)
    move = lambda tree: tree_map(lambda t: t.to(device), tree)  # noqa
    return (move(params), move(lane), rows.to(device), pads.to(device),
            reset.to(device)), cfg


def test_meta_tensors_reach_only_the_plain_versions():
    """A meta tensor takes each wrapper's plain version (counted
    ``fabric.dispatch.<op>.meta``), launches nothing, and gives the
    kernel's output shape."""
    meta = torch.device("meta")
    fused_args, fused_cfg = _fused_tick(U.CPU)
    with U.one_thread():
        fused_want = fused_stream.fused_stream_step(*fused_args,
                                                    cfg=fused_cfg)
    fused_meta, _ = _fused_tick(meta)
    wrappers = ((fused_stream.fused_stream_cuda, "launches"),
                (fused_stream.fused_stream_cuda, "tc_launches"),
                (matmul.matmul, "launches"), (matmul.matmul_bf16, "launches"),
                (flash_attention.flash_attention, "launches"),
                (ssd_scan.ssd_scan, "launches"), (conv1d.conv1d, "launches"),
                (edit_distance.levenshtein, "launches"),
                (edit_distance.banded_align, "launches"),
                (matmul.matmul_int8, "launches"),
                (conv1d.conv1d_int8, "launches"))
    before = [getattr(w, a) for w, a in wrappers]
    base = fabric.counters()
    assert ops.mat_mul(torch.empty(8, 16, device=meta),
                       torch.empty(16, 4, device=meta)).shape == (8, 4)
    assert ops.mat_mul(torch.empty(8, 16, device=meta, dtype=torch.bfloat16),
                       torch.empty(16, 4, device=meta, dtype=torch.bfloat16)
                       ).dtype == torch.bfloat16
    q = torch.empty(1, 4, 32, 16, device=meta, dtype=torch.bfloat16)
    kv = torch.empty(1, 2, 32, 16, device=meta, dtype=torch.bfloat16)
    assert ops.flash_attention(q, kv, kv).shape == q.shape
    x = torch.empty(6, 100, 8, device=meta)
    bc = torch.empty(6, 100, 16, device=meta)
    assert ops.ssd_scan(x, torch.empty(6, 100, device=meta), bc, bc
                        ).shape == x.shape
    assert ops.conv1d(torch.empty(2, 64, 4, device=meta),
                      torch.empty(5, 4, 8, device=meta)).shape == (2, 64, 8)
    tok = torch.zeros(3, 5, dtype=torch.int32, device=meta)
    assert ops.edit_distance(tok, tok).shape == (3,)
    assert ops.banded_align(tok, tok, band=2).shape == (3,)
    i8 = torch.empty(8, 32, dtype=torch.int8, device=meta)
    assert matmul.matmul_int8(i8, torch.empty(32, 8, dtype=torch.int8,
                                              device=meta)).dtype == torch.int32
    assert conv1d.conv1d_int8(torch.empty(2, 16, 32, dtype=torch.int8,
                                          device=meta),
                              torch.empty(3, 32, 8, dtype=torch.int8,
                                          device=meta)).shape == (2, 14, 8)
    fused_got = fused_stream.fused_stream_step(*fused_meta, cfg=fused_cfg)
    got_leaves, want_leaves = cost.tensors(fused_got), cost.tensors(fused_want)
    assert len(got_leaves) == len(want_leaves) > 3
    for g, w in zip(got_leaves, want_leaves):
        assert g.device == meta
        assert (g.shape, g.dtype) == (w.shape, w.dtype)
    assert [getattr(w, a) for w, a in wrappers] == before
    got = fabric.counters_delta(base)
    for op, n in (("matmul", 2), ("flash_attention", 1), ("ssd_scan", 1),
                  ("conv1d", 1), ("edit_distance", 1), ("banded_align", 1),
                  ("fused_stream", 1)):
        assert got[f"fabric.dispatch.{op}.meta"] == n, op
    assert not [k for k in got if k.endswith((".cuda", ".reference"))]


def test_fused_tick_is_counted_as_one_kernel():
    """``cost.count`` takes the fused tick as one unit: the FLOPs of its
    plain version (the convolutions and the head it composes, counted
    once, none under their own kernels' names), its inputs and outputs
    as its only device traffic, and none of its intermediates in the
    peak."""
    from torch.utils.flop_counter import FlopCounterMode
    args, cfg = _fused_tick(U.CPU)
    flops = FlopCounterMode(display=False)
    with U.one_thread(), flops:
        fused_stream._fused_reference(
            args[2], args[3], args[4], args[1]["prev_class"],
            args[1]["bases"], args[1]["ticks"], tuple(args[1]["conv"]),
            args[0], cfg=cfg)
    assert flops.get_total_flops() > 0
    meta, _ = _fused_tick(torch.device("meta"))
    got = cost.count(
        lambda *a: fused_stream.fused_stream_step(*a, cfg=cfg), *meta)
    assert dict(got.flops_by_kernel) == {
        "fused_stream": flops.get_total_flops()}
    assert got.flops == flops.get_total_flops()
    io = cost.nbytes(meta) + cost.nbytes(got.output)
    assert got.hbm_by_kind["kernel.fused_stream"] == io
    assert got.hbm_bytes == io
    assert got.peak_bytes <= io


def test_meta_kernel_gradient_is_the_plain_versions():
    """On meta, a kernel that carries its plain version's gradient on the
    card carries it too (shapes only)."""
    a = torch.empty(8, 16, device="meta", requires_grad=True)
    b = torch.empty(16, 4, device="meta", requires_grad=True)
    out = ops.mat_mul(a, b)
    assert out.grad_fn is not None
    ga, gb = torch.autograd.grad(out.sum(), (a, b))
    assert ga.shape == a.shape and gb.shape == b.shape


def test_cli_writes_a_report_that_report_reads(tmp_path, capsys):
    out = tmp_path / "dryrun.json"
    with U.one_thread():
        got = dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                           "--mesh", "1x1", "--smoke", "--out", str(out)])
    assert [r["status"] for r in got] == ["ok"]
    rec = got[0]
    assert rec["mesh"] == "1x1" and rec["fits_80gb"] is True
    assert set(rec["memory"]) >= {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes", "peak_bytes"}
    assert rec["roofline"]["dominant"] == "memory"
    assert "trace_s" in rec and "lower_s" not in rec
    capsys.readouterr()
    report.main(["--dryrun", str(out), "--section", "dryrun"])
    text = capsys.readouterr().out
    assert "mesh 1x1" in text and "| qwen3-4b | decode_32k | 1x1 | ok" in text
    # resuming: a done cell is not traced again
    again = dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                         "--mesh", "1x1", "--smoke", "--out", str(out)])
    assert again == got


def test_cli_exits_non_zero_on_a_failed_cell(monkeypatch, tmp_path):
    def broken(*a, **k):
        raise RuntimeError("broken cell")
    monkeypatch.setattr(steps, "lower_cell", broken)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                     "--mesh", "1x1", "--smoke"])
    assert e.value.code == 1


def test_parse_mesh():
    assert dryrun.parse_mesh("8x8") == (8, 8)
    assert dryrun.parse_mesh("1X2") == (1, 2)
    for bad in ("8", "0x2", "axb"):
        with pytest.raises(ValueError):
            dryrun.parse_mesh(bad)
    assert np.prod(dryrun.parse_mesh(dryrun.MESHES[1])) == 64
