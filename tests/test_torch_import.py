"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and it never runs on the CPU unless the caller asks for it."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import torch_port_util  # noqa: F401  (torch lazy-module registries)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SRC = os.path.join(ROOT, "src")
PKG = os.path.join(SRC, "repro_torch")

_IMPORT_SCRIPT = r"""
import json, sys
sys.path.insert(0, {src!r})
import repro_torch, repro_torch.engine
import repro_torch.engine.adaptive, repro_torch.realtime
import repro_torch.kernels.fused_stream, repro_torch.kernels.ops
import repro_torch.data.flowcell, repro_torch.core.seed_extend
import repro_torch.quant, repro_torch.quant.observers, repro_torch.quant.params
import repro_torch.engine.base, repro_torch.engine.basecall
import repro_torch.core.soc_model, repro_torch.core.pipeline
import repro_torch.core.pathogen, repro_torch.core.variant_caller
import repro_torch.engine.pipeline, repro_torch.kernels.edit_distance
import repro_torch.kernels.flash_attention, repro_torch.kernels.ssd_scan
import repro_torch.models.transformer, repro_torch.models.param
import repro_torch.configs, repro_torch.launch.steps
import repro_torch.obs, repro_torch.obs.validate, repro_torch.fleet
import repro_torch.field, repro_torch.distributed.compression
import repro_torch.train.checkpoint, repro_torch.train.micro_basecaller
import repro_torch.train.optimizer, repro_torch.utils.tree
import repro_torch.quant.fake_quant, repro_torch.launch.serve
import repro_torch.engine.lm, repro_torch.models.registry
import repro_torch.serving, repro_torch.serving.engine
import repro_torch.configs.basecaller_soc
import repro_torch.train.trainer, repro_torch.train.fault_tolerance
import repro_torch.data.tokens, repro_torch.launch.train
import repro_torch.distributed.tp, repro_torch.distributed.sharding
import repro_torch.distributed.launch, repro_torch.launch.mesh
import repro_torch.train.checkpoint_converter
import repro_torch.analysis, repro_torch.analysis.cost
import repro_torch.analysis.roofline, repro_torch.analysis.report
import repro_torch.launch.dryrun, repro_torch.utils.shapes
mods = sorted(m for m in sys.modules
              if m == "jax" or m.startswith("jax.")
              or m == "repro" or m.startswith("repro."))
print("RESULT " + json.dumps(mods))
"""


def test_import_pulls_in_no_jax_and_no_repro():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_SCRIPT.format(src=SRC)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
    assert json.loads(line[0][len("RESULT "):]) == []


def test_scan_covers_the_lm_modules():
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("models/transformer.py", "models/attention.py",
                "models/mamba2.py", "models/layers.py", "models/param.py",
                "models/config.py", "configs/__init__.py",
                "configs/qwen3_4b.py", "configs/mamba2_780m.py",
                "launch/steps.py", "kernels/flash_attention.py",
                "kernels/ssd_scan.py"):
        assert mod in found, mod


def test_scan_covers_the_obs_fleet_and_field_modules():
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("obs/__init__.py", "obs/metrics.py", "obs/trace.py",
                "obs/export.py", "obs/validate.py", "fleet/__init__.py",
                "fleet/scheduler.py", "fleet/batching.py", "fleet/fleet.py",
                "field/__init__.py", "field/uplink.py", "field/device.py",
                "field/aggregator.py", "field/scenario.py",
                "distributed/__init__.py", "distributed/compression.py"):
        assert mod in found, mod


def test_scan_covers_the_train_utils_and_serve_modules():
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("train/__init__.py", "train/optimizer.py",
                "train/checkpoint.py", "train/micro_basecaller.py",
                "utils/__init__.py", "utils/tree.py", "quant/fake_quant.py",
                "launch/serve.py", "core/ctc.py"):
        assert mod in found, mod


def test_scan_covers_the_decode_modules():
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("engine/lm.py", "models/registry.py", "serving/__init__.py",
                "serving/legacy.py", "serving/engine.py",
                "configs/nemotron_4_15b.py", "configs/starcoder2_3b.py",
                "configs/minicpm_2b.py", "configs/basecaller_soc.py"):
        assert mod in found, mod


def test_scan_covers_the_lm_train_modules():
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("train/trainer.py", "train/fault_tolerance.py",
                "data/tokens.py", "launch/train.py", "configs/common.py"):
        assert mod in found, mod


def test_scan_covers_the_tensor_parallel_modules():
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("distributed/tp.py", "distributed/sharding.py",
                "distributed/launch.py", "launch/mesh.py",
                "train/checkpoint_converter.py"):
        assert mod in found, mod


def test_scan_covers_the_mesh_modules():
    """The modules of training over a mesh, the sequence-sharded decode
    and the lane meshes are scanned, and the rank side of their tests
    imports no JAX either."""
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("launch/mesh.py", "launch/train.py", "train/trainer.py",
                "train/optimizer.py", "train/checkpoint.py",
                "train/fault_tolerance.py", "models/attention.py",
                "engine/lm.py", "engine/adaptive.py", "realtime/runtime.py",
                "fleet/fleet.py", "field/device.py", "field/scenario.py",
                "distributed/sharding.py", "distributed/tp.py"):
        assert mod in found, mod
    with open(os.path.join(HERE, "torch_mesh_cases.py")) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert "repro_torch.launch.mesh" in names
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_scan_covers_the_zero3_and_expert_parallel_modules():
    """The modules that place and gather a mesh's state (the mesh plan,
    the data collectives, the models that gather at use, the MoE's
    expert parallelism, the optimizer, trainer, checkpoints and launch)
    are scanned, and the rank side of their tests imports no JAX."""
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("distributed/sharding.py", "distributed/tp.py",
                "models/transformer.py", "models/moe.py",
                "models/encdec.py", "models/mamba2.py",
                "models/attention.py", "models/layers.py",
                "train/optimizer.py", "train/trainer.py",
                "train/checkpoint.py", "train/fault_tolerance.py",
                "train/checkpoint_converter.py", "launch/steps.py",
                "launch/train.py", "launch/dryrun.py", "analysis/cost.py",
                "configs/common.py"):
        assert mod in found, mod
    with open(os.path.join(HERE, "torch_mesh_cases.py")) as fh:
        tree = ast.parse(fh.read())
    defs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"mesh_plan_for", "local_params", "mesh_checkpoint"} <= defs


def test_scan_covers_the_dry_run_modules():
    """The dry run's modules (the analysis package, the cell builders and
    the CLI) and the shape helpers are scanned."""
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("analysis/__init__.py", "analysis/cost.py",
                "analysis/roofline.py", "analysis/report.py",
                "launch/dryrun.py", "launch/steps.py", "utils/shapes.py",
                "utils/__init__.py", "core/pipeline.py", "core/fm_index.py"):
        assert mod in found, mod


def test_spawned_ranks_hold_no_jax_and_no_repro():
    """Each rank ``distributed.launch.run`` starts (spawn: a fresh
    interpreter) imports the port's tensor-parallel modules and holds no
    ``jax`` and no ``repro`` module; the ranks' module under tests/ imports
    neither either."""
    import torch_tp_cases
    from repro_torch.distributed import launch
    assert launch.run(torch_tp_cases.loaded_modules, 2) == [[], []]
    with open(torch_tp_cases.__file__) as fh:
        tree = ast.parse(fh.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names] + [n.module for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "repro")]


def test_checkpoints_need_no_ml_dtypes():
    """bf16 and fp8 leaves go through torch's own dtypes: the card's
    machine has no JAX, and nothing promises it ml_dtypes."""
    proc = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path.insert(0, {SRC!r}); "
         "import repro_torch.train.checkpoint; "
         "print('ml_dtypes' in sys.modules)"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "False"


def test_train_and_checkpoint_without_card_raise(monkeypatch, tmp_path):
    from repro_torch.train import checkpoint, micro_basecaller
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        micro_basecaller.train_micro_basecaller(steps=1)
    checkpoint.save(str(tmp_path), {"w": torch.ones(2)}, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.load_params(str(tmp_path))


def test_fleet_and_field_without_card_raise(monkeypatch):
    from repro_torch.field import EdgeDevice, FieldSpec, run_field_scenario
    from repro_torch.fleet import Fleet
    from repro_torch.obs import profile_window
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Fleet()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_field_scenario(FieldSpec(n_devices=1, n_infected=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EdgeDevice(0, [1, 2, 3, 4] * 100, [(0, 100)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with profile_window("unused"):
            pass


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_repro():
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{os.path.relpath(path, ROOT)}: {n}")
    assert not bad, bad


def test_build_without_card_raises(monkeypatch):
    import repro_torch.engine as te
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        te.build("adaptive_sampling", preset="smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.build("adaptive_sampling", preset="flowcell_smoke")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.build("basecall", preset="edge_int8")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.build("pathogen_pipeline", preset="edge_int8")
    from repro_torch.configs import ARCHS
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    cfg = ARCHS["qwen3-4b"].smoke_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init(torch.Generator().manual_seed(0), cfg)
    params, _ = transformer.init(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        steps.prefill(params, [[1, 2, 3]], cfg)


def test_resolve_device():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_one_card_mesh_and_unported_presets():
    import repro_torch.engine as te
    from repro_torch.engine.adaptive import resolve_lane_mesh
    # one device (the CPU here): no lane mesh; two devices are refused
    assert resolve_lane_mesh(None, device="cpu") is None
    assert resolve_lane_mesh("auto", 512, device="cpu") is None
    assert resolve_lane_mesh(1, device="cpu") is None
    with pytest.raises(ValueError, match="not in 1..1"):
        resolve_lane_mesh(2, device="cpu")
    # every preset of the JAX engines is ported; edge_int8 stores int8
    eng = te.build("adaptive_sampling", preset="edge_int8", device="cpu",
                   channels=4, chunk=64)
    assert eng.runtime.params["conv1"]["w"].q.dtype == torch.int8
    assert set(te.presets("adaptive_sampling")) == {
        "default", "smoke", "edge_int8", "flowcell_512", "flowcell_smoke"}
    assert set(te.workloads()) == {"adaptive_sampling", "basecall",
                                   "pathogen_pipeline", "field_aggregator",
                                   "lm_decode"}
    assert te.presets("lm_decode") == {
        "default": {"slots": 4, "max_len": 64},
        "smoke": {"slots": 2, "max_len": 32},
        "full": {"smoke": False, "slots": 8, "max_len": 512}}


def test_chip_smoke_alone_fails_without_output(tmp_path):
    """chip_smoke.py alone in a directory (or on a machine with no card)
    exits non-zero and prints no result."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout == ""


WGMMA = "_Z24matmul_bf16_wgmma_kernelILi3EEv14CUtensorMap_stS0_PK13__nv_bf"
MMA = "_Z18matmul_bf16_kernelPK13__nv_bfloat16S1_S1_PS_iiiiii"
PTXAS_LOG = f"""\
ptxas info    : Compiling entry function '{WGMMA}' for 'sm_90a'
ptxas info    : Function properties for {WGMMA}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 64 bytes smem
ptxas info    : Compiling entry function '{MMA}' for 'sm_90a'
ptxas info    : Function properties for {MMA}
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 126 registers, used 1 barriers, 18944 bytes smem
ptxas warning : (C7508) setmaxnreg ignored
"""


def test_ptxas_summary_reads_registers_and_spills():
    from repro_torch.kernels import _build
    got = _build.ptxas_summary(PTXAS_LOG)
    assert got["matmul_bf16_wgmma_kernel<3>"] == {
        "spill_stores": 0, "spill_loads": 0, "registers": 168}
    assert got["matmul_bf16_kernel"] == {
        "spill_stores": 4, "spill_loads": 12, "registers": 126}
    assert got["warnings"] == [PTXAS_LOG.splitlines()[-1].strip()]


def test_scan_covers_the_family_modules():
    """The MoE layer, the encoder-decoder and the five family configs."""
    found = {os.path.relpath(p, PKG) for p in _port_sources()}
    for mod in ("models/moe.py", "models/encdec.py",
                "configs/grok1_314b.py", "configs/llama4_maverick_400b.py",
                "configs/jamba_v01_52b.py", "configs/internvl2_76b.py",
                "configs/whisper_medium.py"):
        assert mod in found, mod
