"""Cell construction for the dry run, and the LM prefill step
(``repro/launch/steps.py``).

A *cell* = (architecture x input shape x mesh).  :func:`build_cell` gives
the step one rank runs and that rank's arguments as ``meta`` tensors
(shapes and dtypes, no device memory anywhere), and :func:`lower_cell`
traces it once (``analysis.cost``) in place of JAX's lower + compile +
``memory_analysis()``:

  train_4k    -> trainer.jit_train_step (make_train_step at 1x1) over
                 (state, batch), the state updated in place (JAX's
                 donated state)
  prefill_32k -> :func:`prefill`'s body: last-token logits (whisper: the
                 encoder's states)
  decode_32k  -> serve_step over (params, cache, tokens, pos), the cache
                 updated in place (JAX's donated cache)
  long_500k   -> serve_step with a 524288-token cache (ssm/hybrid only)

The mesh is ``launch.mesh.make_mesh``'s layout (no process group): the
trace plays its rank 0 inside ``tp.recording``, which records the
collectives.  Rank 0's arguments are its blocks of the params, in every
cell kind, as JAX's ``spec_tree`` in-shardings place them
(``sharding.mesh_plan`` / ``tp.partition_params``: the model axis's
slices, ZeRO-3 over data for the ``fsdp`` archs, the experts over data),
the optimizer state beside them, its cache (its KV heads, or all of
them for its positions where the rules split the cache by sequence), and
its block of the batch (the whole batch where the data axis does not
divide it, as JAX's ``_batch_sharding`` falls back to replicating it).
Every step runs inside ``tp.mesh_ctx``: the leaves are gathered where
they are used, as JAX's GSPMD gathers them for the same in-shardings.  Where a
rule needs what the port lacks (a model axis the KV heads do not divide,
or whisper's tensor-parallel decode, which JAX refuses too),
:func:`build_cell` raises :class:`Unsupported` with the reason, and the
dry run records the cell as skipped.

:func:`prefill` is the ``fn`` of JAX's ``_prefill_cell`` on one device:

    from repro_torch.configs import ARCHS
    from repro_torch.launch.steps import prefill
    from repro_torch.models import transformer
    cfg = ARCHS["qwen3-4b"].config()
    params, _ = transformer.init(torch.Generator("cuda").manual_seed(0), cfg)
    logits = prefill(params, tokens, cfg)            # (B, 1, vocab)

It runs on the card unless the caller asks for ``device="cpu"`` (the plain
versions of the kernels, as the tests run it).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.analysis import cost as cost_mod
from repro_torch.configs.common import ArchSpec
from repro_torch.configs.shapes import ShapeCell
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as shardlib
from repro_torch.distributed import tp
from repro_torch.models import attention as attn
from repro_torch.models import encdec, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.registry import get_model, require_train_and_tp
from repro_torch.train import optimizer as opt_mod
from repro_torch.train import trainer as trainer_mod

META = torch.device("meta")


# ------------------------------------------------------------- prefill ---
def _prefill_body(params, tokens, cfg: ModelConfig, input_embeds=None):
    """The prefill step on tensors where they are: the encoder's states
    for ``encdec``, else the last token's logits (tokens cast to int64
    here, inside the step)."""
    with torch.inference_mode():
        if cfg.family == "encdec":
            return encdec.encode(params, tokens, cfg)
        logits, _ = transformer.apply(params, tokens.long(), cfg,
                                      input_embeds=input_embeds,
                                      last_logits_only=True)
    return logits


def prefill(params, tokens, cfg: ModelConfig, *, input_embeds=None,
            device="cuda") -> torch.Tensor:
    """Last-token logits (B, 1, vocab) of ``tokens`` (B, S): int array or
    tensor, moved to ``device``; ``input_embeds`` (B, F, d), the VLM's
    patch embeddings, replace the first F embedding rows.  For an
    ``encdec`` config ``tokens`` are the frames (B, S, d_model) and the
    result is the encoder's states (B, S, d_model).  ``params`` must
    already live on ``device``."""
    dev = resolve_device(device)
    emb = params["embedding"]["embed"]
    if emb.device != dev:
        raise ValueError(f"prefill: params on {emb.device}, asked for {dev}")
    tokens = torch.as_tensor(tokens).to(dev)
    if input_embeds is not None:
        input_embeds = torch.as_tensor(input_embeds).to(dev)
    return _prefill_body(params, tokens, cfg, input_embeds)


# --------------------------------------------------------------- cells ---
class Unsupported(NotImplementedError):
    """A cell that needs what the port lacks; the message is the reason."""


@dataclasses.dataclass
class Cell:
    name: str
    fn: Callable                # fn(mesh, *args): mesh the recorded one
    args: tuple                 # this rank's, meta tensors
    mesh: Any = None            # launch.mesh.Mesh, a layout
    rules: Any = None           # sharding context re-entered at trace time
    plan: Any = None            # sharding.MeshPlan on more than one rank
    cfg: Any = None             # the cell's ModelConfig


def make_rules(spec: ArchSpec, mesh, shape: ShapeCell,
               cfg: Optional[ModelConfig] = None, *,
               opt: bool = False) -> dict:
    """JAX's rules for the cell (``repro/launch/steps.py::make_rules``),
    its optimized ``opt`` set included.

    Where the heads do not divide the model axis, ``act_seq`` maps to it:
    context-parallel attention (``attention._context_parallel``), and a
    decode's cache split by sequence over it.  ``opt`` adds JAX's two
    rules: ``kv_seq`` over ``model`` for a decode (the sequence-sharded
    decode beside tensor-parallel heads, ``attention.decode_attention``),
    and ``act_heads_q`` over ``model`` where the heads divide it.  The
    latter pins JAX's attention logits to a head-sharded layout, which is
    the layout the port's tensor parallelism computes anyway (each model
    rank attends over its own heads), so nothing reads it.  As in JAX,
    ``act_seq`` and ``act_heads_q`` never hold together."""
    overrides = dict(spec.rules_overrides)
    if shape.kind == "decode" and shape.global_batch < mesh.shape.get(
            "data", 1):
        # batch unshardable (e.g. long_500k B=1): shard the KV sequence over
        # every axis instead
        overrides.setdefault("kv_seq", shardlib.data_axes(mesh) + ("model",))
    if cfg is not None and cfg.num_heads % mesh.shape.get("model", 1) != 0:
        # heads don't divide the model axis (llama4 40H, minicpm 36H,
        # starcoder2 24H): context-parallel attention
        overrides.setdefault("act_seq", "model")
    if opt:
        if shape.kind == "decode":
            overrides.setdefault("kv_seq", "model")
        mext = mesh.shape.get("model", 1)
        if cfg is not None and cfg.num_heads % mext == 0 \
                and cfg.num_heads // max(cfg.num_kv_heads, 1) >= 1:
            overrides.setdefault("act_heads_q", "model")
    return shardlib.default_rules(mesh, fsdp=spec.fsdp, overrides=overrides)


def _refuse(cfg: ModelConfig, shape: ShapeCell, mesh) -> None:
    """Raise :class:`Unsupported` where a rule needs what the port lacks:
    whisper's tensor-parallel decode, which JAX refuses too."""
    if shape.kind == "decode" and mesh.shape.get("model", 1) > 1:
        try:
            require_train_and_tp(cfg, "the decode cell")
        except NotImplementedError as e:
            raise Unsupported(str(e)) from None


def _rows(b: int, mesh) -> int:
    """A data rank's rows of a global batch of ``b`` (all of them where
    the data axes do not divide it)."""
    d = 1
    for a in shardlib.data_axes(mesh):
        d *= mesh.shape[a]
    return b // d if b % d == 0 else b


def _batch(cfg: ModelConfig, shape: ShapeCell, rows: int) -> dict:
    """JAX's ``_batch_specs`` at ``rows`` rows, on meta: int32 tokens and
    labels, bf16 frames and patch embeddings."""
    s = shape.seq_len
    if cfg.family == "encdec":
        dec = max(s // cfg.decoder_train_frac, 1)
        return {
            "frames": torch.empty((rows, s, cfg.d_model),
                                  dtype=torch.bfloat16, device=META),
            "tokens": torch.empty((rows, dec), dtype=torch.int32,
                                  device=META),
            "labels": torch.empty((rows, dec), dtype=torch.int32,
                                  device=META),
        }
    batch = {"tokens": torch.empty((rows, s), dtype=torch.int32,
                                   device=META),
             "labels": torch.empty((rows, s), dtype=torch.int32,
                                   device=META)}
    if cfg.family == "vlm":
        batch["input_embeds"] = torch.empty(
            (rows, cfg.frontend_tokens, cfg.d_model), dtype=torch.bfloat16,
            device=META)
    return batch


def _plan_and_params(cfg, model, mesh, rules):
    """(plan, rank 0's params on meta): the mesh plan (None on one rank)
    and rank 0's blocks of the params by it."""
    shapes, axes = model.abstract_params(cfg)
    if mesh.size == 1:
        return None, shapes
    try:
        plan = shardlib.mesh_plan(axes, shapes, cfg=cfg, mesh=mesh,
                                  rules=rules)
    except ValueError as e:
        d, m = mesh.shape.get("data", 1), mesh.shape.get("model", 1)
        raise Unsupported(f"the {d}x{m} mesh plan: {e}") from None
    return plan, tp.partition_params(shapes, plan, rank=0)


def build_cell(arch_name: str, spec: ArchSpec, shape: ShapeCell, mesh,
               *, smoke: bool = False, opt: bool = False) -> Cell:
    """The cell of ``arch_name`` at ``shape`` on ``mesh`` (a layout:
    ``make_mesh((d, m), ("data", "model"))`` outside a process group):
    rank 0's step and its meta arguments, under :func:`make_rules`
    (``opt``: JAX's optimized set).  Raises :class:`Unsupported` where
    the port lacks what a rule needs."""
    cfg = spec.smoke_config() if smoke else spec.config()
    model = get_model(cfg)
    rules = make_rules(spec, mesh, shape, cfg, opt=opt)
    _refuse(cfg, shape, mesh)
    plan, params = _plan_and_params(cfg, model, mesh, rules)
    if shape.kind == "train":
        cell = _train_cell(arch_name, spec, cfg, model, shape, mesh, params,
                           plan)
    elif shape.kind == "prefill":
        cell = _prefill_cell(arch_name, cfg, shape, mesh, params, plan)
    else:
        cell = _decode_cell(arch_name, cfg, model, shape, mesh, params,
                            plan, rules)
    cell.mesh, cell.rules, cell.plan, cell.cfg = mesh, rules, plan, cfg
    return cell


def state_bytes(cell: Cell) -> dict:
    """Rank 0's param bytes (and, in a train cell, its moments') as the
    cell holds them (``rank0``) and by JAX's spec arithmetic (``spec``:
    each leaf's dims divided by the extents of the mesh axes its
    ``spec_tree`` entry names, under the cell's rules)."""
    shapes, axes = get_model(cell.cfg).abstract_params(cell.cfg)
    with shardlib.use_sharding(cell.mesh, cell.rules):
        specs = {k: shardlib.logical_spec(a, tuple(leaf.shape))
                 for (k, _, a), (_, _, leaf) in zip(
                     tp._flatten_with_keys(axes, is_leaf=lambda x:
                                           isinstance(x, tuple)),
                     tp._flatten_with_keys(shapes))}
    args = cell.args[0]
    train = isinstance(args, dict) and "opt" in args
    trees = ([args["params"], args["opt"]["m"], args["opt"]["v"]] if train
             else [args])
    flats = [{k: t for k, _, t in tp._flatten_with_keys(tree)}
             for tree in trees]
    rank0 = sum(t.numel() * t.element_size() for f in flats
                for t in f.values())
    spec = 0
    for k, _, leaf in tp._flatten_with_keys(shapes):
        n = leaf.numel()
        for entry in specs[k]:
            for a in (entry,) if isinstance(entry, str) else entry or ():
                n //= cell.mesh.shape[a]
        # the param's dtype, and its moments' (the optimizer's)
        spec += n * (leaf.element_size() + sum(f[k].element_size()
                                               for f in flats[1:]))
    return {"rank0": rank0, "spec": spec}


def _train_cell(arch_name, spec: ArchSpec, cfg, model, shape, mesh, params,
                plan) -> Cell:
    opt_cfg = opt_mod.OptimizerConfig(state_dtype=spec.optimizer_state_dtype,
                                      schedule=spec.schedule)
    tcfg = trainer_mod.TrainerConfig(grad_accum=spec.accum_for(shape.name),
                                     accum_dtype=spec.grad_accum_dtype)
    state = {"params": params,
             "opt": opt_mod.init_opt_state(params, opt_cfg)}
    batch = _batch(cfg, shape, _rows(shape.global_batch, mesh))
    cell = Cell(name=f"{arch_name}:{shape.name}", fn=None,
                args=(state, batch))

    def fn(bound, state, batch):
        # a 1x1 mesh's step is make_train_step's
        step = trainer_mod.jit_train_step(model.loss, cfg, opt_cfg, tcfg,
                                          mesh=bound, plan=plan,
                                          local_batch=True)
        with shardlib.use_sharding(bound, cell.rules):
            return step(state, batch)
    cell.fn = fn
    return cell


def _mesh_ctx(bound, plan, shape: ShapeCell):
    """``tp.mesh_ctx`` of a cell: the data ranks split the batch where
    they divide it (:func:`_rows`), else each holds all of it."""
    return tp.mesh_ctx(bound, plan, batch=_rows(shape.global_batch, bound)
                       < shape.global_batch)


def _prefill_cell(arch_name, cfg, shape, mesh, params, plan) -> Cell:
    b, s = _rows(shape.global_batch, mesh), shape.seq_len
    if cfg.family == "encdec":
        args = (params, torch.empty((b, s, cfg.d_model), dtype=torch.bfloat16,
                                    device=META))
    elif cfg.family == "vlm":
        args = (params, torch.empty((b, s), dtype=torch.int32, device=META),
                torch.empty((b, cfg.frontend_tokens, cfg.d_model),
                            dtype=torch.bfloat16, device=META))
    else:
        args = (params, torch.empty((b, s), dtype=torch.int32, device=META))
    cell = Cell(name=f"{arch_name}:{shape.name}", fn=None, args=args)

    def fn(bound, params, tokens, input_embeds=None):
        with shardlib.use_sharding(bound, cell.rules), \
                _mesh_ctx(bound, plan, shape):
            return _prefill_body(params, tokens, cfg, input_embeds)
    cell.fn = fn
    return cell


def _decode_cell(arch_name, cfg, model, shape, mesh, params, plan,
                 rules) -> Cell:
    b, s = _rows(shape.global_batch, mesh), shape.seq_len
    m = mesh.shape.get("model", 1)
    cell = Cell(name=f"{arch_name}:{shape.name}", fn=None, args=())
    # the cache of this rank's KV (and SSM) heads and, where the rules
    # split it by sequence, its positions
    with shardlib.use_sharding(mesh, rules), \
            tp.axis_ctx("model", m, group=tp.RecordedGroup(("model",), m)):
        n = attn.decode_seq_extent()
        if s % n:
            raise Unsupported(f"a cache of {s} positions over {n} ranks")
        cache = model.init_cache(cfg, b, s // n, device=META)
    cell.args = (params, cache,
                 torch.empty((b, 1), dtype=torch.int32, device=META),
                 torch.empty((b,), dtype=torch.int32, device=META))

    def fn(bound, params, cache, tokens, pos):
        with shardlib.use_sharding(bound, cell.rules), \
                _mesh_ctx(bound, plan, shape), torch.inference_mode():
            return model.serve(params, cache, tokens, pos, cfg)
    cell.fn = fn
    return cell


@dataclasses.dataclass
class Traced:
    """:func:`lower_cell`'s record: one rank's memory (JAX's
    ``memory_analysis()`` fields, per rank) and the traced cost."""
    argument_bytes: int         # the storages of the arguments it reads
    output_bytes: int           # the outputs' storages
    alias_bytes: int            # outputs that are arguments (state, cache)
    temp_bytes: int             # the traced peak less all the arguments
    peak_bytes: int             # the traced peak of live bytes
    argument_bytes_by_arg: list
    cost: cost_mod.WeightedCost
    trace_s: float

    def memory(self) -> dict:
        return {"argument_bytes": self.argument_bytes,
                "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes,
                "alias_bytes": self.alias_bytes,
                "peak_bytes": self.peak_bytes,
                "unused_argument_bytes": self.cost.unused_argument_bytes,
                "argument_bytes_by_arg": self.argument_bytes_by_arg}


def lower_cell(cell: Cell) -> Traced:
    """The port's stand-in for JAX's lower + compile +
    ``memory_analysis()``: one trace of ``cell.fn`` on its meta arguments
    (``analysis.cost.count``) inside ``tp.recording(cell.mesh)``."""
    args_keys = {cost_mod.storage_key(t)
                 for t in cost_mod.tensors(cell.args)}
    t0 = time.perf_counter()
    with tp.recording(cell.mesh) as (bound, _):
        cost = cost_mod.count(lambda *a: cell.fn(bound, *a), *cell.args)
    trace_s = time.perf_counter() - t0
    out = cost.output
    output_bytes = cost_mod.storage_bytes(out)
    fresh = cost_mod.storage_bytes(out, exclude=args_keys)
    return Traced(
        argument_bytes=cost.argument_bytes, output_bytes=output_bytes,
        alias_bytes=output_bytes - fresh,
        temp_bytes=(cost.peak_bytes - cost.argument_bytes
                    - cost.unused_argument_bytes),
        peak_bytes=cost.peak_bytes,
        argument_bytes_by_arg=[cost_mod.storage_bytes(a) for a in cell.args],
        cost=cost, trace_s=trace_s)
