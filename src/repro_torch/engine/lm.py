"""LM decode engine: continuous batching over a fixed KV-slot pool
(``repro/engine/lm.py``).

The decode_32k / long_500k serving shape: a fixed pool of cache slots,
requests admitted into free slots (their prompts fed one token at a time
through the all-slot step, simple and exact), every ``step`` advancing
*all* active slots one token, finished slots freeing at once.  The slot
bookkeeping lives in :class:`~repro_torch.engine.scheduler.SlotScheduler`,
the accounting in :class:`~repro_torch.engine.telemetry.Telemetry`.

    eng = repro_torch.engine.build("lm_decode", preset="full",
                                   arch="qwen3-4b")       # on the card
    eng.submit(Request(uid=0, prompt=np.array([1, 2, 3]), max_new_tokens=8))
    report = eng.drain()

A step is ``model.serve`` (``transformer.serve_step``) on the engine's
device: on the card its MLP runs the ``matmul_bf16`` kernel (fp32
``matmul`` for a float32 model) at M = the slot count, the rest plain
PyTorch ops, as JAX runs them in jnp.  As in JAX, a prompt token is fed
through the step of every slot: the other slots read token 0 at their
current position, which a later step overwrites in a KV cache but which
advances an SSM slot's state.

Tensor parallelism (JAX's ``mesh=``: an int degree, or a mesh with a
``model`` axis): one process a rank, each building its own engine inside a
``torch.distributed`` group of that many ranks
(:func:`repro_torch.distributed.launch.run` starts them).  A rank keeps
its slice of the params (:mod:`repro_torch.distributed.tp`), builds its
own cache (its KV heads, its SSM heads) and runs ``model.serve`` inside
``tp.axis_ctx`` on its model group; the logits come back gathered on every
rank, so the decode loop, the scheduler included, is byte for byte the
replicated one on each.  A ``data`` axis replicates, as JAX's
(``repro/engine/lm.py:60-95``): with ``model == 1`` the mesh runs the
unmeshed engine; with ``model > 1`` each data replica runs the
tensor-parallel engine on its model group, over the same slots (JAX does
not split them over data).  ``ckpt_dir`` with a ``sharded`` checkpoint
(from ``python -m repro_torch.train.checkpoint_converter``) loads
pre-partitioned, each rank reading only its shard; a ``full`` one is the
migration path (load, then slice).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.engine.base import EngineBase
from repro_torch.engine.registry import register


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (L,) tokens
    max_new_tokens: int
    submitted_at: float = 0.0
    tokens_out: list = dataclasses.field(default_factory=list)
    done_at: float = 0.0


def _resolve_mesh(mesh):
    """None | "auto" | int tensor-parallel degree | Mesh -> Mesh or None:
    None where the model axis is 1 (a data axis alone replicates the
    unmeshed engine, as JAX's)."""
    from repro_torch.launch.mesh import Mesh, make_mesh
    if mesh is None or mesh == "auto":
        return None
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        return None if mesh <= 1 else make_mesh((1, mesh), ("data", "model"))
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh={mesh!r}: expected None, 'auto', an int "
                        "tensor-parallel degree or a launch.mesh.Mesh")
    return mesh if mesh.shape.get("model", 1) > 1 else None


# which dim of each cache leaf is model-sharded: k/v/conv their packed
# feature dim (last), the ssm state its packed batch*heads rows
_CACHE_TP_DIM = {"k": -1, "v": -1, "conv": -1, "ssm": 2}


class LMDecodeEngine(EngineBase):
    """Slot-based continuous batching around ``model.serve``.

    ``mesh`` (an int tensor-parallel degree, or a ``(data, model)`` mesh)
    shards the model Megatron-style over this rank's model group; the
    process group must hold the mesh's ranks.
    ``ckpt_dir`` loads params from a checkpoint of either format (a
    sharded one, under TP, pre-partitioned)."""

    workload = "lm_decode"

    def __init__(self, model, params, cfg, *, slots: int, max_len: int,
                 eos: int = -1, trace=False, mesh=None, ckpt_dir=None,
                 ckpt_step=None, device="cuda"):
        self.mesh = _resolve_mesh(mesh)
        super().__init__(slots=slots, tracer=trace)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.max_len = max_len
        self.eos = eos
        self.tp = self.mesh.shape["model"] if self.mesh is not None else 1
        self.plan = None
        self.model_group = None
        if self.tp > 1:
            self._build_tensor_parallel(params, ckpt_dir, ckpt_step)
        else:
            if params is None and ckpt_dir is not None:
                from repro_torch.train import checkpoint as ck
                params, _ = ck.load_params(ckpt_dir, step=ckpt_step,
                                           device=self.device)
            self.params = params
            self.cache = model.init_cache(cfg, slots, max_len,
                                          device=self.device)
        self.pos = np.zeros((slots,), np.int32)
        self.budget = np.zeros((slots,), np.int32)  # remaining new tokens
        self.finished: list[Request] = []

    def _build_tensor_parallel(self, params, ckpt_dir, ckpt_step):
        import torch.distributed as dist
        from repro_torch.distributed import sharding as shardlib
        from repro_torch.distributed import tp as tp_mod
        from repro_torch.launch.mesh import bind
        from repro_torch.models.registry import require_train_and_tp
        model, cfg, ext = self.model, self.cfg, self.tp
        require_train_and_tp(cfg, "tensor-parallel decode")
        size = self.mesh.size
        if not dist.is_initialized() or dist.get_world_size() != size:
            have = (dist.get_world_size() if dist.is_initialized()
                    else "no process group")
            raise RuntimeError(
                f"tensor-parallel decode on the mesh {self.mesh.shape} runs "
                f"one process a rank in a group of {size} ({have} here): "
                "start them with repro_torch.distributed.launch.run")
        self.mesh = bind(self.mesh)
        self.model_group = self.mesh.group("model")
        shapes, axes = model.abstract_params(cfg)
        plan = tp_mod.build_plan(axes, shapes, cfg=cfg, tp=ext,
                                 rules=shardlib.default_rules(self.mesh))
        self.plan = plan
        rank = self.mesh.index("model")
        if params is None and ckpt_dir is not None:
            from repro_torch.train import checkpoint as ck
            manifest, _ = ck._read_manifest(ckpt_dir, ckpt_step)
            if manifest.get("format") == "sharded":
                params = tp_mod.load_sharded_params(
                    ckpt_dir, plan, step=ckpt_step, rank=rank,
                    device=self.device)
            else:
                # migration path: the full checkpoint, then this slice
                params, _ = ck.load_params(ckpt_dir, step=ckpt_step,
                                           device=self.device)
                params = tp_mod.partition_params(params, plan, rank=rank)
        elif params is not None:
            params = tp_mod.partition_params(params, plan, rank=rank,
                                             device=self.device)
        else:
            raise ValueError("tensor-parallel engine needs params or "
                             "ckpt_dir")
        self.params = params
        slots, max_len = self.scheduler.slots, self.max_len
        full = model.init_cache(cfg, slots, max_len, device="meta")
        with self._tp_scope():
            self.cache = model.init_cache(cfg, slots, max_len,
                                          device=self.device)
        for name, d in _CACHE_TP_DIM.items():
            if name not in full:
                continue
            # the conv window's B/C columns (2 * ssm_state) stay whole
            keep = 2 * cfg.ssm_state if name == "conv" else 0
            want = (full[name].shape[d] - keep) // ext + keep
            if self.cache[name].shape[d] != want:
                raise ValueError(
                    f"cache {name}: rank holds {self.cache[name].shape[d]} "
                    f"of {full[name].shape[d]} along dim {d}, expected "
                    f"{want} at tp={ext}")

    def _tp_scope(self):
        import contextlib
        if self.tp == 1:
            return contextlib.nullcontext()
        from repro_torch.distributed import tp as tp_mod
        return tp_mod.axis_ctx("model", self.tp, group=self.model_group)

    @property
    def slots(self) -> int:
        return self.scheduler.slots

    def _slot_tid(self, s: int) -> int:
        return self.telemetry.tracer.tid(self.telemetry.trace_pid,
                                         f"slot{s:02d}")

    def _step(self, toks: np.ndarray) -> np.ndarray:
        """One ``model.serve`` over every slot; the last position's logits
        (slots, vocab) as float32 on the host."""
        dev = self.device
        with torch.inference_mode(), self._tp_scope():
            logits, self.cache = self.model.serve(
                self.params, self.cache,
                torch.from_numpy(toks).to(device=dev, dtype=torch.int64),
                torch.from_numpy(self.pos).to(device=dev, dtype=torch.int64),
                self.cfg)
            return logits[:, -1].float().cpu().numpy()

    def submit(self, req: Request, **_) -> None:
        req.submitted_at = time.perf_counter()
        self.scheduler.submit(req)

    def _admit(self) -> None:
        tracer, pid = self.telemetry.tracer, self.telemetry.trace_pid
        for s, req in self.scheduler.admit():
            if tracer.enabled:
                # the request's span on its slot's track, closed when it
                # finishes (see step)
                tracer.begin("request", pid=pid, tid=self._slot_tid(s),
                             cat="request",
                             args={"uid": req.uid,
                                   "prompt_len": len(req.prompt),
                                   "max_new_tokens": req.max_new_tokens})
            # prefill: feed the prompt one token at a time
            logits = None
            with self.telemetry.stage("prefill"):
                for tok in req.prompt:
                    tkn = np.zeros((self.slots, 1), np.int32)
                    tkn[s, 0] = int(tok)
                    logits = self._step(tkn)
                    self.telemetry.dispatches += 1
                    self.pos[s] += 1
            self.budget[s] = req.max_new_tokens
            if logits is not None:
                req.tokens_out.append(int(logits[s].argmax()))
            # empty prompt: the first decode step() seeds from token 0

    def step(self) -> bool:
        """One decode step across all active slots."""
        t0 = time.perf_counter()
        with self.telemetry.scope():
            self._admit()
            active = self.scheduler.active
            if self.scheduler.n_busy == 0:
                return False
            toks = np.zeros((self.slots, 1), np.int32)
            for s, req in enumerate(active):
                if req is not None and req.tokens_out:
                    toks[s, 0] = req.tokens_out[-1]
            with self.telemetry.stage("decode"):
                logits_np = self._step(toks)
        tracer, pid = self.telemetry.tracer, self.telemetry.trace_pid
        self.telemetry.dispatches += 1
        self.telemetry.steps += 1
        for s, req in enumerate(active):
            if req is None:
                continue
            self.pos[s] += 1
            self.budget[s] -= 1
            nxt = int(logits_np[s].argmax())
            req.tokens_out.append(nxt)
            self.telemetry.tokens += 1
            hit_eos = (self.eos >= 0 and nxt == self.eos)
            if self.budget[s] <= 0 or hit_eos \
                    or self.pos[s] >= self.max_len - 1:
                req.done_at = time.perf_counter()
                self.finished.append(req)
                self.scheduler.release(s)
                self.pos[s] = 0
                self.telemetry.completed += 1
                self.telemetry.observe_latency(
                    (req.done_at - req.submitted_at) * 1e3)
                if tracer.enabled:
                    tracer.end(pid=pid, tid=self._slot_tid(s),
                               args={"tokens": len(req.tokens_out),
                                     "eos": hit_eos})
        self.telemetry.gauge("queue_depth", self.scheduler.pending)
        self.telemetry.gauge("slots_busy", self.scheduler.n_busy)
        self.telemetry.wall_s += time.perf_counter() - t0
        return True


@register("lm_decode", presets={
    "default": {"slots": 4, "max_len": 64},
    "smoke": {"slots": 2, "max_len": 32},
    "full": {"smoke": False, "slots": 8, "max_len": 512},
})
def build_lm_decode(model=None, params=None, cfg=None, *,
                    arch: str = "qwen3-4b", smoke: bool = True,
                    slots: int, max_len: int, eos: int = -1,
                    seed: int = 0, trace=False, mesh=None, ckpt_dir=None,
                    ckpt_step=None, device="cuda"):
    """Builder: supply (model, params, cfg) or let the preset pick an arch
    (its smoke config by default) and draw fresh params on ``device`` from
    ``torch.Generator(device).manual_seed(seed)``.  ``ckpt_dir`` loads
    params from a checkpoint instead; ``mesh`` (an int degree, or a
    ``(data, model)`` mesh) serves tensor-parallel from inside each rank
    where its model axis exceeds 1."""
    _resolve_mesh(mesh)
    dev = resolve_device(device)
    if cfg is None:
        from repro_torch.configs import ARCHS
        spec = ARCHS[arch]
        cfg = spec.smoke_config() if smoke else spec.config()
    if model is None:
        from repro_torch.models.registry import get_model
        model = get_model(cfg)
    if params is None and ckpt_dir is None:
        params, _ = model.init(torch.Generator(dev).manual_seed(seed), cfg,
                               device=dev)
    return LMDecodeEngine(model, params, cfg, slots=slots, max_len=max_len,
                          eos=eos, trace=trace, mesh=mesh, ckpt_dir=ckpt_dir,
                          ckpt_step=ckpt_step, device=dev)
