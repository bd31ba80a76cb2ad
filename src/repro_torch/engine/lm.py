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

Tensor parallelism (JAX's ``mesh=`` with a ``model`` axis, and a
``sharded`` checkpoint) waits for ROADMAP.md Queue 1 item 5b: a ``mesh``
other than None, 1 or ``"auto"`` raises ``NotImplementedError``.
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


WAITING_TP = ("tensor-parallel decode is not ported yet (ROADMAP.md, "
              "Queue 1 item 5b: the int8-weight and TP branches)")


def check_mesh(mesh) -> None:
    """One card: ``mesh`` None, 1 or ``"auto"``; anything else (a tensor-
    parallel degree above 1, a mesh object) raises."""
    if mesh is None or mesh == "auto":
        return
    if isinstance(mesh, int) and mesh <= 1:
        return
    raise NotImplementedError(f"mesh={mesh!r}: {WAITING_TP}")


class LMDecodeEngine(EngineBase):
    """Slot-based continuous batching around ``model.serve``.

    ``ckpt_dir`` loads params from a JAX ``full`` checkpoint
    (``train/checkpoint.load_params``; a ``sharded`` one raises)."""

    workload = "lm_decode"

    def __init__(self, model, params, cfg, *, slots: int, max_len: int,
                 eos: int = -1, trace=False, mesh=None, ckpt_dir=None,
                 ckpt_step=None, device="cuda"):
        check_mesh(mesh)
        super().__init__(slots=slots, tracer=trace)
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.max_len = max_len
        self.eos = eos
        if params is None and ckpt_dir is not None:
            from repro_torch.train import checkpoint as ck
            params, _ = ck.load_params(ckpt_dir, step=ckpt_step,
                                       device=self.device)
        self.params = params
        self.cache = model.init_cache(cfg, slots, max_len, device=self.device)
        self.pos = np.zeros((slots,), np.int32)
        self.budget = np.zeros((slots,), np.int32)  # remaining new tokens
        self.finished: list[Request] = []

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
        with torch.inference_mode():
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
    params from a ``full`` checkpoint instead."""
    check_mesh(mesh)
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
