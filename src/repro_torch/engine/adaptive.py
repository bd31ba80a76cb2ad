"""Adaptive-sampling engine: the Read-Until loop behind the engine API
(``repro/engine/adaptive.py``).

Wires :class:`repro_torch.realtime.runtime.AdaptiveSamplingRuntime`
(channel-lane scheduling, streaming basecalls, prefix mapping, policy)
from serving-level inputs — a reference genome and target intervals.
``submit`` accepts a raw signal array or a ``SimulatedRead``.  The
``edge_int8`` preset stores the CNN int8 once at build
(:func:`repro_torch.engine.base.quantize_edge_params`) and runs every tick
on the int8 kernels; the summary carries the ``soc_energy_*`` block.
"""
from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.engine.base import energy_block, quantize_edge_params
from repro_torch.engine.registry import register


def legacy_adaptive_policy(use_kernel: bool = False, interpret=None, *,
                           device="cuda") -> dict[str, str]:
    """The placements the old per-stage booleans of
    ``AdaptiveSamplingServer`` stand for, as ``{op: target}`` for the
    basecall CNN (``conv1d``) and the prefix mapper (``banded_align``).

    In JAX (``repro/engine/adaptive.py:17``) ``use_kernel`` placed only the
    CNN and ``interpret`` only the mapper.  The port has no placement
    policy: the tensor's device picks every kernel's target
    (:func:`repro_torch.kernels.fabric.target_of`), so both ops land on
    ``device``'s target whatever the booleans say (JAX's kernels and
    reference paths compute the same function).  Kept for the shim's
    signature; it validates ``device``."""
    import torch

    from repro_torch.kernels import fabric
    del use_kernel, interpret
    target = fabric.target_of(torch.empty(0, device=resolve_device(device)))
    return {"conv1d": target, "banded_align": target}


def resolve_lane_mesh(mesh, channels: int | None = None, *, device="cuda"):
    """Engine-facing mesh spelling (JAX's): None (one device), ``"auto"``
    (the largest count of ``device``'s type that divides ``channels``:
    visible cards, or the one CPU; None where that is 1), an int device
    count (raises beyond the devices there are), or a prebuilt
    :class:`~repro_torch.distributed.sharding.LaneMesh`."""
    if mesh is None:
        return None
    import torch

    from repro_torch.distributed.sharding import LaneMesh, lane_mesh
    kind = resolve_device(device).type
    if isinstance(mesh, LaneMesh):
        return mesh
    if mesh == "auto":
        n = torch.cuda.device_count() if kind == "cuda" else 1
        if channels is not None:
            while n > 1 and channels % n:
                n -= 1
        return lane_mesh(n, kind) if n > 1 else None
    if isinstance(mesh, int) and not isinstance(mesh, bool):
        return lane_mesh(mesh, kind) if mesh > 1 else None
    raise TypeError(f"mesh={mesh!r}: expected None, 'auto', a device count "
                    "or a sharding.LaneMesh")


class AdaptiveSamplingEngine:
    """Read-Until serving shape: keep/eject decisions with latency and
    signal-saved accounting.  ``flowcell=`` attaches a
    :class:`repro_torch.data.flowcell.FlowcellSimulator` as the read source
    (``True``, a dict of ``FlowcellConfig`` fields, or a config).
    ``mesh=`` shards the per-lane state over a lane mesh (``"auto"``, a
    device count, or a ``LaneMesh``; :func:`resolve_lane_mesh`)."""

    workload = "adaptive_sampling"

    def __init__(self, params, bc_cfg, reference, target_intervals, *,
                 channels: int = 32, chunk: int = 256, policy=None,
                 align_cfg=None, device="cuda", mesh=None,
                 pipeline_depth: int = 1, flowcell=None, trace=False,
                 fused=None):
        from repro_torch.realtime.mapper import (PREFIX_ALIGN_CFG,
                                                 PrefixMapper, TargetPanel)
        from repro_torch.realtime.policy import PolicyConfig
        from repro_torch.realtime.runtime import AdaptiveSamplingRuntime

        self.device = resolve_device(device)
        self.panel = TargetPanel.build(reference, target_intervals)
        mapper = PrefixMapper(self.panel, align_cfg or PREFIX_ALIGN_CFG,
                              device=self.device)
        self.flowcell = None
        if flowcell is not None and flowcell is not False:
            from repro_torch.data.flowcell import (FlowcellConfig,
                                                   FlowcellSimulator)
            if flowcell is True:
                fc_cfg = FlowcellConfig(channels=channels)
            elif isinstance(flowcell, FlowcellConfig):
                if flowcell.channels != channels:
                    raise ValueError(
                        f"flowcell channels={flowcell.channels} conflicts "
                        f"with engine channels={channels}")
                fc_cfg = flowcell
            else:
                kw = dict(flowcell)
                fc_channels = kw.pop("channels", channels)
                if fc_channels != channels:
                    raise ValueError(
                        f"flowcell channels={fc_channels} conflicts with "
                        f"engine channels={channels}; set one of them")
                fc_cfg = FlowcellConfig(channels=channels, **kw)
            self.flowcell = FlowcellSimulator(
                self.panel.reference, fc_cfg,
                target_mask=self.panel.target_mask)
        self.runtime = AdaptiveSamplingRuntime(
            params, bc_cfg, mapper, policy or PolicyConfig(),
            channels=channels, chunk_samples=chunk, device=self.device,
            mesh=resolve_lane_mesh(mesh, channels, device=self.device),
            pipeline_depth=pipeline_depth, source=self.flowcell,
            tracer=trace, fused=fused)

    @property
    def telemetry(self):
        return self.runtime.telemetry

    @property
    def scheduler(self):
        return self.runtime.scheduler

    @property
    def records(self):
        return self.runtime.records

    def submit(self, signal, *, read_id: int = 0,
               on_target: bool | None = None, position: int = -1) -> None:
        from repro_torch.realtime.session import SimulatedRead
        if isinstance(signal, SimulatedRead):
            self.runtime.submit(signal)
            return
        self.runtime.submit(SimulatedRead(
            signal=np.asarray(signal, np.float32), read_id=read_id,
            on_target=on_target, position=position))

    def submit_all(self, reads) -> None:
        for r in reads:
            self.submit(r)

    def step(self) -> bool:
        return self.runtime.tick()

    def suspend_tick(self) -> None:
        """Fleet hook: hand the card (or lane mesh) to the next tenant with
        none of our double-buffered tick still in flight."""
        self.runtime.yield_mesh()

    def flush(self) -> None:
        self.runtime.flush()

    def detach_source(self) -> None:
        """Live flowcell detach (fleet ``remove_tenant``): stop capturing
        new molecules; occupied lanes stream to their decisions."""
        self.runtime.detach_source()
        self.flowcell = None

    def drain(self, max_steps: int = 100_000) -> dict:
        out = self.runtime.run(max_steps)
        out.update(self._energy())
        return out

    def summary(self) -> dict:
        out = self.runtime.report()
        out.update(self._energy())
        return out

    def _energy(self) -> dict:
        return energy_block(self.runtime.params, self.runtime.cfg,
                            self.telemetry.samples)


@register("adaptive_sampling", presets={
    "default": {"channels": 32, "chunk": 256},
    "smoke": {"channels": 4, "chunk": 128},
    "edge_int8": {"channels": 32, "chunk": 256, "quantize": "int8",
                  "fused": True},
    # a full 512-channel flowcell on the deterministic step encoder + its
    # exact hand-built decoder CNN
    "flowcell_512": {"channels": 512, "chunk": 256,
                     "flowcell": {"encoder": "step", "n_reads": 1024},
                     "pipeline_depth": 2, "mesh": "auto", "fused": True},
    "flowcell_smoke": {"channels": 64, "chunk": 128,
                       "flowcell": {"encoder": "step", "n_reads": 128,
                                    "read_len": (96, 192)},
                       "pipeline_depth": 2},
})
def build_adaptive_sampling(params=None, cfg=None, reference=None,
                            targets=None, *, channels: int, chunk: int,
                            quantize=None, policy=None, align_cfg=None,
                            device="cuda", mesh=None, pipeline_depth: int = 1,
                            flowcell=None, seed: int = 0, trace=False,
                            fused=None):
    """Builder: supply (params, cfg) + reference/targets, or get a fresh CNN
    drawn from ``seed`` over a random reference with the first quarter as
    target.  A step-encoded flowcell with no explicit params gets the exact
    :func:`repro_torch.data.flowcell.step_basecaller`.  ``quantize="int8"``
    (the ``edge_int8`` preset) stores the CNN weights int8 once; every tick
    then basecalls on the int8 kernels.  ``fused=True`` runs each tick as
    the single fused kernel, ``None`` does so on the card; decisions are
    identical either way.  ``trace`` enables span tracing (True, or a
    shared Tracer)."""
    import torch

    from repro_torch.core import basecaller as bc

    dev = resolve_device(device)
    fc_encoder = None
    if isinstance(flowcell, dict):
        fc_encoder = flowcell.get("encoder")
    elif flowcell is not None and flowcell is not False and flowcell is not True:
        fc_encoder = getattr(flowcell, "encoder", None)
    if params is None and cfg is None and fc_encoder == "step":
        from repro_torch.data.flowcell import step_basecaller
        cfg, params = step_basecaller(dev)
    if cfg is None:
        cfg = bc.BasecallerConfig()
    if params is None:
        params = bc.init(torch.Generator().manual_seed(seed), cfg,
                         device=dev)
    if quantize is not None:
        params = quantize_edge_params(params, cfg, scheme=quantize,
                                      chunk=max(chunk, 512), seed=seed)
    if reference is None:
        from repro_torch.data import genome as G
        reference = G.random_genome(np.random.default_rng(seed), 20_000)
    if targets is None:
        targets = [(0, len(reference) // 4)]
    return AdaptiveSamplingEngine(
        params, cfg, reference, targets, channels=channels, chunk=chunk,
        policy=policy, align_cfg=align_cfg, device=dev, mesh=mesh,
        pipeline_depth=pipeline_depth, flowcell=flowcell, trace=trace,
        fused=fused)
