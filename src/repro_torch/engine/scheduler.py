"""Fixed-shape slot scheduler shared by every streaming engine.

The SoC time-shares a statically provisioned fabric; the software analogue
is a fixed pool of ``slots`` (KV-cache lanes, sensor channels, in-flight
device jobs) fed from an unbounded submit queue.  One scheduler owns the
three pieces every engine used to re-implement:

  * **admission** — queued work moves into free slots, oldest first
    (``LMServer._admit``, ``AdaptiveSamplingRuntime._assign_free``),
  * **slot recycling** — a released slot is immediately reusable
    (continuous batching),
  * **bounded in-flight depth** — at most ``depth`` slots may be occupied
    at once (``StreamingBasecallPipeline``'s double-buffer queue); the
    occupancy FIFO lets a producer drain the *oldest* job to make room.

Slots hold arbitrary host objects (a request, a channel session, an
in-flight device array); device state lives outside, indexed by slot id —
the scheduler never touches device memory, so every jitted function keeps
its fixed shape.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, Optional


class SlotScheduler:
    """Admission + recycling + bounded depth over a fixed slot pool."""

    def __init__(self, slots: int, *, depth: Optional[int] = None,
                 on_event: Optional[Callable[[str, int], None]] = None):
        if slots <= 0:
            raise ValueError(f"slots must be positive, got {slots}")
        if depth is not None and not (0 < depth <= slots):
            raise ValueError(f"depth must be in 1..{slots}, got {depth}")
        self.slots = slots
        self.depth = slots if depth is None else depth
        self.active: list[Any] = [None] * slots
        self.queue: collections.deque = collections.deque()
        self._fifo: collections.deque[int] = collections.deque()  # oldest first
        self.admitted_total = 0
        self.released_total = 0
        # observability hook: called as on_event(kind, slot) after every
        # state transition — kind is "admit" (from queue), "assign" (direct
        # placement), or "release" (see Tracer.scheduler_hook)
        self.on_event = on_event

    # ------------------------------------------------------------ intake --
    def submit(self, item: Any) -> None:
        self.queue.append(item)

    def submit_all(self, items: Iterable[Any]) -> None:
        for item in items:
            self.submit(item)

    @property
    def pending(self) -> int:
        return len(self.queue)

    # --------------------------------------------------------- occupancy --
    @property
    def busy(self) -> list[int]:
        """Occupied slot ids in slot order (fixed-shape iteration order)."""
        return [s for s in range(self.slots) if self.active[s] is not None]

    @property
    def n_busy(self) -> int:
        return len(self._fifo)

    @property
    def drained(self) -> bool:
        return not self.queue and not self._fifo

    def oldest(self) -> Optional[int]:
        """Slot id of the longest-occupied slot (the one a depth-bounded
        producer drains to make room), or None when idle."""
        return self._fifo[0] if self._fifo else None

    # --------------------------------------------------------- admission --
    def admit(self, wrap: Optional[Callable[[int, Any], Any]] = None
              ) -> list[tuple[int, Any]]:
        """Move queued items into free slots (lowest slot id first) until
        slots, queue, or the depth bound run out.

        ``wrap(slot, item)`` optionally converts the queued item into the
        object stored in the slot (e.g. a read into a channel session).
        Returns ``[(slot, stored_object), ...]`` for the newly admitted.
        """
        out = []
        for s in range(self.slots):
            if not self.queue or self.n_busy >= self.depth:
                break
            if self.active[s] is None:
                out.append((s, self._place(s, self.queue.popleft(), wrap)))
        return out

    def _place(self, slot: int, item: Any,
               wrap: Optional[Callable[[int, Any], Any]],
               kind: str = "admit") -> Any:
        """Occupy a free slot: the one bookkeeping tail shared by queue
        admission and direct assignment."""
        stored = wrap(slot, item) if wrap is not None else item
        self.active[slot] = stored
        self._fifo.append(slot)
        self.admitted_total += 1
        if self.on_event is not None:
            self.on_event(kind, slot)
        return stored

    def assign(self, slot: int, item: Any,
               wrap: Optional[Callable[[int, Any], Any]] = None) -> Any:
        """Place ``item`` directly into a specific free slot, bypassing the
        queue — for callers where slot identity is physical (a flowcell
        channel whose pore just recovered).  Same invariants as ``admit``:
        the slot must be free and the depth bound holds.  Returns the
        stored object."""
        if not 0 <= slot < self.slots:
            raise ValueError(f"slot {slot} out of range 0..{self.slots - 1}")
        if self.active[slot] is not None:
            raise ValueError(f"slot {slot} is already occupied")
        if self.n_busy >= self.depth:
            raise ValueError(f"depth bound {self.depth} reached")
        return self._place(slot, item, wrap, kind="assign")

    def release(self, slot: int) -> Any:
        """Free a slot and return what it held; the slot is immediately
        eligible for re-admission."""
        item = self.active[slot]
        if item is None:
            raise ValueError(f"slot {slot} is not occupied")
        self.active[slot] = None
        self._fifo.remove(slot)
        self.released_total += 1
        if self.on_event is not None:
            self.on_event("release", slot)
        return item
