"""Request-level scheduler for the continuous-batching serve engine.

The port's own copy of ``repro.serve.scheduler``.

The engine owns a fixed number of decode *slots* (rows of the batched
decode state).  The scheduler is the host-side control plane: a bounded
admission queue in front of the slots, a slot table mapping rows to live
requests, and the admit/retire bookkeeping counters that ``serve_stats()``
reports.  It is pure Python — every device-side decision (sampling,
finished masks, state scatter) lives in the engine's device steps; the
scheduler only decides *which* request occupies *which* row *when*.

Admission policy: whenever at least ``min_admit`` slots are free and the
queue is non-empty, the engine runs one bulk-prefill step admitting as
many queued requests as there are free rows (the prefill forward costs
the same at any occupancy, so batching admissions maximally is strictly
better).  Decode never stalls for prefill of a *non-empty* running batch
— admission interleaves between decode steps and only touches the rows
it fills.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


class QueueFull(RuntimeError):
    """Raised by ``submit`` when the admission queue is at capacity —
    the caller must back off (backpressure, not silent drops)."""


@dataclass
class Request:
    """One generation request and its lifecycle timestamps.

    ``tokens`` holds only the *generated* tokens (the prompt is not
    echoed); timestamps are engine-clock floats, -1.0 until reached.
    """

    rid: int
    prompt: list[int]
    max_new: int
    temperature: float = 0.0
    seed: int = 0
    eos_id: int | None = None
    arrival_t: float = 0.0
    admit_t: float = -1.0
    first_token_t: float = -1.0
    finish_t: float = -1.0
    tokens: list[int] = field(default_factory=list)

    @property
    def ttft(self) -> float:
        """Time to first token (admission wait + prefill)."""
        return self.first_token_t - self.arrival_t

    @property
    def done(self) -> bool:
        return self.finish_t >= 0.0


class Scheduler:
    """Bounded admission queue + slot table.

    ``plan_admissions`` pairs free slots with queued requests (FIFO) but
    does not commit them — the engine calls ``admit`` once the device-side
    scatter has actually happened, so the table never disagrees with the
    carry buffers.
    """

    def __init__(self, n_slots: int, max_queue: int = 256, min_admit: int = 1):
        if n_slots < 1:
            raise ValueError("need at least one decode slot")
        self.n_slots = n_slots
        self.max_queue = max_queue
        self.min_admit = max(1, min_admit)
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * n_slots
        self.counters = {
            "submitted": 0,
            "rejected": 0,
            "admitted": 0,
            "retired": 0,
            "queue_peak": 0,
        }

    # -- queue -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        if len(self.queue) >= self.max_queue:
            self.counters["rejected"] += 1
            raise QueueFull(
                f"admission queue full ({self.max_queue}); retry later"
            )
        self.queue.append(req)
        self.counters["submitted"] += 1
        self.counters["queue_peak"] = max(
            self.counters["queue_peak"], len(self.queue)
        )

    # -- slots -------------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is None]

    def active_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slots) if r is not None]

    def plan_admissions(self) -> list[tuple[int, Request]]:
        """Pair free slots with queued requests.  With work still decoding,
        admission waits for ``min_admit`` free rows (each admission costs a
        full bulk-prefill forward, so batching them amortizes it); once the
        batch is empty there is nothing to amortize against and any free
        row admits immediately."""
        free = self.free_slots()
        if not self.queue:
            return []
        decoding = len(free) < self.n_slots
        need = min(self.min_admit, len(self.queue))
        if decoding and len(free) < need:
            return []
        plan = []
        for s in free:
            if not self.queue:
                break
            plan.append((s, self.queue.popleft()))
        return plan

    def admit(self, slot: int, req: Request) -> None:
        assert self.slots[slot] is None, f"slot {slot} already occupied"
        self.slots[slot] = req
        self.counters["admitted"] += 1

    def retire(self, slot: int) -> Request:
        req = self.slots[slot]
        assert req is not None, f"retiring empty slot {slot}"
        self.slots[slot] = None
        self.counters["retired"] += 1
        return req

    @property
    def idle(self) -> bool:
        return not self.queue and all(r is None for r in self.slots)
