"""Deterministic fault injection for the elastic-restart machinery.

``PPYTHON_FAULT`` arms faults in a worker at ``init()`` time.  The whole
point is *reproducibility*: elastic-restart tests must kill the same
rank at the same message every run, on CI, with no timing races — so
every fault is either counter-triggered (``after_sends=N`` fires on the
N+1-th send, deterministic for a deterministic program) or driven by a
seeded RNG (``prob=``/``seed=``).

Grammar (``;``-separated specs, each ``action:key=val,key=val``)::

    kill:rank=2,after_sends=40      # rank 2 exits (code 75) before its
                                    # 41st send — 40 messages delivered
    delay:rank=1,op=recv,ms=5,prob=0.1,seed=7
                                    # seeded 10% chance of a 5 ms stall
    drop_once:rank=0,after_sends=3  # rank 0's 4th send vanishes

Common keys: ``rank=`` (default: every rank), ``op=send|recv|any``,
``after_sends=``/``after_recvs=`` (counter thresholds, default 0),
``epoch=`` (the generation the fault is armed in, default 0 — so a
relaunched world runs clean and the faulted run's restart converges),
``seed=``, ``prob=`` (default 1.0), ``ms=`` (delay only), ``count=``
(drop_once only, default 1).

``instrument_faults(ctx)`` is called by ``init()`` after trace
instrumentation, so a killed send never half-happens: the process exits
*before* the transport is entered.

The port's own copy of ``repro.comm.faultinject`` (NumPy only), for the checkpoint's
``Dmat`` paths; it differs from the original in its docstrings alone.
"""

from __future__ import annotations

import os
import random
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from .context import run_epoch

__all__ = ["FAULT_EXIT", "FaultPlan", "FaultSpec", "instrument_faults",
           "parse_fault"]

# deliberately distinctive: a supervisor log line showing 75 means "the
# armed fault fired", not an organic crash
FAULT_EXIT = 75

_ACTIONS = ("kill", "delay", "drop_once")
_INT_KEYS = ("rank", "after_sends", "after_recvs", "seed", "epoch", "count")
_FLOAT_KEYS = ("ms", "prob")


@dataclass
class FaultSpec:
    """One parsed fault clause."""

    action: str
    rank: int | None = None      # None: applies to every rank
    op: str = "any"              # send | recv | any
    after_sends: int = 0
    after_recvs: int = 0
    ms: float = 0.0
    prob: float = 1.0
    seed: int = 0
    epoch: int = 0
    count: int = 1               # drop_once: how many drops

    def matches_op(self, op: str) -> bool:
        return self.op in ("any", op)


def parse_fault(spec: str) -> list[FaultSpec]:
    """Parse a ``PPYTHON_FAULT`` string into fault clauses (see module
    docstring for the grammar).  Raises ``ValueError`` on junk — a typo'd
    chaos spec must fail the job loudly, not silently run fault-free."""
    out: list[FaultSpec] = []
    for clause in spec.split(";"):
        clause = clause.strip()
        if not clause:
            continue
        action, sep, rest = clause.partition(":")
        action = action.strip()
        if action not in _ACTIONS:
            raise ValueError(
                f"unknown fault action {action!r} in {clause!r} "
                f"(expected one of {', '.join(_ACTIONS)})"
            )
        kwargs: dict[str, Any] = {}
        if sep:
            for kv in rest.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                key, eq, val = kv.partition("=")
                key = key.strip()
                val = val.strip()
                if not eq or not val:
                    raise ValueError(f"fault key {kv!r} is not key=value")
                if key in _INT_KEYS:
                    kwargs[key] = int(val)
                elif key in _FLOAT_KEYS:
                    kwargs[key] = float(val)
                elif key == "op":
                    if val not in ("send", "recv", "any"):
                        raise ValueError(f"fault op must be send|recv|any, "
                                         f"got {val!r}")
                    kwargs[key] = val
                else:
                    raise ValueError(f"unknown fault key {key!r} in {clause!r}")
        out.append(FaultSpec(action=action, **kwargs))
    return out


@dataclass
class FaultPlan:
    """The armed faults for one (rank, epoch), with op counters.

    ``kill_fn`` is overridable for unit tests; the default is a hard
    ``os._exit`` — a simulated node failure must not run ``finally``
    blocks or atexit hooks (a real SIGKILL wouldn't)."""

    specs: list[FaultSpec]
    pid: int
    epoch: int = 0
    kill_fn: Callable[[], None] | None = None
    sends: int = 0
    recvs: int = 0
    _rng: dict[int, random.Random] = field(default_factory=dict)
    _dropped: dict[int, int] = field(default_factory=dict)

    def __post_init__(self) -> None:
        self.specs = [
            s for s in self.specs
            if (s.rank is None or s.rank == self.pid) and s.epoch == self.epoch
        ]
        for i, s in enumerate(self.specs):
            self._rng[i] = random.Random(s.seed)
            self._dropped[i] = 0

    @property
    def armed(self) -> bool:
        return bool(self.specs)

    def _fire_kill(self, spec: FaultSpec, op: str) -> None:
        print(
            f"[faultinject] rank {self.pid} epoch {self.epoch}: kill after "
            f"{self.sends} sends / {self.recvs} recvs (at {op})",
            file=sys.stderr, flush=True,
        )
        if self.kill_fn is not None:
            self.kill_fn()
            return
        os._exit(FAULT_EXIT)

    def _check(self, op: str, done: int) -> bool:
        """Run every armed clause against one op; returns False when a
        ``drop_once`` clause eats the operation."""
        deliver = True
        for i, s in enumerate(self.specs):
            if not s.matches_op(op):
                continue
            threshold = s.after_sends if op == "send" else s.after_recvs
            if done < threshold:
                continue
            if s.action == "kill":
                self._fire_kill(s, op)
            elif s.action == "delay":
                if s.prob >= 1.0 or self._rng[i].random() < s.prob:
                    time.sleep(s.ms / 1000.0)
            elif s.action == "drop_once" and op == "send":
                if self._dropped[i] < s.count:
                    self._dropped[i] += 1
                    deliver = False
        return deliver

    def before_send(self) -> bool:
        """Called before each send; False means the send is dropped."""
        deliver = self._check("send", self.sends)
        self.sends += 1
        return deliver

    def before_recv(self) -> None:
        self._check("recv", self.recvs)
        self.recvs += 1


def plan_from_env(pid: int, spec: str | None = None,
                  epoch: int | None = None) -> FaultPlan | None:
    """Build the armed plan for this rank, or None when no fault applies."""
    if spec is None:
        spec = os.environ.get("PPYTHON_FAULT", "")
    if not spec:
        return None
    plan = FaultPlan(
        specs=parse_fault(spec), pid=pid,
        epoch=run_epoch() if epoch is None else epoch,
    )
    return plan if plan.armed else None


def instrument_faults(ctx: Any) -> Any:
    """Wrap ``ctx``'s send/recv entry points with the armed fault plan.

    Instance-level and idempotent, mirroring the obs trace wrapper; a
    run without ``PPYTHON_FAULT`` (or whose faults target another rank
    or another epoch) pays nothing — the context is returned untouched.
    """
    if getattr(ctx, "_fault_instrumented", False):
        return ctx
    plan = plan_from_env(getattr(ctx, "pid", 0))
    if plan is None:
        return ctx

    send0 = ctx.send
    isend0 = ctx.isend
    recv0 = ctx.recv

    def send(dest, tag, obj):
        if plan.before_send():
            return send0(dest, tag, obj)
        return None  # dropped on the floor, as a lost packet would be

    def isend(dest, tag, obj):
        if plan.before_send():
            return isend0(dest, tag, obj)
        from .context import SendRequest

        return SendRequest()

    def recv(source, tag, timeout=None):
        plan.before_recv()
        return recv0(source, tag, timeout)

    ctx.send = send
    ctx.isend = isend
    ctx.recv = recv
    ctx._fault_plan = plan
    ctx._fault_instrumented = True
    return ctx
