"""Continuous-batching serve engine in PyTorch (the port of
``repro.serve.engine``).

* ``make_prefill_step`` / ``make_serve_step`` — the prefill forward (with
  ``with_state=True`` it also returns the decode state after each row's
  real tokens: the bulk-prefill unit) and the one-token decode.
* ``ContinuousBatchingEngine`` — fixed decode slots over a persistent
  batched decode state.  Requests are admitted into freed rows mid-decode
  by one bulk prefill forward; finished rows retire without stalling the
  batch.  Where the JAX engine donates its carry to a jitted step, this
  one preallocates the carry tensors and updates them in place.
  Sampling and the finished mask run on the device, so each step makes
  one small host copy: (3, slots) int32 per decode step, (2, slots) per
  admission.
* ``ServeEngine`` — the batch API, a thin wrapper over the engine.

Over a (data, model) ``mesh`` (the reference's ``mesh=``) every rank runs
the same scheduler over all the slots: it decides from the submission
order alone, so identical ``submit`` calls keep the ranks in lockstep.
Rank r owns its block of slots along the data axes, as
``dist.sharding.serve_carry_shardings`` places the carry: its decode
state, control vectors, temperatures and generators hold those rows
only, and its prefill and decode steps run on them alone (a rank with
no admitted row still runs its step).  On a model axis the params are
this rank's blocks (``init_params(..., mesh=)``), gathered where the
model uses them.  The step's host copy becomes one all-gather over each
mesh axis of every rank's packed block, then one copy to the host, so
every scheduler sees every slot's token and ``serve_stats`` counts every
slot.  The packed block carries a column with the step's fingerprint
(its kind, number and rows); the gathers span the whole mesh, the
model axis and an unsplit data axis too, so a rank whose fingerprint
differs from any other's raises.  The MoE capacities stay the whole
engine's, so the expert products keep the one-process engine's shapes.

With tracing on (``repro_torch.obs.trace``), each admission records a
``serve.admit_group`` instant, a ``serve.prefill`` span and a
``serve.ttft`` instant per request, and each decode step a
``serve.decode`` span, with the JAX engine's names and fields; off, each
costs one attribute check.  Inside those spans the port records two
regions of its own (``obs.device_spans``): ``engine.sample`` around each
``_sample`` call (``sampled``: the rows drawn at a temperature) and
``engine.admit`` around an admission's scatter into the carry (``rows``,
``tokens``: the real prompt tokens admitted, ``positions``: slots x
``prefill_pad`` prefilled).  On the card each step is anchored at its
start and resolved once its ``serve.*`` span has closed at the host
copy, so these regions and ``moe_ffn``'s carry their device time on the
host clock.

Bitwise scheduler-equivalence: every per-slot computation is
row-independent at fixed shapes (per-row positions, the causal mask over
right-padded prompts, one ``torch.Generator`` per temperature row), so a
request's tokens do not depend on its slot or its batch companions.
The generators cannot reproduce JAX's PRNG keys: temperature samples
differ from the JAX engine's, greedy tokens do not.
"""

from __future__ import annotations

import contextlib
import itertools
import time
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from .._device import resolve_device
from ..dist.hints import mesh_context
from ..dist.shard import all_gather_into
from ..models.config import ModelConfig
from ..models.model import (
    backbone,
    decode_state_batch_dims,
    decode_step,
    init_decode_state,
    last_logits,
    model_forward,
    prefill_forward,
)
from ..obs import device_spans as _ds
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .scheduler import Request, Scheduler

_NO_EOS = -1  # sentinel: sampled ids are always >= 0, so -1 never matches

# distinguishes each engine's metrics in the process-wide registry
_ENGINE_IDS = itertools.count()

_COUNTER_NAMES = (
    "prefill_steps",
    "decode_steps",
    "slot_steps_total",
    "slot_steps_active",
    "tokens_generated",
    "prefill_tokens",
    "prefill_positions",
)


def make_prefill_step(cfg: ModelConfig, last_only: bool = True,
                      with_state: bool = False, state_dtype=torch.bfloat16,
                      moe_cap: int | None = None):
    """Full-sequence forward.

    ``last_only`` runs the LM head on the final position only.
    ``with_state`` returns ``(logits, decode_state)`` for a right-padded
    request group (``batch`` carries ``tokens`` (B, S) and ``lengths``
    (B,)): row i's logits are at its last real token and its state is
    what token-by-token decode would hold after ``lengths[i]`` tokens
    (``moe_cap``: the MoE capacity, by default the group's drop-free
    one)."""
    if with_state:

        def prefill_state_step(params, batch):
            return prefill_forward(
                cfg, params, batch["tokens"], batch["lengths"],
                state_dtype=state_dtype, moe_cap=moe_cap,
            )

        return prefill_state_step

    def prefill_step(params, batch):
        kw = dict(tokens=batch.get("tokens"),
                  inputs_embeds=batch.get("inputs_embeds"),
                  positions=batch.get("positions"))
        if not last_only:
            return model_forward(cfg, params, **kw)[0]
        return last_logits(cfg, params, backbone(cfg, params, **kw)[0][:, -1])

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One-token decode: (params, state, tokens (B,1), pos) -> (logits, state)."""

    def serve_step(params, state, tokens, pos):
        return decode_step(cfg, params, state, tokens, pos)

    return serve_step


def prefill_pad_for(cfg: ModelConfig, n: int) -> int:
    """Smallest legal prefill width >= n: the chunked SSM/WKV scans need
    the padded length divisible by their chunk (once it exceeds one)."""
    n = max(1, n)
    if cfg.family == "hybrid":
        c = cfg.ssm_chunk
        return -(-n // c) * c
    if cfg.family == "ssm":
        c = cfg.ssm_chunk or 64
        return n if n <= c else -(-n // c) * c
    return n


def _sample(logits: torch.Tensor, rows, temps: list[float],
            gens: list[torch.Generator | None]) -> torch.Tensor:
    """Greedy argmax for every row; Gumbel-max sampling at its temperature
    for each row in ``rows`` with ``temps[row] > 0``, drawing only from
    that row's own generator (slot-independent chains)."""
    tok = logits.argmax(dim=-1).to(torch.int32)
    for r in rows:
        t = temps[r]
        if t > 0.0:
            u = torch.rand(logits.shape[-1], generator=gens[r], device=logits.device)
            gumbel = -torch.log(-torch.log(u))
            tok[r] = (logits[r] / t + gumbel).argmax().to(torch.int32)
    return tok


class ContinuousBatchingEngine:
    """Request-level continuous batching over a fixed slot batch.

    ``submit`` enqueues (bounded queue — raises ``QueueFull``); ``step``
    runs one engine step: an admission bulk-prefill if slots are free and
    requests are queued, then one batched decode step for every live row.
    ``run`` drains to idle.  ``params`` must lie on ``device``; with
    ``mesh`` they are this rank's blocks (see the module docstring).
    """

    def __init__(self, cfg: ModelConfig, params: dict, slots: int = 4,
                 max_seq: int = 512, prefill_pad: int = 64,
                 max_queue: int = 256, min_admit: int = 1,
                 state_dtype=torch.bfloat16, device="cuda", mesh=None,
                 clock=time.perf_counter):
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(
                f"params are on {params['embed'].device}, engine on {self.device}"
            )
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.prefill_pad = prefill_pad_for(cfg, prefill_pad)
        self.state_dtype = state_dtype
        self.clock = clock
        self.sched = Scheduler(slots, max_queue=max_queue, min_admit=min_admit)
        self._rid = itertools.count()
        self._bdims = decode_state_batch_dims(cfg)
        # counters/latency histograms live in the obs.metrics registry
        # under a per-engine scope; serve_stats() is a view over them,
        # and metrics.reset() clears them via the registered hook
        scope = f"serve.e{next(_ENGINE_IDS)}."
        self._ttft = _metrics.histogram(scope + "ttft_s")
        self._tpot = _metrics.histogram(scope + "tpot_s")
        self._counters = {
            name: _metrics.counter(scope + name) for name in _COUNTER_NAMES
        }
        _metrics.on_reset(self.reset_stats)

        # this rank's slots [lo, lo + n) (all of them off a mesh)
        self.mesh = mesh
        self._lo, self._n = 0, slots
        self._on_mesh = contextlib.nullcontext
        if mesh is not None:
            self._place_on(mesh, params)
        n, dev = self._n, self.device
        self._carry = {
            "state": init_decode_state(cfg, n, max_seq, dtype=state_dtype, device=dev),
            "tokens": torch.zeros((n, 1), dtype=torch.int32, device=dev),
            "pos": torch.zeros((n,), dtype=torch.int64, device=dev),
            "active": torch.zeros((n,), dtype=torch.bool, device=dev),
            "gen": torch.zeros((n,), dtype=torch.int32, device=dev),
            "budget": torch.ones((n,), dtype=torch.int32, device=dev),
            "eos": torch.full((n,), _NO_EOS, dtype=torch.int32, device=dev),
        }
        # sampling control stays on the host: per-slot temperature and the
        # slot's generator (seeded from the request at admission), of this
        # rank's slots
        self._temps = [0.0] * n
        self._gens: list[torch.Generator | None] = [None] * n
        # MoE: the drop-free expert capacities of the admission prefill (b *
        # s * top_k at the (slots, prefill_pad) shape) and of a decode step.
        # Fixed per engine, and the whole engine's on a mesh, so the expert
        # products run at one shape and a row's bits do not depend on its
        # companions or on how the slots were split
        moe = cfg.family == "moe"
        self._prefill = make_prefill_step(
            cfg, with_state=True, state_dtype=state_dtype,
            moe_cap=slots * self.prefill_pad * cfg.moe_top_k if moe else None)
        self._moe_cap = slots * cfg.moe_top_k if moe else None

    def _place_on(self, mesh, params: dict) -> None:
        """This rank's slots on ``mesh`` and the groups of the step's
        gathers; the params must be its blocks."""
        from ..dist.shard import block_of
        from ..dist.sharding import param_shardings, serve_carry_shardings
        from ..models.model import param_shapes
        from ..train.optimizer import leaves

        for t, shape, sh in zip(leaves(params), leaves(param_shapes(self.cfg)),
                                leaves(param_shardings(self.cfg, mesh))):
            want = tuple(hi - lo for lo, hi in block_of(shape, sh, mesh))
            if tuple(t.shape) != want:
                raise ValueError(f"a param of shape {tuple(t.shape)} is not this rank's "
                                 f"block {want} of {tuple(shape)} on the mesh")
        spec = serve_carry_shardings(self.cfg, mesh, self.slots, self.max_seq)["tokens"].spec
        ((lo, hi),) = block_of((self.slots,), spec, mesh)
        self._lo, self._n = lo, hi - lo
        names = spec[0] if spec else ()
        names = list(names if isinstance(names, tuple) else (names,))
        axes = list(mesh.mesh_dim_names)
        # every axis's group, minor first: the gathered blocks come out in
        # the mesh's row-major order, shape (*mesh.shape, k, n + 1)
        self._groups = [mesh.get_group(name) for name in reversed(axes)]
        self._mesh_shape = tuple(int(n) for n in mesh.shape)
        # the one copy of the slots: index 0 on the axes that do not split
        # them, then their axes in the spec's (mixed radix) order
        self._take = tuple(slice(None) if a in names else 0 for a in axes)
        split = [a for a in axes if a in names]
        self._order = [split.index(a) for a in names]
        self._on_mesh = lambda: mesh_context(mesh)
        self._tag = torch.zeros((3, 1), dtype=torch.int32, device=self.device)
        self._stepno = 0

    def _local(self, slots) -> list[int]:
        """This rank's rows of the global ``slots``."""
        lo, n = self._lo, self._n
        return [s - lo for s in slots if lo <= s < lo + n]

    def _pull(self, packed: torch.Tensor, rows) -> np.ndarray:
        """The step's packed (k, local slots) int32 block as the (k, slots)
        host array.  Off a mesh one copy to the host; on a mesh, with the
        step's fingerprint (its number, kind and ``rows``: the admitted
        slots with their prompt lengths, budgets and eos ids, or the
        decoded slots) in an extra column, one all-gather over each mesh
        axis first, and a check that every rank of the mesh took the same
        step."""
        if self.mesh is None:
            return packed.cpu().numpy()  # the step's single host copy
        self._stepno += 1
        k = packed.shape[0]
        fp = zlib.crc32(repr((self._stepno, k, list(rows))).encode()) & 0x7FFFFFFF
        x = torch.cat([packed, self._tag[:k].fill_(fp)], dim=1)
        for group in self._groups:
            out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
            all_gather_into(out, x.contiguous(), group=group)
            x = out
        host = x.cpu().numpy().reshape(*self._mesh_shape, k, self._n + 1)
        if not (host[..., -1] == fp).all():
            raise RuntimeError(f"serve ranks out of lockstep at step {self._stepno}: "
                               f"fingerprints {host[..., 0, -1].ravel().tolist()}, "
                               f"this rank's {fp}")
        blocks = host[self._take].transpose(*self._order, -2, -1).reshape(-1, k, self._n + 1)
        return blocks[:, :, :-1].transpose(1, 0, 2).reshape(k, -1)

    # -- device steps ------------------------------------------------------

    def _admit_step(self, slots_in: list[int], ptoks, plens, budget, eos):
        """Bulk prefill of every row (this rank's), then scatter the
        admitted rows into the carry in place.  Returns the (2, slots)
        int32 host copy [first token, done]."""
        if _trace.enabled:
            _ds.anchor(self.device)
        c = self._carry
        dev = self.device
        mine = slice(self._lo, self._lo + self._n)
        local = self._local(slots_in)
        lengths = torch.from_numpy(plens[mine]).to(dev)
        with self._on_mesh():
            logits, pstate = self._prefill(
                self.params, {"tokens": torch.from_numpy(ptoks[mine]).to(dev),
                              "lengths": lengths})
        first = (self._sample_traced(logits, local) if _trace.enabled
                 else _sample(logits, local, self._temps, self._gens))
        budget_t = torch.from_numpy(budget[mine]).to(dev)
        eos_t = torch.from_numpy(eos[mine]).to(dev)
        done0 = (first == eos_t) | (budget_t <= 1)
        packed = torch.stack([first, done0.to(torch.int32)])
        rows = [(s, int(plens[s]), int(budget[s]), int(eos[s])) for s in slots_in]
        if local:
            with (_ds.region("engine.admit", rows=len(rows), tokens=sum(r[1] for r in rows),
                             positions=self.slots * self.prefill_pad)
                  if _trace.enabled else _trace._NOOP):
                idx = torch.tensor(local, dtype=torch.int64, device=dev)
                for name, new in pstate.items():
                    live = c["state"][name]
                    bd = self._bdims[name]
                    # KV caches: the prefill's seq length is below max_seq, so
                    # the rows land at the front of the admitted slots' caches
                    region = live[tuple(slice(0, n) for n in new.shape)]
                    region.index_copy_(bd, idx, new.index_select(bd, idx).to(live.dtype))
                c["tokens"][idx, 0] = first[idx]
                c["pos"][idx] = lengths[idx].long()
                c["active"][idx] = ~done0[idx]
                c["gen"][idx] = 1
                c["budget"][idx] = budget_t[idx]
                c["eos"][idx] = eos_t[idx]
        return self._pull(packed, rows)

    def _decode_step(self, rows: list[int]):
        """One batched decode step over every slot (this rank's).  Returns
        the (3, slots) int32 host copy [token, was active, done]."""
        if _trace.enabled:
            _ds.anchor(self.device)
        c = self._carry
        with self._on_mesh():
            logits, _ = decode_step(self.cfg, self.params, c["state"], c["tokens"],
                                    c["pos"], moe_cap=self._moe_cap)
        local = self._local(rows)
        tok = (self._sample_traced(logits, local) if _trace.enabled
               else _sample(logits, local, self._temps, self._gens))
        was = c["active"]
        gen = c["gen"] + was
        pos = c["pos"] + was
        done = was & ((tok == c["eos"]) | (gen >= c["budget"]) | (pos >= self.max_seq))
        packed = torch.stack([tok, was.to(torch.int32), done.to(torch.int32)])
        c["tokens"][:, 0] = tok
        c["pos"].copy_(pos)
        c["gen"].copy_(gen)
        c["active"].copy_(was & ~done)
        return self._pull(packed, rows)

    def _sample_traced(self, logits: torch.Tensor, rows: list[int]) -> torch.Tensor:
        """``_sample`` over this rank's ``rows`` in an ``engine.sample``
        region (tracing on)."""
        with _ds.region("engine.sample", sampled=sum(self._temps[r] > 0.0 for r in rows)):
            return _sample(logits, rows, self._temps, self._gens)

    # -- host control loop -------------------------------------------------

    def submit(self, prompt, max_new: int = 16, temperature: float = 0.0,
               seed: int = 0, eos_id: int | None = None,
               arrival_t: float | None = None) -> Request:
        """Enqueue a request.  Raises ``QueueFull`` when the admission
        queue is at capacity (backpressure) and ``ValueError`` for
        requests that cannot fit the engine geometry."""
        prompt = list(prompt)
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.prefill_pad:
            raise ValueError(
                f"prompt length {len(prompt)} exceeds prefill_pad "
                f"{self.prefill_pad}"
            )
        if len(prompt) + max_new > self.max_seq:
            raise ValueError(
                f"prompt {len(prompt)} + max_new {max_new} exceeds "
                f"max_seq {self.max_seq}"
            )
        req = Request(
            rid=next(self._rid), prompt=prompt, max_new=max_new,
            temperature=temperature, seed=seed, eos_id=eos_id,
            arrival_t=self.clock() if arrival_t is None else arrival_t,
        )
        self.sched.submit(req)  # may raise QueueFull
        return req

    def _do_admit(self, plan, finished):
        B, P = self.slots, self.prefill_pad
        ptoks = np.zeros((B, P), np.int32)
        plens = np.ones((B,), np.int32)
        budget = np.ones((B,), np.int32)
        eos = np.full((B,), _NO_EOS, np.int32)
        for s, req in plan:
            ptoks[s, : len(req.prompt)] = req.prompt
            plens[s] = len(req.prompt)
            budget[s] = req.max_new
            eos[s] = _NO_EOS if req.eos_id is None else req.eos_id
            for r in self._local([s]):  # the slot's owner samples it
                self._temps[r] = float(req.temperature)
                gen = None
                if req.temperature > 0.0:
                    gen = torch.Generator(device=self.device)
                    gen.manual_seed(req.seed)
                self._gens[r] = gen
        t0 = self.clock()
        with _trace.span("serve.prefill", rows=len(plan), pad=P):
            packed = self._admit_step([s for s, _ in plan], ptoks, plens, budget, eos)
        first, done0 = packed[0], packed[1].astype(bool)
        t1 = self.clock()
        if _trace.enabled:
            _ds.resolve()  # after the span, which ends at the host copy
        self._counters["prefill_steps"].inc()
        self._counters["prefill_tokens"].inc(sum(len(req.prompt) for _, req in plan))
        self._counters["prefill_positions"].inc(B * P)
        for s, req in plan:
            self.sched.admit(s, req)
            req.admit_t = t0
            req.first_token_t = t1
            req.tokens.append(int(first[s]))
            self._counters["tokens_generated"].inc()
            self._ttft.observe(t1 - req.arrival_t)
            if _trace.enabled:
                _trace.instant("serve.ttft", rid=req.rid, slot=s,
                               ttft_ms=(t1 - req.arrival_t) * 1e3)
            if done0[s]:
                req.finish_t = t1
                finished.append(self.sched.retire(s))

    def _do_decode(self, finished):
        t0 = self.clock()
        with _trace.span("serve.decode", slots=self.slots) as sp:
            packed = self._decode_step(self.sched.active_slots())
            tok, was, done = packed[0], packed[1].astype(bool), packed[2].astype(bool)
            sp.set(active=int(was.sum()))
        t1 = self.clock()
        if _trace.enabled:
            _ds.resolve()  # after the span, which ends at the host copy
        n_active = 0
        for s in range(self.slots):
            if not was[s]:
                continue
            n_active += 1
            req = self.sched.slots[s]
            req.tokens.append(int(tok[s]))
            self._counters["tokens_generated"].inc()
            if done[s]:
                req.finish_t = t1
                finished.append(self.sched.retire(s))
        self._counters["decode_steps"].inc()
        self._counters["slot_steps_total"].inc(self.slots)
        self._counters["slot_steps_active"].inc(n_active)
        if n_active:
            self._tpot.observe((t1 - t0) / n_active)

    def step(self) -> list[Request]:
        """One engine step: admission prefill (if warranted) then one
        batched decode step.  Returns requests that finished."""
        finished: list[Request] = []
        plan = self.sched.plan_admissions()
        if plan:
            if _trace.enabled:
                _trace.instant("serve.admit_group", rows=len(plan),
                               queued=len(self.sched.queue))
            self._do_admit(plan, finished)
        if self.sched.active_slots():
            self._do_decode(finished)
        return finished

    def run(self) -> list[Request]:
        """Drain queue and slots to idle; returns all finished requests."""
        out: list[Request] = []
        while not self.sched.idle:
            out.extend(self.step())
        return out

    def reset_stats(self) -> None:
        """Zero this engine's counters and latency histograms (e.g. after
        a warm-up request); live slots are untouched.  Also runs as an
        ``obs.metrics.reset()`` hook."""
        self._ttft.reset()
        self._tpot.reset()
        for c in self._counters.values():
            c.reset()
        for k in self.sched.counters:
            self.sched.counters[k] = 0

    def serve_stats(self) -> dict:
        """Counters + latency summaries for the run so far — a view over
        this engine's scope in the ``repro_torch.obs.metrics`` registry
        (plus the scheduler's admission counters)."""
        stats = dict(self.sched.counters)
        stats.update({k: c.value for k, c in self._counters.items()})
        total = max(1, stats["slot_steps_total"])
        stats["padded_slot_waste"] = 1.0 - stats["slot_steps_active"] / total
        # the admissions' prefilled positions that held no prompt token
        stats["prefill_pad_waste"] = 1.0 - (stats["prefill_tokens"]
                                            / max(1, stats["prefill_positions"]))
        for name, h in (("ttft", self._ttft), ("tpot", self._tpot)):
            xs = h.samples()
            if xs:
                stats[f"{name}_p50_ms"] = float(np.percentile(xs, 50) * 1e3)
                stats[f"{name}_p95_ms"] = float(np.percentile(xs, 95) * 1e3)
                stats[f"{name}_mean_ms"] = float(np.mean(xs) * 1e3)
        return stats


@dataclass
class ServeEngine:
    """Batch generation API: each ``generate`` call runs its prompts
    through a ``ContinuousBatchingEngine`` sized to the batch — prefill is
    one bulk forward per batch, never token-by-token decode."""

    cfg: ModelConfig
    params: dict
    max_seq: int = 512
    device: str | torch.device = "cuda"
    _engines: dict = field(default_factory=dict, repr=False)

    def generate(self, prompts: list[list[int]], max_new: int = 16,
                 temperature: float = 0.0, seed: int = 0) -> list[list[int]]:
        b = len(prompts)
        pad = prefill_pad_for(self.cfg, max(len(p) for p in prompts))
        eng = self._engines.get((b, pad))
        if eng is None:
            eng = ContinuousBatchingEngine(
                self.cfg, self.params, slots=b, max_seq=self.max_seq,
                prefill_pad=pad, device=self.device,
            )
            self._engines[(b, pad)] = eng
        reqs = [
            eng.submit(p, max_new=max_new, temperature=temperature,
                       seed=seed + i)
            for i, p in enumerate(prompts)
        ]
        eng.run()
        return [list(p) + r.tokens for p, r in zip(prompts, reqs)]
