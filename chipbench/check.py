"""Whether what the timed path produced is correct.

Once the window has closed, a sample of the requests the engine finished
is drawn from the seed: the greedy request with the most served tokens,
``check.greedy - 1`` other greedy ones and ``check.sampled`` sampled
ones.  The family's plain reference (``reference/<family>.py``, fp32,
TF32 off) runs once over each prompt with its served tokens, in blocks
of ``BLOCK`` requests, on the same weights.  Each served token is
judged by its gap: how far the reference's logit of that token lies
below the reference's best.  A greedy token's gap is ``max(l) - l[tok]``.
A sampled token was the argmax of ``l / T + g`` (Gumbel-max at the
request's temperature T): the noise ``g`` is drawn again here as the
engine draws it, one ``torch.rand(vocab)`` a token from a device
generator seeded with the request's seed, and the gap is ``T (max(z) -
z[tok])`` with ``z = l_ref / T + g``.  The readings are the widest gap
of each kind (``greedy_gap``, ``sampled_gap``), the mean gap of each
kind (``greedy_mean_gap``, ``sampled_mean_gap``) and over every checked
token (``mean_gap``), the requests due inside the window that never got
a first token, and the finished requests whose length is not what they
asked for (no request has an end-of-sequence token); a cell compares
those its ``check.limits`` names.

The control (``quant="fp8"``) puts the reference in the program's place
at float8 e4m3: at each position of the same prompts and tokens it
takes the token the fp8 reference puts first and reads its gap under
the fp32 reference.  Its readings go through the same limits as the
program's (``control_checks``); ``control_correct`` has to come out
false.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .serve import Served, Timeline

BLOCK = 4  # requests a reference forward takes at once


def pick(tl: Timeline, cell: dict, seed: int) -> list[Served]:
    """The checked requests, drawn from the seed among the finished ones."""
    want = cell["check"]
    done = [s for s in tl.requests if s.finished]
    greedy = [s for s in done if s.req.temperature == 0.0]
    hot = [s for s in done if s.req.temperature > 0.0]
    rng = np.random.default_rng([int(seed) % 2**63, 2**33])
    out = []
    if greedy:
        longest = max(greedy, key=lambda s: (len(s.handle.tokens), -s.req.index))
        rest = [s for s in greedy if s is not longest]
        k = min(len(rest), int(want["greedy"]) - 1)
        out += [longest] + [rest[i] for i in sorted(rng.choice(len(rest), k, replace=False))]
    k = min(len(hot), int(want["sampled"]))
    out += [hot[i] for i in sorted(rng.choice(len(hot), k, replace=False))]
    return out


def _noise(req, width: int, n: int, device) -> torch.Tensor:
    """The (n, width) Gumbel noise the engine drew for a sampled request."""
    gen = torch.Generator(device=device)
    gen.manual_seed(req.seed)
    u = torch.stack([torch.rand(width, generator=gen, device=device) for _ in range(n)])
    return -torch.log(-torch.log(u))


def gaps(ref, c: dict, params: dict, picked: list[Served], device, block: int,
         quant: str | None = None, every: list | None = None) -> dict:
    """The widest and the mean gap over the picked requests' served
    tokens, greedy and sampled apart (``greedy_gap``, ``sampled_gap``,
    ``greedy_mean_gap``, ``sampled_mean_gap``; None where no request of
    the kind was picked), and the mean gap over all of them
    (``mean_gap``); with ``quant`` the gaps of the tokens the control puts
    first instead.  ``every`` collects each token's (kind, gap)."""
    worst = {"greedy_gap": None, "sampled_gap": None}
    total = {"greedy_gap": 0.0, "sampled_gap": 0.0}
    count = {"greedy_gap": 0, "sampled_gap": 0}
    for at in range(0, len(picked), block):
        part = picked[at: at + block]
        seqs = [s.req.prompt + s.handle.tokens[:-1] for s in part]
        width = max(len(q) for q in seqs)
        tokens = torch.zeros((len(part), width), dtype=torch.long, device=device)
        for i, q in enumerate(seqs):
            tokens[i, : len(q)] = torch.tensor(q, device=device)
        with torch.no_grad():
            ref_logits = ref.forward(c, params, tokens)
            ctrl_logits = None if quant is None else ref.forward(c, params, tokens, quant)
        for i, s in enumerate(part):
            start, n = len(s.req.prompt) - 1, len(s.handle.tokens)
            lg = ref_logits[i, start: start + n]
            temp = s.req.temperature
            noise = _noise(s.req, lg.shape[-1], n, device) if temp > 0 else 0.0
            z = lg / temp + noise if temp > 0 else lg
            if ctrl_logits is None:
                tok = torch.tensor(s.handle.tokens, device=device)
            else:
                cz = ctrl_logits[i, start: start + n]
                tok = (cz / temp + noise if temp > 0 else cz).argmax(dim=-1)
            gap = (z.max(dim=-1).values - z.gather(-1, tok[:, None])[:, 0]) * (
                temp if temp > 0 else 1.0)
            key = "sampled_gap" if temp > 0 else "greedy_gap"
            top = float(gap.max())
            worst[key] = top if worst[key] is None else max(worst[key], top)
            total[key] += float(gap.sum())
            count[key] += gap.numel()
            if every is not None:
                every += [(key, g) for g in gap.tolist()]
        del ref_logits, ctrl_logits
    for kind in ("greedy", "sampled"):
        n = count[f"{kind}_gap"]
        worst[f"{kind}_mean_gap"] = total[f"{kind}_gap"] / n if n else None
    n = sum(count.values())
    worst["mean_gap"] = sum(total.values()) / n if n else None
    return worst


def judge(ref, c: dict, params: dict, tl: Timeline, cell: dict, seed: int, device,
          control: str | None = None) -> dict:
    """Every compared number beside its limit: ``{name: {"value", "limit"}}``,
    plus how long the reference took (``reference_s``); with ``control``
    (``"fp8"``) also the control's gaps on the same requests (``control``),
    judged by the cell's limits (``control_checks``, ``control_correct``)."""
    t0 = time.perf_counter()
    picked = pick(tl, cell, seed)
    readings = gaps(ref, c, params, picked, device, BLOCK)
    readings["unanswered"] = sum(1 for s in tl.due_in_window()
                                 if not s.times and not s.rejected)
    readings["short"] = sum(1 for s in tl.requests
                            if s.finished and len(s.handle.tokens) != s.req.max_new)
    limits = cell["check"]["limits"]
    out = {name: {"value": readings[name], "limit": limits[name]} for name in limits}
    verdict = {"checks": out, "readings": readings, "picked": len(picked),
               "tokens": sum(len(s.handle.tokens) for s in picked),
               "reference_s": time.perf_counter() - t0}
    if control is not None:
        prog, ctrl = [], []
        gaps(ref, c, params, picked, device, BLOCK, every=prog)
        verdict["control"] = gaps(ref, c, params, picked, device, BLOCK, control, every=ctrl)
        # the control answers every request the program answered, at the
        # lengths asked for: only its gaps can fail
        ctrl_readings = {**readings, **verdict["control"]}
        verdict["control_checks"] = {name: {"value": ctrl_readings[name], "limit": limits[name]}
                                     for name in limits}
        verdict["control_correct"] = passed(verdict["control_checks"])
        verdict["detail"] = {"program": _spread(prog), "control": _spread(ctrl)}
    return verdict


def _spread(every: list) -> dict:
    """Quantiles of the per-token gaps, by kind."""
    out = {}
    for kind in ("greedy_gap", "sampled_gap"):
        g = np.sort([v for k, v in every if k == kind])
        if len(g):
            out[kind] = {"n": len(g), "mean": float(g.mean()),
                         "nonzero": float((g > 1e-6).mean()),
                         **{f"p{q}": float(np.quantile(g, q / 100)) for q in (50, 90, 99)},
                         "max": float(g[-1])}
    return out


def passed(checks: dict) -> bool:
    """Every number at or under its limit; a number with no reading (no
    request of its kind finished) fails."""
    return all(v["value"] is not None and v["value"] <= v["limit"] for v in checks.values())
