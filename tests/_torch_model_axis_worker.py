"""One rank of a run of the port on a (data, model) mesh, for
``tests/test_torch_model_axis.py`` and ``tests/test_torch_serve_mesh.py``:
run inside a world by ``repro_torch.launch.distributed_init`` as a
script,

    distributed_init --device cpu tests/_torch_model_axis_worker.py MODE OUT_DIR ARGS...

* ``train``: the training CLI (``repro_torch.launch.train.run``) with
  ARGS; writes this rank's losses, grad norms, mesh coordinates and its
  blocks of the params, m and v (by leaf path) to ``OUT_DIR/rank<k>.npz``.
  In a world of one without ``--data-model`` it is the one-process run.
* ``remat``: ARGS = ARCH: the reduced config's loss on this rank's
  blocks under the mesh context, its backward taken outside it, with
  remat on and off; writes the gathers counted in each forward and
  backward and the gradients' blocks.
* ``serve``: ARGS = ARCH DATA MODEL [swap]: the engine over a (DATA,
  MODEL) mesh (0 0: the one-process engine) on
  ``tests/test_torch_serve_mesh.py``'s requests; writes every request's
  tokens and the ``serve_stats`` counters.  With ``swap`` rank 1 submits
  requests 2 and 3 in the other order, and the ranks fall out of
  lockstep.
"""

import json
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.dist import mesh_context
from repro_torch.dist import shard as dshard
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import init_params, loss_fn
from repro_torch.serve import ContinuousBatchingEngine
from repro_torch.train.data import shard_batch, synthetic_batch

# the serve test's geometry and requests: 6 requests on 4 slots, the last
# two arriving after the third step (mid-decode), one sampled
SERVE_GEO = dict(slots=4, max_seq=32, prefill_pad=8)
SERVE_REQS = [
    {"prompt": [1, 5, 9], "max_new": 7, "seed": 0, "temperature": 0.0},
    {"prompt": [2, 4, 6, 8, 10], "max_new": 5, "seed": 1, "temperature": 1.0},
    {"prompt": [3], "max_new": 6, "seed": 2, "temperature": 0.0},
    {"prompt": [11, 13, 17, 19], "max_new": 9, "seed": 3, "temperature": 0.0},
    {"prompt": [7, 7], "max_new": 4, "seed": 4, "temperature": 0.0},
    {"prompt": [12, 30, 2, 5, 8, 1], "max_new": 6, "seed": 5, "temperature": 0.0},
]
COUNTERS = ("prefill_steps", "decode_steps", "slot_steps_total", "slot_steps_active",
            "tokens_generated", "admitted", "retired")


def drive(eng, reqs=SERVE_REQS) -> list:
    """The requests through ``eng``: four, then two more after the third
    step.  Returns each request's tokens."""
    def submit(r):
        return eng.submit(r["prompt"], max_new=r["max_new"], temperature=r["temperature"],
                          seed=r["seed"])

    live = [submit(r) for r in reqs[:4]]
    steps = 0
    while not eng.sched.idle:
        eng.step()
        steps += 1
        if steps == 3:
            live += [submit(r) for r in reqs[4:]]
    return [r.tokens for r in live]


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.detach().cpu().numpy()
    return out


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def train(out_dir: str, *argv: str) -> None:
    args = cli.parse_args(list(argv))
    params, opt_state, history = cli.run(args)
    coords = {"data": 0, "model": 0}
    if args.data_model is not None:
        mesh = cli.data_mesh(args.data_model, torch.device("cpu"))
        coords = {n: mesh.get_local_rank(n) for n in ("data", "model")}
    blocks = {f"p/{k}": v for k, v in _flat(params).items()}
    blocks.update({f"m/{k}": v for k, v in _flat(opt_state["m"]).items()})
    blocks.update({f"v/{k}": v for k, v in _flat(opt_state["v"]).items()})
    np.savez(f"{out_dir}/rank{_rank()}.npz", losses=np.array([h["loss"] for h in history]),
             grad_norms=np.array([h["grad_norm"] for h in history]),
             coords=np.array([coords["data"], coords["model"]]), **blocks)


def remat(out_dir: str, arch: str) -> None:
    cfg = get_config(arch).reduced()
    mesh = make_local_mesh(1, dist.get_world_size())
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu", mesh=mesh)
    batch = shard_batch(cfg, synthetic_batch(cfg, 2, 16, step=1, device="cpu"), mesh)
    out = {}
    for on in (True, False):
        flat = {k: v.detach().requires_grad_() for k, v in _flat_tensors(params).items()}
        start = dshard.gathers
        with mesh_context(mesh):
            loss = loss_fn(cfg, _unflat(flat), batch, remat=on)
        fwd = dshard.gathers - start
        loss.backward()  # outside the mesh context: the recompute enters it itself
        key = "remat" if on else "plain"
        out[f"{key}_forward"], out[f"{key}_backward"] = fwd, dshard.gathers - start - fwd
        out[f"{key}_loss"] = float(loss)
        np.savez(f"{out_dir}/rank{_rank()}_{key}.npz",
                 **{k: v.grad.numpy() for k, v in flat.items()})
    with open(f"{out_dir}/rank{_rank()}.json", "w") as f:
        json.dump(out, f)


def _flat_tensors(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat_tensors(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _unflat(flat: dict) -> dict:
    root: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        node = root
        for p in head:
            node = node.setdefault(p, {})
        node[last] = v
    return root


def serve(out_dir: str, arch: str, data: str, model: str, swap: str = "") -> None:
    cfg = get_config(arch).reduced()
    mesh = make_local_mesh(int(data), int(model)) if int(data) else None
    params = init_params(cfg, seed=0, dtype=torch.float32, device="cpu", mesh=mesh)
    eng = ContinuousBatchingEngine(cfg, params, state_dtype=torch.float32, device="cpu",
                                   mesh=mesh, **SERVE_GEO)
    reqs = list(SERVE_REQS)
    if swap and _rank() == 1:
        reqs[2], reqs[3] = reqs[3], reqs[2]
    tokens = drive(eng, reqs)
    stats = eng.serve_stats()
    with open(f"{out_dir}/rank{_rank()}.json", "w") as f:
        json.dump({"tokens": tokens, "stats": {k: stats[k] for k in COUNTERS},
                   "local_slots": [eng._lo, eng._n]}, f)


if __name__ == "__main__":
    mode, *rest = sys.argv[1:]
    {"train": train, "remat": remat, "serve": serve}[mode](*rest)
