"""Dry run of the port: trace every (arch × shape × mesh) cell on a fake
world (the port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's analyses of the compiled program.  The port has
no compiler, so it runs the cell's real step, as one rank runs it, on
fake tensors (``FakeTensorMode``: shapes and dtypes, no data) inside a
fake process group of the production world: 256 cards as (32, 8) over
("data", "model"), or 512 as (2, 32, 8) over ("pod", "data", "model")
(``launch/mesh.py::production_shape``).  Every tensor is a fake on the
CPU: the dry run never touches a card, as the reference's compile-only
run never touches a TPU, and no kernel is built or launched.  Importing
this module creates nothing; only ``fake_world`` (and ``main``, which
enters it) creates the group, and it refuses to start beside one.

The cell bodies are the port's own steps, as ``_lower_and_compile``
builds the reference's: ``make_train_step`` on the mesh (the global
batch, this rank's blocks of the fp32 params and AdamW moments, the
kernels' plain versions under ``plain_kernels()`` as on the card),
``make_prefill_step`` and ``make_serve_step`` under ``mesh_context(mesh)``
(bf16 blocks gathered on use, this rank's rows of the batch and of the
decode state).  The serve bodies reach the kernels' stand-ins
(``kernels.ops``): each allocates the kernel's outputs alone and adds the
kernel's own count.  The reference's ``TrainStepConfig.sp`` has no
counterpart in the port (``train/train_step.py``): records say
``"sp": null``.

Per cell, for rank 0 (every rank of a production mesh does the same):

* ``cost.flops_per_device``: ``FlopCounterMode`` (matrix products) over
  the step, plus the kernels' ``cost`` flops;
* ``cost.bytes_per_device``: the bytes every aten op reads and writes
  (inputs and outputs; views and allocations move none) plus the
  kernels' bytes: the unfused upper bound, as if no two ops shared a
  read;
* ``cost.transcendentals``: the output elements of transcendental ops
  (exp, log, tanh, rsqrt, sigmoid, SiLU, GELU, softmax, ...) plus the
  kernels';
* ``collectives``: each ``c10d`` call with its tensor bytes and group
  size, turned into link bytes by the reference's ring factors
  (``link_bytes``), under the reference's names;
* ``memory.peak_bytes``: the traced peak of live storages (each rounded
  up to 512 bytes, the card's allocation unit), with the params,
  optimizer state, inputs and decode state counted from the start,
  beside its categories at the peak.  XLA's argument/output/temp/alias
  sizes have no meaning here and are not given.

No extrapolation: the port loops over layers in Python, so every layer
and microbatch is traced (``cost`` equals ``cost_raw``,
``extrapolated_from_layers`` null), on both meshes.  ``hbm_model`` is
``dist/memmodel.py::analytic_memory`` with its ``fits_h100_80gb`` flag;
it read 1.582x under the card's measured peak for gemma-2b training at
4 x 128 (``HBM_MODEL_NOTE``).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] [--out f.jsonl]
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import sys
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.weak import WeakIdKeyDictionary

from ..configs import SHAPES, cell_applicable, get_config, list_archs
from ..dist.memmodel import analytic_memory
from ..dist.sharding import mesh_shape
from .mesh import production_shape

__all__ = ["MICROBATCHES", "HBM_MODEL_NOTE", "input_specs", "link_bytes", "fake_world",
           "trace_cell", "cell_record", "lower_cell", "main"]

# baseline grad-accum microbatch counts per arch for train_4k (the
# reference's table)
MICROBATCHES = {
    "qwen2-vl-72b": 16,
    "qwen3-moe-235b-a22b": 16,
    "nemotron-4-15b": 8,
    "zamba2-2.7b": 8,
    "qwen2-7b": 4,
    "minicpm-2b": 4,
    "musicgen-medium": 4,
    "deepseek-moe-16b": 4,
    "rwkv6-1.6b": 4,
    "gemma-2b": 2,
}

N_DEVICES = {False: 256, True: 512}  # the single- and multi-pod worlds

HBM_MODEL_NOTE = ("analytic model (dist/memmodel.py): read 1.582x under the card's measured "
                  "peak for gemma-2b training at 4 x 128 (NVIDIA H100 80GB HBM3, 700.00 W)")

ALLOC_UNIT = 512  # bytes: the CUDA caching allocator's smallest block

SKIP_REASON = "full attention at 524k decode (DESIGN.md §5)"


def input_specs(cfg, kind: str, batch: int, seq: int) -> dict:
    """``{name: (shape, dtype)}`` of every model input, global (the
    reference's ``ShapeDtypeStruct`` stand-ins)."""
    i32 = torch.int32
    specs: dict = {}
    if kind in ("train", "prefill"):
        if cfg.frontend:
            specs["inputs_embeds"] = ((batch, seq, cfg.d_model), torch.bfloat16)
        else:
            specs["tokens"] = ((batch, seq), i32)
        if kind == "train":
            specs["labels"] = ((batch, seq), i32)
        if cfg.pos_embedding == "mrope":
            specs["positions"] = ((3, batch, seq), i32)
    elif kind == "decode":
        specs["tokens"] = ((batch, 1), i32)
        specs["pos"] = ((), i32)
    return specs


def _microbatches(arch: str, batch: int, dp_total: int) -> int:
    mb = MICROBATCHES.get(arch, 4)
    # each microbatch must still cover the data axes
    while mb > 1 and (batch // mb) % dp_total:
        mb //= 2
    return max(1, min(mb, batch))


def link_bytes(op: str, size: float, n: int) -> float:
    """Per-device link bytes of one collective of ``size`` result bytes
    over ``n`` ranks, the reference's ring accounting
    (``collective_link_bytes``): all-gather result·(N-1)/N, reduce-scatter
    result·(N-1), all-reduce 2·size·(N-1)/N, all-to-all size·(N-1)/N,
    anything else (collective-permute) size."""
    if op == "all-gather":
        return size * (n - 1) / max(n, 1)
    if op == "reduce-scatter":
        return size * (n - 1)
    if op == "all-reduce":
        return 2 * size * (n - 1) / max(n, 1)
    if op == "all-to-all":
        return size * (n - 1) / max(n, 1)
    return size


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(n_devices: int, *, multi_pod: bool = False, shape: dict | None = None):
    """A fake process group of ``n_devices`` ranks, joined as rank 0, and
    the mesh over it: the production mesh, or ``shape`` ({axis name:
    size} in mesh order).  Yields the ``DeviceMesh``; destroys the group
    on exit.  Collectives on it move nothing and return at once.  Refuses
    to start while a process group exists."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialized; the fake "
                           "world must not meet a real one")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("fake_world: torch.testing._internal.distributed.fake_pg is "
                           "missing from this torch; the dry run needs its fake backend") from e
    if shape is None:
        dims, names = production_shape(n_devices, multi_pod=multi_pod)
    else:
        names, dims = tuple(shape), tuple(shape.values())
    if math.prod(dims) != n_devices:
        raise ValueError(f"mesh {dict(zip(names, dims))} does not cover {n_devices} ranks")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n_devices)
    try:
        yield init_device_mesh("cpu", dims, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()
        gc.collect()  # the mesh's groups sit in reference cycles


# ---------------------------------------------------------------------------
# What a rank's step dispatches
# ---------------------------------------------------------------------------

_TRANSCENDENTAL = frozenset({
    "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10", "log1p", "tanh", "tanh_",
    "rsqrt", "rsqrt_", "sqrt", "sqrt_", "sigmoid", "sigmoid_", "silu", "silu_", "silu_backward",
    "gelu", "gelu_", "gelu_backward", "erf", "sin", "cos", "softplus", "pow", "pow_",
    "_softmax", "_log_softmax", "_log_softmax_backward_data", "logsumexp",
})
# allocations and metadata: no bytes move
_NO_TRAFFIC = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "lift_fresh",
    "_local_scalar_dense",
})
# c10d ops, by the reference's names for what they do
_COLLECTIVES = {
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _allocates(func) -> bool:
    """Whether ``func``'s outputs are new storage (not views of its inputs
    or the inputs it wrote in place)."""
    return all(r.alias_info is None for r in func._schema.returns)


def _group_size(args) -> int:
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):
            return dist.ProcessGroup.unbox(a).size()
        if isinstance(a, dist.ProcessGroup):
            return a.size()
    raise ValueError("a c10d call without a process group")


class _Trace(TorchDispatchMode):
    """Counts the bytes, transcendentals and collectives of every op it
    sees, and the live storages' bytes (a liveness tracker: a storage
    counts from the op that made it until its last reference goes)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0
        self.calls: list[tuple[str, int, int]] = []  # (op, result bytes, group size)
        self.live: dict[str, int] = {}
        self.peak = 0
        self.at_peak: dict[str, int] = {}
        self._seen = WeakIdKeyDictionary()

    def track(self, category: str, tree) -> None:
        for t in _tensors(tree):
            self._add(t, category)

    def _add(self, t: torch.Tensor, category: str) -> None:
        st = t.untyped_storage()
        if st in self._seen:
            return
        n = -(-st.nbytes() // ALLOC_UNIT) * ALLOC_UNIT
        self._seen[st] = weakref.ref(st, lambda _, n=n, c=category: self._free(n, c))
        self.live[category] = self.live.get(category, 0) + n
        total = sum(self.live.values())
        if total > self.peak:
            self.peak, self.at_peak = total, dict(self.live)

    def _free(self, n: int, category: str) -> None:
        self.live[category] -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d":
            if name != "barrier":
                self.calls.append((_COLLECTIVES.get(name, name), _nbytes(args[0]),
                                   _group_size(args)))
        elif not _is_view(func) and name not in _NO_TRAFFIC:
            self.bytes += _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
            if name in _TRANSCENDENTAL:
                self.transcendentals += sum(t.numel() for t in _tensors(out))
        if _allocates(func):
            for t in _tensors(out):
                self._add(t, "transient")
        return out

    def collectives(self) -> dict:
        """The reference's form: link bytes and calls by op, and (the
        port's addition) calls by op and group size."""
        sums: dict[str, float] = {}
        count: dict[str, int] = {}
        by_group: dict[str, dict[str, int]] = {}
        for op, size, n in self.calls:
            sums[op] = sums.get(op, 0.0) + link_bytes(op, size, n)
            count[op] = count.get(op, 0) + 1
            g = by_group.setdefault(op, {})
            g[str(n)] = g.get(str(n), 0) + 1
        sums["total"] = sum(sums.values())
        return {"bytes": sums, "count": count, "count_by_group_size": by_group}


def _build(cfg, kind: str, batch: int, seq: int, mesh, microbatches: int, remat: bool,
           grad_compression: str, dtype):
    """(body, external): the cell's step for this rank (for one device
    with ``mesh`` None), ready to run once on fakes, and the tensors it
    starts with, by category.  Call inside the ``FakeTensorMode`` the
    trace runs in."""
    from ..dist.hints import mesh_context
    from ..dist.shard import shard_tree
    from ..dist.sharding import batch_shardings, decode_state_shardings
    from ..models import init_params
    from ..models.model import abstract_decode_state

    params = init_params(cfg, 0, dtype=dtype, device="cpu", mesh=mesh)
    glob = {k: torch.zeros(shape, dtype=dt) for k, (shape, dt) in
            input_specs(cfg, kind, batch, seq).items()}
    if kind == "train":
        from ..train.optimizer import AdamWConfig
        from ..train.train_step import TrainStepConfig, init_opt_state, make_train_step

        ts = TrainStepConfig(microbatches=microbatches, remat=remat,
                             grad_compression=grad_compression)
        opt_state = init_opt_state(cfg, params, ts)
        step = make_train_step(cfg, AdamWConfig(schedule="wsd" if cfg.wsd_schedule else "cosine"),
                               ts, mesh=mesh)
        # the train step takes the global batch and cuts this rank's rows
        return (lambda: step(params, opt_state, glob),
                {"params": params, "opt_state": opt_state, "inputs": glob})
    on_mesh = contextlib.nullcontext
    if mesh is not None:  # this rank's rows, and its leaves gathered on use
        specs = batch_shardings(cfg, mesh, kind, batch)
        split = any(e is not None for e in specs["inputs_embeds" if cfg.frontend and
                                                 kind == "prefill" else "tokens"].spec)
        glob = shard_tree(glob, specs, mesh)
        on_mesh = functools.partial(mesh_context, mesh, rows_split=split)
    if kind == "prefill":
        from ..serve.engine import make_prefill_step

        step = make_prefill_step(cfg)

        def body():
            with torch.no_grad(), on_mesh():
                return step(params, glob)

        return body, {"params": params, "inputs": glob}
    from ..serve.engine import make_serve_step

    abstract = abstract_decode_state(cfg, batch, seq)
    shapes = {k: v.shape for k, v in abstract.items()}
    if mesh is not None:  # this rank's block of each leaf
        sh = decode_state_shardings(cfg, mesh, batch, seq)
        shapes = {k: sh[k].shard_shape(v) for k, v in shapes.items()}
    state = {k: torch.zeros(shapes[k], dtype=v.dtype) for k, v in abstract.items()}
    step = make_serve_step(cfg)

    def body():
        with torch.no_grad(), on_mesh():
            return step(params, state, glob["tokens"], glob["pos"])

    return body, {"params": params, "inputs": glob, "decode_state": state}


def trace_cell(cfg, kind: str, batch: int, seq: int, mesh, *, microbatches: int = 1,
               remat: bool = True, grad_compression: str = "none", dtype=None) -> dict:
    """Run one rank's step of a cell on fakes over ``mesh`` (a
    ``DeviceMesh`` of a ``fake_world``; None: one device, no world, the
    meshless step) and count it.  ``dtype``: the
    params' (default fp32 for training, the port's trainer; bf16 for
    serving, the engine's)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..kernels.ops import kernel_tally

    if dtype is None:
        dtype = torch.float32 if kind == "train" else torch.bfloat16
    fake = FakeTensorMode()
    t0 = time.monotonic()
    with fake:
        body, external = _build(cfg, kind, batch, seq, mesh, microbatches, remat,
                                grad_compression, dtype)
    trace = _Trace()
    for category, tree in external.items():
        trace.track(category, tree)
    del external
    with fake, kernel_tally() as kernels, FlopCounterMode(display=False) as flops, trace:
        out = body()
        del out
    seconds = time.monotonic() - t0
    aten_flops = int(flops.get_total_flops())
    k_sum = {key: sum(k[key] for k in kernels.values())
             for key in ("flops", "bytes", "transcendentals")}
    coll = trace.collectives()
    return {
        "flops": aten_flops + k_sum["flops"],
        "aten_flops": aten_flops,
        "bytes": trace.bytes + k_sum["bytes"],
        "transcendentals": trace.transcendentals + k_sum["transcendentals"],
        "kernels": kernels,
        "collectives": coll,
        "collective_calls": trace.calls,
        "memory": {"peak_bytes": trace.peak, "at_peak": trace.at_peak,
                   "alloc_unit_bytes": ALLOC_UNIT},
        "param_dtype": str(dtype).removeprefix("torch."),
        "trace_s": seconds,
    }


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------


def _mesh_label(sizes: dict) -> str:
    return "x".join(str(v) for v in sizes.values())


def _skip_record(arch: str, shape_name: str, multi_pod: bool) -> dict:
    return {"arch": arch, "shape": shape_name, "mesh": "multi" if multi_pod else "single",
            "status": "skipped", "reason": SKIP_REASON}


def cell_record(arch: str, shape_name: str, mesh, microbatches: int | None = None,
                grad_compression: str = "none") -> dict:
    """The part of a cell's record that needs no tracing, on ``mesh`` (a
    ``DeviceMesh`` or {axis name: size}): the skip record, or the counts,
    microbatches, ``hbm_model`` and model FLOPs."""
    sizes = mesh_shape(mesh)
    multi = "pod" in sizes
    cfg = get_config(arch)
    cell = SHAPES[shape_name]
    if not cell_applicable(cfg, shape_name):
        return _skip_record(arch, shape_name, multi)
    n_dev = math.prod(sizes.values())
    dp_total = sizes.get("data", 1) * sizes.get("pod", 1)
    mb = 1
    if cell.kind == "train":
        mb = microbatches or _microbatches(arch, cell.batch, dp_total)
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        model_flops = 6 * n_active * cell.batch * cell.seq
    elif cell.kind == "prefill":
        model_flops = 2 * n_active * cell.batch * cell.seq
    else:
        model_flops = 2 * n_active * cell.batch  # one token per request
    return {
        "arch": arch, "shape": shape_name, "mesh": "multi" if multi else "single",
        "mesh_shape": _mesh_label(sizes), "kind": cell.kind, "n_devices": n_dev,
        "batch": cell.batch, "seq": cell.seq, "status": "ok", "microbatches": mb,
        "param_count": cfg.param_count(), "active_param_count": n_active,
        "grad_compression": grad_compression, "sp": None,
        "hbm_model": analytic_memory(cfg, sizes, cell.kind, cell.batch, cell.seq,
                                     microbatches=mb),
        "hbm_model_note": HBM_MODEL_NOTE,
        "model_flops_per_device": model_flops / n_dev,
    }


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               microbatches: int | None = None, remat: bool = True,
               grad_compression: str = "none", mesh=None) -> dict:
    """One cell's record: traced on ``mesh`` (a fake world's), or on a
    production world of its own (256 cards, 512 with ``multi_pod``)."""
    if mesh is None:
        if not cell_applicable(get_config(arch), shape_name):
            return _skip_record(arch, shape_name, multi_pod)
        with fake_world(N_DEVICES[multi_pod], multi_pod=multi_pod) as mesh:
            return lower_cell(arch, shape_name, multi_pod, microbatches, remat,
                              grad_compression, mesh)
    record = cell_record(arch, shape_name, mesh, microbatches, grad_compression)
    if record["status"] != "ok":
        return record
    cell = SHAPES[shape_name]
    t = trace_cell(get_config(arch), cell.kind, cell.batch, cell.seq, mesh,
                   microbatches=record["microbatches"], remat=remat,
                   grad_compression=grad_compression)
    record["remat"] = remat if cell.kind == "train" else None
    record["param_dtype"] = t["param_dtype"]
    record["trace_s"] = round(t["trace_s"], 2)
    record["memory"] = t["memory"]
    record["cost_raw"] = {
        "flops_per_device": float(t["flops"]),
        "bytes_per_device": float(t["bytes"]),
        "bytes_are": "unfused upper bound: every aten op's inputs and outputs, plus the "
                     "kernels' own bytes",
        "collective_bytes_per_device": float(t["collectives"]["bytes"]["total"]),
        "transcendentals": float(t["transcendentals"]),
    }
    record["cost"] = {**record["cost_raw"], "extrapolated_from_layers": None}
    record["aten_flops_per_device"] = float(t["aten_flops"])
    record["kernels"] = t["kernels"]
    record["collectives"] = t["collectives"]
    return record


def _summary(tag: str, rec: dict) -> str:
    hm = rec["hbm_model"]
    return (f"[ok] {tag}: hbm-model {hm['total'] / 2**30:.2f} GiB/device "
            f"({'fits' if hm['fits_h100_80gb'] else 'OVER'} 80G; the model read 1.582x under "
            f"the card's peak for gemma-2b training at 4x128), "
            f"traced peak {rec['memory']['peak_bytes'] / 2**30:.2f} GiB, "
            f"{rec['cost']['flops_per_device'] / 1e12:.2f} TF/device, "
            f"link {rec['cost']['collective_bytes_per_device'] / 2**30:.3f} GiB/device "
            f"(trace {rec['trace_s']}s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true", help="run every cell")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required (or --all)")
        cells = [(args.arch, args.shape)]
    meshes = [args.multi_pod] if not args.both_meshes else [False, True]

    failures = 0
    for mp in meshes:
        with fake_world(N_DEVICES[mp], multi_pod=mp) as mesh:
            label = _mesh_label(mesh_shape(mesh))
            for arch, shape in cells:
                tag = f"{arch} × {shape} × {label}"
                try:
                    rec = lower_cell(arch, shape, multi_pod=mp, microbatches=args.microbatches,
                                     remat=not args.no_remat, mesh=mesh)
                except Exception as e:  # noqa: BLE001 - recorded as cell failure
                    rec = {"arch": arch, "shape": shape, "mesh": "multi" if mp else "single",
                           "status": "failed", "error": f"{type(e).__name__}: {e}"}
                    failures += 1
                if rec["status"] == "ok":
                    print(_summary(tag, rec), flush=True)
                elif rec["status"] == "skipped":
                    print(f"[skip] {tag}: {rec['reason']}", flush=True)
                else:
                    print(f"[FAIL] {tag}: {rec['error']}", flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
