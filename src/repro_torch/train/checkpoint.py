"""Checkpointing in PyTorch (the port of ``repro.train.checkpoint``):
atomic, async save/restore in the reference's on-disk format.

Layout (one directory per step, atomically published by rename)::

    ckpt/step-000042.tmp/...   -> ckpt/step-000042/
        manifest.json          # per-leaf: global shape, dtype, segments
        <leaf-path>__s<k>.npy  # one file per saved leaf (this package)
        <leaf-path>__r<p>.npy  # one file per rank (the reference's
                               # collective sharded save)

The manifest and the file names are the reference's
(``docs/checkpoint-format.md``), so either package restores what the
other saved, bit for bit.  ``save`` writes what the reference's ``save``
writes (contiguous ``"index"`` segments, no ``"format"`` key); the
readers take format-2 manifests too, whose ``"falls"`` segments (a
sharded save's cyclic or block-cyclic parts) are intersected with the
wanted window by the FALLS algebra, reading only the intersecting
``np.load(mmap_mode='r')`` windows (``reshard_read``).

Leaves are torch tensors (brought to the host with ``.detach().cpu()``)
or NumPy arrays; ``load_tree`` and ``CheckpointManager.restore`` return
tensors on a ``device``, with ``shardings`` each rank's block alone
(the reference's elastic restore), read from exactly the saved bytes
that intersect it.  bfloat16 leaves are stored as their raw uint16
bit patterns and widened bit-exactly on read, as in the reference.

``CheckpointManager`` keeps the reference's async writes (background
thread, on a host snapshot taken before ``save`` returns: the training
step updates its tensors in place), retention, restart discovery with
its integrity check, and the fsync chain of the atomic publish.

The ``Dmat`` paths run over the port's copy of the PGAS core
(``repro_torch.core.dmat``, ``repro_torch.comm``), with the reference's
algorithm and names.  ``CheckpointManager.save_sharded`` is the
collective save: every mapped rank writes its owned part of each
``Dmat`` leaf as one ``__r<pid>.npy`` file whose segment carries the
per-dim FALLS and the leaf's ``Dmap``; rank 0 writes the replicated
leaves, merges the gathered partial manifests and publishes.
``restore_resharded`` lands such a checkpoint under another processor
grid: each rank mmap-reads its owned FALLS intersection of the saved
segments (``direct``), or the saved map's ranks read their own shards
and one ``RedistPlan`` redistribution moves the rest (``redist``); no
rank allocates a global array (the ``ckpt.peak_buffer_bytes`` gauge).
``Dmat`` leaves come back as ``Dmat``s whose local parts are host NumPy,
as in the reference; replicated leaves as tensors on ``device``.
``elastic_resume_step`` is the step a relaunched world agrees on.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from .._device import resolve_device
from ..core.dmap import Dmap
from ..core.dmat import Dmat
from ..core.pitfalls import FALLS
from ..core.redist import (
    as_basic_index,
    owned_segment_positions,
    redistribute,
    segment_intersection,
)
from ..obs import metrics as _metrics

__all__ = ["CheckpointManager", "elastic_resume_step", "load_tree",
           "reshard_read", "restore_resharded", "save_tree"]

# restore-side observability: the largest buffer any reader allocated
# (the no-global-array assertion in benchmarks/ckpt_bench.py), plus
# files-opened / bytes-read counters (the zero-intersection tests assert
# a non-intersecting shard file is never even opened)
_PEAK = _metrics.gauge("ckpt.peak_buffer_bytes")
_FILES = _metrics.counter("ckpt.files_opened")
_BYTES = _metrics.counter("ckpt.read_bytes")


def _note_buffer(nbytes: int) -> None:
    """Set-max: the gauge keeps the largest restore buffer seen."""
    if nbytes > _PEAK.value:
        _PEAK.set(nbytes)


def _fsync_dir(path: Path) -> None:
    """fsync a directory fd so the entries inside it are durable.

    The rename-into-place publish is only atomic against *readers*; a
    host crash can still lose the rename (or the files it points at)
    unless the data, the directory that names it, and the parent that
    names the rename are all synced.  Best-effort on filesystems that
    reject directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _flatten(tree: dict, prefix: str = "") -> list[tuple[str, Any]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        p = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.extend(_flatten(v, p))
        else:
            out.append((p, v))
    return out


def _unflatten(items: dict[str, Any]) -> dict:
    root: dict = {}
    for path, v in items.items():
        parts = path.split(".")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


# ---------------------------------------------------------------------------
# bfloat16: raw bit patterns on disk, exact widening on read
# ---------------------------------------------------------------------------


def _is_bf16(dtype_str: str) -> bool:
    return dtype_str == "bfloat16"


def _bf16_store(arr: np.ndarray) -> np.ndarray:
    """uint16 bit-pattern view for writing (np.save of the ml_dtypes
    dtype would degrade to an opaque ``|V2`` descr)."""
    return np.ascontiguousarray(arr).view(np.uint16)


def _bf16_widen(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits -> float32, bit-exact (bf16 is f32's top half)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _open_shard(path: Path, bf16: bool) -> np.ndarray:
    """mmap a shard file; bf16 shards present as uint16 bits (also
    reinterprets legacy ``|V2`` files written before the uint16 era)."""
    _FILES.inc()
    mm = np.load(path, mmap_mode="r")
    if bf16 and mm.dtype != np.uint16:
        mm = mm.view(np.uint16)
    return mm


# ---------------------------------------------------------------------------
# Segment index encoding
# ---------------------------------------------------------------------------


def _falls_encode(fs: list[FALLS]) -> list[list[int]]:
    return [[int(f.l), int(f.r), int(f.s), int(f.n)] for f in fs]


def _segment_falls(seg: dict) -> list[list[FALLS]]:
    """A segment's per-dim global index set, whichever encoding it uses:
    ``"falls"`` (general, written by save_sharded) or the legacy
    contiguous ``"index"`` ``[start, stop)`` pairs."""
    if "falls" in seg:
        return [[FALLS(*map(int, f)) for f in dim] for dim in seg["falls"]]
    return [
        [FALLS(s, e - 1, max(e - s, 1), 1)] if e > s else []
        for s, e in seg["index"]
    ]


def _read_segment_positions(
    step_dir: Path, seg: dict, file_pos: tuple, bf16: bool
) -> np.ndarray:
    """Read exactly ``file_pos`` from one shard file (mmap window)."""
    mm = _open_shard(step_dir / seg["file"], bf16)
    data = mm[as_basic_index(file_pos)]
    n = 1
    for p in file_pos:
        n *= len(p)
    _BYTES.inc(n * mm.dtype.itemsize)
    if bf16:
        data = _bf16_widen(np.asarray(data))
    return data


# ---------------------------------------------------------------------------
# Save
# ---------------------------------------------------------------------------


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host NumPy array and its manifest dtype: a tensor via
    ``.detach().cpu()``, bf16 as its uint16 bits under ``"bfloat16"``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _snapshot(leaf):
    """A host copy of a leaf that later in-place updates do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def _write_shard(step_dir: Path, fn: str, data: np.ndarray, bf16: bool) -> int:
    # write through an explicit handle so the shard can be fsynced: a
    # crash after the step dir's rename-publish must not leave a
    # discoverable checkpoint with torn shards
    with open(step_dir / fn, "wb") as f:
        np.save(f, _bf16_store(data) if bf16 else data)
        f.flush()
        os.fsync(f.fileno())
    return (step_dir / fn).stat().st_size


def _save_leaf(step_dir: Path, name: str, path: str, leaf) -> dict:
    """Write a whole leaf as one segment; returns its manifest entry."""
    arr, arr_dtype = _host(leaf)
    fn = f"{name}__{path}__s0.npy"
    nbytes = _write_shard(step_dir, fn, arr, _is_bf16(arr_dtype))
    return {
        "shape": [int(s) for s in arr.shape],
        "dtype": arr_dtype,
        "segments": [{"file": fn, "index": [[0, s] for s in arr.shape],
                      "nbytes": nbytes}],
    }


def save_tree(step_dir: Path, name: str, tree: dict) -> dict:
    """Write every leaf (one segment each); returns this tree's manifest
    entry."""
    return {path: _save_leaf(step_dir, name, path, leaf) for path, leaf in _flatten(tree)}


def save_tree_sharded(step_dir: Path, name: str, tree: dict, pid: int) -> dict:
    """This rank's contribution to one tree of a collective sharded save.

    ``Dmat`` leaves: every mapped rank writes its owned local part (halo
    stripped) as one ``__r<pid>.npy`` file whose manifest segment carries
    the per-dim FALLS index set and the leaf's ``Dmap``.  Other leaves
    (tensors or arrays) are treated as replicated and written by rank 0
    as one segment.  Returns partial entries merged by rank 0 in
    ``save_sharded``."""
    entries: dict[str, dict] = {}
    for path, leaf in _flatten(tree):
        if isinstance(leaf, Dmat):
            dtype_str = str(leaf.dtype)
            entry = {
                "shape": [int(s) for s in leaf.shape],
                "dtype": dtype_str,
                "dmap": leaf.dmap.to_json(),
                "segments": [],
            }
            if leaf.dmap.inmap(pid):
                falls = [leaf.dmap.dim_falls(leaf.shape, d, pid) for d in range(leaf.ndim)]
                if all(falls):  # owns cells along every dim
                    fn = f"{name}__{path}__r{pid}.npy"
                    nbytes = _write_shard(step_dir, fn,
                                          np.ascontiguousarray(leaf.local_view_owned()),
                                          _is_bf16(dtype_str))
                    entry["segments"].append({
                        "file": fn,
                        "falls": [_falls_encode(fs) for fs in falls],
                        "nbytes": nbytes,
                        "saver": pid,
                    })
            entries[path] = entry
        elif pid == 0:
            entries[path] = _save_leaf(step_dir, name, path, leaf)
    return entries


# ---------------------------------------------------------------------------
# Read / reshard
# ---------------------------------------------------------------------------


def reshard_read(
    step_dir: Path, entry: dict, want: list[list[int]] | None = None
) -> np.ndarray:
    """Assemble the ``want`` region (default: all) of a saved leaf.

    Per dimension, the wanted half-open range is a single-segment FALLS;
    intersecting it with each saved segment's FALLS yields exactly the
    file regions to read — the paper's redistribution math, disk edition.
    Shard files are opened ``np.load(mmap_mode='r')`` and only the
    intersecting windows are touched: a segment with an empty
    intersection is never opened, and the only allocation is the ``want``
    output buffer (bf16 entries come back as bit-exact float32)."""
    shape = entry["shape"]
    bf16 = _is_bf16(entry["dtype"])
    if not shape:  # scalar
        _FILES.inc()
        data = np.load(step_dir / entry["segments"][0]["file"])
        _BYTES.inc(int(data.nbytes))
        if bf16:
            data = _bf16_widen(np.asarray(data).view(np.uint16))
        return data
    if want is None:
        want = [[0, s] for s in shape]
    dtype = np.float32 if bf16 else np.dtype(entry["dtype"])
    out = np.zeros([stop - start for start, stop in want], dtype=dtype)
    _note_buffer(out.nbytes)
    want_falls = [
        [FALLS(ws, we - 1, max(we - ws, 1), 1)] if we > ws else []
        for ws, we in want
    ]
    for seg in entry["segments"]:
        hit = segment_intersection(want_falls, _segment_falls(seg))
        if hit is None:
            continue
        want_pos, file_pos = hit
        out[as_basic_index(want_pos)] = _read_segment_positions(
            step_dir, seg, file_pos, bf16
        )
    return out


def _fill_owned_from_disk(step_dir: Path, entry: dict, dmap: Dmap, shape: tuple, pid: int,
                          loc: np.ndarray) -> None:
    """Fill ``pid``'s owned local storage with its intersection of every
    saved segment — the mmap fast path of resharding restore."""
    bf16 = _is_bf16(entry["dtype"])
    for seg in entry["segments"]:
        hit = owned_segment_positions(dmap, shape, pid, _segment_falls(seg))
        if hit is None:
            continue
        local_pos, file_pos = hit
        loc[as_basic_index(local_pos)] = _read_segment_positions(step_dir, seg, file_pos, bf16)


def _as_tensor(arr: np.ndarray, dtype_str: str, dev: torch.device) -> torch.Tensor:
    """A read leaf as a tensor on ``dev``: bf16 entries (read widened to
    float32) back to their stored bits, NaNs too."""
    arr = np.asarray(arr, order="C")
    if not arr.flags.writeable:  # a ThreadComm broadcast's frozen buffer
        arr = arr.copy()
    if _is_bf16(dtype_str):
        bits = (arr.view(np.uint32) >> 16).astype(np.uint16)
        t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(dev)


def load_tree(step_dir: Path, name: str, manifest: dict, device="cuda",
              shardings: dict | None = None, mesh=None) -> dict:
    """Restore a tree: each leaf assembled from its saved segments and
    moved to ``device`` (bf16 leaves back in bf16, bit for bit).  With
    ``shardings`` (a tree of ``dist.sharding.Sharding`` or specs over the
    same keys) and ``mesh`` (this rank's coordinates), each leaf it
    places is this rank's block alone (``dist.shard.block_of``), read
    through ``reshard_read(..., want=block)``."""
    dev = resolve_device(device)
    flat_sh = dict(_flatten(shardings)) if shardings else {}
    if flat_sh and mesh is None:
        raise ValueError("restoring blocks needs the mesh that places them")
    leaves = {}
    for path, entry in manifest.items():
        want = None
        if path in flat_sh:
            from ..dist.shard import block_of

            block = block_of(entry["shape"], flat_sh[path], mesh)
            if block != [[0, n] for n in entry["shape"]]:
                want = block
        leaves[path] = _as_tensor(reshard_read(step_dir, entry, want), entry["dtype"], dev)
    return _unflatten(leaves)


def _resolve_dst_map(dst_map, name: str, path: str, entry: dict, np_: int):
    """Which Dmap a leaf restores under (None -> replicated).

    ``dst_map`` may be a single :class:`Dmap` (applied to every leaf of
    matching rank), a dict keyed ``"tree.leaf.path"`` / ``"tree"`` /
    ``"*"``, or a callable ``(tree, path, entry) -> Dmap | None``.  A
    leaf no rule covers falls back to its *saved* map when that map fits
    the live world, else replicates."""
    m = None
    if callable(dst_map) and not isinstance(dst_map, Dmap):
        m = dst_map(name, path, entry)
    elif isinstance(dst_map, dict):
        m = dst_map.get(f"{name}.{path}", dst_map.get(name, dst_map.get("*")))
    elif isinstance(dst_map, Dmap):
        m = dst_map
    if m is not None and m.ndim != len(entry["shape"]):
        m = None
    if m is None and "dmap" in entry:
        saved = Dmap.from_json(entry["dmap"])
        if max(saved.proclist) < np_:
            m = saved
    return m


class CheckpointManager:
    """Atomic, optionally-async checkpointing with retention + discovery."""

    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # -- save -------------------------------------------------------------------

    def save(self, step: int, trees: dict[str, dict], blocking: bool = True,
             extra_meta: dict | None = None) -> None:
        """trees: {"params": ..., "opt_state": ...}."""
        if not blocking:
            self.wait()  # one in-flight async save at a time
            # snapshot to host memory before returning control
            host_trees = {
                n: _unflatten({p: _snapshot(l) for p, l in _flatten(t)})
                for n, t in trees.items()
            }
            self._thread = threading.Thread(
                target=self._write, args=(step, host_trees, extra_meta), daemon=True
            )
            self._thread.start()
            return
        self._write(step, trees, extra_meta)

    def _write(self, step: int, trees, extra_meta) -> None:
        tmp = self.dir / f"step-{step:08d}.tmp"
        final = self.dir / f"step-{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "trees": {}}
        if extra_meta:
            manifest["meta"] = extra_meta
        for name, tree in trees.items():
            manifest["trees"][name] = save_tree(tmp, name, tree)
        self._publish(tmp, final, manifest)
        self._gc()

    def _publish(self, tmp: Path, final: Path, manifest: dict) -> None:
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # durability order: shard files (synced as written) → manifest
        # (just synced) → the directory naming them → the rename → the
        # parent naming the rename.  Only then is the checkpoint both
        # discoverable and whole after a host crash.
        _fsync_dir(tmp)
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        _fsync_dir(self.dir)

    def save_sharded(self, step: int, trees: dict[str, dict], ctx=None,
                     extra_meta: dict | None = None) -> None:
        """Collective parallel sharded save (all ranks, same ``self.dir``).

        Every mapped rank writes its own ``Dmat`` shards concurrently
        (one ``__r<pid>.npy`` per leaf, fsynced), partial manifest
        entries are gathered to rank 0, and rank 0 alone publishes the
        merged manifest with the same rename/fsync durability chain as
        :meth:`save`.  Other leaves are taken as replicated and written
        by rank 0.  The manifest records each leaf's ``Dmap``, which is
        what lets :meth:`restore_resharded` land the bytes under a
        different grid."""
        pid = 0 if ctx is None else ctx.pid
        tmp = self.dir / f"step-{step:08d}.tmp"
        final = self.dir / f"step-{step:08d}"
        if pid == 0:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
        if ctx is not None:
            ctx.barrier(tag=("__ckpt_mkdir", step))
        local = {name: save_tree_sharded(tmp, name, tree, pid) for name, tree in trees.items()}
        parts = [local] if ctx is None else ctx.gather(0, local, tag=("__ckpt_manifest", step))
        if pid == 0:
            manifest = {"step": step, "time": time.time(), "format": 2, "trees": {}}
            if extra_meta:
                manifest["meta"] = extra_meta
            for part in parts:
                for name, entries in part.items():
                    tree_m = manifest["trees"].setdefault(name, {})
                    for path, e in entries.items():
                        got = tree_m.get(path)
                        if got is None:
                            tree_m[path] = dict(e)
                        else:
                            got["segments"] = got["segments"] + e["segments"]
            for entries in manifest["trees"].values():
                for e in entries.values():
                    e["segments"].sort(key=lambda s: s.get("saver", -1))
            self._publish(tmp, final, manifest)
            self._gc()
        if ctx is not None:
            ctx.barrier(tag=("__ckpt_publish", step))

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step-{s:08d}", ignore_errors=True)

    # -- restore -------------------------------------------------------------------

    def _manifest_ok(self, step_dir: Path) -> bool:
        """Quick integrity check: the manifest parses, every segment
        file exists, and recorded sizes match.  Restart discovery uses
        this to *skip* a checkpoint torn by a crash instead of raising
        minutes into the relaunch (an explicit ``restore(step=...)``
        still raises, so a truly broken step is loudly inspectable)."""
        try:
            with open(step_dir / "manifest.json") as f:
                manifest = json.load(f)
            for entries in manifest.get("trees", {}).values():
                for entry in entries.values():
                    for seg in entry["segments"]:
                        p = step_dir / seg["file"]
                        size = p.stat().st_size  # raises if missing
                        if "nbytes" in seg and size != seg["nbytes"]:
                            return False
        except (OSError, ValueError, KeyError, TypeError):
            return False
        return True

    def list_steps(self, valid_only: bool = False) -> list[int]:
        steps = sorted(
            int(p.name.split("-")[1])
            for p in self.dir.glob("step-*")
            if p.is_dir() and not p.name.endswith(".tmp")
        )
        if not valid_only:
            return steps
        return [s for s in steps
                if self._manifest_ok(self.dir / f"step-{s:08d}")]

    def latest_step(self) -> int | None:
        steps = self.list_steps(valid_only=True)
        return steps[-1] if steps else None

    def restore(
        self, step: int | None = None, device="cuda", shardings: dict | None = None,
        mesh=None,
    ) -> tuple[int, dict[str, dict], dict]:
        """Returns (step, trees, meta), the trees' leaves tensors on
        ``device``.  ``shardings`` maps a tree's name to its placement
        tree on ``mesh``: each rank then reads only its blocks (``load_tree``),
        so a run saved on one mesh shape resumes on another.  Leaves saved
        by the reference's ``save_sharded`` are assembled from their FALLS
        segments."""
        dev = resolve_device(device)
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step_dir = self.dir / f"step-{step:08d}"
        with open(step_dir / "manifest.json") as f:
            manifest = json.load(f)
        trees = {name: load_tree(step_dir, name, entries, dev,
                                 (shardings or {}).get(name), mesh)
                 for name, entries in manifest["trees"].items()}
        return step, trees, manifest.get("meta", {})

    def restore_resharded(self, step: int | None = None, ctx=None, dst_map=None, *,
                          via: str = "auto", device="cuda") -> tuple[int, dict[str, dict], dict]:
        """Restore under a (possibly different) grid: (step, trees, meta).

        Distributed leaves come back as ``Dmat``s (host NumPy local parts)
        under the map ``dst_map`` resolves for them (see
        :func:`_resolve_dst_map`); uncovered leaves restore replicated, as
        tensors on ``device``.  Two collectively-agreed data paths:

        * ``direct`` — every rank mmap-reads exactly its owned FALLS
          intersection of the saved segments (parallel, zero messages;
          needs every rank to see every intersecting shard file).
        * ``redist`` — ranks of the *saved* map read only their own
          shards, then one ``RedistPlan`` redistribution over the live
          transport moves the residual (restore roots that are not a
          shared filesystem, or any time direct reads are impossible).

        ``via='auto'`` (default) allgathers per-rank file visibility and
        picks ``direct`` only when unanimous.  No rank ever materializes
        a global array; the peak reader allocation is tracked in the
        ``ckpt.peak_buffer_bytes`` gauge."""
        dev = resolve_device(device)
        pid = 0 if ctx is None else ctx.pid
        np_ = 1 if ctx is None else ctx.np_
        if pid == 0:
            if step is None:
                step = self.latest_step()
            manifest = None
            if step is not None:
                try:
                    with open(self.dir / f"step-{step:08d}" / "manifest.json") as f:
                        manifest = json.load(f)
                except OSError:
                    manifest = None
            payload = (step, manifest)
        else:
            payload = None
        if ctx is not None:
            payload = ctx.bcast(0, payload, tag="__ckpt_reshard_manifest")
        step, manifest = payload
        if manifest is None:
            raise FileNotFoundError(f"no restorable checkpoint under {self.dir} (step={step})")
        step_dir = self.dir / f"step-{step:08d}"

        mode = via
        if via == "auto":
            ok = self._segments_visible(step_dir, manifest)
            flags = [ok] if ctx is None else ctx.allgather(bool(ok), tag="__ckpt_reshard_mode")
            mode = "direct" if all(flags) else "redist"
        if mode not in ("direct", "redist"):
            raise ValueError(f"via must be auto|direct|redist, got {via!r}")

        trees: dict[str, dict] = {}
        for name, entries in manifest["trees"].items():
            leaves: dict[str, Any] = {}
            for path, entry in entries.items():
                m = _resolve_dst_map(dst_map, name, path, entry, np_)
                if m is None:
                    arr = self._restore_replicated(step_dir, entry, ctx, pid, mode)
                    leaves[path] = _as_tensor(arr, entry["dtype"], dev)
                else:
                    leaves[path] = self._restore_dmat(step_dir, entry, m, ctx, pid, np_, mode)
            trees[name] = _unflatten(leaves)
        return step, trees, manifest.get("meta", {})

    def _segments_visible(self, step_dir: Path, manifest: dict) -> bool:
        try:
            for entries in manifest["trees"].values():
                for entry in entries.values():
                    for seg in entry["segments"]:
                        if not (step_dir / seg["file"]).exists():
                            return False
        except (KeyError, TypeError):
            return False
        return True

    def _restore_replicated(self, step_dir, entry, ctx, pid, mode) -> np.ndarray:
        if mode == "direct" or ctx is None:
            return reshard_read(step_dir, entry)
        arr = reshard_read(step_dir, entry) if pid == 0 else None
        return ctx.bcast(0, arr, tag="__ckpt_reshard_repl")

    def _restore_dmat(self, step_dir, entry, m: Dmap, ctx, pid, np_, mode) -> Dmat:
        shape = tuple(int(s) for s in entry["shape"])
        bf16 = _is_bf16(entry["dtype"])
        dtype = np.float32 if bf16 else np.dtype(entry["dtype"])
        if m.proclist and max(m.proclist) >= np_:
            raise RuntimeError(f"destination map {m!r} does not fit the live world "
                               f"(np={np_}); pass a dst_map over live ranks")
        out = Dmat(shape, m, dtype=dtype, ctx=ctx)
        if out.local is not None and out.local.size:
            _note_buffer(out.local.nbytes)
        if mode == "direct":
            if m.inmap(pid):
                _fill_owned_from_disk(step_dir, entry, m, shape, pid, out.local_view_owned())
            return out
        # redist: the saved map's ranks read their own shards, then the
        # residual moves are one RedistPlan redistribution over the live
        # transport — a checkpoint is just one more distribution.
        src_map = (Dmap.from_json(entry["dmap"]) if "dmap" in entry
                   else Dmap([1] * len(shape), proclist=[0]))
        if max(src_map.proclist) >= np_:
            raise RuntimeError(
                f"cannot restore {entry.get('dmap')!r} via the transport: "
                f"saved map needs rank {max(src_map.proclist)} but the live "
                f"world has np={np_} and shard files are not visible to every rank")
        src = Dmat(shape, src_map, dtype=dtype, ctx=ctx)
        if src.local is not None and src.local.size:
            _note_buffer(src.local.nbytes)
        if src_map.inmap(pid):
            _fill_owned_from_disk(step_dir, entry, src_map, shape, pid, src.local_view_owned())
        redistribute(out, src)
        return out


def restore_resharded(mgr: CheckpointManager, step: int | None = None, ctx=None,
                      dst_map=None, *, via: str = "auto", device="cuda"):
    """Module-level alias of :meth:`CheckpointManager.restore_resharded`
    (the elastic-resume call site reads
    ``restore_resharded(mgr, elastic_resume_step(mgr, ctx), ctx, new_map)``)."""
    return mgr.restore_resharded(step, ctx, dst_map, via=via, device=device)


def elastic_resume_step(mgr: CheckpointManager, ctx=None) -> int | None:
    """The step every rank of a relaunched world should resume from.

    A rank killed mid-step may hold one fewer checkpoint than its peers
    (per-rank checkpoint roots, or an async save that never landed), so
    the *consistent* recovery line is the minimum of the per-rank latest
    valid steps.  Returns ``None`` when any rank has no valid checkpoint
    (the world must start from scratch together).  Without ``ctx`` (or a
    single-rank world) this is just this rank's ``latest_step()``.  Pair
    it with :func:`restore_resharded` and a map over the new world."""
    mine = mgr.latest_step()
    if ctx is None or getattr(ctx, "np_", 1) <= 1:
        return mine
    latest = ctx.allgather(-1 if mine is None else int(mine), tag="__ckpt_resume")
    lo = min(latest)
    return None if lo < 0 else lo
