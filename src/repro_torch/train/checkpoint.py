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
its integrity check, and the fsync chain of the atomic publish.  The
reference's ``Dmat`` paths need ``core.dmat`` and the communication
layer, which the port does not have yet: ``save_tree_sharded``,
``CheckpointManager.save_sharded``, ``restore_resharded`` and
``elastic_resume_step`` raise ``NotImplementedError``.
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
from ..core.pitfalls import FALLS
from ..core.redist import as_basic_index, segment_intersection
from ..obs import metrics as _metrics

__all__ = ["CheckpointManager", "elastic_resume_step", "load_tree",
           "reshard_read", "restore_resharded", "save_tree"]

_NOT_PORTED = ("the Dmat checkpoint paths need repro_torch.core.dmat and a "
               "communication layer, not ported yet (ROADMAP.md Queue 1 item 7)")

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


def save_tree(step_dir: Path, name: str, tree: dict) -> dict:
    """Write every leaf (one segment each); returns this tree's manifest
    entry."""
    entries = {}
    for path, leaf in _flatten(tree):
        arr, arr_dtype = _host(leaf)
        fn = f"{name}__{path}__s0.npy"
        nbytes = _write_shard(step_dir, fn, arr, _is_bf16(arr_dtype))
        entries[path] = {
            "shape": [int(s) for s in arr.shape],
            "dtype": arr_dtype,
            "segments": [{"file": fn, "index": [[0, s] for s in arr.shape],
                          "nbytes": nbytes}],
        }
    return entries


def save_tree_sharded(step_dir: Path, name: str, tree: dict, pid: int) -> dict:
    """The reference's per-rank part of a collective sharded save of
    ``Dmat`` leaves: not ported."""
    raise NotImplementedError(_NOT_PORTED)


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
        arr = np.asarray(reshard_read(step_dir, entry, want), order="C")
        if _is_bf16(entry["dtype"]):  # back to the stored bits, NaNs too
            bits = (arr.view(np.uint32) >> 16).astype(np.uint16)
            t = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        leaves[path] = t.to(dev)
    return _unflatten(leaves)


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
        """The reference's collective sharded save: not ported."""
        raise NotImplementedError(_NOT_PORTED)

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
                          via: str = "auto"):
        """The reference's restore under another processor grid: not
        ported."""
        raise NotImplementedError(_NOT_PORTED)


def restore_resharded(mgr: CheckpointManager, step: int | None = None, ctx=None,
                      dst_map=None, *, via: str = "auto"):
    """Module-level alias of :meth:`CheckpointManager.restore_resharded`:
    not ported."""
    raise NotImplementedError(_NOT_PORTED)


def elastic_resume_step(mgr: CheckpointManager, ctx=None) -> int | None:
    """The reference's recovery step agreed across a relaunched world: not
    ported."""
    raise NotImplementedError(_NOT_PORTED)
