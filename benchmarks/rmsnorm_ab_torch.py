#!/usr/bin/env python3
"""Time the rmsnorm kernels of several checkouts in turns on one card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 benchmarks/rmsnorm_ab_torch.py TREE [TREE ...]

Each TREE is a directory holding ``src/repro_torch/csrc/rmsnorm.cu``: this
checkout (``.``), or an earlier commit unpacked with ``git archive COMMIT
| tar -x -C DIR``.  Every TREE's source is compiled with this checkout's
nvcc flags (``repro_torch.kernels._build``), all at once, and called
through ``rmsnorm_launch``, the C entry point every version has.  At
``chip_smoke.py``'s rmsnorm time rows (``RMS_ROWS``), in bf16 and fp32,
each kernel is first held to the plain version, then timed with
``chip_smoke.device_ms`` (CUDA-graph replays over 24 rotating input
sets) beside an empty kernel of its own grid and block (``floor_ms``).
Every version launches one block a row; the threads a block come from
the library's ``rmsnorm_layout`` where it exports one, else they are 256
(the kernel before ``rmsnorm_layout`` existed).  The trees are timed in
order and then in reverse (A B B A for two), so that a drift of the
card over the run shows.

Prints the card's name and power limit, one JSON line for each tree's
build (registers and spills), one for each pass, and a last line with
every reading.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rmsnorm as rn  # noqa: E402

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_CODES = {torch.float32: 0, torch.bfloat16: 1}


def build(trees: list[str], out: Path) -> list[tuple[ctypes.CDLL, dict]]:
    """Each tree's rmsnorm library and its ``-Xptxas -v`` report, with
    one nvcc per tree, all running at once."""
    procs = []
    for i, tree in enumerate(trees):
        lib = out / f"rmsnorm-{i}.so"
        src = Path(tree) / "src" / "repro_torch" / "csrc" / "rmsnorm.cu"
        procs.append((subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib))
    libs = []
    for (proc, lib), tree in zip(procs, trees):
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{tree}: nvcc exit {proc.returncode}\n{log}")
        libs.append((ctypes.CDLL(str(lib)), cs.ptxas_report(log)))
    return libs


class Kernel:
    """One library's ``rmsnorm_launch`` as ``fn(x, w) -> y``, and the
    threads a block it launches for (D, dtype)."""

    def __init__(self, lib: ctypes.CDLL):
        self.fn = lib.rmsnorm_launch
        self.fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        self.fn.restype = ctypes.c_int
        try:
            self.layout_fn = lib.rmsnorm_layout
        except AttributeError:
            self.layout_fn = None

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        y = torch.empty_like(x)
        err = self.fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), x.shape[0], x.shape[1],
                      1e-5, _CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rmsnorm launch failed: cudaError {err}")
        return y

    def threads(self, d: int, dtype) -> int:
        """Threads a block (every version launches one block a row)."""
        if self.layout_fn is None:
            return 256
        out = (ctypes.c_int * 2)()
        if self.layout_fn(d, _CODES[dtype], out):
            raise ValueError(f"no layout for d {d}")
        return out[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+", help="checkout roots holding src/repro_torch/csrc/rmsnorm.cu")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_ab_torch: no CUDA device", file=sys.stderr)
        return 1
    card = cs.phase_device()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(args.trees, Path(tmp))
        for tree, (_, report) in zip(args.trees, libs):
            print(json.dumps({"tree": tree, "ptxas": report}), flush=True)
        kernels = [Kernel(lib) for lib, _ in libs]

        gen = torch.Generator(device="cuda").manual_seed(1)
        sets = {(label, name): cs.rms_sets(gen, m, d, dtype=dtype)
                for label, m, d in cs.RMS_ROWS for name, dtype in DTYPES.items()}
        for s in sets.values():
            for k in kernels:
                x, w = s[0]
                cs.max_err(k(x, w), rn.rmsnorm_plain(x, w), cs.KERNEL_TOL[x.dtype])
        readings = []
        order = list(range(len(args.trees)))
        for turn, i in enumerate(order + order[::-1]):
            k, rows = kernels[i], {}
            for label, m, d in cs.RMS_ROWS:
                for name, dtype in DTYPES.items():
                    threads = k.threads(d, dtype)
                    row = {"shape": [m, d], "threads_per_block": threads,
                           "ms": cs.device_ms(k, sets[(label, name)]),
                           "floor_ms": cs.rms_floor_ms(rn, m, threads),
                           **cs.rms_bound(m, d, dtype)}
                    row.update(bound_share=row["bound_ms"] / row["ms"],
                               ms_minus_floor=row["ms"] - row["floor_ms"])
                    rows[f"{label}/{name}"] = row
            readings.append({"tree": args.trees[i], "turn": turn, "rows": rows})
            print(json.dumps(readings[-1]), flush=True)
    print(json.dumps({"card": card["nvidia_smi"], "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
