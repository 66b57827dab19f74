"""The benchmark's files, found by name.

``Bench(root)`` reads ``BENCHMARK.json`` at the root of a checkout and
finds a cell's file, its configuration's file, the readers of its
metrics and its family's reference by the names ``BENCHMARK.json``
gives.  Nothing here knows a cell, a traffic mix, a configuration or a metric by
name.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = "chipbench"


class Bench:
    def __init__(self, root: Path | str = ROOT):
        self.root = Path(root)
        self.dir = self.root / PKG
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    # -- cells and configurations ------------------------------------------

    def cell(self, name: str) -> dict:
        """The cell's ``BENCHMARK.json`` entry merged over its own file
        (``workloads/<name>.json``: the profiled steps and the correctness
        check) and its traffic mix's (``traffic/<traffic>.json``: the loop,
        the engine's geometry, the lengths and the sampling); raises
        KeyError for an unknown cell."""
        entry = next((w for w in self.spec["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        mix = json.loads((self.dir / "traffic" / f"{entry['traffic']}.json").read_text())
        body = json.loads((self.dir / "workloads" / f"{name}.json").read_text())
        if body.get("config", entry["config"]) != entry["config"]:
            raise ValueError(f"{name}: its file names config {body['config']!r}, "
                             f"BENCHMARK.json {entry['config']!r}")
        return {**mix, **body, **entry}

    def config(self, name: str) -> dict:
        """A configuration's file (``configs/<name>.json``)."""
        entry = next((c for c in self.spec["configs"] if c["name"] == name), None)
        if entry is None:
            raise KeyError(f"no config {name!r} in BENCHMARK.json")
        return json.loads((self.root / entry["file"]).read_text())

    # -- metrics -----------------------------------------------------------

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics ``cell`` reports:
        those that list it under ``workloads`` or list no cells."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, kind: str, name: str):
        """The module of ``end_to_end/<name>.py`` or ``metrics/<name>.py``:
        its ``read(ctx)`` returns the metric or None, and a per-layer
        reader may list in ``hooks`` the ``(module, function)`` pairs of
        the program whose calls the traced steps record for it."""
        folder = "end_to_end" if kind == "end_to_end" else "metrics"
        return load_file(self.dir / folder / f"{name}.py", f"{PKG}_{folder}_{name}")

    def reference(self, family: str):
        """The plain reference module of a model family."""
        return load_file(self.dir / "reference" / f"{family}.py", f"{PKG}_reference_{family}")


def load_file(path: Path, module_name: str):
    """Import a file by its path (metric names hold dots, which an import
    statement cannot name)."""
    spec = importlib.util.spec_from_file_location(module_name.replace(".", "_"), path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
