"""Useful model FLOPs per token, counted from a configuration file's
published keys (2 a multiply-add, matrix products only) by its family's
own file: ``costs/families/<family>.py`` under the checkout's benchmark
folder, whose ``token_flops(c, n)`` gives the FLOPs of one token with
``n`` keys in its context.
"""

from __future__ import annotations

import functools
from pathlib import Path

from chipbench.spec import PKG, load_file


@functools.cache
def family(name: str, bench_dir: Path):
    """The count of family ``name``: its file under ``bench_dir`` as a
    module, or None where it has none."""
    path = Path(bench_dir) / "costs" / "families" / f"{name}.py"
    return load_file(path, f"{PKG}_costs_{name}") if path.is_file() else None


def prompt_flops(c: dict, fam, length: int) -> int:
    """A prompt's real tokens by the count ``fam`` (from ``family``), each
    over the keys before it and itself."""
    return sum(fam.token_flops(c, i + 1) for i in range(length))
