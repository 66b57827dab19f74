"""The paper's own benchmark configuration: HPC Challenge problem sizes
(paper §III.F).  Sizes follow the paper's scaling protocol — the problem
grows with Np for STREAM/FFT/RandomAccess (weak scaling) and HPL uses a
fixed 4K matrix per the single-process figure.

The port's copy of ``repro.configs.hpcc``; ``tests/test_torch_port.py``
holds it to the original."""

from dataclasses import dataclass


@dataclass(frozen=True)
class HPCCConfig:
    stream_elems_per_proc: int = 2**20   # triad vector elements per rank
    fft_side: int = 2**9                 # P=Q=512 complex matrix
    ra_table_bits: int = 16              # 2^16-entry table per the scaled-down run
    ra_updates_per_proc: int = 2**12
    hpl_n: int = 256                     # LU problem size (CPU-CI scale)
    hpl_block: int = 32


def config() -> HPCCConfig:
    return HPCCConfig()
