"""pPython core for the port: PGAS distributed arrays (the paper's
primary contribution), the same user surface as ``repro.core``.

``Dmap`` (the map construct) + ``Dmat`` (the distributed array) +
PITFALLS (the redistribution index algebra) + the parallel support
functions.  ``dmap``, ``pitfalls``, ``redist``, ``dmat`` and ``ops`` are
the port's own copies of ``repro.core``'s modules (NumPy only; ``Dmat``
runs over the port's copy of the communication layer,
``repro_torch.comm``), so a pRUN worker that imports this package never
pays the ``torch`` import.  Beyond the reference's names it exports the
segment helpers the checkpoint reads with (``as_basic_index``,
``owned_segment_positions``, ``segment_intersection``).
``torch_bridge`` (imported on its own) lowers a ``Dmap`` onto a
``torch.distributed`` mesh (the port of ``repro.core.jax_bridge``).
"""

from .dmap import Dmap
from .dmat import Dmat, redistribute
from .redist import (
    RedistPlan,
    as_basic_index,
    clear_plan_cache,
    exec_stats,
    get_plan,
    owned_segment_positions,
    plan_cache_stats,
    reset_exec_stats,
    segment_intersection,
)
from .ops import (
    agg,
    agg_all,
    arange_field,
    barrier,
    dcomplex,
    fft,
    global_block_range,
    global_block_ranges,
    global_ind,
    grid,
    inmap,
    local,
    ones,
    put_local,
    rand,
    randn,
    scatter,
    sprand,
    synch,
    transpose_grid,
    zeros,
)
from .pitfalls import (
    FALLS,
    block_cyclic_falls,
    block_falls,
    cyclic_falls,
    dist_falls,
    falls_indices,
    falls_intersect,
    falls_list_intersect,
    falls_list_size,
    intersect_ranks,
)

__all__ = [
    "Dmap",
    "Dmat",
    "redistribute",
    "RedistPlan",
    "get_plan",
    "plan_cache_stats",
    "exec_stats",
    "reset_exec_stats",
    "clear_plan_cache",
    "FALLS",
    "falls_indices",
    "falls_intersect",
    "falls_list_intersect",
    "falls_list_size",
    "block_falls",
    "cyclic_falls",
    "block_cyclic_falls",
    "dist_falls",
    "intersect_ranks",
    "zeros",
    "ones",
    "rand",
    "randn",
    "arange_field",
    "dcomplex",
    "sprand",
    "fft",
    "local",
    "put_local",
    "agg",
    "agg_all",
    "scatter",
    "global_block_range",
    "global_block_ranges",
    "global_ind",
    "grid",
    "inmap",
    "synch",
    "barrier",
    "transpose_grid",
    "as_basic_index",
    "owned_segment_positions",
    "segment_intersection",
]
