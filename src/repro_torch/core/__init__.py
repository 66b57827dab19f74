"""The part of pPython's core the port needs: the map construct and the
PITFALLS index algebra, for the checkpoint's segment reads.

``dmap``, ``pitfalls`` and ``redist`` are the port's own copies of
``repro.core``'s modules.  ``Dmat`` and the parallel support functions
(``repro.core.dmat``, ``repro.core.ops``) are not ported: they need the
communication layer, which waits for distribution.
"""

from .dmap import Dmap
from .pitfalls import FALLS
from .redist import as_basic_index, owned_segment_positions, segment_intersection

__all__ = ["Dmap", "FALLS", "as_basic_index", "owned_segment_positions",
           "segment_intersection"]
