"""The part of pPython's core the port needs: the map construct, the
distributed array and the PITFALLS index algebra, for the checkpoint's
segment reads and ``Dmat`` paths and for the torch bridge.

``dmap``, ``pitfalls``, ``redist``, ``dmat`` and ``ops`` are the port's
own copies of ``repro.core``'s modules (NumPy only; ``Dmat`` runs over
the port's copy of the communication layer, ``repro_torch.comm``);
``torch_bridge`` lowers a ``Dmap`` onto a ``torch.distributed`` mesh
(the port of ``repro.core.jax_bridge``).
"""

from .dmap import Dmap
from .dmat import Dmat, redistribute
from .ops import agg
from .pitfalls import FALLS
from .redist import as_basic_index, owned_segment_positions, segment_intersection

__all__ = ["Dmap", "Dmat", "FALLS", "agg", "as_basic_index", "owned_segment_positions",
           "redistribute", "segment_intersection"]
