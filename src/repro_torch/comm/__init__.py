"""PythonMPI for the port: pPython's messaging layer (paper §III.D),
the same interface and transports as ``repro.comm``, each module the
port's own copy (NumPy and the standard library only).

Six interchangeable transports behind one interface
(``PPYTHON_TRANSPORT=file|socket|shm|hier|thread`` selects at ``init()``):

* ``FileMPI``    — the paper's transport: pickle payloads through a shared
                   directory (the default; ``PPYTHON_NP``, ``PPYTHON_PID``,
                   ``PPYTHON_COMM_DIR``), messages inspectable on disk.
* ``SocketComm`` — persistent peer-to-peer TCP connections bootstrapped by
                   a rendezvous (``rendezvous.py``): multi-node with no
                   shared filesystem on any message path.
* ``ShmComm``    — single-node multi-process over per-peer mmap'd ring
                   arenas (``/dev/shm``-backed by pRUN).
* ``HierComm``   — shm arenas between ranks of one node, TCP across
                   nodes (``PPYTHON_NODE_ID`` partitions virtual nodes).
* ``ThreadComm`` — in-process ranks (``run_spmd``).
* ``LocalComm``  — the world of one.

``collectives.py`` adds the collective algorithms, ``Group``
sub-communicators and the two-level algorithms over ``HierComm``;
``frame.py`` is the pickle-5 frame the serializing transports share;
``testing.py`` hosts thread-ranks over any transport
(``run_transport_spmd``).  ``repro_torch.launch.pRUN`` starts worlds of
processes over each of them.

No ``torch`` import here or below: pRUN workers must start fast.
"""

from .collectives import Group, group_of, world_group
from .context import (
    CommContext,
    LocalComm,
    Np,
    Pid,
    RecvIntoRequest,
    Request,
    StragglerTimeout,
    ctx_counter,
    get_context,
    init,
    land_into,
    recv_timeout,
    run_epoch,
    set_context,
)
from .faultinject import FaultPlan, instrument_faults
from .filempi import FileMPI
from .hiercomm import HierComm
from .shmcomm import ShmComm
from .socketcomm import SocketComm
from .threadcomm import ThreadComm, run_spmd

__all__ = [
    "CommContext",
    "FileMPI",
    "HierComm",
    "LocalComm",
    "ShmComm",
    "SocketComm",
    "ThreadComm",
    "Group",
    "RecvIntoRequest",
    "Request",
    "StragglerTimeout",
    "FaultPlan",
    "instrument_faults",
    "land_into",
    "run_epoch",
    "ctx_counter",
    "group_of",
    "world_group",
    "run_spmd",
    "recv_timeout",
    "get_context",
    "set_context",
    "init",
    "Np",
    "Pid",
]
