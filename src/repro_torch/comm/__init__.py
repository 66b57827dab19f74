"""PythonMPI for the port: the part of pPython's messaging layer (paper
§III.D) that the checkpoint's ``Dmat`` paths run over.

Three transports behind the reference's interface, each a copy of
``repro.comm``'s module (NumPy only):

* ``FileMPI``    — the paper's transport: pickle payloads through a shared
                   directory (``PPYTHON_TRANSPORT=file``, the default;
                   ``PPYTHON_NP``, ``PPYTHON_PID``, ``PPYTHON_COMM_DIR``).
* ``ThreadComm`` — in-process ranks (``run_spmd``).
* ``LocalComm``  — the world of one.

``collectives.py`` adds the collective algorithms and ``Group``
sub-communicators, ``frame.py`` the pickle-5 frame FileMPI writes.

The reference's ``socket``, ``shm`` and ``hier`` transports are not in
the port: ``init()`` with ``PPYTHON_TRANSPORT`` set to one of them
raises ``ModuleNotFoundError`` on the missing module.
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
from .threadcomm import ThreadComm, run_spmd

__all__ = [
    "CommContext",
    "FileMPI",
    "LocalComm",
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
