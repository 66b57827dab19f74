"""The port's copies of pPython's process transports on the CPU:
``SocketComm``, ``ShmComm``, ``HierComm`` and their rendezvous.

* Every collective and a ``Dmat`` corner turn, on 4 thread-ranks of this
  process over each transport of ``repro_torch.comm.testing`` (``thread``,
  ``file``, ``socket``, ``shm``, ``hier`` on 2 virtual nodes), equal the
  reference's on its thread transport; over ``hier`` the world group
  takes the two-level (intra-node + leaders) path.
* The TCP rendezvous served by rank 0 or by the launcher's
  multi-generation server (a world of 2, then its relaunch at 3), and the
  file rendezvous, give every rank the same endpoint table.
* ``node_label`` equals the reference's.

Worlds of processes over these transports are in
``tests/test_torch_prun.py`` and ``tests/test_torch_pgas.py``.
"""

import socket
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

import repro.comm as ref_comm
import repro.core as ref_core
import repro_torch.comm as port_comm
import repro_torch.core as port_core
from _torch_prun import isolated, private_tmp, shm_parent  # noqa: F401
from repro.comm import testing as ref_testing
from repro.comm.hiercomm import node_label as ref_node_label
from repro_torch.comm import testing
from repro_torch.comm.hiercomm import node_label
from repro_torch.comm.rendezvous import (
    bind_listener,
    rendezvous_file,
    rendezvous_tcp,
    serve_generations,
)

PORT = SimpleNamespace(comm=port_comm, core=port_core)
REF = SimpleNamespace(comm=ref_comm, core=ref_core)


def _collectives(pkg):
    def body():
        ctx = pkg.comm.get_context()
        g = pkg.comm.world_group(ctx)
        me, n = ctx.pid, ctx.np_
        x = np.arange(12.0) * (me + 1)
        out = {
            "allreduce": g.allreduce(x, np.add).tolist(),
            "big_allreduce": g.allreduce(np.arange(50_000.0) * (me + 1), np.add)[::997].tolist(),
            "bcast": ctx.bcast(1, {"v": np.full(5, 7.0)} if me == 1 else None)["v"].tolist(),
            "allgather": [a.tolist() for a in ctx.allgather(x[:3])],
            "gather": ctx.gather(0, me * 10),
            "alltoallv": [a.tolist() for a in g.alltoallv(
                [np.full(2, me * 10.0 + d) for d in range(n)])],
            "reduce_scatter": g.reduce_scatter(np.arange(4.0 * n), np.add).tolist(),
            "two_level": g._hier_parts() is not None,
        }
        src = pkg.core.Dmap([n, 1], {}, range(n))
        dst = pkg.core.Dmap([1, n], "c", range(n))
        z = pkg.core.zeros(9, 10, map=dst)
        z[:, :] = pkg.core.arange_field(9, 10, map=src)
        full = pkg.core.agg(z, root=0)
        out["corner_turn"] = None if full is None else full.tolist()
        ctx.barrier()
        return out

    return body


@pytest.fixture(scope="module")
def reference_collectives():
    return ref_testing.run_transport_spmd(_collectives(REF), 4, "thread")


@pytest.mark.parametrize("transport", testing.TRANSPORTS)
def test_collectives_equal_the_references(transport, shm_parent, reference_collectives):
    got = testing.run_transport_spmd(_collectives(PORT), 4, transport, timeout=120)
    for pid, (g, w) in enumerate(zip(got, reference_collectives)):
        assert g.pop("two_level") == (transport == "hier"), pid
        w = dict(w)
        w.pop("two_level")
        assert g == w, f"rank {pid} on {transport}"
    assert list(shm_parent.iterdir()) == []  # the throwaway arena dirs are gone


def _threaded(np_, body):
    results, errors = [None] * np_, []

    def run(pid):
        try:
            results[pid] = body(pid)
        except BaseException as e:  # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(np_)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    if errors:
        raise errors[0]
    return results


def test_tcp_rendezvous_served_by_rank_0():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        addr = f"127.0.0.1:{s.getsockname()[1]}"
    tables = _threaded(3, lambda pid: rendezvous_tcp(3, pid, ("127.0.0.1", 9000 + pid), addr,
                                                     timeout=20, external_server=False,
                                                     epoch=0))
    assert tables == [[("127.0.0.1", 9000 + r) for r in range(3)]] * 3


def test_the_launchers_server_serves_a_relaunch_at_another_size():
    srv = bind_listener("127.0.0.1")
    addr = f"127.0.0.1:{srv.getsockname()[1]}"
    t = threading.Thread(target=serve_generations, args=(srv, 2, time.monotonic() + 30),
                         daemon=True)
    t.start()

    def world(epoch, np_):
        return _threaded(np_, lambda pid: rendezvous_tcp(
            np_, pid, ("127.0.0.1", 9350 + 10 * epoch + pid), addr, timeout=15,
            external_server=True, epoch=epoch))

    assert world(0, 2) == [[("127.0.0.1", 9350), ("127.0.0.1", 9351)]] * 2
    assert world(1, 3) == [[("127.0.0.1", 9360 + r) for r in range(3)]] * 3
    srv.close()
    t.join(10)
    assert not t.is_alive()


def test_file_rendezvous_fences_a_dead_generation(tmp_path):
    (tmp_path / "ep_0").write_bytes(b"left by a dead generation")
    tables = _threaded(2, lambda pid: rendezvous_file(2, pid, ("h", 9500 + pid), tmp_path,
                                                      timeout=10, epoch=1))
    assert tables == [[("h", 9500), ("h", 9501)]] * 2


@pytest.mark.parametrize("override", [None, "rack7-node3"])
def test_node_label_equals_the_references(override):
    assert node_label(override) == ref_node_label(override)
