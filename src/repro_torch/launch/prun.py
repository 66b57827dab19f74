"""pRUN — pPython's SPMD launcher (paper §III.A).

``pRUN(target, np_)`` starts ``np_`` Python instances of the same program
(single program, multiple data), wiring each to the selected PythonMPI
transport through environment variables::

    PPYTHON_NP         world size
    PPYTHON_PID        this instance's rank
    PPYTHON_TRANSPORT  file | socket | shm | hier | thread
    PPYTHON_COMM_DIR   shared directory (file transport; scratch for
                       result files otherwise)
    PPYTHON_RDZV_ADDR  rank-0 TCP rendezvous (socket/hier transports)
    PPYTHON_SHM_DIR    arena directory (shm/hier transports; pRUN puts
                       it under /dev/shm when the node has it)
    PPYTHON_SHM_NONCE  per-launch nonce stamped into every arena header
                       (shm/hier; makes stale-directory reuse inert)
    PPYTHON_NODE_ID    virtual-node fingerprint override (hier transport;
                       ``pRUN(..., nodes=N)`` assigns contiguous blocks)

``target`` is either a script path (launched as ``python script.py``) or a
``"module:function"`` string (launched through ``prun_worker``).  Rank
results come back through rank-local result files in the launch scratch
directory, mirroring how gridMatlab collected leader output.

Transports: ``file`` (default) is the paper's shared-directory messaging;
``socket`` launches the same subprocesses but messages flow over a TCP
peer mesh bootstrapped through a loopback rendezvous server — no comm
directory on any message path; ``shm`` moves messages through mmap'd
ring arenas in a launcher-owned directory under ``/dev/shm`` — the
memory-speed single-node path — and the launcher removes that directory
**unconditionally** (crash included: shared-memory files are RAM, a
leak outlives the workers); ``hier`` composes both — the socket
rendezvous exchanges endpoints *and* node fingerprints, same-node peers
then talk through shm arenas and cross-node peers over TCP
(``nodes=N`` partitions a single machine into N virtual nodes for
tests/benchmarks), and the arena directory keeps the unconditional
shm cleanup even when only the TCP half of the bootstrap fails;
``thread`` hosts every rank on a thread of *this* process
(module:function targets only) — the fastest way to run an SPMD body
with zero launch overhead.

Fault handling beyond the paper: the supervisor notices dead processes
(nonzero exit) and, while ``restarts > 0`` budget remains, **gang
restarts the whole world** under a bumped epoch (``PPYTHON_EPOCH``) —
every transport fences messages, rendezvous registrations, socket
HELLOs, and arena headers by that generation counter, so no ghost of a
dead generation can ever talk to the relaunched one.  Relaunched ranks
are expected to resume from the latest checkpoint (see
``repro_torch.train.checkpoint.elastic_resume_step``); with deterministic
replay the faulted run finishes bitwise-equal to an unfaulted one.
``PPYTHON_FAULT`` (see ``repro_torch.comm.faultinject``) arms deterministic
kill/delay/drop faults in the workers for chaos testing.  An
auto-created scratch directory is removed on clean exit but **kept on
failure** (with a notice) so message files and results can be inspected
post-mortem — the paper's debugging affordance, extended to crashes.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from pathlib import Path
from typing import Any, Sequence

__all__ = ["pRUN", "prun_worker"]


def _worker_cmd(target: str, extra_args: Sequence[str]) -> list[str]:
    if ":" in target and not os.path.exists(target):
        return [
            sys.executable,
            "-m",
            "repro_torch.launch.prun",
            target,
            *extra_args,
        ]
    return [sys.executable, target, *extra_args]


def _serve_rendezvous(np_: int, timeout: float):
    """Bind a loopback rendezvous listener and serve endpoint exchanges
    on a daemon thread.  Binding port 0 and serving the *live* socket
    (instead of probe-port-then-close-then-rebind) means the advertised
    port can never be stolen between probe and bind, and two concurrent
    pRUN launches can never cross-register into each other's server.

    The server is the multi-generation variant: one listener serves the
    epoch-0 exchange and every gang-restart generation after it, so a
    relaunched world re-registers fresh endpoints with no port churn.
    Returns ``(addr, server_socket, errors)``; close the socket to stop.
    A serving failure (e.g. a rank that never registered) is appended to
    ``errors`` for the supervising loop to raise *promptly* — a silent
    bootstrap death must not surface minutes later as a generic worker
    timeout."""
    from ..comm.rendezvous import bind_listener, serve_generations

    srv = bind_listener("127.0.0.1")
    addr = f"127.0.0.1:{srv.getsockname()[1]}"
    deadline = time.monotonic() + timeout
    errors: list[BaseException] = []

    def serve() -> None:
        try:
            serve_generations(srv, np_, deadline)
        except Exception as e:  # noqa: BLE001 - surfaced by the supervisor
            errors.append(e)

    threading.Thread(target=serve, name="ppython-rdzv", daemon=True).start()
    return addr, srv, errors


def _run_threaded(target: str, np_: int, args: Sequence[str],
                  timeout: float, env: dict | None) -> list[Any]:
    """transport="thread": host every rank on a thread of this process."""
    if ":" not in target or os.path.exists(target):
        raise ValueError(
            "pRUN(transport='thread') needs a module:function target "
            f"(scripts own the process; got {target!r})"
        )
    if env:
        raise ValueError(
            "pRUN(transport='thread') cannot give ranks a private env= — "
            "they share this process; set os.environ or use a process "
            "transport"
        )
    from ..comm import run_spmd

    mod_name, fn_name = target.split(":", 1)
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return run_spmd(fn, np_, args=tuple(args), timeout=timeout)


def pRUN(
    target: str,
    np_: int,
    *,
    args: Sequence[str] = (),
    transport: str | None = None,
    comm_dir: str | os.PathLike | None = None,
    timeout: float = 600.0,
    restarts: int = 0,
    elastic_np: int | None = None,
    env: dict[str, str] | None = None,
    collect_results: bool = True,
    nodes: int | None = None,
    trace: bool | None = None,
) -> list[Any]:
    """Launch ``np_`` SPMD instances of ``target``; return per-rank results.

    ``transport`` is ``file``/``socket``/``shm``/``hier``/``thread``
    (default: the ``PPYTHON_TRANSPORT`` environment, else ``file``).
    ``nodes`` (hier only) partitions the ranks into that many contiguous
    virtual nodes via per-rank ``PPYTHON_NODE_ID`` — omitted, ranks
    fingerprint by hostname, so a single-machine hier run is one node.
    Results are only collected for ``module:function`` targets (scripts
    run for side effects, matching the paper's usage).

    ``trace`` forces per-rank tracing on (``True``) or off (``False``)
    in the workers regardless of the launcher's ``PPYTHON_TRACE``;
    ``None`` inherits the environment.  Traced process workers merge
    their buffers at shutdown into one Chrome-trace JSON under
    ``PPYTHON_TRACE_DIR`` (see ``repro_torch.obs``).

    ``elastic_np`` (needs ``restarts > 0``) relaunches the gang at a
    *different* world size after a fault: the restarted generation runs
    ``elastic_np`` ranks under the bumped epoch, its rendezvous
    registrations carry the new world size, and the workers are expected
    to resume from checkpoints through
    ``repro_torch.train.checkpoint.restore_resharded`` — on-disk shards saved
    by the old grid are redistributed onto the new one (scale-up or
    -down) via the FALLS intersection algebra.  Results are collected
    from the final generation's world.
    """
    transport = (transport or os.environ.get("PPYTHON_TRANSPORT")
                 or "file").lower()
    if transport not in ("file", "socket", "shm", "hier", "thread"):
        raise ValueError(
            f"unknown transport {transport!r} "
            "(expected file|socket|shm|hier|thread)"
        )
    if nodes is not None and transport != "hier":
        raise ValueError(
            f"nodes= partitions virtual nodes for transport='hier' only "
            f"(got transport={transport!r})"
        )
    if elastic_np is not None:
        if restarts <= 0:
            raise ValueError(
                "elastic_np= changes the world size on gang restart and "
                "needs restarts > 0"
            )
        if elastic_np < 1:
            raise ValueError(f"elastic_np must be >= 1, got {elastic_np}")
        if transport == "thread":
            raise ValueError(
                "elastic_np= needs a process transport (thread worlds "
                "have no gang restart)"
            )
    if transport == "thread":
        return _run_threaded(target, np_, args, timeout, env)

    own_dir = comm_dir is None
    comm_dir = Path(
        tempfile.mkdtemp(prefix="ppython_") if own_dir else comm_dir
    )
    comm_dir.mkdir(parents=True, exist_ok=True)
    is_func = ":" in target and not os.path.exists(target)

    base_env = dict(os.environ)
    base_env.update(env or {})
    base_env["PPYTHON_NP"] = str(np_)
    base_env["PPYTHON_TRANSPORT"] = transport
    # the world generation: 0 at launch, bumped on every gang restart.
    # Never inherited from os.environ (a worker launching a nested pRUN
    # would leak its own epoch into the fresh world); only an explicit
    # env= pin survives.
    if not (env and "PPYTHON_EPOCH" in env):
        base_env["PPYTHON_EPOCH"] = "0"
    if trace is not None:
        base_env["PPYTHON_TRACE"] = "1" if trace else "0"
        if trace:
            base_env.setdefault("PPYTHON_TRACE_DIR", os.getcwd())
    # the directory doubles as the result mailbox in every mode; only the
    # file transport also sends messages through it
    base_env["PPYTHON_COMM_DIR"] = str(comm_dir)
    rdzv_srv = None
    rdzv_errors: list[BaseException] = []
    shm_dir: Path | None = None
    if transport == "hier":
        # a rank's node id must come from THIS launch (nodes= below) or
        # the hostname fingerprint — an os.environ-inherited id (e.g. a
        # hier worker launching a nested pRUN) would collapse the nested
        # world onto one rank's virtual node
        if not (env and "PPYTHON_NODE_ID" in env):
            base_env.pop("PPYTHON_NODE_ID", None)
    if transport in ("shm", "hier"):
        # arenas live in a launcher-owned directory under /dev/shm when
        # the node has it (pages never see a writeback path); a fresh
        # per-launch nonce is stamped into every arena header so workers
        # can never attach to arenas a dead run left in a reused dir.
        # Only the *explicit* env= argument can pin the dir/nonce —
        # values inherited through os.environ (a shm worker launching a
        # nested pRUN, a stale export) would collide two live runs on
        # the same arenas with matching nonces.
        explicit = env or {}
        if "PPYTHON_SHM_DIR" in explicit:
            shm_dir = None  # caller owns the directory and its lifetime
        else:
            shm_base = "/dev/shm" if os.path.isdir("/dev/shm") else None
            shm_dir = Path(tempfile.mkdtemp(prefix="ppython_shm_",
                                            dir=shm_base))
            base_env["PPYTHON_SHM_DIR"] = str(shm_dir)
        if "PPYTHON_SHM_NONCE" not in explicit:
            base_env["PPYTHON_SHM_NONCE"] = uuid.uuid4().hex
    if (transport in ("socket", "hier")
            and "PPYTHON_RDZV_ADDR" not in base_env):
        # single-node launch: the launcher itself serves the rendezvous
        # over loopback, so the comm dir never appears on a message path
        # (multi-node jobs point PPYTHON_RDZV_ADDR at a reachable host
        # instead — see slurm.py, where rank 0 serves).  For hier this
        # runs AFTER the shm block, so the finally's unconditional
        # arena-dir rmtree covers a rendezvous/bootstrap failure too —
        # the TCP half failing can never leak /dev/shm arenas.
        addr, rdzv_srv, rdzv_errors = _serve_rendezvous(np_, timeout)
        base_env["PPYTHON_RDZV_ADDR"] = addr
        base_env["PPYTHON_RDZV_EXTERNAL"] = "1"
        base_env.setdefault("PPYTHON_HOST", "127.0.0.1")
    elif transport in ("socket", "hier"):
        # caller brought their own rendezvous address: rank 0 serves it,
        # so a stale EXTERNAL flag (e.g. inherited from an enclosing
        # launcher) must not leave the job serverless
        base_env.pop("PPYTHON_RDZV_EXTERNAL", None)
    # keep each instance single-threaded (paper §III.F.4: multithreaded BLAS
    # oversubscribes the node when several ranks share it)
    base_env.setdefault("OMP_NUM_THREADS", "1")
    base_env.setdefault("OPENBLAS_NUM_THREADS", "1")
    base_env.setdefault("MKL_NUM_THREADS", "1")

    cmd = _worker_cmd(target, list(args))
    procs: dict[int, subprocess.Popen] = {}
    restarts_left = restarts
    epoch = int(base_env.get("PPYTHON_EPOCH", "0") or 0)
    explicit_env = env or {}

    def launch(pid: int) -> None:
        e = dict(base_env)
        e["PPYTHON_PID"] = str(pid)
        if transport == "hier" and nodes is not None:
            # contiguous virtual-node blocks, matching
            # repro_torch.comm.testing.virtual_node_ids
            e["PPYTHON_NODE_ID"] = str(pid * max(1, min(nodes, np_)) // np_)
        procs[pid] = subprocess.Popen(cmd, env=e)

    def gang_restart(dead_pid: int, rc: int) -> None:
        """Relaunch the WHOLE world under a bumped epoch.

        A single-rank restart cannot work on the fast fabrics: survivors
        hold collective state (context-minted tags, half-run algorithms)
        the fresh rank never saw, so the restarted rank would deadlock
        against mid-collective peers.  Killing everyone and replaying
        from the latest checkpoint is deterministic — and the epoch
        fence (rendezvous registrations, socket HELLOs, arena headers,
        file-message names) guarantees no ghost of the dead generation
        can ever talk to the new one.

        With ``elastic_np`` the relaunched generation runs at that world
        size instead of the faulted one's: the new ranks register their
        world size with the multi-generation rendezvous, and resume is
        expected to reshard checkpoints onto the new grid
        (``restore_resharded``)."""
        nonlocal epoch, np_
        epoch += 1
        new_np = np_ if elastic_np is None else elastic_np
        print(
            f"pRUN: rank {dead_pid} exited with code {rc}; gang-restarting "
            f"as epoch {epoch} with {new_np} rank(s) "
            f"({restarts_left} restart(s) left)",
            file=sys.stderr,
        )
        for q in procs.values():
            if q.poll() is None:
                q.kill()
        for q in procs.values():
            q.wait()
        procs.clear()
        np_ = new_np
        base_env["PPYTHON_NP"] = str(np_)
        base_env["PPYTHON_EPOCH"] = str(epoch)
        if (transport in ("shm", "hier")
                and "PPYTHON_SHM_NONCE" not in explicit_env):
            # a fresh nonce per generation: the relaunched world can
            # never attach to the dead generation's arenas, even before
            # their owners recreate them
            base_env["PPYTHON_SHM_NONCE"] = uuid.uuid4().hex
        from ..obs import metrics as _metrics

        _metrics.counter("elastic.restarts").inc()
        for pid in range(np_):
            launch(pid)

    deadline = time.monotonic() + timeout
    failed = True
    try:
        # spawning happens inside the try: a mid-loop Popen failure (e.g.
        # EAGAIN on a loaded box) must still reach the finally, which
        # kills the ranks already launched and reclaims the arena dir
        for pid in range(np_):
            launch(pid)

        while True:
            if rdzv_errors:
                for q in procs.values():
                    if q.poll() is None:
                        q.kill()
                raise RuntimeError(
                    f"pRUN rendezvous bootstrap failed: {rdzv_errors[0]}"
                ) from rdzv_errors[0]
            alive = False
            for pid, p in list(procs.items()):
                rc = p.poll()
                if rc is None:
                    alive = True
                elif rc != 0:
                    if restarts_left > 0:
                        restarts_left -= 1
                        gang_restart(pid, rc)
                        alive = True
                        break  # procs was rebuilt: restart the scan
                    for q in procs.values():
                        if q.poll() is None:
                            q.kill()
                    raise RuntimeError(
                        f"pRUN rank {pid} exited with code {rc} "
                        f"(no restart budget left)"
                    )
            if not alive:
                break
            if time.monotonic() > deadline:
                for q in procs.values():
                    if q.poll() is None:
                        q.kill()
                raise TimeoutError(f"pRUN: ranks still running after {timeout}s")
            time.sleep(0.02)

        if is_func and collect_results:
            results = []
            for pid in range(np_):
                rf = comm_dir / f"result_{pid}.pkl"
                if rf.exists():
                    with open(rf, "rb") as f:
                        results.append(pickle.load(f))
                else:
                    results.append(None)
            # only now is the run a success: an unreadable result file
            # (truncated pickle, missing class) keeps the scratch dir
            failed = False
            return results
        failed = False
        return []
    finally:
        if failed:
            # any exit before success — spawn failure, timeout, a rank's
            # nonzero rc, result-collection error — must not orphan live
            # workers (shm ranks would yield-spin until their recv
            # timeout); kill is idempotent for already-dead ranks
            for q in procs.values():
                if q.poll() is None:
                    q.kill()
        if rdzv_srv is not None:
            try:
                rdzv_srv.close()  # stops the launcher's rendezvous thread
            except OSError:
                pass
        if shm_dir is not None:
            # ALWAYS reclaimed, crash or not: arena files are shared
            # memory, and unlike the comm-dir scratch there is nothing a
            # post-mortem can read out of a half-consumed byte ring
            import shutil

            shutil.rmtree(shm_dir, ignore_errors=True)
        if own_dir:
            if failed:
                # keep messages/results on disk for post-mortem — the
                # paper's "inspect the unclaimed .buf file" affordance
                print(
                    f"pRUN: keeping scratch dir {comm_dir} for post-mortem "
                    f"(launch failed)",
                    file=sys.stderr,
                )
            else:
                import shutil

                shutil.rmtree(comm_dir, ignore_errors=True)


def prun_worker(target: str, argv: Sequence[str]) -> None:
    """Entry point inside each SPMD instance for ``module:function`` targets."""
    from ..comm import init

    mod_name, fn_name = target.split(":", 1)
    ctx = init()
    try:
        from ..comm.context import run_epoch
        from ..obs import trace as _trace

        if run_epoch() > 0 and _trace.enabled:
            # mark the resume in the timeline: a merged trace of an
            # elastic run shows where the relaunched generation began
            _trace.instant("elastic.resume", epoch=run_epoch(),
                           rank=ctx.pid)
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, fn_name)
        result = fn(*argv) if argv else fn()
        out_dir = os.environ.get("PPYTHON_COMM_DIR")
        if out_dir:  # multi-node socket jobs may run without any scratch dir
            out = Path(out_dir) / f"result_{ctx.pid}.pkl"
            tmp = out.with_suffix(".tmp")
            with open(tmp, "wb") as f:
                pickle.dump(result, f, protocol=5)
            os.rename(tmp, out)
        from ..obs import trace as _trace

        if _trace.enabled:
            # collective (all ranks reach here only if every body
            # succeeded — a failed rank skips it and the launcher kills
            # the stragglers): align clocks, gather buffers, rank 0
            # writes the merged Chrome trace
            merged = _trace.merge_traces(ctx)
            if merged is not None:
                print(f"pRUN: merged trace -> {merged}", file=sys.stderr)
    finally:
        ctx.finalize()


if __name__ == "__main__":
    prun_worker(sys.argv[1], sys.argv[2:])
