"""Serving tensor parallelism: one process per card, driven by rank 0.

The reference's runner is one controller over a JAX mesh: XLA launches
every shard's program from one trace.  The port runs eagerly, and its
decode step is bound by the host's launches, so one Python thread
launching every shard's kernels would spend about tp times the host
time of a step.  Here every card has its own process (the Megatron and
vLLM layout), and each process launches only its own shard's kernels:

  * the caller's process is rank 0.  It keeps the engine's host half
    (scheduler, block manager, spill tier, supervisor, HTTP front end)
    and runs shard 0 on ``cuda:0``;
  * :class:`WorkerMesh` spawns ranks 1 … tp-1 (``spawn``, never
    ``fork``: the caller may hold JAX, CUDA or threads), on ``cuda:1 …
    tp-1`` over NCCL, or on the CPU over gloo for ``device="cpu"``.  All
    join one process group through ``distributed.init_parallel_env``.
    A spawned worker imports only the port (:func:`_worker_main`);
  * :class:`MeshRunner`, rank 0's :class:`~.runner.ModelRunner`, sends
    every device-facing call to the workers as ONE control message (the
    method's name and its host arguments, over a pipe per worker), then
    runs its own shard.  Each worker runs the same call on its shard, so
    every rank enters the layers' all-reduces in one order.  Nothing in
    a layer or a kernel waits on the host;
  * logits, the next tokens and the ring come out the same on every
    rank; rank 0 reads its own.  ``read_page`` and ``mesh_info`` wait for
    the workers' replies (their heads of a page, their footprints).

Failures.  A worker that raises sends its traceback; rank 0 raises it,
naming the rank, at its next call or wait.  A worker that dies fails
rank 0's next call (its pipe and its process are checked before every
message).  Every wait has a deadline: the process group's collectives
time out after :data:`TIMEOUT_S`, and rank 0's waits for replies or for
its card (at each host read of a step's result) give up after the same
time, checking the workers all along.  A call that raises on rank 0's
own shard after its message went out fails the mesh too: the workers
may have entered collectives that rank 0 never will, so the group is
out of step.  A failed mesh stays failed: every later call raises at
once, and the next :func:`get_mesh` (a supervisor's runner rebuild
among them) starts new workers.

Host timers.  Every rank counts the calls it runs and their host
seconds; :meth:`WorkerMesh.host_stats` returns each rank's, with its
process's CPU seconds, so that a caller can see where each rank's host
time goes.

Lifetime.  A supervisor's runner rebuild builds a new runner on the same
workers (each rebuilds its shard from rank 0's scatter, without a new
spawn).  One mesh serves every engine of its (tp, device type) in a
process — the tests pay the spawn once per file — and :func:`get_mesh`
replaces it when another shape is asked for.  ``Engine.close()``,
:func:`shutdown_meshes` and the process's exit stop the workers; a
worker whose parent is gone exits within a second.
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import socket
import threading
import time
import traceback
import weakref

import numpy as np
import torch

from .mesh import mesh_devices
from .runner import ModelRunner, state_spec

__all__ = ["MeshRunner", "WorkerError", "WorkerMesh", "get_mesh",
           "shutdown_meshes"]

TIMEOUT_S = 120            # collectives, rendezvous, replies, card waits
_POLL_S = 1.0              # a worker's wait between parent checks

# the device-facing calls a mesh runs on every rank
CALLS = ("decode_step", "verify_step", "prefill", "prefill_cached",
         "copy_page", "read_page", "write_page", "push_slot",
         "correct_tokens", "reinject_step", "load_adapter", "release")


class WorkerError(RuntimeError):
    """A worker rank failed: it raised (its traceback is in the message),
    died, or gave no reply in time."""

    def __init__(self, rank, what):
        super().__init__(f"serving mesh rank {rank}: {what}")
        self.rank = rank


# ------------------------------------------------------------ the wire
# Tensors cross the pipes as numpy bits: torch's own pickling of a CPU
# tensor would move its storage into shared memory.
class _Bits:
    __slots__ = ("dtype", "array")

    def __init__(self, t):
        t = t.detach().cpu().contiguous()
        self.dtype = str(t.dtype).rpartition(".")[2]
        self.array = (t.view(torch.int16) if t.dtype == torch.bfloat16
                      else t).numpy()

    def tensor(self):
        t = torch.from_numpy(np.array(self.array))
        return t.view(torch.bfloat16) if self.dtype == "bfloat16" else t


def _pack(obj):
    if torch.is_tensor(obj):
        return _Bits(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    return obj


def _unpack(obj):
    if isinstance(obj, _Bits):
        return obj.tensor()
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(x) for x in obj)
    if isinstance(obj, dict):
        return {k: _unpack(v) for k, v in obj.items()}
    return obj


def _leave_group(dev_type):
    """Leave the default process group without waiting on any peer: an
    NCCL group is aborted (its destroy may wait for ranks that are gone
    or never call it), a gloo one destroyed.  Either way a later mesh
    can join a new one."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return
    abort = getattr(dist.distributed_c10d, "_abort_process_group", None)
    if dev_type == "cuda" and abort is not None:
        abort()
    else:
        dist.destroy_process_group()


def _died(rank, proc):
    return WorkerError(rank, f"died (exit code {proc.exitcode})")


def _host_stats(timers):
    """This process's host counters: its CPU seconds, the wall clock, and
    per call name [calls, host seconds]."""
    return {"pid": os.getpid(), "cpu_s": time.process_time(),
            "wall_s": time.perf_counter(),
            "calls": {k: list(v) for k, v in timers.items()}}


def _timed(timers, name, fn, *args, **kwargs):
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    n_s = timers.setdefault(name, [0, 0.0])
    n_s[0] += 1
    n_s[1] += time.perf_counter() - t0
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------ a worker
def _worker_main(rank, tp, dev_type, port, conn, parent_pid, threads):
    """Rank ``rank``'s loop: join the group, then run each message's call
    on the runner it names; reply where asked, send a traceback where a
    call raises.  Imports only the port.  A CPU rank takes rank 0's
    thread count, so that the replicated parts of a step (the lm_head
    and its argmax among them) round alike on every rank."""
    if dev_type == "cpu":
        torch.set_num_threads(threads)
    try:
        from ...distributed import init_parallel_env
        group = init_parallel_env(dev_type, rank=rank, world_size=tp,
                                  init_method=f"tcp://127.0.0.1:{port}",
                                  timeout_s=TIMEOUT_S)
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dev_type == "cuda" else torch.device("cpu"))
    except BaseException:                       # noqa: BLE001 - reported
        conn.send(("error", None, traceback.format_exc()))
        return
    runners, timers = {}, {}
    while True:
        if not conn.poll(_POLL_S):
            if os.getppid() != parent_pid:
                return                          # rank 0 is gone
            continue
        try:
            seq, rid, name, args, kwargs, reply = conn.recv()
        except (EOFError, OSError):
            return
        if name == "__stop__":
            runners.clear()
            _leave_group(dev_type)
            return
        try:
            args, kwargs = _unpack(args), _unpack(kwargs)
            if name == "__init__":
                config, spec, kw = args
                runners[rid] = ModelRunner(config, spec, device=device,
                                           tp=tp, rank=rank, group=group,
                                           **kw)
                out = None
            elif name == "__drop__":
                runners.pop(rid, None)
                out = None
            elif name == "__host__":
                out = _host_stats(timers)
            else:
                out = _timed(timers, name, getattr(runners[rid], name),
                             *args, **kwargs)
            if reply:
                conn.send(("ok", seq, _pack(out)))
        except BaseException:                   # noqa: BLE001 - reported
            conn.send(("error", seq, traceback.format_exc()))


# ------------------------------------------------------------ the mesh
class WorkerMesh:
    """Ranks 1 … tp-1 in their own processes, and this process as rank 0,
    in one process group (see the module docstring)."""

    def __init__(self, tp: int, device=None):
        self.tp = int(tp)
        self.dev_type = mesh_devices(tp, device)[0].type
        self.lock = threading.RLock()
        self.failed = None          # the first failure, once there is one
        self.sends = 0              # control messages sent (one per call)
        self.send_s = 0.0           # host seconds spent sending them
        self.timers = {}            # rank 0's shard calls: [calls, s]
        self._seq = 0
        self._next_rid = 1
        self._drops = []            # runners to drop on the workers
        ctx = multiprocessing.get_context("spawn")
        port = _free_port()
        self._conns, self._procs = [], []
        for r in range(1, self.tp):
            here, there = ctx.Pipe()
            p = ctx.Process(target=_worker_main, name=f"serving-tp-rank{r}",
                            args=(r, self.tp, self.dev_type, port, there,
                                  os.getpid(), torch.get_num_threads()),
                            daemon=True)
            p.start()
            there.close()
            self._conns.append(here)
            self._procs.append(p)
        try:
            from ...distributed import init_parallel_env
            self.group = init_parallel_env(
                self.dev_type, rank=0, world_size=self.tp,
                init_method=f"tcp://127.0.0.1:{port}", timeout_s=TIMEOUT_S)
        except BaseException as e:
            why = self._worker_failure(wait_s=5.0)
            self.close()
            if why is not None:
                raise why from e
            raise

    @property
    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]

    # ---------------------------------------------------------- checks
    def _worker_failure(self, wait_s=0.0):
        """A :class:`WorkerError` for the first worker that sent a
        traceback or is not alive (waiting up to ``wait_s`` for a
        traceback to arrive), else None."""
        deadline = time.monotonic() + wait_s
        while True:
            for r, (conn, p) in enumerate(zip(self._conns, self._procs), 1):
                try:
                    if conn.poll():
                        kind, _seq, payload = conn.recv()
                        if kind == "error":
                            return WorkerError(r, f"raised:\n{payload}")
                except (EOFError, OSError):
                    return _died(r, p)
                if not p.is_alive():
                    return _died(r, p)
            if time.monotonic() >= deadline:
                return None
            time.sleep(0.01)

    def _fail(self, err):
        if self.failed is None:
            self.failed = err
        raise err

    def check(self):
        """Raise if the mesh failed, or a worker raised or died."""
        if self.failed is not None:
            raise WorkerError(self.failed.rank, "the serving mesh failed "
                              f"earlier: {self.failed}")
        err = self._worker_failure()
        if err is not None:
            self._fail(err)

    # --------------------------------------------------------- messages
    def send(self, rid, name, args=(), kwargs=None, reply=False):
        """Check the workers, then send one call to every worker (after
        any pending drops); returns the call's sequence number.  The
        host time of the whole, checks included, counts in ``send_s``."""
        t0 = time.perf_counter()
        self.check()
        while self._drops:
            self._post(self._drops.pop(), "__drop__", (), {}, False)
        seq = self._post(rid, name, args, kwargs or {}, reply)
        self.sends += 1
        self.send_s += time.perf_counter() - t0
        return seq

    def _post(self, rid, name, args, kwargs, reply):
        self._seq += 1
        msg = (self._seq, rid, name, _pack(args), _pack(kwargs), reply)
        for r, conn in enumerate(self._conns, 1):
            try:
                conn.send(msg)
            except (BrokenPipeError, EOFError, OSError):
                self._fail(self._worker_failure()
                           or WorkerError(r, "its pipe is closed"))
        return self._seq

    def replies(self, seq):
        """Every worker's reply to call ``seq``, in rank order (1 …
        tp-1), within :data:`TIMEOUT_S`."""
        out = []
        deadline = time.monotonic() + TIMEOUT_S
        for r, (conn, p) in enumerate(zip(self._conns, self._procs), 1):
            while True:
                if conn.poll(0.05):
                    try:
                        kind, got, payload = conn.recv()
                    except (EOFError, OSError):
                        self._fail(_died(r, p))
                    if kind == "error":
                        self._fail(WorkerError(r, f"raised:\n{payload}"))
                    if got == seq:
                        out.append(_unpack(payload))
                        break
                    continue
                if not p.is_alive():
                    self._fail(_died(r, p))
                if time.monotonic() > deadline:
                    self._fail(WorkerError(r, f"no reply within "
                                              f"{TIMEOUT_S} s"))
        return out

    def wait_card(self):
        """Wait for rank 0's card to finish the work queued so far,
        checking the workers while it runs: a collective whose peer died
        or raised never ends, so this raises (naming the rank) instead
        of blocking, and gives up after :data:`TIMEOUT_S`."""
        if self.dev_type != "cuda":
            self.check()
            return
        ev = torch.cuda.Event()
        ev.record()
        deadline = time.monotonic() + TIMEOUT_S
        while not ev.query():
            err = self._worker_failure()
            if err is not None:
                self._fail(err)
            if time.monotonic() > deadline:
                self._fail(WorkerError(0, f"the card did not finish within "
                                          f"{TIMEOUT_S} s"))
            time.sleep(0.0002)
        self.check()

    def host_stats(self) -> list[dict]:
        """Every rank's host counters (see :func:`_host_stats`), in rank
        order; the request itself is not a runner call and counts as no
        control message."""
        with self.lock:
            self.check()
            seq = self._post(0, "__host__", (), {}, True)
            return [_host_stats(self.timers)] + self.replies(seq)

    def new_runner(self, config, spec, kw) -> int:
        """Build a runner on every worker (its shard arrives by the
        scatter that rank 0's runner starts next); returns its id."""
        rid = self._next_rid
        self._next_rid += 1
        self.send(rid, "__init__", (config, spec, kw))
        return rid

    def drop(self, rid):
        """Forget runner ``rid`` on the workers with the next message."""
        self._drops.append(rid)

    # --------------------------------------------------------- lifetime
    def close(self):
        """Stop every worker (each leaves the group first), then leave the
        process group here.  A failed mesh's workers may wait inside a
        collective that will never end: they get a second, then are
        killed."""
        global _live
        for conn in self._conns:
            try:
                conn.send((0, 0, "__stop__", (), {}, False))
            except (BrokenPipeError, EOFError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=1 if self.failed is not None else 5)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []
        if _live is self:
            _live = None
        _leave_group(self.dev_type)


_live: WorkerMesh | None = None
_live_lock = threading.Lock()


def get_mesh(tp: int, device=None) -> WorkerMesh:
    """The live mesh of ``tp`` ranks on ``device``'s type, started (or
    restarted, when another shape or a failed mesh holds the process
    group) as needed.  Callers in several threads get one mesh."""
    global _live
    dev_type = torch.device("cuda" if device is None else device).type
    with _live_lock:
        if _live is not None and (_live.tp != tp
                                  or _live.dev_type != dev_type
                                  or _live.failed is not None):
            _live.close()
        if _live is None:
            _live = WorkerMesh(tp, device)
        return _live


def shutdown_meshes():
    """Stop the live mesh's workers (also run at the process's exit)."""
    if _live is not None:
        _live.close()


atexit.register(shutdown_meshes)


# ------------------------------------------------------ rank 0's runner
class MeshRunner(ModelRunner):
    """Rank 0's runner of a tp > 1 mesh: each device-facing call goes to
    the workers as one message, then runs on shard 0 (see the module
    docstring).  The engine talks to it as to a single-device runner."""

    def __init__(self, config, state: dict, *, mesh: WorkerMesh, **kw):
        from ...models.convert import check_serving_shardable
        # refuse on rank 0 before any worker enters a collective
        self._validate_quantized_state(state)
        check_serving_shardable(state, mesh.tp)
        self._mesh = mesh
        wire_kw = {k: v for k, v in kw.items() if k != "device"}
        with mesh.lock:
            self._rid = mesh.new_runner(config, state_spec(state), wire_kw)
            super().__init__(config, state, tp=mesh.tp, rank=0,
                             group=mesh.group, **kw)
        weakref.finalize(self, mesh.drop, self._rid)
        from ...observability.resources import resource_tracker
        resource_tracker().set_mesh({f"{self.device.type}:{r}": {"tp": r}
                                     for r in range(mesh.tp)})

    def _call(self, name, *args, **kwargs):
        mesh = self._mesh
        with mesh.lock:
            mesh.send(self._rid, name, args, kwargs)
            try:
                return _timed(mesh.timers, name, getattr(super(), name),
                              *args, **kwargs)
            except Exception as e:
                # the workers run the call to its end, and may wait in a
                # collective that this rank left: the group is out of
                # step whatever the cause, so the mesh has failed
                err = mesh._worker_failure(wait_s=1.0)
                mesh.failed = mesh.failed or err or WorkerError(
                    0, f"raised in {name}: {e!r}")
                if err is not None:
                    raise err from e
                raise

    def decode_step(self):
        logits = self._call("decode_step")
        if logits is not None:
            self._mesh.wait_card()
        return logits

    def verify_step(self, draft, dlen):
        return self._call("verify_step", draft, dlen)

    def prefill(self, ids, plen, row, adapter_row=0):
        logits = self._call("prefill", ids, plen, row, adapter_row)
        self._mesh.wait_card()
        return logits

    def prefill_cached(self, ids, suffix_len, cached_len, row,
                       adapter_row=0):
        logits = self._call("prefill_cached", ids, suffix_len, cached_len,
                            row, adapter_row)
        self._mesh.wait_card()
        return logits

    def copy_page(self, src, dst):
        return self._call("copy_page", src, dst)

    def read_page(self, page):
        """The full-head page: every rank's heads, gathered in rank
        order."""
        with self._mesh.lock:
            seq = self._mesh.send(self._rid, "read_page", (page,),
                                  reply=True)
            mine = super().read_page(page)
            theirs = self._mesh.replies(seq)
        return tuple(torch.cat([m] + [t[i] for t in theirs], dim=1)
                     for i, m in enumerate(mine))

    def write_page(self, page, k, v, kscale=None, vscale=None):
        self._check_page_scales(kscale, vscale)
        return self._call("write_page", page, k, v, kscale, vscale)

    def push_slot(self, slot, row, pos, tok, active, adapter_row=0):
        return self._call("push_slot", slot, row, pos, tok, active,
                          adapter_row)

    def correct_tokens(self, corrections):
        return self._call("correct_tokens", corrections)

    def reinject_step(self):
        return self._call("reinject_step")

    def load_adapter(self, row, a, b, scale):
        self._check_bank_row(row)
        return self._call("load_adapter", row, a, b, scale)

    def release(self):
        """Free every rank's pools; on a failed mesh only this rank's
        (its workers stop with the mesh)."""
        if self._mesh.failed is not None:
            return super().release()
        return self._call("release")

    def fetch_ring(self):
        self._mesh.wait_card()
        return super().fetch_ring()

    def mesh_info(self) -> dict:
        """Every rank's device, mesh position and footprints."""
        with self._mesh.lock:
            seq = self._mesh.send(self._rid, "mesh_entry", reply=True)
            entries = [self.mesh_entry()] + self._mesh.replies(seq)
        return {"tp": self.tp, "axis": "tp", "kv_quant": self.kv_quant,
                "devices": entries}

    def rank_states(self) -> list[dict]:
        """Every rank's ring, pos and tok, in rank order."""
        with self._mesh.lock:
            seq = self._mesh.send(self._rid, "rank_state", reply=True)
            mine = self.rank_state()
            return [mine] + self._mesh.replies(seq)
