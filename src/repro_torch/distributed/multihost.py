"""Multi-process DCF-PCA over ``torch.distributed`` (counterpart of
``repro.distributed.multihost``).

The paper's scaling claim is that one consensus round ships only the small
(m, r) factor a client.  The sharded engine (``core.dcf_pca``,
``method="dcf_sharded"``) runs as one OS process a rank: each rank along
the mesh's data axes is one client holding its own column block, and the
ranks meet only in ``torch.distributed`` collectives.  This module holds
the pieces around it:

* **bootstrap** -- ``torch.distributed.init_process_group`` with a bounded
  connect timeout and retries with backoff, plus the ``RPCA_*`` environment
  protocol, so worker code only calls :func:`initialize_from_env`.  Where a
  card is present each rank takes ``local_rank % device_count`` as its
  current device, so ``device.resolve_device(None)`` gives it that card.
* **meshes** -- :func:`multihost_mesh` (a ``DeviceMesh`` over every rank)
  and :class:`MeshComm`, the engine's view of one: the rank's client index
  and row block, the process groups of the data axes, the model axis and
  the whole mesh, and the only collectives the engine uses (``all_reduce``
  and the list form of ``all_gather``: gloo operations that take CUDA
  tensors, staged through the host), each counting the bytes it moves
  (:func:`wire_counts`).
* **worker harness** -- :func:`launch_workers` spawns N Python processes on
  one host, each bootstrapped into one process group: the CI stand-in for
  a multi-host launch, with the same collectives over a local transport.
* **wire accounting** -- the modelled bytes a consensus round moves a
  client (:func:`consensus_wire_model`) and the process-wide traffic
  counters the solver adapters feed.

The backend is the caller's: ``"gloo"`` by default on the CPU, ``"nccl"``
by default where each local rank has a card of its own.  Ranks that share
one card use gloo on CUDA tensors (NCCL refuses two ranks on one device,
and :func:`check_backend` says so).  Nothing here switches backend or
device on its own.

Import stays light: ``torch.distributed`` is touched only when a function
here is called.
"""
from __future__ import annotations

import datetime
import math
import os
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Sequence

import torch

from repro_torch import counters

ENV_COORDINATOR = "RPCA_COORDINATOR"
ENV_NUM_PROCESSES = "RPCA_NUM_PROCESSES"
ENV_PROCESS_ID = "RPCA_PROCESS_ID"
#: This process's rank on its host, and the ranks on its host: one rank is
#: one process and one device, so they take the place of the reference's
#: forced host-device count (``RPCA_LOCAL_DEVICES``).
ENV_LOCAL_RANK = "RPCA_LOCAL_RANK"
ENV_LOCAL_RANKS = "RPCA_LOCAL_RANKS"
ENV_BACKEND = "RPCA_BACKEND"


# ---------------------------------------------------------------------------
# bootstrap


def default_backend(local_ranks: int) -> str:
    """``"nccl"`` when a card is present and each of the host's
    ``local_ranks`` ranks has one of its own, else ``"gloo"``."""
    if torch.cuda.is_available() and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def check_backend(backend: str, local_ranks: int) -> None:
    """Refuse ``"nccl"`` for more local ranks than the host has cards: NCCL
    refuses two ranks on one device."""
    if backend != "nccl":
        return
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local_ranks > cards:
        raise ValueError(
            f"backend 'nccl' takes at most one rank a card: {local_ranks} "
            f"local ranks but {cards} CUDA device(s) on this host (NCCL "
            f"refuses two ranks on one device; use backend 'gloo', which "
            f"stages CUDA tensors through the host)"
        )


def bootstrap(coordinator: str, num_processes: int, process_id: int,
              backend: str | None = None, *, local_rank: int | None = None,
              local_ranks: int | None = None,
              connect_timeout_s: float = 120.0, connect_attempts: int = 4,
              backoff_s: float = 0.5) -> None:
    """Join the ``num_processes``-wide default process group as rank
    ``process_id``, meeting at ``coordinator`` (``host:port``; rank 0
    serves the store there).

    ``backend`` defaults to :func:`default_backend` of the host's
    ``local_ranks`` (default: every rank on this host).  Where a card is
    present the rank's current device becomes ``local_rank %
    device_count`` first.  The connect gets a bounded
    ``connect_timeout_s`` (which also bounds each collective's wait), and
    a failed attempt is retried up to ``connect_attempts`` times with
    exponential backoff (``backoff_s * 2**attempt`` sleeps): a worker that
    races a still-binding coordinator joins once it is up.  A live default
    group is never retried: a process bootstraps once."""
    import torch.distributed as dist

    if local_ranks is None:
        local_ranks = num_processes
    if local_rank is None:
        local_rank = process_id
    if backend is None:
        backend = default_backend(local_ranks)
    check_backend(backend, local_ranks)
    if dist.is_initialized():
        raise RuntimeError(
            "the default process group is live: bootstrap may only be "
            "called once a process")
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    attempts = max(1, connect_attempts)
    for attempt in range(attempts):
        try:
            dist.init_process_group(
                backend, init_method=f"tcp://{coordinator}",
                world_size=num_processes, rank=process_id,
                timeout=datetime.timedelta(seconds=connect_timeout_s))
            return
        except (RuntimeError, ValueError, OSError) as e:
            if ("twice" in str(e) or "only be called once" in str(e)
                    or attempt + 1 >= attempts):
                raise
            if dist.is_initialized():  # clear the failed half-init
                dist.destroy_process_group()
            time.sleep(backoff_s * (2 ** attempt))


def initialize_from_env() -> bool:
    """Bootstrap from the ``RPCA_*`` worker environment; a no-op without
    it.  Returns True when this process joined a process group.  Worker
    scripts call this once at the top; the same script then runs alone
    (variables unset) and under :func:`launch_workers`."""
    coord = os.environ.get(ENV_COORDINATOR)
    if not coord:
        return False
    num = int(os.environ[ENV_NUM_PROCESSES])
    pid = int(os.environ[ENV_PROCESS_ID])
    bootstrap(coord, num, pid, os.environ.get(ENV_BACKEND) or None,
              local_rank=int(os.environ.get(ENV_LOCAL_RANK, pid)),
              local_ranks=int(os.environ.get(ENV_LOCAL_RANKS, num)))
    return True


def shutdown() -> None:
    """Leave the default process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """An OS-assigned free TCP port for the coordinator."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# meshes


def multihost_mesh(axes: tuple[str, ...] = ("data",),
                   shape: tuple[int, ...] | None = None,
                   device: torch.device | str | None = None):
    """A ``DeviceMesh`` over every rank of the default process group, in
    rank order (``init_device_mesh``): one ``data`` axis by default, or
    ``shape`` over ``axes`` (a data x model layout).  ``device`` names the
    device type of the mesh's tensors: the card unless ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.device import resolve_device

    if shape is None:
        shape = (dist.get_world_size(),)
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def _mesh_ranks(mesh) -> torch.Tensor:
    return torch.as_tensor(mesh.mesh)


def is_multiprocess_mesh(mesh) -> bool:
    """True when the mesh spans more than one OS process: in torch, every
    mesh of more than one rank (one process a rank)."""
    return mesh is not None and _mesh_ranks(mesh).numel() > 1


#: Process groups made for a (mesh, axes) pair: ``new_group`` is collective
#: over the default group, so each is made once, by every rank, in order.
_GROUPS: dict[tuple, tuple] = {}


def _axes_group(mesh, axes: tuple[str, ...]):
    """``(group, lin, members)`` for the ranks that share this rank's
    coordinates on every axis outside ``axes``: the process group, for
    each of its group ranks the linear (row-major, in ``axes``' order)
    index of its coordinates along ``axes``, and the group's global ranks
    in group-rank order."""
    import torch.distributed as dist

    key = (mesh, axes)
    if key in _GROUPS:
        return _GROUPS[key]
    names = tuple(mesh.mesh_dim_names)
    ranks = _mesh_ranks(mesh)
    dims = [names.index(a) for a in axes]
    rest = [d for d in range(ranks.ndim) if d not in dims]
    # The mesh's ranks with ``axes`` last, in their order: a row a group.
    rows = ranks.permute(*rest, *dims).reshape(
        -1, math.prod(ranks.shape[d] for d in dims)).tolist()
    me = dist.get_rank()
    if len(axes) == 1:
        group = mesh.get_group(axes[0])
    elif len(rows) == 1 and len(rows[0]) == dist.get_world_size():
        group = dist.group.WORLD
    else:
        group = None
        for row in rows:  # every rank makes every group, in one order
            made = dist.new_group(sorted(row))
            if me in row:
                group = made
    row = next(r for r in rows if me in r)
    members = dist.get_process_group_ranks(group)
    entry = (group, [row.index(g) for g in members], members)
    _GROUPS[key] = entry
    return entry


_wire_lock = threading.Lock()
#: Collective calls and the bytes they moved, by operation, in this
#: process (``{op}_calls``, ``{op}_bytes``), and the host seconds spent in
#: them (``seconds``).  An ``all_reduce`` counts its payload, an
#: ``all_gather`` what it receives (E payloads).  A replayed
#: round graph adds its captured calls and bytes (``core.runtime``), not
#: its seconds.
_WIRE: dict[str, float] = {
    "all_reduce_calls": 0, "all_reduce_bytes": 0,
    "all_gather_calls": 0, "all_gather_bytes": 0, "seconds": 0.0}


def wire_counts(reset: bool = False) -> dict[str, float]:
    """A snapshot of the collective counters (:data:`_WIRE`)."""
    with _wire_lock:
        snap = dict(_WIRE)
        if reset:
            for k in _WIRE:
                _WIRE[k] = type(_WIRE[k])(0)
    return snap


def add_wire_counts(delta: dict[str, float]) -> None:
    with _wire_lock:
        for k, v in delta.items():
            _WIRE[k] += v


# A replayed round adds its captured calls and bytes, not its seconds.
counters.register(
    "wire", lambda: {k: v for k, v in wire_counts().items()
                     if k != "seconds"}, add_wire_counts)


#: Whether a :class:`MeshComm` collective on CUDA tensors synchronises the
#: device first and last, so that its seconds hold only the collective (a
#: measurement setting: ``chip_smoke.py`` sets it in its workers; the
#: syncs cost the solve its overlap).
SYNC_TIMING = False


class MeshComm:
    """One rank's view of a mesh for the sharded engine: its client index
    (the linear index of its coordinates along ``data_axes``, row-major:
    the reference's ``axis_index(data_axes)``), the client count E, its row
    block along ``model_axis``, and the collectives over the data group,
    the model group and the whole mesh.

    Every collective goes through :meth:`all_reduce` or the list form of
    :meth:`all_gather` (the gloo operations that take CUDA tensors), which
    count their calls and bytes (:func:`wire_counts`) and time themselves
    on the host (:data:`SYNC_TIMING`)."""

    def __init__(self, mesh, data_axes: Sequence[str] = ("data",),
                 model_axis: str | None = None):
        names = tuple(mesh.mesh_dim_names or ())
        data_axes = tuple(data_axes)
        for a in data_axes + ((model_axis,) if model_axis else ()):
            if a not in names:
                raise ValueError(
                    f"mesh axis {a!r} not in the mesh's axes {names}")
        if model_axis in data_axes:
            raise ValueError(
                f"model_axis {model_axis!r} is also a data axis")
        self.mesh = mesh
        self.data_axes = data_axes
        self.model_axis = model_axis
        ranks = _mesh_ranks(mesh)
        coord = mesh.get_coordinate()
        size = dict(zip(names, ranks.shape))
        self.clients = 1
        self.client = 0
        for a in data_axes:
            self.clients *= int(size[a])
            self.client = self.client * int(size[a]) + coord[names.index(a)]
        self.model_size = 1 if model_axis is None else int(size[model_axis])
        self.model_index = (0 if model_axis is None
                            else coord[names.index(model_axis)])
        self.shape = [int(s) for s in ranks.shape]
        self._data = _axes_group(mesh, data_axes)
        self._model = (None if model_axis is None
                       else _axes_group(mesh, (model_axis,)))
        self._all = _axes_group(mesh, data_axes + (
            (model_axis,) if model_axis else ()))

    def _group(self, over: str):
        return {"data": self._data, "model": self._model,
                "all": self._all}[over]

    def _timed(self, op: str, x: torch.Tensor, nbytes: int, fn) -> Any:
        cuda = x.device.type == "cuda"
        capturing = cuda and torch.cuda.is_current_stream_capturing()
        sync = cuda and SYNC_TIMING and not capturing
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if sync:
            torch.cuda.synchronize()
        add_wire_counts({f"{op}_calls": 1, f"{op}_bytes": nbytes,
                         "seconds": 0.0 if capturing
                         else time.perf_counter() - t0})
        return out

    @property
    def capturable(self) -> bool:
        """Whether a round's collectives can be captured in a CUDA graph:
        on NCCL groups (their kernels run on the device).  Gloo runs its
        collectives on the host, so a round over gloo runs eagerly."""
        import torch.distributed as dist

        groups = [e[0] for e in (self._data, self._model, self._all) if e]
        return all(str(dist.get_backend(g)) == "nccl" for g in groups)

    def all_reduce(self, x: torch.Tensor, over: str = "data"
                   ) -> torch.Tensor:
        """The sum of ``x`` over the ``over`` group (``"data"``,
        ``"model"`` or ``"all"``), as a new tensor; the identity for
        ``"model"`` without a model axis."""
        import torch.distributed as dist

        entry = self._group(over)
        if entry is None:
            return x
        y = x.reshape(-1).clone()

        def reduce():
            dist.all_reduce(y, group=entry[0])
            return y.view(x.shape)

        return self._timed("all_reduce", y, y.numel() * y.element_size(),
                           reduce)

    def all_gather(self, x: torch.Tensor, over: str = "data"
                   ) -> torch.Tensor:
        """``x`` of every rank of the ``over`` group, stacked on a new
        leading axis in linear index order (client order for ``"data"``),
        identical on every rank.  The list form of ``all_gather``."""
        import torch.distributed as dist

        group, lin, _ = self._group(over)
        flat = x.reshape(-1).contiguous()
        outs = [torch.empty_like(flat) for _ in lin]

        def gather():
            dist.all_gather(outs, flat, group=group)
            order = sorted(range(len(lin)), key=lin.__getitem__)
            return torch.stack([outs[j] for j in order]).view(
                len(lin), *x.shape)

        return self._timed("all_gather", flat,
                           len(lin) * flat.numel() * flat.element_size(),
                           gather)


# ---------------------------------------------------------------------------
# worker harness

_PREAMBLE = """\
import repro_torch.distributed.multihost as _mh
_mh.initialize_from_env()
"""
_POSTAMBLE = """
_mh.shutdown()
"""

#: Output markers of a lost coordinator port: ``free_port`` probes a port
#: and closes it before rank 0's store binds it, so another process can
#: take it in between (torch's TCPStore says ``EADDRINUSE`` / "address
#: already in use").  Such a cohort is relaunched on a fresh port; matched
#: without regard to case.
_BIND_RACE_MARKERS = ("eaddrinuse", "address already in use",
                      "failed to bind")


def _launch_once(code: str, num_processes: int, backend: str | None,
                 timeout: int, extra_env: dict[str, str] | None,
                 kill_after: dict[int, float] | None) -> list[str]:
    """One worker-cohort launch (see :func:`launch_workers`)."""
    src_dir = os.path.abspath(
        os.path.join(os.path.dirname(__file__), "..", ".."))
    env_base = dict(os.environ)
    env_base.update(extra_env or {})
    env_base[ENV_COORDINATOR] = f"127.0.0.1:{free_port()}"
    env_base[ENV_NUM_PROCESSES] = str(num_processes)
    env_base[ENV_LOCAL_RANKS] = str(num_processes)
    env_base[ENV_BACKEND] = backend or ""
    env_base["PYTHONPATH"] = src_dir + os.pathsep + env_base.get(
        "PYTHONPATH", "")
    procs = []
    for pid in range(num_processes):
        env = dict(env_base)
        env[ENV_PROCESS_ID] = str(pid)
        env[ENV_LOCAL_RANK] = str(pid)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _PREAMBLE + code + _POSTAMBLE],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        ))
    timers = []
    for pid, delay in (kill_after or {}).items():
        t = threading.Timer(float(delay), procs[int(pid)].kill)
        t.daemon = True
        t.start()
        timers.append(t)
    outs: list[str] = []
    fail: str | None = None
    try:
        for pid, p in enumerate(procs):
            try:
                out, _ = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                for q in procs:
                    q.wait()
                raise
            outs.append(out)
            if p.returncode != 0 and fail is None:
                fail = f"worker {pid} exited {p.returncode}:\n{out}"
    finally:
        for t in timers:
            t.cancel()
        for q in procs:
            if q.poll() is None:
                q.kill()
                q.wait()
    if fail is not None:
        raise RuntimeError(fail)
    return outs


def launch_workers(code: str, num_processes: int = 2, timeout: int = 900,
                   extra_env: dict[str, str] | None = None, *,
                   backend: str | None = None,
                   kill_after: dict[int, float] | None = None,
                   max_restarts: int = 0,
                   bind_retries: int = 3) -> list[str]:
    """Run ``code`` in ``num_processes`` fresh Python processes on this
    host, one rank each.

    Each worker gets the ``RPCA_*`` environment (``backend`` as
    ``RPCA_BACKEND``: ``None`` takes :func:`default_backend`) and ``src``
    on its ``PYTHONPATH``; ``initialize_from_env()`` has run when ``code``
    starts, and the worker leaves the group when it ends.  The harness
    chooses no device: the worker code names it.  Returns each worker's
    output (stdout and stderr, index = rank); raises ``RuntimeError`` with
    the first failing worker's output on any nonzero exit.

    Fault tolerance, as the reference's:

    * **Coordinator bind race.**  A cohort that fails with a bind marker
      (:data:`_BIND_RACE_MARKERS`) is relaunched on a fresh port, up to
      ``bind_retries`` times, with backoff.
    * **Deterministic crashes.**  ``kill_after={rank: seconds}`` SIGKILLs
      those workers after a fixed delay on the first launch only; with
      ``max_restarts > 0`` a failed cohort (killed or crashed) is
      respawned whole on a fresh port, up to that many times.  Worker code
      that resumes from its latest checkpoint turns this into the kill ->
      respawn -> finish-bit-exact drill.
    """
    check_backend(backend or default_backend(num_processes), num_processes)
    last: Exception | None = None
    for attempt in range(max_restarts + 1):
        binds = 0
        while True:
            try:
                return _launch_once(
                    code, num_processes, backend, timeout, extra_env,
                    kill_after if attempt == 0 else None,
                )
            except RuntimeError as e:
                text = str(e).lower()
                if (any(m in text for m in _BIND_RACE_MARKERS)
                        and binds < bind_retries):
                    binds += 1
                    time.sleep(0.2 * (2 ** (binds - 1)))
                    continue
                last = e
                break
        if attempt >= max_restarts:
            break
    assert last is not None
    raise last


# ---------------------------------------------------------------------------
# consensus wire accounting


def topk_k(d: int, frac: float) -> int:
    """Static kept-entry count for a ``d``-entry factor at ``frac``."""
    return max(1, min(d, int(round(frac * d))))


def consensus_wire_model(m: int, rank: int, num_clients: int,
                         compress=None) -> dict[str, float]:
    """Modelled consensus bytes one client moves per round.

    Dense: ship the local (m, r) f32 factor up and receive the consensus
    factor down, ``2 m r * 4`` bytes (the paper's ``2 E m r`` bound over
    ``E`` clients).  Compressed: the consensus runs as an all-gather of
    each client's top-k (value f32, index int32) payload, so a client
    sends ``k * 8`` and receives ``(E-1) * k * 8``, ``E k * 8`` in all.
    Index bytes are counted."""
    d = m * rank
    dense = 2 * d * 4
    frac = getattr(compress, "topk_frac", None) if compress is not None \
        else None
    if frac is None:
        shipped = dense
        k = d
    else:
        k = topk_k(d, float(frac))
        shipped = 8 * k * num_clients
    return {
        "dense_bytes": float(dense),
        "shipped_bytes": float(shipped),
        "ratio": dense / shipped,
        "k": float(k),
    }


_traffic_lock = threading.Lock()
_TRAFFIC = {
    "solves": 0,
    "rounds": 0,
    "shipped_bytes": 0.0,
    "dense_bytes": 0.0,
}


def record_consensus(m: int, rank: int, num_clients: int, rounds: int,
                     compress=None) -> None:
    """Fold one solve's modelled consensus traffic into the counters."""
    model = consensus_wire_model(m, rank, num_clients, compress)
    with _traffic_lock:
        _TRAFFIC["solves"] += 1
        _TRAFFIC["rounds"] += int(rounds)
        _TRAFFIC["shipped_bytes"] += model["shipped_bytes"] * rounds
        _TRAFFIC["dense_bytes"] += model["dense_bytes"] * rounds


def consensus_traffic(reset: bool = False) -> dict[str, float]:
    """Snapshot of the process-wide consensus traffic counters.

    ``bytes_per_round`` is the modelled per-client shipped bytes averaged
    over recorded rounds; ``achieved_ratio`` the realized dense/shipped
    compression (1.0 when every solve ran dense)."""
    with _traffic_lock:
        snap = dict(_TRAFFIC)
        if reset:
            for key in _TRAFFIC:
                _TRAFFIC[key] = type(_TRAFFIC[key])(0)
    rounds = max(snap["rounds"], 1)
    shipped = snap["shipped_bytes"]
    return {
        "solves": snap["solves"],
        "rounds": snap["rounds"],
        "shipped_bytes": shipped,
        "bytes_per_round": shipped / rounds,
        "achieved_ratio": (snap["dense_bytes"] / shipped) if shipped else 1.0,
    }
