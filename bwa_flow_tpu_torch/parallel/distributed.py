"""Multi-process execution — the MPI master/worker analog
(torch.distributed on gloo).

Port of bwa_flow_tpu/parallel/distributed.py. The reference scales across
nodes with a pull-based MPI scatter of read batches, per-rank output
directories, one Bcast and a final Barrier
(src/mpi/MPIChannel.cpp:138-193, mpi_main.cpp:220-318). Here:

  - `torch.distributed.init_process_group("gloo")` forms the process
    group (coordinator address from flag or env; its TCP store listens
    on the coordinator port) — replacing MPI_Init;
  - batches are handed out by a pull work queue on rank 0 (or strided
    over batch index); every rank reads the whole FASTQ, so read ids
    stay globally consistent and hashing/tie-breaks match a one-process
    run;
  - each rank runs the full align pipeline on its own device and writes
    its own output (the reference's per-rank `<host>-<pid>` dirs);
  - cross-rank reductions (stats, duplicate-signature union, partition
    tallies) are all-gathers of int64/float64 CPU tensors. Gloo, not
    NCCL: the collectives carry host arrays, and NCCL refuses two ranks
    on one GPU. NB the reference performs markdup *per rank* with no
    cross-rank exchange; `merge_markdup_signatures` is an optional
    strictness improvement over it.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as tdist


def resolve_coordinator(coordinator: str | None = None) -> str:
    """One source of truth for the coordinator address: explicit flag ->
    BWA_TPU_COORDINATOR env -> localhost default. Every consumer (the
    process group's store, work-queue host/port derivation) must use this
    so an env-configured multi-host run cannot have nonzero ranks pulling
    from localhost."""
    if coordinator:
        return coordinator
    return os.environ.get("BWA_TPU_COORDINATOR", "localhost:9911")


def parse_hostport(addr: str, default_port: int = 9911
                   ) -> tuple[str, int]:
    """Split host:port accepting IPv6 literals: '[::1]:9911' -> ('::1',
    9911), '::1' -> ('::1', default), 'host:9911' -> ('host', 9911)."""
    addr = addr.strip()
    if addr.startswith("["):            # [v6]:port or [v6]
        host, _, rest = addr[1:].partition("]")
        if rest.startswith(":"):
            return host, int(rest[1:])
        return host, default_port
    if addr.count(":") > 1:             # bare IPv6 literal, no port
        return addr, default_port
    host, sep, port = addr.rpartition(":")
    if not sep:
        return addr, default_port
    return host, int(port)


def _world() -> int:
    """Ranks in the process group; 1 when none is initialised."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """MPI_Init analog. Returns (process_id, num_processes)."""
    if num_processes is None:
        num_processes = int(os.environ.get("BWA_TPU_NPROCS", "1"))
    if num_processes <= 1:
        return 0, 1
    if process_id is None:
        process_id = int(os.environ["BWA_TPU_PROC_ID"])
    host, port = parse_hostport(resolve_coordinator(coordinator))
    if ":" in host:
        host = f"[{host}]"
    tdist.init_process_group("gloo", init_method=f"tcp://{host}:{port}",
                             world_size=num_processes, rank=process_id)
    return process_id, num_processes


def shutdown() -> None:
    """Destroy the process group (end of run, error paths included), so
    that neither the interpreter's exit nor a peer waits on it."""
    if tdist.is_initialized():
        tdist.destroy_process_group()


def shard_batches(batches, process_id: int, num_processes: int):
    """Strided batch assignment (the scatter analog). Every host consumes
    the same read-id numbering; only its own shard is aligned."""
    for i, batch in enumerate(batches):
        if i % num_processes == process_id:
            yield batch


class WorkQueueServer:
    """Pull-based batch-index service — the MPI master loop analog.

    The reference's master rank hands each worker the NEXT read chunk on
    request, so a slow node simply pulls fewer chunks and nobody
    straggles the job (src/mpi/MPIChannel.cpp:138-193:
    SampleChannel::retrieve's MPI_Send(rank)->MPI_Recv(chunk) loop).
    Here the master hands out batch INDEXES over a one-line TCP protocol
    and every host reads its own input (all hosts see the same FASTQ, so
    shipping read data like MPI_Recv does would waste the wire); each
    index is served to exactly one puller.

    Protocol: client sends ``NEXT <token>\\n``, server replies ``<idx>\\n``
    with a monotonically increasing index. The token is a per-run
    identifier all ranks derive from the coordinator address (or
    BWA_TPU_RUN_TOKEN); a stray connection from another job or a
    restarted rank with a different token is refused instead of silently
    consuming indexes (which would lose those batches — no rank would
    ever align them). The server never says "done" — it does not know
    the input length up front (batches stream in); a client past the end
    of its local iterator simply stops pulling. Exact-partition safety
    net: verify_partition() allgathers per-rank aligned counts at the
    end and raises on read loss.
    """

    def __init__(self, host: str = "", port: int = 0,
                 token: str | None = None):
        import socket
        import threading
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self._sock.bind((host, port))
        except OSError:
            if not host:
                raise
            # coordinator address may be a DNS name / VIP not assignable
            # on this host's interfaces (NAT, load balancer): serve on
            # all interfaces instead — clients still connect via the
            # resolved name
            self._sock.bind(("", port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self.token = run_token() if token is None else token
        self._next = 0
        self._lock = threading.Lock()
        self._closed = False
        self._threads = []
        t = threading.Thread(target=self._accept, daemon=True)
        t.start()
        self._threads.append(t)

    def _accept(self):
        import threading
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn):
        want = b"NEXT " + self.token.encode()
        try:
            f = conn.makefile("rwb")
            while True:
                line = f.readline()
                if not line or line.strip() != want:
                    if line:
                        f.write(b"ERR bad token\n")
                        f.flush()
                    return
                with self._lock:
                    idx = self._next
                    self._next += 1
                f.write(b"%d\n" % idx)
                f.flush()
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass


class WorkQueueClient:
    """Puller side; retries the connect while the master starts up.

    The connect window (BWA_TPU_WQ_TIMEOUT, default 60 s) must cover
    rank-0 startup skew — on big genomes rank 0 spends minutes in index
    load before serving, so pass a larger timeout (the CLI ties it to
    the same env). Known failure mode (documented, unhandled): an index
    pulled by a rank that then crashes is never requeued; surviving
    ranks finish their shards and block at the final barrier until the
    job scheduler kills them — same semantics as the reference's MPI
    (a dead rank hangs the job, mpi_main.cpp)."""

    def __init__(self, host: str, port: int, timeout: float | None = None,
                 token: str | None = None):
        import socket
        import time as _time
        if timeout is None:
            timeout = float(os.environ.get("BWA_TPU_WQ_TIMEOUT", "60"))
        self.token = run_token() if token is None else token
        deadline = _time.time() + timeout
        err = None
        while _time.time() < deadline:
            try:
                self._sock = socket.create_connection((host, port),
                                                      timeout=timeout)
                break
            except OSError as e:
                err = e
                _time.sleep(0.2)
        else:
            raise ConnectionError(
                f"work queue at {host}:{port} unreachable: {err}")
        self._f = self._sock.makefile("rwb")

    def next_index(self) -> int:
        self._f.write(b"NEXT %s\n" % self.token.encode())
        self._f.flush()
        line = self._f.readline()
        if not line:
            raise ConnectionError("work queue closed mid-run")
        if line.startswith(b"ERR"):
            raise ConnectionError(
                f"work queue refused request: {line.decode().strip()}")
        return int(line)

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass


def run_token(coordinator: str | None = None) -> str:
    """Per-run work-queue token every rank derives identically (no
    communication needed): BWA_TPU_RUN_TOKEN env, else a digest of the
    resolved coordinator address + process count. Callers that know the
    --coordinator flag must pass it through: deriving from the env-only
    default would mint one shared token for every flag-configured job,
    defeating the stray-connection rejection."""
    tok = os.environ.get("BWA_TPU_RUN_TOKEN")
    if tok:
        return tok
    import hashlib
    basis = (resolve_coordinator(coordinator) + "/"
             + os.environ.get("BWA_TPU_NPROCS", "1"))
    return hashlib.sha1(basis.encode()).hexdigest()[:12]


def verify_partition(n_local_batches: int, n_aligned: int) -> None:
    """Exact-partition check at the end of a pull-mode run: every batch
    index below the (host-identical) input length must have been aligned
    by exactly one rank. The protocol serves each index once, so the only
    loss mode is an index consumed by a connection that never aligned it
    (crashed rank, stray client); that shows up as sum(aligned) <
    n_batches. Raises RuntimeError on loss — silent read loss is the one
    unacceptable failure."""
    if _world() == 1:
        return
    counts = allgather_i64(np.asarray(
        [[n_local_batches, n_aligned]], dtype=np.int64))
    n_batches = int(counts[0, 0])
    if not np.all(counts[:, 0] == n_batches):
        raise RuntimeError(
            f"ranks disagree on input length: {counts[:, 0].tolist()}")
    total = int(counts[:, 1].sum())
    if total != n_batches:
        raise RuntimeError(
            f"work-queue partition incomplete: {total} of {n_batches} "
            f"batches aligned (per-rank {counts[:, 1].tolist()}) — "
            "some indexes were consumed but never aligned")


def pull_batches(batches, client: "WorkQueueClient", tally: dict = None):
    """Dynamic batch assignment: align exactly the batch indexes pulled
    from the master's queue. Read-id numbering stays global (every host
    walks the whole local iterator), like shard_batches, so hash_64
    tie-breaks match a single-host run. `tally` (optional dict) receives
    n_batches/n_aligned for verify_partition."""
    n_seen = 0
    n_aligned = 0
    try:
        want = client.next_index()
        for i, batch in enumerate(batches):
            n_seen = i + 1
            if i == want:
                yield batch
                n_aligned += 1
                want = client.next_index()
    finally:
        client.close()
        if tally is not None:
            tally["n_batches"] = n_seen
            tally["n_aligned"] = n_aligned


def workqueue_addr(coordinator: str | None) -> tuple[str, int]:
    """(host, port) of the work-queue service, derived from the RESOLVED
    coordinator (flag -> env -> default; the coordinator's own port is
    taken by the process group's TCP store)."""
    host, port = parse_hostport(resolve_coordinator(coordinator))
    return host, port + 137


def workqueue_port(coordinator: str | None) -> int:
    return workqueue_addr(coordinator)[1]


def _allgather(t: torch.Tensor) -> list[torch.Tensor]:
    out = [torch.empty_like(t) for _ in range(_world())]
    tdist.all_gather(out, t)
    return out


def allgather_i64(rows: np.ndarray) -> np.ndarray:
    """All-gather variable-length int64[N, K] rows across ranks (pads to
    the global max and strips). Single-process: identity."""
    if _world() == 1:
        return rows
    n = torch.tensor([rows.shape[0]], dtype=torch.int64)
    counts = torch.cat(_allgather(n)).numpy()
    cap = int(counts.max())
    k = rows.shape[1] if rows.size else 3
    pad = torch.zeros((cap, k), dtype=torch.int64)
    pad[:rows.shape[0]] = torch.from_numpy(
        np.ascontiguousarray(rows, dtype=np.int64).reshape(-1, k))
    gathered = _allgather(pad)
    out = [g[:int(c)].numpy() for g, c in zip(gathered, counts)]
    return np.concatenate(out, axis=0)


def merge_markdup_signatures(state) -> None:
    """Union all ranks' duplicate signatures into this rank's state
    (optional strictness pass; the reference keeps markdup per rank).
    NativeMarkDupState's uint64 triples stay below 2^63 (its
    docstring), so they fit int64."""
    rows = np.asarray(state.signature_items(), dtype=np.int64)
    if rows.size == 0:
        rows = np.zeros((0, 3), dtype=np.int64)
    merged = allgather_i64(rows)
    state.merge(merged.tolist())


def reduce_stats(stats: dict) -> dict:
    """Sum numeric pipeline counters across ranks (final-report analog)."""
    if _world() == 1:
        return dict(stats)
    keys = sorted(stats)
    vals = torch.tensor([float(stats[k]) for k in keys],
                        dtype=torch.float64)
    allv = torch.stack(_allgather(vals)).numpy()
    return {k: allv[:, i].sum() for i, k in enumerate(keys)}


def barrier() -> None:
    if _world() > 1:
        tdist.barrier()
