"""The port's multi-process layer (bwa_flow_tpu_torch/parallel/
distributed.py, torch.distributed on gloo) and the CLI's --nprocs runs:
the cases of tests/test_distributed.py on the port's module, the run
token against the JAX package's, a two-process gloo run of the
collectives, and two-rank `mem` runs on the CPU whose union equals the
one-process output and the JAX package's --no-device SAM."""

import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
import threading
import time
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from bwa_flow_tpu.parallel import distributed as jdist
from bwa_flow_tpu_torch import cli
from bwa_flow_tpu_torch.io import bam
from bwa_flow_tpu_torch.parallel import distributed as dist
from bwa_flow_tpu_torch.parallel.distributed import (
    WorkQueueClient, WorkQueueServer, parse_hostport, pull_batches,
    shard_batches, workqueue_addr)
from bwa_flow_tpu_torch.pipeline import sort

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300


def _free_port() -> int:
    """A free TCP port p with p + 137 (the work queue's) free too."""
    for _ in range(100):
        with socket.socket() as a, socket.socket() as b:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            if p + 137 > 65535:
                continue
            try:
                b.bind(("127.0.0.1", p + 137))
            except OSError:
                continue
            return p
    raise RuntimeError("no free port pair")


def _env(home) -> dict:
    # one intra-op thread a rank, as in this process: the ranks' small
    # tensors slow down many times over on oversubscribed cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), HOME=str(home),
               OMP_NUM_THREADS="1")
    for k in ("BWA_TPU_NPROCS", "BWA_TPU_PROC_ID", "BWA_TPU_COORDINATOR",
              "BWA_TPU_RUN_TOKEN", "BWA_TPU_EXTEND16"):
        env.pop(k, None)
    return env


def _run_ranks(argvs, env, cwd) -> list[str]:
    """Start one process per argv, wait for all (killing the rest when
    one fails or the time runs out); returns their stdout."""
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env,
                              cwd=str(cwd)) for a in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=TIMEOUT)
            outs.append((p.returncode, out, err))
            if p.returncode != 0:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    assert len(outs) == len(procs)
    return [o for _, o, _ in outs]


# ------------------------------------------------ work queue, sharding

def test_shard_batches():
    batches = [[i] for i in range(10)]
    got = [list(shard_batches(iter(batches), r, 3)) for r in range(3)]
    assert got[0] == [[0], [3], [6], [9]]
    assert got[1] == [[1], [4], [7]]
    assert got[2] == [[2], [5], [8]]
    assert got == [list(jdist.shard_batches(iter(batches), r, 3))
                   for r in range(3)]


def test_pull_workqueue_partition_and_balance():
    """Every batch goes to exactly one puller, and a straggler
    self-load-balances: the fast puller takes more batches instead of the
    job waiting on the slow one (src/mpi/MPIChannel.cpp:138-193)."""
    srv = WorkQueueServer(port=0)
    batches = [[i] for i in range(40)]
    got = [[], []]

    def run(rank, delay):
        cl = WorkQueueClient("127.0.0.1", srv.port)
        for b in pull_batches(iter(batches), cl):
            got[rank].append(b[0])
            time.sleep(delay)

    ts = [threading.Thread(target=run, args=(0, 0.0)),
          threading.Thread(target=run, args=(1, 0.02))]  # rank 1 straggles
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    srv.close()
    assert not any(t.is_alive() for t in ts)
    assert sorted(got[0] + got[1]) == list(range(40))   # exact partition
    assert not (set(got[0]) & set(got[1]))
    assert len(got[0]) > len(got[1]) * 2, (len(got[0]), len(got[1]))


def test_pull_workqueue_order_within_rank_and_tally():
    """A rank sees its pulled batches in input order, walks the whole
    iterator, and tallies what it saw and aligned."""
    srv = WorkQueueServer(port=0)
    cl = WorkQueueClient("127.0.0.1", srv.port)
    tally: dict = {}
    out = [b[0] for b in pull_batches(iter([[i] for i in range(7)]), cl,
                                      tally=tally)]
    srv.close()
    assert out == list(range(7))
    assert tally == {"n_batches": 7, "n_aligned": 7}


def test_workqueue_rejects_bad_token():
    """A stray connection with the wrong run token is refused and
    consumes no batch index."""
    srv = WorkQueueServer(port=0, token="good")
    ok = WorkQueueClient("127.0.0.1", srv.port, token="good")
    assert ok.next_index() == 0
    bad = WorkQueueClient("127.0.0.1", srv.port, token="evil")
    with pytest.raises(ConnectionError):
        bad.next_index()
    assert ok.next_index() == 1
    ok.close()
    bad.close()
    srv.close()


def test_parse_hostport_ipv6():
    cases = [("localhost:9911", ("localhost", 9911)),
             ("host", ("host", 9911)), ("[::1]:9931", ("::1", 9931)),
             ("::1", ("::1", 9911)), ("[fe80::2]", ("fe80::2", 9911))]
    for addr, want in cases:
        assert parse_hostport(addr) == want == jdist.parse_hostport(addr)
    assert parse_hostport("10.0.0.2:80", 9000) == ("10.0.0.2", 80)


def test_workqueue_addr_env(monkeypatch):
    """The work queue follows BWA_TPU_COORDINATOR when no flag is given;
    an explicit flag wins."""
    monkeypatch.setenv("BWA_TPU_COORDINATOR", "10.1.2.3:7000")
    assert workqueue_addr(None) == ("10.1.2.3", 7137)
    assert workqueue_addr("h:8000") == ("h", 8137)
    assert dist.workqueue_port("[::1]:9000") == 9137


@pytest.mark.parametrize("case", ["env_token", "flag", "env_coordinator",
                                  "default"])
def test_run_token_equals_jax(monkeypatch, case):
    for k in ("BWA_TPU_RUN_TOKEN", "BWA_TPU_COORDINATOR", "BWA_TPU_NPROCS"):
        monkeypatch.delenv(k, raising=False)
    flag = None
    if case == "env_token":
        monkeypatch.setenv("BWA_TPU_RUN_TOKEN", "tok42")
    elif case == "flag":
        flag = "10.0.0.9:1234"
        monkeypatch.setenv("BWA_TPU_NPROCS", "4")
    elif case == "env_coordinator":
        monkeypatch.setenv("BWA_TPU_COORDINATOR", "[::1]:5555")
    got = dist.run_token(flag)
    assert got == jdist.run_token(flag)
    if case == "env_token":
        assert got == "tok42"
    else:
        assert len(got) == 12 and got != dist.run_token("other:1")


# ------------------------------------------------------ process group

def test_init_distributed_init_method(monkeypatch):
    """One process forms no group; more call init_process_group on gloo
    with the coordinator's address (IPv6 hosts in brackets), the rank and
    the world size from flags or the environment."""
    calls = []
    monkeypatch.setattr(dist.tdist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    monkeypatch.delenv("BWA_TPU_NPROCS", raising=False)
    assert dist.init_distributed() == (0, 1)
    assert dist.init_distributed("h:1", 1, 0) == (0, 1)
    assert dist.init_distributed("[::1]:7001", 2, 1) == (1, 2)
    monkeypatch.setenv("BWA_TPU_NPROCS", "3")
    monkeypatch.setenv("BWA_TPU_PROC_ID", "2")
    monkeypatch.setenv("BWA_TPU_COORDINATOR", "10.0.0.1:7002")
    assert dist.init_distributed() == (2, 3)
    assert calls == [
        (("gloo",), dict(init_method="tcp://[::1]:7001", world_size=2,
                         rank=1)),
        (("gloo",), dict(init_method="tcp://10.0.0.1:7002", world_size=3,
                         rank=2))]


def test_collectives_without_a_group():
    """With no process group every collective is the identity."""
    assert not dist.tdist.is_initialized()
    rows = np.arange(6, dtype=np.int64).reshape(3, 2)
    assert dist.allgather_i64(rows) is rows
    assert dist.reduce_stats({"a": 1}) == {"a": 1}
    dist.verify_partition(5, 0)
    dist.barrier()
    dist.shutdown()


WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np
    from bwa_flow_tpu_torch.parallel import distributed as dist

    pid, n, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    assert dist.init_distributed(coord, n, pid) == (pid, n)
    res = {"world": dist.tdist.get_world_size()}

    res["stats"] = {k: float(v) for k, v in dist.reduce_stats(
        {"reads": 10 * (pid + 1), "waves": 1}).items()}
    rows = np.arange(3 * 2, dtype=np.int64).reshape(3, 2) + 100 * pid
    res["gather"] = dist.allgather_i64(rows[:3 - 2 * pid]).tolist()
    empty = np.zeros((0, 3), np.int64) if pid else np.ones((2, 3), np.int64)
    res["gather_empty"] = dist.allgather_i64(empty).tolist()

    dist.verify_partition(5, 3 if pid == 0 else 2)   # exact: no raise
    res["short"] = res["disagree"] = None
    try:
        dist.verify_partition(5, 2)                  # 4 of 5 aligned
    except RuntimeError as e:
        res["short"] = str(e)
    try:
        dist.verify_partition(5 + pid, 3 - pid)      # lengths differ
    except RuntimeError as e:
        res["disagree"] = str(e)
    dist.barrier()
    dist.shutdown()
    res["after_shutdown"] = dist.tdist.is_initialized()
    print(json.dumps(res))
""")


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    (d / "worker.py").write_text(WORKER)
    coord = f"127.0.0.1:{_free_port()}"
    outs = _run_ranks([[sys.executable, str(d / "worker.py"), str(i), "2",
                        coord] for i in range(2)], _env(d), d)
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def test_gloo_reduce_stats(collectives):
    assert all(r["world"] == 2 for r in collectives)
    assert all(r["stats"] == {"reads": 30.0, "waves": 2.0}
               for r in collectives)


def test_gloo_allgather_i64_unequal_rows(collectives):
    want = [[0, 1], [2, 3], [4, 5], [100, 101]]
    assert all(r["gather"] == want for r in collectives)
    assert all(r["gather_empty"] == [[1, 1, 1]] * 2 for r in collectives)


def test_gloo_verify_partition_raises_on_loss(collectives):
    for r in collectives:
        assert "4 of 5 batches aligned" in r["short"]
        assert "disagree on input length: [5, 6]" in r["disagree"]


def test_gloo_barrier_and_shutdown(collectives):
    assert [r["after_shutdown"] for r in collectives] == [False, False]


# ------------------------------------------------------ two-rank mem

N_READS = 150
BASE = ["--disable-markdup", "-K", "2000", "-t", "1"]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A 20 kb genome with a repeat family, 150 x 101 bp reads (-K 2000
    makes 8 batches of about 20), the port's index and one-process
    SAM and BAM, and the JAX package's --no-device SAM."""
    d = tmp_path_factory.mktemp("torch_dist")
    rng = np.random.default_rng(0xD157)
    g = rng.integers(0, 4, 20000).astype(np.uint8)
    unit = rng.integers(0, 4, 300).astype(np.uint8)
    for p in rng.integers(0, 19700, 8):
        cp = unit.copy()
        m = rng.random(300) < 0.03
        cp[m] = (cp[m] + 1) % 4
        g[p:p + 300] = cp
    text = np.frombuffer(b"ACGT", np.uint8)[g].tobytes().decode()
    (d / "ref.fa").write_text(">chr1\n" + "\n".join(
        text[i:i + 70] for i in range(0, len(text), 70)) + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    with open(d / "r.fq", "w") as f:
        for i in range(N_READS):
            p = int(rng.integers(0, 20000 - 101))
            r = list(text[p:p + 101])
            for j in rng.integers(0, 101, int(rng.integers(0, 4))):
                r[j] = "ACGT"[("ACGT".index(r[j]) + 1) % 4]
            s = "".join(r)
            if i % 2:
                s = s.translate(comp)[::-1]
            f.write(f"@q{i}\n{s}\n+\n{'I' * 101}\n")
    jd = d / "jax"
    jd.mkdir()
    shutil.copy(d / "ref.fa", jd)
    shutil.copy(d / "r.fq", jd)
    code = ("from bwa_flow_tpu import cli\n"
            "assert cli.main(['index', 'ref.fa']) == 0\n"
            f"assert cli.main(['mem', '--no-device', '-o', 'one.sam'] + "
            f"{BASE!r} + ['ref.fa', 'r.fq']) == 0\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(jd), timeout=TIMEOUT,
                       env=dict(_env(d), JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    assert cli.main(["index", str(d / "ref.fa")]) == 0
    assert cli.main(["mem", "--device", "cpu", "-o", str(d / "one.sam")]
                    + BASE + [str(d / "ref.fa"), str(d / "r.fq")]) == 0
    assert cli.main(["mem", "--device", "cpu", "--sort", "--num-buckets",
                     "8", "--temp-dir", str(d / "td_one"), "-o",
                     str(d / "one.bam")] + BASE
                    + [str(d / "ref.fa"), str(d / "r.fq")]) == 0
    return d


def _records(path) -> list[str]:
    return [l for l in Path(path).read_text().splitlines()
            if l and not l.startswith("@")]


def _ranks(d, mode, extra, out):
    coord = f"127.0.0.1:{_free_port()}"
    return [[sys.executable, "-m", "bwa_flow_tpu_torch", "mem", "--device",
             "cpu", "--nprocs", "2", "--proc-id", str(pid), "--coordinator",
             coord, "--dist", mode, "-o", str(out)] + extra + BASE
            + [str(d / "ref.fa"), str(d / "r.fq")] for pid in range(2)]


def test_one_process_sam_equals_jax(world):
    one = _records(world / "one.sam")
    assert one == _records(world / "jax" / "one.sam")
    assert len({l.split("\t")[0] for l in one}) == N_READS


@pytest.mark.parametrize("mode", ["pull", "stride"])
def test_two_rank_union_equals_one_process(world, mode):
    out = world / f"two_{mode}.sam"
    _run_ranks(_ranks(world, mode, [], out), _env(world), world)
    parts = [_records(world / f"two_{mode}.part{i:03d}.sam")
             for i in range(2)]
    assert all(parts), [len(p) for p in parts]
    assert not ({l.split("\t")[0] for l in parts[0]}
                & {l.split("\t")[0] for l in parts[1]})
    one = _records(world / "one.sam")
    assert sorted(parts[0] + parts[1]) == sorted(one)
    assert sorted(one) == sorted(_records(world / "jax" / "one.sam"))


def test_two_rank_sorted_bams_hold_the_one_process_records(world):
    out = world / "two.bam"
    extra = ["--sort", "--num-buckets", "8", "--temp-dir",
             str(world / "td_two")]
    _run_ranks(_ranks(world, "pull", extra, out), _env(world), world)

    def recs(p):
        data = Path(p).read_bytes()
        assert data.endswith(bam.BGZF_EOF)
        raw = [r["raw"] for r in bam.decode_bam_records(
            gzip.decompress(data))[2]]
        keys = [sort.sort_key_from_raw(r) for r in raw]
        assert keys == sorted(keys)
        return raw

    parts = [recs(world / f"two.part{i:03d}.bam") for i in range(2)]
    assert all(parts)
    assert (world / "td_two" / "rank001" / "bucket-000008.bamr").exists()
    assert Counter(parts[0] + parts[1]) == Counter(recs(world / "one.bam"))


def test_a_failing_rank_fails_its_peer(world):
    """Rank 1 fails (its FASTQ is missing) after the group formed: it
    destroys the group on the way out, so rank 0 fails at its next
    collective instead of waiting out gloo's timeout; neither exits 0."""
    argvs = _ranks(world, "pull", [], world / "fail.sam")
    argvs[1][-1] = str(world / "missing.fq")
    procs = [subprocess.Popen(a, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=_env(world), cwd=str(world))
             for a in argvs]
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode != 0 for p in procs] == [True, True]
    assert "missing.fq" in errs[1]
    assert "Connection closed by peer" in errs[0], errs[0][-2000:]
