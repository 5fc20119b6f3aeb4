"""The port's CLI (`bwa_flow_tpu_torch index|mem --device cpu`) against
`python -m bwa_flow_tpu` on the fixture of tests/test_cli.py: index files
byte-equal, single-end and paired-end mem SAM equal apart from @PG
(paired-end also with the int16 extension core and with -I),
--no-device equal too, and so are runs sharded over CPU devices with
--local-devices, and validated runs under the hang watchdog; `--sort`
BAMs equal after decompression. `mem` takes the native route, in
--ext-mode host by default (BWA_TPU_EXT too) and in --ext-mode waves.
Runs that cannot be right (a hung device, a corrupted result) exit
non-zero."""

import gzip
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bwa_flow_tpu_torch import cli
from bwa_flow_tpu_torch.io import bam
from bwa_flow_tpu_torch.ops import extend_torch
from bwa_flow_tpu_torch.pipeline import batch as batchmod
from bwa_flow_tpu_torch.pipeline import sort
from bwa_flow_tpu_torch.pipeline.batch import BatchAligner, DeviceResultError

# small tensors: one intra-op thread per test process (xdist runs six)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
INDEX_EXTS = (".bwt", ".sa", ".pac", ".ann", ".amb")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    rng = np.random.default_rng(0xC11)
    d = tmp_path_factory.mktemp("torch_cli")
    genome = np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 8000)]
    with open(d / "ref.fa", "w") as f:
        f.write(">chrA test contig\n")
        s = genome.tobytes().decode()
        for i in range(0, len(s), 70):
            f.write(s[i:i + 70] + "\n")
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    g = genome.tobytes()
    se, r1, r2 = [], [], []
    for i in range(12):
        pos = int(rng.integers(0, 8000 - 420))
        read = bytearray(g[pos:pos + 101])
        if i % 3 == 0:              # a few substitutions
            j = int(rng.integers(0, 101))
            read[j] = b"ACGT"[(b"ACGT".index(read[j]) + 1) % 4]
        se.append((f"s{i}", read.decode()))
        r1.append((f"p{i}/1", read.decode()))
        r2.append((f"p{i}/2", g[pos + 300:pos + 401].translate(comp)[::-1]
                   .decode()))
    for name, recs in (("se.fq", se), ("r1.fq", r1), ("r2.fq", r2)):
        with open(d / name, "w") as f:
            for n, s in recs:
                f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")
    jd = d / "jax"
    jd.mkdir()
    for name in ("ref.fa", "se.fq", "r1.fq", "r2.fq"):
        shutil.copy(d / name, jd / name)
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               HOME=str(d))
    for args in (["index", "ref.fa"], ["mem", "-o", "se.sam", "ref.fa",
                                        "se.fq"]):
        r = subprocess.run([sys.executable, "-m", "bwa_flow_tpu"] + args,
                           capture_output=True, text=True, cwd=str(jd),
                           env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
    # both paired-end runs in one process: pe.sam, and pe_I.sam with -I;
    # then sorted BAMs of both inputs on the host golden path
    pe_runs = ("from bwa_flow_tpu import cli\n"
               "pe = ['ref.fa', 'r1.fq', 'r2.fq']\n"
               "assert cli.main(['mem', '-o', 'pe.sam'] + pe) == 0\n"
               "assert cli.main(['mem', '-I', '300,30', '-o', 'pe_I.sam']"
               " + pe) == 0\n"
               "srt = ['mem', '--no-device', '--sort', '--num-buckets', '8']\n"
               "assert cli.main(srt + ['--temp-dir', 'td_se', '-o', 'se.bam',"
               " 'ref.fa', 'se.fq']) == 0\n"
               "assert cli.main(srt + ['--temp-dir', 'td_pe', '-o', 'pe.bam']"
               " + pe) == 0\n")
    r = subprocess.run([sys.executable, "-c", pe_runs], capture_output=True,
                       text=True, cwd=str(jd), env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert cli.main(["index", str(d / "ref.fa")]) == 0
    return d


def _waves_carry_every_task(monkeypatch):
    """The native route's --ext-mode waves with no host drain and no
    harvesters, so that the device waves run every task that fits even
    on this fixture's few reads."""
    init = BatchAligner.__init__

    def no_drain(self, *a, **k):
        init(self, *a, **k)
        if self.ext_mode == "waves":
            self.drain_max, self.harvest_workers = 0, 0
    monkeypatch.setattr(BatchAligner, "__init__", no_drain)


def _body(path):
    return [l for l in Path(path).read_text().splitlines()
            if not l.startswith("@PG")]


def test_index_files_equal_jax_package(workdir):
    for ext in INDEX_EXTS:
        mine = (workdir / f"ref.fa{ext}").read_bytes()
        theirs = (workdir / "jax" / f"ref.fa{ext}").read_bytes()
        assert mine == theirs, ext


@pytest.mark.parametrize("mode", ["device_cpu", "no_device"])
def test_mem_sam_equals_jax_package(workdir, mode):
    out = workdir / f"se_{mode}.sam"
    flag = ["--device", "cpu"] if mode == "device_cpu" else ["--no-device"]
    assert cli.main(["mem"] + flag + ["-o", str(out),
                                      str(workdir / "ref.fa"),
                                      str(workdir / "se.fq")]) == 0
    mine = _body(out)
    assert mine == _body(workdir / "jax" / "se.sam")
    recs = [l.split("\t") for l in mine if not l.startswith("@")]
    assert len(recs) == 12 and all(f[2] == "chrA" for f in recs)
    pg = [l for l in out.read_text().splitlines() if l.startswith("@PG")]
    assert pg and pg[0].startswith(
        "@PG\tID:bwa_flow_tpu_torch\tPN:bwa_flow_tpu_torch")


PE_MODES = {"device_cpu": ["--device", "cpu"],
            "device_cpu_int16": ["--device", "cpu", "--ext-mode", "waves"],
            "no_device": ["--no-device"],
            "insert_override": ["--device", "cpu", "-I", "300,30"]}


@pytest.mark.parametrize("mode", sorted(PE_MODES))
def test_pe_mem_sam_equals_jax_package(workdir, mode, monkeypatch):
    """BWA_TPU_EXTEND16=1 runs the native route's device waves on the
    int16 plain version (the int16 kernel's CPU path); the SAM does not
    change. The other modes run the default --ext-mode host."""
    if mode == "device_cpu_int16":
        monkeypatch.setenv("BWA_TPU_EXTEND16", "1")
        _waves_carry_every_task(monkeypatch)
    else:
        monkeypatch.delenv("BWA_TPU_EXTEND16", raising=False)
    calls = []
    core16 = extend_torch.extend_core16

    def counting(*a, **k):
        calls.append(1)
        return core16(*a, **k)
    monkeypatch.setattr(extend_torch, "extend_core16", counting)
    out = workdir / f"pe_{mode}.sam"
    assert cli.main(["mem"] + PE_MODES[mode] + [
        "-o", str(out), str(workdir / "ref.fa"), str(workdir / "r1.fq"),
        str(workdir / "r2.fq")]) == 0
    mine = _body(out)
    want = "pe_I.sam" if mode == "insert_override" else "pe.sam"
    assert mine == _body(workdir / "jax" / want)
    recs = [l.split("\t") for l in mine if not l.startswith("@")]
    assert len(recs) == 24 and all(int(f[1]) & 0x1 for f in recs)
    assert [f[0] for f in recs[::2]] == [f[0] for f in recs[1::2]]
    assert bool(calls) == (mode == "device_cpu_int16")


@pytest.mark.parametrize("extra", [["--device-timeout", "1"],
                                   ["--validate-every", "1"],
                                   ["--ext-mode", "waves"]])
def test_later_slice_options_exit_nonzero(workdir, extra, monkeypatch,
                                          capsys):
    """Each option ends a run that cannot be right with a non-zero exit,
    where the JAX package degrades to the host: a device that never
    finishes (--device-timeout), a corrupted region (--validate-every),
    a device wave row outside its task's range (--ext-mode waves: the
    structural check of every wave row on the native route)."""
    monkeypatch.delenv("BWA_TPU_EXT", raising=False)
    if extra[0] == "--device-timeout":
        monkeypatch.setattr(BatchAligner, "_ready",
                            staticmethod(lambda device: lambda: False))
        want = TimeoutError
    elif extra[0] == "--validate-every":
        real = BatchAligner.extend_waves_packed

        def corrupted(self, *a, **k):
            rows, frac, off = real(self, *a, **k)
            rows = rows.copy()
            rows[0, 5] += 1   # the first region's score
            return rows, frac, off
        monkeypatch.setattr(BatchAligner, "extend_waves_packed", corrupted)
        want = DeviceResultError
    else:
        _waves_carry_every_task(monkeypatch)
        real_ext = batchmod.seed_extend_desc_batch

        def bad_rows(*a, **k):
            out = real_ext(*a, **k).clone()
            out[1, 0] = -3   # lqle of the wave's first lane
            return out
        monkeypatch.setattr(batchmod, "seed_extend_desc_batch", bad_rows)
        want = DeviceResultError
    with pytest.raises(SystemExit) as e:
        cli.main(["mem", "--device", "cpu"] + extra
                 + ["-o", str(workdir / "later.sam"), str(workdir / "ref.fa"),
                    str(workdir / "se.fq")])
    assert e.value.code not in (0, None)
    assert isinstance(e.value.__cause__, want)
    err = capsys.readouterr().err
    assert "[E::mem] " in err
    if extra[0] == "--ext-mode":
        assert "wave lane" in err


def test_validation_and_timeout_equal_jax_sam(workdir):
    """--validate-every 1 --device-timeout 5: the JAX package's SAM, one
    validation a batch."""
    out = workdir / "se_validated.sam"
    assert cli.main(["mem", "--device", "cpu", "--validate-every", "1",
                     "--device-timeout", "5", "--batch-reads", "4", "-o",
                     str(out), str(workdir / "ref.fa"),
                     str(workdir / "se.fq")]) == 0
    assert _body(out) == _body(workdir / "jax" / "se.sam")
    assert cli.last_run_stats["validations"] == 3


def _mem_run(workdir, inputs, extra, name, capsys):
    """Run `mem --device cpu` on se.fq or the pairs; returns (SAM body,
    stderr)."""
    fq = ["se.fq"] if inputs == "se" else ["r1.fq", "r2.fq"]
    out = workdir / name
    capsys.readouterr()
    assert cli.main(["mem", "--device", "cpu"] + extra
                    + ["-o", str(out), str(workdir / "ref.fa")]
                    + [str(workdir / f) for f in fq]) == 0
    return _body(out), capsys.readouterr().err


def test_ext_mode_host_is_the_default_path(workdir, monkeypatch, capsys):
    """With neither --ext-mode nor BWA_TPU_EXT, `mem` takes the native
    route in host mode: every extension task on the harvesters, no
    device wave, no ksw launch; the SAM is the JAX package's."""
    monkeypatch.delenv("BWA_TPU_EXT", raising=False)
    body, err = _mem_run(workdir, "se", [], "se_default.sam", capsys)
    assert body == _body(workdir / "jax" / "se.sam")
    st = cli.last_run_stats
    assert st["waves"] == st["ext_tasks_device"] == 0
    assert st["ext_tasks_host"] > 0
    assert "native route, host mode" in err
    assert "ksw_extend2 0, ksw_extend2_i16 0" in err


def test_ext_mode_waves_runs_device_waves(workdir, monkeypatch, capsys):
    """--ext-mode waves on the native route: device waves carry the
    tasks; the SAM does not change."""
    monkeypatch.delenv("BWA_TPU_EXT", raising=False)
    _waves_carry_every_task(monkeypatch)
    body, err = _mem_run(workdir, "se", ["--ext-mode", "waves"],
                         "se_waves.sam", capsys)
    assert body == _body(workdir / "jax" / "se.sam")
    assert cli.last_run_stats["ext_tasks_device"] > 0
    assert "native route, waves mode" in err


@pytest.mark.parametrize("inputs", ["se", "pe"])
def test_ext_mode_host_runs(workdir, inputs, monkeypatch, capsys):
    """--ext-mode host runs, single-end and paired-end, and gives the JAX
    package's SAM."""
    monkeypatch.setenv("BWA_TPU_EXT", "waves")   # the option wins
    body, err = _mem_run(workdir, inputs, ["--ext-mode", "host"],
                         f"{inputs}_host.sam", capsys)
    assert body == _body(workdir / "jax" / f"{inputs}.sam")
    assert cli.last_run_stats["ext_tasks_device"] == 0
    assert "native route, host mode" in err


@pytest.mark.parametrize("inputs", ["se", "pe"])
def test_ext_mode_host_from_the_environment_runs(workdir, inputs,
                                                 monkeypatch, capsys):
    """BWA_TPU_EXT=host runs, single-end and paired-end, and gives the
    JAX package's SAM."""
    monkeypatch.setenv("BWA_TPU_EXT", "host")
    body, err = _mem_run(workdir, inputs, [], f"{inputs}_env_host.sam",
                         capsys)
    assert body == _body(workdir / "jax" / f"{inputs}.sam")
    assert cli.last_run_stats["ext_tasks_device"] == 0
    assert "native route, host mode" in err


def test_help_lists_the_options(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["mem", "--help"])
    assert e.value.code == 0
    text = " ".join(capsys.readouterr().out.split())
    for opt in ("--validate-every", "--device-timeout", "--ext-mode"):
        assert opt in text
    assert "{host,waves}" in text and "native _wave driver" in text


# a `mem` run whose device stops finishing as its second batch's
# extension starts; it records its pool's worker pids in argv[1]
_STALL_SCRIPT = """\
import json, sys
from bwa_flow_tpu_torch import cli
from bwa_flow_tpu_torch.pipeline import batch, dataflow
init, ext = dataflow.AlignPipeline.__init__, batch.BatchAligner.extend_async
def pool_pids(self, *a, **k):
    init(self, *a, **k)
    with open(sys.argv[1], "w") as f:
        json.dump([p.pid for p in self.pool._pool], f)
calls = []
def stall(self, *a, **k):
    calls.append(1)
    if len(calls) == 2:
        self._ready = lambda device: (lambda: False)
    return ext(self, *a, **k)
dataflow.AlignPipeline.__init__ = pool_pids
batch.BatchAligner.extend_async = stall
cli.entry_main(sys.argv[2:])
"""


def test_stalled_run_exits_nonzero_and_leaves_no_pool_child(workdir):
    """A run whose device hangs in its second batch, with a pool of two
    workers forked: exit non-zero with [E::mem] on stderr, no pool
    worker left behind."""
    script = workdir / "stall_run.py"
    script.write_text(_STALL_SCRIPT)
    pids_f = workdir / "stall_pids.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, str(script), str(pids_f), "mem", "--device", "cpu",
         "-t", "3", "--batch-reads", "4", "--device-timeout", "0.5", "-o",
         str(workdir / "stall.sam"), str(workdir / "ref.fa"),
         str(workdir / "se.fq")], capture_output=True, text=True,
        env=env, timeout=300)
    assert r.returncode not in (0, None), r.stderr[-2000:]
    assert "[E::mem] device work did not finish" in r.stderr
    pids = json.loads(pids_f.read_text())
    assert len(pids) == 2
    deadline = time.monotonic() + 10
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _alive(p)]
        time.sleep(0.1)
    assert not alive


# a `mem` run on the native route in --ext-mode waves (no host drain, no
# harvesters) whose device stops finishing as its second batch's
# extension starts; that extension's worker reaches its first device wait
# argv[1] s late. Prints when the stall began.
_NATIVE_STALL_SCRIPT = """\
import sys, time
from bwa_flow_tpu_torch import cli
from bwa_flow_tpu_torch.pipeline import batch
B = batch.BatchAligner
init, start, ext = B.__init__, B.extend_async, B.extend_waves_packed
def waves_only(self, *a, **k):
    init(self, *a, **k)
    self.drain_max, self.harvest_workers = 0, 0
calls = []
def stall(self, *a, **k):
    calls.append(1)
    if len(calls) == 2:
        self._ready = lambda device: (lambda: False)
        print(f"[stall] at {time.time():.3f}", file=sys.stderr, flush=True)
    return start(self, *a, **k)
def late(self, *a, **k):
    if len(calls) == 2:
        time.sleep(float(sys.argv[1]))
    return ext(self, *a, **k)
B.__init__, B.extend_async, B.extend_waves_packed = waves_only, stall, late
cli.entry_main(sys.argv[2:])
"""


def test_stalled_native_run_exits_within_one_timeout(workdir):
    """The CLI's own route (native, --ext-mode waves) on a device that
    hangs in its second batch: the main thread's wait for the third
    batch's seeding times out, and the process exits non-zero with
    [E::mem] about one --device-timeout after the stall, although the
    extension worker's wait began later (it is abandoned, not waited
    out)."""
    timeout, late_s = 2.0, 1.6
    script = workdir / "native_stall_run.py"
    script.write_text(_NATIVE_STALL_SCRIPT)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.pop("BWA_TPU_EXT", None)
    r = subprocess.run(
        [sys.executable, str(script), str(late_s), "mem", "--device",
         "cpu", "--ext-mode", "waves", "--batch-reads", "4",
         "--device-timeout", str(timeout), "-o",
         str(workdir / "native_stall.sam"), str(workdir / "ref.fa"),
         str(workdir / "se.fq")], capture_output=True, text=True,
        env=env, timeout=300)
    t_end = time.time()
    assert r.returncode not in (0, None), r.stderr[-2000:]
    assert "[E::mem] device work did not finish" in r.stderr
    t_stall = [float(l.split()[-1]) for l in r.stderr.splitlines()
               if l.startswith("[stall] at ")]
    assert len(t_stall) == 1, r.stderr[-2000:]
    assert timeout <= t_end - t_stall[0] < timeout + late_s / 2 + 0.5, \
        t_end - t_stall[0]


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.mark.parametrize("n", [0, 1, 2])
def test_local_devices_se_equals_one_device_and_jax(workdir, n,
                                                    monkeypatch):
    """--local-devices 2 shards every batch over two CPU shards; 0 and 1
    are the one-device path. The SAM equals the one-device --device cpu
    run's and the JAX package's. In --ext-mode waves with no host drain
    and no harvester, so that waves run on every shard at this size
    (test_local_devices_pe_equals_jax runs the default host mode)."""
    _waves_carry_every_task(monkeypatch)
    out = workdir / f"se_ld{n}.sam"
    assert cli.main(["mem", "--device", "cpu", "--local-devices", str(n),
                     "--ext-mode", "waves", "-o", str(out),
                     str(workdir / "ref.fa"), str(workdir / "se.fq")]) == 0
    assert _body(out) == _body(workdir / "jax" / "se.sam")
    shards = cli.last_run_stats["shards"]
    assert len(shards) == max(n, 1)
    assert all(sh["ext_tasks_device"] > 0 for sh in shards)
    if n == 2:
        one = workdir / "se_device_cpu.sam"
        if not one.exists():
            assert cli.main(["mem", "--device", "cpu", "-o", str(one),
                             str(workdir / "ref.fa"),
                             str(workdir / "se.fq")]) == 0
        assert _body(out) == _body(one)


def test_local_devices_pe_equals_jax(workdir):
    out = workdir / "pe_ld2.sam"
    assert cli.main(["mem", "--device", "cpu", "--local-devices", "2",
                     "-o", str(out), str(workdir / "ref.fa"),
                     str(workdir / "r1.fq"), str(workdir / "r2.fq")]) == 0
    assert _body(out) == _body(workdir / "jax" / "pe.sam")
    assert len(cli.last_run_stats["shards"]) == 2


def test_local_devices_choice():
    """CPU shards as asked; CUDA shards never fall back to the CPU."""
    cpu = torch.device("cpu")
    assert cli.local_devices("cpu", 3) == [cpu] * 3
    assert cli.local_devices("cuda", 1) is None
    assert cli.local_devices("cuda", 0) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.local_devices("cuda", 2)


def _bam_parts(path):
    """(header text without @PG lines, refs, raw records in order) of a
    BAM, after checking that it ends in the BGZF EOF block."""
    data = Path(path).read_bytes()
    assert data.endswith(bam.BGZF_EOF)
    text, refs, recs = bam.decode_bam_records(gzip.decompress(data))
    text = [l for l in text.splitlines() if not l.startswith("@PG")]
    return text, refs, [r["raw"] for r in recs]


@pytest.mark.parametrize("inputs", ["se", "pe"])
def test_sorted_bam_equals_jax_package(workdir, inputs):
    """`--sort` on the device path (plain torch on the CPU) against the
    JAX package's `--no-device --sort`, after decompression, @PG aside."""
    fq = ["se.fq"] if inputs == "se" else ["r1.fq", "r2.fq"]
    out = workdir / f"{inputs}_sorted.bam"
    assert cli.main(["mem", "--device", "cpu", "--sort", "--num-buckets",
                     "8", "--temp-dir", str(workdir / f"td_{inputs}"),
                     "-o", str(out), str(workdir / "ref.fa")]
                    + [str(workdir / f) for f in fq]) == 0
    mine = _bam_parts(out)
    assert mine == _bam_parts(workdir / "jax" / f"{inputs}.bam")
    assert mine[1] == [("chrA", 8000)]
    assert len(mine[2]) == 12 * len(fq)
    keys = [sort.sort_key_from_raw(r) for r in mine[2]]
    assert keys == sorted(keys)


@pytest.fixture(scope="module")
def dupdir(tmp_path_factory):
    """The fixture of tests/test_bam_sort.py::test_cli_sorted_bam: six
    reads and a duplicate of the first."""
    d = tmp_path_factory.mktemp("torch_dup")
    rng = np.random.default_rng(0xB0)
    g = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 6000)].tobytes()
    (d / "ref.fa").write_text(
        ">c1\n" + "\n".join(g.decode()[i:i + 70]
                            for i in range(0, 6000, 70)) + "\n")
    with open(d / "se.fq", "w") as f:
        for i in range(6):
            p = 500 * i
            f.write(f"@s{i}\n{g[p:p+101].decode()}\n+\n{'I'*101}\n")
        f.write(f"@dup0\n{g[0:101].decode()}\n+\n{'I'*101}\n")
    assert cli.main(["index", str(d / "ref.fa")]) == 0
    return d


@pytest.mark.parametrize("remove", [False, True], ids=["mark", "remove"])
def test_sort_marks_or_removes_duplicates(dupdir, remove):
    out = dupdir / f"out_{remove}.bam"
    assert cli.main(["mem", "--device", "cpu", "--sort", "--num-buckets",
                     "4", "--temp-dir", str(dupdir / f"td_{remove}"),
                     "-o", str(out)]
                    + (["--remove-duplicates"] if remove else [])
                    + [str(dupdir / "ref.fa"), str(dupdir / "se.fq")]) == 0
    _, _, recs = bam.decode_bam_records(gzip.decompress(out.read_bytes()))
    dups = [r["qname"] for r in recs if r["flag"] & 0x400]
    if remove:
        assert len(recs) == 6 and not dups
        assert "dup0" not in {r["qname"] for r in recs}
    else:
        assert len(recs) == 7 and dups == ["dup0"]
    keys = [sort.sort_key_from_raw(r["raw"]) for r in recs]
    assert keys == sorted(keys)


def test_sort_without_output_exits_nonzero(workdir):
    with pytest.raises(SystemExit) as e:
        cli.main(["mem", "--device", "cpu", "--sort",
                  str(workdir / "ref.fa"), str(workdir / "se.fq")])
    assert e.value.code not in (0, None)
