"""The port's CLI (`bwa_flow_tpu_torch index|mem --device cpu`) against
`python -m bwa_flow_tpu` on the fixture of tests/test_cli.py: index files
byte-equal, mem SAM equal apart from @PG, --no-device equal too."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bwa_flow_tpu_torch import cli

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
    se, r2 = [], []
    for i in range(12):
        pos = int(rng.integers(0, 8000 - 420))
        read = bytearray(g[pos:pos + 101])
        if i % 3 == 0:              # a few substitutions
            j = int(rng.integers(0, 101))
            read[j] = b"ACGT"[(b"ACGT".index(read[j]) + 1) % 4]
        se.append((f"s{i}", read.decode()))
        r2.append((f"p{i}/2", g[pos + 300:pos + 401].translate(comp)[::-1]
                   .decode()))
    for name, recs in (("se.fq", se), ("r2.fq", r2)):
        with open(d / name, "w") as f:
            for n, s in recs:
                f.write(f"@{n}\n{s}\n+\n{'I' * len(s)}\n")
    jd = d / "jax"
    jd.mkdir()
    for name in ("ref.fa", "se.fq"):
        shutil.copy(d / name, jd / name)
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu",
               HOME=str(d))
    for args in (["index", "ref.fa"], ["mem", "-o", "se.sam", "ref.fa",
                                        "se.fq"]):
        r = subprocess.run([sys.executable, "-m", "bwa_flow_tpu"] + args,
                           capture_output=True, text=True, cwd=str(jd),
                           env=env, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
    assert cli.main(["index", str(d / "ref.fa")]) == 0
    return d


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


@pytest.mark.parametrize("extra", [["--sort"], ["--nprocs", "2"], ["PE"]])
def test_later_slice_options_exit_nonzero(workdir, extra):
    fq = [str(workdir / "se.fq")]
    if extra == ["PE"]:
        extra, fq = [], fq + [str(workdir / "r2.fq")]
    with pytest.raises(SystemExit) as e:
        cli.main(["mem", "--device", "cpu"] + extra
                 + [str(workdir / "ref.fa")] + fq)
    assert e.value.code not in (0, None)
