"""BENCHMARK.json keeps to the benchmark's contract, every cell resolves
to files, and a cell, configuration, mix or metric is added with files
and entries alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_units(bench):
    assert set(bench) == KEYS
    assert len(json.dumps(bench)) <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in bench["paths"])
    assert 1 <= len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        names += [w["name"], w["config"], w["traffic"]]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert _line(m["layer"])
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end"):
        ns = [x["name"] for x in bench[group]]
        assert len(ns) == len(set(ns))
    ms = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(ms) == len(set(ms))
    assert "setup_s" in ms


def test_cells_resolve(bench):
    import run
    e2e = {m["name"] for m in bench["end_to_end"]}
    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    pairs = set()
    for w in bench["workloads"]:
        cell, config, mix, limits = run.resolve(bench, w["name"])
        assert config["name"] == w["config"]
        assert (BENCH.parent / configs[w["config"]]["file"]).exists()
        assert configs[w["config"]]["reduced"] == config["reduced"]
        assert set(limits) >= {"missing", "record_faults", "suboptimal_reads"}
        used.add(w["config"])
        pairs.add((w["config"], w["traffic"]))
        reported = [m for m in bench["per_layer"]
                    if w["name"] in m.get("workloads", [w["name"]])]
        assert reported and all(m["moves"] in e2e for m in reported)
    assert used == set(configs)
    assert len(pairs) == len(bench["workloads"])
    for m in bench["per_layer"]:
        assert callable(run.reader(m["name"]))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in bench["workloads"]}


def test_configs_at_full_length(bench):
    import run
    lengths = {"ecoli_k12": 4_641_652, "dm6": 143_726_002}
    for c in bench["configs"]:
        cfg = run.load_json(ROOT / c["file"])
        assert cfg["length"] == lengths[c["name"]]
        assert cfg["reduced"] == [] and cfg["assumed"]


def _copy_tree(tmp_path):
    dst = tmp_path / "tree"
    (dst / "benchmark").mkdir(parents=True)
    for p in BENCH.iterdir():
        if p.name in (".cache", "__pycache__", "tests"):
            continue
        if p.is_dir():
            shutil.copytree(p, dst / "benchmark" / p.name)
        else:
            shutil.copy(p, dst / "benchmark" / p.name)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_new_cell_config_mix_metric_by_files_alone(tmp_path):
    """A dummy configuration, mix, cell and per-layer metric added to a
    copy of the tree as new files and BENCHMARK.json entries: the
    harness in the copy resolves and reads them with no code changed."""
    dst = _copy_tree(tmp_path)
    b = dst / "benchmark"
    cfg = json.loads((b / "configs" / "ecoli_k12.json").read_text())
    cfg.update(name="dummy_cfg", length=123_456)
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "se151.json").read_text())
    mix.update(read_len=101)
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (b / "limits" / "dummy.cell.json").write_text(json.dumps(
        {"missing": 0, "record_faults": 0, "suboptimal_reads": 5}))
    (b / "metrics" / "dummy.batches.py").write_text(
        "def read(rec):\n    return rec['batches'] or None\n")
    spec = json.loads((dst / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="dummy_cfg", source="test",
                                file="benchmark/configs/dummy_cfg.json",
                                reduced=[], why="test"))
    spec["workloads"].append(dict(name="dummy.cell", config="dummy_cfg",
                                  traffic="dummy_mix", chips=1, why="test"))
    spec["per_layer"].append(dict(name="dummy.batches", unit="batches",
                                  better="higher", source="host_clock",
                                  layer="io", moves="reads_per_s",
                                  workloads=["dummy.cell"]))
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    probe = (
        "import json, sys; sys.path.insert(0, 'benchmark'); import run\n"
        "bench = run.load_json(run.ROOT / 'BENCHMARK.json')\n"
        "cell, cfg, mix, lim = run.resolve(bench, 'dummy.cell')\n"
        "v = run.reader('dummy.batches')({'batches': 7})\n"
        "print(json.dumps([cfg['length'], mix['read_len'],"
        " lim['suboptimal_reads'], v, str(run.HERE)]))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=dst,
                         capture_output=True, text=True, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got[:4] == [123_456, 101, 5, 7]
    assert got[4] == str(b)


def test_fails_without_a_card_or_the_program(tmp_path):
    """No result line where there is no CUDA device, nor in a directory
    that holds only BENCHMARK.json and the benchmark's files."""
    for cwd in (ROOT, _copy_tree(tmp_path)):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", "dm6.pe151",
             "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=cwd,
            capture_output=True, text=True, timeout=300,
            env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert p.returncode != 0
        assert not p.stdout.strip()


@pytest.mark.parametrize("name", ["io.parse_share", "device.idle_share"])
def test_metric_reader_files_named_after_metrics(bench, name):
    assert (BENCH / "metrics" / f"{name}.py").exists()
    assert name in {m["name"] for m in bench["per_layer"]}


def test_genomes_carry_their_published_repeats():
    """E. coli's repeat classes cover about 2.2% of its genome, as
    annotated; dm6's (at a hundredth of its length, classes in
    proportion) cover about a tenth; the same spec gives the same
    genome."""
    import numpy as np
    import genome
    import run
    from conftest import tiny_genome
    cfg = run.load_json(BENCH / "configs" / "ecoli_k12.json")
    g, spans = genome.make_genome(cfg["length"], cfg["genome"])
    assert 0.018 < genome.repeat_share(spans, len(g)) < 0.026
    assert len(spans) == sum(f["copies"] for f in cfg["genome"]["repeats"])
    g2, _ = genome.make_genome(cfg["length"], cfg["genome"])
    assert np.array_equal(g, g2)
    fly = run.load_json(BENCH / "configs" / "dm6.json")
    n = fly["length"] // 100
    small = tiny_genome(fly["genome"], n, fly["length"])
    g, spans = genome.make_genome(n, small)
    assert 0.06 < genome.repeat_share(spans, n) < 0.2
    # most copies lie in the heterochromatin, the last 0.165 of it
    assert (spans[:, 0] >= int(0.835 * n)).mean() > 0.6
