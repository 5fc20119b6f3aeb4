"""Nothing the harness imports, the port's modules it drives included,
has the top-level name jax, jaxlib, flax or bwa_flow_tpu (names compared
whole: bwa_flow_tpu_torch is the port)."""

import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "bwa_flow_tpu"}

PROBE = """
import sys
sys.path[:0] = ['benchmark', '.']
import run, reference, readgen, devtrace, genome, control, series
from bwa_flow_tpu_torch import cli, _build
from bwa_flow_tpu_torch.dedup.markdup import make_markdup_stage
from bwa_flow_tpu_torch.index.io import load_index
from bwa_flow_tpu_torch.index.build import build_index
from bwa_flow_tpu_torch.io.fastq import read_batches
from bwa_flow_tpu_torch.pipeline.dataflow import AlignPipeline
from bwa_flow_tpu_torch.utils.trace import GLOBAL
import torch.profiler
print(' '.join(sorted({m.split('.', 1)[0] for m in sys.modules})))
"""


def test_no_jax_in_the_harness_or_what_it_drives():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    tops = set(out.stdout.split())
    assert "bwa_flow_tpu_torch" in tops and "run" in tops
    assert not tops & FORBIDDEN


def test_forbidden_check_compares_whole_names(monkeypatch):
    import run
    monkeypatch.setitem(sys.modules, "bwa_flow_tpu_torch_x", sys)
    assert "bwa_flow_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib" in run.forbidden_modules()
