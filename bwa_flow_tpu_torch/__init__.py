"""bwa_flow_tpu_torch — BWA-MEM on PyTorch and CUDA.

The PyTorch counterpart of ``bwa_flow_tpu``: the same exact BWA-MEM
pipeline (device SMEM seeding with fused SA resolution, host chaining,
device seed-extension waves, host dedup/primary/SAM tail, markdup) with
the device half written as torch tensor code plus hand-written CUDA
kernels for the NVIDIA H100 (``csrc/``). It shares no code with the JAX
package: the host modules are its own copies.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` in Python, ``--device cpu`` on the CLI); on the CPU
every kernel is replaced by its plain PyTorch version.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None
                   ) -> torch.device:
    """The torch device an entry point runs on: ``cuda`` by default.
    Raises when CUDA is asked for and there is none — a run never moves
    to the CPU unless the caller asked for the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bwa_flow_tpu_torch: CUDA device requested but "
            "torch.cuda.is_available() is False (pass device='cpu' / "
            "--device cpu to run on the CPU)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
