"""Seed-occurrence enumeration shared by SA resolution and chaining.

mem_chain (bwa/bwamem.c) walks each seed interval's occurrences x0 + k
(every one when s <= max_occ, else max_occ of them at stride
s // max_occ). This module lays those probes out flat, read-major, so
the device resolves their SA values in one batch and the chain stage
reads them back by position.
"""

from __future__ import annotations

import numpy as np

from ..utils.opts import MemOpt


def sa_probe_layout(opt: MemOpt, all_intvs, build_owners: bool = True
                    ) -> tuple[np.ndarray, np.ndarray, list | None]:
    """Occurrence enumeration shared by SA resolution and chaining:
    (rows int64[NO] of interval coordinates x0+k, off int64[n+1] per-read
    boundaries, owners [(read, x0, k)] for the dict-based Python path).
    owners is skipped (None) when build_owners is False — its
    construction is the costly part of this pure-Python loop.

    Array-native IntvBatch inputs take a fully vectorized path."""
    from .smem import IntvBatch
    if isinstance(all_intvs, IntvBatch) and not build_owners:
        sv, x0, iv_off = all_intvs.sv, all_intvs.x0, all_intvs.iv_off
        mo = np.int64(opt.max_occ)
        over = sv > mo
        step = np.where(over, sv // np.maximum(mo, 1), 1)
        cnt = np.where(over, np.minimum(sv, step * mo)
                       // np.maximum(step, 1), sv)
        tot = np.zeros(len(sv) + 1, np.int64)
        np.cumsum(cnt, out=tot[1:])
        NO = int(tot[-1])
        # rows[j] = x0_i + (j - tot[i]) * step_i for j in intv i's range
        j = np.arange(NO, dtype=np.int64)
        i_of = np.repeat(np.arange(len(sv), dtype=np.int64), cnt)
        rows_v = x0[i_of] + (j - tot[i_of]) * step[i_of]
        return rows_v, tot[iv_off], None
    rows: list[int] = []
    owners: list[tuple[int, int, int]] | None = \
        [] if build_owners else None
    max_occ = opt.max_occ
    off = np.zeros(len(all_intvs) + 1, np.int64)
    for ridx, intvs in enumerate(all_intvs):
        for p in intvs:
            s_, x0 = p.s, p.x0
            if s_ > max_occ:
                step = s_ // max_occ
                ks = range(0, min(s_, step * max_occ), step)
            else:
                ks = range(s_)
            rows.extend(x0 + k for k in ks)
            if owners is not None:
                owners.extend((ridx, x0, k) for k in ks)
        off[ridx + 1] = len(rows)
    return np.asarray(rows, dtype=np.int64), off, owners
