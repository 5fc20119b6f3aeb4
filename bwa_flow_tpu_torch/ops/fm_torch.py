"""Device FM-index primitives in PyTorch — batched occ / extend / SA lookup.

Port of bwa_flow_tpu/ops/fm_jax.py. The index lives on the device in the
block layout of index/fmindex.py (one 32-byte int32 row per 64 symbols:
4 counts + 4 packed words), and every primitive is vectorized over a
batch of probes:

  - one occ probe  = one row gather + popcount of xor-matched 2-bit slots
  - bwt_extend     = two all-symbol probes (k-1, k-1+s) + the
    bidirectional chain (bwa/bwt.c:262-275)
  - sa lookup      = a dense-SA gather, or a batched LF walk to a sampled
    row with an iteration budget and an overflow mask (bwa/bwt.c:86-96);
    on a card each sa_batch call is one launch of the sa_walk kernel
    (ops/fm_cuda.py, csrc/sa_walk.cu), on the CPU its plain version

torch has no unsigned 32-bit shifts or popcount: the packed words widen
to int64 (masked to 32 bits) and a SWAR popcount counts the slots.
Coordinates are int64 ("wide"), or int32 on a narrow view of a sub-2^31
genome; the dtype of the probe tensor and of ``L2`` carries through.

Every read of the device from the host goes through a `fetch` argument
(to_host by default), so the batch aligner can put its hang watchdog
(pipeline/batch.py, BatchAligner.fetch) in front of each. On a card
sa_batch reads nothing: only the plain walk on the CPU reads its stop
condition.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..index.fmindex import BLOCK, FMIndex
from ..index.io import wide
from . import fm_cuda

_M32 = 0xFFFFFFFF
_PAIR = 0x55555555


def to_host(t) -> np.ndarray:
    """Device -> host copy (blocks until the producing work is done): the
    default `fetch` of every function of the port that reads the
    device."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@dataclasses.dataclass
class DeviceFM:
    """Device-resident FM index (torch tensors on one device).

    Mirrors FMIndex: ``seq_len``, ``primary``, ``l_pac``, ``sa_intv`` are
    Python ints; ``L2`` is a [5] tensor in the coordinate dtype (int64,
    or int32 on a narrow view); ``fm_blocks`` int32[n_blocks, 8]; ``sa``
    the sampled SA (int32 for sub-2^31 genomes, else int64);
    ``pac_words`` packs the forward-strand 2-bit reference 16 symbols per
    int32 (byte b of word w = pac[4w+b]); ``sa_dense`` the full int32 SA
    of a small genome (None for large ones)."""

    seq_len: int
    primary: int
    L2: torch.Tensor
    fm_blocks: torch.Tensor
    sa_intv: int
    sa: torch.Tensor
    pac_words: torch.Tensor
    l_pac: int
    sa_dense: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self.fm_blocks.device

    @classmethod
    def from_host(cls, fm: FMIndex, device, dense_sa_max: int | None = None,
                  fetch=to_host) -> "DeviceFM":
        """Upload `fm`; a sub-2^31 genome no longer than dense_sa_max
        (BWA_TPU_DENSE_SA_MAX, 2^28 by default) also gets its dense SA,
        walked on the device (`fetch` reads the walks' results)."""
        device = torch.device(device)
        if fm.bns is not None:
            pac = fm.bns.pac
            n_words = (len(pac) + 3) // 4
            padded = np.zeros(n_words * 4, dtype=np.uint8)
            padded[:len(pac)] = pac
            pw = padded.reshape(-1, 4).astype(np.uint32)
            pac_words = (pw[:, 0] | (pw[:, 1] << 8) | (pw[:, 2] << 16)
                         | (pw[:, 3] << 24)).astype(np.uint32)
            l_pac = int(fm.bns.l_pac)
        else:
            pac_words = np.zeros(1, dtype=np.uint32)
            l_pac = 0
        sa_dt = np.int32 if 0 < fm.seq_len and not wide(fm.seq_len) \
            else np.int64
        dfm = cls(
            seq_len=int(fm.seq_len), primary=int(fm.primary),
            L2=torch.as_tensor(np.asarray(fm.L2, np.int64), device=device),
            fm_blocks=torch.as_tensor(np.array(fm.fm_blocks, np.int32),
                                      device=device),
            sa_intv=int(fm.sa_intv),
            sa=torch.as_tensor(np.array(fm.sa, sa_dt), device=device),
            pac_words=torch.as_tensor(pac_words.view(np.int32),
                                      device=device),
            l_pac=l_pac)
        if dense_sa_max is None:
            dense_sa_max = int(os.environ.get("BWA_TPU_DENSE_SA_MAX",
                                              1 << 28))
        if 0 < fm.seq_len <= min(dense_sa_max, (1 << 31) - 1):
            dense = _densify_sa(dfm, fm, fetch)
            dfm.sa_dense = torch.as_tensor(np.array(dense, np.int32),
                                           device=device)
        return dfm

    @classmethod
    def from_numpy(cls, leaves, device) -> "DeviceFM":
        """State carry-over: build the index from the leaves of
        bwa_flow_tpu's DeviceFM (a mapping of field name -> numpy array,
        e.g. ``{k: np.asarray(v) for k, v in dfm._asdict().items()}``),
        so both packages compute on the same device arrays."""
        device = torch.device(device)

        def t(name, dt=None):
            a = np.asarray(leaves[name])
            return torch.as_tensor(np.array(a, dtype=dt), device=device)

        dense = leaves.get("sa_dense")
        return cls(
            seq_len=int(leaves["seq_len"]), primary=int(leaves["primary"]),
            L2=t("L2", np.int64), fm_blocks=t("fm_blocks", np.int32),
            sa_intv=int(leaves["sa_intv"]), sa=t("sa"),
            pac_words=t("pac_words", np.int32), l_pac=int(leaves["l_pac"]),
            sa_dense=None if dense is None else t("sa_dense", np.int32))

    def replica(self, device) -> "DeviceFM":
        """A copy of the index in memory of its own on `device` (also
        when it is this index's device): the per-device replica of a
        sharded run, which the JAX package makes with device_put."""
        device = torch.device(device)
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device, copy=True)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    def narrow(self) -> "DeviceFM":
        """int32-coordinate view of a sub-2^31 index (the FM scalars the
        occ/extend chain touches become int32, so derived coordinates and
        counts stay int32). Callers guard seq_len < 2^31."""
        return dataclasses.replace(self, L2=self.L2.to(torch.int32))


def pac_sym_batch(dfm: DeviceFM, pos: torch.Tensor) -> torch.Tensor:
    """Reference base at forward-reverse coordinate pos -> int32 in
    [0, 3]. Positions >= l_pac read the reverse-complement strand
    (bwa/bntseq.c get_seq semantics); out-of-range positions clamp."""
    two_l = dfm.l_pac * 2
    posc = pos.clamp(0, two_l - 1)
    is_rev = posc >= dfm.l_pac
    fpos = torch.where(is_rev, two_l - 1 - posc, posc)
    word = dfm.pac_words[(fpos >> 4).long()].to(torch.int64) & _M32
    byte = (word >> (8 * ((fpos >> 2) & 3)).to(torch.int64)) & 0xFF
    sym = ((byte >> (6 - 2 * (fpos & 3)).to(torch.int64)) & 3).to(
        torch.int32)
    return torch.where(is_rev, 3 - sym, sym)


def _popcount32(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values holding 32-bit words."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _M32) >> 24


def _count_slots(words: torch.Tensor, c: torch.Tensor, within: torch.Tensor
                 ) -> torch.Tensor:
    """#matches of 2-bit symbol c among the first `within` symbols of a
    [..., 4]-word slab (16 symbols/word, first symbol in the top bits).

    words: int64[..., 4] (32-bit values); c: int[...] in [0, 3];
    within: int[...] in [0, 64]. Returns int32[...]."""
    pat = (c.to(torch.int64) * _PAIR)[..., None]
    x = ~(words ^ pat) & _M32
    hits = x & (x >> 1) & _PAIR     # one bit per matching symbol slot
    # symbols t=0..15 sit at bit pair (15-t)*2: the first n symbols of a
    # word are its top 2n bits
    ar = torch.arange(4, dtype=torch.int64, device=words.device) * 16
    n_w = (within[..., None].to(torch.int64) - ar).clamp(0, 16)
    keep = torch.where(n_w == 0, 0, ~((1 << (2 * (16 - n_w))) - 1) & _M32)
    return _popcount32(hits & keep).sum(-1).to(torch.int32)


def _row_words(dfm: DeviceFM, blk: torch.Tensor):
    """Gather fm block rows: (counts int32[..., 4], words int64[..., 4])."""
    rows = dfm.fm_blocks[blk]
    return rows[..., :4], rows[..., 4:8].to(torch.int64) & _M32


def _sel4(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """vals[..., idx] for a trailing axis of 4 (idx in [0, 4))."""
    return vals.gather(-1, idx.long().unsqueeze(-1)).squeeze(-1)


def occ_batch(dfm: DeviceFM, k: torch.Tensor, c: torch.Tensor
              ) -> torch.Tensor:
    """occ(k, c) for row coords k in [-1, seq_len] (bwa/bwt.c:107-129).
    Returns k's dtype."""
    dt = k.dtype
    at_end = k == dfm.seq_len
    at_neg = k == -1
    kk = k - (k >= dfm.primary).to(dt)
    kk = kk.clamp(0, dfm.seq_len - 1)
    blk = (kk // BLOCK).long()
    within = (kk % BLOCK).to(torch.int32) + 1
    counts, words = _row_words(dfm, blk)
    cc = c.clamp(0, 3)
    base = _sel4(counts, cc)
    L2 = dfm.L2.to(dt)
    l2c = L2[cc.long()]
    l2c1 = L2[cc.long() + 1]
    val = base.to(dt) + _count_slots(words, cc, within)
    end_val = l2c1 - l2c
    return torch.where(at_neg, 0, torch.where(at_end, end_val, val))


def occ4_batch(dfm: DeviceFM, k: torch.Tensor) -> torch.Tensor:
    """All-symbol occ at row coords k (bwa/bwt.c:169-186). Returns
    k's dtype [..., 4]."""
    dt = k.dtype
    at_end = (k == dfm.seq_len)[..., None]
    at_neg = (k == -1)[..., None]
    kk = k - (k >= dfm.primary).to(dt)
    kk = kk.clamp(0, dfm.seq_len - 1)
    blk = (kk // BLOCK).long()
    within = (kk % BLOCK).to(torch.int32) + 1
    counts, words = _row_words(dfm, blk)
    c4 = torch.arange(4, dtype=torch.int32, device=k.device)
    cnt = _count_slots(words[..., None, :], c4.expand(kk.shape + (4,)),
                       within[..., None])
    val = counts.to(dt) + cnt
    L2 = dfm.L2.to(dt)
    end_val = L2[1:5] - L2[0:4]
    return torch.where(at_neg, 0, torch.where(at_end, end_val, val))


def bwt_extend_batch(dfm: DeviceFM, ik: torch.Tensor, is_back: bool
                     ) -> torch.Tensor:
    """Bidirectional extension for a batch of intervals
    (bwa/bwt.c:262-275). ik: [..., 3] = (k, l, s). Returns [..., 4, 3]:
    row c = the interval after adding base c."""
    fwd = 0 if is_back else 1
    bwd = 1 - fwd
    x_f = ik[..., fwd]
    s = ik[..., 2]
    both = torch.stack([x_f - 1, x_f - 1 + s], dim=-1)
    occ2 = occ4_batch(dfm, both)                         # [..., 2, 4]
    tk = occ2[..., 0, :]
    tl = occ2[..., 1, :]
    ok_fwd = dfm.L2[:4].to(ik.dtype) + 1 + tk
    ok_s = tl - tk
    crosses = ((x_f <= dfm.primary) & (x_f + s - 1 >= dfm.primary)
               ).to(ik.dtype)
    b3 = ik[..., bwd] + crosses
    b2 = b3 + ok_s[..., 3]
    b1 = b2 + ok_s[..., 2]
    b0 = b1 + ok_s[..., 1]
    ok_bwd = torch.stack([b0, b1, b2, b3], dim=-1)
    cols = [None, None, ok_s]
    cols[fwd] = ok_fwd
    cols[bwd] = ok_bwd
    return torch.stack(cols, dim=-1)


def set_intv_batch(dfm: DeviceFM, c: torch.Tensor) -> torch.Tensor:
    """Initial single-base intervals (bwa/bwt.h:80). c: int in [0, 3].
    Returns [..., 3] in the index's coordinate dtype (dfm.L2's)."""
    cl = c.clamp(0, 3).long()
    L2 = dfm.L2
    l2c, l2c1, l2r = L2[cl], L2[cl + 1], L2[3 - cl]
    return torch.stack([l2c + 1, l2r + 1, l2c1 - l2c], dim=-1)


def bwt_b0_batch(dfm: DeviceFM, k: torch.Tensor) -> torch.Tensor:
    """Symbol at $-removed BWT position k (bwa/bwt.h:78). -> int32."""
    blk = (k // BLOCK).long()
    off = (k % BLOCK).to(torch.int32)
    words = dfm.fm_blocks[blk][..., 4:8].to(torch.int64) & _M32
    word = _sel4(words, off >> 4)
    shift = ((15 - (off & 15)) << 1).to(torch.int64)
    return ((word >> shift) & 3).to(torch.int32)


def _inv_psi_batch(dfm: DeviceFM, k: torch.Tensor) -> torch.Tensor:
    """LF-mapping step (bwa/bwt.c:53-59), fused single-gather form: for
    k != primary the symbol position k - (k > primary) equals the occ row
    k - (k >= primary), so ONE fm_blocks row yields both the BWT symbol c
    and occ(k, c). k == seq_len fuses too (the whole final row counts the
    L2 end total); k == primary maps to 0 as in bwa."""
    kk = k - (k >= dfm.primary).to(k.dtype)
    kk = kk.clamp(0, dfm.seq_len - 1)
    blk = (kk // BLOCK).long()
    off = (kk % BLOCK).to(torch.int32)
    counts, words = _row_words(dfm, blk)
    word = _sel4(words, off >> 4)
    shift = ((15 - (off & 15)) << 1).to(torch.int64)
    c = ((word >> shift) & 3).to(torch.int32)
    base = _sel4(counts, c)
    l2 = dfm.L2.to(k.dtype)[c.long()]
    cnt = _count_slots(words, c, off + 1)
    lf = l2 + base.to(k.dtype) + cnt
    return torch.where(k == dfm.primary, 0, lf)


def _lf_walk_plain(dfm: DeviceFM, mask: int, kk, steps, T: int,
                   check: int = 8, fetch=to_host):
    """T LF steps over every lane (JAX's _lf_walk_fixed and the
    while_loops' bodies); dead lanes (sampled rows) hold. Stops early
    once every lane is dead (read with `fetch` every `check` steps; the
    remaining steps would change nothing). Returns (kk, steps): new
    tensors, or the inputs when no lane walked."""
    for it in range(T):
        walking = (kk & mask) != 0
        if it % check == 0 and not fetch(walking.any()):
            break
        kk = torch.where(walking, _inv_psi_batch(dfm, kk), kk)
        steps = steps + walking.to(steps.dtype)
    return kk, steps


def _sa_walk_plain(dfm: DeviceFM, k: torch.Tensor, max_iters: int,
                   intv: int, fetch=to_host
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the sa_walk kernel: sa_batch's LF walk as the
    JAX package runs it (fm_jax.sa_batch), step by step. PHASED with
    `intv` and B >= 64: 2*intv steps over all lanes; the first B/4 live
    lanes in lane order compacted into a pool (compact_pool: lane 0 in
    every slot it leaves empty, so those copies walk as lane 0 does) for
    4*intv more; the first B/16 still live, pool-dropped lanes included,
    into a pool that walks to max_iters; each pool scattered back.
    Otherwise one walk to max_iters. Returns (sa int64[B], overflow
    bool[B]); a lane still live at the end (budget or pool exhausted)
    overflows. The stop checks read the card through `fetch`."""
    mask = dfm.sa_intv - 1
    B = k.shape[0]
    phased = intv > 0 and B >= 64
    kk, steps = _lf_walk_plain(dfm, mask, k, torch.zeros_like(k),
                               2 * intv if phased else max_iters,
                               8 if phased else 1, fetch)
    if phased:
        def compact_pool(CAP):
            """The pool's lanes: the first CAP live lanes in lane order,
            then lane 0 in every slot left."""
            live = (kk & mask) != 0
            l32 = live.to(torch.int32)
            rank = torch.cumsum(l32, 0, dtype=torch.int32) - l32
            dst = torch.where(live & (rank < CAP), rank, CAP).long()
            src = torch.zeros(CAP + 1, dtype=torch.int64, device=k.device)
            src[dst] = torch.arange(B, dtype=torch.int64, device=k.device)
            return src[:CAP]

        # survivors (~e^-2) -> B/4 pool, 4*intv fixed steps
        src = compact_pool(B // 4)
        kp, sp = _lf_walk_plain(dfm, mask, kk[src], steps[src], 4 * intv,
                                fetch=fetch)
        kk, steps = kk.index_put((src,), kp), steps.index_put((src,), sp)
        # stragglers (~e^-6) -> B/16 pool, walk to the budget
        src = compact_pool(B // 16)
        kp, sp = _lf_walk_plain(dfm, mask, kk[src], steps[src], max_iters,
                                1, fetch)
        kk, steps = kk.index_put((src,), kp), steps.index_put((src,), sp)
    overflow = (kk & mask) != 0
    idx = (kk // dfm.sa_intv).clamp(0, dfm.sa.shape[0] - 1).long()
    return (steps + dfm.sa[idx]).to(torch.int64), overflow


def _on_card(t: torch.Tensor, who: str) -> bool:
    """True for a CUDA tensor (its kernel runs), False for a CPU one (the
    plain version runs); any other device raises. The dispatch of the LF
    walk here and of the seed machines' wrappers in smem_torch."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{who}: tensors on {t.device}: expected cuda (the "
                     "kernel) or cpu (the plain version)")


def sa_batch(dfm: DeviceFM, k: torch.Tensor, max_iters: int = 256,
             intv: int = 0, fetch=to_host
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Suffix-array values (bwa/bwt.c:86-96). k: int64[B] (or int32 on a
    narrow view). With a dense SA this is one gather. Otherwise an LF
    walk; with `intv` (the sampled interval) it is PHASED: 2*intv steps
    over all lanes, the first B/4 survivors in lane order 4*intv more,
    then the first B/16 still live to max_iters (_sa_walk_plain). Returns
    (sa int64[B], overflow bool[B]); overflow lanes (budget or pool
    exhausted) are redone by the caller on the host. On a card the walk
    is one launch of the sa_walk kernel (fm_cuda.sa_walk), which reads
    nothing back to the host; on the CPU the plain walk reads its stop
    condition through `fetch`. k is not written."""
    if dfm.sa_dense is not None:
        idx = k.clamp(0, dfm.sa_dense.shape[0] - 1).long()
        return (dfm.sa_dense[idx].to(torch.int64),
                torch.zeros(k.shape, dtype=torch.bool, device=k.device))
    if not _on_card(k, "sa_batch"):
        return _sa_walk_plain(dfm, k, max_iters, intv, fetch)
    return fm_cuda.sa_walk(dfm, k, max_iters, intv)


def _densify_sa(dfm: DeviceFM, fm: FMIndex, fetch=to_host) -> np.ndarray:
    """Full int32 SA of a sub-2^31 genome, computed once at upload time
    by LF-walking every row on the device in fixed-size chunks (SA
    lookup then becomes one gather). Cached beside the index as
    <prefix>.tpu.sadense.npy when the index was loaded from disk (the
    same file bwa_flow_tpu writes). Stragglers past the budget re-walk
    in one deep call; the rest fall back to the host bwt_sa."""
    prefix = getattr(fm, "cache_prefix", None)
    cachef = f"{prefix}.tpu.sadense.npy" if prefix else None
    if cachef and os.path.exists(cachef):
        try:
            dense = np.load(cachef, mmap_mode="r")
            if dense.shape[0] == int(fm.seq_len) + 1:
                return dense
        except (OSError, ValueError):
            pass
    from . import fm as fmops
    dev = dfm.device
    # FM interval rows span [0, seq_len] INCLUSIVE (bwt_sa accepts
    # k == seq_len), so densify one row past seq_len
    n = int(fm.seq_len) + 1
    # chunk: 2^20 rows, or the power of two covering a small genome (the
    # values are exact whatever the chunking: overflows are redone)
    CH = 4096
    while CH < min(n, 1 << 20):
        CH <<= 1
    out = np.empty(n, np.int32)
    for off in range(0, n, CH):
        m = min(CH, n - off)
        pad = torch.zeros(CH, dtype=torch.int64, device=dev)
        pad[:m] = torch.arange(off, off + m, dtype=torch.int64, device=dev)
        vals_t, ovf_t = sa_batch(dfm, pad, 1024, int(fm.sa_intv), fetch)
        vals = fetch(vals_t[:m].to(torch.int32))
        ovf = np.nonzero(fetch(ovf_t[:m]))[0]
        if len(ovf) > 256:
            # one deep device redo for the straggler tail
            W = 1024
            while W < len(ovf):
                W <<= 1
            pad2 = np.zeros(W, dtype=np.int64)
            pad2[:len(ovf)] = off + ovf
            v2, o2 = sa_batch(dfm, torch.as_tensor(pad2, device=dev),
                              16384, 0, fetch)
            vals[ovf] = fetch(v2[:len(ovf)]).astype(np.int32)
            ovf = ovf[fetch(o2[:len(ovf)])]
        for j in ovf:
            vals[j] = fmops.bwt_sa(fm, off + int(j))
        out[off:off + m] = vals
    if cachef:
        try:
            np.save(cachef, out)
        except OSError:
            pass
    return out
