"""Golden (NumPy) Smith-Waterman kernels with exact bwa ksw semantics.

Integer-exact reimplementations of:
  - ksw_extend2 (bwa/ksw.c:380-479): banded local extension with z-drop,
    end-bonus band caps, to-end score; THE hot kernel the Pallas TPU
    implementation is diffed against.
  - ksw_global2 (bwa/ksw.c:504-606): banded global alignment + traceback
    CIGAR.
  - ksw_align2 / ksw_u8 / ksw_i16 (bwa/ksw.c:111-365): striped local SW with
    second-best tracking, emulated in full precision (the striped u8/i16
    arithmetic reduces to the plain recurrence; the 255 cap and endsc break
    are reproduced).

Rows are NumPy-vectorized; the F dependency is a decayed prefix max (F
derives from M only, not H, per bwa's recurrence) so no lazy-F is needed.

ksw_extend2 and ksw_global2 run the native host kernels
(csrc/host/_native.cpp, ksw_impl.h: the same semantics, built at first
use), as the JAX package's do when its extensions are built;
ksw_extend2_py and ksw_global2_py are the NumPy versions, run only when
called by name. ksw_align2 (mate rescue) stays NumPy, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import _build

KSW_XBYTE = 0x10000
KSW_XSTOP = 0x20000
KSW_XSUBO = 0x40000
KSW_XSTART = 0x80000

MINUS_INF = -0x40000000

_NEG = np.iinfo(np.int64).min // 4


def _decayed_prefix_max(t: np.ndarray, gape: int, init) -> np.ndarray:
    """Vectorized F-scan: F[0] = init; F[j] = max(F[j-1] - gape, t[j-1]).

    Unrolls to F[j] = max(init - j*gape, max_{k<j}(t[k] - (j-1-k)*gape)).
    Intermediate 0-floors in the C code are no-ops whenever t >= 0 (the
    k=j-1 term already dominates)."""
    n = len(t)
    idx = np.arange(n, dtype=np.int64)
    run = np.maximum.accumulate(t + idx * gape)
    f = np.empty(n, dtype=np.int64)
    f[0] = init
    if n > 1:
        f[1:] = np.maximum(run[:-1] - idx[:-1] * gape,
                           init - idx[1:] * gape)
    return f


def ksw_extend2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
                mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                e_ins: int, w: int, end_bonus: int, zdrop: int, h0: int
                ) -> tuple[int, int, int, int, int, int]:
    """Returns (score, qle, tle, gtle, gscore, max_off), from the native
    kernel."""
    assert h0 > 0
    return _build.host_module("_native").ksw_extend2(
        int(qlen), np.ascontiguousarray(query[:qlen], dtype=np.uint8),
        int(tlen), np.ascontiguousarray(target[:tlen], dtype=np.uint8),
        np.ascontiguousarray(mat, dtype=np.int8), mat.shape[0], o_del,
        e_del, o_ins, e_ins, w, end_bonus, zdrop, h0)


def ksw_extend2_py(qlen: int, query: np.ndarray, tlen: int,
                   target: np.ndarray, mat: np.ndarray, o_del: int,
                   e_del: int, o_ins: int, e_ins: int, w: int,
                   end_bonus: int, zdrop: int, h0: int
                   ) -> tuple[int, int, int, int, int, int]:
    """Pure-NumPy oracle (always available, never dispatches)."""
    assert h0 > 0
    m = mat.shape[0]
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    qp = mat[:, query[:qlen].astype(np.intp)].astype(np.int64)  # [m, qlen]
    # eh arrays: ehH[j] = H(i-1, j-1); ehE[j] = E(i, j)
    ehH = np.zeros(qlen + 1, dtype=np.int64)
    ehE = np.zeros(qlen + 1, dtype=np.int64)
    ehH[0] = h0
    ehH[1] = h0 - oe_ins if h0 > oe_ins else 0
    j = 2
    while j <= qlen and ehH[j - 1] > e_ins:
        ehH[j] = ehH[j - 1] - e_ins
        j += 1
    # adjust w if too large (bwa/ksw.c:399-407)
    max_sc = int(mat.max())
    max_ins = int((qlen * max_sc + end_bonus - o_ins) / e_ins + 1.0)
    w = min(w, max(max_ins, 1))
    max_del = int((qlen * max_sc + end_bonus - o_del) / e_del + 1.0)
    w = min(w, max(max_del, 1))

    maxv = h0
    max_i = max_j = -1
    max_ie = -1
    gscore = -1
    max_off = 0
    beg, end = 0, qlen
    for i in range(tlen):
        q = qp[int(target[i])]
        if beg < i - w:
            beg = i - w
        if end > i + w + 1:
            end = i + w + 1
        if end > qlen:
            end = qlen
        if beg == 0:
            h1_init = h0 - (o_del + e_del * (i + 1))
            if h1_init < 0:
                h1_init = 0
        else:
            h1_init = 0
        if beg < end:
            sl = slice(beg, end)
            Hd = ehH[sl].copy()          # H(i-1, j-1) for j in band
            Ein = ehE[sl].copy()         # E(i, j)
            M = np.where(Hd != 0, Hd + q[sl], 0)
            T_ins = np.maximum(M - oe_ins, 0)
            F = _decayed_prefix_max(T_ins, e_ins, 0)
            H = np.maximum(np.maximum(M, Ein), F)
            Eout = np.maximum(np.maximum(M - oe_del, 0), Ein - e_del)
            # write back: ehH[j] = H(i,j-1) for j in (beg,end]; ehH[beg]=h1_init
            ehH[beg] = h1_init
            ehH[beg + 1:end + 1] = H
            ehE[sl] = Eout
            ehE[end] = 0
            h1 = int(H[-1])
            # row max and its last position
            mrow = int(H.max())
            if mrow > 0:
                mj = beg + int(np.nonzero(H == mrow)[0][-1])
            else:
                mj = beg + len(H) - 1  # all zeros: mj = last j (m stays 0)
            j_after = end
        else:
            # collapsed band: the reference still runs the row — the inner
            # loop is empty but eh[end]/gscore bookkeeping happens, then
            # m==0 breaks (ksw.c:451-456; no beg>=end shortcut exists)
            ehH[end] = h1 = h1_init
            ehE[end] = 0
            mrow, mj = 0, -1
            j_after = beg
        if j_after == qlen:
            if h1 >= gscore:
                max_ie = i
            gscore = max(gscore, h1)
        if mrow == 0:
            break
        if mrow > maxv:
            maxv, max_i, max_j = mrow, i, mj
            max_off = max(max_off, abs(mj - i))
        elif zdrop > 0:
            if i - max_i > mj - max_j:
                if maxv - mrow - ((i - max_i) - (mj - max_j)) * e_del > zdrop:
                    break
            else:
                if maxv - mrow - ((mj - max_j) - (i - max_i)) * e_ins > zdrop:
                    break
        # shrink the band (scan over ehH[j]=H(i,j-1), ehE[j]=E(i+1,j))
        j = beg
        while j < end and ehH[j] == 0 and ehE[j] == 0:
            j += 1
        beg = j
        j = end
        while j >= beg and ehH[j] == 0 and ehE[j] == 0:
            j -= 1
        end = min(j + 2, qlen)
    return maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off


def ksw_global2(qlen: int, query: np.ndarray, tlen: int, target: np.ndarray,
                mat: np.ndarray, o_del: int, e_del: int, o_ins: int,
                e_ins: int, w: int, want_cigar: bool = True
                ) -> tuple[int, list[tuple[int, int]]]:
    """Banded global alignment. Returns (score, cigar) with cigar as
    [(op, len)] (op: 0=M 1=I 2=D), from the native kernel."""
    return _build.host_module("_native").ksw_global2(
        int(qlen), np.ascontiguousarray(query[:qlen], dtype=np.uint8),
        int(tlen), np.ascontiguousarray(target[:tlen], dtype=np.uint8),
        np.ascontiguousarray(mat, dtype=np.int8), mat.shape[0], o_del,
        e_del, o_ins, e_ins, w, bool(want_cigar))


def ksw_global2_py(qlen: int, query: np.ndarray, tlen: int,
                   target: np.ndarray, mat: np.ndarray, o_del: int,
                   e_del: int, o_ins: int, e_ins: int, w: int,
                   want_cigar: bool = True) -> tuple[int, list]:
    """Pure-NumPy oracle (always available, never dispatches)."""
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    n_col = min(qlen, 2 * w + 1)
    qp = mat[:, query[:qlen].astype(np.intp)].astype(np.int64)
    ehH = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    ehE = np.full(qlen + 1, MINUS_INF, dtype=np.int64)
    ehH[0] = 0
    j = 1
    while j <= qlen and j <= w:
        ehH[j] = -(o_ins + e_ins * j)
        j += 1
    z = np.zeros((tlen, n_col), dtype=np.uint8) if want_cigar else None
    for i in range(tlen):
        q = qp[int(target[i])]
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        h1_init = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        sl = slice(beg, end)
        Hd = ehH[sl].copy()
        Ein = ehE[sl].copy()
        M = Hd + q[sl]
        # F recurrence: F(beg) = MINUS_INF; F(j+1) = max(M(j)-oe_ins, F(j)-e_ins)
        F = _decayed_prefix_max(M - oe_ins, e_ins, MINUS_INF)
        d = np.where(M >= Ein, 0, 1).astype(np.uint8)
        H = np.maximum(M, Ein)
        d = np.where(H >= F, d, 2).astype(np.uint8)
        H = np.maximum(H, F)
        t_del = M - oe_del
        e_dec = Ein - e_del
        d |= np.where(e_dec > t_del, 1 << 2, 0).astype(np.uint8)
        Eout = np.maximum(e_dec, t_del)
        t_ins = M - oe_ins
        f_dec = F - e_ins
        d |= np.where(f_dec > t_ins, 2 << 4, 0).astype(np.uint8)
        if want_cigar:
            z[i, :end - beg] = d
        ehH[beg] = h1_init
        ehH[beg + 1:end + 1] = H
        ehE[sl] = Eout
        ehE[end] = MINUS_INF
    score = int(ehH[qlen])
    cigar: list[tuple[int, int]] = []
    if want_cigar:
        def push(op, ln):
            if cigar and cigar[-1][0] == op:
                cigar[-1] = (op, cigar[-1][1] + ln)
            else:
                cigar.append((op, ln))
        i = tlen - 1
        k = min(i + w + 1, qlen) - 1
        which = 0
        while i >= 0 and k >= 0:
            which = (int(z[i, k - max(i - w, 0)]) >> (which << 1)) & 3
            if which == 0:
                push(0, 1)
                i -= 1
                k -= 1
            elif which == 1:
                push(2, 1)
                i -= 1
            else:
                push(1, 1)
                k -= 1
        if i >= 0:
            push(2, i + 1)
        if k >= 0:
            push(1, k + 1)
        cigar.reverse()
    return score, cigar


@dataclasses.dataclass
class KswResult:
    score: int = 0
    te: int = -1
    qe: int = -1
    score2: int = -1
    te2: int = -1
    tb: int = -1
    qb: int = -1


def _ksw_local(qlen, query, tlen, target, mat, o_del, e_del, o_ins, e_ins,
               xtra, byte_mode) -> KswResult:
    """ksw_u8/ksw_i16 emulation in exact integers (bwa/ksw.c:111-334)."""
    minsc = (xtra & 0xFFFF) if (xtra & KSW_XSUBO) else 0x10000
    endsc = (xtra & 0xFFFF) if (xtra & KSW_XSTOP) else 0x10000
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    shift = -int(mat.min()) if byte_mode else 0
    qp = mat[:, query[:qlen].astype(np.intp)].astype(np.int64)
    H = np.zeros(qlen, dtype=np.int64)
    E = np.zeros(qlen, dtype=np.int64)
    Hmax = np.zeros(qlen, dtype=np.int64)
    gmax, te = 0, -1
    b: list[list[int]] = []  # [imax, i] runs
    r = KswResult()
    for i in range(tlen):
        q = qp[int(target[i])]
        Hd = np.empty(qlen, dtype=np.int64)  # H(i-1, j-1)
        Hd[0] = 0
        Hd[1:] = H[:-1]
        M = np.maximum(Hd + q, 0)  # u8: saturating floor at 0; i16: max w/ e,f>=0
        # Unlike ksw_extend2, E/F here derive from H (post-max), so iterate
        # the lazy-F fixpoint (Farrar's trick, converges to the exact
        # recurrence; bwa/ksw.c:177-188).
        Hn = np.maximum(M, E)
        while True:
            T_ins = np.maximum(Hn - oe_ins, 0)
            F = _decayed_prefix_max(T_ins, e_ins, 0)
            Hn2 = np.maximum(Hn, F)
            if (Hn2 == Hn).all():
                break
            Hn = Hn2
        E = np.maximum(np.maximum(Hn - oe_del, 0),
                       np.maximum(E - e_del, 0))
        H = Hn
        imax = int(H.max()) if qlen else 0
        if imax >= minsc:
            if not b or b[-1][1] + 1 != i:
                b.append([imax, i])
            elif b[-1][0] < imax:
                b[-1] = [imax, i]
        if imax > gmax:
            gmax, te = imax, i
            Hmax[:] = H
            if (byte_mode and gmax + shift >= 255) or gmax >= endsc:
                break
    r.score = gmax if not (byte_mode and gmax + shift >= 255) else 255
    r.te = te
    if r.score != 255 or not byte_mode:
        # qe: smallest query position attaining the row max at te
        if te >= 0:
            mx = int(Hmax.max())
            r.qe = int(np.nonzero(Hmax == mx)[0][0])
        if b:
            max_sc = int(mat.max())
            rad = (r.score + max_sc - 1) // max_sc
            low, high = te - rad, te + rad
            for imax, e in b:
                if (e < low or e > high) and imax > r.score2:
                    r.score2, r.te2 = imax, e
    return r


def ksw_align2(qlen, query, tlen, target, mat, o_del, e_del, o_ins, e_ins,
               xtra) -> KswResult:
    byte_mode = bool(xtra & KSW_XBYTE)
    r = _ksw_local(qlen, query, tlen, target, mat, o_del, e_del, o_ins,
                   e_ins, xtra, byte_mode)
    if (xtra & KSW_XSTART) == 0 or ((xtra & KSW_XSUBO) and r.score < (xtra & 0xFFFF)):
        return r
    # reverse pass to find start positions
    q_rev = query[:r.qe + 1][::-1].copy()
    t_rev = target[:r.te + 1][::-1].copy()
    rr = _ksw_local(r.qe + 1, q_rev, r.te + 1, t_rev, mat, o_del, e_del,
                    o_ins, e_ins, KSW_XSTOP | r.score, byte_mode)
    if r.score == rr.score:
        r.tb = r.te - rr.te
        r.qb = r.qe - rr.qe
    return r
