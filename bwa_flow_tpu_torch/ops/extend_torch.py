"""Batched exact ksw_extend2 in plain PyTorch tensor ops.

This is the plain version of the CUDA kernel in ops/extend_cuda.py: the
CPU path of the port, and the yardstick chip_smoke.py holds the kernel
against on the card. It reproduces bwa's ksw_extend2
(bwa/ksw.c:380-479) bit for bit — band clamping, h0-seeded first
column, z-drop with del/ins asymmetry, to-end gscore, last-argmax ties
for (max_i, max_j) and the post-row band shrink — as one loop over
target rows with every per-lane scalar held as a [B] tensor, so early
exits become freeze masks. The intra-row F dependency is a decayed
prefix max (torch.cummax). With row_dtype=torch.int16 it is also the
plain version of the int16 kernel (extend_cuda.extend_core_cuda16): the
DP rows are int16, as in the Pallas body _make_kernel16.

Port of bwa_flow_tpu/ops/extend_jax.py::extend_core; the output
contract is the task 6-tuple (score, qle, tle, gtle, gscore, max_off).
"""

from __future__ import annotations

import torch

NEG = -(1 << 30)
NEG16 = -(1 << 13)   # the F-scan floor of the int16 rows
# rows between the host-side "every lane finished" checks (each check is
# a device sync; finished lanes are frozen, so extra rows are no-ops)
_CHECK_EVERY = 32


def _as_int(v) -> int:
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def band_cap(qlen: torch.Tensor, w, mat: torch.Tensor, o_del, e_del,
             o_ins, e_ins, end_bonus) -> torch.Tensor:
    """Per-lane band width after ksw_extend2's cap (bwa/ksw.c:399-407),
    computed in double precision and truncated toward zero as bwa does.
    `w` is an int or an int32[B] tensor. Returns int32[B]."""
    max_sc = float(mat.max().item())
    qf = qlen.to(torch.float64)
    eb = float(_as_int(end_bonus))
    max_ins = (qf * max_sc + eb - _as_int(o_ins)) / _as_int(e_ins) + 1.0
    max_del = (qf * max_sc + eb - _as_int(o_del)) / _as_int(e_del) + 1.0
    if isinstance(w, torch.Tensor) and w.dim() > 0:
        wv = w.to(torch.int32)
    else:
        wv = torch.full_like(qlen, _as_int(w), dtype=torch.int32)
    wv = torch.minimum(wv, max_ins.to(torch.int32).clamp_min(1))
    return torch.minimum(wv, max_del.to(torch.int32).clamp_min(1))


def extend_core(qmax: int, tmax: int,
                query: torch.Tensor, qlen: torch.Tensor,
                target: torch.Tensor, tlen: torch.Tensor,
                h0: torch.Tensor, mat: torch.Tensor,
                o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop,
                stats: dict | None = None, row_dtype=torch.int32
                ) -> tuple[torch.Tensor, ...]:
    """Batched ksw_extend2 on any device.

    query: int32[B, qmax] (0..4), target: int32[B, tmax];
    qlen/tlen/h0: int32[B]; mat: int32[5, 5]; `w` an int or int32[B]
    (the band-doubling retry passes 2w for selected lanes); the other
    scalars are ints or 0-d tensors. Returns (score, qle, tle, gtle,
    gscore, max_off), each int32[B]; degenerate lanes (qlen == 0 or
    tlen == 0) give (h0, 0, 0, 0, -1, 0). With `stats`, adds the number
    of banded DP cells the inputs need to stats["cells"] (the work
    measure of the kernel's bound).

    row_dtype=torch.int16 keeps the DP rows (H, E, the query profile and
    every [B, qmax] temporary) in int16 and the per-lane carries in
    int32, as the Pallas body _make_kernel16 does; it is exact while
    extend_cuda.i16_exact holds for the inputs."""
    rdt = row_dtype
    neg = NEG16 if rdt == torch.int16 else NEG
    dev = query.device
    i32 = torch.int32
    B = query.shape[0]
    o_del, e_del = _as_int(o_del), _as_int(e_del)
    o_ins, e_ins = _as_int(o_ins), _as_int(e_ins)
    zdrop = _as_int(zdrop)
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    query = query.to(i32)
    target = target.to(i32)
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    h0 = h0.to(i32)
    mat = mat.to(i32)

    wv = band_cap(qlen, w, mat, o_del, e_del, o_ins, e_ins, end_bonus)

    # query profile for all 5 target symbols: qp[b, c, j] = mat[c, q[b, j]]
    qp = mat.to(rdt)[:, query.long().clamp(0, 4)].permute(1, 0, 2)

    jcol = torch.arange(qmax + 1, dtype=rdt, device=dev)[None, :]
    jq = torch.arange(qmax, dtype=rdt, device=dev)[None, :]
    h0r = h0.to(rdt)

    # first row of H (bwa/ksw.c:390-396): ehH[0]=h0; ehH[j>=1] =
    # max(h0 - oe_ins - (j-1)*e_ins, 0) while the chain stays positive
    ehH = torch.where(
        jcol == 0, h0r[:, None],
        torch.clamp_min(h0r[:, None] - oe_ins - (jcol - 1) * e_ins, 0))
    ehH = torch.where(jcol <= qlen[:, None], ehH, 0)
    ehE = torch.zeros((B, qmax + 1), dtype=rdt, device=dev)

    beg = torch.zeros(B, dtype=i32, device=dev)
    end = qlen.clone()
    maxv = h0.clone()
    max_i = torch.full((B,), -1, dtype=i32, device=dev)
    max_j = max_i.clone()
    max_ie = max_i.clone()
    gscore = max_i.clone()
    max_off = torch.zeros(B, dtype=i32, device=dev)
    done = (qlen == 0) | (tlen == 0)
    zero_col = torch.zeros((B, 1), dtype=rdt, device=dev)
    neg_col = torch.full((B, 1), neg, dtype=rdt, device=dev)
    cells = torch.zeros((), dtype=torch.int64, device=dev)

    for i in range(tmax):
        if i % _CHECK_EVERY == 0 and not bool(
                ((~done) & (i < tlen)).any()):
            break
        active0 = (~done) & (i < tlen)
        beg = torch.where(active0, torch.clamp_min(beg, i - wv), beg)
        end = torch.where(active0,
                          torch.minimum(torch.minimum(end, i + wv + 1),
                                        qlen),
                          end)
        degenerate = beg >= end
        active = active0 & ~degenerate
        act2 = active[:, None]
        if stats is not None:
            cells += torch.where(active, end - beg, 0).sum()

        tb = target[:, min(i, tmax - 1)]
        # q[b, j] = mat[tb[b], query[b, j]] via 5-way select
        q = torch.zeros((B, qmax), dtype=rdt, device=dev)
        for c in range(5):
            q = torch.where((tb == c)[:, None], qp[:, c, :], q)

        band_j = (jq >= beg[:, None]) & (jq < end[:, None])
        Hd = ehH[:, :qmax]             # H(i-1, j-1) at band position j
        Ein = ehE[:, :qmax]
        M = torch.where(Hd != 0, Hd + q, 0)
        M = torch.where(band_j, M, 0)
        Ein_b = torch.where(band_j, Ein, 0)

        # F scan: F[beg] = 0; F[j] = max_{beg<=k<j} (max(M[k]-oe_ins,0)
        #                                            - (j-1-k)*e_ins)
        T_ins = torch.clamp_min(M - oe_ins, 0)
        A = torch.where(band_j, T_ins + jq * e_ins, neg)
        run = torch.cummax(A, dim=1).values
        runs = torch.cat([neg_col, run[:, :-1]], dim=1)
        F = torch.clamp_min(runs - (jq - 1) * e_ins, neg)
        F = torch.where(jq == beg[:, None], 0, F)
        F = torch.where(band_j, F, 0)
        F = torch.clamp_min(F, 0)

        H = torch.maximum(torch.maximum(M, Ein_b), F)
        H = torch.where(band_j, H, 0)
        Eout = torch.maximum(torch.clamp_min(M - oe_del, 0), Ein_b - e_del)
        Eout = torch.where(band_j, Eout, 0)

        h1_init = torch.where(
            beg == 0, torch.clamp_min(h0 - (o_del + e_del * (i + 1)), 0),
            0).to(i32)
        h1_row = h1_init.to(rdt)[:, None]

        # write-back: ehH[beg]=h1_init; ehH[j]=H[j-1] for beg<j<=end;
        # ehE[j]=Eout[j] for beg<=j<end; ehE[end]=0
        Hshift = torch.cat([zero_col, H], dim=1)
        in_write = (jcol > beg[:, None]) & (jcol <= end[:, None])
        new_ehH = torch.where(jcol == beg[:, None], h1_row,
                              torch.where(in_write, Hshift, ehH))
        band_e = (jcol >= beg[:, None]) & (jcol < end[:, None])
        Epad = torch.cat([Eout, zero_col], dim=1)
        new_ehE = torch.where(band_e, Epad,
                              torch.where(jcol == end[:, None], 0, ehE))

        h1 = Hshift.gather(1, end.long()[:, None])[:, 0].to(i32)  # end-1
        mrow = torch.where(band_j, H, 0).amax(dim=1).to(i32)
        # mj: last band position attaining mrow; end-1 on an all-zero row
        att = band_j & (H == mrow[:, None])
        mj = torch.where(att, jq, -1).amax(dim=1).to(i32)
        mj = torch.where(mrow > 0, mj, end - 1)

        # collapsed-band rows still do the eh[end]/gscore bookkeeping
        # before m==0 breaks them (ksw.c:451-456)
        j_after = torch.where(degenerate, beg, end)
        h1_eff = torch.where(degenerate, h1_init, h1)
        to_end = active0 & (j_after == qlen)
        upd_ie = to_end & (h1_eff >= gscore)
        new_max_ie = torch.where(upd_ie, i, max_ie)
        new_gscore = torch.where(to_end, torch.maximum(gscore, h1_eff),
                                 gscore)

        break_zero = mrow == 0
        improved = mrow > maxv
        new_maxv = torch.where(improved, mrow, maxv)
        new_max_i = torch.where(improved, i, max_i)
        new_max_j = torch.where(improved, mj, max_j)
        new_max_off = torch.where(
            improved, torch.maximum(max_off, (mj - i).abs()), max_off)
        # z-drop (bwa/ksw.c:452-458), only when not improved
        di = i - max_i
        dj = mj - max_j
        zd = torch.where(di > dj,
                         maxv - mrow - (di - dj) * e_del > zdrop,
                         maxv - mrow - (dj - di) * e_ins > zdrop)
        break_z = (~improved) & zd if zdrop > 0 else torch.zeros_like(zd)

        broke = break_zero | break_z
        # band shrink (bwa/ksw.c:460-466) on the post-write arrays
        nz = (new_ehH != 0) | (new_ehE != 0)
        fwd_mask = nz & (jcol >= beg[:, None]) & (jcol < end[:, None])
        first_nz = torch.where(fwd_mask, jcol, qmax + 2).amin(dim=1).to(i32)
        beg_s = torch.minimum(first_nz, end)
        bwd_mask = nz & (jcol >= beg_s[:, None]) & (jcol <= end[:, None])
        last_nz = torch.where(bwd_mask, jcol, beg_s[:, None] - 1).amax(dim=1)
        end_s = torch.minimum(last_nz + 2, qlen)

        keep = active & ~broke
        upd = active & ~break_zero
        deg2 = (active0 & degenerate)[:, None]
        at_end = jcol == end[:, None]
        ehH = torch.where(act2, new_ehH,
                          torch.where(deg2 & at_end, h1_row, ehH))
        ehE = torch.where(act2, new_ehE,
                          torch.where(deg2 & at_end, 0, ehE))
        beg = torch.where(keep, beg_s, beg)
        end = torch.where(keep, end_s, end)
        maxv = torch.where(upd, new_maxv, maxv)
        max_i = torch.where(upd, new_max_i, max_i)
        max_j = torch.where(upd, new_max_j, max_j)
        max_off = torch.where(upd, new_max_off, max_off)
        max_ie = torch.where(active0, new_max_ie, max_ie)
        gscore = torch.where(active0, new_gscore, gscore)
        done = done | (active0 & degenerate) | (active & broke)

    if stats is not None:
        stats["cells"] = stats.get("cells", 0) + int(cells)
    return (maxv, max_j + 1, max_i + 1, max_ie + 1, gscore, max_off)


def extend_core16(qmax: int, tmax: int, query, qlen, target, tlen, h0,
                  mat, o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop,
                  stats: dict | None = None) -> tuple[torch.Tensor, ...]:
    """extend_core with int16 DP rows: the plain version of the int16
    kernel. Exact while extend_cuda.i16_exact holds for the inputs."""
    return extend_core(qmax, tmax, query, qlen, target, tlen, h0, mat,
                       o_del, e_del, o_ins, e_ins, w, end_bonus, zdrop,
                       stats=stats, row_dtype=torch.int16)
