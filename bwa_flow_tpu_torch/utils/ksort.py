"""Faithful port of klib's ks_introsort (reference bwa/ksort.h:176-227).

Bit-exact SAM output requires reproducing not just bwa's comparators but
the *permutation ks_introsort applies to equal keys*: e.g. which of
several identical-weight repeat chains survives mem_chain_flt
(bwa/bwamem.c:350) depends on the post-sort order of ties, and the sub
score (XS tag) follows from it. Python's stable sort keeps input order
on ties; klib's introsort does not — it runs median-of-3 quicksort
partitions (which swap equal elements across the pivot), leaves
partitions <= 16 unsorted, and finishes with one insertion-sort pass.

``ks_introsort(a, lt)`` sorts list ``a`` in place with strict-less
``lt``, applying exactly the reference's element movements.
"""

from __future__ import annotations


def _insertsort(a, lt, s, t):
    # __ks_insertsort (ksort.h:146-153): t is one-past-end
    for i in range(s + 1, t):
        j = i
        while j > s and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a, lt, s, n):
    # ks_combsort (ksort.h:154-175)
    shrink = 1.2473309501039786540366528676643
    gap = n
    while True:
        if gap > 2:
            gap = int(gap / shrink)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(s, s + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
        if not (do_swap or gap > 2):
            break
    if gap != 1:
        _insertsort(a, lt, s, s + n)


def ks_introsort(a: list, lt) -> None:
    """In-place sort of ``a`` by strict-less ``lt``, klib-permutation-exact."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    stack = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, lt, s, t - s + 1)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            # median-of-3 pivot selection (ksort.h:199-202)
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, lt, 0, n)
                return
            s, t, d = stack.pop()
