"""Greedy CD-HIT-style sequence clustering.

Behavioral parity with the reference's ``-cluster`` mode
(/root/reference/rust/sa_opencl/src/main.rs:149-265):

  * sort by length descending (stable);
  * pass 1: collapse exact duplicates (equal length + equal string,
    main.rs:160-179);
  * pass 2: greedy clustering — substring containment shortcut gated on
    long-coverage (main.rs:197-202), otherwise align (retain_all=False) and
    threshold on long-coverage, short-coverage and identity
    (= matches / alignment-length, main.rs:204-235); defaults all 0.8;
  * representatives ``.fas`` + members ``.clstr`` (main.rs:244-265).
    Note the reference emits exact-duplicate sequences as representatives
    too (their ``cluster_of`` is never reassigned, main.rs:252) — we
    replicate that.

Batching difference: within one greedy row every candidate alignment is
independent, so the whole row is dispatched as one bucketed batch instead of
the reference's serial aligner calls — identical results, device-sized work.
Rows are the parallelism ceiling for EXACT parity: which sequences remain
unclustered when representative ii is processed depends on every earlier
row's merges, so cross-row batching would change results.  (Approximate
speedups — e.g. optimistic cross-row batching with invalidation — belong
behind a flag if ever needed; all-vs-all scoring without the greedy
dependency is what `sweep.py` is for.)
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from .aligner import AlignResult
from .io.fasta import SeqData


def alignment_identity_stats(a1: str, a2: str) -> Tuple[int, int, int]:
    """(non-gap count row1, non-gap count row2, match count)
    (parity: main.rs:206-230)."""
    alen = blen = matchnum = 0
    for x, y in zip(a1, a2):
        if x != "-":
            alen += 1
        if y != "-":
            blen += 1
        if x == "-" or y == "-":
            continue
        if x == y:
            matchnum += 1
    return alen, blen, matchnum


def greedy_cluster(
    seqs: Sequence[SeqData],
    engine,
    identity: float = 0.8,
    coverage_short: float = 0.8,
    coverage_long: float = 0.8,
    progress: Optional[Callable[[str], None]] = None,
) -> Tuple[List[int], List[List[int]], List[SeqData]]:
    """Returns (cluster_of, members, sorted_seqs); indices refer to
    sorted_seqs (length-descending order)."""
    order = sorted(seqs, key=lambda s: len(s.seq), reverse=True)
    nn = len(order)
    cluster_of = list(range(nn))
    members: List[List[int]] = [[] for _ in range(nn)]
    identical = list(range(nn))
    identical_members: List[List[int]] = [[] for _ in range(nn)]

    # pass 1: exact-duplicate collapse (equal lengths are adjacent)
    for ii in range(nn):
        if identical[ii] != ii:
            continue
        identical_members[ii].append(ii)
        si = order[ii].seq
        for jj in range(ii + 1, nn):
            if identical[jj] != jj:
                continue
            sj = order[jj].seq
            if len(si) != len(sj):
                break
            if si == sj:
                identical[jj] = ii
                identical_members[ii].append(jj)

    # pass 2: greedy clustering, one batched row per representative
    for ii in range(nn):
        if cluster_of[ii] != ii or identical[ii] != ii:
            continue
        members[ii].extend(identical_members[ii])
        identical_members[ii] = []
        si = order[ii].seq

        # scan pass: classify candidates (no mutation — merges must land in
        # strict jj order so members/.clstr match the reference byte-for-byte)
        visited: List[int] = []
        contained: set = set()
        to_align: List[int] = []
        for jj in range(ii + 1, nn):
            if cluster_of[jj] != jj or identical[jj] != jj:
                continue
            visited.append(jj)
            sj = order[jj].seq
            if sj in si:
                contained.add(jj)
            else:
                to_align.append(jj)

        # one bucketed device batch for the whole row (reference: serial
        # aligner calls, main.rs:204)
        if to_align:
            results = engine.align_pairs(
                [(order[ii], order[jj]) for jj in to_align], retain_all=False
            )
            by_jj = dict(zip(to_align, results))
        else:
            by_jj = {}

        # merge pass, in jj order (parity: main.rs:195-243)
        for jj in visited:
            sj = order[jj].seq
            if jj in contained:
                lcov = len(sj) / len(si) if si else 0.0
                if lcov >= coverage_long:
                    cluster_of[jj] = ii
                    members[ii].extend(identical_members[jj])
                    identical_members[jj] = []
            else:
                r: AlignResult = by_jj[jj]
                alen, blen, matchnum = alignment_identity_stats(
                    r.aligned1, r.aligned2
                )
                if len(si) < len(sj):  # pragma: no cover - sorted desc
                    raise RuntimeError("??")
                lcov = alen / len(si) if si else 0.0
                scov = blen / len(sj) if sj else 0.0
                alnlen = len(r.aligned1)
                ident = matchnum / alnlen if alnlen else 0.0
                if (
                    lcov >= coverage_long
                    and scov >= coverage_short
                    and ident >= identity
                ):
                    cluster_of[jj] = ii
                    members[ii].extend(identical_members[jj])
                    identical_members[jj] = []
            if progress is not None and (jj + 1) % 1000 == 0:
                progress(f"{jj + 1} alignments were done.")
        if progress is not None and (ii + 1) % 10 == 0:
            progress(f"{ii + 1} sequences were processed.")

    return cluster_of, members, order


def write_cluster_outputs(
    outfilename: str,
    order: Sequence[SeqData],
    cluster_of: Sequence[int],
    members: Sequence[List[int]],
) -> None:
    """Representatives ``.fas`` + members ``.clstr`` (main.rs:244-265)."""
    with open(outfilename, "w") as f:
        for cc in range(len(cluster_of)):
            if cc == cluster_of[cc]:
                f.write(f">{order[cc].name} {order[cc].desc}\n{order[cc].seq}\n")
    with open(outfilename + ".clstr", "w") as f:
        for cc in range(len(cluster_of)):
            if not members[cc]:
                continue
            f.write(" ".join(order[mm].name for mm in members[cc]))
            f.write("\n")
