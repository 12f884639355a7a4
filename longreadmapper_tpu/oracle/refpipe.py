"""Pure-Python/numpy oracle: a literal transcription of the reference's
mapping control flow (/root/reference/alnmain.c:330-527), used as the golden
reference the device pipeline must match record-for-record (SURVEY.md §4
"golden-SAM comparison harness").

Slow by design (per-read loops, dict histograms) — completely independent
code path from mapping/pipeline.py.

Defined-behavior choices shared with the device pipeline where the reference
is UB (documented):
  - lookup failure (seq_lookup == 0): strand=0, no reverse-complement, ed=-1
    (the reference reads uninitialized seq_meta there, alnmain.c:430-446)
  - N bases in reads: seeds containing N are uninformative; in alignment N
    mismatches everything (reference indexes uninitialized mapper[] entries)
  - CIGAR tie-break: M > I > D (the GACT submodule is absent upstream)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .. import native
from ..formats.catmeta import MtaEntry
from ..index.fmi import FMIndex, encode_bytes
from ..utils.config import Params


class _Histo:
    """Reference histo semantics (histo.c): bucket=key>>4, count, min key,
    insertion order; two-max scan with stable ties."""

    def __init__(self):
        self.entries: List[List[int]] = []  # [bucket, min_key, count]

    def add(self, key: int):
        b = key >> 4
        for e in self.entries:
            if e[0] == b:
                e[2] += 1
                e[1] = min(e[1], key)
                return
        self.entries.append([b, key, 1])

    def find_2_max(self) -> Tuple[Tuple[int, int], Tuple[int, int]]:
        """Returns ((key, val) top1, (key, val) top2) — histo_find_2_max."""
        s0 = [0, 0]  # key, val
        s1 = [0, 0]
        for b, k, v in self.entries:
            if s1[1] < v and s0[1] < v:
                s1 = s0
                s0 = [k, v]
            elif s1[1] < v and s0[1] >= v:
                s1 = [k, v]
        return (s0[0], s0[1]), (s1[0], s1[1])


@dataclass
class OracleResult:
    loc: int
    found: bool
    gi: int
    strand: int
    off: int
    ed: int
    flag: int
    mapq: int
    valid: bool
    cigar: Optional[List[Tuple[int, str]]]
    seq_out: str  # SEQ as emitted (rev-comped when strand==1, alnmain.c:437)


_COMP = str.maketrans("ACGTacgt", "TGCATGCA")


def revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


class OracleMapper:
    def __init__(self, fmi: FMIndex, lch_kl: np.ndarray, hlen: int,
                 cat: np.ndarray, mta: List[MtaEntry], params: Params):
        self.fmi = fmi
        self.kl = np.asarray(lch_kl, dtype=np.int64)
        self.hlen = hlen
        self.cat = cat
        self.mta = mta
        self.p = params

    # --- lc_aln (lchash.c:89-104)
    def lc_aln(self, codes: np.ndarray) -> Tuple[int, int, int]:
        qlen = len(codes)
        left = qlen - self.hlen
        if qlen >= self.hlen:
            tail = codes[left:]
            if (tail >= 4).any():
                return 0, 0, 0
            num = 0
            for c in tail:
                num = (num << 2) | int(c)
            k, l = int(self.kl[num, 0]), int(self.kl[num, 1])
        else:
            k, l = 1, self.fmi.length - 1
        if k == 0 and l == 0:
            return 0, 0, 0
        return self.fmi.fmi_aln(codes[:left], k, l)

    # --- PART 1 (alnmain.c:330-405)
    def best_location(self, codes: np.ndarray) -> int:
        p = self.p
        sl, gl = p.seed_len, p.gap_len
        rlen = len(codes)
        outer = _Histo()
        best = None
        accepted_iter = None
        for it in range(sl + gl):
            inner = _Histo()
            j = it
            while j < rlen - sl:
                r, k, l = self.lc_aln(codes[j:j + sl])
                if 0 < r < p.thres:
                    for kk in range(k, l + 1):
                        key = int(self.fmi.sa_access(kk)) - j
                        inner.add(key)
                j += sl + gl
            num_seeds = rlen // (sl + gl)
            if num_seeds > 0:
                (k1, v1), (_, v2) = inner.find_2_max()
                score = (v1 + v2) / num_seeds
                if score > p.accept_score:
                    best = k1
                    accepted_iter = it
                    break
                elif v1 != 0:
                    outer.add(k1)
        # post-loop (alnmain.c:400-403) incl. last-phase-accept overwrite
        if best is None or accepted_iter == sl + gl - 1:
            (k1, _), _ = outer.find_2_max()
            best = k1
        return best

    # --- seq_lookup (alnmain.c:151-176)
    def seq_lookup(self, loc: int, qlen: int):
        for gi, m in enumerate(self.mta):
            start, slen = m.offset, m.seq_len
            end = start + 2 * slen
            if loc >= start and loc + qlen <= start + slen:
                return True, gi, 0, loc - start, loc
            if loc >= start + slen and loc + qlen <= end:
                off = end - loc - qlen
                return True, gi, 1, off, off + start
        return False, 0, 0, 0, 0

    # --- full per-read pipeline (PART 2+3)
    def map_read(self, seq: str) -> OracleResult:
        codes = encode_bytes(np.frombuffer(seq.encode(), np.uint8))
        rlen = len(seq)
        loc = self.best_location(codes)
        found, gi, strand, off, loc_fwd = self.seq_lookup(loc, rlen)
        limit = int((self.p.error_rate * rlen) * 2)
        seq_out = revcomp(seq) if (found and strand) else seq
        if not found:
            return OracleResult(loc=loc, found=False, gi=0, strand=0, off=off,
                                ed=-1, flag=0x4, mapq=0, valid=False,
                                cigar=None, seq_out=seq_out)
        q = encode_bytes(np.frombuffer(seq_out.encode(), np.uint8))
        tgt = encode_bytes(self.cat[loc_fwd:loc_fwd + rlen])
        tgt = np.where(tgt >= 4, 5, tgt).astype(np.uint8)
        W = max(8, int(self.p.error_rate * rlen * 2))
        ed, ops = native.banded_align(q, tgt, W)
        if ed < 0 or ed > limit:
            ed = -1
        flag = 0
        mapq = 255
        valid = ed >= 0
        if not valid:
            flag += 0x4
            mapq = 0
        elif strand:
            flag += 16
        return OracleResult(loc=loc, found=True, gi=gi, strand=strand,
                            off=off, ed=ed, flag=flag, mapq=mapq, valid=valid,
                            cigar=ops, seq_out=seq_out)
