"""Runtime parameters (reference: alnmain.h:10-13, read_params alnmain.c:574-588).

All hard-coded tunables of the reference are surfaced here (SURVEY.md §5):
o_ratio=32 (asindex.c:138), hlen=12 (asindex.c:142), csa_ratio=4 (fmidx.c:194),
CHUNK_SIZE=500 (alnmain.c:19), ERROR_RATE=0.05 (alnmain.c:21), vote-accept
threshold 0.6 (alnmain.c:378), histo bucket shift 4 (histo.c:27).
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class Params:
    # accaln runtime params (defaults: alnmain.c:577-580)
    batch_size: int = 1000
    seed_len: int = 20
    thres: int = 300  # non-informative seed threshold AND initial histo capacity

    # index-build params
    o_ratio: int = 32          # sampled-Occ stride in the .mfi file format
    hlen: int = 12             # lchash k-mer length (asindex.c:142)
    csa_ratio: int = 4         # sampled-SA stride (fmidx.c:194)

    # pipeline constants
    chunk_size: int = 500      # reads per device chunk (alnmain.c:19)
    error_rate: float = 0.05   # alignment limit = 2*error_rate*len (alnmain.c:21,428)
    accept_score: float = 0.6  # early vote-accept threshold (alnmain.c:378)
    bucket_shift: int = 4      # diagonal quantization (histo.c:27)
    gap_len: int = 1           # seed tiling gap `gl` (alnmain.c:343)

    # our flags (divergences documented)
    n_seed: int = 0            # RNG seed for N-replacement (reference: time(NULL))
    vote_budget: int = 128     # compacted vote slots per (read, phase);
                               # the per-read overflow flag reports drops




def auto_hlen(n_cat: int) -> int:
    """The one hlen rule (docs/TUNING.md "Choosing hlen").

    Deeper lchash tables cut the seed-expansion gather — the map step's
    dominant cost — because the per-seed background hit rate is
    lam = n/4^hlen: at hlen 14 a 4 Mb genome's vote budget drops from 112
    to 80 slots, and at genome scale 12 is unusable (n = 1e9: lam = 60 ->
    ~3000-slot budgets).  The table is 16 B x 4^hlen as built and
    stored (uint64 (k, l) pairs: 4.3 GB at 14, the .lch file likewise)
    and 8 B x 4^hlen on the device (int32 pairs: 2.1 GB at 14), flat in
    n, so 14 is a small share of one device at every real genome size;
    15 quadruples it.  The
    reference hard-codes 12 (asindex.c:142) — only sub-Mb toy fixtures
    keep that floor, where a 4^14-row table build against a sub-second
    index is absurd.

    `n_cat` is the .cat length (2*genome + 1); returns 12 or 14."""
    return 14 if n_cat >= 2_000_000 else 12


def read_params(path: str = "params") -> Params:
    """Reference `read_params` (alnmain.c:574-588): optional whitespace file
    `batch_size seed_len thres` in the cwd; silent defaults if absent."""
    p = Params()
    if os.path.exists(path):
        with open(path) as f:
            toks = f.read().split()
        if len(toks) >= 3:
            p.batch_size, p.seed_len, p.thres = int(toks[0]), int(toks[1]), int(toks[2])
    return p
