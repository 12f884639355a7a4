"""lchash: precomputed SA intervals for all 4^hlen k-mers.

The reference builds this with 4^hlen *serial* backward searches
(/root/reference/lchash/lchash.c:52-73 — 16.7M iterations at hlen=12, the
index-build hot loop).  The device build runs the same recurrence as a batched
`lax.scan` over hlen characters with all k-mers in vector lanes — an
embarrassingly parallel gather workload.

K-mer numbering matches `_num_from_seq`/`_seq_from_num` (lchash.c:19-49):
the FIRST character of the k-mer occupies the most-significant 2 bits, so in
backward-search order (last char first) step j consumes bits (num >> 2j) & 3.
Absent k-mers store (0, 0) (lchash.c:64-66).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.rank import backward_step
from .fmi import FMIndex


def lc_build_host(fmi: FMIndex, hlen: int) -> np.ndarray:
    """Vectorized-numpy lchash build (oracle path). Returns (4^hlen, 2) uint64."""
    upper = 1 << (2 * hlen)
    ids = np.arange(upper, dtype=np.int64)
    c4 = fmi.c4()
    rank = fmi._full_rank()
    k = np.ones(upper, dtype=np.int64)
    l = np.full(upper, fmi.length - 1, dtype=np.int64)
    for j in range(hlen):
        c = (ids >> (2 * j)) & 3
        active = k <= l
        k_new = c4[c] + rank[np.maximum(k, 1) - 1 + 1, c] + 1
        l_new = c4[c] + rank[l + 1, c]
        k = np.where(active, k_new, k)
        l = np.where(active, l_new, l)
    absent = k > l
    out = np.stack([np.where(absent, 0, k), np.where(absent, 0, l)], axis=1)
    return out.astype(np.uint64)


def lc_build_from_sa(sa: np.ndarray, cat_codes: np.ndarray, hlen: int
                     ) -> np.ndarray:
    """Direct SA-derived lchash build — O(n·hlen) host time, no FM searches.

    The (k, l) interval of a k-mer is the contiguous run of SA rows whose
    suffixes start with it.  Encode each suffix's first hlen characters as a
    base-5 key ('$'/past-end = 0 < A=1 < C=2 < G=3 < T=4, matching suffix
    lexicographic order), which is non-decreasing along the SA; the interval
    is then two binary searches.  Produces bit-identical tables to the
    reference's 4^hlen serial backward searches (lchash.c:52-73) — checked
    against lc_build_host in tests.

    sa: (n,) suffix array of the .cat text; cat_codes: (n,) uint8 codes
    (0..3 = ACGT, 4 = '$').  Returns (4^hlen, 2) uint64, absent k-mers (0,0).
    """
    n = sa.shape[0]
    kdt = np.int32 if 5 ** hlen < 2**31 else np.int64
    dig = np.where(cat_codes < 4, cat_codes + 1, 0).astype(kdt)
    pw = (5 ** (hlen - 1 - np.arange(hlen))).astype(kdt)
    keys = np.zeros(n, dtype=kdt)
    chunk = 1 << 20
    idt = np.int32 if n < 2**31 else np.int64
    for s in range(0, n, chunk):
        w = sa[s:s + chunk].astype(idt)[:, None] + np.arange(hlen, dtype=idt)
        v = np.where(w < n, dig[np.minimum(w, n - 1)], kdt(0))
        keys[s:s + chunk] = v @ pw
    # k-mer keys by doubling: K_k[i*4 + c] = K_{k-1}[i]*5 + (c+1) —
    # strictly increasing, so both binary-search sides stay valid
    mkeys = np.arange(1, 5, dtype=kdt)
    for _ in range(hlen - 1):
        mkeys = ((mkeys * kdt(5))[:, None]
                 + np.arange(1, 5, dtype=kdt)[None, :]).reshape(-1)
    lo = np.searchsorted(keys, mkeys, side="left")
    hi = np.searchsorted(keys, mkeys, side="right")
    # Reference quirk, replicated exactly: fmi_aln's init (k=1, l=n-1) plus
    # the inclusive-Occ `+1` recurrence (fmidx.c:306) can never enter the
    # row of the terminal suffix "P$", so the occurrence of a k-mer at
    # position n-1-hlen is always missed.  That row sorts first in its run
    # ('$' is smallest), so bump its k-mer's lower bound.
    term = n - 1 - hlen
    if term >= 0 and np.all(cat_codes[term:term + hlen] < 4):
        kid = 0
        for t in range(hlen):
            kid = (kid << 2) | int(cat_codes[term + t])
        lo[kid] += 1
    absent = lo >= hi
    out = np.stack([np.where(absent, 0, lo), np.where(absent, 0, hi - 1)],
                   axis=1)
    return out.astype(np.uint64)


def lc_build_device(packed, occ_samp, c4, dollar_pos: int, n: int, hlen: int,
                    chunk: int = 1 << 20) -> np.ndarray:
    """Device lchash build: batched backward search over all 4^hlen k-mers.

    Processes k-mer ids in chunks to bound working memory; each chunk is one
    jitted scan with every k-mer in its own vector lane.
    """
    upper = 1 << (2 * hlen)
    chunk = min(chunk, upper)
    assert upper % chunk == 0
    pos_dtype = occ_samp.dtype

    @jax.jit
    def build_chunk(ids):
        k0 = jnp.ones_like(ids, dtype=pos_dtype)
        l0 = jnp.full_like(ids, n - 1, dtype=pos_dtype)

        def step(carry, j):
            k, l = carry
            c = ((ids >> (2 * j)) & 3).astype(jnp.int32)
            k2, l2 = backward_step(c4, packed, occ_samp, dollar_pos,
                                   k, l, c, k <= l)
            return (k2, l2), None

        (k, l), _ = lax.scan(step, (k0, l0), jnp.arange(hlen))
        absent = k > l
        zero = jnp.zeros_like(k)
        return jnp.stack([jnp.where(absent, zero, k),
                          jnp.where(absent, zero, l)], axis=1)

    out = np.empty((upper, 2), dtype=np.uint64)
    for start in range(0, upper, chunk):
        ids = jnp.arange(start, start + chunk, dtype=jnp.int32)
        out[start:start + chunk] = np.asarray(build_chunk(ids)).astype(np.uint64)
    return out
