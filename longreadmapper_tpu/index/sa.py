"""Suffix-array build glue (reference: psascan/sa_use.cc:8-17 `sa_build`).

Builds the suffix array of the file at `prefix` (the .cat text) and writes it
as `<prefix>.sa5` in the 40-bit codec.  The construction itself is the native
SA-IS component (longreadmapper_tpu/native/sais.cpp) replacing pSAscan.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..formats.ui40 import write_sa5, read_sa5


def sa_build(prefix: str, ram_use: int = 0) -> np.ndarray:
    """Build and persist `<prefix>.sa5`; returns the SA as int64.

    `ram_use` (bytes, the reference's `sa_build` ram parameter,
    psascan/sa_use.cc:8-17) bounds the CONSTRUCTION working set: when the
    in-RAM SA-IS footprint (~12 B/char) would exceed it, the blocked
    external-memory builder runs instead (index/sa_external.py,
    docs/EXTERNAL_SA.md) — byte-identical .sa5 either way.  0 = in-RAM."""
    import os

    n = os.path.getsize(prefix)
    if ram_use > 0 and n * 12 > ram_use:
        from .sa_external import sa_build_external

        sa_build_external(prefix, ram_use)
        return read_sa5(prefix + ".sa5")
    text = np.fromfile(prefix, dtype=np.uint8)
    sa = native.suffix_array(text)
    write_sa5(sa, prefix + ".sa5")
    return sa


def sa_load(prefix: str) -> np.ndarray:
    """Load `<prefix>.sa5` whole (alnmain.c:242-252 behavior)."""
    return read_sa5(prefix + ".sa5")


def sa_build_xla(codes: np.ndarray) -> np.ndarray:
    """Accelerator suffix-array construction: sort-based prefix doubling.

    The reference parallelizes SA construction with OpenMP threads inside
    pSAscan (SURVEY.md P1); the device equivalent runs the whole build
    as device sorts.  Per doubling round (all arrays in POSITION order —
    no gathers or scatters):

        rank2 = rank shifted left by k            (dynamic slice, cheap)
        sort positions by (rank, rank2)           (device sort)
        rank\' = run-boundary prefix count, carried back to position
                 order by a SECOND sort keyed on position

    O(log n) rounds of two n-element sorts; early exit once all ranks are
    distinct.  codes: (n,) uint8 with 0..3 = ACGT and 4 = \'$\' (remapped
    below the alphabet, matching suffix order).  Returns int64 host SA.
    """
    import jax
    import jax.numpy as jnp
    from jax import lax

    n = int(codes.shape[0])
    assert n < 2**31
    first = np.where(codes == 4, -1, codes.astype(np.int32))
    rank = jnp.asarray(first)
    pos = jnp.arange(n, dtype=jnp.int32)
    neg = jnp.full((n,), -0x7FFFFFFF, jnp.int32)

    @jax.jit
    def one_round(rank, k):
        ext = jnp.concatenate([rank, neg])
        rank2 = lax.dynamic_slice(ext, (k,), (n,))
        r1s, r2s, ps = lax.sort((rank, rank2, pos), dimension=0,
                                is_stable=False, num_keys=2)
        changed = jnp.concatenate([
            jnp.zeros((1,), jnp.int32),
            ((r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])
             ).astype(jnp.int32)])
        newr_sorted = jnp.cumsum(changed)
        _, rank_new = lax.sort((ps, newr_sorted), dimension=0,
                               is_stable=False, num_keys=1)
        return rank_new, ps, newr_sorted[-1]

    k = 1
    sa = None
    while True:
        rank, sa, maxr = one_round(rank, jnp.int32(k))
        if int(maxr) == n - 1 or k >= n:
            break
        k *= 2
    return np.asarray(sa).astype(np.int64)
