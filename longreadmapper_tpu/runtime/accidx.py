"""Index-build driver — the `accidx` equivalent (/root/reference/asindex.c:129-153).

Pipeline: FASTA -> .mta/.cat (N-replacement, uppercase, fwd+revcomp concat)
-> suffix array (.sa5, native SA-IS) -> FM-index (.mfi) -> lchash (.lch).

The lchash build runs on the accelerator when JAX has one (batched
backward search over all 4^hlen k-mers); on the CPU backend, or with
`use_device=False`, it runs on the host from the suffix array.  A failure
of the device build fails the index build.
"""

from __future__ import annotations

import jax
import numpy as np

from ..formats.catmeta import create_meta, load_cat
from ..formats.lch import write_lch
from ..index.device import build_device_index
from ..index.fmi import FMIndex, encode_bytes
from ..index.lchash import lc_build_device, lc_build_from_sa
from ..index.sa import sa_build
from ..utils.config import Params
from ..utils.log import new_logger


def build_index(fasta_path: str, params: Params | None = None,
                use_device: bool = True, verbose: bool = True,
                devidx: bool = True, ram_use: int = 0) -> None:
    """`ram_use` (bytes) bounds the SA-construction working set — the
    reference's `fmi_build` ram parameter (asindex.c:138, 8 GiB there);
    0 = unbounded in-RAM SA-IS."""
    p = params or Params()
    log = new_logger(verbose=verbose)

    t0 = log.vlog("create_meta: writing %s.mta / .cat", fasta_path)
    mta = create_meta(fasta_path, n_seed=p.n_seed)
    prefix = fasta_path + ".cat"
    log.vlog("create_meta done in %.2fs (%d sequences)", log.elapse(t0), len(mta))

    t0 = log.vlog("sa_build: suffix array -> %s.sa5", prefix)
    sa = sa_build(prefix, ram_use=ram_use)
    log.vlog("sa_build done in %.2fs (n=%d)", log.elapse(t0), sa.shape[0])

    t0 = log.vlog("fmi_build: C/BWT/O/CSA tables (o_ratio=%d)", p.o_ratio)
    fmi = FMIndex.build(prefix, o_ratio=p.o_ratio, csa_ratio=p.csa_ratio, sa=sa)
    fmi.write(prefix)
    log.vlog("fmi_build done in %.2fs", log.elapse(t0))

    t0 = log.vlog("lc_build: %d k-mers (hlen=%d)", 1 << (2 * p.hlen), p.hlen)
    # The SA-derived host build is O(n*hlen) with no FM searches and no
    # compiles — byte-identical to the reference's 4^hlen serial backward
    # searches (tests/test_index.py).  The batched device scan runs only
    # where JAX has an accelerator.
    cat = load_cat(prefix)  # one pass; re-reading is ~45 s/scan at hg19 scale
    if use_device and jax.default_backend() != "cpu":
        # the device scan reads only the BWT rank tables: a one-row
        # placeholder stands in for the lchash table being built
        idx, meta = build_device_index(
            fmi, np.zeros((1, 2), np.uint64), p.hlen, cat, mta)
        kl = lc_build_device(idx.packed, idx.occ_samp, idx.c4,
                             meta.dollar_pos, meta.n, p.hlen)
        del idx
    else:
        kl = lc_build_from_sa(fmi.sa, encode_bytes(cat), p.hlen)
    write_lch(prefix + ".lch", p.hlen, kl)
    log.vlog("lc_build done in %.2fs", log.elapse(t0))

    if devidx:
        # persist the derived device-layout arrays at BUILD time so the
        # first `map` is an I/O-bound fread like the reference's accaln
        # init (alnmain.c:192-252) — at genome scale the assembly is tens
        # of minutes and belongs in the (already long) index build, not in
        # the first mapping run
        from ..index.device import _assemble_host_arrays, save_device_cache

        t0 = log.vlog("devidx: assembling the device-layout cache")
        arrays, meta = _assemble_host_arrays(fmi, kl, p.hlen, cat, mta)
        save_device_cache(fasta_path, arrays, meta)
        log.vlog("devidx cache written in %.2fs (pos_dtype=%s)",
                 log.elapse(t0), meta.pos_dtype)
