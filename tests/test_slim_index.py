"""Slim index layout: sa_ctx carries SA only
(4 B/pos instead of 8) and the 16-base verify window is recomputed per vote
from a text_pair gather — must be record-identical to the full layout on
the same genome/reads, in both position widths.

The reference's sampled CSA (fmidx.c:153-163,315-331) exists for the same
memory trade; the slim layout is the device point on that curve (one
extra int32-pair gather per vote instead of LF-walks, which would
multiply the seeding stage's gathers)."""

import numpy as np
import pytest

from conftest import sample_reads, write_fasta


def _build_idx(tmp_path, genome, hlen, slim, force=None):
    from longreadmapper_tpu.formats.catmeta import (create_meta, load_cat,
                                                    load_mta)
    from longreadmapper_tpu.index.device import build_device_index
    from longreadmapper_tpu.index.fmi import FMIndex, encode_bytes
    from longreadmapper_tpu.index.lchash import lc_build_from_sa
    from longreadmapper_tpu.index.sa import sa_build

    fa = str(tmp_path / f"slim{int(slim)}.fa")
    write_fasta(fa, [("chr1", genome)])
    create_meta(fa, n_seed=0)
    prefix = fa + ".cat"
    sa = sa_build(prefix)
    fmi = FMIndex.build(prefix, sa=sa)
    cat = load_cat(prefix)
    kl = lc_build_from_sa(sa, encode_bytes(cat), hlen)
    idx, meta = build_device_index(fmi, kl, hlen, cat, load_mta(fa + ".mta"),
                                   force_pos_dtype=force, slim=slim)
    return idx, meta, load_mta(fa + ".mta")


def test_slim_layout_shapes(tmp_path):
    rng = np.random.default_rng(3)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 60_000))
    idx, meta, _ = _build_idx(tmp_path, genome, 8, slim=True)
    assert meta.slim
    # upload pads SA tables to a 4-row multiple (packed slot layout)
    assert idx.sa_ctx.ndim == 1
    assert idx.sa_ctx.shape[0] == -(-meta.n // 4) * 4
    nw = idx.text_packed.shape[0]
    assert idx.text_pair.shape == (nw + 2, 2)
    # adjacency + padding: row j == [padded[j], padded[j+1]]
    tp = np.asarray(idx.text_pair)
    words = np.asarray(idx.text_packed)
    assert tp[0, 0] == 0 and tp[0, 1] == words[0]
    assert np.array_equal(tp[1:nw, 0], words[: nw - 1])
    assert np.array_equal(tp[1:nw, 1], words[1:nw])
    assert tp[nw, 0] == words[nw - 1] and tp[nw, 1] == 0


def test_slim_vs_full_records(tmp_path):
    """Same genome, same reads: every MapRecord field identical."""
    from longreadmapper_tpu.models.mapper import TPUMapper
    from longreadmapper_tpu.utils.config import Params

    rng = np.random.default_rng(17)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 250_000))
    hlen = 10
    params = Params(hlen=hlen)
    reads = [(f"r{i}", s, None) for i, (_, s, *_) in enumerate(
        sample_reads(rng, genome, 48, 600, error_rate=0.05))]

    recs = {}
    for slim in (False, True):
        idx, meta, mta = _build_idx(tmp_path, genome, hlen, slim)
        assert meta.slim == slim
        mapper = TPUMapper(idx, meta, mta, params, chunk_b=48)
        recs[slim] = mapper.map_chunk(reads)
    for a, b in zip(recs[False], recs[True]):
        assert (a.valid, a.ed, a.off, a.cigar, a.flag) == \
               (b.valid, b.ed, b.off, b.cigar, b.flag), a.qname


def test_slim_pos64_sam_parity(tmp_path):
    """Forced split-hi positions + slim layout produces byte-identical SAM
    to the full pos64 layout (each in its own x64 subprocess)."""
    import os
    import subprocess
    import sys

    from longreadmapper_tpu.runtime.accidx import build_index
    from longreadmapper_tpu.utils.config import Params

    rng = np.random.default_rng(29)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 150_000))
    fa = str(tmp_path / "p64.fa")
    write_fasta(fa, [("chr1", genome)])
    build_index(fa, Params(hlen=8), use_device=False, verbose=False)
    fq = str(tmp_path / "r.fq")
    with open(fq, "w") as f:
        for i, (_, s, *_) in enumerate(
                sample_reads(rng, genome, 24, 500, error_rate=0.04)):
            f.write(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n")

    worker = os.path.join(os.path.dirname(__file__), "_pos64_worker.py")
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    outs = {}
    for mode in ("full", "slim"):
        args = [sys.executable, worker, fa, fq, "32", "20", "300"]
        if mode == "slim":
            args.append("slim")
        r = subprocess.run(args, capture_output=True, text=True,
                           timeout=600, env=env)
        assert r.returncode == 0, (mode, r.stderr[-3000:])
        assert "POS64_OK" in r.stderr
        outs[mode] = r.stdout
    assert outs["slim"] == outs["full"]
    assert outs["full"].count("\n") > 20  # real records, not just a header


def test_slim_cache_derivation(tmp_path):
    """A full-layout devidx cache must serve a slim load by deriving the
    slim arrays (no recompute from artifacts), and the records must match
    the directly-built slim index."""
    from longreadmapper_tpu.formats.catmeta import create_meta
    from longreadmapper_tpu.index.device import load_device_index
    from longreadmapper_tpu.models.mapper import TPUMapper
    from longreadmapper_tpu.runtime.accidx import build_index
    from longreadmapper_tpu.utils.config import Params

    rng = np.random.default_rng(23)
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, 120_000))
    fa = str(tmp_path / "c.fa")
    write_fasta(fa, [("chr1", genome)])
    params = Params(hlen=8)
    build_index(fa, params, use_device=False, verbose=False)

    idx_full, meta_full, mta = load_device_index(fa)  # writes the cache
    assert not meta_full.slim
    idx_slim, meta_slim, _ = load_device_index(fa, slim=True)  # cache hit
    assert meta_slim.slim
    assert idx_slim.sa_ctx.ndim == 1
    assert np.array_equal(np.asarray(idx_slim.sa_ctx),
                          np.asarray(idx_full.sa_ctx)[:, 0])

    reads = [(f"r{i}", s, None) for i, (_, s, *_) in enumerate(
        sample_reads(rng, genome, 16, 400, error_rate=0.04))]
    ra = TPUMapper(idx_full, meta_full, mta, params, chunk_b=16
                   ).map_chunk(reads)
    rb = TPUMapper(idx_slim, meta_slim, mta, params, chunk_b=16
                   ).map_chunk(reads)
    for a, b in zip(ra, rb):
        assert (a.valid, a.ed, a.off, a.cigar) == \
               (b.valid, b.ed, b.off, b.cigar), (a.qname, a, b)
