#!/usr/bin/env python3
"""Smoke test on the GPU: index a bacterial genome and map reads end to end.

Everything runs in ONE process that holds the card(s), through the
entry points a user calls (`cli index`, `cli warmup`, `cli map`, and with
--four-cards `cli mapdist`), and every result is checked against the
repo's plain references.  Each phase prints one line with its result and
times; the last line of standard output is one JSON object:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases (one card, the default):
  1 device   JAX's backend is the GPU; the card's name and power limit;
             the native host library is built; the compile-cache directory.
  2 index    `cli index` on a seeded synthetic genome the size of E. coli
             K-12 MG1655 (4,641,652 bp, with N runs and lowercase
             stretches) at auto hlen 14: the lchash table is built on the
             card and must equal the host build from the suffix array
             (index/lchash.lc_build_from_sa) byte for byte.
  3 1 kb     16,384 reads, 3% substitutions, chunk 2048.
  4 10 kb    512 reads, 2% substitutions, 0.5% insertions, 0.5% deletions
             (the resident-dirs path at half band, per-indel walks).
  5 50 kb    64 reads, same error mix (the tiled gact path).
  6 repeats  a 3 Mb genome with ~45% repeats (scripts/gen_repeat_genome.py),
             1 kb reads: the exact-slots retry tier must fire.
  7 kernels  both lowerings of the band DP's min-plus scan
             (ops/wavefront._minplus_scan) at the map step's shapes: equal
             outputs, and each one's time on the card, alone and inside the
             direction DP (ops/wavefront.banded_nw_dirs_v), the full-score
             DP (banded_nw_scores) and the tiled forward pass
             (ops/gact.gact_forward).

Phases 3-6 map with `cli warmup` (compile) then `cli map` (run) and
compare SAM records, field by field, with oracle/refpipe.OracleMapper on
a seeded sample of reads.  Tolerance is zero: every device result is an
integer (edit distances, positions, direction bits).

--four-cards runs only the multi-card path and its reference: `cli
mapdist` over four cards with the index row-sharded (`--shard-index`, mesh
1x4) and replicated (mesh 4x1), then `cli map` on one card.  Both mapdist
SAMs must equal the one-card SAM, and every card must have held its share
of the index.

Exits non-zero, without the JSON line, when JAX finds no GPU or any check
fails.  Usage: python chip_smoke.py [--seed N] [--four-cards]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import tempfile
import time
import traceback
from functools import partial

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import longreadmapper_tpu  # noqa: E402  (fails outside a checkout)

if os.path.dirname(os.path.abspath(longreadmapper_tpu.__file__)) != \
        os.path.join(REPO, "longreadmapper_tpu"):
    sys.exit("chip_smoke.py must run from the checkout it belongs to")

# Workload sizes.  The genome is E. coli K-12 MG1655's length; read
# counts fill whole chunks of each length bucket.
SIZES = dict(
    genome_bp=4_641_652,
    n_1k=16_384, n_10k=512, n_50k=64,
    repeat_bp=3_000_000, n_repeat=2048, hlen=14,
    oracle_1k=16, oracle_10k=4, oracle_50k=2, oracle_repeat=24,
    chunk=2048,
)
# (rows, band) of the band DP's min-plus scan: the 1 kb chunk's short band,
# the 10 kb bucket's half band and its full-band retry
SCAN_SHAPES = ((2048, 256), (200, 1152), (256, 2176))
# (B, L, W, band) of the direction DP: the 1 kb chunk and the 10 kb bucket
DIRS_SHAPES = ((2048, 1024, 127, 256), (200, 10240, 512, 1152))
# (B, L, T, W, band) of the tiled forward pass: the 50 kb bucket's half band
GACT_SHAPE = (40, 50176, 512, 2508, 5120)

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
_COMP[np.frombuffer(b"ACGTNacgtn", np.uint8)] = np.frombuffer(b"TGCANtgcan",
                                                              np.uint8)
_CODE = np.full(256, 4, np.uint8)
_CODE[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.uint8)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(*a) -> None:
    print(*a, flush=True)


# ---------------------------------------------------------------- data

def make_genome(rng, n: int) -> np.ndarray:
    """Uniform random ACGT with a few N runs (assembly gaps) and lowercase
    stretches (soft-masked regions), as uint8 ASCII."""
    g = _ACGT[rng.integers(0, 4, n, dtype=np.uint8)]
    for _ in range(5):
        ln = int(rng.integers(50, 2000))
        p = int(rng.integers(0, n - ln))
        g[p:p + ln] = ord("N")
    for _ in range(20):
        ln = int(rng.integers(1000, 20000))
        p = int(rng.integers(0, n - ln))
        g[p:p + ln] |= 0x20
    return g


def write_fasta(path: str, name: str, g: np.ndarray) -> None:
    full = len(g) // 80 * 80
    lines = np.concatenate(
        [g[:full].reshape(-1, 80),
         np.full((full // 80, 1), ord("\n"), np.uint8)], axis=1)
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(lines.tobytes())
        if full < len(g):
            f.write(g[full:].tobytes() + b"\n")


def simulate_reads(rng, g: np.ndarray, n: int, length: int, sub: float,
                   ins: float = 0.0, dele: float = 0.0) -> list:
    """n reads of exactly `length` bases from either strand of the
    upper-cased genome; per source base: deletion, else an insertion
    before it, else a substitution to a different base."""
    up = g & 0xDF
    span = length + int(length * dele * 2) + 64
    reads = []
    for i in range(n):
        p = int(rng.integers(0, len(up) - span))
        src = up[p:p + span].copy()
        r = rng.random(span)
        dmask = r < dele
        imask = (r >= dele) & (r < dele + ins)
        smask = (r >= dele + ins) & (r < dele + ins + sub)
        code = _CODE[src[smask]]
        shift = rng.integers(1, 4, code.size, dtype=np.uint8)
        src[smask] = np.where(code < 4, _ACGT[(code + shift) % 4],
                              _ACGT[shift])
        pair = np.stack([_ACGT[rng.integers(0, 4, span, dtype=np.uint8)],
                         src], axis=1)
        out = pair[np.stack([imask, ~dmask], axis=1)][:length]
        if rng.random() < 0.5:
            out = _COMP[out[::-1]]
        reads.append((f"r{i}", out.tobytes().decode()))
    return reads


def write_fastq(path: str, reads) -> None:
    with open(path, "w") as f:
        f.writelines(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n"
                     for name, seq in reads)


# ---------------------------------------------------------------- cli

class _Tee(io.TextIOBase):
    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


def run_cli(argv, stdout_path: str | None = None) -> str:
    """`longreadmapper_tpu.cli.main(argv)` in this process; returns its
    log (stderr, also echoed).  SAM on stdout goes to `stdout_path`."""
    from longreadmapper_tpu.cli import main
    buf = io.StringIO()
    with contextlib.ExitStack() as st:
        st.enter_context(contextlib.redirect_stderr(_Tee(buf, sys.__stderr__)))
        if stdout_path is not None:
            st.enter_context(contextlib.redirect_stdout(
                st.enter_context(open(stdout_path, "w"))))
        rc = main(list(argv))
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def logged(log: str, pattern: str) -> tuple:
    m = re.search(pattern, log)
    check(m is not None, f"log line /{pattern}/ missing")
    return m.groups()


def sam_records(path: str) -> dict:
    with open(path) as f:
        return {l.split("\t", 1)[0]: l.rstrip("\n")
                for l in f if l.strip() and not l.startswith("@")}


def sam_headers(path: str, kind: str) -> list:
    with open(path) as f:
        return [l.rstrip("\n") for l in f if l.startswith(kind)]


# ---------------------------------------------------------------- oracle

class Oracle:
    """oracle/refpipe.OracleMapper over the written artifacts, as SAM lines
    in the mapper's record format."""

    def __init__(self, fa: str, kl=None):
        from longreadmapper_tpu.formats.catmeta import load_cat, load_mta
        from longreadmapper_tpu.formats.lch import read_lch
        from longreadmapper_tpu.index.fmi import FMIndex
        from longreadmapper_tpu.oracle.refpipe import OracleMapper
        from longreadmapper_tpu.utils.config import Params
        prefix = fa + ".cat"
        hlen, kl_file = read_lch(prefix + ".lch")
        self.mta = load_mta(fa + ".mta")
        self.m = OracleMapper(FMIndex.read(prefix, with_sa=True),
                              kl_file if kl is None else kl, hlen,
                              load_cat(prefix), self.mta, Params())

    def line(self, name: str, seq: str) -> str:
        from longreadmapper_tpu.formats.sam import cigar_string, sam_record
        o = self.m.map_read(seq)
        qual = "I" * len(seq)
        if o.valid:
            rec = sam_record(name, o.flag, self.mta[o.gi].seq_name, o.off,
                             o.mapq, cigar_string(o.cigar), o.seq_out, qual,
                             o.ed)
        elif o.found:
            rec = sam_record(name, 4, self.mta[o.gi].seq_name, o.off, 0, "*",
                             o.seq_out, qual, -1)
        else:
            rec = sam_record(name, 4, "*", 0, 0, "*", seq, qual, -1)
        return rec.rstrip("\n")


def oracle_parity(oracle: Oracle, reads, recs: dict, k: int, rng) -> float:
    """SAM records of a seeded sample of k reads must equal the oracle's;
    returns the seconds the oracle took."""
    t0 = time.perf_counter()
    for i in sorted(rng.choice(len(reads), size=k, replace=False).tolist()):
        name, seq = reads[i]
        want = oracle.line(name, seq)
        check(recs.get(name) == want,
              f"SAM differs from the oracle for {name}:\n"
              f"  got  {recs.get(name)!r:.300}\n  want {want!r:.300}")
    return time.perf_counter() - t0


def map_phase(label: str, fa: str, reads, work: str, n_oracle: int, rng,
              oracle: Oracle) -> dict:
    """`cli warmup` + `cli map` on `reads`, then oracle parity; returns
    the SAM records by read name and the count of retried reads."""
    fq = os.path.join(work, f"{label}.fq")
    write_fastq(fq, reads)
    length = len(reads[0][1])
    chunk = str(SIZES["chunk"])
    wlog = run_cli(["warmup", fa, "--lengths", str(length),
                    "--chunk-b", chunk])
    compile_s = float(logged(wlog, r"warmed 1 bucket\(s\) in ([\d.]+)s")[0])
    sam = os.path.join(work, f"{label}.sam")
    mlog = run_cli(["map", fa, fq, str(len(reads)), "20", "300",
                    "--chunk-b", chunk, "--rg-id", "0"], stdout_path=sam)
    setup_s = float(logged(mlog, r"index loaded in ([\d.]+)s")[0])
    run_s = float(logged(mlog, r"batch done in ([\d.]+)s")[0])
    valid, total = map(int, logged(mlog, r"Sensitivity: (\d+)/(\d+)="))
    phases = logged(mlog, r"host phases: (.*)")[0]
    retried, rewalked, flagged = map(int, logged(
        mlog, r"retry tiers: (\d+) reads re-mapped exactly, (\d+) chunks "
              r"re-walked, (\d+) reads flagged"))
    recs = sam_records(sam)
    check(total == len(reads) and len(recs) == len(reads),
          f"{len(recs)} SAM records for {len(reads)} reads")
    oracle_s = oracle_parity(oracle, reads, recs, n_oracle, rng)
    say(f"[{label}] {len(reads)} reads x {length} bp: sensitivity "
        f"{valid}/{total} = {valid / total:.4f}; {total / run_s:.1f} reads/s "
        f"(setup {setup_s:.2f}s, compile {compile_s:.1f}s, run "
        f"{run_s:.2f}s; host phases {phases}); retried {retried}, "
        f"re-walked {rewalked}, flagged {flagged}; SAM == oracle on "
        f"{n_oracle} reads ({oracle_s:.1f}s)")
    return recs, retried


# ---------------------------------------------------------------- phases

def phase_device(cache_dir: str, want_count: int) -> None:
    import jax
    from longreadmapper_tpu import native
    from longreadmapper_tpu.utils.gpu import card_name_and_power_limit
    check(jax.default_backend() == "gpu",
          f"JAX's backend is {jax.default_backend()!r}, not the GPU")
    devs = jax.devices()
    check(len(devs) >= want_count,
          f"{len(devs)} GPU(s) visible, {want_count} needed")
    for line in card_name_and_power_limit():
        say(f"[device] nvidia-smi: {line}")
    native._load()
    check(native.HAVE_NATIVE, "native host library failed to build")
    say(f"[device] jax {jax.__version__}, {len(devs)} x "
        f"{devs[0].device_kind}; HAVE_NATIVE True; compile cache {cache_dir}")


def build_indexed_genome(g: np.ndarray, name: str, work: str) -> tuple:
    """Write the genome and run `cli index`; returns (fasta, seconds)."""
    fa = os.path.join(work, f"{name}.fa")
    write_fasta(fa, name, g)
    t0 = time.perf_counter()
    log = run_cli(["index", fa])
    dt = time.perf_counter() - t0
    hlen = int(logged(log, r"auto hlen = (\d+)")[0])
    check(hlen == SIZES["hlen"], f"auto hlen {hlen}, expected "
          f"{SIZES['hlen']}")
    return fa, dt


def phase_index(fa: str, index_s: float) -> np.ndarray:
    """The device-built .lch must equal lc_build_from_sa byte for byte."""
    import struct

    from longreadmapper_tpu.formats.catmeta import load_cat
    from longreadmapper_tpu.formats.ui40 import read_sa5
    from longreadmapper_tpu.index.fmi import encode_bytes
    from longreadmapper_tpu.index.lchash import lc_build_from_sa
    prefix = fa + ".cat"
    hlen = SIZES["hlen"]
    t0 = time.perf_counter()
    kl = lc_build_from_sa(read_sa5(prefix + ".sa5"),
                          encode_bytes(load_cat(prefix)), hlen)
    host_s = time.perf_counter() - t0
    with open(prefix + ".lch", "rb") as f:
        head = f.read(12)
        body = np.fromfile(f, dtype="<u8")
    check(head == struct.pack("<i", hlen) + struct.pack("<Q", kl.size),
          ".lch header differs from the host build's")
    check(body.size == kl.size and np.array_equal(body, kl.reshape(-1)),
          ".lch table differs from lc_build_from_sa")
    n_cat = os.path.getsize(prefix)
    say(f"[index] {SIZES['genome_bp']} bp genome, .cat {n_cat} B, hlen "
        f"{hlen}: "
        f"cli index {index_s:.1f}s (lchash on the card); .lch == "
        f"lc_build_from_sa byte for byte ({kl.nbytes + 12} B, host build "
        f"{host_s:.1f}s)")
    return kl


def phase_repeats(rng, work: str) -> None:
    from gen_repeat_genome import build_repeat_genome
    from longreadmapper_tpu.index.device import load_device_index
    from longreadmapper_tpu.models.mapper import TPUMapper
    from longreadmapper_tpu.utils.config import Params
    g = np.frombuffer(build_repeat_genome(rng, SIZES["repeat_bp"]).encode(),
                      np.uint8).copy()
    fa, index_s = build_indexed_genome(g, "repeats", work)
    say(f"[repeats] {SIZES['repeat_bp']} bp, ~45% repeats: cli index "
        f"{index_s:.1f}s")
    reads = simulate_reads(rng, g, SIZES["n_repeat"], 1000, 0.03)
    oracle = Oracle(fa)
    recs, retried = map_phase("repeats", fa, reads, work,
                              SIZES["oracle_repeat"], rng, oracle)
    check(retried > 0, "the exact-slots retry tier never fired")
    # the same sample through the library entry point: which reads took
    # the retry tier, and their records equal the CLI's
    sample = [reads[i] for i in
              rng.choice(len(reads), size=SIZES["oracle_repeat"],
                         replace=False)]
    idx, meta, mta = load_device_index(fa, verbose=False)
    mapper = TPUMapper(idx, meta, mta, Params(), chunk_b=SIZES["chunk"])
    text, _, _ = mapper.collect_chunk_sam(mapper.submit_chunk(
        [(n, s, "I" * len(s)) for n, s in sample]))
    check(mapper.retried_reads > 0,
          "no read of the oracle sample took the retry tier")
    lines = {l.split("\t", 1)[0]: l for l in text.splitlines()}
    for name, seq in sample:
        check(lines[name] == recs[name] == oracle.line(name, seq),
              f"retry-tier sample read {name} differs")
    say(f"[repeats] library re-map of {len(sample)} sampled reads: "
        f"{mapper.retried_reads} took the retry tier; records == cli map "
        f"== oracle")


def _median_time(fn, *args, reps: int = 5) -> tuple:
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return out, sorted(ts)[reps // 2], first


def phase_kernels(card: str) -> None:
    """Both min-plus scan lowerings: equal outputs and their times, alone
    (a 64-row dependent chain, as the DP runs them) and inside the band
    DPs of the map step."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from longreadmapper_tpu.ops import gact, wavefront
    from longreadmapper_tpu.ops.wavefront import (INF, SCAN_LOWERINGS,
                                                  _minplus_scan)

    @partial(jax.jit, static_argnames=("lowering",))
    def chain(x, lowering):
        band = x.shape[-1]

        def step(h, xr):
            return _minplus_scan(jnp.minimum(h + 1, xr), band,
                                 lowering=lowering), None

        return lax.scan(step, x[0], x[1:])[0]

    def compare(what, outs, times, work, firsts=None):
        ref = jax.tree_util.tree_leaves(outs[SCAN_LOWERINGS[0]])
        for lw in SCAN_LOWERINGS[1:]:
            check(all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b
                      in zip(jax.tree_util.tree_leaves(outs[lw]), ref)),
                  f"{what}: the lowerings' outputs differ")
        say(f"[kernels] {what} on {card}: " + ", ".join(
            f"{lw} {work(times[lw])}"
            + (f" (first call {firsts[lw]:.1f}s)" if firsts else "")
            for lw in SCAN_LOWERINGS)
            + f"; outputs equal; rule: {wavefront.SCAN_LOWERING}")

    rng = np.random.default_rng(7)
    rows = 64
    for B, band in SCAN_SHAPES:
        x = jnp.asarray(rng.integers(0, INF + 1, (rows, B, band),
                                     dtype=np.int32))
        outs, times = {}, {}
        for lw in SCAN_LOWERINGS:
            outs[lw], times[lw], _ = _median_time(partial(chain, lowering=lw),
                                                  x)
        compare(f"min-plus scan ({B}, band {band})", outs, times,
                lambda t: f"{t / (rows - 1) * 1e6:.2f} us/row")

    def codes(B, L):
        return (jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.int8)),
                jnp.asarray(rng.integers(0, 4, (B, L), dtype=np.int8)))

    jobs = [(f"XLA banded_nw_dirs_v (B {B}, L {L}, W {W}, band {band}, "
             f"with_nm)", B * L * band, codes(B, L),
             partial(wavefront.banded_nw_dirs_v.__wrapped__, W=W, band=band,
                     with_nm=True))
            for B, L, W, band in DIRS_SHAPES]
    # the full-score DP at the 1 kb chunk's shape (what the removed Pallas
    # scores kernel computed)
    B, L, W, band = DIRS_SHAPES[0]
    jobs.append((f"XLA banded_nw_scores (B {B}, L {L}, W {W}, band {band})",
                 B * L * band, codes(B, L),
                 partial(wavefront.banded_nw_scores.__wrapped__, W=W,
                         band=band)))
    B, L, T, W, band = GACT_SHAPE
    jobs.append((f"XLA gact_forward (B {B}, L {L}, T {T}, W {W}, band "
                 f"{band})", B * L * band, codes(B, L),
                 partial(gact.gact_forward.__wrapped__, T=T, W=W,
                         band=band)))
    rule = wavefront.SCAN_LOWERING
    try:
        for what, cells, (q, t), fn in jobs:
            outs, times, firsts = {}, {}, {}
            for lw in SCAN_LOWERINGS:
                # the lowering is read at trace time: a fresh function
                # (jit caches traces per function object) per rule
                wavefront.SCAN_LOWERING = lw
                outs[lw], times[lw], firsts[lw] = _median_time(
                    jax.jit(lambda q, t, fn=fn: fn(q, t)), q, t)
            wavefront.SCAN_LOWERING = rule
            compare(what, outs, times,
                    lambda t: f"{t * 1e3:.2f} ms = {cells / t / 1e9:.1f} "
                              f"Gcells/s", firsts)
            del outs
    finally:
        wavefront.SCAN_LOWERING = rule


def run_one_card(seed: int, work: str, card: str) -> list:
    failed = []

    def phase(name, fn, *a):
        try:
            return fn(*a)
        except Exception:
            traceback.print_exc()
            say(f"[{name}] FAILED")
            failed.append(name)
            return None

    rng = np.random.default_rng(seed)
    g = make_genome(rng, SIZES["genome_bp"])
    built = phase("index", build_indexed_genome, g, "ecoli_k12_mg1655", work)
    kl = None if built is None else phase("index", phase_index, *built)
    if kl is not None:
        fa = built[0]
        oracle = Oracle(fa, kl=kl)
        del kl
        mix = dict(sub=0.02, ins=0.005, dele=0.005)
        for label, n, length, err, k in (
                ("1kb", SIZES["n_1k"], 1000, dict(sub=0.03),
                 SIZES["oracle_1k"]),
                ("10kb", SIZES["n_10k"], 10_000, mix, SIZES["oracle_10k"]),
                ("50kb", SIZES["n_50k"], 50_000, mix, SIZES["oracle_50k"])):
            reads = simulate_reads(rng, g, n, length, **err)
            phase(label, map_phase, label, fa, reads, work, k, rng, oracle)
        del oracle
    phase("repeats", phase_repeats, rng, work)
    phase("kernels", phase_kernels, card)
    return failed


def device_peaks(devs) -> list:
    return [d.memory_stats()["peak_bytes_in_use"] for d in devs]


def placement_check(fa: str, devs) -> str:
    """load_device_index onto a 1x4 mesh (what `mapdist --shard-index`
    calls) must put one row slice of each big table on each card."""
    from longreadmapper_tpu.index.device import load_device_index
    from longreadmapper_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(n_data=1, n_model=4, devices=devs)
    idx, _, _ = load_device_index(fa, verbose=False, mesh=mesh,
                                  shard_tables=True)
    for name in ("lch", "sa_ctx", "text_packed"):
        a = getattr(idx, name)
        shards = a.addressable_shards
        check({s.device for s in shards} == set(devs),
              f"{name} is not spread over the four cards")
        check(all(s.data.shape[0] * 4 == a.shape[0] for s in shards),
              f"{name} is not row-sharded in quarters")
    return "lch, sa_ctx and text_packed row-sharded in quarters over " \
           "the four cards"


def run_four_cards(seed: int, work: str) -> list:
    """mapdist over four cards (index sharded, then replicated), then the
    one-card reference; SAMs equal, every card holding its index share."""
    import jax
    devs = jax.devices()[:4]
    rng = np.random.default_rng(seed)
    g = make_genome(rng, SIZES["genome_bp"])
    fa, index_s = build_indexed_genome(g, "ecoli_k12_mg1655", work)
    reads = simulate_reads(rng, g, SIZES["n_1k"], 1000, 0.03)
    fq = os.path.join(work, "1kb.fq")
    write_fastq(fq, reads)
    lch_bytes = 4 ** SIZES["hlen"] * 2 * 4   # device lchash, int32 pairs
    say(f"[4cards] cli index {index_s:.1f}s; {len(reads)} reads x 1000 bp")

    outs = {}
    for label, extra, mesh in (("sharded", ["--shard-index"], "1 model=4"),
                               ("replicated", [], "4 model=1")):
        prefix = os.path.join(work, f"dist_{label}.sam")
        t0 = time.perf_counter()
        log = run_cli(["mapdist", fa, fq, str(len(reads)), "20", "300",
                       "--out-prefix", prefix, "--chunk-b",
                       str(SIZES["chunk"]), *extra])
        dt = time.perf_counter() - t0
        check(f"4 devices, mesh data={mesh}" in log,
              f"mapdist {label} did not run on the 4-card mesh")
        valid, total = map(int, logged(
            log, r"global sensitivity: (\d+)/(\d+)="))
        pk = device_peaks(devs)
        outs[label] = prefix + ".part0"
        say(f"[4cards] mapdist {label} (mesh data={mesh}): {valid}/{total} "
            f"valid, {dt:.1f}s incl. index load + compile; peak device "
            f"memory {[round(p / 2**30, 2) for p in pk]} GiB")
        if label == "sharded":
            check(all(p >= 0.9 * lch_bytes / 4 for p in pk),
                  "a card never held its quarter of the lchash table")
        else:
            check(all(p >= lch_bytes for p in pk),
                  "a card never held the replicated lchash table")
    say(f"[4cards] {placement_check(fa, devs)}")
    sam = os.path.join(work, "single.sam")
    t0 = time.perf_counter()
    run_cli(["map", fa, fq, str(len(reads)), "20", "300", "--chunk-b",
             str(SIZES["chunk"]), "--rg-id", "0"], stdout_path=sam)
    single = sam_records(sam)
    check(len(single) == len(reads), "single-card SAM is short")
    for label, path in outs.items():
        check(sam_headers(path, "@SQ") == sam_headers(sam, "@SQ"),
              f"mapdist {label} @SQ header differs")
        check(sam_records(path) == single,
              f"mapdist {label} SAM differs from the single-card SAM")
    say(f"[4cards] single-card cli map {time.perf_counter() - t0:.1f}s; "
        f"both mapdist SAMs == single-card SAM ({len(single)} records)")
    return []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only mapdist over four cards and its "
                         "one-card reference")
    args = ap.parse_args(argv)

    from longreadmapper_tpu.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    import jax
    count = 4 if args.four_cards else 1
    try:
        phase_device(cache_dir, count)
    except Exception as e:
        say(f"[device] FAILED: {e}")
        return 1
    from longreadmapper_tpu.utils.gpu import card_name_and_power_limit
    card = card_name_and_power_limit()[0]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="lrm_smoke_") as work:
        failed = (run_four_cards(args.seed, work) if args.four_cards
                  else run_one_card(args.seed, work, card))
    say(f"[done] {time.perf_counter() - t0:.0f}s after the device phase")
    if failed:
        say(f"FAILED phases: {', '.join(dict.fromkeys(failed))}")
        return 1
    dev = jax.devices()[0]
    say(f"[card] {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
