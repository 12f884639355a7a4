"""End-to-end mapping throughput on one GPU.

Prints ONE JSON line:
  {"metric": "reads_per_s_per_chip", "value": N, "unit": "reads/s",
   "vs_baseline": N / <numpy-oracle reads/s on this host>,
   "device_kind": ..., "card": "<name>, <power limit>"}
Fails when JAX finds no GPU.

The reference publishes no numbers (BASELINE.md) and its ALIGNER binary
cannot be built (the gact/ submodule is absent upstream; the index builder
CAN be — see scripts/build_reference_accidx.sh and the byte-parity test),
so the recorded baseline is the pure-Python/numpy oracle transcription of
the reference pipeline running on this host's CPU — the same work, same
parameters, same results.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

GENOME_MB = int(os.environ.get("GMB", 4))
N_READS = int(os.environ.get("NREADS", 16384))
READ_LEN = int(os.environ.get("RLEN", 1000))
ERR = float(os.environ.get("ERR", 0.03))
# hlen is an INDEX-BUILD tuning knob our framework surfaces (the
# reference hard-codes 12, asindex.c:142): expand-and-verify's dominant
# sa_ctx gather scales with the vote-slot budget, which scales with the
# lchash background rate n/4^hlen — the deeper table trades 2.1 GB of
# device memory for a 112 -> 80 slot budget.  SAM output is
# hlen-independent (oracle runs the same hlen).
# default = the production auto-hlen rule (utils/config.auto_hlen): the
# bench genome and `cli index` now land on the same table depth
HLEN = int(os.environ.get("HLEN", 14))
CHUNK_B = int(os.environ.get("CHUNK_B", 2048))
PASSES = int(os.environ.get("PASSES", 5))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main():
    import jax
    from longreadmapper_tpu.utils.compile_cache import enable_compile_cache
    from longreadmapper_tpu.utils.gpu import card_name_and_power_limit

    enable_compile_cache()
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py measures a GPU; JAX's backend is "
                 f"{jax.default_backend()!r}")
    card = card_name_and_power_limit()[0]
    from longreadmapper_tpu.formats.catmeta import create_meta, load_cat
    from longreadmapper_tpu.index.fmi import FMIndex
    from longreadmapper_tpu.index.lchash import lc_build_from_sa
    from longreadmapper_tpu.index.sa import sa_build
    from longreadmapper_tpu.models.mapper import TPUMapper
    from longreadmapper_tpu.oracle.refpipe import OracleMapper
    from longreadmapper_tpu.utils.config import Params

    log("devices:", jax.devices(), "card:", card)
    # BENCH_CACHE (default 1): reuse a deterministic per-config dir so
    # repeated invocations skip the host index build; the genome/reads are
    # seeded and the devidx cache is fingerprint+version checked, so the
    # cached artifacts are identical to a fresh build.  BENCH_CACHE=0
    # forces a from-scratch build in a fresh tempdir.
    if os.environ.get("BENCH_CACHE", "1") == "1":
        tmp = os.path.join(tempfile.gettempdir(),
                           f"lrm_bench_cache_g{GENOME_MB}_h{HLEN}")
        os.makedirs(tmp, exist_ok=True)
    else:
        tmp = tempfile.mkdtemp(prefix="lrm_bench_")
    rng = np.random.default_rng(2026)

    # --- data
    n = GENOME_MB * 1_000_000
    genome = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
    fa = os.path.join(tmp, "ref.fa")
    if not (os.path.exists(fa) and os.path.getsize(fa) > n):
        with open(fa, "w") as f:
            f.write(">chr1\n")
            step = 1 << 16
            for i in range(0, n, step):
                f.write(genome[i:i + step] + "\n")
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i in range(N_READS):
        p = int(rng.integers(0, n - READ_LEN))
        s = genome[p:p + READ_LEN]
        if rng.random() < 0.5:
            s = s.translate(comp)[::-1]
        chars = np.frombuffer(s.encode(), np.uint8).copy()
        mask = rng.random(READ_LEN) < ERR
        chars[mask] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(mask.sum()))]
        reads.append((f"r{i}", chars.tobytes().decode(), "I" * READ_LEN))

    # --- index build: write the full artifact set once, then load through
    # the production `load_device_index` path (its devidx cache makes
    # BENCH_CACHE reruns I/O-bound)
    params = Params(hlen=HLEN)
    prefix = fa + ".cat"
    artifacts = (fa + ".mta", prefix, prefix + ".sa5", prefix + ".mfi",
                 prefix + ".lch")
    if not all(os.path.exists(p) for p in artifacts):
        from longreadmapper_tpu.formats.lch import write_lch
        from longreadmapper_tpu.index.fmi import encode_bytes
        t0 = time.time()
        create_meta(fa, n_seed=0)
        sa = sa_build(prefix)
        fmi_b = FMIndex.build(prefix, sa=sa)
        fmi_b.write(prefix)
        log(f"host index build (SA+FMI): {time.time() - t0:.1f}s")
        t0 = time.time()
        kl = lc_build_from_sa(sa, encode_bytes(load_cat(prefix)), HLEN)
        write_lch(prefix + ".lch", HLEN, kl)
        log(f"SA-derived lchash build (4^{HLEN} k-mers): "
            f"{time.time() - t0:.1f}s")
        del sa, fmi_b, kl
    t0 = time.time()
    from longreadmapper_tpu.index.device import load_device_index
    idx, meta, mta = load_device_index(fa)
    log(f"device index load: {time.time() - t0:.1f}s "
        f"(hlen={meta.hlen}, n={meta.n})")

    mapper = TPUMapper(idx, meta, mta, params, chunk_b=CHUNK_B)

    # --- warmup (compile)
    t0 = time.time()
    recs = mapper.map_chunk(reads[:CHUNK_B])
    log(f"warmup chunk (compile+run): {time.time() - t0:.1f}s; "
        f"valid {sum(r.valid for r in recs)}/{CHUNK_B}")

    # --- timed (device/host overlapped stream); five passes, report the
    # steady-state (fastest) one
    # the timed loop runs the PRODUCTION output path (SAM text, same as
    # `cli map`) — the reference's unit of work is reads -> SAM records
    best_dt, valid = None, 0
    for _ in range(PASSES):
        mapper.phase_s = {k: 0.0 for k in mapper.phase_s}
        t0 = time.time()
        total = valid = 0
        chunk_iter = (reads[s:s + CHUNK_B]
                      for s in range(0, N_READS, CHUNK_B))
        sam_bytes = 0
        for text, n_recs, n_valid in mapper.map_stream_sam(chunk_iter):
            sam_bytes += len(text)
            valid += n_valid
            total += n_recs
        dt = time.time() - t0
        ph = " ".join(f"{k}={v:.2f}s" for k, v in mapper.phase_s.items())
        log(f"pass: {dt:.2f}s ({total / dt:.0f} reads/s) host phases: {ph}")
        best_dt = dt if best_dt is None else min(best_dt, dt)
    dt = best_dt
    rps = total / dt
    from longreadmapper_tpu.models.mapper import _bucket_len
    bcfg = mapper._steps[_bucket_len(READ_LEN)][0]
    cells = total * READ_LEN * (2 * bcfg.W + 1)
    log(f"mapped {total} reads in {dt:.2f}s -> {rps:.1f} reads/s "
        f"(valid {valid}/{total}); DP ~{cells / dt / 1e9:.2f} Gcells/s")

    # --- oracle baseline (few reads, extrapolate)
    from longreadmapper_tpu.formats.lch import read_lch
    fmi = FMIndex.read(prefix, with_sa=True)
    o_hlen, kl = read_lch(prefix + ".lch")
    cat = load_cat(prefix)
    oracle = OracleMapper(fmi, kl, o_hlen, cat, mta, params)
    t0 = time.time()
    n_o = 3
    for name, s, _ in reads[:n_o]:
        oracle.map_read(s)
    o_rps = n_o / (time.time() - t0)
    log(f"oracle baseline: {o_rps:.2f} reads/s")

    row = {
        "metric": "reads_per_s_per_chip",
        "value": round(rps, 2),
        "unit": "reads/s",
        "vs_baseline": round(rps / o_rps, 2),
    }
    if READ_LEN != 1000:        # long-read rows are self-describing
        row.update(read_len=READ_LEN, sensitivity=round(valid / total, 4))
    row.update(device_kind=jax.devices()[0].device_kind, card=card)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
