"""CLI operability contracts: --quiet silence, --no-devidx, and warmup
precompiling EVERY step variant the stream can dispatch (host-encode for
ragged chunks, raw device-encode for uniform chunks, the exact-slots
overflow retry tier) — a "successful" warmup must leave no minutes-long
mid-stream compile (reference cold start is fread-only, alnmain.c:192-252).
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from conftest import make_genome, sample_reads, write_fasta

HLEN = 5


def _own_log_lines(stderr: str):
    """Our logger's stderr lines, dropping XLA/absl C++ noise (e.g.
    'E0817 ... cpu_aot_loader.cc' machine-feature warnings from a
    compilation cache built on another machine)."""
    return [l for l in stderr.splitlines()
            if l.strip()
            and not (len(l) > 2 and l[0] in "EWIF" and l[1].isdigit())
            and "WARNING" not in l]


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _child_env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(33)
    genome = make_genome(rng, 20000)
    fa = str(tmp / "ref.fa")
    write_fasta(fa, [("c1", genome)])
    reads = sample_reads(rng, genome, 6, 300, error_rate=0.03)
    rf = str(tmp / "reads.fa")
    with open(rf, "w") as f:
        for name, seq, *_ in reads:
            f.write(f">{name}\n{seq}\n")
    return fa, rf


def test_cli_quiet_is_silent(ref):
    fa, rf = ref
    env = _child_env()
    r = subprocess.run(
        [sys.executable, "-m", "longreadmapper_tpu.cli", "index", fa,
         "--host-only", "--hlen", str(HLEN), "--quiet"],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not r.stdout.strip(), r.stdout[-500:]
    assert not _own_log_lines(r.stderr), _own_log_lines(r.stderr)[:5]
    assert os.path.isdir(fa + ".cat.devidx")  # devidx persists at build

    r = subprocess.run(
        [sys.executable, "-m", "longreadmapper_tpu.cli", "map", fa, rf,
         "--quiet"],
        capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    # SAM on stdout; NOTHING of ours on stderr (incl. the devidx
    # cache-hit line — load_device_index must honor verbose=False)
    assert not _own_log_lines(r.stderr), _own_log_lines(r.stderr)[:5]
    recs = [l for l in r.stdout.splitlines() if l and not l.startswith("@")]
    assert len(recs) == 6 and all(len(l.split("\t")) == 12 for l in recs)


def test_cli_no_devidx_skips_cache(ref, tmp_path):
    fa0, _ = ref
    genome = "".join(l.strip() for l in open(fa0) if not l.startswith(">"))
    fa = str(tmp_path / "nd.fa")
    write_fasta(fa, [("c1", genome)])
    r = subprocess.run(
        [sys.executable, "-m", "longreadmapper_tpu.cli", "index", fa,
         "--host-only", "--hlen", str(HLEN), "--no-devidx", "--quiet"],
        capture_output=True, text=True, env=_child_env(), timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not os.path.isdir(fa + ".cat.devidx")


def test_warmup_covers_all_step_variants(ref):
    from longreadmapper_tpu.index.device import load_device_index
    from longreadmapper_tpu.models.mapper import TPUMapper
    from longreadmapper_tpu.utils.config import Params

    fa, _ = ref
    idx, meta, mta = load_device_index(fa, verbose=False)
    mapper = TPUMapper(idx, meta, mta, Params(hlen=HLEN), chunk_b=8)
    mapper.warmup([256])
    assert list(mapper._steps) == [256]
    assert list(mapper._raw_steps) == [256]      # uniform-chunk variant
    assert list(mapper._retry_steps) == [256]    # overflow retry tier
