"""External-memory SA construction must be byte-identical to the in-RAM
SA-IS on every text — including tandem/satellite texts where block
extensions tie (the margin-prefix repair path) and merge keys collide
(the comparator-run path)."""

import os

import numpy as np
import pytest

from longreadmapper_tpu import native
from longreadmapper_tpu.formats.ui40 import read_sa5
from longreadmapper_tpu.index.sa_external import sa_build_external


def _check(tmp_path, text: bytes, ram: int, margin: int):
    p = str(tmp_path / "t.cat")
    with open(p, "wb") as f:
        f.write(text)
    sa_build_external(p, ram, margin=margin)
    got = read_sa5(p + ".sa5")
    want = native.suffix_array(np.frombuffer(text, dtype=np.uint8))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,ram,margin", [
    (5_000, 6_000, 32),       # ~10 blocks
    (60_000, 30_000, 64),     # ~24 blocks
    (999, 10 ** 9, 32),       # single block (degenerate)
])
def test_random_text(tmp_path, n, ram, margin):
    rng = np.random.default_rng(n)
    text = rng.choice(list(b"ACGT"), n).astype(np.uint8).tobytes() + b"$"
    _check(tmp_path, text, ram, margin)


def test_satellite_tandem(tmp_path):
    """Period-7 tandem array: every block extension ties (margin-equal
    runs span whole blocks) and 24-byte merge keys collide massively."""
    unit = b"ACGTGCA"
    text = unit * 3000 + b"$"            # 21 kb, lcps in the thousands
    _check(tmp_path, text, 12_000, 32)


def test_mixed_repeats(tmp_path):
    rng = np.random.default_rng(3)
    parts = []
    motif = rng.choice(list(b"ACGT"), 60).astype(np.uint8).tobytes()
    for _ in range(200):
        if rng.random() < 0.5:
            parts.append(motif)
        else:
            parts.append(rng.choice(list(b"ACGT"), 100
                                    ).astype(np.uint8).tobytes())
    text = b"".join(parts) + b"$"
    _check(tmp_path, text, 9_000, 48)


def test_native_merge_matches_numpy_merge(tmp_path, monkeypatch):
    """The native streamed merge (samerge.cpp) and the numpy prefix-key
    merge must emit byte-identical .sa5 — including on a tandem text
    whose 24-byte merge keys collide across blocks."""
    if native._load() is None:
        pytest.skip("no native toolchain")
    rng = np.random.default_rng(11)
    unit = b"ACGTGCA"
    texts = [
        unit * 2000 + b"$",
        rng.choice(list(b"ACGT"), 40_000).astype(np.uint8).tobytes() + b"$",
    ]
    for i, text in enumerate(texts):
        p = str(tmp_path / f"m{i}.cat")
        with open(p, "wb") as f:
            f.write(text)
        monkeypatch.setenv("LRM_SA_MERGE", "py")
        sa_build_external(p, 12_000, margin=32)
        with open(p + ".sa5", "rb") as f:
            want = f.read()
        monkeypatch.setenv("LRM_SA_MERGE", "native")
        sa_build_external(p, 12_000, margin=32)
        with open(p + ".sa5", "rb") as f:
            got = f.read()
        assert got == want


def test_cat_roundtrip_matches_in_ram_build(tmp_path):
    """Real artifact flow: sa_build(ram_use=...) routes through the
    external builder and produces a byte-identical .sa5."""
    from longreadmapper_tpu.formats.catmeta import create_meta
    from longreadmapper_tpu.index.sa import sa_build

    from conftest import make_genome, write_fasta

    rng = np.random.default_rng(5)
    fa = str(tmp_path / "g.fa")
    write_fasta(fa, [("c1", make_genome(rng, 15000))])
    create_meta(fa, n_seed=0)
    prefix = fa + ".cat"

    sa_ram = sa_build(prefix)
    ram_bytes = os.path.getsize(prefix) * 12 // 8  # force ~8 blocks
    sa_ext = sa_build(prefix, ram_use=ram_bytes)
    np.testing.assert_array_equal(sa_ext, sa_ram)


@pytest.mark.skipif(os.environ.get("LRM_BIG_SA_EXT") != "1",
                    reason="set LRM_BIG_SA_EXT=1 (2.5e9 chars, ~1-2 h)")
def test_big_external_build(tmp_path):
    """Genome-scale external build at a 16 GB budget (a quarter of this
    host's RAM; the in-RAM build needs ~29 GB at this n) — runs via the
    dev script in a subprocess so the working set is released."""
    import subprocess
    import sys

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "scripts", "sa_external_check.py"),
         "--mb", "2500", "--ram-mb", "16384"],
        capture_output=True, text=True, timeout=4 * 3600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "EXACT" in r.stdout, r.stdout[-2000:]
    print(r.stdout.strip())
