"""Test harness config: force an 8-device virtual CPU mesh BEFORE jax import
so sharding tests run anywhere (SURVEY.md §7; multi-chip dry-run contract)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

from longreadmapper_tpu.utils.compile_cache import enable_compile_cache

# every XLA compile costs seconds on a small host — persist the cache
enable_compile_cache()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


def make_genome(rng, length: int, n_frac: float = 0.0) -> str:
    """Random ACGT genome string with optional N fraction (dna_txt_gen.py
    equivalent — reference scripts/dna_txt_gen.py:12)."""
    bases = rng.integers(0, 4, length)
    seq = np.frombuffer(b"ACGT", dtype=np.uint8)[bases].copy()
    if n_frac > 0:
        mask = rng.random(length) < n_frac
        seq[mask] = ord("N")
    return seq.tobytes().decode("ascii")


def write_fasta(path: str, seqs):
    with open(path, "w") as f:
        for name, seq in seqs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 70):
                f.write(seq[i:i + 70] + "\n")


def sample_reads(rng, genome: str, n_reads: int, read_len: int,
                 error_rate: float = 0.0, rc_frac: float = 0.5):
    """Sample reads from both strands with substitution errors.

    Returns list of (name, seq, true_pos, strand).
    """
    comp = {"A": "T", "C": "G", "G": "C", "T": "A", "N": "N"}
    alpha = "ACGT"
    out = []
    for i in range(n_reads):
        pos = int(rng.integers(0, len(genome) - read_len))
        seq = genome[pos:pos + read_len]
        strand = int(rng.random() < rc_frac)
        if strand:
            seq = "".join(comp[c] for c in reversed(seq))
        if error_rate > 0:
            chars = list(seq)
            for j in range(read_len):
                if rng.random() < error_rate:
                    chars[j] = alpha[int(rng.integers(0, 4))]
            seq = "".join(chars)
        out.append((f"read{i}", seq, pos, strand))
    return out


def write_fastq(path: str, reads):
    with open(path, "w") as f:
        for name, seq, *_ in reads:
            f.write(f"@{name}\n{seq}\n+\n{'I' * len(seq)}\n")
