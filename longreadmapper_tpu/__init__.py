"""longreadmapper_tpu — a long-read DNA mapping framework in JAX.

A from-scratch JAX/XLA re-realization of the capabilities of
lisanhu/LongReadMapper (AccSeqV9): reference preprocessing, suffix-array /
FM-index / lchash seed-table construction, batched exact-match seeding via BWT
backward search, histogram diagonal voting, banded (GACT-style) tiled
alignment, and SAM emission — designed for an accelerator (device-resident
index, vectorized gathers, banded wavefront DP, shard_map data parallelism)
rather than ported from the reference's CPU design.

Reference behavior contracts are cited per-module as /root/reference/<file>:<line>.
"""

import os

# The compute path is int32-clean by design: positions, votes, scores and DP
# cells all fit 32 bits for texts < 2^31 bytes (every config short of the
# whole human genome).  Global x64 is NOT enabled; the >2^31-position
# index path enables it at load (index/device._require_x64).

__version__ = "0.1.0"

# Base encoding used throughout the framework: A=0 C=1 G=2 T=3, anything else
# (N, ...) = 4.  The on-disk ".cat" text additionally contains a final '$'
# terminator (reference: asindex.c:108-110) which device layouts encode via an
# explicit dollar position scalar.
A, C, G, T, NBASE = 0, 1, 2, 3, 4
