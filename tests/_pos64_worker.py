"""Subprocess worker: map with the genome-scale split-hi int64 position
layout forced on a small index, SAM to stdout.

Runs in its own process because force_pos_dtype='int64' enables jax x64
mode globally (required for int64 position arithmetic).

Usage: python _pos64_worker.py <ref.fa> <reads.fq> <batch> <seed_len> <thres>
       [slim]
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from longreadmapper_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

fa, fq = sys.argv[1], sys.argv[2]
batch, seed_len, thres = (int(a) for a in sys.argv[3:6])
slim = len(sys.argv) > 6 and sys.argv[6] == "slim"

from longreadmapper_tpu.formats.sam import sam_header
from longreadmapper_tpu.index.device import load_device_index
from longreadmapper_tpu.models.mapper import TPUMapper
from longreadmapper_tpu.runtime.reads import chunks, load_read_batches
from longreadmapper_tpu.utils.config import Params

idx, meta, mta = load_device_index(fa, force_pos_dtype="int64", slim=slim)
assert meta.pos_dtype == "int64", meta
assert meta.slim == slim
assert idx.sa_hi is not None and idx.lch_hi is not None
assert jax.config.jax_enable_x64

params = Params(hlen=meta.hlen, seed_len=seed_len, thres=thres,
                batch_size=batch)
mapper = TPUMapper(idx, meta, mta, params, chunk_b=16)
out = sys.stdout
out.write(sam_header(mta, 0))
for b in load_read_batches(fq, params.batch_size):
    for recs in mapper.map_stream(chunks(b, mapper.B)):
        for rec in recs:
            out.write(rec.to_sam())
print("POS64_OK", file=sys.stderr)
