"""Mapping driver — the `accaln` equivalent (/root/reference/alnmain.c:277-551).

Loads the persisted index to the device, streams read batches, runs the
jitted mapping step per chunk, and emits SAM.  Logs phase timings and the
final sensitivity ratio valid/total (alnmain.c:541-542).
"""

from __future__ import annotations

import sys
from typing import Optional, TextIO

from ..formats.sam import sam_header
from ..index.device import load_device_index
from ..models.mapper import TPUMapper
from ..utils.config import Params, read_params
from ..utils.log import new_logger
from .reads import chunks, load_read_batches


def run_mapping(genome_path: str, reads_path: str,
                params: Optional[Params] = None,
                out: Optional[TextIO] = None, rg_id: int = 0,
                chunk_b: int = 0, verbose: bool = True,
                slim: bool = False) -> tuple[int, int]:
    """Map `reads_path` against the index of `genome_path`; SAM to `out`.

    `slim` selects the reduced-memory index layout (IndexMeta.slim: SA-only
    sa_ctx + per-vote text window recompute) for genomes near the
    device memory ceiling.  Returns (valid, total).
    """
    p = params or read_params()
    out = out or sys.stdout
    log = new_logger(verbose=verbose)

    log.vlog("Start initialization")
    t0 = log.vlog("loading index artifacts for %s", genome_path)
    idx, meta, mta = load_device_index(genome_path, slim=slim,
                                       verbose=verbose)
    log.vlog("index loaded in %.2fs (n=%d, hlen=%d, %s positions)",
             log.elapse(t0), meta.n, meta.hlen, meta.pos_dtype)
    log.vlog("Current settings:")
    log.vlog("batch_size: %d", p.batch_size)
    log.vlog("seed_length: %d", p.seed_len)
    log.vlog("non-informative seeds threshold: %d", p.thres)

    out.write(sam_header(mta, rg_id))

    mapper = TPUMapper(idx, meta, mta, p, chunk_b=chunk_b)
    total = valid = 0
    for batch in load_read_batches(reads_path, p.batch_size):
        t0 = log.vlog("processing batch of %d reads", len(batch))
        for text, n, v in mapper.map_stream_sam(chunks(batch, mapper.B)):
            out.write(text)
            total += n
            valid += v
        log.vlog("batch done in %.2fs (total %d)", log.elapse(t0), total)

    log.vlog("Done aligning")
    if total:
        log.vlog("Sensitivity: %d/%d=%f", valid, total, valid / total)
    log.vlog("host phases: %s", " ".join(
        f"{k}={v:.3f}s" for k, v in mapper.phase_s.items()))
    log.vlog("retry tiers: %d reads re-mapped exactly, %d chunks re-walked, "
             "%d reads flagged", mapper.retried_reads,
             mapper.retried_sat_chunks, mapper.overflow_reads)
    return valid, total
