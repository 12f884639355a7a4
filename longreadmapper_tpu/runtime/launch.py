"""Multi-host distributed mapping launcher.

The reference scales across machines only by SLURM job arrays — one
independent process per parameter point (SURVEY.md P5).  This framework
instead runs ONE logical mapper over every device of one or more hosts:

  - `jax.distributed.initialize()` wires the hosts (from the
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID env
    vars; a single process skips it);
  - a global ('data', 'model') mesh spans every device; each chunk is a
    GLOBAL batch sharded over 'data' (every process parses the shared
    FASTQ and packs only its own contiguous row slice — host-local I/O,
    no central dispatcher);
  - the device index is loaded once per host straight onto the mesh:
    replicated per device, or — `shard_index_tables` — row-sharded over
    the 'model' axis for genomes that exceed one device's memory
    (parallel/dist.shard_index; XLA partitions the seeding gathers into
    per-shard lookups + collectives);
  - the sensitivity counter (alnmain.c:541) is a real cross-device
    collective (psum over 'data', or a GSPMD global sum when the index is
    sharded), so every process logs the same GLOBAL valid count;
  - each process emits SAM for its row slice to `<out>.part<k>`; process
    0 writes the header.  Record order is deterministic: chunk-major,
    then process-slice within the chunk.

Single-process use degenerates to runtime/accaln.run_mapping semantics
(plus the mesh, covering all local devices).
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from ..formats.sam import sam_header
from ..index.device import load_device_index
from ..models.mapper import TPUMapper
from ..utils.config import Params, read_params
from ..utils.log import new_logger
from .reads import chunks, load_read_batches


def init_distributed() -> tuple[int, int]:
    """Initialize jax.distributed when a coordinator is configured.

    Returns (process_index, process_count).  Controlled by the env vars
    JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID; a lone
    process skips initialization."""
    import jax

    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if coord and nproc > 1:
        try:
            jax.distributed.initialize(
                coordinator_address=coord,
                num_processes=nproc,
                process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
        except RuntimeError:
            # already initialized by the caller (initialize() must precede
            # any backend use, so library users may do it themselves)
            pass
    return jax.process_index(), jax.process_count()


def run_distributed(genome_path: str, reads_path: str,
                    params: Optional[Params] = None,
                    out_prefix: Optional[str] = None, rg_id: int = 0,
                    chunk_b: int = 0, shard_index_tables: bool = False,
                    model_shards: int = 0, slim: bool = False,
                    verbose: bool = True) -> tuple[int, int]:
    """Map `reads_path` with one logical mapper over every device.  Returns the GLOBAL (valid, total) — identical on every
    process, via the collective sensitivity counter.

    SAM goes to `<out_prefix>.part<process_index>` (stdout when
    out_prefix is None and the slice is a single process).
    `model_shards` sets the 'model' mesh-axis size when
    `shard_index_tables` (default: all devices, i.e. maximal memory relief;
    the 'data' axis gets the rest)."""
    import jax

    from ..parallel.mesh import make_mesh

    pid, nproc = init_distributed()
    p = params or read_params()
    log = new_logger(verbose=verbose and pid == 0)

    ndev = len(jax.devices())
    n_model = (model_shards or ndev) if shard_index_tables else 1
    assert ndev % n_model == 0, (ndev, n_model)
    mesh = make_mesh(n_data=ndev // n_model, n_model=n_model)

    t0 = log.vlog("process %d/%d: %d devices, mesh data=%d model=%d%s",
                  pid, nproc, ndev, ndev // n_model, n_model,
                  " (index tables sharded)" if shard_index_tables else "")
    # slim composes with table sharding: SA-only sa_ctx + text_pair verify
    # windows shrink each model shard's slice further (the reference's
    # sampled-CSA trade, fmidx.c:153-163, expressed as a layout option).
    # The tables go from host memory straight to their mesh placement, so
    # a sharded index never has to fit on one device.
    idx, meta, mta = load_device_index(genome_path, slim=slim,
                                       verbose=verbose and pid == 0,
                                       mesh=mesh,
                                       shard_tables=shard_index_tables)
    log.vlog("index loaded in %.2fs (n=%d)", log.elapse(t0), meta.n)

    if out_prefix is None and nproc == 1:
        out = sys.stdout
        close = False
    else:
        prefix = out_prefix or "out.sam"
        out = open(f"{prefix}.part{pid}", "w")
        close = True
    if pid == 0:
        out.write(sam_header(mta, rg_id))

    mapper = TPUMapper(idx, meta, mta, p, chunk_b=chunk_b, mesh=mesh,
                       shard_tables=shard_index_tables)
    del idx
    total = local_total = 0
    for batch in load_read_batches(reads_path, p.batch_size):
        # every process walks every GLOBAL chunk (SPMD); the mapper packs
        # and assembles only this process's row slice of each one
        for text, n, _ in mapper.map_stream_sam(chunks(batch, mapper.B)):
            out.write(text)
            local_total += n
        total += len(batch)
    if close:
        out.close()
    valid = mapper.valid_global
    if total:
        log.vlog("global sensitivity: %d/%d=%f (process %d wrote %d records)",
                 valid, total, valid / total, pid, local_total)
    return valid, total
