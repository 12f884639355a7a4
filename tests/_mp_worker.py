"""Subprocess worker for the 2-process CPU-mesh launcher test.

Usage: python _mp_worker.py <pid> <nproc> <port> <ndev_per_proc> <fa> <fq>
                            <out_prefix> <shard(0|1)> <chunk_b>
                            [model_shards]

Each process forms its own 4-device virtual CPU node; the two nodes wire
up via jax.distributed (Gloo CPU collectives) into one 8-device mesh —
the smallest faithful model of a multi-host mesh.
"""

import os
import sys

pid, nproc, port, ndev = (int(a) for a in sys.argv[1:5])
fa, fq, out_prefix, shard, chunk_b = sys.argv[5:10]
model_shards = int(sys.argv[10]) if len(sys.argv) > 10 else 0

os.environ["JAX_PLATFORMS"] = "cpu"
# the default CPU-collective deadline is 30 s; on a single-core host two
# workers can drift past it while tracing/compiling cache-cold programs
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={ndev}"
                           + " --xla_cpu_collective_timeout_seconds=600")
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = str(nproc)
os.environ["JAX_PROCESS_ID"] = str(pid)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from longreadmapper_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
jax.config.update("jax_cpu_collectives_implementation", "gloo")
# must run before ANY backend use (library imports build jnp constants)
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)

from longreadmapper_tpu.runtime.launch import run_distributed
from longreadmapper_tpu.utils.config import Params

params = Params(hlen=6, seed_len=20, thres=300, batch_size=64)
valid, total = run_distributed(
    fa, fq, params, out_prefix=out_prefix, rg_id=0,
    chunk_b=int(chunk_b), shard_index_tables=shard == "1",
    model_shards=model_shards, verbose=False)
print(f"WORKER_OK pid={pid} valid={valid} total={total}", flush=True)
