"""Device-mesh helpers.

The reference has no distributed runtime at all (SURVEY.md §2: files+stdout
are the only IPC; OpenMP threads and SLURM job arrays are its parallelism).
The device-mesh equivalents:

  P3 (chunked batch loop)       -> 'data' mesh axis: reads sharded per chip
  index replication vs sharding -> 'model' mesh axis: SA/lchash tables can be
                                   sharded over chips (BASELINE configs 3-5)
  P5 (SLURM sweeps)             -> multi-host meshes via
                                   jax.distributed.initialize + the same mesh
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """('data', 'model') mesh over the available devices."""
    devs = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devs) // n_model
    devs = devs[: n_data * n_model]
    arr = np.array(devs).reshape(n_data, n_model)
    return Mesh(arr, ("data", "model"))


def data_sharded(mesh: Mesh) -> NamedSharding:
    """Batch-dim sharding over the 'data' axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def model_sharded(mesh: Mesh) -> NamedSharding:
    """Leading-dim sharding over the 'model' axis (for index tables)."""
    return NamedSharding(mesh, P("model"))
