"""Distributed mapping: data-parallel reads over a device mesh.

Design (BASELINE.json north star): reads stream data-parallel across chips
(the device form of the reference's chunked batch loop, alnmain.c:330);
the index is replicated per chip (configs 1-2, 4) or sharded over the
'model' axis (configs 3, 5 — large genomes).  Per-shard results carry a
psum'd valid-read counter so the sensitivity metric (alnmain.c:541) is a
real cross-chip collective; record arrays ride the out-sharding back to the
host (an all-gather at the data boundary).
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..index.device import DeviceIndex
from ..mapping.pipeline import MapperConfig, make_map_step


def _pad0(a, m: int):
    """Pad dim 0 to a multiple of m (pad rows are never gathered — all
    pipeline gathers clip to the true n-1).  Host arrays pad on the host."""
    r = (-a.shape[0]) % m
    if r:
        xp = np if isinstance(a, np.ndarray) else jnp
        a = xp.concatenate([a, xp.zeros((r,) + a.shape[1:], a.dtype)],
                           axis=0)
    return a


def _place(a, sharding):
    """Put one table on the mesh.  Host arrays go straight to the devices
    that hold their slices (no staging copy, and valid in multi-process
    meshes, where a process addresses only its own devices)."""
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        return jax.make_array_from_callback(a.shape, sharding,
                                            lambda i: a[i])
    return jax.device_put(a, sharding)


def shard_index(idx: DeviceIndex, mesh: Mesh, shard_tables: bool = False
                ) -> DeviceIndex:
    """Place the index on the mesh: replicated, or with the big gather
    tables (SA, lchash, text) sharded row-wise over the 'model' axis.
    Takes host (numpy) or device arrays; already-placed arrays stay put."""
    rep = NamedSharding(mesh, P())
    if not shard_tables:
        shard = rep
        nm = 1
    else:
        shard = NamedSharding(mesh, P("model"))
        nm = mesh.shape["model"]
    big = ("sa_ctx", "sa_hi", "lch", "lch_hi", "text_packed", "text_pair")
    return DeviceIndex(**{
        k: (_place(_pad0(a, nm), shard) if k in big and a is not None
            else _place(a, rep))
        for k, a in idx._asdict().items()})


def _valid_count(cfg: MapperConfig, out, lens):
    """Mapped-read count for the sensitivity metric (alnmain.c:541).

    Pad rows (lens == 0) never count: a zero-length read trivially
    'aligns' with ed 0, so the global psum'd counter must mask them."""
    mw = cfg.meta_words
    if "blob" in out:
        meta = jax.lax.bitcast_convert_type(
            out["blob"][:, :4 * mw].reshape(-1, mw, 4), jnp.int32)
    else:
        meta = out["meta"]
    ed = meta[:, mw - 3]
    found = meta[:, 2 if cfg.pos64 else 1]
    return jnp.sum((ed >= 0) & (found != 0) & (lens > 0)).astype(jnp.int32)


def make_sharded_map_step(cfg: MapperConfig, mesh: Mesh,
                          shard_tables: bool = False):
    """Data-parallel mapping step over `mesh`'s 'data' axis.

    cfg.B is the GLOBAL batch.  Returns step(idx, codes, codes_rc, lens,
    limits) -> (out dict, valid_count) where `valid_count` is the GLOBAL
    mapped-read count (a real cross-device collective, replicated to every
    process).

    Two lowerings, matching how the index was placed by `shard_index`:

      shard_tables=False — shard_map over 'data': each shard runs the
        single-chip step on B / n_data reads against its replicated index
        copy; the valid counter is psum'd over the data axis.
      shard_tables=True — GSPMD: the single-chip program runs on the
        GLOBAL batch with the big gather tables row-sharded over 'model';
        XLA partitions the gathers into per-shard lookups + collectives
        (the index never needs to fit on one chip).  The valid counter is
        a global sum (XLA inserts the reduction collective).
    """
    n_data = mesh.shape["data"]
    assert cfg.B % n_data == 0, (cfg.B, n_data)

    if shard_tables:
        inner = make_map_step(cfg)
        data_sh = NamedSharding(mesh, P("data"))

        @jax.jit
        def gspmd_step(idx, codes, codes_rc, lens, limits):
            codes = jax.lax.with_sharding_constraint(codes, data_sh)
            codes_rc = jax.lax.with_sharding_constraint(codes_rc, data_sh)
            lens = jax.lax.with_sharding_constraint(lens, data_sh)
            limits = jax.lax.with_sharding_constraint(limits, data_sh)
            out = inner(idx, codes, codes_rc, lens, limits)
            out = {k: jax.lax.with_sharding_constraint(v, data_sh)
                   for k, v in out.items()}
            return out, _valid_count(cfg, out, lens)

        return gspmd_step

    local_cfg = replace(cfg, B=cfg.B // n_data)
    local_step = make_map_step(local_cfg)

    def shard_fn(idx, codes, codes_rc, lens, limits):
        out = local_step(idx, codes, codes_rc, lens, limits)
        valid = jax.lax.psum(_valid_count(local_cfg, out, lens), "data")
        return out, valid

    out_keys = ("blob", "ops_tail")
    sharded = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P("data"), P("data"), P("data"), P("data")),
        out_specs=({k: P("data") for k in out_keys}, P()),
    )
    return jax.jit(sharded)
