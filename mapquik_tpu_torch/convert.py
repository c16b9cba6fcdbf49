"""Carry state across from the JAX package: its HashIndex (keys and pay as
numpy arrays), ShardedHashIndex, RefMeta and Params become the port's, so
both packages map against the same tables. Takes plain arrays and
attributes; imports nothing of the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .index.build import RefMeta
from .index.hashtable import BUCKET, HashIndex, key_lane, pay_lane
from .params import Params

_NCOL = 6  # the JAX sharded table's columns per slot: h1, h2, ridrc, start, end, offset


def params_from_jax(jax_params) -> Params:
    """The port's Params from a JAX Params (or its dataclasses.asdict).

    The port implements the gather-free chain only (chain_scan=True) and has
    no dispatch groups, so those two fields are checked and dropped."""
    d = dict(jax_params) if isinstance(jax_params, dict) else dataclasses.asdict(jax_params)
    if not d.pop("chain_scan", True):
        raise ValueError("the port implements chain_scan=True only")
    d.pop("dispatch_group", None)
    d["length_bins"] = tuple(d["length_bins"])
    return Params(**d)


def hash_index_from_jax(index, device=None) -> HashIndex:
    """The port's HashIndex from a JAX HashIndex (v4 grouped rows), on device."""
    device = resolve_device(device)
    keys = np.array(index.keys).view(np.int32)  # a writable copy
    pay = np.array(index.pay).view(np.int32)
    if keys.ndim != 2 or keys.shape[1] != 128 or pay.shape != (keys.shape[0] * 2, 128):
        raise ValueError(f"not a v4 hash table: keys {keys.shape}, pay {pay.shape}")
    return HashIndex(keys=torch.from_numpy(keys).to(device),
                     pay=torch.from_numpy(pay).to(device))


def sharded_index_from_jax(sidx, mesh=None):
    """The port's ShardedHashIndex from a JAX one: per shard, flat fused int32
    slots [S * 8 * 6] holding the shard's table of tS buckets repeated S / tS
    times. Each shard's tS is the smallest power of two (from 16, the build's
    least size) whose span the slots repeat; that span is regrouped into v4
    (keys, pay) and placed on mesh.devices[s] (on the card when mesh is None)."""
    from .parallel.sharded_index import ShardedHashIndex

    slots = np.asarray(sidx.slots).view(np.int32)
    D = slots.shape[0]
    if mesh is not None and mesh.size != D:
        raise ValueError(f"index built for {D} shards, mesh has {mesh.size}")
    S = slots.shape[1] // (BUCKET * _NCOL)
    tables = []
    for s in range(D):
        tS = 16
        while tS < S and not (slots[s].reshape(S // tS, -1) == slots[s, : tS * BUCKET * _NCOL]
                              ).all():
            tS *= 2
        fused = slots[s, : tS * BUCKET * _NCOL].reshape(-1, _NCOL)
        si = np.arange(tS * BUCKET, dtype=np.int64)
        keys = np.empty(tS * BUCKET * 2, dtype=np.int32)
        pay = np.empty(tS * BUCKET * 4, dtype=np.int32)
        keys[key_lane(si)] = fused[:, 0]
        keys[key_lane(si) + 1] = fused[:, 1]
        for c in range(4):
            pay[pay_lane(si) + c] = fused[:, 2 + c]
        dev = mesh.devices[s] if mesh is not None else resolve_device(None)
        tables.append(HashIndex(keys=torch.from_numpy(keys.reshape(-1, 128)).to(dev),
                                pay=torch.from_numpy(pay.reshape(-1, 128)).to(dev)))
    return ShardedHashIndex(tuple(tables), int(sidx.n))


def ref_meta_from_jax(meta) -> RefMeta:
    return RefMeta(names=list(meta.names), lengths=np.asarray(meta.lengths, dtype=np.int64))


def from_jax(index, meta, params, device=None):
    """(HashIndex, RefMeta, Params) of the port from the JAX package's."""
    return hash_index_from_jax(index, device), ref_meta_from_jax(meta), params_from_jax(params)
