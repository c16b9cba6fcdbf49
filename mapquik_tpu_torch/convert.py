"""Carry state across from the JAX package: its HashIndex (keys and pay as
numpy arrays), RefMeta and Params become the port's, so both packages map
against the same table. Takes plain arrays and attributes; imports nothing of
the JAX package."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve_device
from .index.build import RefMeta
from .index.hashtable import HashIndex
from .params import Params


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


def ref_meta_from_jax(meta) -> RefMeta:
    return RefMeta(names=list(meta.names), lengths=np.asarray(meta.lengths, dtype=np.int64))


def from_jax(index, meta, params, device=None):
    """(HashIndex, RefMeta, Params) of the port from the JAX package's."""
    return hash_index_from_jax(index, device), ref_meta_from_jax(meta), params_from_jax(params)
