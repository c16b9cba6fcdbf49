"""Index files: save and load the built reference index as one .npz
(counterpart of `mapquik_tpu/index/serialize.py`; the same v4 format, so a
file moves between the two packages in both directions).

`--save-index idx.npz` once, then `--load-index idx.npz` skips the index
build. Version 2 and 3 files (slot layouts [S, 8, 7] and [S, 8, 6]) are
upgraded to v4 on load.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..params import Params
from .build import RefMeta
from .hashtable import HashIndex, pack_slots

_FORMAT_VERSION = 4  # v4: 128-lane grouped (keys, pay) rows; v3 [S,8,6]; v2 [S,8,7]


def save_index(path: str, index: HashIndex, meta: RefMeta, params_key: str = "") -> None:
    """Write a HashIndex and its reference metadata to `path`."""
    if not isinstance(index, HashIndex):
        raise TypeError(f"unknown index type {type(index)!r}")
    cols = {f"col_{name}": v.cpu().numpy() for name, v in index._asdict().items()}
    np.savez_compressed(
        path,
        version=np.int64(_FORMAT_VERSION),
        kind="hash",
        params_key=params_key,
        # fixed-width unicode, not dtype=object, so that load_index can refuse
        # pickled payloads: a shared index file must never run code
        names=np.asarray(meta.names, dtype=np.str_),
        lengths=meta.lengths,
        **cols,
    )


def load_index(path: str, expect_params_key: str = "", device=None
               ) -> Tuple[HashIndex, RefMeta]:
    """An index saved by save_index (either package's), on `device` (CUDA
    unless "cpu"). Raises on an unknown version, a params mismatch, a sorted
    index or a pickled payload."""
    device = resolve_device(device)
    z = np.load(path, allow_pickle=False)
    version = int(z["version"])
    if version not in (2, 3, _FORMAT_VERSION):
        raise ValueError(f"index format version {version} unsupported")
    saved_key = str(z["params_key"])
    if expect_params_key and saved_key and saved_key != expect_params_key:
        raise ValueError(
            f"index was built with params {saved_key!r}, run requests "
            f"{expect_params_key!r} — rebuild or drop --load-index"
        )
    kind = str(z["kind"])
    if kind != "hash":
        raise ValueError(f"index kind {kind!r} is not supported here: only hash "
                         "indexes are; rebuild the index")
    meta = RefMeta(names=[str(n) for n in z["names"]], lengths=z["lengths"])
    if version < _FORMAT_VERSION:
        if version == 2:
            # v2 stored (h1, h2, rid, start, end, offset, rc); fold rid and rc
            # into the v3 ridrc column, which is 0 in empty slots
            s7 = z["col_slots"]
            s6 = np.concatenate(
                [s7[..., :2], ((s7[..., 2] << 1) | s7[..., 6])[..., None], s7[..., 3:6]],
                axis=-1,
            )
            empty = (s7[..., 0] == -1) & (s7[..., 1] == -1)
            s6[..., 2][empty] = 0
        else:
            s6 = z["col_slots"]
        # every v3 slot, empty ones included, goes to the same flat slot in v4
        flat = s6.reshape(-1, 6)
        keys, pay = pack_slots(
            s6.shape[0], np.arange(flat.shape[0], dtype=np.int64),
            flat[:, 0].astype(np.uint32), flat[:, 1].astype(np.uint32),
            flat[:, 2] >> 1, flat[:, 3], flat[:, 4], flat[:, 5], flat[:, 2] & 1,
        )
    else:
        keys, pay = z["col_keys"], z["col_pay"]
    return (HashIndex(keys=torch.from_numpy(np.ascontiguousarray(keys, np.int32)).to(device),
                      pay=torch.from_numpy(np.ascontiguousarray(pay, np.int32)).to(device)),
            meta)


def params_key(p: Params) -> str:
    """Semantic-parameter fingerprint for index compatibility checks."""
    return f"k{p.k}-l{p.l}-d{p.density:g}-hpc{int(p.use_hpc)}"
