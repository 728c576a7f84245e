"""Checkpoint/resume for chain ensembles.

The reference has none (SURVEY.md §5.4): tables rebuild from scratch per
process.  Here a checkpoint is exactly what §5.4 prescribes -- RNG keys +
chain positions + the table *config* (tables are deterministic functions
of (a-grid, N, M), so they rebuild on load rather than being serialised;
a 100-point grid rebuilds on the device from its config, far cheaper
than writing GBs).

Format: one ``.npz`` with flattened pytree leaves + a JSON sidecar for
the treedef/meta.  Multi-host: each process saves its addressable shards
(``process_index`` suffix); ``load`` reassembles a host-local array (the
caller re-shards with parallel.mesh.shard_chain_tree).
"""
from __future__ import annotations

import json
import os
from typing import Any, Optional

import jax
import numpy as np

__all__ = ["save", "load"]

_FORMAT = 1


def save(path: str, state: Any, meta: Optional[dict] = None) -> str:
    """Write ``state`` (a pytree of arrays) + ``meta`` (JSON-able) to
    ``path`` (.npz appended if missing).  Returns the final path.

    Multi-host: each process writes ``<path>.p<process_index>.npz`` with
    its addressable shards, so saves on a shared filesystem never collide;
    single-host saves keep the plain name."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrs = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, jax.Array):
            # key arrays serialise as their raw uint32 data
            if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
                arrs[f"leaf{i}__key"] = np.asarray(jax.random.key_data(leaf))
                continue
            if not leaf.is_fully_addressable:
                # keep only this process's UNIQUE shards (reassembled on
                # load by the caller re-sharding with parallel.mesh).
                # Dedup by shard index: a leaf replicated over any mesh
                # axis yields one identical shard per local device, and
                # naively concatenating them would silently stack copies.
                uniq = {}
                for s in leaf.addressable_shards:
                    k = tuple((sl.start if sl.start is not None else 0,
                               sl.stop if sl.stop is not None else -1)
                              for sl in s.index)
                    uniq.setdefault(k, s.data)
                if len(uniq) == 1:
                    # fully replicated (or one distinct shard): save the
                    # single copy as-is
                    leaf = np.asarray(next(iter(uniq.values())))
                else:
                    leaf = np.concatenate(
                        [np.asarray(v) for _, v in sorted(uniq.items())])
            else:
                leaf = np.asarray(jax.device_get(leaf))
        arrs[f"leaf{i}"] = np.asarray(leaf)
    if path.endswith(".npz"):
        path = path[: -len(".npz")]
    if jax.process_count() > 1:
        path = f"{path}.p{jax.process_index()}"
    path = path + ".npz"
    sidecar = {
        "format": _FORMAT,
        "treedef": jax.tree_util.tree_structure(state).serialize_using_proto().hex()
        if hasattr(treedef, "serialize_using_proto") else None,
        "meta": meta or {},
        "n_leaves": len(leaves),
        "process_index": jax.process_index(),
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrs)
    os.replace(tmp, path)
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f)
    return path


def load(path: str, like: Any = None):
    """Read a checkpoint.  Returns (state, meta).

    ``like``: a pytree with the same structure, used to rebuild the
    treedef.  When omitted, the treedef serialised in the sidecar is used
    instead (works for standard containers and registered node types; if
    deserialisation fails -- e.g. an unregistered custom node -- the flat
    leaf list is returned and the caller unflattens)."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    with open(path + ".json") as f:
        sidecar = json.load(f)
    data = np.load(path)
    n = sidecar["n_leaves"]
    leaves = []
    for i in range(n):
        if f"leaf{i}__key" in data:
            leaves.append(jax.random.wrap_key_data(
                jax.numpy.asarray(data[f"leaf{i}__key"])))
        else:
            leaves.append(data[f"leaf{i}"])
    if like is not None:
        treedef = jax.tree_util.tree_structure(like)
        return jax.tree_util.tree_unflatten(treedef, leaves), sidecar["meta"]
    if sidecar.get("treedef"):
        try:
            proto = bytes.fromhex(sidecar["treedef"])
            td0 = jax.tree_util.tree_structure(0)
            treedef = type(td0).deserialize_using_proto(
                jax.tree_util.default_registry, proto)
            return (jax.tree_util.tree_unflatten(treedef, leaves),
                    sidecar["meta"])
        except Exception:
            pass
    return leaves, sidecar["meta"]
