"""Checkpointing: a tree of tensors -> .npy files + a manifest with an
integrity hash.

Port of `repro/ckpt/checkpoint.py`, with the same file layout
(``step_{step:010d}/{path joined by "__"}.npy`` + ``manifest.json``), the
same manifest and the same integrity hash (folded through the port's
`core/hashing`), so either package loads the other's checkpoints.

Fault-tolerance contract:
  * writes are atomic (tmp dir + rename), so a crash mid-save never corrupts
    the latest checkpoint;
  * every array's bytes are folded into an XOR-incremental integrity hash
    (the same primitive Nezha uses for log equality), checked on load;
  * the manifest commits through the Nezha-replicated metadata log
    (`repro_torch.ckpt.replicated_log`) when one is attached: a checkpoint
    "exists" only once consensus commits its manifest -- so all hosts agree
    on the restore point after a failure (no torn checkpoints across hosts).

Leaves may be tensors (on any device) or numpy arrays. A bf16 tensor is
written as the reference writes its bf16 arrays: the raw 2-byte words as
numpy's void type ``|V2``, with "bfloat16" in the manifest. Loading returns
numpy arrays as the reference does (a bf16 leaf as those ``|V2`` words);
`as_tensor` turns a loaded leaf back into a tensor of a given type.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.hashing import entry_hash_np, fold_hashes_np

BF16_WORDS = np.dtype("V2")     # how numpy stores a bf16 array it cannot type


def to_numpy(x) -> np.ndarray:
    """A leaf as the numpy array the checkpoint stores (bf16 -> |V2)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(BF16_WORDS)
        return x.numpy()
    return np.asarray(x)


def as_tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """A loaded leaf as a tensor of ``dtype`` on ``device``: bf16 words
    (|V2) are reinterpreted as bf16, anything else converted."""
    if arr.dtype == BF16_WORDS:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.as_tensor(arr)
    return t.to(dtype=dtype, device=device)


def _dtype_name(x, arr: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _tree_hash(flat) -> int:
    hs = []
    for path, arr in flat:
        a = np.asarray(arr)
        # fold a cheap content signature: (nbytes, first/last 64 bytes)
        raw = a.tobytes()[:64] + a.tobytes()[-64:] if a.nbytes else b""
        sig = np.frombuffer(raw.ljust(128, b"\0"), dtype=np.uint64)
        path_h = zlib.crc32("/".join(path).encode())  # process-stable
        h = fold_hashes_np(entry_hash_np(sig, np.uint64(a.nbytes),
                                         np.uint64(path_h)))
        hs.append(np.uint64(h))
    return int(fold_hashes_np(np.asarray(hs, dtype=np.uint64))) if hs else 0


def save_checkpoint(directory: str, step: int, tree, *,
                    metadata: Optional[dict] = None, log=None) -> dict:
    """Atomic save. Returns the manifest."""
    leaves = list(_flatten(tree))
    flat = [(path, to_numpy(x)) for path, x in leaves]
    tmp = os.path.join(directory, f".tmp-{step}-{int(time.time()*1e6)}")
    final = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(tmp, exist_ok=True)
    names = {}
    for (path, x), (_, arr) in zip(leaves, flat):
        name = "__".join(path) or "root"
        np.save(os.path.join(tmp, name + ".npy"), arr, allow_pickle=False)
        names[name] = {"path": list(path), "shape": list(arr.shape),
                       "dtype": _dtype_name(x, arr)}
    manifest = {
        "step": step,
        "integrity_hash": _tree_hash(flat),
        "arrays": names,
        "metadata": metadata or {},
        "time": time.time(),
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    if log is not None:
        # Commit through the Nezha-replicated metadata log: after this
        # returns, a quorum of coordination replicas agrees this checkpoint
        # is the restore point.
        log.commit_manifest(step, manifest["integrity_hash"], final)
    return manifest


def latest_step(directory: str, log=None) -> Optional[int]:
    """The log's latest committed step if a log is attached and holds one,
    else the largest ``step_*`` directory, else None."""
    if log is not None:
        committed = log.latest_committed()
        if committed is not None:
            return committed["step"]
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None


def load_checkpoint(directory: str, step: Optional[int] = None, *, log=None,
                    verify: bool = True):
    """Returns (tree of numpy arrays, manifest); raises IOError when the
    integrity hash does not match."""
    if step is None:
        step = latest_step(directory, log=log)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    d = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tree: dict = {}
    flat = []
    for name, info in manifest["arrays"].items():
        arr = np.load(os.path.join(d, name + ".npy"))
        flat.append((tuple(info["path"]), arr))
        node = tree
        *parents, leaf = info["path"] or ["root"]
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = arr
    if verify:
        got = _tree_hash(sorted(flat, key=lambda t: t[0]))
        if got != manifest["integrity_hash"]:
            raise IOError(f"checkpoint {d} integrity hash mismatch")
    return tree, manifest


__all__ = ["save_checkpoint", "load_checkpoint", "latest_step"]
