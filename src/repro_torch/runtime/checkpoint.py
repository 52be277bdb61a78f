"""Atomic, checksummed checkpoints on the reference's on-disk layout.

The port's own copy of the reference's ``repro.runtime.checkpoint``
(without JAX), so that a checkpoint written by either package is read by
the other::

    <dir>/step_<N:08d>/
        manifest.json     # step, extra metadata, and per leaf its file,
                          # shape, dtype and sha256
        <leafpath>.npy    # one file per tree leaf, "/" written as "__"
    <dir>/step_<N:08d>.COMMITTED   # commit marker, written last

A tree is nested dicts, lists, tuples and named tuples whose leaves are
tensors or arrays.  Its leaf paths are the reference's: dict keys in
sorted order (as ``jax.tree_util`` flattens them), list and tuple items
by index, named-tuple fields as ``.<field>``, joined by "/"
(``params/layers/0/scores``; an ``AdamState``'s ``1/.mu/embed/table``).  Writes go to ``step_<N>.tmp-<pid>`` and are
renamed before the marker is written, so a writer cut off mid-way never
leaves a committed but partial checkpoint.  ``restore`` verifies every
leaf's sha256 and shape.

A tree with DTensor leaves (a model over a ``DeviceMesh``) saves
collectively: every rank assembles each leaf's whole tensor, rank 0
alone writes and commits the step, and the others wait for it at a
barrier.  ``restore(..., shardings=)`` lays each loaded leaf out by a
``NamedSharding`` on any mesh (each rank keeps its chunk), so a step
saved at one world size restores at another.

DWN artifacts (``save_artifact`` / ``load_artifact``) put the spec, its
fingerprint, the stage and the calibration record in the manifest's
``extra`` with ``kind == "dwn-artifact"``.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..sharding.partition import place


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _leaf_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, in the reference's order."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif _is_namedtuple(tree):
        items = [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += _leaf_paths(sub, f"{prefix}/{key}" if prefix else str(key))
    return out


def _rebuild(tree, leaves: dict, prefix: str = ""):
    """``tree``'s structure with each leaf replaced by ``leaves[path]``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(
            _rebuild(v, leaves, f"{prefix}/.{f}" if prefix else f".{f}")
            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _rebuild(v, leaves, f"{prefix}/{i}" if prefix else str(i))
            for i, v in enumerate(tree))
    return leaves[prefix]


def _is_dtensor(leaf) -> bool:
    return isinstance(leaf, torch.Tensor) and hasattr(leaf, "placements")


def _as_numpy(leaf) -> np.ndarray:
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _collective(tree) -> bool:
    """Whether saving ``tree`` is collective: it holds a DTensor."""
    return any(_is_dtensor(leaf) for _, leaf in _leaf_paths(tree))


def _barrier() -> None:
    import torch.distributed as dist
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def writes(tree) -> bool:
    """Whether this process writes ``tree``'s checkpoints: always, unless
    the tree holds DTensors and this is not rank 0."""
    if not _collective(tree):
        return True
    import torch.distributed as dist
    return dist.get_rank() == 0


def _sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save(directory: str | os.PathLike, step: int, tree, *,
         extra: dict | None = None) -> Path:
    """Atomically save a tree checkpoint.  Returns the final path.  With
    DTensor leaves every rank of the process group must call it: each
    leaf is assembled on every rank, rank 0 writes, and every rank
    returns once the step is committed."""
    base = Path(directory)
    final = base / f"step_{step:08d}"
    # one leaf at a time, assembled (on every rank) as it is written
    arrays = ((name, _as_numpy(leaf)) for name, leaf in _leaf_paths(tree))
    if not _collective(tree):
        return _write(base, final, step, arrays, extra)
    if writes(tree):
        _write(base, final, step, arrays, extra)
    else:
        for _ in arrays:
            pass
    _barrier()
    return final


def _write(base: Path, final: Path, step: int, leaves, extra) -> Path:
    """Write ``(path, array)`` pairs as step ``step`` and commit it."""
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f"step_{step:08d}.tmp-{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest: dict = {"step": step, "extra": extra or {},
                      "created": time.time(), "leaves": {}}
    for name, arr in leaves:
        fn = name.replace("/", "__") + ".npy"
        np.save(tmp / fn, arr)
        manifest["leaves"][name] = {
            "file": fn, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": _sha256(tmp / fn),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    marker = base / f"step_{step:08d}.COMMITTED"
    marker.write_text(str(time.time()))
    return final


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest committed step under ``directory``, or None."""
    base = Path(directory)
    if not base.exists():
        return None
    steps = []
    for marker in base.glob("step_*.COMMITTED"):
        s = int(marker.stem.split("_")[1])
        if (base / f"step_{s:08d}" / "manifest.json").exists():
            steps.append(s)
    return max(steps) if steps else None


def restore(directory: str | os.PathLike, step: int, like, *,
            device="cpu", shardings=None, verify: bool = True):
    """Restore a checkpoint into the structure of ``like`` (whose leaves
    give the expected shapes: a DTensor's are the whole tensor's).  Each
    leaf becomes a tensor on ``device`` with the dtype it was saved with;
    with ``shardings`` (a tree like ``like`` of ``NamedSharding``s on a
    ``DeviceMesh``, None for a leaf to keep whole) a DTensor laid out by
    its sharding on the mesh's device instead, the reference's
    mesh-elastic restore.  Raises ``KeyError`` for a leaf the checkpoint
    lacks, ``IOError`` for a checksum mismatch and ``ValueError`` for a
    shape mismatch.  Returns (tree, extra)."""
    base = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((base / "manifest.json").read_text())
    placed = dict(_leaf_paths(shardings)) if shardings is not None else {}
    leaves = {}
    for name, leaf in _leaf_paths(like):
        meta = manifest["leaves"].get(name)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {name!r}")
        path = base / meta["file"]
        if verify and _sha256(path) != meta["sha256"]:
            raise IOError(f"checksum mismatch for {name} ({path})")
        arr = np.load(path)
        want_shape = tuple(getattr(leaf, "shape", arr.shape))
        if tuple(arr.shape) != want_shape:
            raise ValueError(
                f"shape mismatch for {name}: ckpt {arr.shape} vs "
                f"{want_shape}")
        sharding = placed.get(name)
        if sharding is None:
            leaves[name] = torch.from_numpy(arr).to(device)
        else:
            leaves[name] = place(torch.from_numpy(arr).to(
                _mesh_device(sharding.mesh)), sharding)
    return _rebuild(like, leaves), manifest["extra"]


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_latest(directory, like, *, device="cpu", shardings=None):
    """``(step, tree, extra)`` of the newest committed step, or
    ``(None, None, None)``."""
    s = latest_step(directory)
    if s is None:
        return None, None, None
    tree, extra = restore(directory, s, like, device=device,
                          shardings=shardings)
    return s, tree, extra


# ---------------------------------------------------------------------------
# DWN artifact checkpoints (the repro_torch.dwn lifecycle)
# ---------------------------------------------------------------------------

def _artifact_like(spec, leaves: dict) -> dict:
    """Zero-filled like-trees for the artifact groups present in a
    manifest, with shapes and dtypes from the spec alone."""
    dcfg = spec.dwn_config()
    layer_specs = dcfg.layer_specs()
    F, T = dcfg.num_features, dcfg.bits_per_feature
    like: dict = {}
    if any(name.startswith("params/") for name in leaves):
        like["params"] = {"layers": [
            {"scores": np.zeros((s.num_luts, s.fan_in, s.num_candidates),
                                np.float32),
             "tables": np.zeros((s.num_luts, s.table_size), np.float32)}
            for s in layer_specs]}
        like["buffers"] = {"thresholds": np.zeros((F, T), np.float32)}
    if any(name.startswith("frozen/") for name in leaves):
        like["frozen"] = {
            "thresholds": np.zeros((F, T), np.float32),
            "mapping_idx": [np.zeros((s.num_luts, s.fan_in), np.int32)
                            for s in layer_specs],
            "tables_bin": [np.zeros((s.num_luts, s.table_size), np.int32)
                           for s in layer_specs]}
    return like


def save_artifact(directory: str | os.PathLike, artifact, *,
                  step: int = 0) -> Path:
    """Save a ``repro_torch.dwn.DWNArtifact`` (atomic, sha256-verified).

    The tree holds whichever stage state exists (params and buffers, the
    frozen arrays); the spec, stage and calibration ride in the manifest's
    ``extra``, so :func:`load_artifact` (and the reference's) rebuilds the
    build without other context.  Returns the checkpoint path.
    """
    tree: dict = {}
    if artifact.params is not None:
        tree["params"] = artifact.params
        tree["buffers"] = artifact.buffers
    if artifact.frozen is not None:
        f = artifact.frozen
        tree["frozen"] = {"thresholds": _as_numpy(f.thresholds),
                          "mapping_idx": [_as_numpy(i)
                                          for i in f.mapping_idx],
                          "tables_bin": [_as_numpy(t)
                                         for t in f.tables_bin]}
    extra = {"kind": "dwn-artifact",
             "spec": artifact.spec.to_dict(),
             "spec_fingerprint": artifact.spec.fingerprint(),
             "stage": artifact.stage,
             "calibration": dict(artifact.calibration)}
    return save(directory, step, tree, extra=extra)


def load_artifact(directory: str | os.PathLike, *, step: int | None = None,
                  device=None):
    """Restore a DWN artifact saved by :func:`save_artifact` or by the
    reference's ``save_artifact``.

    The spec is read from the manifest and validated again; params and
    buffers come back as float32 tensors on the CPU, the frozen arrays as
    numpy.  An artifact saved at stage "packed" is staged again with
    ``pack(device)`` (default ``cuda``; raises without a card), so its
    packed serving outputs equal the saved model's.  Raises
    ``FileNotFoundError`` when ``directory`` holds no committed step and
    ``ValueError`` when the checkpoint is not a DWN artifact.
    """
    from ..core.model import FrozenDWN
    from ..dwn import DWNArtifact, DWNSpec

    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(
                f"no committed artifact checkpoint under {directory}")
    base = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((base / "manifest.json").read_text())
    extra = manifest["extra"]
    if extra.get("kind") != "dwn-artifact":
        raise ValueError(f"checkpoint at {base} is not a DWN artifact "
                         f"(kind={extra.get('kind')!r})")
    spec = DWNSpec.from_dict(extra["spec"])
    like = _artifact_like(spec, manifest["leaves"])
    tree, _ = restore(directory, step, like)
    art = DWNArtifact(spec)
    art.calibration = dict(extra.get("calibration", {}))
    if "params" in tree:
        art.params, art.buffers = tree["params"], tree["buffers"]
    if "frozen" in tree:
        f = tree["frozen"]
        art.frozen = FrozenDWN(
            spec.dwn_config(), f["thresholds"].numpy(),
            [i.numpy() for i in f["mapping_idx"]],
            [t.numpy() for t in f["tables_bin"]],
            input_frac_bits=spec.frac_bits)
    if extra.get("stage") == "packed" and art.frozen is not None:
        art.pack(device)
    return art


def garbage_collect(directory: str | os.PathLike, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` committed checkpoints (and any
    temporary directory a writer left behind)."""
    base = Path(directory)
    if not base.exists():
        return
    for tmp in base.glob("step_*.tmp-*"):
        shutil.rmtree(tmp, ignore_errors=True)
    steps = sorted(
        int(m.stem.split("_")[1]) for m in base.glob("step_*.COMMITTED"))
    for s in steps[:-keep] if keep else steps:
        shutil.rmtree(base / f"step_{s:08d}", ignore_errors=True)
        (base / f"step_{s:08d}.COMMITTED").unlink(missing_ok=True)


__all__ = ["garbage_collect", "latest_step", "load_artifact", "restore",
           "restore_latest", "save", "save_artifact", "writes"]
