"""Checkpoint: a framework-level handle to a bundle of trained state.

Reference: `python/ray/air/checkpoint.py:63` — a `Checkpoint` interconverts
between dict / directory / bytes / URI forms so trainers, tuners, and serving
can pass checkpoints around without caring how they were produced.

GPU behavior: torch tensors inside dict checkpoints (in nested dicts, lists
and tuples) are copied to CPU tensors on save, so a checkpoint never pins
device memory, is picklable across processes, and keeps its values when the
caller updates the originals in place. A sharded leaf (a ``DTensor``) is
gathered whole first, as the JAX package fetches a sharded ``jax.Array``.

`save_pytree`/`load_pytree` keep a tree as ``<path>/pytree.pkl``, the JAX
package's portable format (it writes orbax's ``pytree/`` directory when orbax
is importable, which this package does not read).
"""

from __future__ import annotations

import io
import os
import pickle
import shutil
import tarfile
import tempfile
import uuid
from contextlib import contextmanager
from typing import Any, Dict, Iterator, Optional

_DICT_FILE = "ckpt.pkl"


def _tree_to_host(obj: Any) -> Any:
    """Copy the torch tensors in a nested dict / list / tuple to CPU tensors
    (detached, and copied even where they are on the CPU, so a later in-place
    update of the original leaves the result as it was); everything else is
    returned as it is.

    A ``DTensor`` leaf is gathered whole with ``full_tensor()`` first (a
    ``.to("cpu")`` would keep it a DTensor of this rank's shard). That gather
    is a collective: every rank of the leaf's mesh must make the same call."""
    if isinstance(obj, dict):
        return type(obj)((k, _tree_to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_tree_to_host(v) for v in obj)
    if (type(obj).__module__ or "").startswith("torch"):
        import torch
        from torch.distributed.tensor import DTensor

        if isinstance(obj, DTensor):
            obj = obj.full_tensor()
        if isinstance(obj, torch.Tensor):
            return obj.detach().to("cpu", copy=True)
    return obj


class Checkpoint:
    """One logical checkpoint, stored as a dict (in memory) or a directory."""

    def __init__(
        self,
        local_path: Optional[str] = None,
        data_dict: Optional[Dict[str, Any]] = None,
        uri: Optional[str] = None,
    ):
        forms = [f for f in (local_path, data_dict, uri) if f is not None]
        if len(forms) != 1:
            raise ValueError(
                "Checkpoint takes exactly one of local_path / data_dict / uri"
            )
        self._local_path = local_path
        self._data_dict = data_dict
        self._uri = uri

    # ------------------------------------------------------------- constructors
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        if not isinstance(data, dict):
            raise TypeError(f"from_dict expects a dict, got {type(data)}")
        return cls(data_dict=_tree_to_host(data))

    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        if not os.path.isdir(path):
            raise ValueError(f"no such checkpoint directory: {path}")
        return cls(local_path=os.path.abspath(path))

    @classmethod
    def from_bytes(cls, blob: bytes) -> "Checkpoint":
        obj = pickle.loads(blob)
        if isinstance(obj, dict) and obj.get("__ckpt_kind__") == "tar":
            tmp = tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
            with tarfile.open(fileobj=io.BytesIO(obj["tar"]), mode="r") as tf:
                tf.extractall(tmp)  # noqa: S202 - our own archive
            return cls(local_path=tmp)
        return cls(data_dict=obj)

    @classmethod
    def from_uri(cls, uri: str) -> "Checkpoint":
        if uri.startswith("file://"):
            return cls(local_path=uri[len("file://"):])
        return cls(uri=uri)

    # ------------------------------------------------------------- converters
    def to_dict(self) -> Dict[str, Any]:
        if self._data_dict is not None:
            return dict(self._data_dict)
        path = self._resolve_local()
        f = os.path.join(path, _DICT_FILE)
        if os.path.exists(f):
            with open(f, "rb") as fh:
                return pickle.load(fh)
        # Directory checkpoint without a dict payload: expose the file map.
        out: Dict[str, Any] = {}
        for name in os.listdir(path):
            full = os.path.join(path, name)
            if os.path.isfile(full):
                with open(full, "rb") as fh:
                    out[name] = fh.read()
        return out

    def to_directory(self, path: Optional[str] = None) -> str:
        path = path or tempfile.mkdtemp(prefix="ray_tpu_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
        if self._data_dict is not None:
            with open(os.path.join(path, _DICT_FILE), "wb") as fh:
                pickle.dump(self._data_dict, fh)
        else:
            src = self._resolve_local()
            if os.path.abspath(src) != os.path.abspath(path):
                shutil.copytree(src, path, dirs_exist_ok=True)
        return path

    @contextmanager
    def as_directory(self) -> Iterator[str]:
        """Context manager: a directory view, deleted afterwards if temporary."""
        if self._local_path:
            yield self._local_path
        else:
            path = self.to_directory()
            try:
                yield path
            finally:
                shutil.rmtree(path, ignore_errors=True)

    def to_bytes(self) -> bytes:
        if self._data_dict is not None:
            return pickle.dumps(self._data_dict)
        buf = io.BytesIO()
        with tarfile.open(fileobj=buf, mode="w") as tf:
            tf.add(self._resolve_local(), arcname=".")
        return pickle.dumps({"__ckpt_kind__": "tar", "tar": buf.getvalue()})

    def to_uri(self, uri: str) -> str:
        if not uri.startswith("file://"):
            raise ValueError("round-1 subset supports file:// URIs only")
        dest = uri[len("file://"):]
        self.to_directory(dest)
        return uri

    # ------------------------------------------------------------- internals
    def _resolve_local(self) -> str:
        if self._local_path:
            return self._local_path
        if self._uri and self._uri.startswith("file://"):
            return self._uri[len("file://"):]
        raise ValueError(f"cannot resolve checkpoint storage: {self._uri}")

    @property
    def uri(self) -> Optional[str]:
        if self._uri:
            return self._uri
        if self._local_path:
            return f"file://{self._local_path}"
        return None

    def __repr__(self):
        kind = (
            "dict" if self._data_dict is not None
            else ("dir" if self._local_path else "uri")
        )
        return f"Checkpoint({kind})"

    def __reduce__(self):
        # Pickling a directory checkpoint inlines its bytes so it can cross
        # process boundaries (the object store ships it to the driver). A
        # dict checkpoint pickles its dict in the same stream, so its
        # tensors' data goes out of band (a resized gang's gathered state is
        # GBs; as one in-band blob it would ride the control plane's frame).
        if self._data_dict is not None:
            return (Checkpoint, (None, self._data_dict))
        if self._uri is not None:
            return (Checkpoint.from_uri, (self._uri,))
        return (Checkpoint.from_bytes, (self.to_bytes(),))


# ----------------------------------------------------------------- sharded trees
_PYTREE_FILE = "pytree.pkl"


def save_pytree(tree: Any, path: str) -> None:
    """Save a (possibly sharded) tree under `path` as ``pytree.pkl``: its
    tensors pickled as CPU tensors (`_tree_to_host`: a DTensor leaf is
    gathered whole, a collective every rank of its mesh must enter, so on a
    mesh every rank calls this; give each rank its own `path` or let one
    write), everything else as it is."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _PYTREE_FILE), "wb") as fh:
        pickle.dump(_tree_to_host(tree), fh)


def load_pytree(path: str) -> Any:
    """The tree `save_pytree` wrote under `path`, with CPU tensor leaves; a
    ``pytree.pkl`` the JAX package wrote (its fallback when orbax is absent)
    loads with its numpy leaves, ready for ``models.convert.params_from_numpy``."""
    pkl = os.path.join(path, _PYTREE_FILE)
    if os.path.exists(pkl):
        with open(pkl, "rb") as fh:
            return pickle.load(fh)
    if os.path.isdir(os.path.join(path, "pytree")):
        raise ValueError(
            f"{path} holds an orbax checkpoint (pytree/), which the PyTorch port does not "
            "read: save the tree with the JAX package where orbax is not installed (its "
            "portable pytree.pkl), or load it there and save it again"
        )
    raise FileNotFoundError(f"no {_PYTREE_FILE} under {path}")
