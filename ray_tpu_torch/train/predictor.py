"""Predictor + BatchPredictor: checkpoint-based inference.

The counterpart of ``ray_tpu/train/predictor.py``; reference:
`python/ray/train/predictor.py` (Predictor ABC: `from_checkpoint` +
`predict`) and `python/ray/train/batch_predictor.py` (BatchPredictor — map a
predictor class over a Dataset with an actor pool that constructs the
predictor ONCE per worker).

``TorchPredictor`` stands where ``JaxPredictor`` does: its params go to the
device once, at construction (the GPU unless ``device`` names another, and
raising when there is none), and each ``predict`` runs ``apply_fn`` eagerly
under ``torch.inference_mode()``, where the JAX predictor jits it.
``BatchPredictor.predict`` scores a Dataset on an actor pool whose actors
hold a share of ``GPU`` each (``num_gpus_per_worker``), where the JAX
package's pool asks for no accelerator.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Type

import numpy as np

from ray_tpu_torch._private.accelerators.gpu import resolve_device
from ray_tpu_torch.air.checkpoint import Checkpoint

class Predictor:
    """Interface: construct from a Checkpoint, score numpy batches.

    ``uses_gpu``: whether the predictor scores on the GPU. A host predictor
    (``XGBoostPredictor``) sets it False, and a ``BatchPredictor`` pool of it
    then holds no ``GPU`` unless asked to. A class that does not subclass
    this one is taken to use the GPU unless it says otherwise."""

    uses_gpu = True

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # map_batches class-UDF protocol.
    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.predict(batch)


def _to_device(tree: Any, device: torch.device) -> Any:
    """Nested dicts, lists and tuples of arrays, scalars or tensors as the
    same nesting of tensors on ``device`` (dtypes kept)."""
    import torch

    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device)
    return torch.as_tensor(np.asarray(tree), device=device)


def _writable(a: np.ndarray) -> np.ndarray:
    return a if a.flags.writeable else a.copy()


def _to_numpy(out: Any) -> np.ndarray:
    import torch

    if isinstance(out, torch.Tensor):
        t = out.detach().to("cpu")
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(out)


class TorchPredictor(Predictor):
    """Predictor over a params tree + an apply fn, ``JaxPredictor``'s
    counterpart.

    `apply_fn(params, features)` runs under ``torch.inference_mode()``;
    `features` is the raw batch dict (its columns as tensors on the
    device) unless `feature_columns` narrows it to a single stacked (B, F)
    float32 matrix (the dict-of-columns -> design-matrix convention the GBDT
    predictors use). Predictions come back as numpy.
    """

    def __init__(self, params: Any, apply_fn: Callable,
                 feature_columns: Optional[List[str]] = None,
                 predictions_column: str = "predictions", device=None):
        self.device = resolve_device(device)
        self._params = _to_device(params, self.device)
        self._apply = apply_fn
        self._feature_columns = list(feature_columns) if feature_columns else None
        self._pred_col = predictions_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *, apply_fn: Callable,
                        params_key: str = "params",
                        feature_columns: Optional[List[str]] = None,
                        predictions_column: str = "predictions",
                        device=None) -> "TorchPredictor":
        data = checkpoint.to_dict()
        if params_key not in data:
            raise ValueError(
                f"checkpoint has no {params_key!r} entry; keys: {sorted(data)}"
            )
        return cls(
            data[params_key], apply_fn,
            feature_columns=feature_columns,
            predictions_column=predictions_column,
            device=device,
        )

    @property
    def params(self) -> Any:
        """The params tree on the predictor's device."""
        return self._params

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        if self._feature_columns is not None:
            feats = torch.as_tensor(np.stack(
                [np.asarray(batch[c], np.float32) for c in self._feature_columns],
                axis=1,
            ), device=self.device)
        else:
            # A Dataset's batches are read-only views of the object store;
            # torch takes writable memory.
            feats = {k: torch.as_tensor(_writable(np.asarray(v)), device=self.device)
                     for k, v in batch.items()}
        with torch.inference_mode():
            out = self._apply(self._params, feats)
        return {self._pred_col: _to_numpy(out)}


class BatchPredictor:
    """Distributed batch inference: checkpoint + predictor class -> scored
    Dataset. Each pool actor builds the predictor once (weights load
    per-worker, not per-batch) and scores a stream of blocks."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._predictor_cls = predictor_cls
        self._predictor_kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(
        self,
        dataset,
        *,
        feature_columns: Optional[List[str]] = None,
        keep_columns: Optional[List[str]] = None,
        batch_size: Optional[int] = None,
        num_workers: int = 2,
        num_gpus_per_worker: Optional[float] = None,
    ):
        """Score `dataset`, returning a Dataset of prediction columns
        (+ `keep_columns` carried through). `feature_columns` narrows the
        batch the predictor sees; `batch_size=None` scores whole blocks.

        ``num_gpus_per_worker`` (upstream Ray's argument) is each pool
        actor's share of ``GPU``. ``None``: the pool together holds one GPU
        (``1 / num_workers`` each; fractions pack onto one device), or none
        when the predictor's kwargs say ``device="cpu"`` or its class runs
        on the host (``uses_gpu = False``). A pool asking for
        more GPU than the cluster has raises ``ValueError`` when it starts."""
        ckpt = self._checkpoint
        pred_cls = self._predictor_cls
        pred_kwargs = self._predictor_kwargs
        keep = list(keep_columns or [])
        feats = list(feature_columns) if feature_columns else None
        if num_gpus_per_worker is None:
            import torch

            device = pred_kwargs.get("device")
            on_cpu = device is not None and torch.device(device).type == "cpu"
            on_gpu = getattr(pred_cls, "uses_gpu", True) and not on_cpu
            num_gpus_per_worker = 1 / num_workers if on_gpu else 0

        class _Scorer:
            def __init__(self):
                self._p = pred_cls.from_checkpoint(ckpt, **pred_kwargs)

            def __call__(self, batch: Dict[str, np.ndarray]):
                sub = {k: batch[k] for k in feats} if feats else batch
                out = dict(self._p.predict(sub))
                for c in keep:
                    if c in out:
                        raise ValueError(
                            f"keep column {c!r} collides with a prediction "
                            "column"
                        )
                    out[c] = batch[c]
                return out

        return dataset.map_batches(
            _Scorer,
            compute="actors",
            num_actors=num_workers,
            batch_size=batch_size,
            num_gpus=num_gpus_per_worker,
        )
