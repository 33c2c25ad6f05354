"""joblib parallel backend running on ray_tpu_torch.

Reference: `python/ray/util/joblib/` (`register_ray` +
`ray_backend.RayBackend`). After `register_ray()`, scikit-learn and any other
joblib user fans its batches out over the cluster::

    from ray_tpu_torch.util.joblib import register_ray
    import joblib

    register_ray()
    with joblib.parallel_backend("ray"):
        GridSearchCV(...).fit(X, y)
"""

from __future__ import annotations

__all__ = ["register_ray"]


def register_ray() -> None:
    """Register the "ray" backend with joblib; raises ImportError, only when
    called, where joblib is not installed."""
    try:
        from joblib.parallel import register_parallel_backend
    except ImportError as e:
        raise ImportError(
            "joblib is required for the ray_tpu_torch joblib backend"
        ) from e
    from ray_tpu_torch.util.joblib.ray_backend import RayBackend

    register_parallel_backend("ray", RayBackend)
