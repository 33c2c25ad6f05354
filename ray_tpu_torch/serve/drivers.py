"""DAGDriver: serve a ray_tpu_torch.dag graph (or several, keyed by route) over HTTP.

Reference: `python/ray/serve/drivers.py:29` (`DAGDriver`) — the ingress
deployment for model-composition graphs: each request's payload becomes the
graph's `InputNode`, the DAG executes across tasks/actors/deployment handles,
and the root's result is the response.

Usage::

    with InputNode() as inp:            # or plain InputNode()
        a = preprocess.bind(inp)
        out = model.bind(a)
    serve.run(serve.deployment(DAGDriver).bind(out))
    # or multiple routes:
    serve.run(serve.deployment(DAGDriver).bind({"/a": dag_a, "/b": dag_b}))
"""

from __future__ import annotations

import json
from typing import Any, Callable, Dict, Optional, Union

import ray_tpu_torch


def json_request(request) -> Any:
    """Default http_adapter: JSON body if present, else the query params."""
    if getattr(request, "body", b""):
        return json.loads(request.body)
    qp = getattr(request, "query_params", None)
    return dict(qp) if qp else None


class DAGDriver:
    def __init__(
        self,
        dags: Union[Any, Dict[str, Any]],
        *,
        http_adapter: Optional[Callable[[Any], Any]] = None,
    ):
        self._routes: Optional[Dict[str, Any]] = (
            dict(dags) if isinstance(dags, dict) else None
        )
        self._dag = None if self._routes is not None else dags
        self._adapter = http_adapter or json_request

    def _dag_for(self, path: str):
        if self._routes is None:
            return self._dag
        dag = self._routes.get(path) or self._routes.get(path.rstrip("/") or "/")
        if dag is None:
            raise KeyError(f"no DAG bound at route {path!r}")
        return dag

    def _execute(self, dag, payload):
        out = dag.execute(payload)
        # The root returns an ObjectRef (task/actor-method node) or a plain
        # value (InputNode root); resolve refs before responding.
        if isinstance(out, ray_tpu_torch.ObjectRef):
            return ray_tpu_torch.get(out)
        return out

    def __call__(self, request):
        """HTTP entry: adapt the request, run the matching DAG."""
        return self._execute(self._dag_for(getattr(request, "path", "/")),
                             self._adapter(request))

    def predict(self, payload):
        """Python-handle entry: run the (single) DAG on the given payload."""
        return self._execute(self._dag_for("/"), payload)

    def predict_with_route(self, path: str, payload):
        return self._execute(self._dag_for(path), payload)
