"""ray_tpu_torch.serve: model serving on the actor substrate.

Reference: `python/ray/serve/` (P19 in SURVEY.md §2) — controller actor
reconciling replica actors (`controller.py:73`, `deployment_state.py:1009`),
HTTP proxy (`http_proxy.py:250`), power-of-two router (`router.py:263`),
deployment graph composition (`deployment_graph_build.py`), autoscaling
(`autoscaling_policy.py`).

GPU-serving note: a deployment whose replicas hold a torch model keeps params
device-resident in the replica process; requests batch naturally per replica
(one ordered queue), and replica count maps to GPUs via
`ray_actor_options={"num_gpus": ...}` (fractions pack onto one device id).
"""

from ray_tpu_torch.serve.api import (
    Application,
    Deployment,
    delete,
    deployment,
    get_deployment_handle,
    http_port,
    ingress,
    proxy_ports,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.handle import (
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve.batching import batch
from ray_tpu_torch.serve.multiplex import get_multiplexed_model_id, multiplexed
from ray_tpu_torch.serve._private.common import AutoscalingConfig, RequestShedded
from ray_tpu_torch.serve._private.http_proxy import ProxyRequest

__all__ = [
    "batch",
    "get_multiplexed_model_id",
    "multiplexed",
    "Application",
    "AutoscalingConfig",
    "Deployment",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentResponseGenerator",
    "ProxyRequest",
    "RequestShedded",
    "delete",
    "deployment",
    "get_deployment_handle",
    "http_port",
    "ingress",
    "proxy_ports",
    "run",
    "shutdown",
    "start",
    "status",
]
