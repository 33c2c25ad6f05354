"""Autoscaler: demand-driven node scale-up and idle scale-down.

Reference: `python/ray/autoscaler/` (`StandardAutoscaler`
(`_private/autoscaler.py:172`), `Monitor` (`monitor.py:127`), cloud
`NodeProvider` plugins, the `fake_multi_node` test provider). The JAX
package's architecture, with GPU providers:

 - `StandardAutoscaler`: reads the scheduler's demand snapshot (pending task
   resource shapes + unplaced PG bundles + per-node idle time), bin-packs
   demand onto configured node types, asks the provider for nodes, and
   terminates nodes idle past the timeout (respecting min_workers).
 - `NodeProvider` plugins: `FakeMultiNodeProvider` (virtual scheduler nodes,
   the `fake_multi_node` analogue), `LocalDaemonProvider` (real node-daemon
   processes on this machine; a GPU node's daemon gives its actors the device
   ids of its own `CUDA_VISIBLE_DEVICES`), and `GcpGpuInstancesProvider`
   (the `gcloud compute instances` command builder for GPU VMs, in place of
   the JAX package's TPU queued-resources provider; needs gcloud at runtime).
 - `Monitor`: background thread driving the loop (the reference's monitor
   process, colocated in the driver that starts it).
"""

from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerConfig,
    Monitor,
    NodeTypeConfig,
    StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.node_provider import (
    FakeMultiNodeProvider,
    GcpGpuInstancesProvider,
    LocalDaemonProvider,
    NodeProvider,
)
from ray_tpu_torch.autoscaler.sdk import request_resources

__all__ = [
    "AutoscalerConfig",
    "NodeTypeConfig",
    "StandardAutoscaler",
    "Monitor",
    "NodeProvider",
    "FakeMultiNodeProvider",
    "LocalDaemonProvider",
    "GcpGpuInstancesProvider",
    "request_resources",
]
