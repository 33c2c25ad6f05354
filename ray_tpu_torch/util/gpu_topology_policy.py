"""NVLink-domain-aware host selection for GPU slice placement groups.

The counterpart of ``ray_tpu/util/tpu_topology_policy.py``. A TPU slice's
hosts sit on an ICI torus, so that policy picks a contiguous sub-box of the
slice's host grid. NVLink domains have no such geometry: inside one domain
(an HGX host, or an NVL rack whose hosts share NVLink switches) every GPU
reaches every other at full bandwidth, and between domains traffic goes over
the network. So what carries over from the TPU policy is:

 - a gang comes from ONE domain and never mixes domains (the TPU planner's
   "never mixes pods");
 - hosts come back in a stable order, the order the caller lists them in
   (the scheduler lists nodes in the order they joined), which fixes the
   ranks;
 - among the domains that fit, the one left with the fewest feasible hosts
   free wins (best fit), so large domains stay whole for large gangs.

Domains come from the ``gpu_nvlink_domain`` node label
(``_private/accelerators/gpu.py::node_topology_labels``). The scheduler checks
each bundle against its host before it takes the plan.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Optional, Sequence

DOMAIN_LABEL = "gpu_nvlink_domain"


def choose_domain_hosts(
    domains: Dict[Hashable, Sequence[Hashable]],
    num_hosts: int,
) -> Optional[List[Hashable]]:
    """Pick ``num_hosts`` hosts of one NVLink domain.

    Args:
      domains: domain name -> the ids of its feasible hosts (hosts that can
        take one bundle of the gang), in a stable order.
      num_hosts: bundles to place, one a host.

    Returns the first ``num_hosts`` hosts of the chosen domain in the order
    given, or None when no domain has enough feasible hosts. Ties between
    domains of equal size go to the domain whose name sorts first.
    """
    if num_hosts <= 0:
        return None
    unique = {name: list(dict.fromkeys(hosts)) for name, hosts in domains.items()}
    fitting = [name for name, hosts in unique.items() if len(hosts) >= num_hosts]
    if not fitting:
        return None
    best = min(fitting, key=lambda name: (len(unique[name]), str(name)))
    return unique[best][:num_hosts]
