"""Dashboard-lite: REST introspection + Prometheus metrics endpoint.

Reference: `dashboard/` (~25k LoC with a TS frontend) — this is the API
surface without the SPA: JSON endpoints over the live scheduler state plus
the merged /metrics exposition, served by the standard library's HTTP server
on a background thread in whichever process starts it (driver or head).

  GET /             tiny HTML overview
  GET /api/cluster  resource + entity rollup (state.summarize)
  GET /api/nodes    /api/actors  /api/tasks  /api/objects
  GET /api/jobs     per-job accounting ledgers (?job=<hex> for one report)
  GET /metrics      Prometheus text (util.metrics across all processes)
"""

from ray_tpu_torch.dashboard.head import DashboardServer, start_dashboard

__all__ = ["start_dashboard", "DashboardServer"]
