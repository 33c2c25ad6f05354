"""Operational CLI, the analogue of `ray start/stop/status/list/timeline/...`
(reference: `python/ray/scripts/scripts.py` — `ray start:529`, `ray stop:1013`,
`ray microbenchmark`, `ray timeline`, state CLI `experimental/state/state_cli.py`).

Usage (via `python -m ray_tpu_torch`):
  start --head [--port P] [--num-cpus N] [--num-gpus N]   start a head server
  start --address HOST:PORT [--num-cpus N] ...            start a node daemon
  stop                                                    stop processes this CLI started
  status [--address A]                                    cluster resource + entity rollup
  list {nodes,actors,tasks,objects} [--address A]
  timeline --output FILE [--address A]                    chrome://tracing dump
  microbenchmark                                          not ported (raises)
  job submit --entrypoint "python x.py" [--working-dir D] [--address A]
  job {status,logs,list,stop} ...

Connection resolution: --address flag, else RAY_TPU_TORCH_ADDRESS env, else the
head this CLI started (recorded in ~/.ray_tpu_torch/cli_state.json).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

STATE_FILE = os.path.expanduser("~/.ray_tpu_torch/cli_state.json")


def _load_state() -> dict:
    try:
        with open(STATE_FILE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_state(state: dict) -> None:
    os.makedirs(os.path.dirname(STATE_FILE), exist_ok=True)
    with open(STATE_FILE, "w") as f:
        json.dump(state, f, indent=2)


def _connect(ns):
    """init() against the resolved address (or error out with guidance)."""
    import ray_tpu_torch

    address = getattr(ns, "address", None) or os.environ.get("RAY_TPU_TORCH_ADDRESS")
    state = _load_state()
    if not address and state.get("head"):
        address = state["head"]["address"]
        os.environ.setdefault("RAY_TPU_TORCH_AUTHKEY_HEX", state["head"]["authkey_hex"])
    if not address:
        sys.exit(
            "no cluster address: pass --address, set RAY_TPU_TORCH_ADDRESS, or "
            "`python -m ray_tpu_torch start --head` first"
        )
    ray_tpu_torch.init(address=address)
    return ray_tpu_torch


# ----------------------------------------------------------------- start/stop
def cmd_start(ns):
    from ray_tpu_torch._private.launch import spawn_head, spawn_node_daemon

    state = _load_state()
    if ns.head:
        extra = []
        if ns.dashboard_port is not None:
            extra += ["--dashboard-port", str(ns.dashboard_port)]
        if ns.persist:
            extra += ["--persist", ns.persist]
        try:
            proc, info = spawn_head(
                port=ns.port, host=ns.host,
                num_cpus=ns.num_cpus, num_gpus=ns.num_gpus,
                resources=json.loads(ns.resources) if ns.resources else None,
                extra_args=tuple(extra),
            )
        except (TimeoutError, RuntimeError) as e:
            sys.exit(str(e))
        state["head"] = {"pid": proc.pid, **info}
        _save_state(state)
        print(f"head started: address={info['address']} pid={proc.pid}")
        if info.get("dashboard_port"):
            print(f"dashboard: http://{ns.host}:{info['dashboard_port']}")
        print(f"connect with: ray_tpu_torch.init(address=\"{info['address']}\")  "
              f"[RAY_TPU_TORCH_AUTHKEY_HEX={info['authkey_hex']}]")
    else:
        if not ns.address:
            sys.exit("start needs --head or --address HOST:PORT")
        head = state.get("head") or {}
        authkey = os.environ.get("RAY_TPU_TORCH_AUTHKEY_HEX") or head.get("authkey_hex")
        shm_dir = ns.shm_dir or tempfile.mkdtemp(prefix="ray_tpu_torch_node_")
        resources = json.loads(ns.resources) if ns.resources else {}
        if ns.num_cpus is not None:
            resources.setdefault("CPU", float(ns.num_cpus))
        if ns.num_gpus:
            resources.setdefault("GPU", float(ns.num_gpus))
        try:
            proc, node_id = spawn_node_daemon(
                ns.address, shm_dir=shm_dir, resources=resources, authkey_hex=authkey
            )
        except (TimeoutError, RuntimeError) as e:
            sys.exit(str(e))
        state.setdefault("daemons", []).append({"pid": proc.pid, "node_id": node_id})
        _save_state(state)
        print(f"node daemon started: node_id={node_id} pid={proc.pid}")


def cmd_stop(_ns):
    state = _load_state()
    stopped = 0
    for d in state.get("daemons", []):
        try:
            os.kill(d["pid"], signal.SIGTERM)
            stopped += 1
        except ProcessLookupError:
            pass
    head = state.get("head")
    if head:
        try:
            os.kill(head["pid"], signal.SIGTERM)
            stopped += 1
        except ProcessLookupError:
            pass
    _save_state({})
    print(f"stopped {stopped} process(es)")


# --------------------------------------------------------------------- state
def cmd_status(ns):
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    print(json.dumps(state_api.summarize(), indent=2, default=str))


def cmd_list(ns):
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    fn = {
        "nodes": state_api.list_nodes,
        "actors": state_api.list_actors,
        "tasks": state_api.list_tasks,
        "objects": state_api.list_objects,
    }[ns.what]
    print(json.dumps(fn(), indent=2, default=str))


def cmd_timeline(ns):
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    events = state_api.timeline(ns.output)
    print(f"wrote {len(events)} events to {ns.output}")


# ------------------------------------------------------------ introspection
def cmd_stack(ns):
    """`ray stack` analogue: all-thread stacks from every live process,
    each thread annotated with the task it is executing."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    dumps = state_api.stacks(ns.timeout)
    for key in sorted(dumps):
        d = dumps[key] or {}
        print(f"=== {key} (pid={d.get('pid')}, "
              f"transport={d.get('transport', 'inband')}) ===")
        if d.get("transport") == "unavailable":
            print(f"  unavailable: {d.get('error')}")
        elif d.get("transport") == "oob":
            print(d.get("raw", ""), end="")
        else:
            for th in d.get("threads", ()):
                task = f"  [task: {th['task']}]" if th.get("task") else ""
                print(f"--- thread {th.get('name')} "
                      f"(id={th.get('thread_id')}){task}")
                print(th.get("stack", ""), end="")
        print()


def cmd_memory(ns):
    """`ray memory` analogue: ownership/refcount attribution, top sites,
    leak suspects, and the store-dir byte join."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    s = state_api.memory_summary()
    if ns.json:
        print(json.dumps(s, indent=2, default=str))
        return
    print(f"objects: {s['num_objects']}  shm: {s['shm_bytes']} B  "
          f"inline: {s['inline_bytes']} B  spilled: {s['spilled_bytes']} B  "
          f"(gauge: {s['gauge_bytes']:.0f} B)")
    print("\ntop creation sites:")
    for site, agg in s["by_site"].items():
        print(f"  {site:40s} {agg['count']:>6} objs {agg['bytes']:>14} B")
    if s["leak_suspects"]:
        print("\nLEAK SUSPECTS (only dead processes reference these):")
        for o in s["leak_suspects"]:
            print(f"  {o['object_id']} {o['size']} B site={o['site']} "
                  f"holders={o['holders']}")
    scan = s["store_scan"]
    if scan.get("leaked"):
        print(f"\nLEAKED STORE BYTES ({scan['leaked_bytes']} B unreferenced "
              f"in {scan['dir']}):")
        for e in scan["leaked"]:
            print(f"  {e['path']} {e['bytes']} B ({e['kind']})")


def cmd_profile(ns):
    """Cluster-wide sampling profile; folded stacks to --output (flamegraph.pl
    / speedscope input) or stdout."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    res = state_api.profile(ns.duration, hz=ns.hz)
    text = res["flamegraph"]
    if ns.output:
        with open(ns.output, "w") as f:
            f.write(text + "\n")
        print(f"wrote {len(res['folded'])} folded stacks "
              f"({res['samples']} samples) to {ns.output}")
    else:
        print(text)


# ------------------------------------------------------------ observability
def cmd_events(ns):
    """Cluster event log: node lifecycle, worker crashes, scale decisions,
    Serve changes, alert fire/resolve (newest last)."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    events = state_api.list_cluster_events(
        limit=ns.limit, kind=ns.kind, severity=ns.severity
    )
    if ns.json:
        print(json.dumps(events, indent=2, default=str))
        return
    for e in events:
        stamp = time.strftime("%H:%M:%S", time.localtime(e["ts"]))
        extra = f"  {e['data']}" if e.get("data") else ""
        print(f"{stamp}  {e['severity']:<8} {e['kind']:<24} "
              f"[{e['source']}] {e['message']}{extra}")
    if not events:
        print("(no events)")


def cmd_series(ns):
    """Query the head's time-series store: counter rates, gauge levels, or
    histogram quantiles over time."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    res = state_api.query_series(
        ns.name,
        labels=json.loads(ns.labels) if ns.labels else None,
        since=time.time() - ns.window if ns.window else None,
        step=ns.step,
        agg=ns.agg,
        q=ns.q,
    )
    if ns.json:
        print(json.dumps(res, indent=2, default=str))
        return
    print(f"{res['name']} ({res['kind']}, step={res['step']:g}s)")
    for s in res["series"]:
        label = ",".join(f"{k}={v}" for k, v in sorted(s["labels"].items()))
        print(f"  {{{label}}}")
        for ts, v in s["points"]:
            stamp = time.strftime("%H:%M:%S", time.localtime(ts))
            print(f"    {stamp}  {v if v is None else round(v, 6)}")
    if not res["series"]:
        print("  (no samples)")


def cmd_trace(ns):
    """End-to-end request traces: list recent ones, or show one trace's
    spans + critical-path attribution (`--trace-id`)."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    if ns.trace_id:
        t = state_api.get_trace(ns.trace_id)
        if ns.json:
            print(json.dumps(t, indent=2, default=str))
            return
        print(f"trace {t['trace_id']}  root={t['root']!r} "
              f"({t['root_kind']})  {t['duration_s'] * 1e3:.2f}ms  "
              f"status={t['status']}")
        by_id = {s["span_id"]: s for s in t["spans"]}

        def depth_of(s):
            d, p = 0, s.get("parent_id")
            while p in by_id and d < 32:
                d, p = d + 1, by_id[p].get("parent_id")
            return d

        t0 = min(s["start"] for s in t["spans"])
        for s in t["spans"]:
            pad = "  " * depth_of(s)
            dur = ((s.get("end") or s["start"]) - s["start"]) * 1e3
            print(f"  {pad}{s['name']} [{s['kind']}] "
                  f"+{(s['start'] - t0) * 1e3:.2f}ms {dur:.2f}ms "
                  f"{s['status']}")
        attr = t["attribution"]
        print(f"\nattribution ({attr['coverage'] * 100:.1f}% of "
              f"{attr['total_s'] * 1e3:.2f}ms wall):")
        for comp, secs in attr["components"].items():
            print(f"  {comp:<14} {secs * 1e3:>10.3f}ms")
        return
    traces = state_api.list_traces(ns.limit)
    if ns.json:
        print(json.dumps(traces, indent=2, default=str))
        return
    for t in traces:
        stamp = time.strftime("%H:%M:%S", time.localtime(t["start"]))
        tail = "  [tail-kept]" if t.get("tail_kept") else ""
        print(f"{stamp}  {t['trace_id']}  {t['duration_s'] * 1e3:>9.2f}ms  "
              f"{t['spans']:>3} spans  {t['status']:<5} "
              f"{t['root'] or '?'}{tail}")
    if not traces:
        print("(no traces recorded — is tracing enabled? "
              "RAY_TPU_TORCH_TRACING=1 or tracing.enable())")


def cmd_latency(ns):
    """'Where does p95 actually go': per-component latency attribution over
    recent traces (state.latency_report)."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    rep = state_api.latency_report(ns.limit)
    if ns.json:
        print(json.dumps(rep, indent=2, default=str))
        return
    if not rep["traces"]:
        print("(no complete traces to attribute)")
        return
    p50 = rep["trace_p50_s"] or 0.0
    p95 = rep["trace_p95_s"] or 0.0
    print(f"latency report over {rep['traces']} trace(s): "
          f"p50={p50 * 1e3:.2f}ms p95={p95 * 1e3:.2f}ms "
          f"coverage={rep['coverage'] * 100:.1f}%")
    print(f"{'component':<14} {'total':>12} {'share':>7}")
    for comp, row in rep["components"].items():
        print(f"{comp:<14} {row['total_s'] * 1e3:>10.3f}ms "
              f"{row['share'] * 100:>6.1f}%")


def cmd_train(ns):
    """Training-gang goodput ledgers: wall time split into productive vs
    badput buckets, current skew, and the named straggler per gang."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    rep = state_api.training_report(ns.gang)
    if ns.json:
        print(json.dumps(rep, indent=2, default=str))
        return
    gangs = rep["gangs"]
    if not gangs:
        print("(no training gangs — is enable_metrics on?)")
        return
    for gang_id, g in sorted(gangs.items()):
        wall = g.get("wall_s", 0.0) or 0.0
        print(f"gang {gang_id}  [{g.get('status', '?')}]  "
              f"world_size={g.get('world_size', '?')}  steps={g.get('steps', 0)}  "
              f"failures={g.get('failures', 0)}  "
              f"resizes={g.get('resizes', 0)}")
        print(f"  wall {wall:.2f}s  goodput {g.get('goodput_frac', 0.0) * 100:.1f}%  "
              f"coverage {g.get('coverage', 0.0) * 100:.1f}%")
        last_resize = g.get("last_resize")
        if last_resize:
            print(f"  last resize: {last_resize.get('old_world')} -> "
                  f"{last_resize.get('new_world')} "
                  f"({last_resize.get('direction')}, "
                  f"{last_resize.get('reason')}; "
                  f"{last_resize.get('resize_s', 0.0):.2f}s, resumed from "
                  f"{last_resize.get('ckpt_source')} checkpoint)")
        if g.get("proactive_checkpoints"):
            print(f"  proactive checkpoints: {g['proactive_checkpoints']} "
                  f"(SUSPECT-triggered stash fetches)")
        for bucket, secs in (g.get("buckets") or {}).items():
            share = secs / wall * 100 if wall > 0 else 0.0
            print(f"    {bucket:<16} {secs:>10.3f}s {share:>6.1f}%")
        straggler = g.get("straggler")
        if straggler:
            print(f"  straggler: rank {straggler['rank']} "
                  f"(dominant phase {straggler['phase']}, "
                  f"skew {straggler['skew_s']:.3f}s; "
                  f"current skew {g.get('skew_s', 0.0):.3f}s)")


def _render_top(state_api, iteration: int) -> str:
    """One frame of `ray_tpu_torch top`, built entirely on the query/state APIs.
    Degrades gracefully when the obs layer is off (shows a notice instead
    of rates)."""
    now = time.time()
    lines = [f"ray_tpu_torch top — {time.strftime('%H:%M:%S')} "
             f"(refresh #{iteration})", ""]
    summary = state_api.summarize()

    def last_rate(metric, labels=None, agg="sum"):
        try:
            res = state_api.query_series(
                metric, labels=labels, since=now - 15, step=5.0, agg=agg
            )
        except Exception:  # noqa: BLE001 — metrics off / head gone
            return None
        pts = [p for s in res["series"] for p in s["points"]
               if p[1] is not None]
        return pts[-1][1] if pts else None

    tasks_s = last_rate("ray_tpu_scheduler_tasks_dispatched_total")
    queue = last_rate("ray_tpu_scheduler_pending_tasks")
    lines.append(
        f"tasks/s: {tasks_s if tasks_s is None else round(tasks_s, 1)}    "
        f"queue depth: {queue if queue is None else int(queue)}    "
        f"tasks by state: {summary['tasks_by_state']}"
    )
    lines.append(
        f"resources: {summary['available_resources']} free of "
        f"{summary['cluster_resources']}    objects: {summary['objects']}"
    )
    lines.append("")
    lines.append("nodes:")
    for n in state_api.list_nodes():
        lines.append(
            f"  {n['node_id'][:8]}  health={n['health']:<8} "
            f"workers={n['num_workers']:<3} alive={n['alive']}"
        )
    rps = last_rate("ray_tpu_serve_proxy_requests_total")
    shed = last_rate("ray_tpu_serve_shed_total")
    p95 = last_rate("ray_tpu_serve_route_wait_p95_s", agg="max")
    if any(v is not None for v in (rps, shed, p95)):
        lines.append("")
        lines.append(
            f"serve: rps={rps if rps is None else round(rps, 1)}  "
            f"route-wait p95="
            f"{p95 if p95 is None else round(p95 * 1000, 1)}ms  "
            f"shed/s={shed if shed is None else round(shed, 1)}"
        )
    try:
        alerts = state_api.list_alerts()
    except Exception:  # noqa: BLE001
        alerts = []
    firing = [a for a in alerts if a["state"] == "firing"]
    lines.append("")
    if firing:
        lines.append("ALERTS FIRING:")
        for a in firing:
            lines.append(
                f"  !! {a['name']} ({a['severity']}): {a['summary']} "
                f"[value={a['value']}, threshold {a['op']} "
                f"{a['threshold']:g}]"
            )
    elif alerts:
        lines.append(f"alerts: {len(alerts)} rule(s), none firing")
    else:
        lines.append("alerts: (metrics disabled)")
    return "\n".join(lines)


def cmd_top(ns):
    """Live refreshing cluster view (htop analogue) on the query API."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    i = 0
    try:
        while True:
            i += 1
            frame = _render_top(state_api, i)
            if not ns.no_clear:
                sys.stdout.write("\x1b[2J\x1b[H")
            print(frame, flush=True)
            if ns.iterations and i >= ns.iterations:
                break
            time.sleep(ns.interval)
    except KeyboardInterrupt:
        pass


def _fmt_bytes(n) -> str:
    n = float(n or 0)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}GiB"


def _render_jobs(state_api, iteration: int) -> str:
    """One frame of `ray_tpu_torch jobs`: the tenant ledger as a top-like table —
    who is using the cluster right now, at what rate, and who is starving."""
    now = time.time()
    jobs = state_api.list_jobs()

    def last_rate(metric, job, agg="sum", q=None):
        try:
            res = state_api.query_series(
                metric, labels={"job": job}, since=now - 15, step=5.0,
                agg=agg, q=q,
            )
        except Exception:  # noqa: BLE001 — metrics off / head gone
            return None
        pts = [p for s in res["series"] for p in s["points"]
               if p[1] is not None]
        return pts[-1][1] if pts else None

    try:
        alerts = state_api.list_alerts()
    except Exception:  # noqa: BLE001
        alerts = []
    firing = [a for a in alerts if a["state"] == "firing"]
    # The job rules aggregate across tenants (agg=max), so attribute a
    # firing rule to the jobs whose own value crosses its threshold.
    starve_thresh = next((a["threshold"] for a in firing
                          if a["name"] == "job_starved"), None)
    runaway_thresh = next((a["threshold"] for a in firing
                           if a["name"] == "job_runaway_object_bytes"), None)

    lines = [f"ray_tpu_torch jobs — {time.strftime('%H:%M:%S')} "
             f"(refresh #{iteration})", ""]
    hdr = (f"{'JOB':<10} {'STATE':<9} {'DRIVER':<18} {'CPU-S/S':>8} "
           f"{'TASKS/S':>8} {'QW-P95':>8} {'OBJ':>9} {'XFER':>9} "
           f"{'SERVE':>6}  ALERTS")
    lines.append(hdr)
    for j in jobs:
        t = j.get("totals") or {}
        job = j["job"]
        live = j.get("state") == "LIVE"
        cpu_rate = last_rate("ray_tpu_job_cpu_seconds_total", job) if live else None
        task_rate = last_rate("ray_tpu_job_tasks_total", job) if live else None
        qw_p95 = last_rate("ray_tpu_job_queue_wait_seconds", job,
                           agg="max", q=0.95) if live else None
        names = []
        if (starve_thresh is not None and qw_p95 is not None
                and qw_p95 > starve_thresh):
            names.append("job_starved")
        if (runaway_thresh is not None
                and float(t.get("object_bytes") or 0) > runaway_thresh):
            names.append("job_runaway_object_bytes")
        alert_names = ",".join(names) or "-"
        lines.append(
            f"{job:<10} {j.get('state', ''):<9} "
            f"{str(j.get('driver') or '')[:18]:<18} "
            f"{'-' if cpu_rate is None else format(cpu_rate, '.2f'):>8} "
            f"{'-' if task_rate is None else format(task_rate, '.1f'):>8} "
            f"{'-' if qw_p95 is None else format(qw_p95, '.2f'):>8} "
            f"{_fmt_bytes(t.get('object_bytes')):>9} "
            f"{_fmt_bytes(t.get('transfer_bytes')):>9} "
            f"{t.get('serve_requests', 0):>6}  {alert_names}"
        )
    if not jobs:
        lines.append("(no jobs)")
    lines.append("")
    if firing:
        lines.append("ALERTS FIRING:")
        for a in firing:
            lines.append(f"  !! {a['name']} ({a['severity']}): {a['summary']}")
    else:
        lines.append(f"alerts: {len(alerts)} rule(s), none firing")
    return "\n".join(lines)


def cmd_jobs(ns):
    """Live per-job accounting view (`ray_tpu_torch jobs`): cpu-s rate, tasks/s,
    queue-wait p95, object/transfer bytes, serve requests, firing alerts."""
    _connect(ns)
    from ray_tpu_torch.util import state as state_api

    if ns.json:
        print(json.dumps(state_api.job_report(ns.job) if ns.job
                         else state_api.list_jobs(), indent=2, default=str))
        return
    if ns.job:
        print(json.dumps(state_api.job_report(ns.job), indent=2, default=str))
        return
    i = 0
    try:
        while True:
            i += 1
            frame = _render_jobs(state_api, i)
            if not ns.no_clear:
                sys.stdout.write("\x1b[2J\x1b[H")
            print(frame, flush=True)
            if ns.iterations and i >= ns.iterations:
                break
            time.sleep(ns.interval)
    except KeyboardInterrupt:
        pass


def cmd_microbenchmark(_ns):
    # The reference runs the repo's bench_core.py, a benchmark of the JAX
    # package; the port's benchmark is still to come.
    raise NotImplementedError(
        "microbenchmark: the port has no core benchmark yet: ROADMAP.md item 9"
    )


# ---------------------------------------------------------------------- jobs
def cmd_job(ns):
    _connect(ns)
    from ray_tpu_torch.job_submission import JobSubmissionClient

    client = JobSubmissionClient()
    if ns.job_cmd == "submit":
        renv = {}
        if ns.working_dir:
            renv["working_dir"] = ns.working_dir
        job_id = client.submit_job(entrypoint=ns.entrypoint, runtime_env=renv or None)
        print(job_id)
        if ns.wait:
            status = client.wait_until_finished(job_id, timeout=ns.timeout)
            print(status)
            print(client.get_job_logs(job_id), end="")
            sys.exit(0 if status == "SUCCEEDED" else 1)
    elif ns.job_cmd == "status":
        print(client.get_job_status(ns.job_id))
    elif ns.job_cmd == "logs":
        print(client.get_job_logs(ns.job_id), end="")
    elif ns.job_cmd == "list":
        print(json.dumps(client.list_jobs(), indent=2))
    elif ns.job_cmd == "stop":
        print("stopped" if client.stop_job(ns.job_id) else "not running")


# ---------------------------------------------------------------------- main
def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head server or node daemon")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--address", help="head address (node-daemon mode)")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--resources", help="JSON resource map")
    sp.add_argument("--shm-dir")
    sp.add_argument("--dashboard-port", type=int, default=None)
    sp.add_argument("--persist", help="GCS persistence file (head mode)")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop processes started by this CLI")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser("status", help="cluster rollup")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser("list", help="list cluster entities")
    sp.add_argument("what", choices=["nodes", "actors", "tasks", "objects"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("timeline", help="dump chrome://tracing timeline")
    sp.add_argument("--output", default="timeline.json")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("stack", help="all-thread stack dump of every live process")
    sp.add_argument("--timeout", type=float, default=None,
                    help="per-process reply deadline before the out-of-band "
                         "faulthandler fallback")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_stack)

    sp = sub.add_parser("memory", help="object ownership/refcount attribution")
    sp.add_argument("--json", action="store_true", help="raw JSON output")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("profile", help="cluster-wide sampling profile")
    sp.add_argument("--duration", type=float, default=1.0)
    sp.add_argument("--hz", type=float, default=None)
    sp.add_argument("--output", help="write folded stacks to this file")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser("events", help="cluster event log (node/worker/serve/"
                                       "autoscaler/alert transitions)")
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--kind", help="filter by event kind")
    sp.add_argument("--severity", help="filter by severity")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser("series", help="query the head time-series store")
    sp.add_argument("name", help="metric name (e.g. ray_tpu_serve_shed_total)")
    sp.add_argument("--labels", help="JSON tag filter, e.g. '{\"app\":\"f\"}'")
    sp.add_argument("--window", type=float, default=60.0,
                    help="lookback seconds (0 = full retention)")
    sp.add_argument("--step", type=float, default=None)
    sp.add_argument("--agg", default="sum", choices=["sum", "max", "avg"])
    sp.add_argument("--q", type=float, default=None,
                    help="histogram quantile (e.g. 0.95)")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_series)

    sp = sub.add_parser("trace", help="end-to-end request traces "
                                      "(list, or one trace's critical path)")
    sp.add_argument("--trace-id", help="show one trace's spans + attribution")
    sp.add_argument("--limit", type=int, default=50)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser("latency", help="per-component latency attribution "
                                        "over recent traces")
    sp.add_argument("--limit", type=int, default=200)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_latency)

    sp = sub.add_parser("train", help="training-gang goodput ledgers "
                                      "(phase split, straggler, badput)")
    sp.add_argument("--gang", help="one gang id (default: all gangs)")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("top", help="live refreshing cluster view")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--iterations", type=int, default=0,
                    help="stop after N frames (0 = until Ctrl-C)")
    sp.add_argument("--no-clear", action="store_true",
                    help="append frames instead of clearing the screen")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser("jobs", help="live per-job accounting view "
                                     "(who is using the cluster)")
    sp.add_argument("--job", help="one job's full ledger report (JSON)")
    sp.add_argument("--interval", type=float, default=2.0)
    sp.add_argument("--iterations", type=int, default=0,
                    help="stop after N frames (0 = until Ctrl-C)")
    sp.add_argument("--no-clear", action="store_true",
                    help="append frames instead of clearing the screen")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_jobs)

    sp = sub.add_parser("microbenchmark", help="run the core microbenchmark")
    sp.set_defaults(fn=cmd_microbenchmark)

    sp = sub.add_parser("job", help="job submission")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("--entrypoint", required=True)
    j.add_argument("--working-dir")
    j.add_argument("--wait", action="store_true")
    j.add_argument("--timeout", type=float, default=600.0)
    j.add_argument("--address")
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("job_id")
        j.add_argument("--address")
    j = jsub.add_parser("list")
    j.add_argument("--address")
    sp.set_defaults(fn=cmd_job)

    ns = p.parse_args(argv)
    ns.fn(ns)


if __name__ == "__main__":
    main()
