"""Self-contained live dashboard page.

Reference: `dashboard/client/src/App.tsx` — the reference ships a React/TS
SPA built ahead of time; this is the 20%-of-the-build that gives the
operator views that matter (cluster tiles, nodes/actors/tasks/jobs tables),
as ONE inline page: vanilla JS polling the existing REST endpoints every
2 s, no build step, no external assets, served straight from memory.
"""

INDEX_HTML = """<!doctype html>
<html>
<head>
<meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
  :root { color-scheme: light dark; }
  body { font-family: system-ui, sans-serif; margin: 0; background: #f6f7f9; color: #1a1d21; }
  @media (prefers-color-scheme: dark) { body { background: #15171a; color: #e8eaed; } }
  header { padding: 14px 22px; background: #20242c; color: #fff; display: flex; align-items: baseline; gap: 14px; }
  header h1 { font-size: 17px; margin: 0; font-weight: 600; }
  header .sub { color: #9aa4b2; font-size: 12px; }
  main { padding: 18px 22px; max-width: 1200px; margin: 0 auto; }
  .tiles { display: flex; gap: 12px; flex-wrap: wrap; margin-bottom: 18px; }
  .tile { background: #fff; border: 1px solid #dde1e6; border-radius: 8px; padding: 10px 16px; min-width: 110px; }
  @media (prefers-color-scheme: dark) { .tile { background: #1e2228; border-color: #2d333b; } }
  .tile .num { font-size: 22px; font-weight: 650; }
  .tile .lbl { font-size: 11px; color: #6b7482; text-transform: uppercase; letter-spacing: .04em; }
  section { margin-bottom: 22px; }
  h2 { font-size: 13px; text-transform: uppercase; letter-spacing: .05em; color: #6b7482; margin: 0 0 6px; }
  table { border-collapse: collapse; width: 100%; background: #fff; border: 1px solid #dde1e6; border-radius: 8px; overflow: hidden; font-size: 13px; }
  @media (prefers-color-scheme: dark) { table { background: #1e2228; border-color: #2d333b; } }
  th, td { text-align: left; padding: 6px 12px; border-bottom: 1px solid #edf0f3; white-space: nowrap; }
  @media (prefers-color-scheme: dark) { th, td { border-bottom-color: #2d333b; } }
  th { font-size: 11px; color: #6b7482; text-transform: uppercase; letter-spacing: .04em; }
  tr:last-child td { border-bottom: none; }
  .ok { color: #188038; } .bad { color: #c5221f; }
  #updated { font-size: 11px; color: #9aa4b2; }
</style>
</head>
<body>
<header>
  <h1>ray_tpu_torch dashboard</h1>
  <span class="sub">live — polls /api every 2s</span>
  <span id="updated"></span>
</header>
<main>
  <div class="tiles" id="tiles"></div>
  <section><h2>Nodes</h2>
    <table id="nodes-table"><thead><tr>
      <th>node id</th><th>alive</th><th>resources</th><th>workers</th><th>labels</th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section><h2>Actors</h2>
    <table id="actors-table"><thead><tr>
      <th>actor id</th><th>class</th><th>name</th><th>state</th><th>restarts</th><th>node</th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section><h2>Tasks</h2>
    <table id="tasks-table"><thead><tr>
      <th>task id</th><th>name</th><th>state</th><th>node</th>
    </tr></thead><tbody></tbody></table>
  </section>
  <section><h2>Jobs</h2>
    <table id="jobs-table"><thead><tr>
      <th>job</th><th>driver</th><th>state</th><th>cpu-s</th><th>tasks f/x/c</th>
      <th>queue-wait s</th><th>object bytes</th><th>xfer bytes</th><th>serve reqs</th>
    </tr></thead><tbody></tbody></table>
  </section>
</main>
<script>
"use strict";
const esc = (s) => String(s ?? "").replace(/[&<>"]/g,
  (c) => ({"&": "&amp;", "<": "&lt;", ">": "&gt;", '"': "&quot;"}[c]));
const fmtRes = (r) => Object.entries(r || {})
  .map(([k, v]) => `${esc(k)}: ${esc(v)}`).join(", ");

function fill(tableId, rows) {
  const body = document.querySelector(`#${tableId} tbody`);
  body.innerHTML = rows.length
    ? rows.join("")
    : '<tr><td colspan="9" style="color:#9aa4b2">none</td></tr>';
}

async function getJSON(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(`${path}: ${r.status}`);
  return r.json();
}

async function refresh() {
  try {
    const [cluster, nodes, actors, tasks, jobs] = await Promise.all([
      getJSON("/api/cluster"), getJSON("/api/nodes"), getJSON("/api/actors"),
      getJSON("/api/tasks"), getJSON("/api/jobs").catch(() => []),
    ]);
    const running = tasks.filter((t) => t.state === "RUNNING").length;
    const tiles = [
      ["nodes", nodes.filter((n) => n.alive !== false).length],
      ["cpus", Object.entries(cluster.cluster_resources || {})
        .filter(([k]) => k === "CPU").map(([, v]) => v)[0] ?? 0],
      ["actors", actors.length],
      ["running tasks", running],
      ["jobs", jobs.length],
    ];
    document.getElementById("tiles").innerHTML = tiles.map(
      ([lbl, num]) =>
        `<div class="tile"><div class="num">${esc(num)}</div>` +
        `<div class="lbl">${esc(lbl)}</div></div>`).join("");
    fill("nodes-table", nodes.map((n) =>
      `<tr><td>${esc((n.node_id || "").slice(0, 14))}</td>` +
      `<td class="${n.alive === false ? "bad" : "ok"}">` +
      `${n.alive === false ? "dead" : "alive"}</td>` +
      `<td>${fmtRes(n.resources)}</td>` +
      `<td>${esc(n.num_workers ?? "")}</td>` +
      `<td>${fmtRes(n.labels)}</td></tr>`));
    fill("actors-table", actors.map((a) =>
      `<tr><td>${esc((a.actor_id || "").slice(0, 14))}</td>` +
      `<td>${esc(a.class_name)}</td><td>${esc(a.name || "")}</td>` +
      `<td class="${a.state === "ALIVE" ? "ok" : ""}">${esc(a.state)}</td>` +
      `<td>${esc(a.num_restarts ?? 0)}</td>` +
      `<td>${esc((a.node_id || "").slice(0, 14))}</td></tr>`));
    fill("tasks-table", tasks.slice(-50).reverse().map((t) =>
      `<tr><td>${esc((t.task_id || "").slice(0, 14))}</td>` +
      `<td>${esc(t.name)}</td><td>${esc(t.state)}</td>` +
      `<td>${esc((t.node_id || "").slice(0, 14))}</td></tr>`));
    const fmtB = (n) => n >= 1 << 20 ? (n / (1 << 20)).toFixed(1) + " MiB"
      : n >= 1024 ? (n / 1024).toFixed(1) + " KiB" : String(n | 0);
    fill("jobs-table", jobs.map((j) => {
      const t = j.totals || {};
      const k = t.tasks || {};
      return `<tr><td>${esc(j.job)}</td><td>${esc(j.driver || "")}</td>` +
        `<td class="${j.state === "LIVE" ? "ok" : ""}">${esc(j.state)}</td>` +
        `<td>${esc((t.cpu_seconds ?? 0).toFixed(1))}</td>` +
        `<td>${esc(k.finished ?? 0)}/${esc(k.failed ?? 0)}/${esc(k.cancelled ?? 0)}</td>` +
        `<td>${esc((t.queue_wait_seconds ?? 0).toFixed(2))}</td>` +
        `<td>${fmtB(t.object_bytes ?? 0)}</td>` +
        `<td>${fmtB(t.transfer_bytes ?? 0)}</td>` +
        `<td>${esc(t.serve_requests ?? 0)}</td></tr>`;
    }));
    document.getElementById("updated").textContent =
      "updated " + new Date().toLocaleTimeString();
  } catch (e) {
    document.getElementById("updated").textContent = "refresh failed: " + e;
  }
}
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""
