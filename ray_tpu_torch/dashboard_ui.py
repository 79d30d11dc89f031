"""Dashboard web UI: a single-file, zero-dependency HTML client.

The reference ships a 14.9k-LoC React/TypeScript client
(`dashboard/client/src`); this build keeps the dashboard surface but
renders it with one self-contained page of vanilla JS polling the same
JSON endpoints the CLI uses (`/api/nodes`, `/api/actors`, `/api/tasks`,
`/api/jobs`, `/api/placement_groups`, `/api/cluster_resources`,
`/api/serve`) — no build step, no npm, served straight from the dashboard
process at `/`. The port's page is the reference's with the cards read
from the `GPU` resource ("GPUs in use", a GPU column per node).
"""

DASHBOARD_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>ray_tpu_torch dashboard</title>
<style>
  :root { --bg:#0f1318; --panel:#171d25; --line:#262f3b; --text:#d5dde6;
          --dim:#7b8794; --accent:#4da3ff; --ok:#3fb68b; --bad:#e5564f;
          --warn:#d9a441; }
  * { box-sizing:border-box; margin:0; }
  body { background:var(--bg); color:var(--text);
         font:14px/1.45 system-ui,-apple-system,"Segoe UI",sans-serif;
         padding:24px; }
  h1 { font-size:18px; font-weight:600; margin-bottom:4px; }
  .sub { color:var(--dim); font-size:12px; margin-bottom:20px; }
  .grid { display:grid; grid-template-columns:repeat(auto-fit,minmax(180px,1fr));
          gap:12px; margin-bottom:20px; }
  .tile { background:var(--panel); border:1px solid var(--line);
          border-radius:8px; padding:14px 16px; }
  .tile .v { font-size:24px; font-weight:600; font-variant-numeric:tabular-nums; }
  .tile .l { color:var(--dim); font-size:12px; margin-top:2px; }
  section { background:var(--panel); border:1px solid var(--line);
            border-radius:8px; padding:16px; margin-bottom:16px; }
  section h2 { font-size:13px; font-weight:600; color:var(--dim);
               text-transform:uppercase; letter-spacing:.06em; margin-bottom:10px; }
  table { width:100%; border-collapse:collapse; font-size:13px; }
  th { text-align:left; color:var(--dim); font-weight:500; padding:4px 10px 6px 0;
       border-bottom:1px solid var(--line); }
  td { padding:5px 10px 5px 0; border-bottom:1px solid var(--line);
       font-variant-numeric:tabular-nums; }
  tr:last-child td { border-bottom:none; }
  .mono { font-family:ui-monospace,Menlo,monospace; font-size:12px; }
  .pill { display:inline-block; padding:1px 8px; border-radius:999px;
          font-size:11px; font-weight:600; }
  .ok   { background:rgba(63,182,139,.15); color:var(--ok); }
  .bad  { background:rgba(229,86,79,.15);  color:var(--bad); }
  .warn { background:rgba(217,164,65,.15); color:var(--warn); }
  .bar { height:6px; background:var(--line); border-radius:3px; overflow:hidden;
         min-width:80px; }
  .bar > div { height:100%; background:var(--accent); }
  .empty { color:var(--dim); font-size:13px; padding:6px 0; }
</style>
</head>
<body>
<h1>ray_tpu_torch</h1>
<div class="sub">cluster dashboard — auto-refreshes every 2s ·
  <a style="color:var(--accent)" href="/metrics">/metrics</a> ·
  <a style="color:var(--accent)" href="/timeline">/timeline</a></div>
<div class="grid" id="tiles"></div>
<section><h2>Nodes</h2><div id="nodes"></div></section>
<section><h2>Actors</h2><div id="actors"></div></section>
<section><h2>Jobs</h2><div id="jobs"></div></section>
<section><h2>Placement groups</h2><div id="pgs"></div></section>
<section><h2>Recent tasks</h2><div id="tasks"></div></section>
<script>
const $ = id => document.getElementById(id);
const esc = s => String(s ?? "").replace(/[&<>"]/g,
  c => ({"&":"&amp;","<":"&lt;",">":"&gt;",'"':"&quot;"}[c]));
const pill = (text, cls) => `<span class="pill ${cls}">${esc(text)}</span>`;
const statePill = s => {
  s = String(s || "");
  if (/ALIVE|RUNNING|FINISHED|SUCCEEDED|CREATED/.test(s)) return pill(s, "ok");
  if (/DEAD|FAILED/.test(s)) return pill(s, "bad");
  return pill(s, "warn");
};
function table(rows, cols) {
  if (!rows || !rows.length) return '<div class="empty">none</div>';
  const head = cols.map(c => `<th>${esc(c[0])}</th>`).join("");
  const body = rows.map(r =>
    "<tr>" + cols.map(c => `<td>${c[1](r)}</td>`).join("") + "</tr>").join("");
  return `<table><thead><tr>${head}</tr></thead><tbody>${body}</tbody></table>`;
}
const shortId = x => `<span class="mono">${esc(String(x ?? "").slice(0, 12))}</span>`;
function bar(used, total) {
  const pct = total > 0 ? Math.min(100, 100 * used / total) : 0;
  return `<div class="bar"><div style="width:${pct}%"></div></div>`;
}
async function j(path) {
  const r = await fetch(path);
  if (!r.ok) throw new Error(path + " -> " + r.status);
  return r.json();
}
async function refresh() {
  try {
    const [nodes, actors, tasks, jobs, pgs, res] = await Promise.all([
      j("/api/nodes"), j("/api/actors"), j("/api/tasks"), j("/api/jobs"),
      j("/api/placement_groups"), j("/api/cluster_resources")]);
    const alive = nodes.filter(n => n.alive !== false);
    const cpuT = res.total.CPU || 0, cpuA = res.available.CPU || 0;
    const gpuT = res.total.GPU || 0, gpuA = res.available.GPU || 0;
    const liveActors = actors.filter(a => a.state === "ALIVE").length;
    $("tiles").innerHTML = [
      [alive.length, "alive nodes"],
      [`${(cpuT - cpuA).toFixed(0)} / ${cpuT.toFixed(0)}`, "CPUs in use"],
      [`${(gpuT - gpuA).toFixed(0)} / ${gpuT.toFixed(0)}`, "GPUs in use"],
      [liveActors, "live actors"],
      [jobs.filter(jb => jb.status === "RUNNING").length, "running jobs"],
      [tasks.length, "recent task records"],
    ].map(t => `<div class="tile"><div class="v">${esc(t[0])}</div>` +
               `<div class="l">${esc(t[1])}</div></div>`).join("");
    $("nodes").innerHTML = table(nodes, [
      ["node", n => shortId(n.node_id)],
      ["address", n => `<span class="mono">${esc(n.address)}</span>`],
      ["state", n => n.alive === false ? pill("DEAD","bad") : pill("ALIVE","ok")],
      ["CPU", n => { const t = (n.resources_total||{}).CPU||0,
                     a = (n.resources_available||{}).CPU||0;
                     return `${(t-a).toFixed(0)}/${t.toFixed(0)} ` + bar(t-a, t); }],
      ["GPU", n => { const t = (n.resources_total||{}).GPU||0,
                     a = (n.resources_available||{}).GPU||0;
                     return t ? `${(t-a).toFixed(0)}/${t.toFixed(0)} ` + bar(t-a, t) : "—"; }],
    ]);
    $("actors").innerHTML = table(actors.slice(0, 50), [
      ["actor", a => shortId(a.actor_id)],
      ["class", a => esc(a.class_name || "")],
      ["name", a => esc(a.name || "")],
      ["state", a => statePill(a.state)],
      ["restarts", a => esc(a.num_restarts ?? 0)],
      ["node", a => shortId(a.node_id || "")],
    ]);
    $("jobs").innerHTML = table(jobs, [
      ["job", jb => shortId(jb.job_id)],
      ["status", jb => statePill(jb.status)],
      ["entrypoint", jb => `<span class="mono">${esc(jb.entrypoint || "(driver)")}</span>`],
    ]);
    $("pgs").innerHTML = table(pgs, [
      ["group", p => shortId(p.placement_group_id)],
      ["strategy", p => esc(p.strategy)],
      ["bundles", p => esc((p.bundles || []).length)],
      ["state", p => statePill(p.state || "CREATED")],
    ]);
    $("tasks").innerHTML = table(tasks.slice(-30).reverse(), [
      ["task", t => shortId(t.task_id)],
      ["name", t => esc(t.name || "")],
      ["type", t => esc(t.type || "")],
      ["state", t => statePill(t.state)],
    ]);
  } catch (e) {
    $("tiles").innerHTML =
      `<div class="tile"><div class="v">—</div><div class="l">${esc(e)}</div></div>`;
  }
}
refresh();
setInterval(refresh, 2000);
</script>
</body>
</html>
"""
