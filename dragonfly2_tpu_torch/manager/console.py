"""The manager's embedded web console: the port's copy of
``dragonfly2_tpu/manager/console.py``, the same single page.

It reads clusters, schedulers, seed peers, peers and jobs, and creates
scheduler clusters, preheat jobs and users and grants or revokes roles,
all through the RBAC-gated REST API with a token sign-in. ``GET /``
serves it.
"""

INDEX_HTML = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>dragonfly2-tpu console</title>
<style>
  body { font-family: ui-monospace, SFMono-Regular, Menlo, monospace;
         margin: 2rem auto; max-width: 70rem; color: #222; }
  h1 { font-size: 1.2rem; }
  h2 { font-size: 1rem; margin-top: 1.5rem; }
  table { border-collapse: collapse; width: 100%; font-size: 0.85rem; }
  th, td { border: 1px solid #ccc; padding: 0.3rem 0.5rem; text-align: left; }
  th { background: #f4f4f4; }
  input, button { font: inherit; padding: 0.25rem 0.5rem; }
  .err { color: #b00020; }
  .state-active { color: #0a7d33; }
  .state-inactive { color: #999; }
</style>
</head>
<body>
<h1>dragonfly2-tpu manager</h1>
<div id="signin">
  <input id="user" placeholder="user" value="root">
  <input id="pass" placeholder="password" type="password">
  <button onclick="signin()">sign in</button>
  <span id="msg" class="err"></span>
</div>
<div id="main" style="display:none">
  <h2>scheduler clusters</h2><table id="scheduler-clusters"></table>
  <form onsubmit="return createCluster(this)">
    <input name="name" placeholder="new cluster name" required>
    <button>create cluster</button> <span class="err" id="cluster-msg"></span>
  </form>
  <h2>schedulers</h2><table id="schedulers"></table>
  <h2>seed peers</h2><table id="seed-peers"></table>
  <h2>peers</h2><table id="peers"></table>
  <h2>jobs</h2><table id="jobs"></table>
  <form onsubmit="return createPreheat(this)">
    <select name="ptype"><option>file</option><option>image</option></select>
    <input name="url" placeholder="preheat url" size="40" required>
    <input name="ranges" placeholder="ranges a-b,c-d (optional)" size="24">
    <label><input type="checkbox" name="device"> land in TPU HBM</label>
    <button>trigger preheat</button> <span class="err" id="job-msg"></span>
  </form>
  <h2>users &amp; roles</h2>
  <form onsubmit="return createUser(this)">
    <input name="name" placeholder="new user" required>
    <input name="password" placeholder="password" type="password" required>
    <button>create user</button> <span class="err" id="user-msg"></span>
  </form>
  <form onsubmit="return grantRole(this, event)">
    <input name="uid" placeholder="user id" size="6" required>
    <input name="role" placeholder="role" required>
    <button name="verb" value="grant">grant</button>
    <button name="verb" value="revoke">revoke</button>
    <span class="err" id="role-msg"></span>
  </form>
</div>
<script>
let token = "";
async function api(path) {
  const r = await fetch("/api/v1/" + path,
                        {headers: {Authorization: "Bearer " + token}});
  if (!r.ok) throw new Error(path + ": " + r.status);
  return await r.json();
}
async function post(path, body, method) {
  const r = await fetch("/api/v1/" + path, {
    method: method || "POST",
    headers: {Authorization: "Bearer " + token,
              "Content-Type": "application/json"},
    body: body === undefined ? undefined : JSON.stringify(body)});
  if (!r.ok) throw new Error(path + ": " + r.status + " " + await r.text());
  return r.status === 204 ? {} : await r.json();
}
function formAction(msgId, fn) {
  const el = document.getElementById(msgId);
  el.textContent = "";
  fn().then(refresh).catch(e => { el.textContent = e.message; });
  return false;
}
function createCluster(f) {
  return formAction("cluster-msg",
      () => post("scheduler-clusters", {name: f.name.value}));
}
function createPreheat(f) {
  const args = {type: f.ptype.value, url: f.url.value,
                device: f.device.checked ? "tpu" : ""};
  const spans = f.ranges.value.split(",").map(s => s.trim()).filter(Boolean);
  if (spans.length) args.ranges = spans;  // sharded preheat: one task/span
  return formAction("job-msg", () => post("jobs", {type: "preheat", args}));
}
function createUser(f) {
  return formAction("user-msg", () => post("users/signup",
      {name: f.name.value, password: f.password.value}));
}
function grantRole(f, ev) {
  // event.submitter is the reliable clicked-button source; activeElement
  // is wrong on Safari and on Enter-key submits. With no submitter info
  // ABORT — silently defaulting would risk inverting a privileged
  // revoke into a grant.
  if (!ev || !ev.submitter || !ev.submitter.value) {
    document.getElementById("role-msg").textContent =
        "use the grant/revoke buttons";
    return false;
  }
  const verb = ev.submitter.value;
  const path = "users/" + encodeURIComponent(f.uid.value)
             + "/roles/" + encodeURIComponent(f.role.value);
  return formAction("role-msg",
      () => post(path, undefined, verb === "revoke" ? "DELETE" : "PUT"));
}
function esc(v) {
  // Every rendered value is attacker-influenced once write paths exist
  // (cluster/user names): escape before the innerHTML sink or a stored
  // name like <img onerror=...> runs in every signed-in console.
  return String(v).replace(/[&<>"']/g, c => ({
    "&": "&amp;", "<": "&lt;", ">": "&gt;",
    '"': "&quot;", "'": "&#39;"}[c]));
}
function render(id, rows, cols) {
  const t = document.getElementById(id);
  if (!rows || !rows.length) { t.innerHTML = "<tr><td>none</td></tr>"; return; }
  cols = cols || Object.keys(rows[0]).filter(
      k => typeof rows[0][k] !== "object").slice(0, 8);
  t.innerHTML = "<tr>" + cols.map(c => "<th>" + esc(c) + "</th>").join("") + "</tr>"
    + rows.map(r => "<tr>" + cols.map(c => {
        let v = r[c] == null ? "" : r[c];
        const cls = c === "state" ? ' class="state-' + esc(v) + '"' : "";
        return "<td" + cls + ">" + esc(v) + "</td>";
      }).join("") + "</tr>").join("");
}
async function refresh() {
  render("scheduler-clusters", await api("scheduler-clusters"),
         ["id", "name", "bio", "is_default"]);
  render("schedulers", await api("schedulers"),
         ["id", "hostname", "ip", "port", "state", "scheduler_cluster_id"]);
  render("seed-peers", await api("seed-peers"),
         ["id", "hostname", "ip", "port", "download_port", "state"]);
  render("peers", await api("peers"),
         ["id", "hostname", "ip", "port", "state"]);
  render("jobs", await api("jobs"),
         ["id", "type", "state", "created_at"]);
}
async function signin() {
  document.getElementById("msg").textContent = "";
  try {
    const r = await fetch("/api/v1/users/signin", {method: "POST",
      body: JSON.stringify({name: document.getElementById("user").value,
                            password: document.getElementById("pass").value})});
    if (!r.ok) throw new Error("signin " + r.status);
    token = (await r.json()).token;
    document.getElementById("signin").style.display = "none";
    document.getElementById("main").style.display = "";
    await refresh();
    setInterval(refresh, 5000);
  } catch (e) {
    document.getElementById("msg").textContent = e.message;
  }
}
</script>
</body>
</html>
"""
