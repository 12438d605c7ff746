"""The admin's browser UI (the counterpart of the pages of
`seaweedfs_tpu/plugin/admin.py`; reference weed/admin/view/app/):

    GET  /              dashboard: data nodes, workers, job types, jobs
    GET  /ui/volumes    every volume replica with its garbage ratio
    GET  /ui/ec         EC volumes and where their shards are
    GET  /ui/jobs       job history (?status= filters) and the actions
    GET  /ui/config     a form a job type, from the workers' schemas
    POST /ui/config     apply a form (the `/maintenance/config` checks)
    POST /ui/actions    action=detect (run detection now) or
                        action=submit (jobType, params JSON)

Every POST must carry the form's CSRF token (one a process, served in
the forms) and, when security.toml sets an admin key or white list, the
admin's credentials: 403 otherwise, the credentials checked first.  It
runs nothing on the device."""

from __future__ import annotations

import html
import json
import time
import urllib.parse
import uuid

from ..operation import master_json
from ..server.httpd import Request
from ..topology import iter_volume_list_ec_shards, iter_volume_list_volumes

_NAV = ("<p><a href='/'>dashboard</a> | "
        "<a href='/ui/volumes'>volumes</a> | "
        "<a href='/ui/ec'>ec</a> | "
        "<a href='/ui/jobs'>jobs</a> | "
        "<a href='/ui/config'>config</a></p>")


class _FormShim:
    """A parsed form handed to a JSON handler, so both entry points
    share one validation path."""

    def __init__(self, payload: dict):
        self._payload = payload
        self.query: dict = {}

    def json(self) -> dict:
        return self._payload


class AdminUI:
    def __init__(self, admin):
        self.admin = admin
        self.csrf = uuid.uuid4().hex
        r = admin.http.route
        r("GET", "/", self.dashboard)
        r("GET", "/ui/volumes", self.volumes)
        r("GET", "/ui/ec", self.ec)
        r("GET", "/ui/jobs", self.jobs)
        r("GET", "/ui/config", self.config)
        r("POST", "/ui/config", self.config_submit)
        r("POST", "/ui/actions", self.actions)

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def page(title: str, inner: str):
        body = f"""<!doctype html><html><head>
<title>{html.escape(title)} - seaweedfs-tpu admin</title>
<style>body{{font-family:sans-serif;margin:2em}}
table{{border-collapse:collapse;margin:1em 0}}
td,th{{border:1px solid #ccc;padding:4px 10px;text-align:left}}
h2{{margin-top:1.5em}} .ok{{color:#2a2}} .bad{{color:#c22}}
input{{margin:2px}}</style></head><body>
<h1>{html.escape(title)}</h1>{_NAV}{inner}</body></html>"""
        return 200, (body.encode(), "text/html; charset=utf-8")

    def _csrf_input(self) -> str:
        return f"<input type='hidden' name='csrf' value='{self.csrf}'>"

    def _write_guard(self, req: Request, form: dict):
        """The admin credentials (when configured), then the CSRF token:
        403 for either, so a caller without credentials learns nothing
        of the token."""
        from .. import security
        err = security.current().check_admin(req.query, req.headers,
                                             req.remote_ip)
        if err:
            return 403, {"error": f"admin credentials required: {err}"}
        if form.get("csrf") != self.csrf:
            return 403, {"error": "missing or stale CSRF token; "
                                  "reload the form page"}
        return None

    @staticmethod
    def _form(req: Request) -> dict:
        """An HTML form body; a field cleared to empty reaches the
        validation instead of keeping its old value."""
        return {k: v[0] for k, v in urllib.parse.parse_qs(
            (req.body or b"").decode(), keep_blank_values=True).items()}

    def _master(self, path: str) -> dict:
        try:
            return master_json(self.admin.master, "GET", path, timeout=10)
        except OSError:
            return {}

    # -- pages --------------------------------------------------------------

    def dashboard(self, req: Request):
        a = self.admin
        vl, status = self._master("/vol/list"), \
            self._master("/cluster/status")
        rows = []
        for dc_name, dc in vl.get("dataCenters", {}).items():
            for rack_name, rack in dc.get("racks", {}).items():
                for node in rack.get("nodes", []):
                    rows.append(
                        f"<tr><td>{html.escape(dc_name)}/"
                        f"{html.escape(rack_name)}</td>"
                        f"<td>{html.escape(node['url'])}</td>"
                        f"<td>{len(node.get('volumes', []))}/"
                        f"{node.get('maxVolumeCount', '?')}</td>"
                        f"<td>{len(node.get('ecShards', []))}</td></tr>")
        with a.lock:
            workers = [
                f"<tr><td>{html.escape(w.worker_id)}</td>"
                f"<td>{html.escape(', '.join(sorted(str(c.get('jobType', '?')) for c in w.capabilities)))}</td>"  # noqa: E501
                f"<td>{w.inflight}/{w.max_concurrent}</td>"
                f"<td>{time.monotonic() - w.last_seen:.0f}s ago</td></tr>"
                for w in a.workers.values()]
            jobs = [self._job_row(j, j.trace[-1]["event"] if j.trace
                                  else "")
                    for j in sorted(a.jobs.values(),
                                    key=lambda j: -j.created)[:50]]
            config_rows = [
                f"<tr><td>{html.escape(jt)}</td>"
                f"<td>{html.escape(', '.join(f['name'] for f in fields))}"
                f"</td><td>{html.escape(str(a.config.get(jt, {})))}"
                f"</td></tr>"
                for jt, fields in sorted(a.schemas.items())]
        inner = f"""<p>master: {html.escape(a.master)} &middot;
leader: {html.escape(str(status.get('leader', '?')))} &middot;
topology: {html.escape(str(status.get('topologyId', '?')))}</p>
<h2>Data nodes</h2>
<table><tr><th>dc/rack</th><th>url</th><th>volumes</th>
<th>ec volumes</th></tr>{''.join(rows)}</table>
<h2>Workers</h2>
<table><tr><th>id</th><th>capabilities</th><th>inflight</th>
<th>seen</th></tr>{''.join(workers)}</table>
<h2>Job types (schemas + config)</h2>
<table><tr><th>type</th><th>schema fields</th><th>config</th></tr>
{''.join(config_rows)}</table>
<h2>Jobs (latest 50)</h2>
<table><tr><th>id</th><th>type</th><th>status</th><th>progress</th>
<th>message</th><th>last decision</th></tr>{''.join(jobs)}</table>"""
        return self.page("seaweedfs-tpu admin", inner)

    @staticmethod
    def _job_row(j, last: str) -> str:
        return (f"<tr><td><a href='/maintenance/job?id={j.job_id}'>"
                f"{j.job_id}</a></td>"
                f"<td>{html.escape(j.job_type)}</td>"
                f"<td>{html.escape(j.status)}</td>"
                f"<td>{j.progress:.0%}</td>"
                f"<td>{html.escape(j.message or '')}</td>"
                f"<td>{html.escape(last)}</td></tr>")

    def volumes(self, req: Request):
        """Every volume replica (cluster_volumes.templ)."""
        rows = []
        for node, v in sorted(
                iter_volume_list_volumes(self._master("/vol/list")),
                key=lambda t: (t[1]["id"], t[0]["url"])):
            garbage = v.get("deletedByteCount", 0)
            size = max(v.get("size", 0), 1)
            flags = ["readonly"] if v.get("readOnly") else []
            rows.append(
                f"<tr><td>{v['id']}</td>"
                f"<td>{html.escape(v.get('collection') or '-')}</td>"
                f"<td>{html.escape(node['url'])}</td>"
                f"<td>{v.get('size', 0):,}</td>"
                f"<td>{v.get('fileCount', 0)}</td>"
                f"<td>{garbage / size:.0%}</td>"
                f"<td>{html.escape(','.join(flags) or '-')}</td></tr>")
        return self.page(
            "Volumes",
            "<table><tr><th>id</th><th>collection</th><th>node</th>"
            "<th>bytes</th><th>files</th><th>garbage</th>"
            f"<th>flags</th></tr>{''.join(rows)}</table>"
            f"<p>{len(rows)} volume replicas</p>")

    def ec(self, req: Request):
        """EC volumes and their shards' spread (cluster_ec_volumes.templ):
        a volume with fewer than 14 shards listed shows in red."""
        by_vol: dict[int, list] = {}
        for node, e in iter_volume_list_ec_shards(self._master("/vol/list")):
            bits = int(e.get("shardBits", e.get("ecIndexBits", 0)))
            sids = [i for i in range(32) if bits >> i & 1]
            by_vol.setdefault(e.get("volumeId", e.get("id")),
                              []).append((node["url"], sids))
        rows = []
        for vid, spread in sorted(by_vol.items()):
            total = sum(len(s) for _, s in spread)
            cells = "; ".join(f"{html.escape(url)}: {','.join(map(str, s))}"
                              for url, s in sorted(spread))
            cls = "ok" if total >= 14 else "bad"
            rows.append(f"<tr><td>{vid}</td><td class='{cls}'>{total}</td>"
                        f"<td>{cells}</td></tr>")
        return self.page(
            "EC volumes",
            "<table><tr><th>volume</th><th>shards</th>"
            f"<th>placement</th></tr>{''.join(rows)}</table>"
            f"<p>{len(rows)} EC volumes</p>")

    def jobs(self, req: Request):
        """The job history with a status filter and each job's last
        decisions (maintenance_queue.templ), and the action forms."""
        a = self.admin
        want = req.query.get("status", "")
        with a.lock:
            jobs = sorted(a.jobs.values(), key=lambda j: -j.created)
            types_ = sorted(a.schemas)
        counts: dict[str, int] = {}
        for j in jobs:
            counts[j.status] = counts.get(j.status, 0) + 1
        if want:
            jobs = [j for j in jobs if j.status == want]
        filters = " | ".join(f"<a href='/ui/jobs?status={s}'>{s} ({n})</a>"
                             for s, n in sorted(counts.items()))
        rows = []
        for j in jobs[:200]:
            trace = "<br>".join(
                f"{html.escape(t.get('event', ''))} "
                f"{html.escape(str(t.get('detail', '')))}"
                for t in j.trace[-3:])
            rows.append(
                f"<tr><td><a href='/maintenance/job?id={j.job_id}'>"
                f"{j.job_id}</a></td>"
                f"<td>{html.escape(j.job_type)}</td>"
                f"<td>{html.escape(j.status)}</td>"
                f"<td>{j.progress:.0%}</td>"
                f"<td>{html.escape(str(j.params)[:80])}</td>"
                f"<td>{trace}</td></tr>")
        options = "".join(f"<option>{html.escape(t)}</option>"
                          for t in types_)
        actions = (
            "<h2>Actions</h2>"
            "<form method='post' action='/ui/actions' "
            "style='display:inline'>"
            "<input type='hidden' name='action' value='detect'>"
            f"{self._csrf_input()}"
            "<button>run detection now</button></form> "
            "<form method='post' action='/ui/actions' "
            "style='display:inline'>"
            "<input type='hidden' name='action' value='submit'>"
            f"{self._csrf_input()}"
            f"<select name='jobType'>{options}</select> "
            "params (JSON): <input name='params' value='{}' "
            "size='30'> <button>submit job</button></form>")
        return self.page(
            "Jobs",
            f"<p>filter: <a href='/ui/jobs'>all</a> | {filters}</p>"
            + actions +
            "<table><tr><th>id</th><th>type</th><th>status</th>"
            "<th>progress</th><th>params</th><th>decisions</th></tr>"
            f"{''.join(rows)}</table>")

    def config(self, req: Request):
        """A form a job type, from the schemas the workers registered,
        filled with the current values (or the defaults)."""
        a = self.admin
        with a.lock:
            schemas = {jt: list(fields)
                       for jt, fields in sorted(a.schemas.items())}
            values = {jt: dict(a.config.get(jt, {})) for jt in schemas}
        forms = []
        for jt, fields in schemas.items():
            inputs = []
            for f in fields:
                name = f["name"]
                cur = values[jt].get(name, f.get("default", ""))
                inputs.append(
                    f"<label>{html.escape(name)} "
                    f"<small>({html.escape(f.get('type', 'string'))})"
                    f"</small> <input name='{html.escape(name)}' "
                    f"value='{html.escape(str(cur))}'></label><br>")
            forms.append(
                f"<h2>{html.escape(jt)}</h2>"
                f"<form method='post' action='/ui/config'>"
                f"<input type='hidden' name='jobType' "
                f"value='{html.escape(jt)}'>"
                f"{self._csrf_input()}{''.join(inputs)}"
                f"<button>apply</button></form>")
        if not forms:
            forms = ["<p>no worker has registered a config schema yet</p>"]
        return self.page("Config", "".join(forms))

    # -- writes -------------------------------------------------------------

    def config_submit(self, req: Request):
        form = self._form(req)
        denied = self._write_guard(req, form)
        if denied is not None:
            return denied
        form.pop("csrf", None)
        jt = form.pop("jobType", "")
        status, payload = self.admin._set_config(
            _FormShim({"jobType": jt, "values": form}))
        if status != 200:
            return self.page("Config error",
                             f"<p class='bad'>{html.escape(str(payload))}"
                             "</p><p><a href='/ui/config'>back</a></p>")
        return 303, (b"", {"Location": "/ui/config",
                           "Content-Type": "text/plain"})

    def actions(self, req: Request):
        form = self._form(req)
        denied = self._write_guard(req, form)
        if denied is not None:
            return denied
        if form.get("action") == "detect":
            self.admin._trigger(_FormShim({}))
            return 303, (b"", {"Location": "/ui/jobs",
                               "Content-Type": "text/plain"})
        if form.get("action") == "submit":
            try:
                params = json.loads(form.get("params") or "{}")
            except ValueError as e:
                return self.page("Submit error",
                                 f"<p class='bad'>bad params JSON: {e}</p>"
                                 "<p><a href='/ui/jobs'>back</a></p>")
            status, payload = self.admin._submit_job(_FormShim(
                {"jobType": form.get("jobType", ""), "params": params}))
            if status != 200:
                return self.page("Submit error",
                                 f"<p class='bad'>{html.escape(str(payload))}"
                                 "</p><p><a href='/ui/jobs'>back</a></p>")
            return 303, (b"", {"Location": "/ui/jobs",
                               "Content-Type": "text/plain"})
        return 400, {"error": "unknown action"}
