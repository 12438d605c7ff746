"""The erasure-coding job handlers (the counterpart of
`seaweedfs_tpu/plugin/handlers/erasure_coding.py`; reference
plugin/worker/erasure_coding_handler.go: Capability :48, Descriptor :61,
Detect :187, Execute :445, delegating to
worker/tasks/erasure_coding/ec_task.go:59):

    markVolumeReadonly        (:261)
    copyVolumeFilesToWorker   (:300)  <- bulk .dat/.idx pull
    generateEcShardsLocally   (:426)  <- the card: the worker owns it,
                                         and the encode runs on the CUDA
                                         GF(2^8) kernel
    distributeEcShards        (:532)  -> ReceiveFile pushes to targets
    mountEcShards             (shard_distribution.go:209)
    deleteOriginalVolume      (:547)

`EcEncodeHandler(device=...)` encodes on that device ("cuda" by
default; a missing card fails the job).  No QoS watch of the source
and destination servers (ROADMAP C).
"""

from __future__ import annotations

import os

from ...operation import master_json
from ...server.httpd import http_download, http_json, http_upload
from ...storage.erasure_coding import ec_decoder, ec_encoder
from ...storage.erasure_coding.ec_context import ECContext, to_ext
from ...topology import iter_volume_list_volumes
from ..worker import JobHandler
from ..worker import must as _must


class EcEncodeHandler(JobHandler):
    job_type = "erasure_coding"

    def __init__(self, fullness_ratio: float = 0.9,
                 collection_filter: str | None = None,
                 data_shards: int = 10, parity_shards: int = 4,
                 device: str = "cuda",
                 encode_mode: str = "worker"):
        self.fullness_ratio = fullness_ratio
        self.collection_filter = collection_filter
        self.data_shards = data_shards
        self.parity_shards = parity_shards
        self.device = device
        # "worker": pull the volume here, encode on this worker's card,
        # distribute.  "scatter": drive the source server's
        # scatter-encode (its card); no volume byte crosses the worker
        self.encode_mode = encode_mode

    def capability(self) -> dict:
        # weight 80 per erasure_coding_handler.go:48
        return {"jobType": self.job_type, "canDetect": True,
                "canExecute": True, "weight": 80}

    def descriptor(self) -> dict:
        """Declarative admin/worker config forms (handler :61)."""
        return {"jobType": self.job_type, "fields": [
            {"name": "fullnessRatio", "type": "float",
             "default": self.fullness_ratio,
             "help": "encode volumes fuller than this fraction"},
            {"name": "collectionFilter", "type": "string",
             "default": self.collection_filter or "",
             "help": "only encode volumes of this collection"},
            {"name": "dataShards", "type": "int",
             "default": self.data_shards},
            {"name": "parityShards", "type": "int",
             "default": self.parity_shards},
            {"name": "encodeMode", "type": "string",
             "default": self.encode_mode,
             "help": "worker (pull+encode here) or scatter "
                     "(source streams shards to placement targets)"},
        ]}

    # -- Detect (:187) ------------------------------------------------

    def detect(self, worker) -> list[dict]:
        vl = master_json(worker.master, "GET", "/vol/list", timeout=30)
        size_limit = self._volume_size_limit(worker)
        proposals = []
        seen = set()
        for _node, v in iter_volume_list_volumes(vl):
            vid = v["id"]
            if vid in seen:
                continue
            seen.add(vid)
            if self.collection_filter not in (None, "") and \
                    v.get("collection", "") != self.collection_filter:
                continue
            if v.get("size", 0) < self.fullness_ratio * size_limit:
                continue
            proposals.append({
                "jobType": self.job_type,
                "dedupeKey": f"ec:{vid}",
                "params": {
                    "volumeId": vid,
                    "collection": v.get("collection", ""),
                    "dataShards": self.data_shards,
                    "parityShards": self.parity_shards,
                },
            })
        return proposals

    def _volume_size_limit(self, worker) -> int:
        r = master_json(worker.master, "GET", "/cluster/status", timeout=30)
        return int(r.get("volumeSizeLimit", 1 << 30))

    # -- Execute (ec_task.go:59) ---------------------------------------

    def _make_ctx(self, params: dict, collection: str,
                  vid: int) -> ECContext:
        """The job's scheme on this handler's device.  A CUDA device
        without a card raises here, before the volume is touched."""
        from ...ops.rs_torch import _resolve_device
        _resolve_device(self.device)
        return ECContext(
            int(params.get("dataShards", self.data_shards)),
            int(params.get("parityShards", self.parity_shards)),
            collection, vid, device=self.device)

    def _lookup_urls(self, worker, vid: int) -> list[str]:
        locations = master_json(worker.master, "GET",
                                f"/dir/lookup?volumeId={vid}",
                                timeout=30).get("locations", [])
        if not locations:
            raise RuntimeError(f"volume {vid} has no locations")
        return [loc["url"] for loc in locations]

    def _mark_readonly(self, urls: list[str], vid: int) -> None:
        # (:261)
        for url in urls:
            _must(http_json("POST", f"{url}/admin/set_readonly",
                            {"volumeId": vid, "readOnly": True},
                            timeout=30),
                  f"set readonly on {url}")

    def _pull_volume(self, worker, vid: int, collection: str,
                     source: str, base: str) -> None:
        """Copy .dat/.idx to the worker (:300), streamed to disk a chunk
        at a time: a 30 GB volume never sits in the worker's memory
        (the reference streams CopyFile the same way)."""
        os.makedirs(worker.work_dir, exist_ok=True)
        for ext in (".dat", ".idx"):
            status, _hdrs = http_download(
                f"{source}/admin/volume_file?volumeId={vid}"
                f"&collection={collection}&ext={ext}", base + ext,
                timeout=600)
            if status != 200:
                raise RuntimeError(f"copy {ext} from {source}: {status}")

    def _unwind_volumes(self, worker, collection: str, ctx: ECContext,
                        vol_urls: "dict[int, list[str]]") -> None:
        """Failure unwind, in order: (1) tear down any distributed or
        mounted shards, so the master never serves EC state beside the
        still-live volume, then (2) make the volume writable again."""
        try:
            targets = master_json(worker.master, "GET", "/cluster/status",
                                  timeout=30)["dataNodes"]
        except (OSError, KeyError):
            targets = []
        for vid, urls in vol_urls.items():
            for target in targets:
                try:
                    http_json("POST", f"{target}/admin/ec/delete_shards",
                              {"volumeId": vid, "collection": collection,
                               "shardIds": list(range(ctx.total))},
                              timeout=30)
                except OSError:
                    pass
            for url in urls:
                try:
                    http_json("POST", f"{url}/admin/set_readonly",
                              {"volumeId": vid, "readOnly": False},
                              timeout=30)
                except OSError:
                    pass

    @staticmethod
    def _cleanup_local(base: str, ctx: ECContext) -> None:
        for ext in [".dat", ".idx", ".ecx", ".ecj", ".vif"] + \
                [to_ext(i) for i in range(ctx.total)]:
            try:
                os.remove(base + ext)
            except FileNotFoundError:
                pass

    def _delete_originals(self, urls: list[str], vid: int) -> None:
        # (:547), only after every shard is mounted
        for url in urls:
            _must(http_json("POST", f"{url}/admin/delete_volume",
                            {"volumeId": vid}, timeout=30),
                  f"delete original on {url}")

    def execute(self, worker, job_id: str, params: dict) -> str:
        if params.get("encodeMode", self.encode_mode) == "scatter":
            if "volumeIds" in params:
                # scatter has no batch form (each volume streams from
                # its own source): the volumes run one after another
                out = []
                for v in dict.fromkeys(int(x)
                                       for x in params["volumeIds"]):
                    p = dict(params, volumeId=v)
                    p.pop("volumeIds", None)
                    out.append(self.execute_scatter(worker, job_id, p))
                return "\n".join(out)
            return self.execute_scatter(worker, job_id, params)
        if "volumeIds" in params:
            return self.execute_batch(worker, job_id, params)
        vid = int(params["volumeId"])
        collection = params.get("collection", "")
        ctx = self._make_ctx(params, collection, vid)
        urls = self._lookup_urls(worker, vid)
        base = os.path.join(worker.work_dir, f"{vid}")
        try:
            placement = self._encode_and_distribute(
                worker, job_id, vid, collection, ctx, urls, urls[0], base)
        except Exception:
            self._unwind_volumes(worker, collection, ctx, {vid: urls})
            raise
        finally:
            self._cleanup_local(base, ctx)
        self._delete_originals(urls, vid)
        return (f"volume {vid}: {ctx} shards encoded on worker "
                f"({ctx.device}) and distributed to "
                f"{sum(1 for s in placement.values() if s)} servers")

    def execute_scatter(self, worker, job_id: str, params: dict) -> str:
        """The source server's scatter-encode (`/admin/ec/generate` with
        a placement), planned and driven by the port shell's
        `_do_ec_encode` under the cluster admin lease, so placement
        cannot interleave with an operator's balance.  Volume bytes go
        from the source to the destinations, never through here."""
        from ...shell.commands import _do_ec_encode
        from .balance import _LockedShellRun
        vid = int(params["volumeId"])
        collection = params.get("collection", "")
        worker.report_progress(job_id, 0.1,
                               f"scatter-encoding volume {vid}")
        opts = {"collection": collection}
        if "dataShards" in params:
            opts["dataShards"] = params["dataShards"]
        if "parityShards" in params:
            opts["parityShards"] = params["parityShards"]
        with _LockedShellRun(worker.master) as env:
            msg = _do_ec_encode(
                env, vid,
                int(params.get("dataShards", self.data_shards)),
                int(params.get("parityShards", self.parity_shards)),
                opts, mode="scatter")
        worker.report_progress(job_id, 0.9, "scattered and mounted")
        return msg

    def _encode_and_distribute(self, worker, job_id: str, vid: int,
                               collection: str, ctx: ECContext,
                               urls: list[str], source: str,
                               base: str) -> dict:
        self._mark_readonly(urls, vid)
        worker.report_progress(job_id, 0.1, "marked readonly")
        self._pull_volume(worker, vid, collection, source, base)
        worker.report_progress(job_id, 0.3, "copied volume files")

        # 3. encode here (:426), on the card
        dat_size = os.path.getsize(base + ".dat")
        version = _read_dat_version(base)
        ec_encoder.write_sorted_file_from_idx(base)
        ec_encoder.write_ec_files(base, ctx)
        ec_encoder.save_ec_volume_info(base, ctx, dat_size, version)
        worker.report_progress(
            job_id, 0.6, f"encoded {ctx.total} shards ({ctx.device})")

        # consistency check (:638 verifyDatIdxConsistency): the decode
        # geometry must not reach past the source's size
        if ec_decoder.find_dat_file_size(base, base) > dat_size:
            raise RuntimeError("ecx entries exceed dat size")

        # 4+5. distribute and mount
        placement = self._distribute_and_mount(worker, vid, collection,
                                               ctx, base)
        worker.report_progress(job_id, 0.8, "distributed shards")
        return placement

    def _distribute_and_mount(self, worker, vid: int, collection: str,
                              ctx: ECContext, base: str) -> dict:
        """Round-robin spread over the alive servers (:532), then mount
        (shard_distribution.go:209)."""
        targets = master_json(worker.master, "GET", "/cluster/status",
                              timeout=30)["dataNodes"]
        if not targets:
            raise RuntimeError("no alive volume servers")
        placement: dict[str, list[int]] = {t: [] for t in targets}
        for sid in range(ctx.total):
            placement[targets[sid % len(targets)]].append(sid)
        for target, sids in placement.items():
            if not sids:
                continue
            for sid in sids:
                _push_file(target, vid, collection, to_ext(sid),
                           base + to_ext(sid))
            for ext in (".ecx", ".vif"):
                _push_file(target, vid, collection, ext, base + ext)
        for target, sids in placement.items():
            if sids:
                _must(http_json("POST", f"{target}/admin/ec/mount",
                                {"volumeId": vid,
                                 "collection": collection,
                                 "shardIds": sids}, timeout=30),
                      f"mount shards on {target}")
        return placement

    # -- batch: N volumes through one batched launch a step ------------
    # (BASELINE config 3: volumes ride the grid's stripe axis,
    # parallel/ec_batch.py)

    def execute_batch(self, worker, job_id: str, params: dict) -> str:
        from ...parallel.ec_batch import encode_volume_files_batch

        # a repeated id would append one volume's rows twice into one
        # set of shard files
        vids = list(dict.fromkeys(int(v) for v in params["volumeIds"]))
        collection = params.get("collection", "")
        ctx = self._make_ctx(params, collection, 0)
        os.makedirs(worker.work_dir, exist_ok=True)
        vol_urls: dict[int, list[str]] = {}
        bases = {vid: os.path.join(worker.work_dir, f"{vid}")
                 for vid in vids}
        n = len(vids)
        try:
            # progress after every volume: a silent 64-volume job would
            # trip the admin's stall reaper and run twice
            for i, vid in enumerate(vids):
                vol_urls[vid] = self._lookup_urls(worker, vid)
                self._mark_readonly(vol_urls[vid], vid)
                self._pull_volume(worker, vid, collection,
                                  vol_urls[vid][0], bases[vid])
                worker.report_progress(
                    job_id, 0.05 + 0.25 * (i + 1) / n,
                    f"pulled volume {vid} ({i + 1}/{n})")

            for vid in vids:
                ec_encoder.write_sorted_file_from_idx(bases[vid])
            encode_volume_files_batch([bases[v] for v in vids], ctx)
            for vid in vids:
                base = bases[vid]
                dat_size = os.path.getsize(base + ".dat")
                ec_encoder.save_ec_volume_info(
                    base, ctx, dat_size, _read_dat_version(base))
                if ec_decoder.find_dat_file_size(base, base) > dat_size:
                    raise RuntimeError(
                        f"volume {vid}: ecx entries exceed dat size")
            worker.report_progress(
                job_id, 0.6, f"batch-encoded {n} volumes ({ctx.device})")

            for i, vid in enumerate(vids):
                self._distribute_and_mount(worker, vid, collection,
                                           ctx, bases[vid])
                worker.report_progress(
                    job_id, 0.6 + 0.3 * (i + 1) / n,
                    f"distributed volume {vid} ({i + 1}/{n})")
        except Exception:
            self._unwind_volumes(worker, collection, ctx, vol_urls)
            raise
        finally:
            for base in bases.values():
                self._cleanup_local(base, ctx)
        for vid in vids:
            self._delete_originals(vol_urls[vid], vid)
        return (f"batch of {n} volumes {ctx} encoded in batched "
                f"launches ({ctx.device}) and distributed")


class EcRebuildHandler(JobHandler):
    """The repair twin of the encode handler: detect EC volumes with
    missing shards and start a streamed rebuild on the server holding
    the most survivors (command_ec_rebuild.go's Detect/Execute shape).
    That server reads the survivors it lacks in ranged windows off
    their holders and runs the codec on its own device; the worker
    moves no shard byte."""

    job_type = "ec_rebuild"

    def capability(self) -> dict:
        # repair outranks balance (30) and defers to encode (80)
        return {"jobType": self.job_type, "canDetect": True,
                "canExecute": True, "weight": 70}

    def descriptor(self) -> dict:
        return {"jobType": self.job_type, "fields": []}

    def detect(self, worker) -> list[dict]:
        from ...storage.erasure_coding.ec_context import TOTAL_SHARDS_COUNT
        from ...topology import iter_volume_list_ec_shards
        vl = master_json(worker.master, "GET", "/vol/list", timeout=30)
        per_vid: dict[int, set] = {}
        holders: dict[int, str] = {}
        for node, e in iter_volume_list_ec_shards(vl):
            sids = per_vid.setdefault(e["volumeId"], set())
            bits = int(e.get("shardBits", e.get("ecIndexBits", 0)))
            sids.update(i for i in range(32) if bits >> i & 1)
            holders.setdefault(e["volumeId"], node["url"])
        proposals = []
        for vid, present in sorted(per_vid.items()):
            if present == set(range(TOTAL_SHARDS_COUNT)):
                # a whole default stripe costs no probe: the healthy
                # steady state makes no extra round trip a cycle
                continue
            # a gap, or another scheme: one info probe decides
            r = http_json(
                "GET", f"{holders[vid]}/admin/ec/info?volumeId={vid}",
                timeout=30)
            if "error" in r:
                continue
            total = r["dataShards"] + r["parityShards"]
            missing = [s for s in range(total) if s not in present]
            if missing and len(present) >= r["dataShards"]:
                proposals.append({
                    "jobType": self.job_type,
                    "dedupeKey": f"ec_rebuild:{vid}",
                    "params": {"volumeId": vid,
                               "collection": r.get("collection", ""),
                               "missingShardIds": missing},
                })
        return proposals

    def execute(self, worker, job_id: str, params: dict) -> str:
        from ...shell.commands import _balance_ec_volume
        from ...topology import fetch_ec_shard_locations, shard_ids_to_urls
        from .balance import _LockedShellRun
        vid = int(params["volumeId"])
        collection = params.get("collection", "")
        locs = fetch_ec_shard_locations(worker.master, vid)
        if not locs:
            raise RuntimeError(f"ec volume {vid} has no shards")
        # the scheme from a shard holder, never a default 10+4
        info = None
        for url in locs:
            r = http_json("GET", f"{url}/admin/ec/info?volumeId={vid}",
                          timeout=30)
            if "error" not in r:
                info = r
                break
        if info is None:
            raise RuntimeError(f"ec volume {vid}: no reachable shards")
        collection = collection or info.get("collection", "")
        rebuilder = max(locs, key=lambda u: len(locs[u]))
        worker.report_progress(job_id, 0.1,
                               f"streaming rebuild on {rebuilder}")
        r = _must(http_json(
            "POST", f"{rebuilder}/admin/ec/rebuild",
            {"volumeId": vid, "collection": collection,
             "mode": "stream", "shardLocations": shard_ids_to_urls(locs),
             "dataShards": info["dataShards"],
             "parityShards": info["parityShards"]},
            timeout=600.0), f"rebuild on {rebuilder}")
        rebuilt = r.get("rebuiltShardIds", [])
        if rebuilt:
            _must(http_json("POST", f"{rebuilder}/admin/ec/mount",
                            {"volumeId": vid, "collection": collection,
                             "shardIds": rebuilt}, timeout=30),
                  f"mount rebuilt shards on {rebuilder}")
        worker.report_progress(job_id, 0.7, f"rebuilt {rebuilt}")
        # re-spread as the shell does: every rebuilt shard left on the
        # rebuilder would let one node's loss cost more than one shard.
        # Under the admin lease, so it cannot interleave with an
        # operator's balance over the same shard copies
        with _LockedShellRun(worker.master) as env:
            moved = _balance_ec_volume(
                env, vid, collection,
                info["dataShards"] + info["parityShards"])
        worker.report_progress(job_id, 0.9, f"rebalanced {moved} shards")
        tele = r.get("telemetry") or {}
        return (f"volume {vid}: rebuilt shards {rebuilt} on "
                f"{rebuilder}, rebalanced {moved} (streamed "
                f"{tele.get('bytesFetchedTotal', 0) >> 20}MB @ "
                f"{tele.get('volumeGbps', 0)} GB/s volume-rate)")


def _read_dat_version(base: str) -> int:
    from ...storage.super_block import SuperBlock
    with open(base + ".dat", "rb") as f:
        return SuperBlock.parse(f.read(8), require_extra=False).version


def _push_file(target: str, vid: int, collection: str, ext: str,
               path: str) -> None:
    """Streamed push (`http_upload`): a shard file goes from disk with
    bounded memory (shard_distribution.go:101, target side)."""
    status, body, _ = http_upload(
        "POST", f"{target}/admin/receive_file?volumeId={vid}"
        f"&collection={collection}&ext={ext}", path, timeout=600)
    if status != 200:
        raise RuntimeError(f"push {ext} to {target}: {status} "
                           f"{body[:200]!r}")
