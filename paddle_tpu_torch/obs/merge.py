"""Cross-process trace/journal merge — the port of
``paddle_tpu/obs/merge.py``: N per-process observability streams fused
into one timeline.

Every journal record carries ``run_id/host/pid`` (obs/events.py) and
every chrome-trace export carries ``metadata.{run_id,host,pid}``
(obs/trace.py), so a multi-process job — coordinator workers, a
trainer beside a server — leaves one journal + one trace per process.

- :func:`merge_journals` reads N JSONL journals, adjusts each file's
  timestamps by its clock offset, sorts, and assigns a MONOTONE merged
  sequence number ``mseq`` (original per-process ``seq``/``host``/
  ``pid`` preserved) — one queryable journal for the whole job.
- :func:`merge_traces` does the same for chrome-trace JSON exports,
  remapping colliding pids and labeling each process
  ``<host> pid=<pid>`` so Perfetto shows one timeline with a lane per
  host.

Clock skew: a worker that heartbeats a coordinator measures its offset
against the coordinator's clock (``trainer/coordinator.sync_clock``)
and journals it as a ``clock_sync`` record (``offset_s`` = local −
coordinator). The merge reads the LAST such record per journal and
subtracts it; ``--offset host=SECONDS`` overrides per host (or input
path) and beats the record.

CLI: ``python -m paddle_tpu_torch.cli trace merge --journal A B
--out-journal M``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence

from paddle_tpu_torch.obs.events import read_journal

__all__ = ["journal_clock_offset", "merge_journals", "merge_traces",
           "main"]


def journal_clock_offset(path: str) -> Optional[float]:
    """The LAST ``clock_sync`` record's ``offset_s`` in a journal
    (local − reference seconds), or None when the journal never
    synced."""
    off = None
    for rec in read_journal(path, strict=False, kind="clock_sync"):
        if isinstance(rec.get("offset_s"), (int, float)):
            off = float(rec["offset_s"])
    return off


def _resolve_offset(path: str, host: Optional[str],
                    offsets: Optional[Dict[str, float]],
                    synced: Optional[float]) -> float:
    """Per-stream offset resolution: explicit path key, then explicit
    host key, then the stream's own clock_sync record, else 0."""
    if offsets:
        if path in offsets:
            return float(offsets[path])
        if host is not None and host in offsets:
            return float(offsets[host])
    return synced if synced is not None else 0.0


def merge_journals(paths: Sequence[str],
                   offsets: Optional[Dict[str, float]] = None,
                   out: Optional[str] = None) -> List[dict]:
    """Fuse N journals into one list sorted by skew-adjusted time.
    Each record gains ``mseq`` (monotone across the merge, 1-based)
    and ``ts_adj`` (reference-clock seconds); ``seq``/``host``/``pid``
    stay as emitted. With ``out``, also writes the merged JSONL."""
    merged: List[dict] = []
    for path in paths:
        synced = journal_clock_offset(path)
        recs = list(read_journal(path, strict=False))
        for rec in recs:
            host = rec.get("host")
            off = _resolve_offset(path, host, offsets, synced)
            rec = dict(rec)
            rec["ts_adj"] = rec["ts"] - off
            rec.setdefault("host", os.path.basename(path))
            merged.append(rec)
    # stable sort on (adjusted time, host, per-process seq): ties keep
    # each process's own order
    merged.sort(key=lambda r: (r["ts_adj"], str(r.get("host")),
                               r["seq"]))
    for i, rec in enumerate(merged):
        rec["mseq"] = i + 1
    if out:
        with open(out, "w", encoding="utf-8") as f:
            for rec in merged:
                f.write(json.dumps(rec) + "\n")
    return merged


def merge_traces(paths: Sequence[str],
                 offsets: Optional[Dict[str, float]] = None,
                 out: Optional[str] = None) -> dict:
    """Fuse N chrome-trace JSON exports into one Perfetto-loadable
    trace: timestamps skew-adjusted onto the reference clock, pids
    remapped when two processes collide, one ``process_name`` metadata
    row per input (``<host> pid=<pid>``)."""
    events: List[dict] = []
    meta_rows: List[dict] = []
    seen_pids: Dict[int, str] = {}
    hosts: List[str] = []
    next_pid = 1
    for path in paths:
        with open(path, encoding="utf-8") as f:
            blob = json.load(f)
        meta = blob.get("metadata", {}) or {}
        host = meta.get("host") or os.path.basename(path)
        orig_pid = meta.get("pid")
        hosts.append(host)
        off = _resolve_offset(path, host, offsets, None)
        # one merged pid per input file; collisions (same pid on two
        # hosts, or pid-less exports) get a fresh lane
        stream_pids: Dict[object, int] = {}

        def lane(pid) -> int:
            nonlocal next_pid
            if pid not in stream_pids:
                cand = pid if isinstance(pid, int) else next_pid
                while cand in seen_pids:
                    cand = next_pid = next_pid + 1
                stream_pids[pid] = cand
                seen_pids[cand] = host
                meta_rows.append(
                    {"ph": "M", "name": "process_name", "pid": cand,
                     "tid": 0,
                     "args": {"name": f"{host} pid={pid}"}})
            return stream_pids[pid]

        for ev in blob.get("traceEvents", []):
            if ev.get("ph") == "M":
                continue                    # re-labeled per stream
            ev = dict(ev)
            ev["pid"] = lane(ev.get("pid", orig_pid))
            if isinstance(ev.get("ts"), (int, float)):
                ev["ts"] = ev["ts"] - off * 1e6
            args = dict(ev.get("args") or {})
            args.setdefault("host", host)
            ev["args"] = args
            events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    merged = {"traceEvents": meta_rows + events,
              "displayTimeUnit": "ms",
              "metadata": {"merged_from": list(paths),
                           "hosts": hosts}}
    if out:
        with open(out, "w", encoding="utf-8") as f:
            json.dump(merged, f)
    return merged


def _parse_offsets(pairs: Sequence[str]) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for p in pairs:
        key, _, val = p.partition("=")
        if not key or not val:
            raise SystemExit(f"--offset wants HOST=SECONDS, got {p!r}")
        out[key] = float(val)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="trace_merge",
        description="fuse per-host journals + chrome traces into one "
                    "timeline")
    ap.add_argument("--journal", nargs="*", default=[],
                    help="per-host journal JSONL files")
    ap.add_argument("--trace", nargs="*", default=[],
                    help="per-host chrome-trace JSON exports "
                         "(Tracer.save)")
    ap.add_argument("--out-journal", default=None,
                    help="merged journal JSONL output path")
    ap.add_argument("--out-trace", default=None,
                    help="merged Perfetto trace JSON output path")
    ap.add_argument("--offset", action="append", default=[],
                    metavar="HOST=SECONDS",
                    help="clock offset override (local - reference) "
                         "for a host or input path; defaults to each "
                         "journal's clock_sync record, else 0")
    args = ap.parse_args(argv)
    if not args.journal and not args.trace:
        ap.error("nothing to merge: pass --journal and/or --trace")
    offsets = _parse_offsets(args.offset)
    summary: Dict[str, object] = {"job": "trace_merge"}
    if args.journal:
        # journals' clock_sync offsets also cover their host's traces
        for path in args.journal:
            off = journal_clock_offset(path)
            if off is not None:
                for rec in read_journal(path, strict=False,
                                        kind="clock_sync"):
                    offsets.setdefault(str(rec.get("host")), off)
        merged = merge_journals(args.journal, offsets,
                                out=args.out_journal)
        summary["journals"] = len(args.journal)
        summary["records"] = len(merged)
        summary["hosts"] = sorted(
            {str(r.get("host")) for r in merged})
        if args.out_journal:
            summary["out_journal"] = args.out_journal
    if args.trace:
        mt = merge_traces(args.trace, offsets, out=args.out_trace)
        summary["traces"] = len(args.trace)
        summary["trace_events"] = len(mt["traceEvents"])
        if args.out_trace:
            summary["out_trace"] = args.out_trace
    print(json.dumps(summary))
    return 0
