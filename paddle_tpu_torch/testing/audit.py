"""Exactly-once audits over the structured event journal — the port of
``paddle_tpu/testing/audit.py``.

- :func:`audit_exactly_once` — the NON-RAISING core: count settles
  per trace_id across one or many journals and report duplicates /
  losses / strays as data.
- :func:`assert_exactly_once` — the pytest-facing wrapper that turns
  the same dict into one readable assertion failure.

``journals`` is polymorphic: a journal path, a list of paths (merged
through obs/merge.py so cross-process ordering holds), or an
already-merged/parsed list of record dicts.

:func:`assert_exactly_once_applied` checks per-shard ``applied_seqs()``
ledgers against an expected map (a ledger-based exactly-once, for a
sharded parameter service).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Union

__all__ = ["audit_exactly_once", "assert_exactly_once",
           "assert_exactly_once_applied"]

Journals = Union[str, Sequence[str], Sequence[dict]]


def _load_records(journals: Journals) -> List[dict]:
    """Normalize the polymorphic ``journals`` argument to a record
    list. Multiple paths go through ``merge_journals`` so the records
    carry ``mseq`` and a cross-process total order; raw record lists
    pass through untouched (the caller already merged)."""
    if isinstance(journals, str):
        journals = [journals]
    journals = list(journals)
    if not journals:
        return []
    if isinstance(journals[0], dict):
        return journals                      # already parsed/merged
    from paddle_tpu_torch.obs.merge import merge_journals
    if len(journals) == 1:
        # single journal: plain read (no clock adjustment to do), but
        # tolerate a torn final line the same way read_journal does
        recs = []
        with open(journals[0], encoding="utf-8") as fh:
            lines = fh.read().splitlines()
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                recs.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break                    # torn final line
                raise
        return recs
    return merge_journals([os.fspath(p) for p in journals])


def audit_exactly_once(journals: Journals,
                       expected_traces: Iterable[str],
                       domain: str = "fleet",
                       kind: str = "settle") -> dict:
    """Audit that every expected trace settled EXACTLY once.

    Returns a report dict (never raises):

    - ``ok``          True iff zero duplicates and zero losses
    - ``expected``    number of expected trace_ids
    - ``settled``     distinct trace_ids with >= 1 settle record
    - ``duplicates``  {trace_id: settle_count} for counts > 1
    - ``lost``        expected trace_ids with NO settle record
    - ``strays``      settled trace_ids outside the expected set
                      (informational: a prime/control request is
                      legitimate — strays do NOT fail the audit)
    """
    expected = {str(t) for t in expected_traces}
    counts: Dict[str, int] = {}
    for rec in _load_records(journals):
        if rec.get("domain") != domain or rec.get("kind") != kind:
            continue
        tid = rec.get("trace_id")
        if tid is None:
            continue
        counts[str(tid)] = counts.get(str(tid), 0) + 1
    dups = {t: n for t, n in counts.items() if n > 1}
    lost = sorted(expected - set(counts))
    strays = sorted(set(counts) - expected)
    return {"ok": not dups and not lost,
            "domain": domain, "kind": kind,
            "expected": len(expected),
            "settled": len(counts),
            "duplicates": dups,
            "lost": lost,
            "strays": strays}


def assert_exactly_once(journals: Journals,
                        expected_traces: Iterable[str],
                        domain: str = "fleet",
                        kind: str = "settle") -> dict:
    """Raise AssertionError unless every expected trace settled
    exactly once; returns the :func:`audit_exactly_once` report so a
    test can keep asserting on strays/counts."""
    report = audit_exactly_once(journals, expected_traces,
                                domain=domain, kind=kind)
    assert report["ok"], (
        f"exactly-once violated for {domain}/{kind}: "
        f"{len(report['duplicates'])} duplicated trace(s) "
        f"{report['duplicates']!r}, {len(report['lost'])} lost "
        f"trace(s) {report['lost']!r} "
        f"(expected {report['expected']}, settled {report['settled']})")
    return report


def assert_exactly_once_applied(
        shards, expected_seqs: Dict[int, dict],
        dup_acks: Optional[int] = None,
        min_dup_acks: int = 0) -> None:
    """The embedding plane's exactly-once: each shard's applied-seq
    ledger must equal the reference run's — a retried seq that
    re-applied would show a doubled high-water mark, a lost WAL replay
    a missing one. ``shards`` maps shard_id -> object with
    ``applied_seqs()`` (EmbeddingShard), or is an EmbedService (its
    ``.shard(sid)`` accessor is used). With ``dup_acks`` given, also
    require at least ``min_dup_acks`` deduped retries — the proof the
    torn window was actually exercised, not skipped."""
    for sid, want in expected_seqs.items():
        shard = shards.shard(sid) if hasattr(shards, "shard") \
            else shards[sid]
        got = shard.applied_seqs()
        assert got == want, (
            f"shard {sid} applied-seq ledger diverged from the "
            f"uninterrupted reference: got {got!r}, want {want!r} — "
            "a retry re-applied (doubled) or a WAL replay was lost")
    if dup_acks is not None:
        assert dup_acks >= min_dup_acks, (
            f"expected >= {min_dup_acks} deduped same-seq retr"
            f"{'y' if min_dup_acks == 1 else 'ies'} (dup_acks), got "
            f"{dup_acks} — the torn-window retry path never ran")
