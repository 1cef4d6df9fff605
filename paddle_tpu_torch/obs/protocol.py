"""The protocol witness — the port of ``paddle_tpu/obs/protocol.py``.

``ProtocolWitness`` observes the event journal (the same observer seam
the flight recorder uses — obs/__init__.py arms ``WITNESS`` at import)
and advances the machines declared in obs/catalog.py ``PROTOCOLS`` per
correlation key.  When a record breaks a machine's rules it journals
``protocol/violation`` carrying the offending chain — which trips the
flight recorder's auto-dump, so the bundle holding the evidence is on
disk before anyone asks.

Live violations (journaled the moment they happen):

- **orphan terminal** — a terminal with ``orphan_violates`` arrives
  for a key with no open machine: a second settle for a settled trace
  (exactly-once broken), a hop settle with no start.

Lazy violations (``finalize()``, on demand):

- **unterminated** — machines still open when asked.  A killed
  process legitimately never settles its hop, so open machines are
  only violations when the caller declares the world quiesced.

Scrape side: ``paddle_tpu_protocol_{tracked,completed,violations_total}``
per-protocol gauges ride a registry collector. ``obs.reset_all()``
resets the witness.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

from paddle_tpu_torch.obs.catalog import PROTOCOLS, Protocol

__all__ = ["ProtocolWitness", "WITNESS"]

_CHAIN_KEEP = 32          # offending-chain records kept per machine


class _Machine:
    __slots__ = ("protocol", "key", "chain", "starts")

    def __init__(self, protocol: str, key, rec_ref):
        self.protocol = protocol
        self.key = key
        self.chain: List[dict] = [rec_ref]
        self.starts = 1


def _ref(rec: dict) -> dict:
    """The compact record reference violations carry: enough to find
    the full record in the journal/flight bundle by seq."""
    out = {"domain": rec.get("domain"), "kind": rec.get("kind"),
           "seq": rec.get("seq")}
    for k in ("trace_id", "phase", "replica", "shard_id", "name"):
        if k in rec:
            out[k] = rec[k]
    return out


class ProtocolWitness:
    """Advance every declared protocol machine from the journal
    stream.  Thread-safe; never raises into the emit path (the
    journal's observer harness also guards, but violations are
    emitted OUTSIDE our lock to keep the journal's lock ordering)."""

    def __init__(self, protocols: Optional[Dict[str, Protocol]] = None):
        self._protocols = dict(protocols or PROTOCOLS)
        self._lock = threading.Lock()
        self._open: Dict[Tuple[str, object], _Machine] = {}
        self._completed: Dict[str, int] = {}
        self._superseded: Dict[str, int] = {}
        self._violations: List[dict] = []
        # (domain, kind) -> [(protocol, role, matcher-ish)] so one
        # journal record costs one dict lookup, not a protocol scan
        self._dispatch: Dict[Tuple[str, str], list] = {}
        for p in self._protocols.values():
            self._dispatch.setdefault(
                (p.start.domain, p.start.kind), []).append(
                    (p, "start", p.start))
            for m in p.intermediates:
                self._dispatch.setdefault(
                    (m.domain, m.kind), []).append((p, "inter", m))
            for t in p.terminals:
                self._dispatch.setdefault(
                    (t.match.domain, t.match.kind), []).append(
                        (p, "terminal", t))

    # ------------------------------------------------------------ observe
    def observe_journal(self, rec: dict) -> None:
        """Journal observer (obs/__init__.py wires it). Violations
        detected under the lock are journaled after it drops."""
        if rec.get("domain") == "protocol":
            return
        routes = self._dispatch.get((rec.get("domain"),
                                     rec.get("kind")))
        if not routes:
            return
        pending: List[dict] = []
        with self._lock:
            for proto, role, obj in routes:
                if role == "terminal":
                    if not obj.match.matches(rec):
                        continue
                    self._on_terminal(proto, obj, rec, pending)
                elif role == "start":
                    if not obj.matches(rec):
                        continue
                    self._on_start(proto, rec)
                else:
                    if not obj.matches(rec):
                        continue
                    mk = (proto.name, self._key_of(proto, rec))
                    m = self._open.get(mk)
                    if m is not None:
                        m.chain.append(_ref(rec))
                        del m.chain[:-_CHAIN_KEEP]
        for v in pending:
            self._journal_violation(v)

    @staticmethod
    def _key_of(proto: Protocol, rec: dict):
        return rec.get(proto.key) if proto.key else None

    def _on_start(self, proto: Protocol, rec: dict) -> None:
        mk = (proto.name, self._key_of(proto, rec))
        m = self._open.get(mk)
        if m is not None:
            if proto.on_restart == "extend":
                # a re-route after failover CONTINUES the same
                # request machine — same trace, next hop
                m.chain.append(_ref(rec))
                m.starts += 1
                del m.chain[:-_CHAIN_KEEP]
                return
            # a fresh start supersedes the stale instance (a failover
            # hop re-uses the trace_id; the dead hop's tear is the
            # fleet plane's story, not a protocol violation here)
            self._superseded[proto.name] = \
                self._superseded.get(proto.name, 0) + 1
        self._open[mk] = _Machine(proto.name, mk[1], _ref(rec))

    def _on_terminal(self, proto: Protocol, term, rec: dict,
                     pending: List[dict]) -> None:
        mk = (proto.name, self._key_of(proto, rec))
        m = self._open.pop(mk, None)
        if m is not None:
            m.chain.append(_ref(rec))
            self._completed[proto.name] = \
                self._completed.get(proto.name, 0) + 1
            return
        if term.orphan_violates:
            v = {"protocol": proto.name, "key": mk[1],
                 "reason": "orphan_terminal",
                 "chain": [_ref(rec)], "record": _ref(rec)}
            self._violations.append(v)
            pending.append(v)

    # ---------------------------------------------------------- violations
    def _journal_violation(self, v: dict) -> None:
        # local import: obs.events imports nothing from here, but the
        # witness is constructed at obs import time — stay lazy
        from paddle_tpu_torch.obs.events import emit as journal_emit
        journal_emit("protocol", "violation", protocol=v["protocol"],
                     key=v["key"], reason=v["reason"],
                     chain=v.get("chain"), record=v.get("record"))

    def finalize(self) -> List[dict]:
        """Close every still-open machine as ``unterminated`` and
        journal the violations.  For tests that have quiesced the
        world and expect every machine settled — NOT called per-test
        (open machines are legal: a SIGKILL'd replica never settles
        its hop)."""
        with self._lock:
            stragglers = list(self._open.values())
            self._open.clear()
            out = []
            for m in stragglers:
                v = {"protocol": m.protocol, "key": m.key,
                     "reason": "unterminated", "chain": list(m.chain),
                     "record": m.chain[-1] if m.chain else None}
                self._violations.append(v)
                out.append(v)
        for v in out:
            self._journal_violation(v)
        return out

    # -------------------------------------------------------------- state
    @property
    def violation_count(self) -> int:
        with self._lock:
            return len(self._violations)

    def violations(self) -> List[dict]:
        with self._lock:
            return list(self._violations)

    def open_machines(self) -> List[dict]:
        with self._lock:
            return [{"protocol": m.protocol, "key": m.key,
                     "chain": list(m.chain)}
                    for m in self._open.values()]

    def counts(self) -> dict:
        with self._lock:
            tracked: Dict[str, int] = {}
            for m in self._open.values():
                tracked[m.protocol] = tracked.get(m.protocol, 0) + 1
            return {"tracked": tracked,
                    "completed": dict(self._completed),
                    "superseded": dict(self._superseded),
                    "violations": len(self._violations)}

    def reset(self) -> None:
        with self._lock:
            self._open.clear()
            self._completed.clear()
            self._superseded.clear()
            del self._violations[:]


WITNESS = ProtocolWitness()


def _protocol_bridge():
    """Registry collector: per-protocol machine gauges, same pattern
    as obs/metrics.py's lockdep bridge."""
    from paddle_tpu_torch.obs.metrics import SampleFamily
    with WITNESS._lock:
        tracked: Dict[str, int] = {}
        for m in WITNESS._open.values():
            tracked[m.protocol] = tracked.get(m.protocol, 0) + 1
        completed = dict(WITNESS._completed)
        viol: Dict[str, int] = {}
        for v in WITNESS._violations:
            viol[v["protocol"]] = viol.get(v["protocol"], 0) + 1
    fams = []
    if tracked:
        fams.append(SampleFamily(
            "paddle_tpu_protocol_tracked", "gauge",
            "protocol machines currently open, per protocol",
            [("paddle_tpu_protocol_tracked", {"protocol": k},
              float(n)) for k, n in sorted(tracked.items())]))
    if completed:
        fams.append(SampleFamily(
            "paddle_tpu_protocol_completed", "gauge",
            "protocol machines closed by a terminal since reset",
            [("paddle_tpu_protocol_completed", {"protocol": k},
              float(n)) for k, n in sorted(completed.items())]))
    if viol:
        fams.append(SampleFamily(
            "paddle_tpu_protocol_violations_total", "counter",
            "protocol violations witnessed since reset",
            [("paddle_tpu_protocol_violations_total",
              {"protocol": k}, float(n))
             for k, n in sorted(viol.items())]))
    return fams


def _install_collector() -> None:
    from paddle_tpu_torch.obs.metrics import REGISTRY
    REGISTRY.register_collector(_protocol_bridge)
