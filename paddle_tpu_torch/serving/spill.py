"""Host-RAM spill tier for cold KV pages — the second tier of the
two-tier KV plane; the port of ``paddle_tpu/serving/spill.py``
(host-only logic, copied; a plain ``threading.Lock`` in place of the
reference's instrumented lock).

Under pool pressure the engine reads cold refcount-1 prefix pages back
to host RAM (``PagedDecoder.read_page``) instead of freeing them, keyed
by their full token path from the trie root; a later prefix match that
walks the same path RESTORES the page into a freshly allocated device
page before prefill is charged (``DecodeEngine._restore_spilled``) —
capacity degrades to a host round-trip, never to a recompute.

Crash-safety is an ORDERING contract, enforced by the engine, not by
this store:

1. read the device page to host and checksum it (no state changed);
2. evict the trie node + free the device page (a crash here loses
   cache contents, never accounting);
3. ``put()`` the complete, checksummed entry (the commit point).

There is no reachable state where a page is BOTH device-owned and
host-stored. Torn writes (corruption INSIDE a committed payload) are
caught at restore time by the per-entry CRC: the entry is dropped and
the lookup degrades to a prefix miss — a torn page is never restored.

The store is capacity-bounded (in pages) with LRU eviction among
entries; its lock guards all state (the engine mutates from its
stepping thread, stats() reads from anywhere). Lock order: engine ->
prefix -> spill store, never the reverse.
"""

from __future__ import annotations

import threading
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np

__all__ = ["SpillStore", "SpillEntry", "entry_checksum"]


def entry_checksum(payload: Dict[str, np.ndarray]) -> int:
    """CRC32 over every leaf's raw bytes, keyed in sorted order — the
    integrity witness a restore re-derives before trusting an entry."""
    crc = 0
    for name in sorted(payload):
        arr = payload[name]
        crc = zlib.crc32(name.encode(), crc)
        crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
    return crc


class SpillEntry:
    """One spilled page: the host copies of its pool leaves (flattened
    ``{leaf-name: np.ndarray}``) plus the CRC computed BEFORE the
    device page was freed. ``verify()`` re-derives the CRC — False
    means a torn write or corruption and the entry must be dropped."""

    __slots__ = ("payload", "crc", "nbytes")

    def __init__(self, payload: Dict[str, np.ndarray],
                 crc: Optional[int] = None):
        self.payload = payload
        self.crc = entry_checksum(payload) if crc is None else int(crc)
        self.nbytes = int(sum(a.nbytes for a in payload.values()))

    def verify(self) -> bool:
        try:
            return entry_checksum(self.payload) == self.crc
        # a payload mangled past hashing (a leaf that is no longer an
        # array) is as untrustworthy as one that hashes wrong
        except Exception:  # noqa: BLE001
            return False


class SpillStore:
    """LRU host-RAM store of spilled KV pages, keyed by the page's
    full token path (a tuple of ints — the trie path that produced
    it). Capacity is in PAGES; ``put`` beyond capacity drops the
    least-recently-touched entries (counted: host eviction is
    lossy-cache behavior, not a fault)."""

    def __init__(self, capacity_pages: int):
        if capacity_pages < 1:
            raise ValueError(f"spill capacity must be >= 1 page, got "
                             f"{capacity_pages}")
        self.capacity = int(capacity_pages)
        self._lock = threading.Lock()
        # token path -> SpillEntry, LRU order (oldest first)
        self._entries: "OrderedDict[tuple, SpillEntry]" = OrderedDict()
        self.put_count = 0
        self.restored_count = 0
        self.evicted_lru = 0
        self.dropped_integrity = 0
        # a put whose key was still resident: the fresh copy replaces
        # the stale one, which leaves the store uncounted otherwise (a
        # revisit recomputes the page holding its last prompt token, so
        # the trie can spill one path twice)
        self.superseded = 0
        self.high_water = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def bytes_used(self) -> int:
        with self._lock:
            return sum(e.nbytes for e in self._entries.values())

    def has(self, key: tuple) -> bool:
        with self._lock:
            return tuple(key) in self._entries

    def put(self, key: tuple, entry: SpillEntry) -> List[tuple]:
        """Commit one spilled page (the LAST step of the spill
        ordering contract). Returns the keys LRU-dropped to stay
        within capacity."""
        key = tuple(key)
        dropped: List[tuple] = []
        with self._lock:
            if key in self._entries:
                del self._entries[key]
                self.superseded += 1
            self._entries[key] = entry
            self.put_count += 1
            self.high_water = max(self.high_water, len(self._entries))
            while len(self._entries) > self.capacity:
                old, _ = self._entries.popitem(last=False)
                self.evicted_lru += 1
                dropped.append(old)
        return dropped

    def pop(self, key: tuple) -> Optional[SpillEntry]:
        """Remove and return the entry for ``key`` (restore takes
        ownership — a failed restore must NOT re-insert a possibly
        torn entry)."""
        with self._lock:
            return self._entries.pop(tuple(key), None)

    def touch(self, key: tuple) -> None:
        with self._lock:
            key = tuple(key)
            if key in self._entries:
                self._entries.move_to_end(key)

    def clear(self) -> int:
        """Drop everything — the engine's step-failure recovery path,
        where the trie the keys were carved from no longer exists
        (never resurrect across a rebuild). Returns the drop count."""
        with self._lock:
            n = len(self._entries)
            self._entries.clear()
            return n

    def accounting(self) -> dict:
        with self._lock:
            return {"spilled": len(self._entries),
                    "spill_capacity": self.capacity,
                    "spill_bytes": sum(e.nbytes
                                       for e in self._entries.values()),
                    "spill_puts": self.put_count,
                    "spill_restores": self.restored_count,
                    "spill_evicted_lru": self.evicted_lru,
                    "spill_dropped_integrity": self.dropped_integrity,
                    "spill_superseded": self.superseded,
                    "spill_high_water": self.high_water}

    def corrupt_one(self, mode: str = "bitflip",
                    rng=None) -> Optional[tuple]:
        """Test hook: corrupt one stored entry in place (``"bitflip"``:
        one byte flipped; ``"truncate"``: the tail zeroed) WITHOUT
        touching its recorded CRC — the restore path must catch it.
        Returns the corrupted key, or None if the store is empty."""
        import random as _random
        rng = rng or _random
        with self._lock:
            if not self._entries:
                return None
            key = rng.choice(list(self._entries))
            entry = self._entries[key]
            name = sorted(entry.payload)[0]
            arr = np.array(entry.payload[name], copy=True)
            if mode == "truncate":
                flat = arr.reshape(-1)
                flat[flat.size // 2:] = 0
            else:
                bb = arr.view(np.uint8).reshape(-1)
                bb[rng.randrange(bb.size)] ^= 0x40
            entry.payload[name] = arr
            if entry.verify():
                # the mutation was a no-op (an all-zero page under
                # truncation): force a delta so the integrity path fires
                bb = arr.view(np.uint8).reshape(-1)
                bb[0] ^= 0xFF
            return key
