"""Persistent content-addressed artifact store.

The disk tier under :class:`~repro_torch.core.translator.TranslationCache` and
:class:`~repro_torch.core.simcache.SimCache`: finished translations and
simulator measurements spill here and survive process restarts, so a tuned
kernel is served byte-identically across daemon restarts with **zero**
pipeline passes re-run (ROADMAP: "a hot kernel should be served from cache
in microseconds cluster-wide, not re-tuned per process").

Design constraints, in order:

1. **Never serve wrong bytes.**  Every entry carries CRC32s over its
   metadata and payload plus explicit lengths; a read validates all of
   them (and that the stored key matches the requested key — a filename
   hash collision must never alias entries) before returning anything.
   Anything that fails validation is *quarantined* — moved aside into
   ``quarantine/`` for post-mortem, never deleted silently, never served —
   and reported as a miss, so the caller recomputes.
2. **Crash-safe writes.**  Entries are written with the shared atomic
   recipe (:func:`repro_torch.util.write_bytes_atomic`: same-dir tmp + fsync +
   rename), so a crash mid-write leaves either no entry or a stale
   ``*.tmp`` that :meth:`ArtifactStore.recover` sweeps on open.  Torn
   writes that reach the final file anyway (lying hardware) are caught by
   check 1 on the next read.
3. **Bounded.**  ``max_entries`` caps the object count with LRU eviction —
   reads refresh an entry's mtime, eviction removes the stalest
   ``(mtime, name)`` first, deterministically.

Layout under ``root``::

    objects/<2-hex shard>/<sha256 of key>.art     one file per entry
    quarantine/<original name>.<reason>           corrupt entries, kept

Entry file format (little-endian)::

    magic "RDART\\x01" | u16 format version | u32 meta len | u32 payload len
    | u32 meta crc | u32 payload crc | meta (JSON, utf-8) | payload

The JSON meta always contains the full ``key`` string (collision guard)
plus whatever the caller stored.  Fault injection (:mod:`repro_torch.testing.
faults`) hooks the write path (torn/tmp writes) and the read path (bit
flips) — the chaos suite drives those to prove property 1 holds.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.testing import faults as _faults
from repro_torch.util import sweep_tmp_files, write_bytes_atomic

MAGIC = b"RDART\x01"
#: bump when the entry layout (or the pickled payload conventions of a
#: consumer) changes incompatibly; mismatched entries are quarantined
STORE_VERSION = 1

_HDR = struct.Struct("<6sHIIII")  # magic, version, meta_len, payload_len,
#                                   meta_crc, payload_crc


class ArtifactStore:
    """Content-addressed, corruption-safe, LRU-bounded on-disk store.

    Keys are arbitrary strings (callers build them from kernel content CRC
    + translation/simulation parameters + arch).  Values are opaque payload
    bytes plus a small JSON-able metadata dict.
    """

    def __init__(self, root: str, max_entries: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.objects_dir = os.path.join(self.root, "objects")
        self.quarantine_dir = os.path.join(self.root, "quarantine")
        self.max_entries = max_entries
        os.makedirs(self.objects_dir, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0
        self.puts = 0
        self.evictions = 0
        self.quarantined = 0
        #: stale tmp files of interrupted writes removed on open
        self.recovered = self.recover()

    # -- pathing ---------------------------------------------------------------

    @staticmethod
    def _digest(key: str) -> str:
        return hashlib.sha256(key.encode("utf-8")).hexdigest()

    def _path(self, key: str) -> str:
        d = self._digest(key)
        return os.path.join(self.objects_dir, d[:2], d + ".art")

    # -- recovery & quarantine -------------------------------------------------

    def recover(self) -> int:
        """Sweep stale ``*.tmp`` leftovers of interrupted atomic writes
        (the crash-mid-write self-heal).  Returns the number removed."""
        removed = len(sweep_tmp_files(self.objects_dir))
        try:
            shards = os.listdir(self.objects_dir)
        except OSError:
            return removed
        for shard in shards:
            removed += len(sweep_tmp_files(os.path.join(self.objects_dir, shard)))
        return removed

    def _quarantine(self, path: str, reason: str) -> None:
        """Move a bad entry aside — kept for post-mortem, never served."""
        self.quarantined += 1
        if obs.enabled():
            obs.metrics().counter("artifact_store.quarantined").inc()
        dest = os.path.join(
            self.quarantine_dir, f"{os.path.basename(path)}.{reason}"
        )
        try:
            os.replace(path, dest)
        except OSError:
            # last resort: a bad entry we cannot move must not keep being
            # re-read as if it were data
            try:
                os.unlink(path)
            except OSError:
                pass

    # -- write -----------------------------------------------------------------

    def put(self, key: str, payload: bytes, meta: Optional[dict] = None) -> bool:
        """Persist one entry (overwriting any previous value for ``key``).

        Returns ``True`` on success.  Injected write faults surface the way
        a real crash would: a ``store.tmp`` fault leaves a stale tmp file
        and no entry (returns ``False``); a ``store.torn`` fault leaves a
        truncated final file for the read path to catch and quarantine.
        """
        full_meta = dict(meta or {})
        full_meta["key"] = key
        meta_bytes = json.dumps(full_meta, sort_keys=True).encode("utf-8")
        blob = (
            _HDR.pack(
                MAGIC,
                STORE_VERSION,
                len(meta_bytes),
                len(payload),
                zlib.crc32(meta_bytes) & 0xFFFFFFFF,
                zlib.crc32(payload) & 0xFFFFFFFF,
            )
            + meta_bytes
            + payload
        )
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)

        inj = _faults.active()
        if inj is not None and inj.fire("store.tmp", key):
            # simulate dying before the rename: partial tmp file, no entry
            with open(path + ".crash.tmp", "wb") as fh:
                fh.write(blob[: inj.torn_length(len(blob), key)])
            return False
        if inj is not None and inj.fire("store.torn", key):
            # simulate a torn write reaching the final file (fsync lied)
            with open(path, "wb") as fh:
                fh.write(blob[: inj.torn_length(len(blob), key)])
            self.puts += 1
            self._evict()
            return True

        write_bytes_atomic(path, blob)
        self.puts += 1
        if obs.enabled():
            obs.metrics().counter("artifact_store.puts").inc()
        self._evict()
        return True

    # -- read ------------------------------------------------------------------

    def get(self, key: str) -> Optional[Tuple[bytes, dict]]:
        """Return ``(payload, meta)`` for ``key``, or ``None``.

        Every failure mode — missing, truncated, bit-flipped, version
        mismatch, key collision — is a miss; corrupt files are quarantined
        on the way.  A served payload always re-verified its CRC in this
        call (degraded or byte-identical, never corrupt).
        """
        path = self._path(key)
        try:
            with open(path, "rb") as fh:
                blob = fh.read()
        except OSError:
            self.misses += 1
            if obs.enabled():
                obs.metrics().counter("artifact_store.misses").inc()
            return None

        inj = _faults.active()
        if inj is not None and inj.fire("store.flip", key):
            blob = inj.flip_bit(blob, key=key)

        entry = self._validate(blob, key)
        if entry is None:
            self._quarantine(path, "corrupt")
            self.misses += 1
            if obs.enabled():
                obs.metrics().counter("artifact_store.misses").inc()
            return None
        self.hits += 1
        if obs.enabled():
            obs.metrics().counter("artifact_store.hits").inc()
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return entry

    @staticmethod
    def _validate(blob: bytes, key: str) -> Optional[Tuple[bytes, dict]]:
        """Full structural + integrity validation of one entry file."""
        if len(blob) < _HDR.size:
            return None
        magic, version, meta_len, payload_len, meta_crc, payload_crc = _HDR.unpack(
            blob[: _HDR.size]
        )
        if magic != MAGIC or version != STORE_VERSION:
            return None
        if len(blob) != _HDR.size + meta_len + payload_len:
            return None
        meta_bytes = blob[_HDR.size : _HDR.size + meta_len]
        payload = blob[_HDR.size + meta_len :]
        if zlib.crc32(meta_bytes) & 0xFFFFFFFF != meta_crc:
            return None
        if zlib.crc32(payload) & 0xFFFFFFFF != payload_crc:
            return None
        try:
            meta = json.loads(meta_bytes.decode("utf-8"))
        except (UnicodeDecodeError, json.JSONDecodeError):
            return None
        if not isinstance(meta, dict) or meta.get("key") != key:
            return None  # filename-hash collision guard
        return payload, meta

    # -- bounds ----------------------------------------------------------------

    def _entries(self) -> List[str]:
        out: List[str] = []
        try:
            shards = os.listdir(self.objects_dir)
        except OSError:
            return out
        for shard in sorted(shards):
            sdir = os.path.join(self.objects_dir, shard)
            if not os.path.isdir(sdir):
                continue
            for name in sorted(os.listdir(sdir)):
                if name.endswith(".art"):
                    out.append(os.path.join(sdir, name))
        return out

    def __len__(self) -> int:
        return len(self._entries())

    def _evict(self) -> None:
        """LRU-evict down to ``max_entries`` (stalest ``(mtime, name)``
        first — deterministic under equal timestamps)."""
        if self.max_entries is None:
            return
        entries = self._entries()
        excess = len(entries) - self.max_entries
        if excess <= 0:
            return

        def age(path: str) -> tuple:
            try:
                return (os.path.getmtime(path), os.path.basename(path))
            except OSError:
                return (0.0, os.path.basename(path))

        for path in sorted(entries, key=age)[:excess]:
            try:
                os.unlink(path)
                self.evictions += 1
                if obs.enabled():
                    obs.metrics().counter("artifact_store.evictions").inc()
            except OSError:
                pass

    # -- telemetry -------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        return {
            "root": self.root,
            "entries": len(self),
            "capacity": self.max_entries,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(
                obs.hit_rate(self.hits, self.misses, default=0.0), 3
            ),
            "puts": self.puts,
            "evictions": self.evictions,
            "quarantined": self.quarantined,
            "recovered_tmp": self.recovered,
        }
