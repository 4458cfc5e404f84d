"""Tiered KV state: a host LRU tier spilling to disk (the port's copy of
`deeplearning4j_tpu.serving.hibernate`).

`TieredStateStore` keeps the `SwapStore` surface (`put`/`take`/
`discard`/`clear`, `SwapEvictedError`, peak high-waters), so the LM
server's preemption plane uses it unchanged, but an entry pushed out of
the host tier spills to a disk tier instead of vanishing.  Idle sticky
sessions hibernate here (`serving/lm.py`), keyed by a digest of their
token prefix, so a fresh process over the same directory resumes them.
The blobs are `serving/transfer.py` frames, byte-compatible with the
JAX package's, so either package resumes the other's disk tier.

The disk tier writes every blob stage-then-rename (tmp file, flush and
fsync, rename, fsync the directory) and records it in a
``MANIFEST.json`` that carries its SHA-256, itself rewritten the same
way.  A kill at any byte leaves either the old manifest and an orphan
file (collected and counted on the next open) or the new manifest and
a whole blob.  `take` re-hashes the blob against the manifest, so a
torn, truncated, flipped or missing file is a `PageShipError` (and a
missing key a `SwapEvictedError`), which the server answers by
recomputing from the prompt.

Single-mutator like `SwapStore` and `PagePool`: the LM worker thread,
under the server's lock, owns every call.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

from deeplearning4j_tpu_torch.serving.pressure import SwapEvictedError
from deeplearning4j_tpu_torch.serving.transfer import PageShipError

MANIFEST_NAME = "MANIFEST.json"
_TMP_PREFIX = ".tmp-"
_SAFE_CHARS = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def prefix_key(tokens: Sequence[int]) -> str:
    """The stable hibernation key for a token prefix: a SHA-256 over
    the token ids.  Content-addressed on purpose — the key survives
    process restarts (resume opens a fresh manifest), and two sessions
    that converged to the same prefix share one blob."""
    h = hashlib.sha256()
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return "hib-" + h.hexdigest()[:40]


def _blob_name(key: str) -> str:
    """Key -> on-disk filename: keys are already filesystem-safe for
    everything this plane generates ("hib-<hex>", "swap-<n>"); anything
    else is content-addressed defensively."""
    if key and all(c in _SAFE_CHARS for c in key):
        return key + ".kvblob"
    return "k-" + hashlib.sha256(key.encode()).hexdigest()[:40] + ".kvblob"


class DiskTier:
    """The bottom tier: checksummed blob files + an atomic manifest.

    LRU over the manifest's insertion order, byte-capped like the host
    tier; eviction DELETES the oldest blob (there is nothing below disk
    to spill to — the victim's session recomputes from its prompt).
    `open()` reconciles directory against manifest: unreferenced blobs
    and stage files from a crashed predecessor are unlinked and
    counted, manifest entries whose file vanished are dropped.
    """

    def __init__(self, directory: str, capacity_bytes: int):
        if capacity_bytes < 1:
            raise ValueError(
                f"capacity_bytes must be >= 1, got {capacity_bytes}")
        self.dir = str(directory)
        self.capacity_bytes = int(capacity_bytes)
        # key -> {"file", "sha256", "bytes"}; insertion order is LRU age
        self._index: "collections.OrderedDict[str, Dict]" = (
            collections.OrderedDict())
        self.bytes_stored = 0
        self.peak_bytes = 0
        self.puts = 0
        self.takes = 0
        self.evicted = 0        # entries deleted to make room
        self.corrupt = 0        # failed sha256 / torn / missing file
        self.write_failed = 0   # ENOSPC & friends: blob dropped, typed
        self.gc_orphans = 0     # unreferenced blobs / stage files GC'd
        self.gc_stale = 0       # manifested entries GC'd by prefix
        self.open()

    # ---- manifest durability ---------------------------------------------

    def _fsync_dir(self) -> None:
        fd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def _write_atomic(self, final_path: str, data: bytes) -> None:
        """Stage -> fsync -> rename -> fsync dir: the only way bytes
        reach this tier."""
        tmp = os.path.join(
            self.dir, _TMP_PREFIX + os.path.basename(final_path))
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, final_path)
        self._fsync_dir()

    def _save_manifest(self) -> None:
        doc = {"version": 1,
               "entries": [dict(meta, key=key)
                           for key, meta in self._index.items()]}
        self._write_atomic(os.path.join(self.dir, MANIFEST_NAME),
                           json.dumps(doc).encode())

    def open(self) -> None:
        """(Re)load the manifest and reconcile it with the directory —
        the crash-recovery edge every restart walks."""
        os.makedirs(self.dir, exist_ok=True)
        self._index.clear()
        self.bytes_stored = 0
        path = os.path.join(self.dir, MANIFEST_NAME)
        entries: List[Dict] = []
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    doc = json.loads(f.read())
                entries = list(doc.get("entries", []))
            except (ValueError, OSError):
                # an unreadable manifest orphans every blob: they are
                # unlinked below and sessions recompute from prompt
                entries = []
        referenced = set()
        dirty = False
        for meta in entries:
            key = str(meta.get("key", ""))
            fname = str(meta.get("file", ""))
            fpath = os.path.join(self.dir, fname)
            if not key or not fname or not os.path.exists(fpath):
                self.gc_orphans += 1   # manifest points at nothing
                dirty = True
                continue
            referenced.add(fname)
            self._index[key] = {"file": fname,
                                "sha256": str(meta.get("sha256", "")),
                                "bytes": int(meta.get("bytes", 0))}
            self.bytes_stored += int(meta.get("bytes", 0))
        for fname in sorted(os.listdir(self.dir)):
            if fname == MANIFEST_NAME or fname in referenced:
                continue
            if fname.startswith(_TMP_PREFIX) or fname.endswith(".kvblob"):
                try:
                    os.unlink(os.path.join(self.dir, fname))
                    self.gc_orphans += 1
                except OSError:
                    pass  # best-effort GC of crash debris
        self.peak_bytes = max(self.peak_bytes, self.bytes_stored)
        if dirty:
            try:
                self._save_manifest()
            except OSError:
                pass  # next successful put rewrites it anyway

    # ---- the byte economy -------------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def keys(self) -> Iterable[str]:
        return self._index.keys()

    def _unlink_entry(self, key: str) -> None:
        meta = self._index.pop(key, None)
        if meta is None:
            return
        self.bytes_stored -= int(meta["bytes"])
        try:
            os.unlink(os.path.join(self.dir, meta["file"]))
        except OSError:
            pass  # already gone: manifest rewrite below is the truth

    def put(self, key: str, blob: bytes) -> Optional[List[str]]:
        """Persist `blob` under `key`.  Same contract as
        `SwapStore.put`: returns the keys evicted to make room, or None
        when the blob alone exceeds the cap (refused).  A failed write
        (ENOSPC and the like) drops THIS key — counted `write_failed`, the
        caller treats it as an eviction of exactly this entry."""
        size = len(blob)
        if size > self.capacity_bytes:
            return None
        evicted: List[str] = []
        if key in self._index:
            self._unlink_entry(key)
        while self.bytes_stored + size > self.capacity_bytes:
            old_key = next(iter(self._index))
            self._unlink_entry(old_key)
            self.evicted += 1
            evicted.append(old_key)
        fname = _blob_name(key)
        try:
            self._write_atomic(os.path.join(self.dir, fname), blob)
            self._index[key] = {
                "file": fname,
                "sha256": hashlib.sha256(blob).hexdigest(),
                "bytes": size}
            self.bytes_stored += size
            self._save_manifest()
        except OSError as e:
            # the blob (or the manifest naming it) never became durable:
            # forget the entry entirely and surface the key as lost
            self.write_failed += 1
            self._index.pop(key, None)
            self.bytes_stored = sum(int(m["bytes"])
                                    for m in self._index.values())
            evicted.append(key)
            try:
                self._save_manifest()
            except OSError:
                pass  # disk still failing; open() reconciles later
            del e
        else:
            self.puts += 1
            self.peak_bytes = max(self.peak_bytes, self.bytes_stored)
        return evicted

    def take(self, key: str) -> bytes:
        """Read, verify and remove the blob under `key`.
        `SwapEvictedError` when the key is not manifested;
        `PageShipError` when the manifested file is missing, torn,
        truncated or fails its SHA-256 — the integrity half of the
        recompute ladder."""
        meta = self._index.get(key)
        if meta is None:
            raise SwapEvictedError(
                f"hibernated state {key!r} is gone (evicted from the "
                f"{self.capacity_bytes}-byte disk tier)")
        fpath = os.path.join(self.dir, meta["file"])
        try:
            with open(fpath, "rb") as f:
                blob = f.read()
        except OSError as e:
            self.corrupt += 1
            self._drop_after_failure(key)
            raise PageShipError(
                f"hibernated blob {meta['file']!r} unreadable: {e}"
            ) from e
        if (len(blob) != int(meta["bytes"])
                or hashlib.sha256(blob).hexdigest() != meta["sha256"]):
            self.corrupt += 1
            self._drop_after_failure(key)
            raise PageShipError(
                f"hibernated blob {meta['file']!r} failed its integrity "
                f"check ({len(blob)} bytes vs manifest "
                f"{meta['bytes']}): torn or corrupt at rest")
        self._unlink_entry(key)
        self.takes += 1
        try:
            self._save_manifest()
        except OSError:
            pass  # blob already consumed; open() reconciles the index
        return blob

    def _drop_after_failure(self, key: str) -> None:
        self._unlink_entry(key)
        try:
            self._save_manifest()
        except OSError:
            pass  # disk is the thing failing; open() reconciles later

    def discard(self, key: str) -> None:
        if key in self._index:
            self._unlink_entry(key)
            try:
                self._save_manifest()
            except OSError:
                pass  # entry gone from the index either way

    def gc(self, prefix: str) -> int:
        """Drop every manifested entry whose key starts with `prefix`
        (a crashed predecessor's process-local swap keys, say) —
        counted separately from crash-debris GC."""
        victims = [k for k in self._index if k.startswith(prefix)]
        for k in victims:
            self._unlink_entry(k)
            self.gc_stale += 1
        if victims:
            try:
                self._save_manifest()
            except OSError:
                pass  # open() reconciles; files are already unlinked
        return len(victims)

    def clear(self) -> None:
        for k in list(self._index):
            self._unlink_entry(k)
        try:
            self._save_manifest()
        except OSError:
            pass  # directory emptied; manifest catches up on next put

    def stats(self) -> Dict:
        return {"entries": len(self._index),
                "bytes": self.bytes_stored,
                "capacity_bytes": self.capacity_bytes,
                "peak_bytes": self.peak_bytes,
                "puts": self.puts, "takes": self.takes,
                "evicted": self.evicted, "corrupt": self.corrupt,
                "write_failed": self.write_failed,
                "gc_orphans": self.gc_orphans,
                "gc_stale": self.gc_stale}


class TieredStateStore:
    """Host LRU tier spilling its oldest entries to a `DiskTier`.

    Drop-in for `SwapStore` on the preemption plane, PLUS the
    hibernation plane's durable bottom.  `put` lands in host memory;
    entries pushed past the host cap spill DOWN (newest-spills-oldest),
    and only what falls off the disk cap — or fails to become durable —
    is reported evicted.  `take` checks host then disk; a disk
    integrity failure propagates as `PageShipError`, a key missing from
    both tiers as `SwapEvictedError`.  Without a disk tier configured
    it degrades to exactly the `SwapStore` economy.
    """

    def __init__(self, host_bytes: int, disk_dir: Optional[str] = None,
                 disk_bytes: int = 1 << 30):
        if host_bytes < 1:
            raise ValueError(f"host_bytes must be >= 1, got {host_bytes}")
        self.capacity_bytes = int(host_bytes)   # SwapStore-compatible name
        self._blobs: "collections.OrderedDict[str, bytes]" = (
            collections.OrderedDict())
        self.bytes_stored = 0
        self.peak_bytes = 0
        self.puts = 0
        self.takes = 0
        self.evicted = 0
        self.rejected = 0
        self.spills = 0          # host -> disk demotions
        self.disk: Optional[DiskTier] = (
            DiskTier(disk_dir, disk_bytes) if disk_dir is not None
            else None)

    def __len__(self) -> int:
        return len(self._blobs) + (len(self.disk) if self.disk else 0)

    def __contains__(self, key: str) -> bool:
        return key in self._blobs or (self.disk is not None
                                      and key in self.disk)

    def _spill_or_evict(self, key: str, blob: bytes,
                        evicted: List[str]) -> None:
        if self.disk is None:
            self.evicted += 1
            evicted.append(key)
            return
        lost = self.disk.put(key, blob)
        self.spills += 1
        if lost is None:                 # larger than the whole disk cap
            self.evicted += 1
            evicted.append(key)
        else:
            for k in lost:
                self.evicted += 1
                evicted.append(k)

    def put(self, key: str, blob: bytes) -> Optional[List[str]]:
        """Store `blob` in the host tier, spilling the oldest host
        entries to disk to make room.  Returns keys evicted from the
        WHOLE hierarchy (the caller marks those lanes
        recompute-from-prompt), or None when the blob alone exceeds the
        host cap — same refusal contract as `SwapStore.put`, because a
        blob too big for host memory would only thrash the tiers."""
        size = len(blob)
        if size > self.capacity_bytes:
            self.rejected += 1
            return None
        evicted: List[str] = []
        if key in self._blobs:           # overwrite: drop the old bytes
            self.bytes_stored -= len(self._blobs.pop(key))
        elif self.disk is not None and key in self.disk:
            self.disk.discard(key)
        while self.bytes_stored + size > self.capacity_bytes:
            old_key, old = self._blobs.popitem(last=False)
            self.bytes_stored -= len(old)
            self._spill_or_evict(old_key, old, evicted)
        self._blobs[key] = blob
        self.bytes_stored += size
        self.peak_bytes = max(self.peak_bytes, self.bytes_stored)
        self.puts += 1
        return evicted

    def take(self, key: str) -> bytes:
        """Remove and return the freshest copy of `key`: host tier
        first, then disk (integrity-verified there).  Typed errors as
        documented on the class."""
        blob = self._blobs.pop(key, None)
        if blob is not None:
            self.bytes_stored -= len(blob)
            self.takes += 1
            return blob
        if self.disk is not None and key in self.disk:
            blob = self.disk.take(key)   # may raise PageShipError
            self.takes += 1
            return blob
        raise SwapEvictedError(
            f"swapped-out lane state {key!r} is gone (evicted from "
            f"the {self.capacity_bytes}-byte store)")

    def discard(self, key: str) -> None:
        blob = self._blobs.pop(key, None)
        if blob is not None:
            self.bytes_stored -= len(blob)
        elif self.disk is not None:
            self.disk.discard(key)

    def gc(self, prefix: str) -> int:
        """Drop entries by key prefix across both tiers (stale
        process-local keys a restart can never resume)."""
        n = 0
        for k in [k for k in self._blobs if k.startswith(prefix)]:
            self.bytes_stored -= len(self._blobs.pop(k))
            n += 1
        if self.disk is not None:
            n += self.disk.gc(prefix)
        return n

    def flush_to_disk(self) -> int:
        """Demote every host-tier entry to disk (the stop path).
        Entries that fall off the disk cap are gone, counted evicted."""
        n = 0
        while self._blobs:
            key, blob = self._blobs.popitem(last=False)
            self.bytes_stored -= len(blob)
            self._spill_or_evict(key, blob, [])
            n += 1
        return n

    def clear(self, prefix: Optional[str] = None) -> None:
        """Drop host entries (all, or by key prefix).  The DISK tier is
        deliberately left alone unless explicitly asked: hibernated
        prefixes stay valid across a pool reset — KV is a deterministic
        function of tokens — so a device-side failure must not torch
        the durable tier."""
        if prefix is None:
            self._blobs.clear()
            self.bytes_stored = 0
        else:
            for k in [k for k in self._blobs if k.startswith(prefix)]:
                self.bytes_stored -= len(self._blobs.pop(k))
            if self.disk is not None:
                self.disk.gc(prefix)

    def stats(self) -> Dict:
        out = {"entries": len(self._blobs),
               "bytes": self.bytes_stored,
               "capacity_bytes": self.capacity_bytes,
               "peak_bytes": self.peak_bytes,
               "puts": self.puts, "takes": self.takes,
               "evicted": self.evicted, "rejected": self.rejected,
               "spills": self.spills}
        if self.disk is not None:
            out["disk"] = self.disk.stats()
        return out


__all__ = [
    "DiskTier",
    "MANIFEST_NAME",
    "TieredStateStore",
    "prefix_key",
]
