"""One task's on-disk store, a ``data`` file plus ``metadata.json``: the
port's copy of ``dragonfly2_tpu/storage/local_store.py``.

Piece ``n`` lives at byte offset ``n * piece_size`` in ``data``;
unknown-length downloads extend the file as pieces arrive in order. The
directory layout and ``metadata.json`` are the JAX package's, key for key,
so a store either package wrote loads in the other.

Where the JAX store asks its optional native library, the port's calls
its own host library (``pkg/dfhost.py``) and nothing else: CRC-32C is
fused into the piece write, re-verification hashes pieces on native
threads, and there is no Python fallback. A completed task lands at an
output path by hardlink, else by ``shutil.copyfile``.

Read buffers: ``read_range`` hands out views of pooled buffers
(``acquire_read_buffer``); only a buffer handed back with
``release_read_buffer`` is ever reused, so a view a caller still holds is
never recycled under it. ``read_piece`` returns fresh ``bytes`` (the
device sink keeps them until its batch flushes).

Certification, as in the JAX store: each write remembers the digest a
piece was checked AGAINST (a parent's advertised one); a done parent's
digest map that every piece matches (``apply_certification``) lets the
completion skip its whole-content re-hash
(``pieces_all_digest_verified``). The native-transport commit
(``record_piece``) waits for the native piece fetch.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from dataclasses import asdict, dataclass, field
from itertools import accumulate

from dragonfly2_tpu_torch.pkg import dfhost
from dragonfly2_tpu_torch.pkg import digest as pkgdigest
from dragonfly2_tpu_torch.pkg.bufpool import BufferPool
from dragonfly2_tpu_torch.pkg.errors import Code, StorageError
from dragonfly2_tpu_torch.pkg.piece import compute_piece_count
from dragonfly2_tpu_torch.storage import io_ring

DATA_FILE = "data"
METADATA_FILE = "metadata.json"

_READ_BUFFERS = BufferPool(name="storage_read")


def acquire_read_buffer(size: int) -> memoryview:
    return _READ_BUFFERS.acquire(size)


def release_read_buffer(view) -> None:
    _READ_BUFFERS.release(view)


def read_buffer_stats() -> dict:
    return _READ_BUFFERS.stats()


def _mismatch(num: int, want, got) -> StorageError:
    return StorageError(f"piece {num} digest mismatch: want {want}, got {got}",
                        Code.ClientPieceDownloadFail)


@dataclass
class PieceRecord:
    num: int
    offset: int
    size: int
    digest: str = ""      # "crc32c:..." per-piece digest
    cost_ms: int = 0

    def to_wire(self) -> dict:
        return asdict(self)

    @classmethod
    def from_wire(cls, d: dict) -> "PieceRecord":
        return cls(num=d["num"], offset=d["offset"], size=d["size"],
                   digest=d.get("digest", ""), cost_ms=d.get("cost_ms", 0))


@dataclass
class TaskStoreMetadata:
    task_id: str
    peer_id: str = ""
    url: str = ""
    tag: str = ""
    application: str = ""
    content_length: int = -1
    piece_size: int = 0
    total_piece_count: int = -1
    digest: str = ""                  # whole-content digest once verified
    header: dict = field(default_factory=dict)
    done: bool = False
    invalid: bool = False
    pieces: dict[int, PieceRecord] = field(default_factory=dict)
    created_at: float = field(default_factory=time.time)
    last_access: float = field(default_factory=time.time)

    def to_json(self) -> dict:
        d = asdict(self)
        d["pieces"] = {str(k): v.to_wire() for k, v in self.pieces.items()}
        return d

    @classmethod
    def from_json(cls, d: dict) -> "TaskStoreMetadata":
        pieces = {int(k): PieceRecord.from_wire(v)
                  for k, v in d.get("pieces", {}).items()}
        return cls(
            task_id=d["task_id"],
            peer_id=d.get("peer_id", ""),
            url=d.get("url", ""),
            tag=d.get("tag", ""),
            application=d.get("application", ""),
            content_length=d.get("content_length", -1),
            piece_size=d.get("piece_size", 0),
            total_piece_count=d.get("total_piece_count", -1),
            digest=d.get("digest", ""),
            header=d.get("header", {}) or {},
            done=d.get("done", False),
            invalid=d.get("invalid", False),
            pieces=pieces,
            created_at=d.get("created_at", time.time()),
            last_access=d.get("last_access", time.time()),
        )


class _PrefixHasher:
    """Background contiguous-prefix hasher: overlaps the completion-time
    whole-content digest with the download itself.

    Started only for back-to-source transfers with a known full-content
    digest (their piece digests are self-computed, so the completion
    re-hash is certain): hashing committed pieces in piece order WHILE
    later pieces stream turns that serial tail into overlap.

    Owns a private O_RDONLY fd. Only committed pieces are read. Any anomaly
    (a piece re-recorded below the frontier, a short read, an fd error)
    poisons the hasher; ``finish`` then returns None and the caller runs
    the full re-hash, so this can only be bypassed, never be wrong.

    Zero-copy feed: a committing writer that still holds the piece's bytes
    hands them to ``feed`` right after the commit, and the frontier
    advances without re-reading landed bytes from disk. The background
    thread preads only pieces that never came through memory (out-of-order
    arrivals)."""

    def __init__(self, store: "LocalTaskStore", algorithm: str):
        self.store = store
        self.algorithm = algorithm
        self._h = pkgdigest.new_hasher(algorithm)
        self._next = 0
        self._err: str | None = None
        self._cv = threading.Condition()
        self._stop = False
        # Frontier claim: one hasher (a feed() caller or the background
        # thread) advances _next at a time.
        self._busy = False
        # A commit that will be followed by a feed of the frontier piece
        # reserves it, so the background thread does not pread it first
        # (stamped: a feed that never arrives only stalls us briefly).
        self._reserved: int | None = None
        self._reserved_at = 0.0
        self.disk_reads = 0   # pieces the background thread pread
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"df-prefix-hash-{store.metadata.task_id[:12]}")
        self._thread.start()

    # Called from _commit_piece_record under the store's _meta_lock (lock
    # order store._meta_lock -> self._cv; _run never takes _meta_lock).
    def piece_recorded(self, num: int, replaced: bool,
                       will_feed: bool = False) -> None:
        with self._cv:
            # <=, not <: _next is also the piece being hashed outside the
            # lock, and a re-record there would hash a torn mix.
            if replaced and num <= self._next:
                self._err = f"piece {num} re-recorded at/behind the frontier"
                self._stop = True
            if (will_feed and not self._stop and not self._busy
                    and num == self._next):
                self._reserved = num
                self._reserved_at = time.monotonic()
                return   # the imminent feed() advances instead
            self._cv.notify()

    def feed(self, num: int, chunks) -> None:
        """Advance the frontier with in-memory bytes (one buffer or a list
        of buffers, in order), after ``piece_recorded``, outside the
        store's _meta_lock, while the caller still owns the buffers. A
        no-op unless ``num`` is exactly the unclaimed frontier."""
        with self._cv:
            if self._reserved == num:
                self._reserved = None
            if (self._err is not None or self._stop or self._busy
                    or num != self._next):
                self._cv.notify()
                return
            self._busy = True
        try:
            if isinstance(chunks, (bytes, bytearray, memoryview)):
                chunks = (chunks,)
            for c in chunks:
                self._h.update(c)
        except Exception as e:  # noqa: BLE001 - poisons; caller re-hashes
            with self._cv:
                self._err = str(e)
                self._busy = False
                self._cv.notify()
            return
        with self._cv:
            self._busy = False
            self._next += 1
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify()

    def _run(self) -> None:
        try:
            fd = os.open(self.store._data_path, os.O_RDONLY)
        except OSError as e:
            with self._cv:
                self._err = str(e)
                self._cv.notify()
            return
        try:
            while True:
                with self._cv:
                    while True:
                        if self._stop:
                            return
                        m = self.store.metadata
                        rec = m.pieces.get(self._next)
                        if rec is not None and not self._busy:
                            if self._reserved != self._next:
                                break
                            # Reclaim only a reservation whose feed never
                            # came (the cost is one pread).
                            if time.monotonic() - self._reserved_at > 1.0:
                                self._reserved = None
                                break
                        if (rec is None and m.total_piece_count >= 0
                                and self._next >= m.total_piece_count):
                            return  # drained
                        # Timed: update_task can set total_piece_count
                        # without a piece commit notifying.
                        self._cv.wait(timeout=1.0)
                    self._busy = True
                try:
                    remaining, off = rec.size, rec.offset
                    self.disk_reads += 1
                    mv = _READ_BUFFERS.acquire(min(remaining, 4 << 20))
                    try:
                        while remaining > 0:
                            take = min(len(mv), remaining)
                            n = os.preadv(fd, [mv[:take]], off)
                            if n <= 0:
                                raise OSError(f"short read at piece {rec.num}")
                            self._h.update(mv[:n])
                            off += n
                            remaining -= n
                    finally:
                        _READ_BUFFERS.release(mv)
                except BaseException:
                    with self._cv:
                        self._busy = False
                    raise
                with self._cv:
                    self._busy = False
                    self._next += 1
                    self._cv.notify()
        except Exception as e:  # noqa: BLE001 - poisons; caller re-hashes
            with self._cv:
                self._err = str(e)
                self._cv.notify()
        finally:
            try:
                os.close(fd)
            except OSError:
                pass

    def finish(self, timeout: float = 60.0) -> str | None:
        """Wait for the frontier to drain; the hex digest, or None on any
        error or timeout (the caller then re-hashes in full)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                if self._err is not None or self._stop:
                    return None
                total = self.store.metadata.total_piece_count
                if total >= 0 and self._next >= total:
                    break
                left = deadline - time.monotonic()
                if left <= 0 or not self._cv.wait(timeout=min(left, 2.0)):
                    if time.monotonic() >= deadline:
                        return None
        self._thread.join(timeout=5.0)
        return self._h.hexdigest()


class LocalTaskStore:
    """Synchronous piece I/O over one data file. Writes go through the
    page cache (pwrite); metadata saves are atomic (tmp + rename)."""

    def __init__(self, base_dir: str, metadata: TaskStoreMetadata):
        self.dir = base_dir
        self.metadata = metadata
        os.makedirs(self.dir, exist_ok=True)
        self._data_path = os.path.join(self.dir, DATA_FILE)
        self._fd: int | None = None
        self._pins = 0
        self._pin_lock = threading.Lock()
        self._unsaved_pieces = 0
        self._last_meta_save = 0.0
        self._output_lock = threading.Lock()
        # Piece writes run on worker threads: the fused crc + pwrite runs
        # without the interpreter lock at disjoint offsets, but fd creation
        # and the metadata record serialize here.
        self._meta_lock = threading.Lock()
        self._prefix_hasher: _PrefixHasher | None = None
        # num -> the digest each piece was checked AGAINST when it landed
        # (a parent's advertised value), as opposed to one it computed
        # itself. In memory only: the completion re-hash skip is decided
        # in the process that landed the pieces.
        self._verified_pieces: dict[int, str] = {}
        # Set at completion from a done parent's piece-digest map (its
        # completion gate passed); the skip compares the verified-against
        # digests to this map, piece by piece.
        self.certified_digests: "dict[int, str] | None" = None

    # -- pinning: GC must not reclaim a store mid-download -----------------

    def pin(self) -> "LocalTaskStore":
        with self._pin_lock:   # the upload server pins from its threads
            self._pins += 1
        return self

    def unpin(self) -> None:
        with self._pin_lock:
            self._pins = max(0, self._pins - 1)

    @property
    def pinned(self) -> bool:
        return self._pins > 0

    def __enter__(self) -> "LocalTaskStore":
        return self.pin()

    def __exit__(self, *exc) -> None:
        self.unpin()

    # -- lifecycle ---------------------------------------------------------

    @classmethod
    def create(cls, base_dir: str,
               metadata: TaskStoreMetadata) -> "LocalTaskStore":
        store = cls(base_dir, metadata)
        store.save_metadata()
        return store

    @classmethod
    def load(cls, base_dir: str) -> "LocalTaskStore":
        with open(os.path.join(base_dir, METADATA_FILE)) as f:
            metadata = TaskStoreMetadata.from_json(json.load(f))
        return cls(base_dir, metadata)

    def _ensure_fd(self) -> int:
        if self._fd is None:
            with self._meta_lock:
                if self._fd is None:
                    self._fd = os.open(self._data_path,
                                       os.O_RDWR | os.O_CREAT, 0o644)
        return self._fd

    def close(self) -> None:
        # Under _meta_lock: serializes with _ensure_fd's lazy reopen (GC
        # closes idle stores' fds mid-life).
        with self._meta_lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def destroy(self) -> None:
        ph = self._prefix_hasher
        if ph is not None:
            self._prefix_hasher = None
            ph.stop()
        self.close()
        shutil.rmtree(self.dir, ignore_errors=True)

    # -- metadata ----------------------------------------------------------

    def save_metadata(self) -> None:
        with self._meta_lock:
            tmp = os.path.join(self.dir, METADATA_FILE + ".tmp")
            with open(tmp, "w") as f:
                json.dump(self.metadata.to_json(), f)
            os.replace(tmp, os.path.join(self.dir, METADATA_FILE))
            self._unsaved_pieces = 0
            self._last_meta_save = time.monotonic()

    # Piece arrivals persist in batches: re-serializing the whole piece
    # map per piece is O(pieces^2). A crash loses at most one batch (those
    # pieces re-fetch on resume); completion (mark_done) always saves.
    _SAVE_EVERY_PIECES = 64
    _SAVE_EVERY_SECONDS = 2.0

    def _piece_recorded_save(self) -> None:
        if (self._unsaved_pieces >= self._SAVE_EVERY_PIECES
                or time.monotonic() - self._last_meta_save
                >= self._SAVE_EVERY_SECONDS):
            self.save_metadata()

    def touch(self) -> None:
        self.metadata.last_access = time.time()

    def update_task(self, *, content_length: int | None = None,
                    total_piece_count: int | None = None,
                    piece_size: int | None = None,
                    digest: str | None = None,
                    header: dict | None = None) -> None:
        m = self.metadata
        if content_length is not None and content_length >= 0:
            m.content_length = content_length
            if m.piece_size and m.total_piece_count < 0:
                m.total_piece_count = compute_piece_count(content_length,
                                                          m.piece_size)
        if total_piece_count is not None and total_piece_count >= 0:
            m.total_piece_count = total_piece_count
        if piece_size is not None and piece_size > 0:
            m.piece_size = piece_size
        if digest is not None:
            m.digest = digest
        if header is not None:
            m.header = header
        self.save_metadata()

    # -- piece writes ------------------------------------------------------

    def write_piece(self, num: int, data, expected_digest: str = "",
                    cost_ms: int = 0, algorithm: str = "") -> PieceRecord:
        """Write piece ``num`` (any bytes-like). With ``expected_digest``
        the bytes must match it; with none, a digest is computed with
        ``algorithm`` (default crc32c). A crc32c digest of a piece not yet
        recorded is fused into the write. That write lands before the
        check, which is safe only because no valid bytes exist at the
        offset yet: a mismatched piece stays unrecorded, and invisible. A
        recorded piece is checked in memory before it is overwritten."""
        m = self.metadata
        if m.piece_size <= 0:
            raise StorageError("piece size not set")
        offset = num * m.piece_size
        fd = self._ensure_fd()
        piece_is_new = num not in m.pieces
        want = pkgdigest.parse(expected_digest) if expected_digest else None
        alg = (want.algorithm if want is not None
               else algorithm or pkgdigest.preferred_piece_algorithm())
        if piece_is_new and alg == pkgdigest.ALGORITHM_CRC32C:
            got = f"{dfhost.write_piece_crc(fd, offset, data):08x}"
            if want is not None and got != want.encoded:
                raise _mismatch(num, want.encoded, got)
        else:
            got = pkgdigest.hash_bytes(alg, data).encoded
            if want is not None and got != want.encoded:
                raise _mismatch(num, want.encoded, got)
            mv = data if isinstance(data, memoryview) else memoryview(data)
            written = 0
            while written < len(mv):
                written += os.pwrite(fd, mv[written:], offset + written)
        if expected_digest:
            self._verified_pieces[num] = expected_digest
        digest_str = expected_digest or f"{alg}:{got}"
        rec = PieceRecord(num=num, offset=offset, size=len(data),
                          digest=digest_str, cost_ms=cost_ms)
        return self._commit_piece_record(rec, feed_chunks=(data,))

    @staticmethod
    def _pwritev_chunks(fd: int, chunks: list, offset: int, num: int) -> None:
        views = [c if isinstance(c, memoryview) else memoryview(c)
                 for c in chunks if len(c)]
        written = 0
        while views:
            n = os.pwritev(fd, views, offset + written)
            if n <= 0:
                raise StorageError(f"pwritev returned {n} at piece {num}")
            written += n
            # A partial vector write (rare on regular files): drop the
            # views written whole, trim the one at the boundary.
            while views and n >= len(views[0]):
                n -= len(views[0])
                views.pop(0)
            if views and n:
                views[0] = views[0][n:]

    def write_piece_chunks(self, num: int, chunks: list, digest_str: str = "",
                           expected_digest: str = "",
                           cost_ms: int = 0) -> PieceRecord:
        """Land piece ``num`` from an ordered list of bytes-like chunks as
        the wire delivered them, with no assembly buffer and no join, in
        one pass that never re-reads landed bytes:

          - ``digest_str`` given: the caller hashed these chunks while they
            arrived; the check is a string compare, the write one pwritev.
          - a crc32c target and an unrecorded piece: fused, each chunk
            checksummed while it is pwritten (the crc continues across
            chunks); safe for the reason ``write_piece`` gives.
          - otherwise: hash the chunks, check, then pwritev."""
        m = self.metadata
        if m.piece_size <= 0:
            raise StorageError("piece size not set")
        offset = num * m.piece_size
        fd = self._ensure_fd()
        size = sum(len(c) for c in chunks)
        want = pkgdigest.parse(expected_digest) if expected_digest else None
        target_alg = (want.algorithm if want is not None
                      else pkgdigest.preferred_piece_algorithm())
        if digest_str:
            if want is not None and digest_str != str(want):
                raise _mismatch(num, want, digest_str)
            self._pwritev_chunks(fd, chunks, offset, num)
        elif num not in m.pieces and target_alg == pkgdigest.ALGORITHM_CRC32C:
            crc, off = 0, offset
            for c in chunks:
                if len(c):
                    crc = dfhost.write_chunk_crc(fd, off, c, crc)
                    off += len(c)
            if want is not None and f"{crc:08x}" != want.encoded:
                raise _mismatch(num, want.encoded, f"{crc:08x}")
            digest_str = f"{pkgdigest.ALGORITHM_CRC32C}:{crc:08x}"
        else:
            h = pkgdigest.new_hasher(target_alg)
            for c in chunks:
                h.update(c)
            digest_str = f"{target_alg}:{h.hexdigest()}"
            if want is not None and digest_str != str(want):
                raise _mismatch(num, want, digest_str)
            self._pwritev_chunks(fd, chunks, offset, num)
        if expected_digest:
            self._verified_pieces[num] = expected_digest
            digest_str = expected_digest
        rec = PieceRecord(num=num, offset=offset, size=size,
                          digest=digest_str, cost_ms=cost_ms)
        return self._commit_piece_record(rec, feed_chunks=chunks)

    def start_prefix_hasher(self, expected_digest: str) -> None:
        """Hash the contiguous piece prefix in the background so
        ``validate_digest`` at completion is (near) free. Idempotent; a
        no-op for an unknown algorithm."""
        if self._prefix_hasher is not None or not expected_digest:
            return
        try:
            algorithm = pkgdigest.parse(expected_digest).algorithm
            # The hasher opens its own fd at once: the data file must
            # exist before the first piece write.
            self._ensure_fd()
            self._prefix_hasher = _PrefixHasher(self, algorithm)
        except (ValueError, StorageError, OSError):
            return

    @staticmethod
    def completion_digest_applies(digest: str, ranged: bool) -> bool:
        """Does the completion-time whole-content digest apply at all?
        Never for a ranged task (the digest names the whole object) or a
        task without a digest."""
        return bool(digest) and not ranged

    def pieces_verified_against_digests(self) -> bool:
        """Every landed piece was checked against an advertised digest:
        the precondition for any certified map to skip the re-hash. False
        means waiting for a certification is futile."""
        with self._meta_lock:
            return all(n in self._verified_pieces
                       for n in self.metadata.pieces)

    def certifies(self, certified: "dict[int, str] | None") -> bool:
        """Would this digest map certify the store: the content complete
        and every piece's verified-against digest equal to the map's? The
        per-piece comparison keeps provenance: pieces checked against a
        corrupt, still-downloading parent's own digests do not match an
        honest done parent's map, so they force the re-hash."""
        if not certified or not self.is_complete():
            return False
        with self._meta_lock:
            return all(self._verified_pieces.get(n) is not None
                       and self._verified_pieces[n] == certified.get(n)
                       for n in self.metadata.pieces)

    def apply_certification(self, candidate_maps) -> bool:
        """Install the first candidate map that certifies the store, so a
        corrupt parent that completed first cannot mask an honest one. An
        installed certifying map is never replaced. True when one is
        installed."""
        if self.certifies(self.certified_digests):
            return True
        for m in candidate_maps:
            if self.certifies(m):
                # A snapshot: the candidate is the dispatcher's live dict.
                self.certified_digests = dict(m)
                return True
        return False

    def pieces_all_digest_verified(self) -> bool:
        """The installed ``certified_digests`` map certifies the store:
        the completion re-hash may be skipped."""
        return self.certifies(self.certified_digests)

    def _commit_piece_record(self, rec: PieceRecord,
                             feed_chunks=None) -> PieceRecord:
        """The one metadata commit point of every write path: record under
        the lock, then persist the piece map in batches so a restart
        resumes from it. ``feed_chunks`` (the piece's bytes, still owned
        by the writer) advance the prefix hasher without a re-read."""
        with self._meta_lock:
            existing = self.metadata.pieces.get(rec.num)
            self.metadata.pieces[rec.num] = rec
            self.touch()
            if existing is None:
                self._unsaved_pieces += 1
            ph = self._prefix_hasher
            if ph is not None:
                ph.piece_recorded(rec.num, existing is not None,
                                  will_feed=feed_chunks is not None)
        if ph is not None and feed_chunks is not None:
            ph.feed(rec.num, feed_chunks)
        if existing is None:
            self._piece_recorded_save()
        return rec

    # -- reads: one preadv engine under every read surface -----------------

    def read_into(self, offset: int, length: int, buf, at: int = 0) -> None:
        """Fill ``buf[at:at+length]`` with file bytes [offset,
        offset+length) by preadv, with no intermediate allocation. A short
        read (EOF inside the span) raises StorageError."""
        if length <= 0:
            return
        mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        if at + length > len(mv):
            raise StorageError(
                f"read buffer too small: need {at + length}, have {len(mv)}")
        fd = self._ensure_fd()
        got = 0
        while got < length:
            n = os.preadv(fd, [mv[at + got:at + length]], offset + got)
            if n <= 0:
                raise StorageError(
                    f"short read at offset {offset + got}: "
                    f"{got}/{length} bytes (EOF)")
            got += n

    def read_spans_into(self, spans, buf) -> int:
        """Pack the byte spans ``[(offset, length), ...]`` back to back into
        ``buf``; returns the total. A multi-span batch goes to the
        submission ring (``storage/io_ring.py``) as one submission; a short
        read anywhere raises StorageError."""
        spans = list(spans)
        buf_offsets = list(accumulate((ln for _, ln in spans), initial=0))
        total = buf_offsets.pop()
        mv = buf if isinstance(buf, memoryview) else memoryview(buf)
        if total > len(mv):
            raise StorageError(
                f"read buffer too small: need {total}, have {len(mv)}")
        if len(spans) > 1:
            try:
                io_ring.get_ring().read_spans(self._ensure_fd(), spans, mv,
                                              buf_offsets)
            except io_ring.ShortReadError as e:
                raise StorageError(str(e)) from None
        elif spans:
            self.read_into(spans[0][0], spans[0][1], mv)
        self.touch()
        return total

    def read_piece(self, num: int) -> bytes:
        """Piece ``num``'s bytes as fresh ``bytes``, read straight into
        them (one copy, from the page cache)."""
        rec = self.metadata.pieces.get(num)
        if rec is None:
            raise StorageError(f"piece {num} not found",
                               Code.StoragePieceNotFound)
        fd = self._ensure_fd()
        parts, got = [], 0
        while got < rec.size:
            part = os.pread(fd, rec.size - got, rec.offset + got)
            if not part:
                raise StorageError(
                    f"short read at offset {rec.offset + got}: "
                    f"{got}/{rec.size} bytes (EOF)")
            parts.append(part)
            got += len(part)
        self.touch()
        return parts[0] if len(parts) == 1 else b"".join(parts)

    def get_pieces(self, start_num: int = 0,
                   limit: int = 0) -> list[PieceRecord]:
        """The recorded pieces from ``start_num`` on, in order."""
        out = []
        with self._meta_lock:  # writers mutate from worker threads
            nums = sorted(n for n in self.metadata.pieces if n >= start_num)
            for n in nums:
                out.append(self.metadata.pieces[n])
                if limit and len(out) >= limit:
                    break
        return out

    def has_piece(self, num: int) -> bool:
        return num in self.metadata.pieces

    @property
    def data_path(self) -> str:
        return self._data_path

    def downloaded_bytes(self) -> int:
        with self._meta_lock:
            return sum(p.size for p in self.metadata.pieces.values())

    def disk_usage(self) -> int:
        try:
            return os.path.getsize(self._data_path)
        except OSError:
            return 0

    # -- completion --------------------------------------------------------

    def is_complete(self) -> bool:
        m = self.metadata
        return (m.total_piece_count >= 0
                and len(m.pieces) >= m.total_piece_count
                and all(n in m.pieces for n in range(m.total_piece_count)))

    def mark_done(self) -> None:
        self.metadata.done = True
        self.touch()
        self.save_metadata()

    def mark_invalid(self) -> None:
        ph = self._prefix_hasher
        if ph is not None:
            self._prefix_hasher = None
            ph.stop()
        self.metadata.invalid = True
        self.save_metadata()

    def _check_content(self, want: str, actual: str) -> str:
        if want and actual != want:
            raise StorageError(
                f"content digest mismatch: want {want}, got {actual}",
                Code.ClientPieceDownloadFail)
        return actual

    def validate_digest(self, expected: str = "") -> str:
        """The whole-content digest over the pieces in order, checked
        against ``expected`` (or the metadata's digest) when there is one.
        Returns the digest string."""
        want = expected or self.metadata.digest
        algorithm = (pkgdigest.parse(want).algorithm if want
                     else pkgdigest.ALGORITHM_SHA256)
        ph = self._prefix_hasher
        if ph is not None:
            # Detach always: a hasher of another algorithm must not keep
            # reading beside the re-hash below.
            self._prefix_hasher = None
            if ph.algorithm != algorithm:
                ph.stop()
                ph = None
        if ph is not None:
            cl = self.metadata.content_length
            prefix_hex = ph.finish(
                timeout=max(60.0, cl / (50 << 20)) if cl > 0 else 60.0)
            if prefix_hex is not None:
                return self._check_content(want, f"{algorithm}:{prefix_hex}")
            ph.stop()   # poisoned or lagging: the full re-hash runs
        h = pkgdigest.new_hasher(algorithm)
        mv = _READ_BUFFERS.acquire(4 << 20)
        try:
            for n in sorted(self.metadata.pieces):
                rec = self.metadata.pieces[n]
                remaining, off = rec.size, rec.offset
                while remaining > 0:
                    take = min(len(mv), remaining)
                    self.read_into(off, take, mv)
                    h.update(mv[:take])
                    off += take
                    remaining -= take
        finally:
            _READ_BUFFERS.release(mv)
        return self._check_content(want, f"{algorithm}:{h.hexdigest()}")

    def reverify_pieces(self, threads: int = 0) -> list[int]:
        """Re-verify every digested piece against the bytes on disk;
        returns the piece numbers that fail. crc32c pieces are hashed on
        the host library's threads; a file too short for that batch, and
        pieces of other algorithms, are checked one by one, where a short
        read counts as a bad piece."""
        recs = [self.metadata.pieces[n] for n in sorted(self.metadata.pieces)]
        crc_recs = [r for r in recs
                    if r.digest.startswith(pkgdigest.ALGORITHM_CRC32C + ":")]
        bad: list[int] = []
        checked: set[int] = set()
        if crc_recs:
            try:
                crcs = dfhost.hash_pieces_crc(
                    self._ensure_fd(), [r.offset for r in crc_recs],
                    [r.size for r in crc_recs], threads=threads)
            except OSError:
                pass   # a truncated file: every piece checked one by one
            else:
                for r, crc in zip(crc_recs, crcs):
                    if f"{pkgdigest.ALGORITHM_CRC32C}:{crc:08x}" != r.digest:
                        bad.append(r.num)
                checked = {r.num for r in crc_recs}
        one_by_one = [r for r in recs if r.num not in checked and r.digest]
        if one_by_one:
            mv = _READ_BUFFERS.acquire(max(r.size for r in one_by_one))
            try:
                for r in one_by_one:
                    d = pkgdigest.parse(r.digest)
                    try:
                        self.read_into(r.offset, r.size, mv)
                    except (StorageError, OSError):
                        bad.append(r.num)
                        continue
                    if pkgdigest.hash_bytes(d.algorithm,
                                            mv[:r.size]).encoded != d.encoded:
                        bad.append(r.num)
            finally:
                _READ_BUFFERS.release(mv)
        return sorted(bad)

    def covers_range(self, start: int, length: int) -> bool:
        """True when every piece overlapping [start, start+length) is
        present."""
        m = self.metadata
        if m.piece_size <= 0 or length <= 0 or start < 0:
            return False
        if m.content_length >= 0 and start + length > m.content_length:
            return False
        first = start // m.piece_size
        last = (start + length - 1) // m.piece_size
        with self._meta_lock:
            return all(n in m.pieces for n in range(first, last + 1))

    def read_range(self, start: int, length: int) -> memoryview:
        """Bytes ``[start, start+length)`` (the caller checked
        ``covers_range``: covered bytes are contiguous in the data file) in
        a pooled view; ``release_read_buffer`` hands it back."""
        mv = _READ_BUFFERS.acquire(length)
        try:
            self.read_spans_into(((start, length),), mv)
        except BaseException:
            _READ_BUFFERS.release(mv)
            raise
        return mv

    def export_range(self, dest: str, start: int, length: int) -> None:
        """Write the byte range [start, start+length) to ``dest`` straight
        off the data file in bounded spans (the caller checked
        ``covers_range``)."""
        os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
        mv = _READ_BUFFERS.acquire(min(4 << 20, length))
        try:
            remaining, off = length, start
            with open(dest, "wb") as out:
                while remaining > 0:
                    take = min(len(mv), remaining)
                    self.read_into(off, take, mv)
                    out.write(mv[:take])
                    off += take
                    remaining -= take
        finally:
            _READ_BUFFERS.release(mv)

    def store_to(self, dest: str, *, hardlink: bool = True) -> None:
        """Land the completed content at ``dest``: a hardlink when
        possible, else a copy to a temporary file renamed into place
        (opening ``dest`` with O_TRUNC in place could truncate the data
        file through a concurrently made hardlink to the same inode).
        Serialized per store: it runs on worker threads."""
        if not self.is_complete():
            raise StorageError("task incomplete; refusing to store output")
        with self._output_lock:
            os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
            try:
                os.unlink(dest)
            except FileNotFoundError:
                pass
            # Truncate to the content length: guards a sparse tail.
            cl = self.metadata.content_length
            if cl >= 0 and self.disk_usage() != cl:
                with open(self._data_path, "r+b") as f:
                    f.truncate(cl)
            if hardlink:
                try:
                    os.link(self._data_path, dest)
                    return
                except FileExistsError:
                    return  # a concurrent lander won the race: same content
                except OSError:
                    pass
            tmp = f"{dest}.df-tmp-{os.getpid()}-{threading.get_ident()}"
            try:
                shutil.copyfile(self._data_path, tmp)
                os.replace(tmp, dest)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
