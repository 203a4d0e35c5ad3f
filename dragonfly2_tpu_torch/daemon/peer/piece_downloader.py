"""Piece downloader, HTTP GETs against a parent's upload server: the
port's copy of ``dragonfly2_tpu/daemon/peer/piece_downloader.py``, on the
standard library (the JAX one rides ``aiohttp``, which the card machine
does not have).

- ``download_piece``: ``GET http://{parent}/download/{task_id[:3]}/
  {task_id}?peerId=...&pieceNum=N`` (and ``tenant=`` when set), the body
  as it arrived plus the digest of the algorithms the store cannot check
  in the write; sizes are checked as the body arrives.
- ``download_span_to_store``: a run of contiguous pieces from one parent
  as ONE ranged GET; each piece is landed through the store's fused
  crc32c + pwrite (``write_piece_chunks``) and checked against the
  parent's advertised digest as it arrives, and ``on_result`` is awaited
  for it before the next is read, so piece reports and sink landings stay
  piece-granular.
- ``pull_one_piece``: the per-piece step the conductor runs when a run
  cannot be formed.

Errors are the JAX package's: coded ``DfError``s carrying a typed failure
``reason`` (``failure_reason``), the same status mapping
(``_upload_status_error``), and ``is_parent_gone``.

Transport: ``http.client`` on the downloader's own worker threads
(``df-piece-http``), connections kept alive per parent and reused; a
``ConnectionError`` on a kept-alive connection before any answer is taken
as stale and the request is sent once more on a fresh one. Each socket
wait is bounded by ``IDLE_TIMEOUT`` (a silent parent is a stall) and a
piece by ``TIMEOUT``. A cancelled call cuts its connection and returns
only after its worker stopped. ``timings`` sums, over every worker, the
seconds spent waiting on a parent (from the request to a piece's last
byte: ``get_wait_s``) and writing pieces into the store
(``store_write_s``).

Each piece attempt stamps the task's flight (``pkg/flight.for_task``, the
process-wide recorder, as in JAX): ``EV_REQUEST`` when it is asked for,
``EV_FIRST_BYTE`` when its first bytes arrive, and ``EV_STORE_START`` /
``EV_STORED`` around its store write. The JAX downloader stamps the store
pair on its per-piece path only (its span is a native fetch); the port's
span writes each piece through the store too, and stamps it likewise.

Each piece GET carries the caller's trace context as a ``traceparent``
header (``pkg/tracing.inject``, read on the loop before the fetch goes to
its thread), so the parent's ``upload.serve`` span joins the child's
trace.

Not ported: the native route (``NativeConnPool``, the native branch of
``download_piece_to_store`` and the span's native fetch) and the chaos
hooks.
"""

from __future__ import annotations

import asyncio
import http.client
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import urlencode

from dragonfly2_tpu_torch.pkg import digest as pkgdigest
from dragonfly2_tpu_torch.pkg import flight as flightlib
from dragonfly2_tpu_torch.pkg import tracing
from dragonfly2_tpu_torch.pkg.bufpool import WorkerCall, await_worker
from dragonfly2_tpu_torch.pkg.errors import Code, DfError, describe

CHUNK = 1 << 20
WORKERS = 16
MAX_IDLE_PER_PARENT = 8
TIMEOUT = 30.0        # a piece, from the request to its last byte
IDLE_TIMEOUT = 10.0   # one socket wait: a silent parent is a stall


def _err(code: Code, msg: str, reason: str) -> DfError:
    """A coded per-piece error carrying its typed failure reason."""
    return DfError(code, msg, {"reason": reason})


def failure_reason(e: DfError) -> str:
    """A piece failure's typed reason: explicit metadata first (raise
    sites on this path tag themselves), then the store's digest-mismatch
    message, then the code."""
    r = e.metadata.get("reason", "")
    if r:
        return r
    if "digest mismatch" in e.message:
        return "corrupt"
    return {
        Code.ClientConnectionError: "refused",
        Code.ClientPieceRequestFail: "transport",
        Code.ClientPieceDownloadFail: "truncated",
        Code.ClientRequestLimitFail: "throttle",
        Code.ClientPieceNotFound: "not_found",
        Code.RequestTimeout: "stall",
    }.get(e.code, "transport")


class _Assembly:
    """One piece's body as the wire delivered it: size checks as chunks
    arrive, and the digest of an algorithm the store cannot check in the
    write (anything but crc32c) computed meanwhile."""

    def __init__(self, expected_size: int, expected_digest: str):
        algorithm = ""
        if expected_digest:
            try:
                algorithm = pkgdigest.parse(expected_digest).algorithm
            except pkgdigest.InvalidDigestError:
                raise DfError(Code.ClientPieceDownloadFail,
                              f"malformed digest {expected_digest!r}")
        self.algorithm = algorithm
        self.hasher = (pkgdigest.new_hasher(algorithm)
                       if algorithm and algorithm != pkgdigest.ALGORITHM_CRC32C
                       else None)
        self.expected = expected_size
        self.chunks: list = []
        self.got = 0

    def add(self, chunk) -> None:
        if self.expected >= 0 and self.got + len(chunk) > self.expected:
            raise _err(Code.ClientPieceDownloadFail,
                       f"body exceeds expected size {self.expected}",
                       "truncated")
        self.chunks.append(chunk)
        self.got += len(chunk)
        if self.hasher is not None:
            self.hasher.update(chunk)

    def finish(self) -> "tuple[list, int, str]":
        if self.expected >= 0 and self.got != self.expected:
            raise _err(Code.ClientPieceDownloadFail,
                       f"body size {self.got} != expected {self.expected}",
                       "truncated")
        digest_str = (f"{self.algorithm}:{self.hasher.hexdigest()}"
                      if self.hasher is not None else "")
        return self.chunks, self.got, digest_str


async def assemble_piece(chunks, expected_size: int,
                         expected_digest: str = "") -> "tuple[list, int, str]":
    """Drain an async chunk iterator into the chunks exactly as delivered
    (no join): ``(chunks, size, digest_str)``. ``digest_str`` is the digest
    computed while the bytes arrived, for an algorithm the store cannot
    fuse into the write; for crc32c it is "" and the store checksums each
    chunk while it writes it. Size mismatches raise here."""
    asm = _Assembly(expected_size, expected_digest)
    async for chunk in chunks:
        asm.add(chunk)
    return asm.finish()


def _upload_status_error(status: int, parent: str, what: str) -> DfError | None:
    """A parent upload server's status as the coded per-piece error, or
    None for a payload status (200/206)."""
    if status in (404, 416):
        return _err(Code.ClientPieceNotFound,
                    f"parent {parent} lacks {what} ({status})", "not_found")
    if status == 429:
        return _err(Code.ClientRequestLimitFail,
                    f"parent {parent} throttled", "throttle")
    if status not in (200, 206):
        return _err(Code.ClientPieceRequestFail,
                    f"parent {parent} returned {status} for {what}",
                    "http5xx" if status >= 500 else "transport")
    return None


def is_parent_gone(e: DfError) -> bool:
    """Errors that mean the parent itself is unusable (not a transient
    piece failure)."""
    return e.code in (Code.ClientConnectionError, Code.ClientPieceRequestFail)


class _Exchange:
    """One response and the connection it arrived on."""

    def __init__(self, key, conn, resp):
        self.key = key
        self.conn = conn
        self.resp = resp


class PieceDownloader:
    def __init__(self):
        self._mu = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._idle: dict[tuple[str, int], list] = {}
        self.timings = {"get_wait_s": 0.0, "store_write_s": 0.0}

    def _count(self, key: str, since: float) -> float:
        """Add the seconds since ``since`` to ``timings[key]``; now."""
        now = time.monotonic()
        with self._mu:
            self.timings[key] += now - since
        return now

    # -- transport ---------------------------------------------------------

    async def _run(self, fn, *args):
        with self._mu:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=WORKERS, thread_name_prefix="df-piece-http")
            pool = self._pool
        call = WorkerCall()
        return await await_worker(pool.submit(fn, call, *args), call.abort)

    def _checkout(self, key) -> "tuple[http.client.HTTPConnection, bool]":
        with self._mu:
            idle = self._idle.get(key)
            if idle:
                return idle.pop(), True
        return http.client.HTTPConnection(
            key[0], key[1], timeout=IDLE_TIMEOUT), False

    def _checkin(self, ex: _Exchange) -> None:
        """Keep a connection whose response was read to its end; close
        any other."""
        resp = ex.resp
        if resp.isclosed() and not resp.will_close and ex.conn.sock is not None:
            with self._mu:
                idle = self._idle.setdefault(ex.key, [])
                if self._pool is not None and len(idle) < MAX_IDLE_PER_PARENT:
                    idle.append(ex.conn)
                    return
        ex.conn.close()

    def _exchange(self, call: WorkerCall, key, path: str,
                  headers: dict) -> _Exchange:
        """Send the GET and read the status line and headers. A kept-alive
        connection that proves stale is replaced once."""
        while True:
            conn, reused = self._checkout(key)
            try:
                call.attach(conn)
                conn.request("GET", path, headers=headers)
                return _Exchange(key, conn, conn.getresponse())
            except ConnectionError:
                conn.close()
                if not reused or call.stopped:
                    raise
            except BaseException:
                conn.close()
                raise
            finally:
                call.detach(conn)

    def _read_body(self, call: WorkerCall, ex: _Exchange, asm: _Assembly,
                   length: int, deadline: float, first=None) -> None:
        """``length`` body bytes into ``asm`` (-1: to the end); ``first()``
        is called when the first bytes arrive."""
        call.attach(ex.conn)
        try:
            left = length
            while left != 0:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"timed out after {TIMEOUT}s")
                data = ex.resp.read(CHUNK if left < 0 else min(CHUNK, left))
                if not data:
                    if left > 0 or ex.resp.length:
                        raise http.client.IncompleteRead(b"", left)
                    return
                if first is not None:
                    first()
                    first = None
                asm.add(data)
                if left > 0:
                    left -= len(data)
        finally:
            call.detach(ex.conn)

    def _transport_error(self, e: BaseException, what: str,
                         parent: str) -> DfError:
        if isinstance(e, TimeoutError):
            return _err(Code.ClientPieceRequestFail,
                        f"{what} from {parent}: {describe(e)}", "stall")
        return _err(Code.ClientPieceRequestFail,
                    f"{what} from {parent}: {describe(e)}", "transport")

    @staticmethod
    def _path(task_id: str, query: dict) -> str:
        return f"/download/{task_id[:3]}/{task_id}?{urlencode(query)}"

    # -- one piece ---------------------------------------------------------

    def _fetch_piece(self, call: WorkerCall, key, path: str, piece_num: int,
                     expected_size: int, expected_digest: str, ft,
                     trace: dict):
        parent = f"{key[0]}:{key[1]}"
        asm = _Assembly(expected_size, expected_digest)
        t0 = time.monotonic()
        deadline = t0 + TIMEOUT
        try:
            ex = self._exchange(call, key, path,
                                {"Accept-Encoding": "identity", **trace})
            status_err = _upload_status_error(ex.resp.status, parent,
                                              f"piece {piece_num}")
            if status_err is not None:
                ex.conn.close()
                raise status_err
            try:
                self._read_body(call, ex, asm, -1, deadline, lambda: ft.record(
                    flightlib.EV_FIRST_BYTE, piece_num))
            except BaseException:
                ex.conn.close()
                raise
            out = asm.finish()
            self._count("get_wait_s", t0)
            self._checkin(ex)
            return out
        except (OSError, http.client.HTTPException) as e:
            raise self._transport_error(e, f"piece {piece_num}", parent)

    async def download_piece(self, parent_ip: str, parent_upload_port: int,
                             task_id: str, piece_num: int, *,
                             src_peer_id: str = "", expected_size: int = -1,
                             expected_digest: str = "",
                             tenant: str = "") -> "tuple[list, int, int, str]":
        """Fetch one piece: ``(chunks, size, cost_ms, digest_str)``, the
        body as wire chunks plus the streaming digest (``assemble_piece``).
        Land it with ``store.write_piece_chunks``, which checks it at the
        commit point with no second pass."""
        query = {"peerId": src_peer_id, "pieceNum": str(piece_num)}
        if tenant:
            query["tenant"] = tenant
        ft = flightlib.for_task(task_id)
        ft.record(flightlib.EV_REQUEST, piece_num, 0.0,
                  f"{parent_ip}:{parent_upload_port}")
        start = time.monotonic()
        # The trace context is read here, on the loop, and handed to the
        # fetching thread: the parent's upload span joins this trace.
        chunks, size, digest_str = await self._run(
            self._fetch_piece, (parent_ip, parent_upload_port),
            self._path(task_id, query), piece_num, expected_size,
            expected_digest, ft, tracing.inject())
        return chunks, size, int((time.monotonic() - start) * 1000), \
            digest_str

    # -- a run of pieces as one ranged GET ---------------------------------

    def _land_span_piece(self, call: WorkerCall, ex: _Exchange, store, a,
                         t0: float, ft):
        """Read piece ``a``'s bytes off the span and land them: crc32c
        fused into the write, checked against the parent's digest."""
        asm = _Assembly(a.expected_size, "")
        self._read_body(call, ex, asm, a.expected_size,
                        time.monotonic() + TIMEOUT, lambda: ft.record(
                            flightlib.EV_FIRST_BYTE, a.piece_num))
        chunks, _, _ = asm.finish()
        landed = self._count("get_wait_s", t0)
        ft.record(flightlib.EV_STORE_START, a.piece_num)
        try:
            rec = store.write_piece_chunks(
                a.piece_num, chunks, "", expected_digest=a.digest,
                cost_ms=int((landed - t0) * 1000))
        finally:
            self._count("store_write_s", landed)
        ft.record(flightlib.EV_STORED, a.piece_num)
        return rec

    async def download_span_to_store(self, parent_ip: str,
                                     parent_upload_port: int, task_id: str,
                                     run: list, store, *,
                                     src_peer_id: str = "", limiter=None,
                                     on_result=None,
                                     tenant: str = "") -> bool:
        """Fetch a CONTIGUOUS run of pieces from one parent as one ranged
        GET, landing each piece as it arrives and awaiting ``on_result(a,
        rec, err)`` for it (rec on success, a coded DfError on failure).
        Returns False when the run is ineligible (shorter than 2, unknown
        geometry, a piece already held, a digest the write cannot check)
        and the caller pulls piece by piece. A transport failure mid-span
        fails only the unread pieces; landed pieces stay recorded."""
        piece_size = store.metadata.piece_size
        if len(run) < 2 or piece_size <= 0:
            return False
        for a in run:
            if (a.expected_size < 0 or a.expected_size > piece_size
                    or store.has_piece(a.piece_num)):
                return False
            if a.digest:
                try:
                    d = pkgdigest.parse(a.digest)
                except pkgdigest.InvalidDigestError:
                    return False  # the per-piece path raises its coded error
                if d.algorithm != pkgdigest.ALGORITHM_CRC32C:
                    return False
        for prev, nxt in zip(run, run[1:]):
            if nxt.piece_num != prev.piece_num + 1:
                return False

        key = (parent_ip, parent_upload_port)
        parent = f"{parent_ip}:{parent_upload_port}"
        span = f"span {run[0].piece_num}-{run[-1].piece_num}"
        start = run[0].piece_num * piece_size
        total = sum(a.expected_size for a in run)
        query = {"peerId": src_peer_id}
        if tenant:
            query["tenant"] = tenant
        headers = {"Range": f"bytes={start}-{start + total - 1}",
                   "Accept-Encoding": "identity", **tracing.inject()}

        async def fail_all(err: DfError) -> bool:
            for a in run:
                await on_result(a, None, err)
            return True

        ft = flightlib.for_task(task_id)
        ft.record(flightlib.EV_REQUEST, run[0].piece_num, 0.0, parent)
        t0 = time.monotonic()   # the first piece waits from the request
        try:
            ex = await self._run(self._exchange, key,
                                 self._path(task_id, query), headers)
        except (OSError, http.client.HTTPException) as e:
            return await fail_all(_err(Code.ClientPieceRequestFail,
                                       f"{span} from {parent}: {describe(e)}",
                                       "transport"))
        consumed = False
        try:
            status_err = _upload_status_error(ex.resp.status, parent, span)
            if status_err is not None:
                return await fail_all(status_err)
            clen = ex.resp.length
            if clen != total:
                return await fail_all(_err(
                    Code.ClientPieceDownloadFail,
                    f"span Content-Length {clen} != expected {total}",
                    "truncated"))
            transport_err: DfError | None = None
            for i, a in enumerate(run):
                if transport_err is not None:
                    await on_result(a, None, transport_err)
                    continue
                if limiter is not None:
                    await limiter.wait(a.expected_size)
                if i:
                    ft.record(flightlib.EV_REQUEST, a.piece_num, 0.0, parent)
                    t0 = time.monotonic()
                try:
                    rec = await self._run(self._land_span_piece, ex, store, a,
                                          t0, ft)
                except DfError as e:     # the piece's digest: this piece only
                    await on_result(a, None, e)
                    continue
                except (OSError, http.client.HTTPException) as e:
                    transport_err = self._transport_error(
                        e, f"piece {a.piece_num} mid-span", parent)
                    await on_result(a, None, transport_err)
                    continue
                await on_result(a, rec, None)
            consumed = transport_err is None
            return True
        finally:
            if consumed:
                self._checkin(ex)
            else:
                ex.conn.close()

    async def close(self) -> None:
        with self._mu:
            pool, self._pool = self._pool, None
            idle, self._idle = self._idle, {}
        if pool is not None:
            pool.shutdown(wait=False)
        for conns in idle.values():
            for conn in conns:
                conn.close()


async def pull_one_piece(downloader: PieceDownloader, store, dispatcher,
                         assignment, *, task_id: str, peer_id: str,
                         limiter, tenant: str = ""):
    """The shared piece-pull step: backfill the store's geometry from the
    dispatcher, rate-limit, fetch from the assigned parent, check and
    write. Returns the PieceRecord; raises DfError WITHOUT reporting to the
    dispatcher (callers own success and failure accounting)."""
    if store.metadata.piece_size <= 0 and dispatcher.piece_size > 0:
        store.update_task(
            piece_size=dispatcher.piece_size,
            content_length=dispatcher.content_length
            if dispatcher.content_length >= 0 else None,
            total_piece_count=dispatcher.total_piece_count
            if dispatcher.total_piece_count >= 0 else None,
        )
    await limiter.wait(max(assignment.expected_size, 1)
                       if assignment.expected_size > 0 else 1)
    chunks, _size, cost_ms, received_digest = await downloader.download_piece(
        assignment.parent.ip, assignment.parent.upload_port,
        task_id, assignment.piece_num,
        src_peer_id=peer_id, expected_size=assignment.expected_size,
        expected_digest=assignment.digest, tenant=tenant)
    # Off the loop: the write blocks on the disk. One pwritev of the
    # chunks, crc fused into it or checked against the streamed digest.
    ft = flightlib.for_task(task_id)

    def write():
        t0 = time.monotonic()
        try:
            return store.write_piece_chunks(
                assignment.piece_num, chunks, received_digest,
                expected_digest=assignment.digest, cost_ms=cost_ms)
        finally:
            downloader._count("store_write_s", t0)

    ft.record(flightlib.EV_STORE_START, assignment.piece_num)
    rec = await asyncio.to_thread(write)
    ft.record(flightlib.EV_STORED, assignment.piece_num)
    return rec
