"""The P2P transport, which turns HTTP GETs into stream tasks: the port's
copy of ``fetch`` and ``sendfile_window`` from
``dragonfly2_tpu/daemon/transport.py``, used by the object gateway
(``daemon/objectstorage.py``). The proxy's half (its rules, a default tag
and ``should_use_p2p``) comes with the proxy, which is not ported yet.

``fetch`` pops ``Range`` and the ``X-Dragonfly-{Tag,Application,Filter}``
headers (case-insensitively), which set the task's identity, and starts
the stream task. ``sendfile_window`` says when a fetch's bytes can go from
the store's data file to the socket by ``sendfile``.
"""

from __future__ import annotations

import os

from dragonfly2_tpu_torch.daemon.peer.task_manager import StreamTaskRequest
from dragonfly2_tpu_torch.pkg.errors import Code, DfError
from dragonfly2_tpu_torch.pkg.piece import Range
from dragonfly2_tpu_torch.proto.common import UrlMeta

HDR_TAG = "X-Dragonfly-Tag"
HDR_APPLICATION = "X-Dragonfly-Application"
HDR_FILTER = "X-Dragonfly-Filter"


def _pop_header(headers: dict[str, str], name: str, default: str = "") -> str:
    """Case-insensitive pop (HTTP/2 hops lowercase the names)."""
    lname = name.lower()
    for k in list(headers):
        if k.lower() == lname:
            return headers.pop(k)
    return default


class P2PTransport:
    def __init__(self, task_manager):
        self.task_manager = task_manager

    @staticmethod
    def sendfile_window(attrs: dict, rng, total: int):
        """(store, offset, count) when a fetch's answer can be sent by
        ``sendfile`` straight off the store's data file, else None:

        - a completed store whose data file is exactly the content: the
          whole object, or any in-bounds range;
        - a store still downloading, for a range whose bytes have all
          landed (``covers_range``): landed bytes sit at their final
          offsets and do not change.

        None when the bytes must stream through the piece iterator: no
        store, an unknown total, a window not covered, or an empty one.
        The caller pins the store around the send."""
        store = attrs.get("local_store")
        if store is None or total < 0:
            return None
        m = store.metadata
        complete = False
        if m.done or store.is_complete():
            # A sparse tail or a stale truncation would make the whole
            # object's Content-Length lie.
            try:
                complete = os.path.getsize(store.data_path) == total
            except OSError:
                return None
        if rng is None:
            return (store, 0, total) if complete and total > 0 else None
        count = min(rng.length, max(total - rng.start, 0))
        if count <= 0:
            return None
        if complete or store.covers_range(rng.start, count):
            return store, rng.start, count
        return None

    async def fetch(self, url: str, headers: dict[str, str] | None = None):
        """Fetch through the P2P fabric: (attrs, body iterator). Raises
        DfError when the task fails before its first byte."""
        headers = dict(headers or {})
        rng = None
        range_header = _pop_header(headers, "Range")
        if range_header:
            try:
                rng = Range.parse_http(range_header)
            except ValueError as e:
                raise DfError(Code.BadRequest, f"bad range: {e}")
        meta = UrlMeta(
            tag=_pop_header(headers, HDR_TAG),
            application=_pop_header(headers, HDR_APPLICATION),
            filter=_pop_header(headers, HDR_FILTER),
            header=headers,
        )
        req = StreamTaskRequest(url=url, meta=meta, range=rng)
        # The task manager resolves an open range against the content
        # length when it is known (attrs["range"]).
        return await self.task_manager.start_stream_task(req)
