"""An HTTP/1.1 server on threads of its own, for the daemon's servers that
the JAX package runs on ``aiohttp`` (the card machine has no ``aiohttp``):
the upload server, the object gateway and ``/metrics``.

One accept thread (``df-<name>-accept``) and one thread a connection
(``df-<name>``), keep-alive. Every open connection is tracked, so ``close``
can cut the idle kept-alive ones and wait for every connection's thread:
no thread of the server outlives it.
"""

from __future__ import annotations

import socket
import sys
import threading
from http.server import ThreadingHTTPServer


class ThreadedServer(ThreadingHTTPServer):
    # aiohttp's listen backlog.
    request_queue_size = 128

    def __init__(self, addr: tuple[str, int], handler, name: str):
        super().__init__(addr, handler)
        self.name = name
        self._mu = threading.Lock()
        self._conns: dict[threading.Thread, socket.socket] = {}
        self._accept: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self.server_address[1]

    def start(self) -> int:
        """Serve on the accept thread; returns the port."""
        self._accept = threading.Thread(target=self.serve_forever,
                                        name=f"df-{self.name}-accept",
                                        daemon=True)
        self._accept.start()
        return self.port

    def process_request(self, request, client_address):
        t = threading.Thread(target=self._serve_connection,
                             args=(request, client_address),
                             name=f"df-{self.name}", daemon=True)
        with self._mu:
            self._conns[t] = request
        t.start()

    def _serve_connection(self, request, client_address) -> None:
        try:
            self.process_request_thread(request, client_address)
        finally:
            with self._mu:
                self._conns.pop(threading.current_thread(), None)

    def handle_error(self, request, client_address):
        # A client that goes away mid-body cuts its connection.
        if not isinstance(sys.exc_info()[1], ConnectionError):
            super().handle_error(request, client_address)

    def close(self, timeout: float = 10.0) -> None:
        """Stop accepting, cut every open connection and wait for the
        threads. It blocks: a server whose handlers wait on an event loop
        must be closed off that loop."""
        if self._accept is not None:
            self.shutdown()
            self._accept.join(timeout)
        self.server_close()
        with self._mu:
            conns = list(self._conns.items())
        for _, sock in conns:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass   # already closed by its thread
        for t, _ in conns:
            t.join(timeout)
