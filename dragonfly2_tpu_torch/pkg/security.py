"""TLS contexts for drpc and the upload server: the port's copy of
``dragonfly2_tpu/pkg/security.py`` (``ssl`` alone).

``server_ssl_context`` presents a certificate and, with
``require_client_cert``, asks each client for one signed by ``ca_file``
(mTLS). ``client_ssl_context`` trusts ``ca_file`` (fabric certificates are
per host, so no hostname check), or nothing checked with
``verify=False``, or the system's store; with ``cert_file`` and
``key_file`` it presents a client certificate.
"""

from __future__ import annotations

import ssl


def server_ssl_context(cert_file: str, key_file: str, *, ca_file: str = "",
                       require_client_cert: bool = False) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.load_cert_chain(cert_file, key_file)
    if ca_file:
        ctx.load_verify_locations(ca_file)
    if require_client_cert:
        ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_ssl_context(*, cert_file: str = "", key_file: str = "",
                       ca_file: str = "",
                       verify: bool = True) -> ssl.SSLContext:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    if ca_file:
        ctx.load_verify_locations(ca_file)
        ctx.check_hostname = False       # fabric certs are per host, not DNS
    elif not verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    else:
        # A bare PROTOCOL_TLS_CLIENT context trusts nothing.
        ctx.load_default_certs()
    if cert_file and key_file:
        ctx.load_cert_chain(cert_file, key_file)
    return ctx
