"""The certificate authority of the intercepting proxy: the port's copy of
``dragonfly2_tpu/pkg/certify.py``, on the standard library alone (the JAX
module builds on ``cryptography``, which the card machine does not have).

The proxy answers a hijacked CONNECT (or an SNI connection) with a leaf
certificate forged for the requested host and signed by a CA the
cluster's clients trust (reference ``client/daemon/proxy/proxy.go:471``).
``CertAuthority`` loads that CA from PEM files or generates one, persists
a generated one so restarts keep the same root of trust, and forges and
caches one server context a host.

What the JAX module gets from ``cryptography`` is done here by hand:

- RSA-2048 keys with exponent 65537: primes from ``secrets``, by trial
  division then Miller-Rabin; PKCS#1 v1.5 signatures over SHA-256, by
  the Chinese remainder theorem.
- X.509 v3 in DER: the CA with BasicConstraints(ca, pathlen 0, critical)
  and KeyUsage(digital signature, cert sign, CRL sign, critical); a leaf
  with CN = ``hostname[:64]``, a SAN that is the host's IP address or DNS
  name, and the serverAuth extended key usage. Validity runs from a day
  before now to 397 days on (3650 for the CA), in UTCTime before 2050
  (RFC 5280 §4.1.2.5). Serial numbers are 159 random bits.
- PEM out as ``RSA PRIVATE KEY`` (PKCS#1) and ``CERTIFICATE``, which
  ``ssl.SSLContext.load_cert_chain`` reads.
- A small DER reader: the CA certificate's subject (copied verbatim as
  every leaf's issuer) and an RSA private key in PKCS#1 or PKCS#8.

Intended divergence: an encrypted CA key, or one that is not RSA, is
refused with ``ValueError`` (``cryptography`` would load it).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import ipaddress
import math
import os
import re
import secrets
import ssl
import tempfile
import threading

_ONE_DAY = datetime.timedelta(days=1)
_E = 65537
_KEY_BITS = 2048

# -- DER ---------------------------------------------------------------------

_BOOLEAN, _INTEGER, _BIT_STRING, _OCTET_STRING, _NULL, _OID = (
    0x01, 0x02, 0x03, 0x04, 0x05, 0x06)
_UTF8, _UTC_TIME, _GENERALIZED_TIME = 0x0C, 0x17, 0x18
_SEQUENCE, _SET = 0x30, 0x31

_OID_CN = "2.5.4.3"
_OID_O = "2.5.4.10"
_OID_RSA = "1.2.840.113549.1.1.1"
_OID_SHA256_RSA = "1.2.840.113549.1.1.11"
_OID_BASIC_CONSTRAINTS = "2.5.29.19"
_OID_KEY_USAGE = "2.5.29.15"
_OID_SAN = "2.5.29.17"
_OID_EKU = "2.5.29.37"
_OID_SERVER_AUTH = "1.3.6.1.5.5.7.3.1"
# DigestInfo of a SHA-256 digest, less the digest (RFC 8017 §9.2 note 1).
_SHA256_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def _tlv(tag: int, value: bytes) -> bytes:
    n = len(value)
    if n < 0x80:
        return bytes((tag, n)) + value
    size = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes((tag, 0x80 | len(size))) + size + value


def _seq(*items: bytes) -> bytes:
    return _tlv(_SEQUENCE, b"".join(items))


def _int(v: int) -> bytes:
    # Two's complement, minimal: a positive value whose top bit is set
    # gets a leading zero byte.
    return _tlv(_INTEGER, v.to_bytes(v.bit_length() // 8 + 1, "big"))


def _oid(dotted: str) -> bytes:
    parts = [int(p) for p in dotted.split(".")]
    out = bytearray([40 * parts[0] + parts[1]])
    for p in parts[2:]:
        chunk = [p & 0x7F]
        while p > 0x7F:
            p >>= 7
            chunk.append(0x80 | (p & 0x7F))
        out += bytes(reversed(chunk))
    return _tlv(_OID, bytes(out))


def _explicit(n: int, value: bytes) -> bytes:
    return _tlv(0xA0 | n, value)


def _bits(value: bytes, unused: int = 0) -> bytes:
    return _tlv(_BIT_STRING, bytes((unused,)) + value)


def _name(*attrs: tuple[str, str]) -> bytes:
    """A Name, one RDN an attribute, each value a UTF8String."""
    return _seq(*(_tlv(_SET, _seq(_oid(oid), _tlv(_UTF8, value.encode())))
                  for oid, value in attrs))


def _time(t: datetime.datetime) -> bytes:
    t = t.astimezone(datetime.timezone.utc)
    if t.year < 2050:
        return _tlv(_UTC_TIME, t.strftime("%y%m%d%H%M%SZ").encode())
    return _tlv(_GENERALIZED_TIME, t.strftime("%Y%m%d%H%M%SZ").encode())


def _extension(oid: str, value: bytes, critical: bool = False) -> bytes:
    # DER leaves a DEFAULT FALSE out.
    flag = _tlv(_BOOLEAN, b"\xff") if critical else b""
    return _seq(_oid(oid), flag, _tlv(_OCTET_STRING, value))


def _read(der: bytes, pos: int = 0) -> tuple[int, int, int]:
    """(tag, start of the value, end of the value) of the TLV at pos."""
    try:
        tag, n = der[pos], der[pos + 1]
        pos += 2
        if n & 0x80:
            k = n & 0x7F
            if not 0 < k <= 4:
                raise ValueError("DER: bad length")
            n = int.from_bytes(der[pos:pos + k], "big")
            pos += k
    except IndexError:
        raise ValueError("DER: truncated") from None
    if pos + n > len(der):
        raise ValueError("DER: truncated")
    return tag, pos, pos + n


def _children(der: bytes, start: int, end: int) -> list[tuple]:
    """(tag, start of the TLV, start of its value, end) of each TLV in
    der[start:end]."""
    out = []
    while start < end:
        tag, vs, ve = _read(der, start)
        out.append((tag, start, vs, ve))
        start = ve
    return out


def _oid_text(body: bytes) -> str:
    parts, v = [body[0] // 40, body[0] % 40], 0
    for b in body[1:]:
        v = (v << 7) | (b & 0x7F)
        if not b & 0x80:
            parts.append(v)
            v = 0
    return ".".join(map(str, parts))


# -- PEM ---------------------------------------------------------------------

_PEM_RE = re.compile(rb"-----BEGIN ([A-Z0-9 ]+)-----\r?\n(.*?)-----END \1-----",
                     re.S)


def _pem(label: str, der: bytes) -> bytes:
    b64 = base64.b64encode(der)
    lines = [b64[i:i + 64] for i in range(0, len(b64), 64)]
    return (f"-----BEGIN {label}-----\n".encode() + b"\n".join(lines)
            + f"\n-----END {label}-----\n".encode())


def _unpem(pem: bytes) -> tuple[str, bytes]:
    """The first PEM block: (label, DER). Refuses an encrypted one."""
    m = _PEM_RE.search(pem)
    if m is None:
        raise ValueError("no PEM block")
    label, body = m.group(1).decode(), m.group(2)
    if b"Proc-Type:" in body or "ENCRYPTED" in label:
        raise ValueError("an encrypted private key is not supported: give "
                         "the CA key unencrypted")
    return label, base64.b64decode(b"".join(body.split()))


# -- RSA ---------------------------------------------------------------------

_SMALL_PRIMES = [p for p in range(3, 2000)
                 if all(p % d for d in range(2, math.isqrt(p) + 1))]
_SMALL_PRODUCT = math.prod(_SMALL_PRIMES)


def _probable_prime(n: int, rounds: int = 8) -> bool:
    """Miller-Rabin with random bases (error below 4^-rounds)."""
    d, s = n - 1, 0
    while not d & 1:
        d >>= 1
        s += 1
    for _ in range(rounds):
        a = 2 + secrets.randbelow(n - 3)
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _prime(bits: int) -> int:
    """A random prime of exactly ``bits`` bits, its top two bits set (so
    a product of two has twice the bits), with gcd(p - 1, e) = 1."""
    while True:
        p = secrets.randbits(bits) | (3 << (bits - 2)) | 1
        if (math.gcd(p, _SMALL_PRODUCT) == 1 and (p - 1) % _E
                and _probable_prime(p)):
            return p


class RSAKey:
    """An RSA private key with its CRT parameters."""

    def __init__(self, n: int, e: int, d: int, p: int, q: int):
        if p * q != n or n.bit_length() < 1024:
            raise ValueError("not a consistent RSA key")
        self.n, self.e, self.d, self.p, self.q = n, e, d, p, q
        self.dp, self.dq = d % (p - 1), d % (q - 1)
        self.qinv = pow(q, -1, p)

    @classmethod
    def generate(cls, bits: int = _KEY_BITS) -> "RSAKey":
        while True:
            p, q = _prime(bits // 2), _prime(bits // 2)
            if p != q:
                break
        lam = math.lcm(p - 1, q - 1)
        return cls(p * q, _E, pow(_E, -1, lam), max(p, q), min(p, q))

    def public_der(self) -> bytes:
        """SubjectPublicKeyInfo."""
        return _seq(_seq(_oid(_OID_RSA), _tlv(_NULL, b"")),
                    _bits(_seq(_int(self.n), _int(self.e))))

    def pkcs1_der(self) -> bytes:
        return _seq(*map(_int, (0, self.n, self.e, self.d, self.p, self.q,
                                self.dp, self.dq, self.qinv)))

    def sign(self, data: bytes) -> bytes:
        """PKCS#1 v1.5 over SHA-256 (RFC 8017 §8.2.1), by the CRT; the
        signature is checked with the public key before it leaves."""
        k = (self.n.bit_length() + 7) // 8
        t = _SHA256_INFO + hashlib.sha256(data).digest()
        m = int.from_bytes(b"\x00\x01" + b"\xff" * (k - len(t) - 3)
                           + b"\x00" + t, "big")
        m1, m2 = pow(m, self.dp, self.p), pow(m, self.dq, self.q)
        s = m2 + (self.qinv * (m1 - m2) % self.p) * self.q
        if pow(s, self.e, self.n) != m:
            raise ValueError("RSA signature failed its check")
        return s.to_bytes(k, "big")

    @classmethod
    def from_pem(cls, pem: bytes) -> "RSAKey":
        """A PKCS#1 ``RSA PRIVATE KEY`` or an RSA PKCS#8 ``PRIVATE KEY``."""
        label, der = _unpem(pem)
        if label == "PRIVATE KEY":
            _, vs, ve = _read(der)
            items = _children(der, vs, ve)
            if len(items) < 3:
                raise ValueError("PKCS#8: truncated")
            _, _, avs, ave = items[1]
            _, _, ovs, ove = _children(der, avs, ave)[0]
            if _oid_text(der[ovs:ove]) != _OID_RSA:
                raise ValueError("the CA key is not an RSA key")
            _, _, kvs, kve = items[2]
            der = der[kvs:kve]
        elif label != "RSA PRIVATE KEY":
            raise ValueError(f"the CA key is not an RSA key ({label})")
        _, vs, ve = _read(der)
        ints = [int.from_bytes(der[a:b], "big")
                for tag, _, a, b in _children(der, vs, ve) if tag == _INTEGER]
        if len(ints) < 6:
            raise ValueError("PKCS#1: truncated")
        _, n, e, d, p, q = ints[:6]
        return cls(n, e, d, p, q)


# -- X.509 -------------------------------------------------------------------

def _subject_der(cert_pem: bytes) -> bytes:
    """The subject Name of a certificate, as its DER bytes."""
    label, der = _unpem(cert_pem)
    if label != "CERTIFICATE":
        raise ValueError(f"not a certificate ({label})")
    _, vs, ve = _read(der)
    _, tvs, tve = _read(der, vs)                  # tbsCertificate
    fields = _children(der, tvs, tve)
    if fields and fields[0][0] == 0xA0:           # [0] version
        fields = fields[1:]
    # serialNumber, signature, issuer, validity, subject
    _, start, _, end = fields[4]
    return der[start:end]


def _certificate(subject: bytes, issuer: bytes, key: RSAKey,
                 signer: RSAKey, days: int, extensions: list[bytes]) -> bytes:
    now = datetime.datetime.now(datetime.timezone.utc)
    sig_alg = _seq(_oid(_OID_SHA256_RSA), _tlv(_NULL, b""))
    tbs = _seq(
        _explicit(0, _int(2)),                    # v3
        _int(secrets.randbits(159) or 1),
        sig_alg, issuer,
        _seq(_time(now - _ONE_DAY), _time(now + datetime.timedelta(days=days))),
        subject, key.public_der(),
        _explicit(3, _seq(*extensions)))
    return _pem("CERTIFICATE", _seq(tbs, sig_alg, _bits(signer.sign(tbs))))


class CertAuthority:
    """A CA that forges leaf certificates for arbitrary hosts."""

    def __init__(self, ca_cert_pem: bytes, ca_key_pem: bytes):
        self.ca_cert_pem = ca_cert_pem
        self.ca_key_pem = ca_key_pem
        self._issuer = _subject_der(ca_cert_pem)
        self._ca_key = RSAKey.from_pem(ca_key_pem)
        self._contexts: dict[str, ssl.SSLContext] = {}
        self._lock = threading.Lock()
        # One leaf key for every forged certificate: keygen is the costly
        # part, and the key is as trusted as the CA key in memory.
        self._leaf_key = RSAKey.generate()

    # -- construction ------------------------------------------------------

    @classmethod
    def generate(cls, common_name: str = "dragonfly2-tpu-proxy-ca",
                 valid_days: int = 3650) -> "CertAuthority":
        key = RSAKey.generate()
        name = _name((_OID_CN, common_name), (_OID_O, "dragonfly2-tpu"))
        cert = _certificate(name, name, key, key, valid_days, [
            _extension(_OID_BASIC_CONSTRAINTS, _seq(
                _tlv(_BOOLEAN, b"\xff"), _int(0)), critical=True),
            # digitalSignature (bit 0), keyCertSign (5), cRLSign (6).
            _extension(_OID_KEY_USAGE, _bits(b"\x86", unused=1),
                       critical=True)])
        return cls(cert, _pem("RSA PRIVATE KEY", key.pkcs1_der()))

    @classmethod
    def load(cls, cert_path: str, key_path: str) -> "CertAuthority":
        with open(cert_path, "rb") as f:
            cert_pem = f.read()
        with open(key_path, "rb") as f:
            key_pem = f.read()
        return cls(cert_pem, key_pem)

    @classmethod
    def load_or_generate(cls, cert_path: str = "", key_path: str = "",
                         persist_dir: str = "") -> "CertAuthority":
        """The operator's CA when paths are given; else one generated and
        persisted in ``persist_dir`` (``proxy-ca.crt``, and
        ``proxy-ca.key`` at mode 0600), so clients install it once."""
        if cert_path and key_path:
            return cls.load(cert_path, key_path)
        if persist_dir:
            cert_p = os.path.join(persist_dir, "proxy-ca.crt")
            key_p = os.path.join(persist_dir, "proxy-ca.key")
            if os.path.exists(cert_p) and os.path.exists(key_p):
                return cls.load(cert_p, key_p)
            ca = cls.generate()
            os.makedirs(persist_dir, exist_ok=True)
            with open(cert_p, "wb") as f:
                f.write(ca.ca_cert_pem)
            fd = os.open(key_p, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "wb") as f:
                f.write(ca.ca_key_pem)
            return ca
        return cls.generate()

    # -- leaf forging ------------------------------------------------------

    def forge_leaf(self, hostname: str) -> tuple[bytes, bytes]:
        """(cert_pem, key_pem) for ``hostname``, signed by the CA."""
        try:
            san = _tlv(0x87, ipaddress.ip_address(hostname).packed)
        except ValueError:
            san = _tlv(0x82, hostname.encode("ascii"))   # an A-label
        cert = _certificate(
            _name((_OID_CN, hostname[:64])), self._issuer, self._leaf_key,
            self._ca_key, 397, [
                _extension(_OID_SAN, _seq(san)),
                _extension(_OID_EKU, _seq(_oid(_OID_SERVER_AUTH)))])
        return cert, _pem("RSA PRIVATE KEY", self._leaf_key.pkcs1_der())

    def server_context(self, hostname: str) -> ssl.SSLContext:
        """A server context presenting a leaf forged for ``hostname``,
        chained with the CA's certificate; one a host, cached."""
        with self._lock:
            ctx = self._contexts.get(hostname)
        if ctx is not None:
            return ctx
        ctx = self.fresh_server_context(hostname)
        with self._lock:
            self._contexts[hostname] = ctx
        return ctx

    def fresh_server_context(self, hostname: str) -> ssl.SSLContext:
        """Uncached, for a caller that changes the context (a connection's
        own ``sni_callback``): the cached ones are shared."""
        cert_pem, key_pem = self.forge_leaf(hostname)
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
        # The chain holds the CA too, so a client that trusts only the
        # root from a bundle file can build the path.
        with tempfile.NamedTemporaryFile(suffix=".pem") as f:
            f.write(cert_pem + self.ca_cert_pem + key_pem)
            f.flush()
            ctx.load_cert_chain(f.name)
        return ctx

    def trust_context(self) -> ssl.SSLContext:
        """A client context trusting this CA and nothing else: what the
        cluster's clients use through the intercepting proxy."""
        ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
        ctx.load_verify_locations(cadata=self.ca_cert_pem.decode())
        return ctx
