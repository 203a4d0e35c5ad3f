"""Tar-shard indexing for the dataset plane: the port's copy of
``dragonfly2_tpu/dataset/tar_index.py``.

WebDataset-style training data ships as plain tar shards (Aizman et al.,
*High-Performance I/O for Large-Scale Deep Learning*): samples are groups
of adjacent files sharing a basename key (``000123.jpg`` + ``000123.cls``).
Random access into a shard therefore needs exactly one thing: a map from
sample key to the byte spans of its members. This module builds that map
with a single streaming pass over the shard (``TarIndexer`` consumes
chunks as they arrive — it never buffers file data, only header blocks),
and serializes it compactly so the index itself can live as a P2P object:
one host pays the header walk, every other host fetches a few KB
(``fetch_or_build_index``). Its index JSON is the JAX package's, byte for
byte.

Handled tar dialects: ustar name+prefix, GNU long name ('L') / long link
('K') extensions, pax extended headers ('x' per-file, 'g' global), links,
and header-checksum validation. Truncation is a TYPED failure
(``TruncatedShardError``) — a shard cut mid-member must never silently
yield partial samples — while a shard that merely ends without the
end-of-archive zero blocks or without the final data block's 512-byte
padding indexes fine (both occur in the wild).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

from dragonfly2_tpu_torch.client.dfstore import DfstoreError
from dragonfly2_tpu_torch.pkg import dflog, metrics

log = dflog.get("dataset.tar_index")

BLOCK = 512
INDEX_VERSION = 1
# Hidden bucket prefix for cached shard indexes (kept out of normal
# listings' way; same bucket as the shard so ACL/lifecycle follow it).
INDEX_PREFIX = ".dfidx/"

INDEX_FETCHES = metrics.counter(
    "dataset_index_total",
    "Shard index resolutions by outcome", ("result",))

# Typeflags whose member body is file data. POSIX says link/dir/device
# sizes are to be ignored; unknown flags are treated as regular files for
# forward compatibility (same rule as Python's tarfile).
_REGTYPES = ("0", "\0", "7")
_LINKTYPES = ("1", "2")
_NODATA_TYPES = ("1", "2", "3", "4", "5", "6")


class TarIndexError(Exception):
    """Malformed tar content (bad checksum, bogus field, corrupt pax)."""


class TruncatedShardError(TarIndexError):
    """The shard ends mid-member: indexing it would drop samples."""


@dataclass(frozen=True)
class TarMember:
    name: str
    offset: int        # offset of the member's header block
    data_offset: int   # offset of the member's first data byte
    size: int          # data bytes (0 for links)
    typeflag: str = "0"
    linkname: str = ""


@dataclass(frozen=True)
class Sample:
    """One webdataset sample: the members sharing a basename key."""

    key: str
    parts: tuple[tuple[str, int], ...]   # (extension, member index), tar order


@dataclass
class ShardIndex:
    shard: str                 # object key (or url) this index describes
    size: int                  # total shard bytes walked
    members: list[TarMember]
    samples: list[Sample]
    links: list[TarMember] = field(default_factory=list)
    version: int = INDEX_VERSION

    @property
    def num_samples(self) -> int:
        return len(self.samples)

    def sample(self, i: int) -> Sample:
        return self.samples[i]

    def members_of(self, sample: Sample,
                   extensions=None) -> list[tuple[str, TarMember]]:
        """(extension, member) pairs of a sample, optionally filtered to
        ``extensions``; unknown requested extensions are simply absent."""
        out = []
        for ext, mi in sample.parts:
            if extensions is not None and ext not in extensions:
                continue
            out.append((ext, self.members[mi]))
        return out

    # -- serialization (the P2P-cached form) -------------------------------

    def to_json_bytes(self) -> bytes:
        doc = {
            "v": self.version,
            "shard": self.shard,
            "size": self.size,
            "members": [[m.name, m.offset, m.data_offset, m.size]
                        for m in self.members],
            "samples": [[s.key, [[e, i] for e, i in s.parts]]
                        for s in self.samples],
            "links": [[m.name, m.offset, m.typeflag, m.linkname]
                      for m in self.links],
        }
        return json.dumps(doc, separators=(",", ":")).encode()

    @classmethod
    def from_json_bytes(cls, raw: bytes) -> "ShardIndex":
        try:
            doc = json.loads(raw)
            if doc["v"] != INDEX_VERSION:
                raise TarIndexError(f"index version {doc['v']} unsupported")
            members = [TarMember(name=n, offset=o, data_offset=d, size=s)
                       for n, o, d, s in doc["members"]]
            samples = [Sample(key=k, parts=tuple((e, int(i)) for e, i in p))
                       for k, p in doc["samples"]]
            links = [TarMember(name=n, offset=o, data_offset=0, size=0,
                               typeflag=t, linkname=ln)
                     for n, o, t, ln in doc.get("links", [])]
            idx = cls(shard=doc["shard"], size=int(doc["size"]),
                      members=members, samples=samples, links=links)
        except TarIndexError:
            raise
        except Exception as e:
            raise TarIndexError(f"corrupt shard index: {e}") from e
        for s in idx.samples:
            for _, mi in s.parts:
                if not 0 <= mi < len(members):
                    raise TarIndexError(
                        f"index sample {s.key!r} references member {mi} "
                        f"of {len(members)}")
        return idx


# -- header field parsing ----------------------------------------------------

def _field_str(b: bytes) -> str:
    return b.split(b"\0", 1)[0].decode("utf-8", "surrogateescape")

def _field_num(b: bytes, what: str, offset: int) -> int:
    if b and b[0] & 0x80:
        # GNU base-256: leading bit flags a big-endian binary number.
        return int.from_bytes(b, "big") - (0x80 << (8 * (len(b) - 1)))
    s = b.split(b"\0", 1)[0].strip(b" \0")
    if not s:
        return 0
    try:
        return int(s, 8)
    except ValueError as e:
        raise TarIndexError(
            f"bad {what} field at offset {offset}: {b!r}") from e


def _checksum_ok(block: bytes) -> bool:
    raw = block[148:156]
    s = raw.split(b"\0", 1)[0].strip(b" \0")
    try:
        want = int(s, 8)
    except ValueError:
        return False
    unsigned = sum(block) - sum(raw) + 8 * 0x20
    # Some ancient writers summed signed chars; accept both.
    signed = unsigned - 256 * sum(1 for c in block if c > 127) \
        + 256 * sum(1 for c in raw if c > 127)
    return want in (unsigned, signed)


def _parse_pax(data: bytes, offset: int) -> dict[str, str]:
    """pax records: ``<decimal len> <key>=<value>\\n`` — len counts the
    whole record including itself and the newline."""
    out: dict[str, str] = {}
    pos = 0
    while pos < len(data):
        try:
            sp = data.index(b" ", pos)
            length = int(data[pos:sp])
            if length <= 0 or pos + length > len(data):
                raise ValueError(f"record length {length}")
            record = data[pos:pos + length]
            if not record.endswith(b"\n"):
                raise ValueError("record missing newline")
            k, sep, v = record[sp - pos + 1:-1].partition(b"=")
            if not sep:
                raise ValueError("record missing '='")
            out[k.decode()] = v.decode("utf-8", "surrogateescape")
            pos += length
        except (ValueError, UnicodeDecodeError) as e:
            raise TarIndexError(
                f"corrupt pax header at offset {offset}: {e}") from e
    return out


# -- sample grouping ---------------------------------------------------------

def group_samples(members: list[TarMember]) -> list[Sample]:
    """Webdataset grouping: key = dirname + basename-up-to-first-dot;
    extension = everything after the first dot. Members keep tar order;
    sample order is first appearance of the key; a duplicated extension
    within one key keeps the first occurrence."""
    parts: dict[str, list[tuple[str, int]]] = {}
    order: list[str] = []
    for i, m in enumerate(members):
        slash = m.name.rfind("/")
        base = m.name[slash + 1:]
        stem, _, ext = base.partition(".")
        if not stem:
            continue   # dotfiles / metadata are not sample parts
        key = m.name[:slash + 1] + stem
        if key not in parts:
            parts[key] = []
            order.append(key)
        if any(e == ext for e, _ in parts[key]):
            continue
        parts[key].append((ext, i))
    return [Sample(key=k, parts=tuple(parts[k])) for k in order]


# -- the incremental indexer -------------------------------------------------

class TarIndexer:
    """Single-pass streaming tar header walk. ``feed()`` arbitrary chunks
    (any split), then ``finish()`` for the ShardIndex. File data is never
    buffered — only 512-byte header blocks and GNU/pax extension payloads
    are captured; everything else adjusts skip counters."""

    _HEADER = "header"

    def __init__(self):
        self._consumed = 0
        self._pend = bytearray()
        self._need = BLOCK
        self._capture = self._HEADER      # or the extension typeflag
        self._ext_size = 0
        self._skip_data = 0
        self._skip_pad = 0
        self._zero_blocks = 0
        self._done = False
        self._next_name: str | None = None
        self._next_link: str | None = None
        self._pax_next: dict[str, str] = {}
        self._pax_global: dict[str, str] = {}
        self._pending_override = False
        self.members: list[TarMember] = []
        self.links: list[TarMember] = []

    def feed(self, chunk: bytes) -> None:
        mv = memoryview(chunk)
        i, n = 0, len(chunk)
        while i < n:
            if self._done:
                # Trailing blocking-factor padding after end-of-archive.
                self._consumed += n - i
                return
            if self._skip_data:
                take = min(self._skip_data, n - i)
                self._skip_data -= take
                self._consumed += take
                i += take
                continue
            if self._skip_pad:
                take = min(self._skip_pad, n - i)
                self._skip_pad -= take
                self._consumed += take
                i += take
                continue
            take = min(self._need - len(self._pend), n - i)
            self._pend += mv[i:i + take]
            self._consumed += take
            i += take
            if len(self._pend) == self._need:
                block = bytes(self._pend)
                self._pend.clear()
                if self._capture == self._HEADER:
                    self._on_header(block)
                else:
                    self._on_extension(block)

    def finish(self, shard: str = "") -> ShardIndex:
        """Validate the end state and build the index. Tolerated endings: clean
        end-of-archive marker, EOF at a member boundary (no zero blocks),
        EOF with only the final data block's padding missing. Anything
        else is a truncation."""
        if not self._done:
            if self._pend or self._capture != self._HEADER:
                raise TruncatedShardError(
                    f"shard truncated mid-{'header' if self._capture == self._HEADER else 'extension'}"
                    f" at offset {self._consumed}")
            if self._skip_data:
                raise TruncatedShardError(
                    f"shard truncated: {self._skip_data} data bytes missing "
                    f"at offset {self._consumed}")
            if self._pending_override:
                raise TruncatedShardError(
                    "shard truncated: extension header without its member")
        return ShardIndex(shard=shard, size=self._consumed,
                          members=self.members,
                          samples=group_samples(self.members),
                          links=self.links)

    # -- internals ---------------------------------------------------------

    def _on_header(self, block: bytes) -> None:
        off = self._consumed - BLOCK
        if block.count(0) == BLOCK:
            self._zero_blocks += 1
            if self._zero_blocks >= 2:
                self._done = True
            return
        if self._zero_blocks:
            raise TarIndexError(f"lone zero block at offset {off - BLOCK}")
        if not _checksum_ok(block):
            raise TarIndexError(f"bad header checksum at offset {off}")
        typeflag = chr(block[156]) or "0"
        size = _field_num(block[124:136], "size", off)
        if size < 0:
            raise TarIndexError(f"negative size at offset {off}")
        if typeflag in ("L", "K", "x", "g"):
            if size > (1 << 24):
                raise TarIndexError(
                    f"implausible {size}-byte extension header at {off}")
            self._capture = typeflag
            self._ext_size = size
            self._need = size + ((-size) % BLOCK)
            if self._need == 0:
                # Zero-length extension: process immediately (degenerate
                # but legal — an empty pax record set).
                self._capture = self._HEADER
                self._need = BLOCK
            return
        self._on_member(block, off, typeflag, size)

    def _on_member(self, block: bytes, off: int, typeflag: str,
                   size: int) -> None:
        pax = {**self._pax_global, **self._pax_next}
        name = pax.get("path")
        if name is None:
            name = self._next_name
        if name is None:
            name = _field_str(block[0:100])
            prefix = (_field_str(block[345:500])
                      if block[257:262] == b"ustar" else "")
            if prefix:
                name = f"{prefix}/{name}"
        linkname = pax.get("linkpath")
        if linkname is None:
            linkname = self._next_link
        if linkname is None:
            linkname = _field_str(block[157:257])
        if "size" in pax:
            try:
                size = int(pax["size"])
            except ValueError as e:
                raise TarIndexError(
                    f"bad pax size at offset {off}: {pax['size']!r}") from e
        data = 0 if typeflag in _NODATA_TYPES else size
        if typeflag in _REGTYPES:
            self.members.append(TarMember(
                name=name, offset=off, data_offset=off + BLOCK, size=size,
                typeflag="0" if typeflag == "\0" else typeflag))
        elif typeflag in _LINKTYPES:
            self.links.append(TarMember(
                name=name, offset=off, data_offset=off + BLOCK, size=0,
                typeflag=typeflag, linkname=linkname))
        self._skip_data = data
        self._skip_pad = (-data) % BLOCK
        self._next_name = self._next_link = None
        self._pax_next = {}
        self._pending_override = False

    def _on_extension(self, block: bytes) -> None:
        off = self._consumed - self._need
        data = block[: self._ext_size]
        kind = self._capture
        self._capture = self._HEADER
        self._need = BLOCK
        if kind == "L":
            self._next_name = data.rstrip(b"\0").decode(
                "utf-8", "surrogateescape")
            self._pending_override = True
        elif kind == "K":
            self._next_link = data.rstrip(b"\0").decode(
                "utf-8", "surrogateescape")
            self._pending_override = True
        elif kind == "x":
            self._pax_next.update(_parse_pax(data, off))
            self._pending_override = True
        else:   # 'g'
            self._pax_global.update(_parse_pax(data, off))


def index_tar_bytes(data: bytes, shard: str = "") -> ShardIndex:
    """Index an in-memory shard (tests, local files)."""
    ix = TarIndexer()
    ix.feed(data)
    return ix.finish(shard)


# -- P2P-cached index lifecycle ----------------------------------------------

def index_object_key(shard_key: str) -> str:
    return f"{INDEX_PREFIX}{shard_key}.json"


async def fetch_or_build_index(store, bucket: str, shard_key: str, *,
                               publish: bool = True) -> ShardIndex:
    """The pod-wide index contract: try the cached index object first
    (computed once, fetched everywhere); on miss, stream the shard ONE
    pass through the indexer — which also warms this host's piece store
    with the shard it is about to consume — and publish the result back
    as a P2P object (best effort; hosts racing to build it converge on
    identical bytes). A cached index whose recorded size disagrees with
    the shard's current length is stale (shard replaced in place) and is
    rebuilt."""
    meta = await store.stat_object(bucket, shard_key)   # missing shard raises
    try:
        raw = await store.get_object(bucket, index_object_key(shard_key))
        idx = ShardIndex.from_json_bytes(raw)
        if idx.shard == shard_key and idx.size == meta.content_length:
            INDEX_FETCHES.labels("hit").inc()
            return idx
        log.info("cached shard index stale; rebuilding", shard=shard_key,
                 cached=idx.size, actual=meta.content_length)
        INDEX_FETCHES.labels("stale").inc()
    except DfstoreError:
        pass
    except TarIndexError as e:
        log.warning("cached shard index corrupt; rebuilding",
                    shard=shard_key, error=str(e)[:200])
        INDEX_FETCHES.labels("corrupt").inc()
    ix = TarIndexer()
    async for chunk in await store.stream_object(bucket, shard_key):
        ix.feed(chunk)
    idx = ix.finish(shard_key)
    INDEX_FETCHES.labels("built").inc()
    if publish:
        try:
            await store.put_object(bucket, index_object_key(shard_key),
                                   idx.to_json_bytes())
        except DfstoreError as e:
            log.warning("shard index publish failed (non-fatal)",
                        shard=shard_key, error=str(e)[:200])
    return idx
