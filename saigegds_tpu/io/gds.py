"""Pure-Python reader for CoreArray GDS files (gdsfmt / SeqArray).

The reference framework's entire data plane is GDS ("Genomic Data Structure",
the CoreArray container behind the gdsfmt + SeqArray R packages): genotype
inputs (`R/saige_main.r:263`, `R/assoc_single.r:69-85`) and association output
files all live in this format.  This module implements a from-scratch binary
reader for the subset of CoreArray needed by SeqArray genotype files, so the
package can ingest the same files with zero R dependency.

Format notes (reverse-engineered from the container layout):

* File = 12-byte magic ``COREARRAYx0A`` + 2-byte version + 4-byte entry word,
  then a sequence of *pieces*.  Each piece starts with a 6-byte little-endian
  size whose bit 47 marks a *head* piece.  Head pieces carry
  ``[next_pos:6][block_id:4][content_size:6]`` and start a logical block;
  continuation pieces carry ``[next_pos:6]`` and extend it.  Blocks form the
  random-access allocation layer; block 1 is the root folder.
* Node records: ``[size:6][nprops:2]`` then, for typed arrays, a 2-byte
  version and the class name stored as ``[len][7-bit packed chars]``
  (e.g. ``dBit2`` / ``dInt32`` / ``dStr8``).  Properties follow as
  ``[type_id:1][packed name][payload]``; the name encodings are stable
  across gdsfmt writers, so they are matched as opaque byte patterns.
* Compressed arrays go through a "pipe": property giving the codec name
  ("LZMA_ra"/"ZIP_ra"/...), the raw/compressed byte sizes, and the block id
  of the data stream.  LZMA_ra streams are one or more concatenated xz
  frames after a small header; we locate the first xz magic and inflate.
* Folder entries: ``[size:6][3 props]`` = child block id (u32), flags (bit 1
  = subfolder, bit 4 = hidden), and the UTF-8 name.
* Attributes: a record of ``[name_len:1][name][TdsAny]`` items where TdsAny
  is a 1-byte type code + payload (0x0e/0x11 = length-prefixed strings, ...).
"""

from __future__ import annotations

import lzma
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from . import native

GDS_MAGIC = b"COREARRAYx0A"
XZ_MAGIC = b"\xfd7zXZ\x00"
ZLIB_MAGIC = b"\x78"          # zlib CMF byte (deflate, 32K window)
_FEED_CHUNK = 1 << 20         # bounded decompressor feed size

_FRAME_MAGIC = {"xz": XZ_MAGIC, "zip": ZLIB_MAGIC}
_FRAME_ERROR = {"xz": lzma.LZMAError, "zip": zlib.error}


def _codec_of(pipe: str) -> Optional[str]:
    u = pipe.upper()
    if u.startswith("LZMA"):
        return "xz"
    if u.startswith("ZIP") or u.startswith("ZRA"):
        return "zip"
    return None


def _new_decoder(codec: str):
    if codec == "xz":
        return lzma.LZMADecompressor(format=lzma.FORMAT_XZ)
    return zlib.decompressobj()


def _decode_one_frame(raw, pos: int, codec: str):
    """Decode the single compressed frame starting at ``pos``.

    Feeds the decompressor bounded chunks from a memoryview — never a
    copy of the whole remaining buffer.  (The naive ``raw[pos:]`` slice
    per frame is O(frames x tail): ~2x350 MB of copies per frame on a
    430K-sample genotype node, ~5 MB/s; chunked feeding decodes at the
    codec's native ~180 MB/s.)

    Returns ``(payload, end_pos)`` where ``end_pos`` is the first byte
    past the frame (``len(raw)`` if the decoder never signalled eof —
    i.e. a truncated tail frame)."""
    mv = memoryview(raw)
    n = len(raw)
    dec = _new_decoder(codec)
    out = bytearray()
    p = pos
    while p < n and not dec.eof:
        chunk = mv[p : p + _FEED_CHUNK]
        p += len(chunk)
        out += dec.decompress(chunk)
    end = p - len(dec.unused_data) if dec.eof else n
    return bytes(out), end


SGRA_MAGIC = b"SGRA"   # our writer's frame table (io/gds_write.py)


def _parse_sgra(raw):
    """Parse an SGRA frame table -> (codec, raw_size, plain_frame,
    [(pos, csize)]) or None for foreign payloads.

    Payloads written by gds_write.py carry exact per-frame compressed
    sizes, so the frame index needs no decoding and frames can be
    inflated in parallel."""
    if len(raw) < 24 or raw[:4] != SGRA_MAGIC or raw[4] != 1:
        return None
    codec = "zip" if raw[5] == 0 else "xz"
    nf, plain, raw_size = struct.unpack_from("<IIQ", raw, 8)
    if len(raw) < 24 + 4 * nf:
        return None
    csizes = struct.unpack_from(f"<{nf}I", raw, 24)
    pos = 24 + 4 * nf
    entries = []
    for cs in csizes:
        entries.append((pos, cs))
        pos += cs
    return codec, raw_size, plain, entries


def _inflate_frames_parallel(raw, codec: str, entries, window: int = 8):
    """Yield each frame's payload in order, inflating up to `window`
    frames concurrently (zlib/lzma release the GIL, so a small thread
    pool scales decode across host cores)."""
    import collections
    import os
    from concurrent.futures import ThreadPoolExecutor

    mv = memoryview(raw)
    if codec == "xz":
        fn = lambda pos, cs: lzma.decompress(mv[pos : pos + cs])  # noqa: E731
    else:
        fn = lambda pos, cs: zlib.decompress(mv[pos : pos + cs])  # noqa: E731
    workers = max(1, min(4, os.cpu_count() or 1, len(entries)))
    if workers == 1 or len(entries) <= 1:
        for pos, cs in entries:
            yield fn(pos, cs)
        return
    with ThreadPoolExecutor(workers) as ex:
        futs = collections.deque()
        it = iter(entries)
        for _ in range(window):
            e = next(it, None)
            if e is None:
                break
            futs.append(ex.submit(fn, *e))
        while futs:
            f = futs.popleft()
            e = next(it, None)
            if e is not None:
                futs.append(ex.submit(fn, *e))
            yield f.result()


def _iter_frames(raw, codec: str, strict: bool = False):
    """Yield ``(frame_pos, payload)`` for each compressed frame in ``raw``.

    Frame starts are located by magic-byte scan (matching the _ra
    container layout: independently decodable frames back to back, each
    preceded by a small header).  A magic hit that fails to decode (a
    false positive inside compressed data) is skipped; with ``strict``
    a failure on the final candidate propagates."""
    magic = _FRAME_MAGIC[codec]
    err = _FRAME_ERROR[codec]
    pos = raw.find(magic)
    n = len(raw)
    while 0 <= pos < n:
        try:
            out, end = _decode_one_frame(raw, pos, codec)
        except err:
            nxt = raw.find(magic, pos + 1)
            if nxt < 0 and strict:
                raise
            pos = nxt
            continue
        yield pos, out
        pos = raw.find(magic, max(end, pos + 1))

# ---------------------------------------------------------------------------
# low-level block collection


def _u48(b: bytes, off: int) -> int:
    return int.from_bytes(b[off : off + 6], "little")


def _read_blocks(data: bytes) -> Dict[int, bytes]:
    if data[:12] != GDS_MAGIC:
        raise ValueError("not a CoreArray GDS file")
    pos = 0x12  # magic(12) + version(2) + entry word(4)
    # first pass: collect pieces by position
    piece_at: Dict[int, tuple] = {}
    while pos + 6 <= len(data):
        sz = _u48(data, pos)
        head = bool(sz >> 47)
        sz &= (1 << 47) - 1
        if sz == 0:
            break
        piece_at[pos] = (sz, head)
        pos += sz
    blocks: Dict[int, bytes] = {}
    for p, (sz, head) in piece_at.items():
        if not head:
            continue
        nxt = _u48(data, p + 6)
        bid = int.from_bytes(data[p + 12 : p + 16], "little")
        total = _u48(data, p + 16)
        buf = bytearray(data[p + 22 : p + sz])
        # follow continuation chain
        while nxt:
            if nxt not in piece_at:
                raise ValueError(f"broken piece chain at {nxt:#x}")
            csz, chead = piece_at[nxt]
            if chead:
                raise ValueError("continuation piece marked as head")
            buf += data[nxt + 12 : nxt + csz]
            nxt = _u48(data, nxt + 6)
        if len(buf) < total:
            raise ValueError(f"block {bid}: short content {len(buf)} < {total}")
        blocks[bid] = bytes(buf[:total])
    return blocks


# ---------------------------------------------------------------------------
# 7-bit packed strings (class names)


def _unpack7(b: bytes, nchars: int) -> str:
    v = int.from_bytes(b, "little")
    return "".join(chr((v >> (7 * i)) & 0x7F) for i in range(nchars))


# ---------------------------------------------------------------------------
# node records

# property name byte patterns (gdsfmt writer constants).  Keys are the raw
# bytes of [type_id][packed property name]; values say how to read payload.
_P_U8 = "u8"
_P_U16 = "u16"
_P_U32 = "u32"
_P_REC = "rec"  # [size:6 incl itself][bytes]
_P_STR = "str"  # [0x10][len:1][chars]
_P_SZPAIR = "szpair"  # [0x10][u64 raw][u64 compressed]
_P_DIMS = "dims"  # [len:1][u32 * (len/4)]
_P_SKIP2 = "skip2"

_PROPS = {
    bytes.fromhex("08c643754ef601"): ("n_children", _P_U32),
    bytes.fromhex("01c7437517e57d"): ("dir_entries", _P_REC),
    bytes.fromhex("0807f37d9d937d"): ("n_attr", _P_U32),
    bytes.fromhex("0108f37ddd45791f"): ("attr_rec", _P_REC),
    bytes.fromhex("15c4466d"): ("pipe_name", _P_STR),
    bytes.fromhex("02c9466d50e0512504"): ("pipe_sizes", _P_SZPAIR),
    bytes.fromhex("05ca466d5070412174"): ("pipe_param1", _P_SKIP2),
    bytes.fromhex("05cb466d50d0581e5542"): ("pipe_param2", _P_U8),
    bytes.fromhex("07c4e3641f"): ("ndim", _P_U16),
    bytes.fromhex("02c34361"): ("dims", _P_DIMS),
    bytes.fromhex("09c4c37c0c"): ("data_block", _P_U32),
    # folder entry props
    bytes.fromhex("0902f500"): ("entry_id", _P_U32),
    bytes.fromhex("0944743112"): ("entry_flags", _P_U32),
    bytes.fromhex("1544c66010"): ("entry_name", "estr"),  # [len:1][chars]
    # dStr8-specific: max string length property (seen on some writers)
    bytes.fromhex("02c37c61"): ("str_maxlen", _P_DIMS),
    # dPackedReal* offset & scale (f64 payloads)
    bytes.fromhex("138616451ef401"): ("real_offset", "f64"),
    bytes.fromhex("1385e7301704"): ("real_scale", "f64"),
}
_PROP_PREFIXES = sorted(_PROPS.items(), key=lambda kv: -len(kv[0]))


def _parse_props(buf: bytes, pos: int, end: int) -> dict:
    """Parse a property region by longest-prefix matching the catalog."""
    out: dict = {}
    while pos < end:
        for pat, (name, kind) in _PROP_PREFIXES:
            if buf[pos : pos + len(pat)] == pat:
                pos += len(pat)
                if kind == _P_U8:
                    out[name] = buf[pos]
                    pos += 1
                elif kind == _P_U16:
                    out[name] = int.from_bytes(buf[pos : pos + 2], "little")
                    pos += 2
                elif kind == _P_U32:
                    out[name] = int.from_bytes(buf[pos : pos + 4], "little")
                    pos += 4
                elif kind == "f64":
                    out[name] = struct.unpack("<d", buf[pos : pos + 8])[0]
                    pos += 8
                elif kind == _P_REC:
                    sz = _u48(buf, pos)
                    out[name] = buf[pos + 6 : pos + sz]
                    pos += sz
                elif kind == _P_STR:
                    assert buf[pos] == 0x10, f"string marker {buf[pos]:#x}"
                    n = buf[pos + 1]
                    out[name] = buf[pos + 2 : pos + 2 + n].decode("utf-8")
                    pos += 2 + n
                elif kind == "estr":
                    n = buf[pos]
                    out[name] = buf[pos + 1 : pos + 1 + n].decode("utf-8")
                    pos += 1 + n
                elif kind == _P_SZPAIR:
                    assert buf[pos] == 0x10
                    out["raw_size"] = int.from_bytes(buf[pos + 1 : pos + 9], "little")
                    out["cmp_size"] = int.from_bytes(buf[pos + 9 : pos + 17], "little")
                    pos += 17
                elif kind == _P_DIMS:
                    n = buf[pos]
                    vals = [
                        int.from_bytes(buf[pos + 1 + 4 * i : pos + 5 + 4 * i], "little")
                        for i in range(n // 4)
                    ]
                    out[name] = vals
                    pos += 1 + n
                elif kind == _P_SKIP2:
                    out[name] = buf[pos : pos + 2]
                    pos += 2
                break
        else:
            raise ValueError(
                f"unknown GDS node property at +{pos}: "
                f"{buf[pos:pos+16].hex(' ')} (please extend _PROPS)"
            )
    return out


def _parse_attrs(rec: bytes) -> dict:
    """Attribute record: sequence of [name_len:1][name][TdsAny value]."""
    out = {}
    pos = 0
    while pos < len(rec):
        n = rec[pos]
        name = rec[pos + 1 : pos + 1 + n].decode("utf-8")
        pos += 1 + n
        t = rec[pos]
        pos += 1
        if t == 0:  # NULL
            val = None
        elif t in (0x0E, 0x11):  # length-prefixed UTF-8 string
            m = rec[pos]
            val = rec[pos + 1 : pos + 1 + m].decode("utf-8")
            pos += 1 + m
        elif t in (1, 2):  # int8/uint8
            val = rec[pos]
            pos += 1
        elif t in (3, 4):
            val = int.from_bytes(rec[pos : pos + 2], "little")
            pos += 2
        elif t in (5, 6):
            val = int.from_bytes(rec[pos : pos + 4], "little")
            pos += 4
        elif t in (7, 8):
            val = int.from_bytes(rec[pos : pos + 8], "little")
            pos += 8
        elif t == 0x12:  # float64
            val = struct.unpack("<d", rec[pos : pos + 8])[0]
            pos += 8
        elif t == 0x13:  # bool?
            val = bool(rec[pos])
            pos += 1
        elif t == 0x21:  # array of TdsAny: [count:4][items]
            cnt = int.from_bytes(rec[pos : pos + 4], "little")
            pos += 4
            val, pos = _parse_any_list(rec, pos, cnt)
        else:
            raise ValueError(f"unknown TdsAny type {t:#x} for attribute {name!r}")
        out[name] = val
    return out


def _parse_any_list(rec: bytes, pos: int, cnt: int):
    vals = []
    for _ in range(cnt):
        t = rec[pos]
        pos += 1
        if t in (0x0E, 0x11):
            m = rec[pos]
            vals.append(rec[pos + 1 : pos + 1 + m].decode("utf-8"))
            pos += 1 + m
        elif t in (1, 2):
            vals.append(rec[pos]); pos += 1
        elif t in (5, 6):
            vals.append(int.from_bytes(rec[pos : pos + 4], "little")); pos += 4
        elif t == 0x12:
            vals.append(struct.unpack("<d", rec[pos : pos + 8])[0]); pos += 8
        elif t == 0:
            vals.append(None)
        else:
            raise ValueError(f"unknown TdsAny array item type {t:#x}")
    return vals, pos


@dataclass
class GDSNode:
    name: str
    bid: int
    is_folder: bool
    hidden: bool = False
    cls: str = ""
    dims: List[int] = field(default_factory=list)
    attrs: dict = field(default_factory=dict)
    children: "Dict[str, GDSNode]" = field(default_factory=dict)
    _file: "Optional[GDSFile]" = None
    _props: dict = field(default_factory=dict)

    def __getitem__(self, path: str) -> "GDSNode":
        node = self
        for part in path.split("/"):
            node = node.children[part]
        return node

    def get(self, path: str) -> "Optional[GDSNode]":
        try:
            return self[path]
        except KeyError:
            return None

    def ls(self):
        return list(self.children)

    def read(self) -> np.ndarray:
        return self._file._read_array(self)

    def __repr__(self):
        kind = "folder" if self.is_folder else self.cls
        return f"GDSNode({self.name!r}, {kind}, dims={self.dims})"


class GDSFile:
    """A read-only CoreArray GDS file (SeqArray-compatible subset)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self._blocks = _read_blocks(data)
        self.root = self._parse_node(1, "", is_folder=True)

    # -- node parsing --

    def _parse_node(self, bid: int, name: str, is_folder: bool, hidden=False) -> GDSNode:
        buf = self._blocks[bid]
        size = _u48(buf, 0)
        nprops = int.from_bytes(buf[6:8], "little")
        pos = 8
        cls = ""
        if not is_folder:
            # [version:2][classname len:1][packed chars]
            pos += 2
            n = buf[pos]
            nbytes = (7 * n + 7) // 8
            cls = _unpack7(buf[pos + 1 : pos + 1 + nbytes], n)
            pos += 1 + nbytes
        props = _parse_props(buf, pos, size)
        node = GDSNode(name=name, bid=bid, is_folder=is_folder, hidden=hidden,
                       cls=cls, _file=self, _props=props)
        if "dims" in props:
            node.dims = props["dims"]
        if "attr_rec" in props:
            node.attrs = _parse_attrs(props["attr_rec"])
        if "dir_entries" in props:
            ents = props["dir_entries"]
            epos = 0
            while epos < len(ents):
                esz = _u48(ents, epos)
                ep = _parse_props(ents, epos + 8, epos + esz)
                epos += esz
                child_folder = bool(ep.get("entry_flags", 0) & 0x2)
                child_hidden = bool(ep.get("entry_flags", 0) & 0x10)
                child = self._parse_node(
                    ep["entry_id"], ep.get("entry_name", "?"),
                    is_folder=child_folder, hidden=child_hidden)
                node.children[child.name] = child
        return node

    # -- data decoding --

    def _raw_stream(self, node: GDSNode) -> bytes:
        props = node._props
        if "data_block" not in props:
            return b""
        raw = self._blocks[props["data_block"]]
        pipe = props.get("pipe_name", "")
        want = props.get("raw_size")
        sg = _parse_sgra(raw)
        if sg is not None:                    # our frame table: parallel
            codec, raw_size, _, entries = sg
            out = bytearray()
            stop = raw_size if want is None else want
            for payload in _inflate_frames_parallel(raw, codec, entries):
                out += payload
                if len(out) >= stop:
                    break
            return bytes(out[:stop])
        if pipe.upper().startswith("LZMA"):
            return _inflate_xz_ra(raw, want)
        if pipe.upper().startswith("ZIP") or pipe.upper().startswith("ZRA"):
            return _inflate_zip_ra(raw, want)
        if pipe:
            raise NotImplementedError(f"GDS pipe codec {pipe!r}")
        return raw

    def frame_index(self, node: GDSNode):
        """[(raw_pos, decompressed_start)] for LZMA_ra/ZIP_ra frames, or None.

        Built once per node by decompressing each frame (the _ra container
        stores no plaintext sizes we parse, so sizes come from one linear
        indexing pass); enables random access without inflating the whole
        node on every read.
        """
        props = node._props
        cache = props.get("_frame_index")
        if cache is not None:
            return cache
        codec = _codec_of(props.get("pipe_name", ""))
        if codec is None or "data_block" not in props:
            return None
        raw = self._blocks[props["data_block"]]
        sg = _parse_sgra(raw)
        if sg is not None:                    # exact, no decoding needed
            _, _, plain, entries = sg
            index = [(pos, i * plain) for i, (pos, _) in enumerate(entries)]
        else:
            index = []
            out_off = 0
            for pos, payload in _iter_frames(raw, codec):
                index.append((pos, out_off))
                out_off += len(payload)
        props["_frame_index"] = index
        return index

    _FRAME_CACHE_SLOTS = 32

    def _inflate_frame(self, node: GDSNode, fi: int) -> bytes:
        """Inflate one compressed frame, LRU-cached (overlapping
        random-access reads — e.g. sliding windows — hit the cache
        instead of re-inflating)."""
        cache = self.__dict__.setdefault("_frame_cache", {})
        key = (id(node), fi)
        hit = cache.pop(key, None)
        if hit is not None:
            cache[key] = hit              # re-insert = most recent
            return hit
        raw = self._blocks[node._props["data_block"]]
        index = node._props["_frame_index"]
        codec = _codec_of(node._props.get("pipe_name", ""))
        data, _ = _decode_one_frame(raw, index[fi][0], codec)
        cache[key] = data
        while len(cache) > self._FRAME_CACHE_SLOTS:
            cache.pop(next(iter(cache)))
        return data

    def read_node_bytes(self, node: GDSNode, start: int, stop: int) -> bytes:
        """Random-access byte range of a node's decompressed payload.

        Uses the frame index to inflate only the covering LZMA frames
        (LRU-cached); falls back to a full inflate for other codecs.
        """
        index = self.frame_index(node)
        if not index:
            return self._raw_stream(node)[start:stop]
        # first frame whose decompressed start is <= start (the starts
        # list is immutable once the index exists — cache it: per-row
        # random access calls this once per row)
        import bisect
        starts = node._props.get("_frame_starts")
        if starts is None:
            starts = [d for _, d in index]
            node._props["_frame_starts"] = starts
        f0 = max(bisect.bisect_right(starts, start) - 1, 0)
        out = bytearray()
        off = index[f0][1]
        for fi in range(f0, len(index)):
            if off >= stop:
                break
            data = self._inflate_frame(node, fi)
            out += data
            off += len(data)
        lo = start - index[f0][1]
        return bytes(out[lo : lo + (stop - start)])

    def stream_node_bytes(self, node: GDSNode, chunk_hint: int = 1 << 22):
        """Yield the node's decompressed payload incrementally.

        LZMA_ra/ZIP_ra containers hold independently-decodable frames, so
        large genotype nodes stream frame-by-frame instead of inflating
        the whole array (the basis of out-of-core block iteration)."""
        props = node._props
        if "data_block" not in props:
            return
        raw = self._blocks[props["data_block"]]
        pipe = props.get("pipe_name", "")
        want = props.get("raw_size")
        produced = 0
        codec = _codec_of(pipe)
        sg = _parse_sgra(raw)
        if sg is not None:                    # our frame table: parallel
            codec, raw_size, _, entries = sg
            if want is None:
                want = raw_size
        if codec is not None:
            frames = _inflate_frames_parallel(raw, codec, sg[3]) \
                if sg is not None else \
                (out for _, out in _iter_frames(raw, codec, strict=True))
            for out in frames:
                if want is not None and produced + len(out) > want:
                    out = out[: want - produced]
                if out:
                    produced += len(out)
                    yield out
                if want is not None and produced >= want:
                    break
        elif pipe:
            raise NotImplementedError(f"GDS pipe codec {pipe!r}")
        else:
            for s in range(0, len(raw), chunk_hint):
                yield raw[s : s + chunk_hint]

    def _read_array(self, node: GDSNode) -> np.ndarray:
        data = self._raw_stream(node)
        dims = tuple(node.dims)
        n = int(np.prod(dims)) if dims else 0
        cls = node.cls
        fixed = decode_fixed(node, data, n)
        if fixed is not None:
            return fixed.reshape(dims)
        if cls == "dBit1":
            bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8),
                                 bitorder="little")
            return bits[:n].reshape(dims)
        if cls == "dBit2":
            return native.unpack_bit2(data, n).reshape(dims)
        if cls in ("dStr8", "dVStr8"):
            # variable-length strings, LEB128 length prefix per element
            return native.vstr8_strings(data, n).reshape(dims)
        if cls == "dCStr8":  # NUL-terminated strings
            parts = data.split(b"\x00")
            arr = np.empty(n, dtype=object)
            for i in range(n):
                arr[i] = parts[i].decode("utf-8", errors="replace")
            return arr.reshape(dims)
        if cls in ("dFStr8",):  # fixed-width strings
            props = node._props
            width = (props.get("str_maxlen") or [1])[0]
            arr = np.empty(n, dtype=object)
            for i in range(n):
                s = data[i * width : (i + 1) * width]
                arr[i] = s.rstrip(b"\x00").decode("utf-8", errors="replace")
            return arr.reshape(dims)
        raise NotImplementedError(f"GDS array class {cls!r}")


_FIXED_NBYTES = {"dInt8": 1, "dUInt8": 1, "dInt16": 2, "dUInt16": 2,
                 "dInt32": 4, "dUInt32": 4, "dInt64": 8, "dUInt64": 8,
                 "dFloat32": 4, "dFloat64": 8}
_FIXED_DTYPES = {"dInt8": np.int8, "dUInt8": np.uint8,
                 "dInt16": "<i2", "dUInt16": "<u2",
                 "dInt32": "<i4", "dUInt32": "<u4",
                 "dInt64": "<i8", "dUInt64": "<u8",
                 "dFloat32": "<f4", "dFloat64": "<f8"}


def element_nbytes(node: GDSNode):
    """Bytes per element for fixed-width array classes, else None.

    The basis of random-access block decoding: for these classes a row
    range of an [M, ...] node is a contiguous byte range of the
    decompressed payload (served frame-by-frame by ``read_node_bytes``).
    """
    cls = node.cls
    if cls in _FIXED_NBYTES:
        return _FIXED_NBYTES[cls]
    if cls.startswith("dPackedReal"):
        spec = cls[len("dPackedReal"):]
        width = int("".join(ch for ch in spec if ch.isdigit())) // 8
        return width if width in (1, 2, 4) else None
    return None


def decode_fixed(node: GDSNode, data: bytes, n: int):
    """Decode ``n`` fixed-width elements from a decompressed byte slice
    (1-D result; dPackedReal applies scale/offset and NaNs the NA code).
    Returns None for classes that are not fixed-width."""
    cls = node.cls
    if cls in _FIXED_DTYPES:
        return np.frombuffer(data, dtype=_FIXED_DTYPES[cls], count=n)
    if cls.startswith("dPackedReal"):
        spec = cls[len("dPackedReal"):]
        scale = node._props.get("real_scale", 1.0)
        offset = node._props.get("real_offset", 0.0)
        width = int("".join(ch for ch in spec if ch.isdigit())) // 8
        unsigned = spec.endswith("U")
        dt = {1: "u1", 2: "<u2", 3: None, 4: "<u4"}[width] if unsigned else \
             {1: "i1", 2: "<i2", 3: None, 4: "<i4"}[width]
        if dt is None:
            raise NotImplementedError(cls)
        raw_ints = np.frombuffer(data, dtype=dt, count=n)
        na_code = (1 << (8 * width)) - 1 if unsigned \
            else -(1 << (8 * width - 1))
        out = raw_ints.astype(np.float64) * scale + offset
        out[raw_ints == na_code] = np.nan
        return out
    return None


def read_bit2_dosage(node: GDSNode) -> np.ndarray:
    """Fused decode of a [M, N, ploidy] dBit2 genotype node into [M, N]
    int8 ALT dosage codes (3 = missing), without materializing the
    unpacked allele array (native path when built)."""
    if node.cls != "dBit2":
        raise ValueError(f"expected a dBit2 node, got {node.cls!r}")
    dims = tuple(node.dims)
    if len(dims) != 3:
        raise ValueError(f"expected [M, N, ploidy] dims, got {dims}")
    M, N, ploidy = dims
    data = node._file._raw_stream(node)
    return native.bit2_dosage_codes(data, M * N, ploidy).reshape(M, N)


def _inflate_xz_ra(raw: bytes, want: Optional[int]) -> bytes:
    """LZMA_ra: small header then one or more concatenated xz frames."""
    if raw.find(XZ_MAGIC) < 0:
        if want in (None, 0):
            return b""
        raise ValueError("LZMA_ra stream without xz frame")
    out = bytearray()
    for _, payload in _iter_frames(raw, "xz", strict=True):
        out += payload
        if want is not None and len(out) >= want:
            break
    if want is not None and len(out) < want:
        raise ValueError(f"LZMA_ra: inflated {len(out)} < expected {want}")
    return bytes(out[:want]) if want is not None else bytes(out)


def _inflate_zip_ra(raw: bytes, want: Optional[int]) -> bytes:
    """ZIP_ra: header then one or more concatenated zlib streams."""
    # header mirrors XZ_RA: magic(5) + 2 + 1 + u32 + u48
    out = bytearray()
    for _, payload in _iter_frames(raw, "zip"):
        out += payload
        if want is not None and len(out) >= want:
            break
    if want is not None and len(out) < want:
        raise ValueError(f"ZIP_ra: inflated {len(out)} < expected {want}")
    return bytes(out[:want]) if want is not None else bytes(out)


def open_gds(path: str) -> GDSFile:
    return GDSFile(path)
