"""Minimal CoreArray GDS writer (SAIGE_OUTPUT association results).

The reference writes association tables to GDS containers with
``FileFormat="SAIGE_OUTPUT"`` / ``"SAIGE_OUTPUT_SET"`` (R/assoc_single.r:252,
R/assoc_aggregate.r:206) and reads them back via ``seqSAIGE_LoadPval``.
This writer emits the same container layout our reader (``io/gds.py``)
parses: array nodes under a root folder, one block per node, raw or
LZMA_ra-compressed (independently-decodable xz frames).  Supported column
classes: dInt32, dFloat64, dVStr8 (LEB128 strings).

The byte-level property patterns mirror the constants reverse-engineered in
``io/gds.py`` (_PROPS) — write what we can read.
"""

from __future__ import annotations

import struct
from typing import Dict, List

import numpy as np

GDS_MAGIC = b"COREARRAYx0A"


def _u48(v: int) -> bytes:
    return int(v).to_bytes(6, "little")


def _pack7(name: str) -> bytes:
    """[len:1] + 7-bit packed chars (inverse of gds.py _unpack7)."""
    v = 0
    for i, ch in enumerate(name):
        v |= (ord(ch) & 0x7F) << (7 * i)
    nbytes = (7 * len(name) + 7) // 8
    return bytes([len(name)]) + v.to_bytes(nbytes, "little")


# property tag bytes (see io/gds.py _PROPS)
_P_NCHILD = bytes.fromhex("08c643754ef601")
_P_DIRENT = bytes.fromhex("01c7437517e57d")
_P_NATTR = bytes.fromhex("0807f37d9d937d")
_P_ATTR = bytes.fromhex("0108f37ddd45791f")
_P_NDIM = bytes.fromhex("07c4e3641f")
_P_DIMS = bytes.fromhex("02c34361")
_P_DATABLK = bytes.fromhex("09c4c37c0c")
_P_EID = bytes.fromhex("0902f500")
_P_EFLAG = bytes.fromhex("0944743112")
_P_ENAME = bytes.fromhex("1544c66010")


def _tds_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return bytes([0x0E, len(b)]) + b


def _attr_rec(attrs: Dict[str, str]) -> bytes:
    out = bytearray()
    for k, v in attrs.items():
        kb = k.encode("utf-8")
        out += bytes([len(kb)]) + kb + _tds_str(v)
    return bytes(out)


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode_column(arr: np.ndarray):
    """-> (classname, payload bytes, n)"""
    if arr.dtype == object or arr.dtype.kind in ("U", "S"):
        payload = bytearray()
        for s in arr:
            b = ("" if s is None else str(s)).encode("utf-8")
            payload += _leb128(len(b)) + b
        return "dVStr8", bytes(payload), len(arr)
    if arr.dtype.kind in ("i", "u"):
        if len(arr) and (arr.min() < -(1 << 31) or arr.max() >= (1 << 31)):
            # silent int32 wraparound would corrupt ids/counts; store as
            # f64 instead (exact to 2^53, like R's numeric)
            a = np.asarray(arr, "<f8")
            return "dFloat64", a.tobytes(), len(a)
        a = np.asarray(arr, "<i4")
        return "dInt32", a.tobytes(), len(a)
    if arr.dtype.kind == "b":
        a = np.asarray(arr, "<i4")
        return "dInt32", a.tobytes(), len(a)
    a = np.asarray(arr, "<f8")
    return "dFloat64", a.tobytes(), len(a)


_P_PIPE = bytes.fromhex("15c4466d")
_P_PIPESZ = bytes.fromhex("02c9466d50e0512504")

LZMA_FRAME_BYTES = 1 << 20   # ~1 MB plaintext per xz frame (random access)
ZIP_FRAME_BYTES = 1 << 22    # ~4 MB plaintext per zlib stream

# Self-describing frame table prepended to _ra payloads we write:
#   "SGRA" + u8 version + u8 codec(0=zip,1=xz) + u16 pad + u32 nframes
#   + u32 plain_frame_bytes + u64 raw_size + u32 csizes[nframes]
# Exact frame boundaries without any decoding -> the reader builds its
# random-access index for free and inflates frames in parallel (zlib/lzma
# release the GIL).  Foreign gdsfmt files (no table) fall back to the
# sequential boundary-discovery path.
SGRA_MAGIC = b"SGRA"


def _frame_table(codec: int, csizes, plain_frame: int,
                 raw_size: int) -> bytes:
    head = SGRA_MAGIC + bytes([1, codec, 0, 0])
    head += struct.pack("<IIQ", len(csizes), plain_frame, raw_size)
    head += struct.pack(f"<{len(csizes)}I", *csizes)
    return head


def _map_frames(fn, payload: bytes, frame: int):
    """Compress each plaintext frame, in parallel when large (zlib/lzma
    release the GIL; frames are independent by construction)."""
    spans = [payload[s : s + frame]
             for s in range(0, max(len(payload), 1), frame)]
    if len(spans) < 2:
        return [fn(s) for s in spans]
    import os
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(min(4, os.cpu_count() or 1)) as ex:
        return list(ex.map(fn, spans))


def _compress_lzma_ra(payload: bytes) -> bytes:
    """LZMA_ra payload: independently-decodable xz frames (the random-
    access container our reader streams / frame-indexes, io/gds.py)."""
    import lzma
    frames = _map_frames(
        lambda s: lzma.compress(s, format=lzma.FORMAT_XZ, preset=6),
        payload, LZMA_FRAME_BYTES)
    return _frame_table(1, [len(f) for f in frames], LZMA_FRAME_BYTES,
                        len(payload)) + b"".join(frames)


def _compress_zip_ra(payload: bytes, level: int = 1) -> bytes:
    """ZIP_ra payload: independently-decodable zlib streams (~4 MB plaintext
    each).  zlib level 1 runs ~10x faster than LZMA — the right container
    for large genotype matrices written in bulk."""
    import zlib
    frames = _map_frames(lambda s: zlib.compress(s, level),
                         payload, ZIP_FRAME_BYTES)
    return _frame_table(0, [len(f) for f in frames], ZIP_FRAME_BYTES,
                        len(payload)) + b"".join(frames)


def _compress_payload(compress, payload: bytes):
    """Apply the requested pipe; returns (pipe_name, compressed_payload)
    or ("", payload) when compression is off."""
    if not compress:
        return "", payload
    c = str(compress).upper()
    if c.startswith("LZMA"):
        return "LZMA_ra", _compress_lzma_ra(payload)
    if c.startswith("ZIP"):
        return "ZIP_ra", _compress_zip_ra(payload)
    raise ValueError(f"unsupported GDS compression {compress!r}")


def _array_node_record(cls: str, dims, data_bid: int,
                       pipe: str = "", raw_size: int = 0,
                       cmp_size: int = 0) -> bytes:
    if isinstance(dims, int):
        dims = (dims,)
    nprops = 3
    props = bytearray()
    if pipe:
        pb = pipe.encode("utf-8")
        props += _P_PIPE + bytes([0x10, len(pb)]) + pb
        props += _P_PIPESZ + bytes([0x10]) \
            + int(raw_size).to_bytes(8, "little") \
            + int(cmp_size).to_bytes(8, "little")
        nprops += 2
    props += _P_NDIM + struct.pack("<H", len(dims))
    props += _P_DIMS + bytes([4 * len(dims)])
    for d in dims:
        props += struct.pack("<I", d)
    props += _P_DATABLK + struct.pack("<I", data_bid)
    body = bytearray()
    body += struct.pack("<H", nprops)
    body += struct.pack("<H", 0x0100)         # class version
    body += _pack7(cls)
    body += props
    return _u48(len(body) + 6) + bytes(body)


def _folder_node_record(children: List[tuple], attrs: Dict[str, str]) -> bytes:
    """children: [(name, bid)] or [(name, bid, is_folder)]"""
    ents = bytearray()
    for child in children:
        name, bid = child[0], child[1]
        is_folder = child[2] if len(child) > 2 else False
        nb = name.encode("utf-8")
        p = bytearray()
        p += _P_EID + struct.pack("<I", bid)
        p += _P_EFLAG + struct.pack("<I", 0x2 if is_folder else 0)
        p += _P_ENAME + bytes([len(nb)]) + nb
        ents += _u48(len(p) + 8) + struct.pack("<H", 3) + p
    props = bytearray()
    nprops = 0
    if attrs:
        rec = _attr_rec(attrs)
        props += _P_NATTR + struct.pack("<I", len(attrs))
        props += _P_ATTR + _u48(len(rec) + 6) + rec
        nprops += 2
    props += _P_NCHILD + struct.pack("<I", len(children))
    props += _P_DIRENT + _u48(len(ents) + 6) + bytes(ents)
    nprops += 2
    body = struct.pack("<H", nprops) + bytes(props)
    return _u48(len(body) + 6) + body


def write_gds_table(path: str, columns: Dict[str, np.ndarray],
                    file_format: str = "SAIGE_OUTPUT",
                    compress: str = "LZMA"):
    """Write a flat table as a SAIGE_OUTPUT-style GDS file.

    ``compress="LZMA"`` stores each column as LZMA_ra frames (the
    reference's ``res.compress`` default, R/assoc_single.r:93); "" or
    None writes raw payloads.
    """
    blocks: Dict[int, bytes] = {}
    children = []
    next_bid = 2
    for name, arr in columns.items():
        cls, payload, n = _encode_column(np.asarray(arr))
        data_bid = next_bid + 1
        pipe, payload2 = _compress_payload(compress, payload)
        if pipe:
            blocks[next_bid] = _array_node_record(
                cls, n, data_bid, pipe=pipe,
                raw_size=len(payload), cmp_size=len(payload2))
            payload = payload2
        else:
            blocks[next_bid] = _array_node_record(cls, n, data_bid)
        blocks[data_bid] = payload
        children.append((name, next_bid))
        next_bid += 2
    blocks[1] = _folder_node_record(children, {"FileFormat": file_format})

    _write_blocks(path, blocks)


def save_assoc_gds(df, path: str, file_format: str = "SAIGE_OUTPUT",
                   compress: str = "LZMA"):
    """Save association results (a DataFrame or a dict of numpy columns)
    as a SAIGE_OUTPUT GDS (LZMA_ra-compressed by default, like the
    reference)."""
    cols = {k: np.asarray(df[k]) for k in df.keys()}
    write_gds_table(path, cols, file_format=file_format, compress=compress)


# ---------------------------------------------------------------------------
# SeqArray-compatible genotype files (the VCF/matrix -> GDS converter story)


def _pack_bit2(values: np.ndarray) -> bytes:
    """Pack 2-bit codes little-endian within each byte (dBit2 layout)."""
    v = np.asarray(values, np.uint8).ravel()
    pad = (-len(v)) % 4
    if pad:
        v = np.concatenate([v, np.zeros(pad, np.uint8)])
    v = v.reshape(-1, 4)
    return (v[:, 0] | (v[:, 1] << 2) | (v[:, 2] << 4) | (v[:, 3] << 6)) \
        .astype(np.uint8).tobytes()


class _NodeBuilder:
    """Shared node-allocation state for the GDS writers: block ids,
    payload compression, and the array/column/folder record shapes."""

    def __init__(self, compress: str):
        self.blocks: Dict[int, bytes] = {}
        self._next = 2
        self.compress = compress

    def add_array(self, cls, dims, payload):
        nb, db = self._next, self._next + 1
        self._next += 2
        pipe, payload2 = _compress_payload(self.compress, payload)
        if pipe:
            self.blocks[nb] = _array_node_record(cls, dims, db, pipe=pipe,
                                                 raw_size=len(payload),
                                                 cmp_size=len(payload2))
            payload = payload2
        else:
            self.blocks[nb] = _array_node_record(cls, dims, db)
        self.blocks[db] = payload
        return nb

    def add_col(self, arr):
        cls, payload, n = _encode_column(np.asarray(arr))
        return self.add_array(cls, n, payload)

    def add_folder(self, children, attrs=None):
        nb = self._next
        self._next += 1
        self.blocks[nb] = _folder_node_record(children, attrs or {})
        return nb


def write_seqarray_gds(path: str, codes: np.ndarray, sample_id=None,
                       variant_id=None, position=None, chromosome=None,
                       allele=None, rs_id=None, compress: str = ""):
    """Write an int8 dosage-code matrix as a SeqArray-style genotype GDS.

    codes: [M, N] with 0/1/2 ALT dosage and 3 = missing.  This is the
    inverse of our reader's genotype path — a one-time converter so any
    matrix source (VCF parsers, simulators) can produce framework input
    (SURVEY.md §7 "hard parts": ship a converter + neutral format).
    """
    codes = np.asarray(codes, np.int8)
    M, N = codes.shape
    sample_id = np.arange(1, N + 1, dtype=np.int32) if sample_id is None \
        else np.asarray(sample_id)
    variant_id = np.arange(1, M + 1, dtype=np.int32) if variant_id is None \
        else np.asarray(variant_id)
    position = np.arange(1, M + 1, dtype=np.int32) if position is None \
        else np.asarray(position, np.int32)
    chromosome = np.asarray(["1"] * M, object) if chromosome is None \
        else np.asarray(chromosome, object)
    allele = np.asarray(["A,G"] * M, object) if allele is None \
        else np.asarray(allele, object)

    # per-genotype allele pair: 0->(0,0) 1->(0,1) 2->(1,1) 3->(3,3);
    # as a 4-bit nibble a1 | a2<<2 that is the genotype's dBit2 contribution
    _nib = np.array([0b0000, 0b0100, 0b0101, 0b1111], np.uint8)
    if N % 2 == 0:
        # bytes never straddle variants: pack two genotypes (4 alleles)
        # per byte directly — no [M, N, 2] materialization (matters at
        # biobank N where the allele tensor is 2x the code matrix)
        nib = _nib[codes]
        geno_payload = (nib[:, 0::2] | (nib[:, 1::2] << 4)).tobytes()
    else:
        a1 = np.select([codes == 0, codes == 1, codes == 2], [0, 0, 1], 3)
        a2 = np.select([codes == 0, codes == 1, codes == 2], [0, 1, 1], 3)
        alleles = np.stack([a1, a2], axis=2).astype(np.uint8)  # [M, N, 2]
        geno_payload = _pack_bit2(alleles)

    bld = _NodeBuilder(compress)
    blocks = bld.blocks
    add_array, add_col, add_folder = \
        bld.add_array, bld.add_col, bld.add_folder

    geno_data = add_array("dBit2", (M, N, 2), geno_payload)
    geno = add_folder([("data", geno_data, False)])
    root_children = [
        ("sample.id", add_col(sample_id), False),
        ("variant.id", add_col(variant_id), False),
        ("position", add_col(position), False),
        ("chromosome", add_col(chromosome), False),
        ("allele", add_col(allele), False),
        ("genotype", geno, True),
    ]
    if rs_id is not None:
        ann = add_folder([("id", add_col(np.asarray(rs_id, object)), False)])
        root_children.append(("annotation", ann, True))
    blocks[1] = _folder_node_record(
        root_children, {"FileFormat": "SEQ_ARRAY", "FileVersion": "v1.0"})

    _write_blocks(path, blocks)


def write_dosage_gds(path: str, dosages: np.ndarray, sample_id=None,
                     variant_id=None, position=None, chromosome=None,
                     allele=None, rs_id=None, compress: str = ""):
    """Write a float ALT-dosage matrix as a SeqArray-style DS GDS.

    dosages: [M, N] float with NaN = missing, stored under
    ``annotation/format/DS`` (the reference's imputed-dosage node,
    R/assoc_single.r:69-85) — no genotype node, so readers auto-detect DS.
    """
    ds = np.asarray(dosages, "<f8")
    M, N = ds.shape
    sample_id = np.arange(1, N + 1, dtype=np.int32) if sample_id is None \
        else np.asarray(sample_id)
    variant_id = np.arange(1, M + 1, dtype=np.int32) if variant_id is None \
        else np.asarray(variant_id)
    position = np.arange(1, M + 1, dtype=np.int32) if position is None \
        else np.asarray(position, np.int32)
    chromosome = np.asarray(["1"] * M, object) if chromosome is None \
        else np.asarray(chromosome, object)
    allele = np.asarray(["A,G"] * M, object) if allele is None \
        else np.asarray(allele, object)

    bld = _NodeBuilder(compress)
    blocks = bld.blocks
    add_array, add_col, add_folder = \
        bld.add_array, bld.add_col, bld.add_folder

    ds_data = add_array("dFloat64", (M, N), ds.tobytes())
    ds_folder = add_folder([("data", ds_data, False)])
    fmt = add_folder([("DS", ds_folder, True)])
    ann_children = [("format", fmt, True)]
    if rs_id is not None:
        ann_children.insert(0, ("id", add_col(np.asarray(rs_id, object)),
                                False))
    ann = add_folder(ann_children)
    blocks[1] = _folder_node_record([
        ("sample.id", add_col(sample_id), False),
        ("variant.id", add_col(variant_id), False),
        ("position", add_col(position), False),
        ("chromosome", add_col(chromosome), False),
        ("allele", add_col(allele), False),
        ("annotation", ann, True),
    ], {"FileFormat": "SEQ_ARRAY", "FileVersion": "v1.0"})
    _write_blocks(path, blocks)


def _write_blocks(path: str, blocks: Dict[int, bytes]):
    with open(path, "wb") as f:
        f.write(GDS_MAGIC)
        f.write(struct.pack("<H", 0x0100))
        f.write(b"\x00" * 4)
        for bid, content in sorted(blocks.items()):
            size = 22 + len(content)
            f.write((size | (1 << 47)).to_bytes(6, "little"))
            f.write(_u48(0))
            f.write(struct.pack("<I", bid))
            f.write(_u48(len(content)))
            f.write(content)
