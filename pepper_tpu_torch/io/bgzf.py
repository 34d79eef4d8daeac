"""BGZF (blocked gzip) reader/writer, pure Python.

Implements the BGZF framing from the SAM spec (section 4.1): concatenated
gzip members carrying a BC extra subfield with the compressed block size.
Used for writing bgzipped VCFs/BAMs (test fixtures and pipeline output) and
as a reference implementation to validate the native C++ reader against.
Replaces the reference's dependency on htslib's bgzf (`pepper/modules/htslib.cmake`).
"""
import ctypes
import struct
import zlib
from typing import BinaryIO, Iterator, Optional, Tuple

MAX_BLOCK_SIZE = 65536
# 28-byte BGZF EOF marker (SAM spec 4.1.2)
EOF_MARKER = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_HEADER = struct.Struct("<BBBBIBBH")  # magic1 magic2 CM FLG MTIME XFL OS XLEN


class BGZFError(ValueError):
    pass


def _read_block(fh: BinaryIO) -> Tuple[bytes, int]:
    """Read one BGZF block. Returns (uncompressed_data, compressed_size).

    Returns (b"", 0) at clean EOF.
    """
    header = fh.read(12)
    if len(header) == 0:
        return b"", 0
    if len(header) < 12:
        raise BGZFError("truncated BGZF block header")
    magic1, magic2, cm, flg, _mtime, _xfl, _os, xlen = _HEADER.unpack(header)
    if magic1 != 0x1F or magic2 != 0x8B or cm != 8 or not (flg & 4):
        raise BGZFError("not a BGZF block (bad gzip/FEXTRA header)")
    extra = fh.read(xlen)
    if len(extra) != xlen:
        raise BGZFError("truncated BGZF extra field")
    bsize = None
    i = 0
    while i + 4 <= xlen:
        si1, si2, slen = extra[i], extra[i + 1], struct.unpack_from("<H", extra, i + 2)[0]
        if si1 == 66 and si2 == 67 and slen == 2:  # 'B','C'
            bsize = struct.unpack_from("<H", extra, i + 4)[0]
        i += 4 + slen
    if bsize is None:
        raise BGZFError("BGZF BC subfield missing")
    block_size = bsize + 1
    cdata_len = block_size - 12 - xlen - 8
    cdata = fh.read(cdata_len)
    tail = fh.read(8)
    if len(cdata) != cdata_len or len(tail) != 8:
        raise BGZFError("truncated BGZF block body")
    crc, isize = struct.unpack("<II", tail)
    data = zlib.decompress(cdata, wbits=-15)
    if len(data) != isize:
        raise BGZFError("BGZF ISIZE mismatch")
    if zlib.crc32(data) & 0xFFFFFFFF != crc:
        raise BGZFError("BGZF CRC mismatch")
    return data, block_size


class BGZFReader:
    """Sequential + virtual-offset random access reader."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        self._block_start = 0       # file offset of current block
        self._buf = b""
        self._pos = 0               # offset within current uncompressed block
        self._next_block_offset = 0

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- virtual offsets ----------------------------------------------------
    @property
    def virtual_offset(self) -> int:
        return (self._block_start << 16) | self._pos

    def seek_virtual(self, voffset: int) -> None:
        coffset, uoffset = voffset >> 16, voffset & 0xFFFF
        self._fh.seek(coffset)
        self._block_start = coffset
        self._buf, csize = _read_block(self._fh)
        self._next_block_offset = coffset + csize
        self._pos = uoffset

    # -- reading -------------------------------------------------------------
    def _fill(self) -> bool:
        while self._pos >= len(self._buf):
            self._block_start = self._next_block_offset or self._fh.tell()
            self._fh.seek(self._block_start)
            data, csize = _read_block(self._fh)
            if csize == 0:
                return False
            self._buf = data
            self._pos = 0
            self._next_block_offset = self._block_start + csize
            if len(data) == 0:
                continue
        return True

    def read(self, n: int) -> bytes:
        out = bytearray()
        while n > 0:
            if not self._fill():
                break
            take = min(n, len(self._buf) - self._pos)
            out += self._buf[self._pos:self._pos + take]
            self._pos += take
            n -= take
        return bytes(out)

    def read_all(self) -> bytes:
        out = bytearray()
        while True:
            chunk = self.read(MAX_BLOCK_SIZE)
            if not chunk:
                break
            out += chunk
        return bytes(out)


_native_deflate = None   # lazily resolved; False = unavailable


def _get_native_deflate():
    """The native lib's libdeflate-backed block compressor (~2.5x faster
    than zlib at level 6). The C++ VCF sink routes its blocks through the
    SAME function, so Python- and native-written files stay byte-identical
    whichever backend this process resolves."""
    global _native_deflate
    if _native_deflate is None:
        _native_deflate = False
        try:
            from pepper_tpu_torch.native import bamio
            if bamio.available():
                lib = bamio._lib
                if not getattr(lib, "_bgzf_bound", False):
                    lib.bgzf_deflate_block.restype = ctypes.c_int64
                    lib.bgzf_deflate_block.argtypes = [
                        ctypes.c_char_p, ctypes.c_int64,
                        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
                    lib._bgzf_bound = True
                _native_deflate = lib
        except Exception:
            _native_deflate = False
    return _native_deflate or None


class BGZFWriter:
    """Streaming BGZF writer producing htslib-compatible files."""

    def __init__(self, path_or_fh, compresslevel: int = 6):
        if isinstance(path_or_fh, (str, bytes)):
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._level = compresslevel
        self._buf = bytearray()
        self._closed = False
        self._coffset = self._fh.tell()  # compressed bytes written so far
        # native libdeflate path only at the default level (its level
        # scale differs from zlib's; 6 is the one the C++ sink uses)
        self._nlib = _get_native_deflate() if compresslevel == 6 else None
        self._nbuf: Optional[ctypes.Array] = (
            (ctypes.c_uint8 * MAX_BLOCK_SIZE)() if self._nlib else None)

    # uncompressed payload capped so the compressed block stays < 64KB
    _FLUSH_AT = 65280

    @property
    def virtual_offset(self) -> int:
        return (self._coffset << 16) | len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self._FLUSH_AT:
            self._write_block(bytes(self._buf[:self._FLUSH_AT]))
            del self._buf[:self._FLUSH_AT]

    def flush(self) -> None:
        if self._buf:
            self._write_block(bytes(self._buf))
            self._buf.clear()

    def _write_block(self, data: bytes) -> None:
        cdata = None
        if self._nlib is not None:
            rc = self._nlib.bgzf_deflate_block(data, len(data), self._nbuf,
                                               MAX_BLOCK_SIZE)
            if rc > 0:
                cdata = bytes(memoryview(self._nbuf)[:rc])
        if cdata is None:
            compressor = zlib.compressobj(self._level, zlib.DEFLATED, -15)
            cdata = compressor.compress(data) + compressor.flush()
        block_size = len(cdata) + 12 + 6 + 8
        if block_size > MAX_BLOCK_SIZE:
            raise BGZFError("BGZF block overflow")
        header = _HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        extra = struct.pack("<BBHH", 66, 67, 2, block_size - 1)
        tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
        self._fh.write(header + extra + cdata + tail)
        self._coffset += block_size

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._fh.write(EOF_MARKER)
        if self._owns:
            self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_blocks(path: str) -> Iterator[Tuple[int, bytes]]:
    """Yield (file_offset, uncompressed_data) for each block."""
    with open(path, "rb") as fh:
        while True:
            offset = fh.tell()
            data, csize = _read_block(fh)
            if csize == 0:
                return
            yield offset, data


def bgzip_file(text_path: str, out_path: str) -> None:
    """bgzip-compress a text file (e.g. a VCF before tabix indexing)."""
    with open(text_path, "rb") as src, BGZFWriter(out_path) as dst:
        while True:
            chunk = src.read(1 << 20)
            if not chunk:
                break
            dst.write(chunk)
