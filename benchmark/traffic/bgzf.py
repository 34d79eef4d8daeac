# Frozen copy of pepper_tpu_torch/io/bgzf.py at commit d27cce3, kept with the benchmark so that
# a later change to the program cannot move the yardstick. The
# program's native (libdeflate) block compressor is left out: zlib only,
# its blocks compressed on a pool of threads.
"""BGZF (blocked gzip) reader/writer, pure Python.

Implements the BGZF framing from the SAM spec (section 4.1): concatenated
gzip members carrying a BC extra subfield with the compressed block size.
Used for writing bgzipped VCFs/BAMs (test fixtures and pipeline output) and
as a reference implementation to validate the native C++ reader against.
Replaces the reference's dependency on htslib's bgzf (`pepper/modules/htslib.cmake`).
"""
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


class BGZFWriter:
    """Streaming BGZF writer producing htslib-compatible files.

    Blocks are compressed on a pool of threads (zlib releases the
    interpreter lock) and written in order, so the bytes are those of a
    sequential writer. While blocks are in flight their file offsets are
    not known: `virtual_offset` is then logical, (block number << 16) |
    offset in the block, which orders and compares as the real one does;
    `real_offset` maps it to the file's once the writer is closed."""

    _WINDOW = 64          # blocks in flight

    def __init__(self, path_or_fh, compresslevel: int = 6, threads: int = 8):
        from concurrent.futures import ThreadPoolExecutor
        if isinstance(path_or_fh, (str, bytes)):
            self._fh = open(path_or_fh, "wb")
            self._owns = True
        else:
            self._fh = path_or_fh
            self._owns = False
        self._level = compresslevel
        self._buf = bytearray()
        self._closed = False
        self._starts = [self._fh.tell()]   # file offset of each block
        self._pending = []
        self._pool = ThreadPoolExecutor(threads)

    # uncompressed payload capped so the compressed block stays < 64KB
    _FLUSH_AT = 65280

    @property
    def virtual_offset(self) -> int:
        return ((len(self._starts) - 1 + len(self._pending)) << 16) \
            | len(self._buf)

    def real_offset(self, logical: int) -> int:
        return (self._starts[logical >> 16] << 16) | (logical & 0xFFFF)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self._FLUSH_AT:
            self._submit(bytes(self._buf[:self._FLUSH_AT]))
            del self._buf[:self._FLUSH_AT]

    def flush(self) -> None:
        if self._buf:
            self._submit(bytes(self._buf))
            self._buf.clear()

    def _submit(self, data: bytes) -> None:
        self._pending.append(self._pool.submit(self._block, data))
        if len(self._pending) >= self._WINDOW:
            self._drain(self._WINDOW // 2)

    def _drain(self, keep: int = 0) -> None:
        while len(self._pending) > keep:
            block = self._pending.pop(0).result()
            self._fh.write(block)
            self._starts.append(self._starts[-1] + len(block))

    def _block(self, data: bytes) -> bytes:
        compressor = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = compressor.compress(data) + compressor.flush()
        block_size = len(cdata) + 12 + 6 + 8
        if block_size > MAX_BLOCK_SIZE:
            raise BGZFError("BGZF block overflow")
        header = _HEADER.pack(0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6)
        extra = struct.pack("<BBHH", 66, 67, 2, block_size - 1)
        tail = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
        return header + extra + cdata + tail

    def close(self) -> None:
        if self._closed:
            return
        self.flush()
        self._drain()
        self._pool.shutdown()
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
