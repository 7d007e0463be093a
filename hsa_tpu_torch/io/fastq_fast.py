"""Native batched FASTQ reader: mmap + C parser -> engine batch arrays.

Production input path (SURVEY.md §2 "C++ reader lib feeding host batches"):
the C side parses records straight into the search engine's [B, Lmax]
uint8 layout (PAD=5 beyond each read), so no per-read Python objects are
created; names/quals stay as byte ranges into the mmap and materialize
lazily.  Gzipped input streams through a chunked zlib decompressor with
a bounded rolling window (host RSS stays O(batch) regardless of input
size — the lineage reads gzip streams via kseq the same way).  Counterpart
of ``hsa_tpu/io/fastq_fast.py``, on the port's own native library, without
the pure-Python fallback parser.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import zlib

import numpy as np

from .. import refpack

_GZ_CHUNK = 1 << 20       # compressed bytes per read() call


class FastqBatcher:
    """Iterate (names, codes uint8[B, max_len], lens int32[B], quals) batches."""

    def __init__(self, path: str, batch: int = 4096, max_len: int = 512):
        self.batch = batch
        self.max_len = max_len
        self._fh = None
        self._dec = None
        if str(path).endswith(".gz"):
            self._fh = open(path, "rb")
            self._dec = zlib.decompressobj(wbits=31)
            self._buf = bytearray()
            # window target: ~one batch of worst-case records (name+seq+
            # qual+framing); the rolling buffer never grows past
            # target + one decompressed chunk
            self._gz_target = batch * (2 * max_len + 96)
        else:
            self._fh = open(path, "rb")
            if os.fstat(self._fh.fileno()).st_size == 0:
                self._buf = b""
            else:
                self._buf = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._pos = np.zeros(1, dtype=np.int64)
        self._lib = refpack.ensure_refpack()

    def _gz_refill(self) -> bool:
        """Drop the consumed prefix and decompress more input into the
        rolling window.  Output is capped per call (zlib ``max_length``
        + ``unconsumed_tail`` carry) so the window never exceeds
        target + 64 KiB no matter the chunk's compression ratio.
        Returns False when the stream is exhausted and nothing new
        arrived."""
        pos = int(self._pos[0])
        if pos:
            del self._buf[:pos]
            self._pos[0] = 0
        grew = False
        while len(self._buf) < self._gz_target:
            if self._dec.unconsumed_tail:
                src = self._dec.unconsumed_tail
            elif self._dec.eof and self._dec.unused_data:
                # multi-member gzip (catted .gz / bgzf-style): chain
                src = self._dec.unused_data
                self._dec = zlib.decompressobj(wbits=31)
            else:
                src = self._fh.read(_GZ_CHUNK)
                if not src:
                    tail = self._dec.flush()
                    if tail:
                        self._buf += tail
                        grew = True
                    if not self._dec.eof:
                        # matches gzip.open's behavior on truncated
                        # input — silent acceptance would drop reads
                        raise EOFError(
                            "compressed FASTQ stream truncated "
                            "(end-of-stream marker missing)")
                    break
            cap = self._gz_target - len(self._buf) + (1 << 16)
            data = self._dec.decompress(src, cap)
            if data:
                self._buf += data
                grew = True
        return grew

    def __iter__(self):
        return self

    def __next__(self):
        if self._dec is not None:
            self._gz_refill()
        buf = self._buf
        if self._pos[0] >= len(buf):
            self.close()
            raise StopIteration
        B, L = self.batch, self.max_len
        codes = np.empty((B, L), np.uint8)
        lens = np.empty(B, np.int32)
        name_off = np.empty(B, np.int64)
        name_len = np.empty(B, np.int32)
        qual_off = np.empty(B, np.int64)
        qual_len = np.empty(B, np.int32)
        # zero-copy view over bytes or mmap
        arr = np.frombuffer(buf, dtype=np.uint8)
        n = self._lib.rp_fastq_batch(
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(buf), self._pos.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            B, L,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            name_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            name_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            qual_off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            qual_len.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if n < 0:
            raise ValueError("malformed FASTQ input")
        if n == 0:
            if self._dec is not None:
                # a record can straddle the window end: widen and retry
                self._gz_target *= 2
                if self._gz_refill():
                    return self.__next__()
            self.close()
            raise StopIteration
        names = [bytes(buf[name_off[i]:name_off[i] + name_len[i]]).decode()
                 for i in range(n)]
        quals = [bytes(buf[qual_off[i]:qual_off[i] + qual_len[i]]).decode()
                 for i in range(n)]
        return names, codes[:n], np.minimum(lens[:n], L), quals

    def close(self):
        if isinstance(self._buf, mmap.mmap):
            self._buf.close()
        if self._fh:
            self._fh.close()
            self._fh = None
