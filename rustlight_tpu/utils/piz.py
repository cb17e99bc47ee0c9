"""PIZ (wavelet + Huffman) EXR block codec.

The reference renderer does EXR I/O through the native OpenEXR C++ library
(src/structure.rs:490-642); PIZ is OpenEXR's bundled wavelet codec and the
default in several DCC tools, so externally-produced reference images and
envmap textures frequently use it. This module implements the PIZ block
format from its public specification twice:

  * a native C++ codec (native/piz_codec.cpp, compiled on demand, ctypes) —
    the production path (Huffman coding is inherently serial byte work);
  * a pure-Python/numpy fallback (vectorized wavelet + LUT, bit-by-bit
    Huffman) for environments without g++.

The two implementations are independent of each other and cross-validated
in tests/test_foundations.py (each decodes the other's output, plus
hand-computed spec vectors built without either codec). No conformant
external PIZ sample is available in this environment (no OpenEXR binding,
zero egress), so conformance rests on the spec-structural tests plus the
dual implementation — the same validation stance as the ZIP/RLE codecs.

Block format (per 32-scanline chunk):
  u16 minNonZero, u16 maxNonZero            (LE)
  bitmap bytes [minNonZero..maxNonZero]     (which u16 values occur; value 0
                                             is implicit and never stored)
  i32 length                                (Huffman byte count, LE)
  Huffman stream: [im u32][iM u32][tableLength u32][nBits u32][0 u32]
                  packed code-length table, then MSB-first code stream with
                  the symbol iM acting as the run-length escape.
Pixel data inside the block is per-channel planar; each float32 channel is
treated as two u16 columns; the 2D wavelet runs per channel (per u16 column
for multi-word types) before Huffman coding.
"""
from __future__ import annotations

import ctypes
import heapq
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).parent / "native"
_LIB = None
_LIB_FAILED = False

USHORT_RANGE = 1 << 16
BITMAP_SIZE = USHORT_RANGE >> 3
HUF_ENCSIZE = USHORT_RANGE + 1
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN


def _load_native():
    global _LIB, _LIB_FAILED
    if _LIB is not None or _LIB_FAILED:
        return _LIB
    so = _NATIVE_DIR / "libpiz.so"
    src = _NATIVE_DIR / "piz_codec.cpp"
    try:
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-o", str(so), str(src)],
                check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.rl_piz_compress.restype = ctypes.c_longlong
        lib.rl_piz_compress.argtypes = [
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong]
        lib.rl_piz_uncompress.restype = ctypes.c_int32
        lib.rl_piz_uncompress.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint16), ctypes.c_longlong]
        _LIB = lib
    except Exception:
        _LIB_FAILED = True
    return _LIB


# ChannelDesc: (nx, ny, size) — pixels per row, rows, u16 words per pixel
ChannelDesc = Tuple[int, int, int]


def _planar_total(chans: Sequence[ChannelDesc]) -> int:
    return sum(nx * ny * size for nx, ny, size in chans)


# --------------------------------------------------------------- native path

def piz_compress(planar: np.ndarray, chans: Sequence[ChannelDesc],
                 force_python: bool = False) -> bytes:
    """Compress a planar u16 block. Returns the PIZ payload bytes."""
    planar = np.ascontiguousarray(planar, dtype=np.uint16)
    assert planar.size == _planar_total(chans)
    lib = None if force_python else _load_native()
    if lib is not None:
        n = planar.size
        # worst case: 58-bit codes (~7.25 B/u16) + packed table + bitmap
        cap = 8 * n + BITMAP_SIZE + 64 + 50_000
        out = np.empty(cap, np.uint8)
        nx = np.ascontiguousarray([c[0] for c in chans], np.int32)
        ny = np.ascontiguousarray([c[1] for c in chans], np.int32)
        sz = np.ascontiguousarray([c[2] for c in chans], np.int32)
        ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        r = lib.rl_piz_compress(
            planar.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n,
            ip(nx), ip(ny), ip(sz), len(chans),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
        if r >= 0:
            return out[:r].tobytes()
    return _piz_compress_py(planar, chans)


def piz_uncompress(payload: bytes, chans: Sequence[ChannelDesc],
                   force_python: bool = False) -> np.ndarray:
    """Uncompress a PIZ payload back to the planar u16 block."""
    n = _planar_total(chans)
    lib = None if force_python else _load_native()
    if lib is not None:
        src = np.frombuffer(payload, np.uint8)
        out = np.empty(n, np.uint16)
        nx = np.ascontiguousarray([c[0] for c in chans], np.int32)
        ny = np.ascontiguousarray([c[1] for c in chans], np.int32)
        sz = np.ascontiguousarray([c[2] for c in chans], np.int32)
        ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        rc = lib.rl_piz_uncompress(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), src.size,
            ip(nx), ip(ny), ip(sz), len(chans),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), n)
        if rc == 0:
            return out
        raise ValueError(f"PIZ native decode failed (rc={rc})")
    return _piz_uncompress_py(payload, chans)


# --------------------------------------------------------------- wavelet (numpy)

def _wenc14(a, b):
    a = a.astype(np.int16)
    b = b.astype(np.int16)
    m = (a.astype(np.int32) + b) >> 1
    d = a.astype(np.int32) - b
    return m.astype(np.int16).astype(np.uint16), d.astype(np.int16).astype(np.uint16)


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + (1 << 15)) & 0xFFFF
    m = (ao + b) >> 1
    d = ao - b
    m = np.where(d < 0, (m + (1 << 15)) & 0xFFFF, m)
    return m.astype(np.uint16), (d & 0xFFFF).astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    b = (m - (d >> 1)) & 0xFFFF
    a = (d + b - (1 << 15)) & 0xFFFF
    return a.astype(np.uint16), b.astype(np.uint16)


def _wav2_encode(v: np.ndarray, mx: int) -> None:
    """In-place multi-level 2D wavelet on view v [ny, nx] (uint16)."""
    enc = _wenc14 if mx < (1 << 14) else _wenc16
    ny, nx = v.shape
    n = min(nx, ny)
    p, p2 = 1, 2
    while p2 <= n:
        ys = np.arange(0, max(ny - p2 + 1, 0), p2)
        xs = np.arange(0, max(nx - p2 + 1, 0), p2)
        if ys.size and xs.size:
            q00 = v[np.ix_(ys, xs)]
            q01 = v[np.ix_(ys, xs + p)]
            q10 = v[np.ix_(ys + p, xs)]
            q11 = v[np.ix_(ys + p, xs + p)]
            i00, i01 = enc(q00, q01)
            i10, i11 = enc(q10, q11)
            l0, l1 = enc(i00, i10)
            v[np.ix_(ys, xs)] = l0
            v[np.ix_(ys + p, xs)] = l1
            h0, h1 = enc(i01, i11)
            v[np.ix_(ys, xs + p)] = h0
            v[np.ix_(ys + p, xs + p)] = h1
        if (nx & p) and ys.size:
            # leftover column: vertical pairs at x = xs[-1] + p2 (loop end)
            x = xs[-1] + p2 if xs.size else 0
            i00, hi = enc(v[ys, x], v[ys + p, x])
            v[ys, x] = i00
            v[ys + p, x] = hi
        if (ny & p) and xs.size:
            y = ys[-1] + p2 if ys.size else 0
            i00, hi = enc(v[y, xs], v[y, xs + p])
            v[y, xs] = i00
            v[y, xs + p] = hi
        p = p2
        p2 <<= 1


def _wav2_decode(v: np.ndarray, mx: int) -> None:
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    ny, nx = v.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, max(ny - p2 + 1, 0), p2)
        xs = np.arange(0, max(nx - p2 + 1, 0), p2)
        if ys.size and xs.size:
            l0 = v[np.ix_(ys, xs)]
            h0 = v[np.ix_(ys, xs + p)]
            l1 = v[np.ix_(ys + p, xs)]
            h1 = v[np.ix_(ys + p, xs + p)]
            i00, i10 = dec(l0, l1)
            i01, i11 = dec(h0, h1)
            a, b = dec(i00, i01)
            v[np.ix_(ys, xs)] = a
            v[np.ix_(ys, xs + p)] = b
            a, b = dec(i10, i11)
            v[np.ix_(ys + p, xs)] = a
            v[np.ix_(ys + p, xs + p)] = b
        if (nx & p) and ys.size:
            x = xs[-1] + p2 if xs.size else 0
            a, b = dec(v[ys, x], v[ys + p, x])
            v[ys, x] = a
            v[ys + p, x] = b
        if (ny & p) and xs.size:
            y = ys[-1] + p2 if ys.size else 0
            a, b = dec(v[y, xs], v[y, xs + p])
            v[y, xs] = a
            v[y, xs + p] = b
        p2 = p
        p >>= 1


def _channel_views(planar: np.ndarray, chans: Sequence[ChannelDesc]):
    """Yield (view [ny, nx], word offset j, size) wavelet targets."""
    off = 0
    for nx, ny, size in chans:
        block = planar[off:off + nx * ny * size].reshape(ny, nx * size)
        for j in range(size):
            yield block[:, j::size]
        off += nx * ny * size


# --------------------------------------------------------------- Huffman (python)

class _BitWriter:
    __slots__ = ("buf", "c", "lc")

    def __init__(self):
        self.buf = bytearray()
        self.c = 0
        self.lc = 0

    def bits(self, n: int, v: int) -> None:
        self.c = (self.c << n) | v
        self.lc += n
        while self.lc >= 8:
            self.lc -= 8
            self.buf.append((self.c >> self.lc) & 0xFF)
        self.c &= (1 << self.lc) - 1

    def code(self, packed: int) -> None:
        self.bits(packed & 63, packed >> 6)

    def flush(self) -> None:
        if self.lc > 0:
            self.buf.append((self.c << (8 - self.lc)) & 0xFF)
            self.c = 0
            self.lc = 0


class _BitReader:
    __slots__ = ("data", "pos", "c", "lc")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.c = 0
        self.lc = 0

    def bits(self, n: int) -> int:
        while self.lc < n:
            self.c = (self.c << 8) | self.data[self.pos]
            self.pos += 1
            self.lc += 8
        self.lc -= n
        v = (self.c >> self.lc) & ((1 << n) - 1)
        self.c &= (1 << self.lc) - 1
        return v


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """lengths [HUF_ENCSIZE] -> packed (code << 6) | length array."""
    n = np.bincount(lengths, minlength=59).astype(np.int64)
    base = np.zeros(59, np.int64)
    c = 0
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        base[i] = c
        c = nc
    packed = np.zeros(HUF_ENCSIZE, np.int64)
    counters = base.copy()
    idx = np.nonzero(lengths)[0]
    for i in idx:
        l = int(lengths[i])
        packed[i] = l | (int(counters[l]) << 6)
        counters[l] += 1
    return packed


def _build_enc_table(freq: np.ndarray) -> Tuple[np.ndarray, int, int]:
    """freq [HUF_ENCSIZE] -> (packed codes, im, iM). Appends the RLE symbol."""
    nz = np.nonzero(freq)[0]
    im = int(nz[0])
    iM = int(nz[-1]) + 1  # run-length pseudo-symbol
    freq = freq.copy()
    freq[iM] = 1

    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    heap: List[Tuple[int, int, List[int]]] = []
    tiebreak = 0
    for s in np.nonzero(freq)[0]:
        heap.append((int(freq[s]), tiebreak, [int(s)]))
        tiebreak += 1
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, _, l1 = heapq.heappop(heap)
        f2, _, l2 = heapq.heappop(heap)
        merged = l1 + l2
        lengths[merged] += 1
        assert lengths[merged].max() <= 58, "Huffman code overflow"
        heapq.heappush(heap, (f1 + f2, tiebreak, merged))
        tiebreak += 1
    return _canonical_codes(lengths), im, iM


def _pack_enc_table(packed: np.ndarray, im: int, iM: int) -> bytes:
    w = _BitWriter()
    i = im
    while i <= iM:
        l = int(packed[i]) & 63
        if l == 0:
            zerun = 1
            while i < iM and zerun < LONGEST_LONG_RUN:
                if (int(packed[i + 1]) & 63) > 0:
                    break
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    w.bits(6, LONG_ZEROCODE_RUN)
                    w.bits(8, zerun - SHORTEST_LONG_RUN)
                else:
                    w.bits(6, SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        w.bits(6, l)
        i += 1
    w.flush()
    return bytes(w.buf)


def _unpack_enc_table(r: _BitReader, im: int, iM: int) -> np.ndarray:
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = r.bits(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = r.bits(8) + SHORTEST_LONG_RUN
            if i + zerun > iM + 1:
                raise ValueError("PIZ: table zero-run overflows")
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            if i + zerun > iM + 1:
                raise ValueError("PIZ: table zero-run overflows")
            i += zerun
        else:
            lengths[i] = l
            i += 1
    return _canonical_codes(lengths)


def _send_code(w: _BitWriter, scode: int, run: int, rcode: int) -> None:
    if (scode & 63) + (rcode & 63) + 8 < (scode & 63) * run:
        w.code(scode)
        w.code(rcode)
        w.bits(8, run)
    else:
        for _ in range(run + 1):
            w.code(scode)


def _huf_encode(packed: np.ndarray, raw: np.ndarray, rlc: int) -> Tuple[bytes, int]:
    w = _BitWriter()
    # run-length segmentation done in numpy: boundaries where value changes
    vals = raw.astype(np.int64)
    change = np.nonzero(np.diff(vals))[0]
    starts = np.concatenate(([0], change + 1))
    ends = np.concatenate((change + 1, [vals.size]))
    for st, en in zip(starts, ends):
        s = int(vals[st])
        total = int(en - st)
        # the encoder caps runs at 256 occurrences (cs < 255 extra repeats)
        while total > 0:
            chunk = min(total, 256)
            _send_code(w, int(packed[s]), chunk - 1, int(packed[rlc]))
            total -= chunk
    nbits = len(w.buf) * 8 + w.lc
    w.flush()
    return bytes(w.buf), nbits


def _huf_decode(packed: np.ndarray, data: bytes, nbits: int, rlc: int,
                n_out: int) -> np.ndarray:
    """Bit-serial canonical decode (prefix-free: shortest match wins)."""
    lengths = (packed & 63).astype(np.int64)
    by_len = {}
    for sym in np.nonzero(lengths)[0]:
        l = int(lengths[sym])
        by_len.setdefault(l, {})[int(packed[sym]) >> 6] = int(sym)
    max_len = max(by_len) if by_len else 0
    out = np.empty(n_out, np.uint16)
    k = 0
    c = 0       # bit accumulator (MSB-first)
    lc = 0      # bits buffered in c
    bitpos = 0  # bits consumed from the stream (only `nbits` are real)
    pos = 0

    def pull() -> bool:
        nonlocal c, lc, bitpos, pos
        if bitpos >= nbits:
            return False
        byte = data[pos]
        pos += 1
        avail = min(8, nbits - bitpos)  # final byte: top bits only (pad below)
        c = (c << avail) | (byte >> (8 - avail))
        lc += avail
        bitpos += avail
        return True

    while k < n_out:
        sym = None
        while sym is None:
            for l in range(1, min(lc, max_len) + 1):
                tab = by_len.get(l)
                if tab is not None and (c >> (lc - l)) in tab:
                    sym = tab[c >> (lc - l)]
                    lc -= l
                    c &= (1 << lc) - 1
                    break
            if sym is None and not pull():
                raise ValueError("PIZ: Huffman stream underrun")
        if sym == rlc:
            while lc < 8:
                if not pull():
                    raise ValueError("PIZ: run count underrun")
            lc -= 8
            run = (c >> lc) & 0xFF
            c &= (1 << lc) - 1
            if k == 0 or k + run > n_out:
                raise ValueError("PIZ: bad run length")
            out[k:k + run] = out[k - 1]
            k += run
        else:
            out[k] = sym
            k += 1
    return out


# --------------------------------------------------------------- block codec (python)

def huf_compress(raw: np.ndarray) -> bytes:
    """Standalone ImfHuf container: [im u32][iM u32][tableLength u32]
    [nBits u32][room u32=0][packed code table][bitstream]. This is the
    coder PIZ embeds after its wavelet pass; DWA's AC coefficient stream
    uses the same container when acCompression == STATIC_HUFFMAN
    (ImfDwaCompressor.cpp::uncompress -> hufUncompress)."""
    raw = np.ascontiguousarray(raw, np.uint16)
    packed, im, iM = _build_enc_table(
        np.bincount(raw, minlength=HUF_ENCSIZE).astype(np.int64))
    table = _pack_enc_table(packed, im, iM)
    data, nbits = _huf_encode(packed, raw, iM)
    return (int(im).to_bytes(4, "little") + int(iM).to_bytes(4, "little")
            + len(table).to_bytes(4, "little")
            + int(nbits).to_bytes(4, "little")
            + (0).to_bytes(4, "little") + table + data)


def huf_uncompress(buf: bytes, n_out: int) -> np.ndarray:
    """Decode a standalone ImfHuf container (see huf_compress) to `n_out`
    u16 symbols."""
    if n_out == 0:
        return np.empty(0, np.uint16)
    im = int.from_bytes(buf[0:4], "little")
    iM = int.from_bytes(buf[4:8], "little")
    nbits = int.from_bytes(buf[12:16], "little")
    r = _BitReader(buf, 20)
    packed = _unpack_enc_table(r, im, iM)
    return _huf_decode(packed, buf[r.pos:], nbits, iM, n_out)


def _piz_compress_py(planar: np.ndarray, chans: Sequence[ChannelDesc]) -> bytes:
    tmp = planar.copy()
    # bitmap of used values (zero implicit)
    used = np.zeros(USHORT_RANGE, bool)
    used[tmp] = True
    used[0] = False
    # bit (v & 7) of byte (v >> 3), LSB-first within each byte
    bitmap = np.packbits(used, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    if nz.size:
        min_nz, max_nz = int(nz[0]), int(nz[-1])
    else:
        min_nz, max_nz = BITMAP_SIZE - 1, 0
    # forward LUT
    present = used.copy()
    present[0] = True
    lut = np.cumsum(present) - 1  # value -> compact index
    max_value = int(lut[-1])
    tmp = lut[tmp].astype(np.uint16)

    for view in _channel_views(tmp, chans):
        _wav2_encode(view, max_value)

    huf = huf_compress(tmp)

    out = bytearray()
    out += int(min_nz).to_bytes(2, "little")
    out += int(max_nz).to_bytes(2, "little")
    if min_nz <= max_nz:
        out += bitmap[min_nz:max_nz + 1].tobytes()
    out += len(huf).to_bytes(4, "little")
    out += huf
    return bytes(out)


def _piz_uncompress_py(payload: bytes, chans: Sequence[ChannelDesc]) -> np.ndarray:
    n = _planar_total(chans)
    min_nz = int.from_bytes(payload[0:2], "little")
    max_nz = int.from_bytes(payload[2:4], "little")
    pos = 4
    if max_nz >= BITMAP_SIZE:
        raise ValueError("PIZ: bad bitmap bounds")
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(payload[pos:pos + nb], np.uint8)
        pos += nb
    used = np.unpackbits(bitmap, bitorder="little").astype(bool)
    used[0] = True
    rev_lut = np.nonzero(used)[0].astype(np.uint16)
    max_value = int(rev_lut.size - 1)

    length = int.from_bytes(payload[pos:pos + 4], "little")
    pos += 4
    huf = payload[pos:pos + length]
    im = int.from_bytes(huf[0:4], "little")
    iM = int.from_bytes(huf[4:8], "little")
    nbits = int.from_bytes(huf[12:16], "little")
    r = _BitReader(huf, 20)
    packed = _unpack_enc_table(r, im, iM)
    data_start = r.pos  # table is byte-padded; reader sits at the data start
    tmp = _huf_decode(packed, huf[data_start:], nbits, iM, n)

    for view in _channel_views(tmp, chans):
        _wav2_decode(view, max_value)
    return rev_lut[tmp]
