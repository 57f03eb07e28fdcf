"""A Zstandard decoder (RFC 8878) in the bitmap library, with its plain
twin in Python: TIFF's compression 50000, where libtiff writes one frame
a strip or tile.

``decompress`` runs in ``native/bitmap_zstd.cpp``; ``decompress_plain``
follows the RFC's steps in Python and is the plain version the tests
hold it to, failures included. Both decode:

  * frames one after another, skippable frames skipped; the frame
    header's window descriptor, single-segment flag, content size and
    content checksum (the low 32 bits of XXH64, checked when the flag is
    set). A frame that names a dictionary raises: TIFF's codec uses none,
    and libzstd refuses one it was not given. A window over 2^27 bytes
    (libzstd's default limit) raises;
  * raw, RLE and compressed blocks, each at most 128 KiB and at most the
    window (compressed size and content both);
  * literals raw, RLE, Huffman-coded in 1 or 4 streams (the jump table)
    and treeless (the frame's last Huffman table); Huffman weights given
    directly (4 bits each) or FSE-coded, the last weight implied;
  * sequences with their three FSE tables predefined, RLE, FSE-coded or
    repeated from the frame's last block, and the three repeat offsets
    with the literal-length-0 rule.

A corrupt or truncated stream raises ``OSError`` and never reads past
its buffer. ``limit`` stops the decoding at the first block boundary at
or past that many bytes and ``frames`` after that many frames, as
libtiff's streaming reader stops once its strip is full and after the
strip's frame.
"""
from __future__ import annotations

import numpy as np

BLOCK_MAX = 128 * 1024
WINDOW_LOG_MAX = 27
_MAGIC = 0xFD2FB528

# the predefined distributions (RFC 8878, 3.1.1.3.2.2)
LL_DEFAULT = (4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
              2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1)
ML_DEFAULT = (1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1)
OF_DEFAULT = (1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
              1, 1, 1, 1, -1, -1, -1, -1, -1)
# literal and match length codes: (baseline, extra bits)
LL_CODES = tuple((c, 0) for c in range(16)) + (
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16))
ML_CODES = tuple((c + 3, 0) for c in range(32)) + (
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16))
# (largest symbol, largest accuracy log) of the LL, OF and ML tables
_LL, _OF, _ML = (35, 9), (31, 8), (52, 9)

_ERRORS = {-1: "corrupt Zstandard data", -2: "Zstandard frame needs a "
           "dictionary", -4: "Zstandard window too large"}


def decompress(src: bytes, limit: int = -1, frames: int = -1) -> bytes:
    """The content of the Zstandard frames in ``src``, in
    ``native/bitmap_zstd.cpp``: every frame, or the first ``frames``
    (skippable ones counted), stopping at the first block boundary at or
    past ``limit`` bytes where ``limit`` >= 0. Fails as
    ``decompress_plain`` does."""
    from ..native import bitmap_library, ptr
    buf = np.frombuffer(src, np.uint8)
    cap = limit + BLOCK_MAX if limit >= 0 else max(4 * buf.size, 1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        n = bitmap_library().mnt_zstd_decompress(ptr(buf), buf.size,
                                                 ptr(out), cap, limit, frames)
        if n != -3:
            break
        cap *= 2                    # the content outgrew the buffer
    if n < 0:
        raise OSError(_ERRORS.get(n, _ERRORS[-1]))
    return out[:n].tobytes()


class _Corrupt(Exception):
    pass


def _need(ok: bool):
    if not ok:
        raise _Corrupt


_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` in Python."""
    n, pos = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed,
             (seed - _P1) & _M64]
        while pos + 32 <= n:
            for i in range(4):
                v[i] = _round(v[i], int.from_bytes(
                    data[pos + 8 * i:pos + 8 * i + 8], 'little'))
            pos += 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) +
             _rotl(v[3], 18)) & _M64
        for x in v:
            h = ((h ^ _round(0, x)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        k = _round(0, int.from_bytes(data[pos:pos + 8], 'little'))
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h = (_rotl(h ^ (int.from_bytes(data[pos:pos + 4], 'little') * _P1
                        & _M64), 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h = (_rotl(h ^ (data[pos] * _P5 & _M64), 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


class _Forward:
    """Bits of ``data[pos:end]`` read LSB first (FSE table headers);
    bits past ``end`` read as zeros, and ``close`` refuses a header that
    used them."""

    def __init__(self, data: bytes, pos: int, end: int):
        self.data, self.start, self.end, self.bit = data, pos, end, pos * 8

    def read(self, n: int) -> int:
        v = 0
        for i in range(n):
            byte = (self.bit + i) >> 3
            if byte < self.end and self.data[byte] >> ((self.bit + i) & 7) & 1:
                v |= 1 << i
        self.bit += n
        return v

    def close(self) -> int:
        pos = (self.bit + 7) >> 3
        _need(pos <= self.end)
        return pos


class _Backward:
    """A backward bit stream ``data[start:end]`` (Huffman streams, FSE
    weights and sequences): read from its last set bit toward its first
    byte, MSB first; bits before the start read as zeros."""

    def __init__(self, data: bytes, start: int, end: int):
        _need(end > start and data[end - 1] != 0)
        self.data, self.start = data, start
        self.pos = (end - start) * 8 - 8 + data[end - 1].bit_length() - 1

    def read(self, n: int) -> int:
        v = self.peek(n)
        self.pos -= n
        return v

    def peek(self, n: int) -> int:
        if n == 0:
            return 0
        lo = self.pos - n
        if lo >= 0:
            b0, b1 = lo >> 3, (self.pos - 1) >> 3
            v = int.from_bytes(self.data[self.start + b0:self.start + b1 + 1],
                               'little') >> (lo & 7)
            return v & ((1 << n) - 1)
        if self.pos <= 0:
            return 0
        v = int.from_bytes(self.data[self.start:self.start +
                                     ((self.pos - 1) >> 3) + 1], 'little')
        return (v & ((1 << self.pos) - 1)) << -lo

    def overflowed(self) -> bool:
        return self.pos < 0

    def done(self) -> bool:
        return self.pos == 0


def _fse_header(data: bytes, pos: int, end: int, max_sym: int,
                max_log: int):
    """An FSE table description at ``data[pos:end]``: (normalised counts,
    accuracy log, the position after it)."""
    rd = _Forward(data, pos, end)
    log = rd.read(4) + 5
    _need(log <= max_log)
    remaining, threshold, bits = (1 << log) + 1, 1 << log, log + 1
    probs = []
    while remaining > 1:
        _need(len(probs) <= max_sym)
        low = rd.read(bits - 1)
        top = 2 * threshold - 1 - remaining
        if low < top:
            count = low
        else:
            count = low | rd.read(1) << (bits - 1)
            if count >= threshold:
                count -= top
        count -= 1
        remaining -= abs(count)
        probs.append(count)
        if count == 0:
            while True:
                rep = rd.read(2)
                probs += [0] * rep
                if rep != 3:
                    break
            _need(len(probs) <= max_sym + 1)
        while remaining < threshold and threshold > 1:
            bits -= 1
            threshold >>= 1
    _need(remaining == 1 and len(probs) <= max_sym + 1)
    return probs, log, rd.close()


def _fse_table(probs, log: int):
    """The decoding table of normalised counts: (symbol, bits, base) per
    state."""
    size = 1 << log
    _need(sum(abs(p) for p in probs) == size)
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(probs)
    for s, p in enumerate(probs):
        if p == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step, pos = (size >> 1) + (size >> 3) + 3, 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & (size - 1)
            while pos > high:
                pos = (pos + step) & (size - 1)
    _need(pos == 0)
    table = []
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        table.append((s, nb, (x << nb) - size))
    return table, log


def _huffman_table(data: bytes, pos: int, end: int):
    """A Huffman tree description at ``data[pos:end]``: ((symbol, bits)
    per index of ``max_bits`` bits, max_bits), and the position after
    it."""
    _need(pos < end)
    head = data[pos]
    pos += 1
    if head >= 128:
        n = head - 127
        _need(pos + (n + 1) // 2 <= end)
        weights = [data[pos + i // 2] >> (4 * (1 - i % 2)) & 15
                   for i in range(n)]
        pos += (n + 1) // 2
    else:
        _need(head > 0 and pos + head <= end)
        probs, log, hdr_end = _fse_header(data, pos, pos + head, 255, 6)
        table, _ = _fse_table(probs, log)
        rd = _Backward(data, hdr_end, pos + head)
        s1 = rd.read(log)
        s2 = rd.read(log)
        weights = []
        states = [s1, s2]
        k = 0
        while True:
            _need(len(weights) < 254)
            s, nb, base = table[states[k]]
            weights.append(s)
            states[k] = base + rd.read(nb)
            if rd.overflowed():
                weights.append(table[states[1 - k]][0])
                break
            k = 1 - k
        pos += head
    _need(all(w <= 11 for w in weights))
    total = sum(1 << (w - 1) for w in weights if w)
    _need(total > 0)
    max_bits = total.bit_length()
    _need(max_bits <= 11)
    rest = (1 << max_bits) - total
    _need(rest & (rest - 1) == 0)
    weights.append(rest.bit_length())
    _need(len(weights) <= 256 and sum(1 for w in weights if w == 1) >= 2
          and sum(1 for w in weights if w == 1) % 2 == 0)
    table = []
    for w in range(1, max_bits + 1):
        for s, ws in enumerate(weights):
            if ws == w:
                table += [(s, max_bits + 1 - w)] * (1 << (w - 1))
    return (table, max_bits), pos


def _huffman_stream(data: bytes, start: int, end: int, n: int, huf,
                    out: bytearray):
    table, max_bits = huf
    rd = _Backward(data, start, end)
    for _ in range(n):
        s, nb = table[rd.peek(max_bits)]
        out.append(s)
        rd.pos -= nb
    _need(rd.done())


def _literals(data: bytes, pos: int, end: int, state: dict):
    """The literals section at ``data[pos:end]``: (literals, the position
    after it)."""
    _need(pos < end)
    b0 = data[pos]
    kind, fmt = b0 & 3, b0 >> 2 & 3
    if kind < 2:
        head = {0: 1, 2: 1, 1: 2, 3: 3}[fmt]
        _need(pos + head <= end)
        v = int.from_bytes(data[pos:pos + head], 'little')
        size = v >> 3 if head == 1 else v >> 4
        _need(size <= BLOCK_MAX)
        pos += head
        if kind == 0:
            _need(pos + size <= end)
            return bytes(data[pos:pos + size]), pos + size
        _need(pos < end)
        return bytes([data[pos]]) * size, pos + 1
    head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    _need(pos + head <= end)
    v = int.from_bytes(data[pos:pos + head], 'little')
    bits = {3: 10, 4: 14, 5: 18}[head]
    size = v >> 4 & ((1 << bits) - 1)
    csize = v >> (4 + bits) & ((1 << bits) - 1)
    _need(size <= BLOCK_MAX)
    pos += head
    stop = pos + csize
    _need(stop <= end)
    if kind == 2:
        state['huf'], pos = _huffman_table(data, pos, stop)
    else:
        _need(state['huf'] is not None)
    out = bytearray()
    if fmt == 0:
        _huffman_stream(data, pos, stop, size, state['huf'], out)
    else:
        # libzstd: a jump table and a byte a stream, six literals
        _need(stop - pos >= 10 and size >= 6)
        sizes = [int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], 'little')
                 for i in range(3)]
        pos += 6
        sizes.append(stop - pos - sum(sizes))
        _need(sizes[3] >= 0)
        seg = (size + 3) // 4
        _need(size >= 3 * seg)
        for i, n in enumerate(sizes):
            _huffman_stream(data, pos, pos + n, seg if i < 3 else
                            size - 3 * seg, state['huf'], out)
            pos += n
    return bytes(out), stop


def _seq_table(mode: int, data: bytes, pos: int, end: int, which: str,
               state: dict):
    """A sequence symbol table of ``mode`` (0 predefined, 1 RLE, 2 FSE, 3
    repeat): (table, the position after it)."""
    limits, default, default_log = {
        'll': (_LL, LL_DEFAULT, 6), 'of': (_OF, OF_DEFAULT, 5),
        'ml': (_ML, ML_DEFAULT, 6)}[which]
    if mode == 0:
        table = _fse_table(list(default), default_log)
    elif mode == 1:
        _need(pos < end and data[pos] <= limits[0])
        table = ([(data[pos], 0, 0)], 0)
        pos += 1
    elif mode == 2:
        probs, log, pos = _fse_header(data, pos, end, *limits)
        table = _fse_table(probs, log)
    else:
        _need(state[which] is not None)
        table = state[which]
    state[which] = table
    return table, pos


def _block(data: bytes, pos: int, end: int, out: bytearray, base: int,
           state: dict, block_max: int):
    """A compressed block ``data[pos:end]`` appended to ``out``, whose
    frame starts at ``base``."""
    lits, pos = _literals(data, pos, end, state)
    _need(len(lits) <= block_max)
    _need(pos < end)
    b0 = data[pos]
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        _need(pos + 2 <= end)
        nseq, pos = (b0 - 128 << 8) + data[pos + 1], pos + 2
    else:
        _need(pos + 3 <= end)
        nseq = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00
        pos += 3
    start = len(out)
    if nseq == 0:
        _need(pos == end)
        out += lits
        return
    _need(pos < end)
    modes = data[pos]
    _need(modes & 3 == 0)
    pos += 1
    ll, pos = _seq_table(modes >> 6, data, pos, end, 'll', state)
    of, pos = _seq_table(modes >> 4 & 3, data, pos, end, 'of', state)
    ml, pos = _seq_table(modes >> 2 & 3, data, pos, end, 'ml', state)
    rd = _Backward(data, pos, end)
    st = [rd.read(ll[1]), rd.read(of[1]), rd.read(ml[1])]
    rep = state['rep']
    lit = 0
    for k in range(nseq):
        ofc = of[0][st[1]][0]
        llc = ll[0][st[0]][0]
        mlc = ml[0][st[2]][0]
        _need(ofc <= 31)
        ofv = (1 << ofc) + rd.read(ofc)
        mlv = ML_CODES[mlc][0] + rd.read(ML_CODES[mlc][1])
        llv = LL_CODES[llc][0] + rd.read(LL_CODES[llc][1])
        if k + 1 < nseq:
            for i in (0, 2, 1):
                tab = (ll, of, ml)[i][0]
                _, nb, b = tab[st[i]]
                st[i] = b + rd.read(nb)
        if ofv > 3:
            offset = ofv - 3
            rep[:] = [offset, rep[0], rep[1]]
        else:
            idx = ofv - 1 + (llv == 0)
            if idx == 0:
                offset = rep[0]
            elif idx == 3:
                offset = rep[0] - 1
                _need(offset > 0)
                rep[:] = [offset, rep[0], rep[1]]
            elif idx == 1:
                offset = rep[1]
                rep[:] = [offset, rep[0], rep[2]]
            else:
                offset = rep[2]
                rep[:] = [offset, rep[0], rep[1]]
        _need(lit + llv <= len(lits))
        out += lits[lit:lit + llv]
        lit += llv
        _need(0 < offset <= len(out) - base)
        _need(len(out) + mlv - start <= block_max)
        src = len(out) - offset
        if offset >= mlv:
            out += out[src:src + mlv]
        else:
            for i in range(mlv):
                out.append(out[src + i])
    _need(rd.done())
    out += lits[lit:]
    _need(len(out) - start <= block_max)


def decompress_plain(src: bytes, limit: int = -1, frames: int = -1) -> bytes:
    """``decompress`` in Python."""
    try:
        return _frames(bytes(src), limit, frames)
    except _Corrupt:
        raise OSError(_ERRORS[-1]) from None


def _frames(data: bytes, limit: int, frames: int) -> bytes:
    out = bytearray()
    pos, n = 0, len(data)
    while pos < n and frames != 0 and not 0 <= limit <= len(out):
        frames -= 1
        _need(pos + 4 <= n)
        magic = int.from_bytes(data[pos:pos + 4], 'little')
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            _need(pos + 8 <= n)
            size = int.from_bytes(data[pos + 4:pos + 8], 'little')
            _need(pos + 8 + size <= n)
            pos += 8 + size
            continue
        _need(magic == _MAGIC and pos + 5 <= n)
        fhd = data[pos + 4]
        pos += 5
        fcs_flag, single, checksum = fhd >> 6, fhd >> 5 & 1, fhd >> 2 & 1
        _need(fhd & 8 == 0)
        did_size = (0, 1, 2, 4)[fhd & 3]
        fcs_size = (single, 2, 4, 8)[fcs_flag]
        _need(pos + (1 - single) + did_size + fcs_size <= n)
        window = 0
        if not single:
            wd = data[pos]
            pos += 1
            log = 10 + (wd >> 3)
            window = (1 << log) + ((1 << log) >> 3) * (wd & 7)
        did = int.from_bytes(data[pos:pos + did_size], 'little')
        pos += did_size
        if did:
            raise OSError(_ERRORS[-2])
        fcs = int.from_bytes(data[pos:pos + fcs_size], 'little') \
            if fcs_size else -1
        if fcs_size == 2:
            fcs += 256
        pos += fcs_size
        if single:
            window = fcs
        if window > 1 << WINDOW_LOG_MAX:
            raise OSError(_ERRORS[-4])
        block_max = min(window, BLOCK_MAX)
        base = len(out)
        state = {'huf': None, 'll': None, 'of': None, 'ml': None,
                 'rep': [1, 4, 8]}
        while True:
            _need(pos + 3 <= n)
            bh = int.from_bytes(data[pos:pos + 3], 'little')
            pos += 3
            last, kind, size = bh & 1, bh >> 1 & 3, bh >> 3
            _need(kind != 3 and size <= block_max)
            if kind == 0:
                _need(pos + size <= n)
                out += data[pos:pos + size]
                pos += size
            elif kind == 1:
                _need(pos < n)
                out += bytes([data[pos]]) * size
                pos += 1
            else:
                _need(pos + size <= n)
                _block(data, pos, pos + size, out, base, state, block_max)
                pos += size
            if not last and 0 <= limit <= len(out):
                return bytes(out)
            if last:
                break
        _need(fcs < 0 or len(out) - base == fcs)
        if checksum:
            _need(pos + 4 <= n)
            want = int.from_bytes(data[pos:pos + 4], 'little')
            _need(xxh64(bytes(out[base:])) & 0xFFFFFFFF == want)
            pos += 4
    return bytes(out)
