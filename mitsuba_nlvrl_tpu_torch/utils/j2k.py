"""A JPEG 2000 codestream decoder (ISO 15444-1) in numpy and the bitmap
library (no PIL), as openjpeg 2.5 decodes for PIL's ``Jpeg2KImagePlugin``:
every layer at full resolution (PIL's ``reduce`` and ``layers`` are 0).

  * the main and tile-part headers: SIZ, COD, COC, QCD, QCC, RGN, POC
    and COM; TLM, PLM, PLT and CRG are read past; tile parts (SOT, SOD)
    in any order, a tile decoded once its parts are gathered (a COC or
    QCC outranks a COD or QCD of its header, a tile's outrank the main
    header's; POC progressions add up, as openjpeg reads them);
  * the geometry: image and tile offsets, tile-components, resolutions,
    subbands, precincts and code-blocks, the partitions anchored at the
    origin of their own coordinates (so offsets give empty precincts);
  * tier 2: tag trees and packet headers (SOP and EPH markers, empty
    packets, inclusion, zero bit planes, the number of passes, Lblock and
    the segment lengths, a segment's passes bounded as the code-block
    style says), the five progression orders LRCP, RLCP, RPCL, PCRL and
    CPRL, and POC's;
  * quantisation: reversible, scalar derived and scalar expounded, with
    guard bits, as openjpeg sets each band's step (its 9/7 synthesis
    scales the high band by its historic ``two_invK``, so the decoder's
    step has no band gain), and RGN's maximum shift;
  * tier 1 (``_t1``: the MQ decoder and the three coding passes of every
    code-block, each pass's segments gathered across layers and tile
    parts, under every code-block style: bypass, reset, termination on
    each pass, vertically causal contexts, predictable termination and
    segmentation symbols), the inverse 5/3 wavelet in integers
    (``_idwt53``), the inverse 9/7 in float32 (``_idwt97``), and the RCT
    or ICT with the DC level shift, rounding half to even and clamping
    (``_finish``): each in ``native/bitmap_j2k.cpp``, with its plain twin
    ``<stage>_plain`` here.

What no fixture covers raises ``NotImplementedError`` naming ROADMAP 12.7:
PPM and PPT (packed packet headers), Part 2 markers, subsampled
components, more than 16 bits a sample, and HTJ2K (its CAP marker, the
Rsiz bit or the code-block style bit). A stream cut short or broken fails
with ``OSError``, as PIL's decoder does (openjpeg in its strict mode,
PIL's default).
"""
from __future__ import annotations

import struct

import numpy as np

from ..scene.types import not_in_slice

SOC, SOT, SOD, EOC = 0xFF4F, 0xFF90, 0xFF93, 0xFFD9
SIZ, COD, COC, QCD, QCC, COM = 0xFF51, 0xFF52, 0xFF53, 0xFF5C, 0xFF5D, \
    0xFF64
RGN, POC = 0xFF5E, 0xFF5F
_SKIPPED = {0xFF55: 'TLM', 0xFF57: 'PLM', 0xFF58: 'PLT', 0xFF63: 'CRG',
            COM: 'COM'}
_REFUSED = {0xFF50: 'CAP (HTJ2K)', 0xFF59: 'CPF (HTJ2K)', 0xFF60: 'PPM',
            0xFF61: 'PPT', 0xFF74: 'MCT', 0xFF75: 'MCC', 0xFF77: 'MCO',
            0xFF78: 'CBD'}
PROGRESSIONS = ('LRCP', 'RLCP', 'RPCL', 'PCRL', 'CPRL')


def _refuse(what: str):
    return not_in_slice(f"JPEG 2000 {what}",
                        "item 12.7 (other bitmap formats)")


def _broken(what: str) -> OSError:
    return OSError(f"broken JPEG 2000 data stream: {what}")


# --- headers -----------------------------------------------------------------

def _siz(body: bytes) -> dict:
    if len(body) < 36:
        raise _broken("short SIZ")
    rsiz, X, Y, XO, YO, XT, YT, XTO, YTO, C = struct.unpack_from(
        '>HIIIIIIIIH', body)
    if rsiz & 0x4000:
        raise _refuse("HTJ2K codestream (Rsiz bit 14)")
    if len(body) < 36 + 3 * C or C == 0:
        raise _broken("short SIZ")
    comps = []
    for c in range(C):
        ssiz, dx, dy = body[36 + 3 * c:39 + 3 * c]
        comps.append({'prec': (ssiz & 0x7F) + 1, 'sgnd': bool(ssiz & 0x80),
                      'dx': dx, 'dy': dy})
        if dx == 0 or dy == 0:
            raise _broken("component sampling of 0")
    if XT == 0 or YT == 0 or XO >= X or YO >= Y or XTO > XO or YTO > YO \
            or XTO + XT <= XO or YTO + YT <= YO:
        raise _broken("bad image or tile geometry")
    for c in comps:
        if c['dx'] != 1 or c['dy'] != 1:
            raise _refuse("subsampled component")
        if c['prec'] > 16:
            raise _refuse(f"{c['prec']}-bit component")
    return {'X': X, 'Y': Y, 'XO': XO, 'YO': YO, 'XT': XT, 'YT': YT,
            'XTO': XTO, 'YTO': YTO, 'comps': comps}


def _spcod(body: bytes, pos: int, precincts: bool) -> dict:
    """SPcod / SPcoc from ``pos``: levels, code-block size and style,
    transform and the precinct sizes."""
    if len(body) < pos + 5:
        raise _broken("short COD/COC")
    levels, xcb, ycb, style, qmfbid = body[pos:pos + 5]
    if levels > 32 or xcb > 8 or ycb > 8 or xcb + ycb > 8 or qmfbid > 1:
        raise _broken("bad coding style")
    if style & 0x40:
        raise _refuse("HTJ2K code-blocks (code-block style bit 6)")
    if style & 0x80:
        raise _broken("reserved code-block style bit")
    numres = levels + 1
    if precincts:
        pp = body[pos + 5:pos + 5 + numres]
        if len(pp) < numres:
            raise _broken("short COD/COC")
        pp = [(b & 15, b >> 4) for b in pp]
        for r, (px, py) in enumerate(pp):
            if r and (px == 0 or py == 0):
                raise _broken("precinct of size 1 above resolution 0")
    else:
        pp = [(15, 15)] * numres
    return {'numres': numres, 'xcb': xcb + 2, 'ycb': ycb + 2,
            'style': style, 'qmfbid': qmfbid, 'pp': pp}


def _cod(body: bytes) -> tuple:
    if len(body) < 5:
        raise _broken("short COD")
    scod, prog, layers, mct = struct.unpack_from('>BBHB', body)
    if prog > 4 or layers == 0:
        raise _broken("bad progression or layer count")
    return {'prog': prog, 'layers': layers, 'mct': mct,
            'sop': bool(scod & 2), 'eph': bool(scod & 4)}, \
        _spcod(body, 5, bool(scod & 1))


def _coc(body: bytes, ncomp: int) -> tuple:
    n = 2 if ncomp >= 257 else 1             # Ccoc's bytes
    if len(body) < n + 1:
        raise _broken("short COC")
    c = struct.unpack_from('>H', body)[0] if n == 2 else body[0]
    if c >= ncomp:
        raise _broken("COC of a missing component")
    return c, _spcod(body, n + 1, bool(body[n] & 1))


def _qcd(body: bytes, pos: int = 0) -> dict:
    if len(body) <= pos:
        raise _broken("short QCD/QCC")
    sq = body[pos]
    style, guard = sq & 31, sq >> 5
    rest = body[pos + 1:]
    if style == 0:
        steps = [(b >> 3, 0) for b in rest]
    elif style in (1, 2):
        if len(rest) < 2:
            raise _broken("short QCD/QCC")
        steps = [(v >> 11, v & 0x7FF) for v in struct.unpack_from(
            f'>{len(rest) // 2}H', rest)]
        if style == 1:
            steps = steps[:1]
    else:
        raise _broken("bad quantisation style")
    if not steps:
        raise _broken("short QCD/QCC")
    return {'style': style, 'guard': guard, 'steps': steps}


def _qcc(body: bytes, ncomp: int) -> tuple:
    wide = ncomp >= 257
    c = (struct.unpack_from('>H', body)[0] if wide else body[0]) \
        if len(body) >= 1 + wide else ncomp
    if c >= ncomp:
        raise _broken("QCC of a missing component")
    return c, _qcd(body, 2 if wide else 1)


def _rgn(body: bytes, ncomp: int) -> tuple:
    """RGN: (component, the ROI's maximum shift)."""
    n = 2 if ncomp >= 257 else 1
    if len(body) < n + 2:
        raise _broken("short RGN")
    c = struct.unpack_from('>H', body)[0] if n == 2 else body[0]
    if c >= ncomp or body[n] != 0:
        raise _broken("bad RGN")
    return c, body[n + 1]


def _poc(body: bytes, ncomp: int) -> list:
    """POC: each progression's (first resolution, first component,
    layers, resolutions, components, order), as openjpeg reads them (a
    component bound of 0 is 256, and none past the last component)."""
    n = 2 if ncomp >= 257 else 1
    size = 5 + 2 * n
    out = []
    for k in range(len(body) // size):
        b = body[k * size:(k + 1) * size]
        r0 = b[0]
        c0 = struct.unpack_from('>H', b, 1)[0] if n == 2 else b[1]
        lay, r1 = struct.unpack_from('>HB', b, 1 + n)
        c1 = struct.unpack_from('>H', b, 4 + n)[0] if n == 2 else b[4 + n]
        prog = b[size - 1]
        if prog > 4:
            raise _broken("bad POC progression")
        out.append((r0, c0, lay, r1, min(c1 or 256, ncomp), prog))
    if not out:
        raise _broken("short POC")
    return out


def _segments(data: bytes, pos: int, stop: int):
    """(marker, body, next position) of each marker segment from ``pos``
    up to and including the first whose marker is in ``stop``."""
    while True:
        if pos + 2 > len(data):
            raise _broken("stream ends inside a header")
        marker = struct.unpack_from('>H', data, pos)[0]
        if marker in stop:
            yield marker, b'', pos + 2
            return
        if marker >> 8 != 0xFF or marker < 0xFF40:
            raise _broken(f"expected a marker at {pos}")
        if pos + 4 > len(data):
            raise _broken("stream ends inside a header")
        n = struct.unpack_from('>H', data, pos + 2)[0]
        if n < 2 or pos + 2 + n > len(data):
            raise _broken("marker segment past the stream's end")
        yield marker, data[pos + 4:pos + 2 + n], pos + 2 + n
        pos += 2 + n


class _Params:
    """Coding and quantisation parameters of the main header, or of one
    tile (a copy, its tile-part header's markers applied)."""

    def __init__(self, ncomp: int):
        self.ncomp = ncomp
        self.cod = None                  # SGcod: prog, layers, mct
        self.cod_c = [None] * ncomp      # SPcod per component
        self.coc_set = [False] * ncomp
        self.qcd = [None] * ncomp
        self.qcc_set = [False] * ncomp
        self.roi = [0] * ncomp           # RGN's shift of each component
        self.pocs = []

    def copy(self) -> '_Params':
        p = _Params(self.ncomp)
        p.cod, p.cod_c, p.qcd = self.cod, list(self.cod_c), list(self.qcd)
        p.roi, p.pocs = list(self.roi), list(self.pocs)
        return p

    def apply(self, marker: int, body: bytes) -> None:
        """A COD, COC, QCD or QCC: a COC or QCC outranks a COD or QCD of
        the same header, whatever their order."""
        if marker == COD:
            self.cod, sp = _cod(body)
            for c in range(self.ncomp):
                if not self.coc_set[c]:
                    self.cod_c[c] = sp
        elif marker == COC:
            c, sp = _coc(body, self.ncomp)
            self.cod_c[c], self.coc_set[c] = sp, True
        elif marker == QCD:
            q = _qcd(body)
            for c in range(self.ncomp):
                if not self.qcc_set[c]:
                    self.qcd[c] = q
        else:
            c, q = _qcc(body, self.ncomp)
            self.qcd[c], self.qcc_set[c] = q, True

    def check(self) -> None:
        if self.cod is None or None in self.cod_c or None in self.qcd:
            raise _broken("no COD or QCD for a component")


def _header_marker(params: _Params, marker: int, body: bytes) -> None:
    if marker in (COD, COC, QCD, QCC):
        params.apply(marker, body)
    elif marker == RGN:
        c, shift = _rgn(body, params.ncomp)
        params.roi[c] = shift
    elif marker == POC:
        params.pocs = params.pocs + _poc(body, params.ncomp)
    elif marker in _REFUSED:
        raise _refuse(f"{_REFUSED[marker]} marker")
    elif marker not in _SKIPPED:
        raise _refuse(f"marker {marker:#06x}")


def parse(data: bytes):
    """The SIZ fields, the main header's parameters and each tile's parts:
    ``(siz, params, tiles)``, ``tiles`` mapping a tile's index to its
    parameters and its packet data (every part's body, in order)."""
    if data[:2] != b'\xff\x4f':
        raise _broken("no SOC marker")
    segs = _segments(data, 2, (SOT,))
    marker, body, pos = next(segs)
    if marker != SIZ:
        raise _broken("SIZ is not the first marker segment")
    siz = _siz(body)
    params = _Params(len(siz['comps']))
    for marker, body, pos in segs:
        if marker != SOT:
            _header_marker(params, marker, body)
    params.check()
    ntx = -(-(siz['X'] - siz['XTO']) // siz['XT'])
    nty = -(-(siz['Y'] - siz['YTO']) // siz['YT'])
    tiles = {}
    pos -= 2
    while True:
        if pos + 2 > len(data):
            raise _broken("no EOC marker")
        marker = struct.unpack_from('>H', data, pos)[0]
        if marker == EOC:
            break
        if marker != SOT or pos + 12 > len(data):
            raise _broken("expected SOT or EOC")
        lsot, isot, psot = struct.unpack_from('>HHI', data, pos + 2)
        if lsot != 10 or isot >= ntx * nty:
            raise _broken("bad SOT")
        start = pos
        end = len(data) - 2 if psot == 0 else start + psot
        if end > len(data) or end < start + 14:
            raise _broken("tile part past the stream's end")
        first = isot not in tiles
        if first:
            tiles[isot] = [params.copy(), []]
        tp = tiles[isot][0]
        tile_hdr = _Params(tp.ncomp) if first else None
        for marker, body, p in _segments(data, pos + 12, (SOD,)):
            if marker == SOD:
                break
            if p > end:
                raise _broken("tile-part header past its part")
            if marker in (COD, COC, QCD, QCC):
                if not first:
                    raise _broken(f"{marker:#06x} in a later tile part")
                tile_hdr.apply(marker, body)
            else:
                _header_marker(tp, marker, body)
        if first:
            # the tile's own COC/QCC outrank its COD/QCD, which outrank
            # the main header's COC/QCC
            if tile_hdr.cod is not None:
                tp.cod = tile_hdr.cod
            for c in range(tp.ncomp):
                if tile_hdr.cod_c[c] is not None:
                    tp.cod_c[c] = tile_hdr.cod_c[c]
                if tile_hdr.qcd[c] is not None:
                    tp.qcd[c] = tile_hdr.qcd[c]
        if p > end:
            raise _broken("SOD past its part")
        tiles[isot][1].append(data[p:end])
        pos = end
    return siz, params, {t: (v[0], b''.join(v[1])) for t, v in tiles.items()}


# --- geometry ----------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _cdiv2(a: int, n: int) -> int:
    return -((-a) >> n)


class _Block:
    __slots__ = ('x0', 'y0', 'x1', 'y1', 'included', 'numbps', 'lblock',
                 'segs', 'chunks')

    def __init__(self, x0, y0, x1, y1):
        self.x0, self.y0, self.x1, self.y1 = x0, y0, x1, y1
        self.included = False
        self.numbps = 0
        self.lblock = 3
        self.segs = []          # [passes, length] of each segment
        self.chunks = []


class _TagTree:
    """A tag tree of w x h leaves (openjpeg's ``opj_tgt``): each node's
    value (999 until known) and lower bound, and its parent."""

    def __init__(self, w: int, h: int):
        parent, levels = [], []
        n0, dims = 0, [(w, h)]
        while dims[-1][0] * dims[-1][1] > 1:
            pw, ph = dims[-1]
            dims.append(((pw + 1) // 2, (ph + 1) // 2))
        for k, (lw, lh) in enumerate(dims):
            levels.append(n0)
            n0 += lw * lh
        for k, (lw, lh) in enumerate(dims):
            for y in range(lh):
                for x in range(lw):
                    if k + 1 < len(dims):
                        pw = dims[k + 1][0]
                        parent.append(levels[k + 1] + (y // 2) * pw + x // 2)
                    else:
                        parent.append(-1)
        self.parent = parent
        self.value = [999] * n0
        self.low = [0] * n0

    def decode(self, bits, leaf: int, threshold: int) -> bool:
        """openjpeg's ``opj_tgt_decode``: whether the leaf's value is
        below ``threshold``, reading bits as far as that needs."""
        path = []
        node = leaf
        while self.parent[node] >= 0:
            path.append(node)
            node = self.parent[node]
        low = 0
        while True:
            if low > self.low[node]:
                self.low[node] = low
            else:
                low = self.low[node]
            while low < threshold and low < self.value[node]:
                if bits.bit():
                    self.value[node] = low
                else:
                    low += 1
            self.low[node] = low
            if not path:
                break
            node = path.pop()
        return self.value[node] < threshold


class _Precinct:
    __slots__ = ('bands',)

    def __init__(self):
        self.bands = []          # (band, cw, blocks, incl tree, msb tree)


class _Band:
    __slots__ = ('orient', 'x0', 'y0', 'x1', 'y1', 'mb', 'step', 'ox', 'oy')


class _Res:
    __slots__ = ('x0', 'y0', 'x1', 'y1', 'pdx', 'pdy', 'pw', 'ph', 'bands',
                 'precincts')


def _tilecomp(siz: dict, t: int, c: int, sp: dict, q: dict) -> dict:
    """The geometry of tile ``t``'s component ``c``: its extent, and each
    resolution's bands and precincts with their code-blocks, as openjpeg's
    ``opj_tcd_init_tile`` lays them out."""
    ntx = _cdiv(siz['X'] - siz['XTO'], siz['XT'])
    p, qy = t % ntx, t // ntx
    tx0 = max(siz['XTO'] + p * siz['XT'], siz['XO'])
    ty0 = max(siz['YTO'] + qy * siz['YT'], siz['YO'])
    tx1 = min(siz['XTO'] + (p + 1) * siz['XT'], siz['X'])
    ty1 = min(siz['YTO'] + (qy + 1) * siz['YT'], siz['Y'])
    comp = siz['comps'][c]
    tcx0, tcy0 = _cdiv(tx0, comp['dx']), _cdiv(ty0, comp['dy'])
    tcx1, tcy1 = _cdiv(tx1, comp['dx']), _cdiv(ty1, comp['dy'])
    numres = sp['numres']
    steps = q['steps']
    if q['style'] == 1:              # derived from the LL band's
        e0, m0 = steps[0]
        steps = [(max(e0 - (b - 1) // 3, 0) if b else e0, m0)
                 for b in range(3 * numres - 2)]
    elif len(steps) < 3 * numres - 2:
        raise _broken("fewer step sizes than bands")
    res_list = []
    for r in range(numres):
        lev = numres - 1 - r
        R = _Res()
        R.x0, R.y0 = _cdiv2(tcx0, lev), _cdiv2(tcy0, lev)
        R.x1, R.y1 = _cdiv2(tcx1, lev), _cdiv2(tcy1, lev)
        R.pdx, R.pdy = sp['pp'][r]
        px0 = (R.x0 >> R.pdx) << R.pdx
        py0 = (R.y0 >> R.pdy) << R.pdy
        px1 = _cdiv2(R.x1, R.pdx) << R.pdx
        py1 = _cdiv2(R.y1, R.pdy) << R.pdy
        R.pw = 0 if R.x0 == R.x1 else (px1 - px0) >> R.pdx
        R.ph = 0 if R.y0 == R.y1 else (py1 - py0) >> R.pdy
        if r == 0:
            cbg_x0, cbg_y0, cbgw, cbgh = px0, py0, R.pdx, R.pdy
            orients = (0,)
        else:
            cbg_x0, cbg_y0 = _cdiv2(px0, 1), _cdiv2(py0, 1)
            cbgw, cbgh = R.pdx - 1, R.pdy - 1
            orients = (1, 2, 3)
        cbw, cbh = min(sp['xcb'], cbgw), min(sp['ycb'], cbgh)
        R.bands = []
        for orient in orients:
            B = _Band()
            B.orient = orient
            if r == 0:
                B.x0, B.y0 = _cdiv2(tcx0, lev), _cdiv2(tcy0, lev)
                B.x1, B.y1 = _cdiv2(tcx1, lev), _cdiv2(tcy1, lev)
                bandno = 0
            else:
                xb, yb = orient & 1, orient >> 1
                B.x0 = _cdiv2(tcx0 - (xb << lev), lev + 1)
                B.y0 = _cdiv2(tcy0 - (yb << lev), lev + 1)
                B.x1 = _cdiv2(tcx1 - (xb << lev), lev + 1)
                B.y1 = _cdiv2(tcy1 - (yb << lev), lev + 1)
                bandno = 3 * (r - 1) + orient
            expn, mant = steps[bandno]
            B.mb = expn + q['guard'] - 1
            # openjpeg's decoder: no band gain for the 9/7 (its synthesis
            # scales the high band by two_invK instead)
            B.step = float(np.float32((1.0 + mant / 2048.0)
                                      * 2.0 ** (comp['prec'] - expn)))
            # where the band's coefficients sit in the tile-component
            B.ox = (res_list[r - 1].x1 - res_list[r - 1].x0) \
                if orient & 1 else 0
            B.oy = (res_list[r - 1].y1 - res_list[r - 1].y0) \
                if orient & 2 else 0
            R.bands.append(B)
        R.precincts = []
        for k in range(R.pw * R.ph):
            P = _Precinct()
            gx0 = cbg_x0 + (k % R.pw) * (1 << cbgw)
            gy0 = cbg_y0 + (k // R.pw) * (1 << cbgh)
            for B in R.bands:
                if B.x0 >= B.x1 or B.y0 >= B.y1:
                    continue                     # an empty band: no blocks
                x0, y0 = max(gx0, B.x0), max(gy0, B.y0)
                x1 = min(gx0 + (1 << cbgw), B.x1)
                y1 = min(gy0 + (1 << cbgh), B.y1)
                bx0, by0 = (x0 >> cbw) << cbw, (y0 >> cbh) << cbh
                cw = max(0, (_cdiv2(x1, cbw) << cbw) - bx0 >> cbw)
                ch = max(0, (_cdiv2(y1, cbh) << cbh) - by0 >> cbh)
                blocks = []
                for j in range(cw * ch):
                    cx = bx0 + (j % cw) * (1 << cbw)
                    cy = by0 + (j // cw) * (1 << cbh)
                    blocks.append(_Block(max(cx, x0), max(cy, y0),
                                         min(cx + (1 << cbw), x1),
                                         min(cy + (1 << cbh), y1)))
                trees = (_TagTree(cw, ch), _TagTree(cw, ch)) if blocks \
                    else (None, None)
                P.bands.append((B, blocks) + trees)
            R.precincts.append(P)
        res_list.append(R)
    return {'x0': tcx0, 'y0': tcy0, 'x1': tcx1, 'y1': tcy1, 'res': res_list,
            'dx': comp['dx'], 'dy': comp['dy'], 'tx0': tx0, 'ty0': ty0,
            'tx1': tx1, 'ty1': ty1}


def _progression(prog: int, layers: int, tcs: list, pocs=()) -> list:
    """The (layer, resolution, component, precinct) of each packet of a
    tile, in openjpeg's order (``pi.c``): the progression ``prog`` over
    every packet, or each POC progression in turn over its resolutions,
    components and layers, a packet already given skipped."""
    ncomp = len(tcs)
    maxres = max(len(tc['res']) for tc in tcs)
    order, seen = [], set()

    def emit(lay, r, c, k):
        if (lay, r, c, k) not in seen:
            seen.add((lay, r, c, k))
            order.append((lay, r, c, k))
    tc0 = tcs[0]
    tx0, ty0, tx1, ty1 = tc0['tx0'], tc0['ty0'], tc0['tx1'], tc0['ty1']

    def steps(comps):
        dx = dy = 0
        for c in comps:
            tc = tcs[c]
            n = len(tc['res'])
            for r, R in enumerate(tc['res']):
                ddx = tc['dx'] << (R.pdx + n - 1 - r)
                ddy = tc['dy'] << (R.pdy + n - 1 - r)
                dx = ddx if not dx else min(dx, ddx)
                dy = ddy if not dy else min(dy, ddy)
        return dx, dy

    def positions(dx, dy):
        y = ty0
        while y < ty1:
            x = tx0
            while x < tx1:
                yield x, y
                x += dx - x % dx
            y += dy - y % dy

    def precinct(c, r, x, y):
        """The precinct of (c, r) that starts at reference point (x, y),
        or None (B.12.1.3)."""
        tc = tcs[c]
        if r >= len(tc['res']):
            return None
        R = tc['res'][r]
        lev = len(tc['res']) - 1 - r
        sx, sy = tc['dx'] << lev, tc['dy'] << lev
        trx0, try0 = _cdiv(tx0, sx), _cdiv(ty0, sy)
        trx1, try1 = _cdiv(tx1, sx), _cdiv(ty1, sy)
        rpx, rpy = R.pdx + lev, R.pdy + lev
        if not (y % (tc['dy'] << rpy) == 0 or
                (y == ty0 and (try0 << lev) % (1 << rpy))):
            return None
        if not (x % (tc['dx'] << rpx) == 0 or
                (x == tx0 and (trx0 << lev) % (1 << rpx))):
            return None
        if R.pw == 0 or R.ph == 0 or trx0 == trx1 or try0 == try1:
            return None
        prci = (_cdiv(x, sx) >> R.pdx) - (trx0 >> R.pdx)
        prcj = (_cdiv(y, sy) >> R.pdy) - (try0 >> R.pdy)
        return prci + prcj * R.pw

    def precincts(c, r):
        R = tcs[c]['res'][r] if r < len(tcs[c]['res']) else None
        return range(R.pw * R.ph) if R is not None else ()

    runs = [(0, 0, layers, maxres, ncomp, prog)] if not pocs else \
        [(r0, c0, min(lay, layers), r1, c1, p)
         for r0, c0, lay, r1, c1, p in pocs]
    for r0, c0, l1, r1, c1, p in runs:
        def visit(c, r, x, y):
            k = precinct(c, r, x, y)
            if k is not None:
                for lay in range(l1):
                    emit(lay, r, c, k)
        if p == 0:                                   # LRCP
            for lay in range(l1):
                for r in range(r0, r1):
                    for c in range(c0, c1):
                        for k in precincts(c, r):
                            emit(lay, r, c, k)
        elif p == 1:                                 # RLCP
            for r in range(r0, r1):
                for lay in range(l1):
                    for c in range(c0, c1):
                        for k in precincts(c, r):
                            emit(lay, r, c, k)
        elif p == 2:                                 # RPCL
            dx, dy = steps(range(ncomp))
            for r in range(r0, r1):
                for x, y in positions(dx, dy):
                    for c in range(c0, c1):
                        visit(c, r, x, y)
        elif p == 3:                                 # PCRL
            dx, dy = steps(range(ncomp))
            for x, y in positions(dx, dy):
                for c in range(c0, c1):
                    for r in range(r0, min(r1, len(tcs[c]['res']))):
                        visit(c, r, x, y)
        else:                                        # CPRL
            for c in range(c0, c1):
                dx, dy = steps((c,))
                for x, y in positions(dx, dy):
                    for r in range(r0, min(r1, len(tcs[c]['res']))):
                        visit(c, r, x, y)
    return order


# --- tier 2 -------------------------------------------------------------------

class _Bits:
    """openjpeg's packet-header bit reader (``opj_bio``): most significant
    bit first, seven bits from a byte that follows 0xFF; past the data's
    end it reads zeros."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.start, self.pos = data, pos, pos
        self.buf, self.ct = 0, 0

    def _bytein(self):
        self.buf = (self.buf << 8) & 0xFFFF
        self.ct = 7 if self.buf == 0xFF00 else 8
        if self.pos < len(self.data):
            self.buf |= self.data[self.pos]
        self.pos += 1

    def bit(self) -> int:
        if self.ct == 0:
            self._bytein()
        self.ct -= 1
        return (self.buf >> self.ct) & 1

    def bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit()
        return v

    def align(self) -> int:
        """Skip to the byte boundary (past the stuffed byte after a
        0xFF); the position after the header."""
        if (self.buf & 0xFF) == 0xFF:
            self._bytein()
        self.ct = 0
        return self.pos


def _numpasses(bits: _Bits) -> int:
    if not bits.bit():
        return 1
    if not bits.bit():
        return 2
    n = bits.bits(2)
    if n != 3:
        return 3 + n
    n = bits.bits(5)
    if n != 31:
        return 6 + n
    return 37 + bits.bits(7)


# code-block styles (COD/COC's SPcod; predictable termination, 16, only
# shapes how an encoder ends a segment)
LAZY, RESET, TERMALL, VSC, SEGSYM = 1, 2, 4, 8, 32


def _new_segment(blk: '_Block', style: int) -> None:
    """openjpeg's ``opj_t2_init_seg``: a segment's most passes. One pass
    under TERMALL; under LAZY (bypass) the first ten (the MQ-coded top
    bit planes), then two raw passes and one MQ pass in turn; else one
    segment for every pass."""
    if style & TERMALL:
        most = 1
    elif style & LAZY:
        most = 10 if not blk.segs else \
            2 if blk.segs[-1][2] in (1, 10) else 1
    else:
        most = 109
    blk.segs.append([0, 0, most])


def _packet(data: bytes, pos: int, R: _Res, k: int, layer: int,
            style: int, sop: bool, eph: bool) -> int:
    """Read the packet of precinct ``k`` of resolution ``R`` for
    ``layer`` from ``data[pos:]``: its SOP marker where the stream may
    have them, its header, its EPH marker where the stream has them, then
    each included code-block's bytes (appended to the block). Returns the
    position after the packet."""
    if sop and data[pos:pos + 2] == b'\xff\x91' and pos + 6 <= len(data):
        pos += 6
    bits = _Bits(data, pos)
    P = R.precincts[k]
    news = []
    if bits.bit():
        for B, blocks, incl, msb in P.bands:
            for j, blk in enumerate(blocks):
                if not blk.included:
                    if not incl.decode(bits, j, layer + 1):
                        continue
                    i = 0
                    while not msb.decode(bits, j, i):
                        i += 1
                        if i > 74:
                            raise _broken("zero bit planes past 74")
                    blk.numbps = B.mb + 1 - i
                    blk.lblock = 3
                    blk.included = True
                    _new_segment(blk, style)
                elif not bits.bit():
                    continue
                n = _numpasses(bits)
                while bits.bit():
                    blk.lblock += 1
                    if blk.lblock > 32:
                        raise _broken("segment length of more than 32 bits")
                if blk.segs[-1][0] == blk.segs[-1][2]:
                    _new_segment(blk, style)
                seg = len(blk.segs) - 1
                while n > 0:
                    new = min(blk.segs[seg][2] - blk.segs[seg][0], n)
                    nbits = blk.lblock + new.bit_length() - 1
                    if nbits > 32:
                        raise _broken("segment length of more than 32 bits")
                    news.append((blk, seg, new, bits.bits(nbits)))
                    n -= new
                    if n > 0:
                        _new_segment(blk, style)
                        seg += 1
    pos = bits.align()
    if eph and data[pos:pos + 2] == b'\xff\x92':
        pos += 2
    if pos > len(data):
        raise _broken("packet header past the tile's data")
    for blk, seg, new, length in news:
        if pos + length > len(data):
            raise _broken("code-block data past the tile's data")
        blk.chunks.append(data[pos:pos + length])
        blk.segs[seg][0] += new
        blk.segs[seg][1] += length
        pos += length
    return pos


# --- tier 1 -------------------------------------------------------------------

# the MQ coder's states (ISO 15444-1 Table C.2): Qe, next on MPS, next on
# LPS, switch
_QE = (0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401,
       0x4801, 0x3801, 0x3001, 0x2401, 0x1C01, 0x1601, 0x5601, 0x5401,
       0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
       0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1,
       0x08A1, 0x0521, 0x0441, 0x02A1, 0x0221, 0x0141, 0x0111, 0x0085,
       0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601)
_NMPS = (1, 2, 3, 4, 5, 38, 7, 8, 9, 10, 11, 12, 13, 29, 15, 16, 17, 18, 19,
         20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36,
         37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46)
_NLPS = (1, 6, 9, 12, 29, 33, 6, 14, 14, 14, 17, 18, 20, 21, 14, 14, 15, 16,
         17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
         33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46)
_SWITCH = (1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1) + (0,) * 32
_CTX_RL, _CTX_UNI = 17, 18


class _MQ:
    """The MQ decoder (ISO 15444-1 C.3, openjpeg's ``mqc``) over
    ``data[start:end]``, the bytes past ``end`` read as 0xFF (openjpeg
    writes a 0xFF 0xFF marker there); the contexts' states persist across
    segments."""

    def __init__(self):
        self.reset()

    def reset(self):
        """Every context to its initial state (RESET does it after each
        MQ-coded pass)."""
        self.state = [0] * 19
        self.mps = [0] * 19
        self.state[_CTX_UNI], self.state[_CTX_RL], self.state[0] = 46, 3, 4

    def _byte(self, p: int) -> int:
        return self.data[p] if p < self.end else 0xFF

    def _bytein(self):
        if self._byte(self.p) == 0xFF:
            if self._byte(self.p + 1) > 0x8F:
                self.c = (self.c + 0xFF00) & 0xFFFFFFFF
                self.ct = 8
            else:
                self.p += 1
                self.c = (self.c + (self._byte(self.p) << 9)) & 0xFFFFFFFF
                self.ct = 7
        else:
            self.p += 1
            self.c = (self.c + (self._byte(self.p) << 8)) & 0xFFFFFFFF
            self.ct = 8

    def init(self, data: bytes, start: int, end: int):
        self.data, self.p, self.end = data, start, end
        self.c = (0xFF if start == end else data[start]) << 16
        self._bytein()
        self.c = (self.c << 7) & 0xFFFFFFFF
        self.ct -= 7
        self.a = 0x8000

    def decode(self, cx: int) -> int:
        s = self.state[cx]
        qe = _QE[s]
        self.a -= qe
        if (self.c >> 16) < qe:
            if self.a < qe:
                d = self.mps[cx]
                self.state[cx] = _NMPS[s]
            else:
                d = 1 - self.mps[cx]
                if _SWITCH[s]:
                    self.mps[cx] = d
                self.state[cx] = _NLPS[s]
            self.a = qe
        else:
            self.c -= qe << 16
            if self.a & 0x8000:
                return self.mps[cx]
            if self.a < qe:
                d = 1 - self.mps[cx]
                if _SWITCH[s]:
                    self.mps[cx] = d
                self.state[cx] = _NLPS[s]
            else:
                d = self.mps[cx]
                self.state[cx] = _NMPS[s]
        while True:
            if self.ct == 0:
                self._bytein()
            self.a = (self.a << 1) & 0xFFFFFFFF
            self.c = (self.c << 1) & 0xFFFFFFFF
            self.ct -= 1
            if self.a >= 0x8000:
                return d


def _zc_context(h: int, v: int, d: int, orient: int) -> int:
    """The zero-coding context (Table D.1) of a sample whose horizontal,
    vertical and diagonal neighbours hold h, v and d significant ones;
    openjpeg's orientation numbering (1: HL, 2: LH) and table."""
    if orient == 3:
        hv = h + v
        if d >= 3:
            return 8
        if d == 2:
            return 7 if hv >= 1 else 6
        if d == 1:
            return 5 if hv >= 2 else 4 if hv == 1 else 3
        return 2 if hv >= 2 else 1 if hv == 1 else 0
    if orient == 1:
        h, v = v, h
    if h == 2:
        return 8
    if h == 1:
        return 7 if v else 6 if d else 5
    if v == 2:
        return 4
    if v == 1:
        return 3
    return 2 if d >= 2 else d


class _Raw:
    """openjpeg's raw (bypass) bit reader over ``data[start:end]``, the
    bytes past ``end`` read as 0xFF: after 0xFF a byte gives seven bits,
    and a byte above 0x8F there is not taken."""

    def __init__(self, data: bytes, start: int, end: int):
        self.data, self.p, self.end = data, start, end
        self.c, self.ct = 0, 0

    def _byte(self) -> int:
        return self.data[self.p] if self.p < self.end else 0xFF

    def decode(self, cx: int = 0) -> int:
        if self.ct == 0:
            if self.c == 0xFF:
                if self._byte() > 0x8F:
                    self.c, self.ct = 0xFF, 8
                else:
                    self.c, self.ct = self._byte(), 7
                    self.p += 1
            else:
                self.c, self.ct = self._byte(), 8
                self.p += 1
        self.ct -= 1
        return (self.c >> self.ct) & 1


def _t1_block_plain(data: bytes, segs, w: int, h: int, orient: int,
                    numbps: int, style: int) -> list:
    """One code-block's samples in openjpeg's scaled form (a magnitude
    with its reconstruction half bit, signed), row by row: the coding
    passes from bit plane ``numbps`` down, over the segments ``segs``
    ((start, end, passes) in ``data``), under the code-block ``style``
    (bypass, reset, vertically causal, segmentation symbols; the
    termination modes only shape the segments), in plain Python."""
    W = w + 2
    sig = [0] * (W * (h + 2))       # 1 significant; a one-sample border
    neg = [0] * (W * (h + 2))
    pi = [0] * (W * (h + 2))
    refined = [0] * (W * (h + 2))
    val = [0] * (W * (h + 2))
    mq = _MQ()
    coder = mq
    bpno, passtype = numbps, 2

    def below(i):
        """Whether the row below sample i counts (not under VSC at a
        stripe's last row)."""
        return not (style & VSC and (i // W - 1) % 4 == 3)

    def ctx_sums(i):
        b = below(i)
        return (sig[i - 1] + sig[i + 1], sig[i - W] + sig[i + W] * b,
                sig[i - W - 1] + sig[i - W + 1]
                + (sig[i + W - 1] + sig[i + W + 1]) * b)

    def sign_bit(i):
        if coder is not mq:
            return coder.decode()
        b = below(i)
        hc = (sig[i - 1] * (1 - 2 * neg[i - 1])
              + sig[i + 1] * (1 - 2 * neg[i + 1]))
        vc = (sig[i - W] * (1 - 2 * neg[i - W])
              + sig[i + W] * (1 - 2 * neg[i + W]) * b)
        hc, vc = max(-1, min(1, hc)), max(-1, min(1, vc))
        xor = 0
        if hc < 0 or (hc == 0 and vc < 0):
            hc, vc, xor = -hc, -vc, 1
        ctx = 9 + (4 if hc == 1 and vc == 1 else 3 if hc == 1 and vc == 0
                   else 2 if hc == 1 else 1 if vc else 0)
        return mq.decode(ctx) ^ xor

    def become_significant(i, s, one):
        sig[i], neg[i] = 1, s
        val[i] = -(one | (one >> 1)) if s else one | (one >> 1)

    def stripe_order():
        for y0 in range(0, h, 4):
            for x in range(w):
                yield y0, x

    for start, end, npasses in segs:
        raw = bool(style & LAZY) and bpno <= numbps - 4 and passtype < 2
        if raw:
            coder = _Raw(data, start, end)
        else:
            coder = mq
            mq.init(data, start, end)
        for _ in range(npasses):
            if bpno < 1:
                break
            one = 1 << bpno
            if passtype == 0:                    # significance propagation
                for y0, x in stripe_order():
                    for y in range(y0, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if sig[i]:
                            continue
                        hs, vs, ds = ctx_sums(i)
                        if hs + vs + ds == 0:
                            continue
                        pi[i] = 1
                        if coder.decode(_zc_context(hs, vs, ds, orient)):
                            become_significant(i, sign_bit(i), one)
            elif passtype == 1:                  # magnitude refinement
                half = one >> 1
                for y0, x in stripe_order():
                    for y in range(y0, min(y0 + 4, h)):
                        i = (y + 1) * W + x + 1
                        if not sig[i] or pi[i]:
                            continue
                        if refined[i]:
                            ctx = 16
                        else:
                            ctx = 15 if sum(ctx_sums(i)) else 14
                        bit = coder.decode(ctx)
                        val[i] += half if bit ^ (val[i] < 0) else -half
                        refined[i] = 1
            else:                                # cleanup
                for y0, x in stripe_order():
                    y = y0
                    if y0 + 4 <= h and all(
                            not sig[(yy + 1) * W + x + 1] and
                            not pi[(yy + 1) * W + x + 1] and
                            sum(ctx_sums((yy + 1) * W + x + 1)) == 0
                            for yy in range(y0, y0 + 4)):
                        if not mq.decode(_CTX_RL):
                            continue
                        run = (mq.decode(_CTX_UNI) << 1) | mq.decode(_CTX_UNI)
                        y = y0 + run
                        i = (y + 1) * W + x + 1
                        become_significant(i, sign_bit(i), one)
                        y += 1
                    for yy in range(y, min(y0 + 4, h)):
                        i = (yy + 1) * W + x + 1
                        if sig[i] or pi[i]:
                            continue
                        if mq.decode(_zc_context(*ctx_sums(i), orient)):
                            become_significant(i, sign_bit(i), one)
                for i in range(len(pi)):
                    pi[i] = 0
                if style & SEGSYM:
                    for _ in range(4):
                        mq.decode(_CTX_UNI)
            if style & RESET and not raw:
                mq.reset()
            passtype += 1
            if passtype == 3:
                passtype, bpno = 0, bpno - 1
    return [val[(y + 1) * W + x + 1] for y in range(h) for x in range(w)]


# block descriptor columns: width, height, orientation, bit planes,
# code-block style, first segment, segment count, offset of the samples
# in the output
_BLOCK_COLS = 8


def _check_t1(data, blocks, segs):
    """The failures both ``_t1`` and its twin raise before decoding."""
    blocks = np.asarray(blocks, np.int64).reshape(-1, _BLOCK_COLS)
    segs = np.asarray(segs, np.int64).reshape(-1, 3)
    if blocks.size:
        w, h, orient, nb, style, s0, ns, off = blocks.T
        if (w < 1).any() or (h < 1).any() or (w * h > 4096).any() or \
                (orient < 0).any() or (orient > 3).any() or \
                (style < 0).any() or (style > 63).any() or \
                (s0 < 0).any() or (ns < 0).any() or \
                (s0 + ns > len(segs)).any() or (off < 0).any():
            raise ValueError("bad code-block descriptor")
        if (nb >= 31).any():
            raise OSError("code-block of 31 or more bit planes")
    if segs.size and ((segs[:, 0] < 0).any() or
                      (segs[:, 1] < segs[:, 0]).any() or
                      (segs[:, 1] > len(data)).any() or
                      (segs[:, 2] < 0).any()):
        raise ValueError("bad code-block segment")
    return blocks, segs


def _t1_size(blocks) -> int:
    return int((blocks[:, 7] + blocks[:, 0] * blocks[:, 1]).max()) \
        if len(blocks) else 0


def _t1(data: bytes, blocks, segs) -> np.ndarray:
    """Tier 1 of many code-blocks in ``native/bitmap_j2k.cpp``: each row
    of ``blocks`` (width, height, orientation 0-3 as LL, HL, LH, HH, its
    bit planes, its code-block style, its first segment and their count,
    the offset of its samples in the output) decodes its segments (rows
    of ``segs``: start and end in ``data``, passes) into int32 samples in
    openjpeg's scaled form. Fails as ``_t1_plain`` does."""
    from ..native import bitmap_library, ptr
    blocks, segs = _check_t1(data, blocks, segs)
    out = np.zeros(_t1_size(blocks), np.int32)
    buf = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1,
                                                                 np.uint8)
    blocks = np.ascontiguousarray(blocks)
    segs = np.ascontiguousarray(segs) if segs.size else np.zeros((1, 3),
                                                                np.int64)
    rc = bitmap_library().mnt_j2k_t1(ptr(buf), ptr(blocks), len(blocks),
                                     ptr(segs), ptr(out))
    if rc != 0:
        raise OSError("code-block decoding failed")
    return out


def _t1_plain(data: bytes, blocks, segs) -> np.ndarray:
    """``_t1`` in plain Python, block by block."""
    blocks, segs = _check_t1(data, blocks, segs)
    out = np.zeros(_t1_size(blocks), np.int32)
    for w, h, orient, nb, style, s0, ns, off in blocks.tolist():
        vals = _t1_block_plain(data, segs[s0:s0 + ns].tolist(), w, h,
                               orient, nb, style)
        out[off:off + w * h] = vals
    return out


# --- the inverse wavelets ------------------------------------------------------

_GEOM_COLS = 4


def _check_geometry(plane: np.ndarray, geom) -> np.ndarray:
    geom = np.asarray(geom, np.int64).reshape(-1, _GEOM_COLS)
    if plane.ndim != 2 or len(geom) == 0:
        raise ValueError("bad wavelet geometry")
    x0, y0, x1, y1 = geom.T
    if (x1 < x0).any() or (y1 < y0).any() or (x0 < 0).any() or \
            (y0 < 0).any() or (x1 - x0 > plane.shape[1]).any() or \
            (y1 - y0 > plane.shape[0]).any() or \
            (np.diff(x1 - x0) < 0).any() or (np.diff(y1 - y0) < 0).any():
        raise ValueError("bad wavelet geometry")
    return geom


def _idwt(plane: np.ndarray, geom, name: str, dtype) -> np.ndarray:
    from ..native import bitmap_library, ptr
    geom = np.ascontiguousarray(_check_geometry(plane, geom))
    out = np.ascontiguousarray(plane, dtype).copy()
    getattr(bitmap_library(), name)(ptr(out), out.shape[1], ptr(geom),
                                    len(geom))
    return out


def _idwt53(plane: np.ndarray, geom) -> np.ndarray:
    """The inverse reversible 5/3 wavelet of a tile-component's int32
    coefficients (the bands of each level laid out as openjpeg lays them),
    level by level (``geom``: each resolution's x0, y0, x1, y1), rows
    then columns, in ``native/bitmap_j2k.cpp``."""
    return _idwt(plane, geom, 'mnt_j2k_idwt53', np.int32)


def _idwt97(plane: np.ndarray, geom) -> np.ndarray:
    """``_idwt53``'s irreversible 9/7 counterpart on float32 coefficients:
    openjpeg's lifting steps, rounded as it rounds them."""
    return _idwt(plane, geom, 'mnt_j2k_idwt97', np.float32)


def _levels(geom):
    """(width, height, previous width, previous height, x0 parity, y0
    parity) of each level above the lowest resolution."""
    for k in range(1, len(geom)):
        x0, y0, x1, y1 = geom[k]
        px0, py0, px1, py1 = geom[k - 1]
        yield x1 - x0, y1 - y0, px1 - px0, py1 - py0, x0 & 1, y0 & 1


def _lift53(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 5/3 of the rows of ``a`` (int32; the first ``sn``
    columns low-pass, the rest high-pass) with the edges mirrored:
    openjpeg's ``opj_idwt53_h`` (one sample at an odd place is halved,
    as C divides)."""
    n = a.shape[1]
    dn = n - sn
    if n == 1:
        return a.copy() if cas == 0 else \
            ((a.astype(np.int64) + (a < 0)) >> 1).astype(np.int32)
    lo = a[:, :sn].astype(np.int64)
    hi = a[:, sn:].astype(np.int64)
    i, j = np.arange(sn), np.arange(dn)
    out = np.empty(a.shape, np.int32)
    if cas == 0:                 # low samples at even places
        dl, dr = hi[:, np.maximum(i - 1, 0)], hi[:, np.minimum(i, dn - 1)]
        s = _wrap(lo - ((dl + dr + 2) >> 2)).astype(np.int64)
        sl, sr = s[:, j], s[:, np.minimum(j + 1, sn - 1)]
        out[:, 0::2], out[:, 1::2] = s, _wrap(hi + ((sl + sr) >> 1))
    else:                        # low samples at odd places
        dl, dr = hi[:, i], hi[:, np.minimum(i + 1, dn - 1)]
        s = _wrap(lo - ((dl + dr + 2) >> 2)).astype(np.int64)
        sl, sr = s[:, np.maximum(j - 1, 0)], s[:, np.minimum(j, sn - 1)]
        out[:, 1::2], out[:, 0::2] = s, _wrap(hi + ((sl + sr) >> 1))
    return out


def _wrap(x: np.ndarray) -> np.ndarray:
    """int64 to int32 with two's-complement wrapping (the C code's)."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)


def _idwt53_plain(plane: np.ndarray, geom) -> np.ndarray:
    """``_idwt53`` in numpy."""
    geom = _check_geometry(plane, geom)
    out = np.ascontiguousarray(plane, np.int32).copy()
    for rw, rh, sw, sh, cx, cy in _levels(geom.tolist()):
        if rh and rw:
            out[:rh, :rw] = _lift53(out[:rh, :rw], sw, cx)
            out[:rh, :rw] = _lift53(out[:rh, :rw].T, sh, cy).T
    return out


# openjpeg's 9/7 lifting constants, and the scale of its high band
_ALPHA, _BETA = np.float32(-1.586134342), np.float32(-0.052980118)
_GAMMA, _DELTA = np.float32(0.882911075), np.float32(0.443506852)
_K, _TWO_INVK = np.float32(1.230174105), np.float32(1.625732422)


def _lift97(a: np.ndarray, sn: int, cas: int) -> np.ndarray:
    """The inverse 9/7 of the rows of ``a`` (float32, the first ``sn``
    columns low-pass): openjpeg's ``opj_v8dwt_decode`` (scale, then the
    four lifting steps, each ``x + (left + right) * c`` in float32, the
    edges mirrored)."""
    n = a.shape[1]
    dn = n - sn
    w = np.empty_like(a)
    lo_at, hi_at = (0, 1) if cas == 0 else (1, 0)
    w[:, lo_at::2] = a[:, :sn]
    w[:, hi_at::2] = a[:, sn:]
    if (cas == 0 and not (dn > 0 or sn > 1)) or \
            (cas == 1 and not (sn > 0 or dn > 1)):
        return w
    w[:, lo_at::2] *= _K
    w[:, hi_at::2] *= _TWO_INVK

    def step(at, c):
        idx = np.arange(at, n, 2)
        left, right = idx - 1, idx + 1
        left[left < 0] = 1                       # mirrored at the edges
        right[right >= n] = n - 2
        w[:, idx] = w[:, idx] + (w[:, left] + w[:, right]) * c
    step(lo_at, -_DELTA)
    step(hi_at, -_GAMMA)
    step(lo_at, -_BETA)
    step(hi_at, -_ALPHA)
    return w


def _idwt97_plain(plane: np.ndarray, geom) -> np.ndarray:
    """``_idwt97`` in numpy (float32 throughout)."""
    geom = _check_geometry(plane, geom)
    out = np.ascontiguousarray(plane, np.float32).copy()
    for rw, rh, sw, sh, cx, cy in _levels(geom.tolist()):
        if rh and rw:
            out[:rh, :rw] = _lift97(out[:rh, :rw], sw, cx)
            out[:rh, :rw] = _lift97(out[:rh, :rw].T, sh, cy).T
    return out


# --- colour transform and level shift -------------------------------------------

def _check_finish(planes, mct, ranges):
    if len(planes) != len(ranges) or not planes or \
            any(p.shape != planes[0].shape for p in planes) or \
            any(p.dtype not in (np.int32, np.float32) for p in planes) or \
            (mct and (len(planes) < 3 or planes[1].dtype != planes[0].dtype
                      or planes[2].dtype != planes[0].dtype)):
        raise ValueError("bad component planes")


def _finish(planes: list, mct: bool, ranges) -> list:
    """The samples of a tile's components (int32 planes after the 5/3,
    float32 after the 9/7): the inverse RCT or ICT of the first three
    where ``mct``, then each plane's DC level shift, rounding (half to
    even, openjpeg's ``lrintf``) and clamping to its range (``ranges``:
    the shift, min and max of each). int32 planes, in
    ``native/bitmap_j2k.cpp``."""
    from ..native import bitmap_library, ptr
    _check_finish(planes, mct, ranges)
    src = [np.ascontiguousarray(p).copy() for p in planes]
    out = [np.empty(p.shape, np.int32) for p in planes]
    lib = bitmap_library()
    n = src[0].size
    if mct:
        lib.mnt_j2k_mct(ptr(src[0]), ptr(src[1]), ptr(src[2]), n,
                        int(src[0].dtype == np.int32))
    for s, o, (shift, lo, hi) in zip(src, out, ranges):
        lib.mnt_j2k_level(ptr(s), n, int(s.dtype == np.int32), shift, lo,
                          hi, ptr(o))
    return out


def _finish_plain(planes: list, mct: bool, ranges) -> list:
    """``_finish`` in numpy."""
    _check_finish(planes, mct, ranges)
    p = list(planes)
    if mct and p[0].dtype == np.int32:
        y, u, v = (x.astype(np.int64) for x in p[:3])
        g = _wrap(y - ((u + v) >> 2))
        p[:3] = [_wrap(v + g), g, _wrap(u + g)]
    elif mct:
        y, u, v = p[:3]
        p[:3] = [y + v * np.float32(1.402),
                 (y - u * np.float32(0.34413)) - v * np.float32(0.71414),
                 y + u * np.float32(1.772)]
    out = []
    for x, (shift, lo, hi) in zip(p, ranges):
        if x.dtype == np.int32:
            out.append(np.clip(_wrap(x.astype(np.int64) + shift), lo,
                               hi).astype(np.int32))
            continue
        # openjpeg: above 2^31 the maximum; below -2^31, NaN, and 2^31
        # itself (lrintf's overflow value) the minimum
        x = x.astype(np.float64)
        r = np.rint(np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0))
        v = np.where(x > 2.0 ** 31, hi, np.clip(r + shift, lo, hi))
        v = np.where((x < -2.0 ** 31) | np.isnan(x) | (x == 2.0 ** 31), lo,
                     v)
        out.append(v.astype(np.int32))
    return out


# --- tiles --------------------------------------------------------------------

def _tile(siz: dict, t: int, params: _Params, data: bytes) -> list:
    """Decode tile ``t``: each component's samples, int32 (H, W), and the
    tile's place on the reference grid."""
    ncomp = len(siz['comps'])
    tcs = [_tilecomp(siz, t, c, params.cod_c[c], params.qcd[c])
           for c in range(ncomp)]
    pos = 0
    for lay, r, c, k in _progression(params.cod['prog'],
                                     params.cod['layers'], tcs, params.pocs):
        pos = _packet(data, pos, tcs[c]['res'][r], k, lay,
                      params.cod_c[c]['style'], params.cod['sop'],
                      params.cod['eph'])
    # tier 1: every code-block of the tile in one call
    chunks, blocks, segs, where = [], [], [], []
    nbytes = nout = 0
    for c, tc in enumerate(tcs):
        for R in tc['res']:
            for P in R.precincts:
                for B, blks, _, _ in P.bands:
                    for blk in blks:
                        w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
                        if not blk.segs or w <= 0 or h <= 0:
                            continue
                        if blk.numbps < 0:
                            raise _broken("more zero bit planes than bits")
                        blocks.append((w, h, B.orient,
                                       blk.numbps + params.roi[c],
                                       params.cod_c[c]['style'], len(segs),
                                       len(blk.segs), nout))
                        for npass, length, _ in blk.segs:
                            segs.append((nbytes, nbytes + length, npass))
                            nbytes += length
                        chunks.extend(blk.chunks)
                        where.append((c, B, blk, nout))
                        nout += w * h
    coded = _t1(b''.join(chunks), np.asarray(blocks, np.int64).reshape(
        -1, _BLOCK_COLS), np.asarray(segs, np.int64).reshape(-1, 3))
    planes = []
    for c, tc in enumerate(tcs):
        planes.append(np.zeros(
            (tc['y1'] - tc['y0'], tc['x1'] - tc['x0']),
            np.int32 if params.cod_c[c]['qmfbid'] == 1 else np.float32))
    for c, B, blk, off in where:
        w, h = blk.x1 - blk.x0, blk.y1 - blk.y0
        v = coded[off:off + w * h].reshape(h, w)
        shift = params.roi[c]
        if shift:            # the ROI's samples scaled back (maxshift)
            mag = np.abs(v)
            v = np.where(mag >= 1 << shift,
                         np.sign(v) * (mag >> shift), v).astype(np.int32)
        if planes[c].dtype == np.int32:
            v = (v + (v < 0)) >> 1                 # C's v / 2
        else:
            v = v.astype(np.float32) * (np.float32(0.5) * np.float32(B.step))
        y, x = B.oy + blk.y0 - B.y0, B.ox + blk.x0 - B.x0
        planes[c][y:y + h, x:x + w] = v
    for c, tc in enumerate(tcs):
        if planes[c].size:
            geom = [(R.x0, R.y0, R.x1, R.y1) for R in tc['res']]
            planes[c] = (_idwt53 if planes[c].dtype == np.int32
                         else _idwt97)(planes[c], geom)
    ranges = []
    for comp in siz['comps']:
        prec = comp['prec']
        if comp['sgnd']:
            ranges.append((0, -(1 << (prec - 1)), (1 << (prec - 1)) - 1))
        else:
            ranges.append((1 << (prec - 1), 0, (1 << prec) - 1))
    mct = bool(params.cod['mct']) and ncomp >= 3
    if mct and (planes[1].dtype != planes[0].dtype or
                planes[2].dtype != planes[0].dtype):
        raise _refuse("colour transform over mixed wavelets")
    return _finish(planes, mct, ranges), tcs[0]


def decode(data: bytes):
    """Decode a codestream: ``(comps, planes)``, ``comps`` the SIZ
    components (precision, signedness), ``planes`` each component's
    samples (int32, the image's height and width) after the inverse
    transforms, shift and clamp, as openjpeg hands them to PIL."""
    siz, params, tiles = parse(data)
    W, H = siz['X'] - siz['XO'], siz['Y'] - siz['YO']
    planes = [np.zeros((H, W), np.int32) for _ in siz['comps']]
    for t in sorted(tiles):
        tp, body = tiles[t]
        tp.check()
        out, tc = _tile(siz, t, tp, body)
        x0, y0 = tc['tx0'] - siz['XO'], tc['ty0'] - siz['YO']
        for c, p in enumerate(out):
            planes[c][y0:y0 + p.shape[0], x0:x0 + p.shape[1]] = p
    return siz['comps'], planes
