"""JPEG decoding in Python and numpy, bit-equal to libjpeg-turbo under Pillow.

The port reads JPEG test sets (ImageNet's validation images among them)
without Pillow.  What Pillow returns is libjpeg-turbo's output with its
default settings, so this module follows libjpeg's decoder step for step:

  * entropy decoding of baseline and extended sequential (SOF0, SOF1) and
    progressive (SOF2) Huffman frames of 8-bit samples, interleaved or not,
    with restart markers; a 16-bit peek into a lookup table per Huffman
    table, and a second table that also holds the extra bits where code and
    bits fit in 16 together;
  * dequantisation and the integer inverse DCT ``JDCT_ISLOW``
    (``jidctint.c``), with its range limit, on every block at once;
  * "fancy" upsampling (``jdsample.c``): the triangle filters h2v1, h2v2 and
    h1v2 with their alternating rounding biases, box replication for other
    integral factors;
  * colour: ``jdcolor.c``'s fixed-point YCbCr -> RGB, YCCK -> CMYK, and
    Pillow's own CMYK -> RGB of its inverted ("Adobe") CMYK.

The colour space follows ``jdapimin.c``'s defaults: one component is gray;
three are YCbCr unless the component ids are 'R', 'G', 'B' or an Adobe marker
without JFIF says transform 0; four are CMYK, or YCCK under Adobe transform 2.

The coefficients are held as 16-bit integers (libjpeg's ``JCOEF``), the
inverse DCT runs over bounded batches of blocks and the colour conversion over
bands of rows, so that memory grows with the pixels by a small factor.

Refused, with a ``ValueError`` that names the feature: arithmetic coding,
12-bit samples, lossless (SOF3) and hierarchical frames, sampling factors
outside libjpeg's 1..4, other than 1, 3 or 4 components, and progressive
files whose scans leave some of the first nine AC coefficients unrefined
(libjpeg then smooths the blocks, ``jdcoefct.c``'s block smoothing, which
this module does not do).
"""

from __future__ import annotations

import array

import numpy as np

from diffpir_tpu_torch.utils.imageio import check_size

__all__ = ["decode_jpeg"]

# zigzag position -> natural (row-major) position in the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22,
    15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55,
    62, 63])

_SOF_REFUSED = {
    0xC3: "lossless (SOF3) JPEG", 0xC5: "hierarchical JPEG (SOF5)",
    0xC6: "hierarchical JPEG (SOF6)", 0xC7: "hierarchical JPEG (SOF7)",
    0xC9: "arithmetic-coded JPEG (SOF9)", 0xCA: "arithmetic-coded JPEG (SOF10)",
    0xCB: "arithmetic-coded JPEG (SOF11)", 0xCD: "arithmetic-coded JPEG (SOF13)",
    0xCE: "arithmetic-coded JPEG (SOF14)", 0xCF: "arithmetic-coded JPEG (SOF15)",
}


class _Huffman:
    """A Huffman table as lookup tables over the next 16 bits."""

    def __init__(self, counts: bytes, symbols: bytes, is_ac: bool):
        lengths = np.repeat(np.arange(1, 17), np.frombuffer(counts, np.uint8))
        syms = np.frombuffer(symbols, np.uint8).astype(np.int64)
        if len(syms) != len(lengths):
            raise ValueError("bad JPEG Huffman table")
        size = np.zeros(65536, np.int64)    # code length, 0 where no code
        sym = np.zeros(65536, np.int64)
        code = 0
        prev = 0
        for length, s in zip(lengths.tolist(), syms.tolist()):
            code <<= length - prev
            prev = length
            if code >= 1 << length:
                raise ValueError("bad JPEG Huffman table")
            lo, hi = code << (16 - length), (code + 1) << (16 - length)
            size[lo:hi] = length
            sym[lo:hi] = s
            code += 1
        # (length, symbol) packed as length | symbol << 5
        self.lut = (size | (sym << 5)).tolist()
        # fast: the code and its extra bits together where they fit in 16:
        # total bits | (run + 1) << 5 | (value + 2**15) << 12 (run + 1 = 64: end
        # of block); 0 elsewhere
        peek = np.arange(65536, dtype=np.int64)
        s_bits = sym & 15
        run = (sym >> 4) if is_ac else np.zeros_like(sym)
        total = size + s_bits
        fits = (size > 0) & (total <= 16)
        raw = (peek >> np.clip(16 - total, 0, 16)) & ((1 << s_bits) - 1)
        value = np.where((s_bits > 0) & (raw < (1 << np.maximum(s_bits - 1, 0))),
                         raw - (1 << s_bits) + 1, raw)
        eob = is_ac & (sym == 0)  # end of block: run 64
        run1 = np.where(eob, 64, run + 1) if is_ac else run + 1
        fast = np.where(fits, total | (run1 << 5) | ((value + 32768) << 12), 0)
        self.fast = fast.tolist()


class _Bits:
    """The unstuffed entropy-coded segments of one scan, with a 32-bit
    window per byte so that any 25 bits from a bit position read as one
    shift and mask.  Bits past a segment's end read as 0, as libjpeg fills
    them."""

    def __init__(self, segments: list[bytes]):
        parts, starts, at = [], [], 0
        for seg in segments:
            seg = seg.replace(b"\xff\x00", b"\xff") + bytes(8)
            starts.append(at * 8)
            parts.append(seg)
            at += len(seg)
        b = np.frombuffer(b"".join(parts) + bytes(4), np.uint8).astype(np.int64)
        self.w = ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()
        self.starts = starts


def _segments(data: bytes, start: int) -> tuple[list[bytes], int]:
    """Entropy-coded data from ``start``: the segments between restart
    markers, and the position of the marker that ends the scan."""
    segs = []
    seg_start = i = start
    n = len(data)
    while True:
        j = data.find(b"\xff", i)
        if j < 0 or j + 1 >= n:
            segs.append(data[seg_start:])
            return segs, n
        nxt = data[j + 1]
        if nxt == 0:
            i = j + 2
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(data[seg_start:j])
            seg_start = i = j + 2
        else:
            segs.append(data[seg_start:j])
            return segs, j


def _decode_sequential(bits: _Bits, order, restart_blocks: int, coef: list,
                       dc_tabs, ac_tabs):
    """Baseline blocks: ``order`` is a list of (offset, component slot)."""
    w = bits.w
    starts = bits.starts
    pos = starts[0]
    seg = 1
    preds = [0] * len(dc_tabs)
    dcl = [t.lut for t in dc_tabs]
    acf = [t.fast for t in ac_tabs]
    acl = [t.lut for t in ac_tabs]
    next_rst = restart_blocks if restart_blocks else -1
    for i, (off, c) in enumerate(order):
        if i == next_rst:
            pos = starts[seg]
            seg += 1
            preds = [0] * len(preds)
            next_rst += restart_blocks
        # DC
        e = dcl[c][(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
        n = e & 31
        if not n:
            raise ValueError("corrupt JPEG data: bad Huffman code")
        pos += n
        s = e >> 5
        if s:
            v = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            preds[c] += v
        coef[off] = preds[c]
        # AC
        fast = acf[c]
        lut = acl[c]
        k = 1
        while k < 64:
            p16 = (w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF
            e = fast[p16]
            if e:
                pos += e & 31
                r = (e >> 5) & 127
                if r == 64:
                    break
                k += r - 1
                coef[off + k] = (e >> 12) - 32768
                k += 1
                continue
            e = lut[p16]
            n = e & 31
            if not n:
                raise ValueError("corrupt JPEG data: bad Huffman code")
            pos += n
            rs = e >> 5
            r, s = rs >> 4, rs & 15
            if s == 0:
                if r == 15:
                    k += 16
                    continue
                break
            k += r
            v = (w[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
            pos += s
            if v < 1 << (s - 1):
                v -= (1 << s) - 1
            if k < 64:
                coef[off + k] = v
            k += 1


def _get(w, pos, n):
    return (w[pos >> 3] >> (32 - (pos & 7) - n)) & ((1 << n) - 1)


def _huff(w, pos, lut):
    e = lut[(w[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
    if not e & 31:
        raise ValueError("corrupt JPEG data: bad Huffman code")
    return e >> 5, pos + (e & 31)


def _extend(v, s):
    return v - (1 << s) + 1 if v < 1 << (s - 1) else v


def _decode_progressive(bits: _Bits, order, restart_blocks: int, coef: list, dc_tabs,
                        ac_tabs, ss: int, se: int, ah: int, al: int):
    """One progressive scan (``jdphuff.c``): DC first / refine over
    ``order``; AC first / refine over one component's blocks."""
    w = bits.w
    starts = bits.starts
    pos = starts[0]
    seg = 1
    preds = [0] * len(dc_tabs)
    eobrun = 0
    next_rst = restart_blocks if restart_blocks else -1
    p1 = 1 << al
    m1 = -1 << al
    for i, (off, c) in enumerate(order):
        if i == next_rst:
            pos = starts[seg]
            seg += 1
            preds = [0] * len(preds)
            eobrun = 0
            next_rst += restart_blocks
        if ss == 0:
            if ah == 0:
                s, pos = _huff(w, pos, dc_tabs[c].lut)
                if s:
                    v = _extend(_get(w, pos, s), s)
                    pos += s
                    preds[c] += v
                coef[off] = preds[c] << al
            else:
                if _get(w, pos, 1):
                    coef[off] |= p1
                pos += 1
            continue
        lut = ac_tabs[c].lut
        if ah == 0:
            if eobrun:
                eobrun -= 1
                continue
            k = ss
            while k <= se:
                rs, pos = _huff(w, pos, lut)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    v = _extend(_get(w, pos, s), s)
                    pos += s
                    if k <= se:
                        coef[off + k] = v * p1
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += _get(w, pos, r)
                        pos += r
                    eobrun -= 1
                    break
            continue
        # AC refinement
        k = ss
        if not eobrun:
            while k <= se:
                rs, pos = _huff(w, pos, lut)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if _get(w, pos, 1) else m1
                    pos += 1
                elif r != 15:
                    eobrun = 1 << r
                    if r:
                        eobrun += _get(w, pos, r)
                        pos += r
                    break
                while k <= se:
                    cv = coef[off + k]
                    if cv:
                        if _get(w, pos, 1) and not cv & p1:
                            coef[off + k] = cv + (p1 if cv >= 0 else m1)
                        pos += 1
                    else:
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s and k <= se:
                    coef[off + k] = s
                k += 1
        if eobrun:
            while k <= se:
                cv = coef[off + k]
                if cv:
                    if _get(w, pos, 1) and not cv & p1:
                        coef[off + k] = cv + (p1 if cv >= 0 else m1)
                    pos += 1
                k += 1
            eobrun -= 1


# jidctint.c constants (CONST_BITS 13, PASS1_BITS 2)
_F = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373, f1175=9633,
          f1501=12299, f1847=15137, f1961=16069, f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(v0, v1, v2, v3, v4, v5, v6, v7, shift: int):
    """One pass of jpeg_idct_islow over arrays of the eight inputs; returns
    the eight outputs descaled by ``shift`` bits."""
    f = _F
    z1 = (v2 + v6) * f["f0541"]
    tmp2 = z1 + v6 * -f["f1847"]
    tmp3 = z1 + v2 * f["f0765"]
    tmp0 = (v0 + v4) << 13
    tmp1 = (v0 - v4) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = v7, v5, v3, v1
    z1 = t0 + t3
    z2 = t1 + t2
    z3 = t0 + t2
    z4 = t1 + t3
    z5 = (z3 + z4) * f["f1175"]
    t0 = t0 * f["f0298"]
    t1 = t1 * f["f2053"]
    t2 = t2 * f["f3072"]
    t3 = t3 * f["f1501"]
    z1 = z1 * -f["f0899"]
    z2 = z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    half = 1 << (shift - 1)

    def d(x):
        return (x + half) >> shift

    return (d(tmp10 + t3), d(tmp11 + t2), d(tmp12 + t1), d(tmp13 + t0),
            d(tmp13 - t0), d(tmp12 - t1), d(tmp11 - t2), d(tmp10 - t3))


def idct_islow(blocks: np.ndarray) -> np.ndarray:
    """Dequantised coefficients (N, 8, 8) in natural order -> (N, 8, 8)
    uint8 samples, as libjpeg's jpeg_idct_islow with its range limit."""
    x = blocks.astype(np.int64)
    # pass 1: columns (CONST_BITS - PASS1_BITS)
    cols = _idct_1d(*(x[:, k, :] for k in range(8)), shift=11)
    ws = np.stack(cols, axis=1)
    # pass 2: rows (CONST_BITS + PASS1_BITS + 3)
    rows = _idct_1d(*(ws[:, :, k] for k in range(8)), shift=18)
    out = np.stack(rows, axis=2)
    # range_limit[(x) & RANGE_MASK] with the table centred on 128
    wrapped = ((out + 512) & 1023) - 512
    return np.clip(wrapped + 128, 0, 255).astype(np.uint8)


def _upsample(plane: np.ndarray, h: int, v: int, hmax: int, vmax: int) -> np.ndarray:
    """One component's (downsampled height, width) samples -> full size, as
    jdsample.c with do_fancy_upsampling."""
    hf, vf = hmax // h, vmax // v
    if hmax % h or vmax % v:
        raise ValueError("JPEG with non-integral sampling ratios")
    x = plane.astype(np.int32)
    dh, dw = x.shape
    if hf == 1 and vf == 1:
        return plane
    if hf == 2 and vf == 1 and dw > 2:
        left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((dh, 2 * dw), np.int32)
        out[:, 0::2] = (3 * x + left + 1) >> 2
        out[:, 1::2] = (3 * x + right + 2) >> 2
        return out.astype(np.uint8)
    if hf == 1 and vf == 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, dw), np.int32)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out.astype(np.uint8)
    if hf == 2 and vf == 2 and dw > 2:
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * dh, 2 * dw), np.int32)
        for rows, other in ((0, up), (1, down)):
            cs = 3 * x + other
            last = np.concatenate([cs[:, :1], cs[:, :-1]], axis=1)
            nxt = np.concatenate([cs[:, 1:], cs[:, -1:]], axis=1)
            out[rows::2, 0::2] = (3 * cs + last + 8) >> 4
            out[rows::2, 1::2] = (3 * cs + nxt + 7) >> 4
        return out.astype(np.uint8)
    return np.repeat(np.repeat(plane, vf, axis=0), hf, axis=1)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(a):
        return int(a * 65536 + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_YCC = _ycc_tables()


def _ycc_to_rgb(y, cb, cr) -> tuple:
    """jdcolor.c ycc_rgb_convert: the three channels as int64 before the
    range limit."""
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return r, g, b


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """Pillow's CMYK -> RGB (Convert.c cmyk2rgb) of Pillow's CMYK."""
    c = cmyk.astype(np.int64)
    nk = 255 - c[..., 3:4]
    t = c[..., :3] * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


def _u16(data: bytes, at: int) -> int:
    return (data[at] << 8) | data[at + 1]


def decode_jpeg(data: bytes):
    """Decode JPEG bytes to ``(mode, pixels, None)``: ``"L"`` (h, w) or
    ``"RGB"`` (h, w, 3) uint8, as Pillow's decode of the file converted to
    RGB (CMYK and YCCK files included)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    n = len(data)
    pos = 2
    qtabs: dict[int, np.ndarray] = {}
    dc_tabs: dict[int, _Huffman] = {}
    ac_tabs: dict[int, _Huffman] = {}
    frame = None
    comps = []           # dicts: id, h, v, tq, blocks (bh, bw), coef list
    restart = 0
    jfif = False
    adobe = None
    progressive = False
    coef_bits = None
    scans = 0
    while pos < n:
        if data[pos] != 0xFF:   # extraneous bytes: skipped, as libjpeg does
            pos = data.find(b"\xff", pos)
            if pos < 0:
                break
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        length = _u16(data, pos)
        seg = data[pos + 2:pos + length]
        pos += length
        if marker in _SOF_REFUSED:
            raise ValueError(f"{_SOF_REFUSED[marker]} is not supported")
        if marker in (0xDE, 0xDF):
            raise ValueError("hierarchical JPEG (DHP/EXP markers) is not supported")
        if marker == 0xCC:
            raise ValueError("arithmetic-coded JPEG (DAC marker) is not supported")
        if marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDB:
            at = 0
            while at < len(seg):
                pq, tq = seg[at] >> 4, seg[at] & 15
                if pq:
                    q = np.frombuffer(seg[at + 1:at + 129], ">u2").astype(np.int64)
                    at += 129
                else:
                    q = np.frombuffer(seg[at + 1:at + 65], np.uint8).astype(np.int64)
                    at += 65
                nat = np.empty(64, np.int64)
                nat[ZIGZAG] = q
                qtabs[tq] = nat
        elif marker == 0xC4:
            at = 0
            while at < len(seg):
                tc, th = seg[at] >> 4, seg[at] & 15
                counts = seg[at + 1:at + 17]
                total = sum(counts)
                table = _Huffman(counts, seg[at + 17:at + 17 + total], tc == 1)
                (ac_tabs if tc else dc_tabs)[th] = table
                at += 17 + total
        elif marker == 0xDD:
            restart = _u16(seg, 0)
        elif marker in (0xC0, 0xC1, 0xC2):
            precision = seg[0]
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG samples are not supported "
                                 "(8-bit only)")
            height, width, ncomp = _u16(seg, 1), _u16(seg, 3), seg[5]
            if height == 0 or width == 0:
                raise ValueError("JPEG without a height in its frame (DNL) is not "
                                 "supported")
            check_size("JPEG", width, height)
            if ncomp not in (1, 3, 4):
                raise ValueError(f"JPEG with {ncomp} components is not supported")
            progressive = marker == 0xC2
            for i in range(ncomp):
                cid, hv, tq = seg[6 + 3 * i], seg[7 + 3 * i], seg[8 + 3 * i]
                if not (1 <= hv >> 4 <= 4 and 1 <= hv & 15 <= 4):
                    raise ValueError(f"JPEG sampling factors {hv >> 4}x{hv & 15} are "
                                     "outside 1..4")
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq, q=None))
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux = -(-width // (8 * hmax))
            mcuy = -(-height // (8 * vmax))
            at = 0
            for c in comps:
                # blocks of the MCU-padded grid, and the component's own size
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["dw"] = -(-width * c["h"] // hmax)
                c["dh"] = -(-height * c["v"] // vmax)
                c["base"] = at
                at += c["bw"] * c["bh"] * 64
            # every component's coefficients, zigzag order (a value past 16
            # bits raises OverflowError: corrupt data)
            coef = array.array("h", bytes(2 * at))
            coef_bits = [[-1] * 64 for _ in comps]
            frame = (width, height, hmax, vmax, mcux, mcuy)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("corrupt JPEG data: scan before frame")
            scans += 1
            ns = seg[0]
            sc = []
            for i in range(ns):
                cid, t = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next(j for j, c in enumerate(comps) if c["id"] == cid)
                sc.append((ci, t >> 4, t & 15))
            ss, se, a = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns]
            ah, al = a >> 4, a & 15
            for ci, _, _ in sc:
                c = comps[ci]
                if c["q"] is None:   # latched at the component's first scan
                    if c["tq"] not in qtabs:
                        raise ValueError("corrupt JPEG data: missing quantisation table")
                    c["q"] = qtabs[c["tq"]]
                for k in range(ss, se + 1):
                    coef_bits[ci][k] = al
            segs, pos = _segments(data, pos)
            order = _scan_order(comps, sc, frame[4], frame[5])
            per_mcu = sum(comps[ci]["h"] * comps[ci]["v"] for ci, _, _ in sc) \
                if len(sc) > 1 else 1
            rst_blocks = restart * per_mcu
            dcs = [dc_tabs.get(td) for _, td, _ in sc]
            acs = [ac_tabs.get(ta) for _, _, ta in sc]
            bits = _Bits(segs)
            if progressive:
                need = dcs if ss == 0 and ah == 0 else (acs if ss else [])
                if any(t is None for t in need):
                    raise ValueError("corrupt JPEG data: missing Huffman table")
                _decode_progressive(bits, order, rst_blocks, coef, dcs, acs, ss, se, ah, al)
            else:
                if any(t is None for t in dcs + acs):
                    raise ValueError("corrupt JPEG data: missing Huffman table")
                _decode_sequential(bits, order, rst_blocks, coef, dcs, acs)
    if frame is None or scans == 0:
        raise ValueError("corrupt JPEG data: no frame or no scan")
    if progressive:
        _refuse_block_smoothing(comps, coef_bits)
    return _finish(comps, np.frombuffer(coef, np.int16), frame, jfif, adobe)


def _scan_order(comps, sc, mcux, mcuy):
    """(offset, slot) of each block of a scan in decode order: MCUs of the
    interleaved components, or one component's blocks in raster order over
    its own size."""
    if len(sc) == 1:
        c = comps[sc[0][0]]
        bw, bh = -(-c["dw"] // 8), -(-c["dh"] // 8)
        yy, xx = np.mgrid[0:bh, 0:bw]
        offs = (c["base"] + (yy * c["bw"] + xx) * 64).ravel().tolist()
        return [(o, 0) for o in offs]
    offs, slots = [], []
    for s, (ci, _, _) in enumerate(sc):
        c = comps[ci]
        my, mx, v, h = np.mgrid[0:mcuy, 0:mcux, 0:c["v"], 0:c["h"]]
        off = c["base"] + ((my * c["v"] + v) * c["bw"] + mx * c["h"] + h) * 64
        offs.append(off.reshape(mcuy, mcux, -1))
        slots.append(np.full(offs[-1].shape, s))
    return list(zip(np.concatenate(offs, axis=2).ravel().tolist(),
                    np.concatenate(slots, axis=2).ravel().tolist()))


def _refuse_block_smoothing(comps, coef_bits):
    """Raise where libjpeg would smooth the blocks (jdcoefct.c smoothing_ok)."""
    useful = False
    for ci, c in enumerate(comps):
        q = c["q"]
        if q is None or any(q[p] == 0 for p in (0, 1, 8, 16, 9, 2, 3, 10, 17, 24)):
            return
        bits = coef_bits[ci]
        if bits[0] < 0:
            return
        if any(b != 0 for b in bits[1:10]):
            useful = True
    if useful:
        raise ValueError("progressive JPEG whose scans leave AC coefficients "
                         "unrefined (libjpeg's block smoothing) is not supported")


_IDCT_BATCH = 1 << 14   # blocks a batch of the inverse DCT
_BAND_ROWS = 256        # rows a band of the colour conversion


def _plane(c, coef_all) -> np.ndarray:
    """One component's samples over its blocks' grid, the inverse DCT in
    batches of ``_IDCT_BATCH`` blocks."""
    n = c["bw"] * c["bh"]
    coef = coef_all[c["base"]:c["base"] + n * 64].reshape(n, 64)
    q = c["q"][ZIGZAG]      # the table in zigzag order
    blocks = np.empty((n, 8, 8), np.uint8)
    for i in range(0, n, _IDCT_BATCH):
        z = coef[i:i + _IDCT_BATCH].astype(np.int64) * q
        nat = np.empty_like(z)
        nat[:, ZIGZAG] = z
        blocks[i:i + _IDCT_BATCH] = idct_islow(nat.reshape(-1, 8, 8))
    return blocks.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(
        c["bh"] * 8, c["bw"] * 8)


def _banded(planes, convert, channels: int) -> np.ndarray:
    """``convert`` of the planes' rows in bands of ``_BAND_ROWS``, into one
    (h, w, channels) uint8 image."""
    h, w = planes[0].shape
    out = np.empty((h, w, channels), np.uint8)
    for r0 in range(0, h, _BAND_ROWS):
        out[r0:r0 + _BAND_ROWS] = convert(*(p[r0:r0 + _BAND_ROWS] for p in planes))
    return out


def _ycc_rgb(y, cb, cr) -> np.ndarray:
    return np.clip(np.stack(_ycc_to_rgb(y, cb, cr), axis=2), 0, 255)


def _ycck_rgb(y, cb, cr, k) -> np.ndarray:
    """YCCK -> CMYK (jdcolor.c ycck_cmyk_convert), then Pillow's reading of
    a 4-component JPEG as Adobe's inverted CMYK ("CMYK;I") to RGB."""
    cmy = [np.clip(255 - ch, 0, 255) for ch in _ycc_to_rgb(y, cb, cr)]
    cmyk = np.stack(cmy + [k.astype(np.int64)], axis=2).astype(np.uint8)
    return cmyk_to_rgb(255 - cmyk)


def _cmyk_rgb(c, m, y, k) -> np.ndarray:
    return cmyk_to_rgb(255 - np.stack([c, m, y, k], axis=2))


def _finish(comps, coef_all, frame, jfif, adobe):
    width, height, hmax, vmax, _, _ = frame
    planes = []
    for c in comps:
        if c["q"] is None:
            raise ValueError("corrupt JPEG data: a component without a scan")
        plane = _plane(c, coef_all)[:c["dh"], :c["dw"]]
        full = _upsample(plane, c["h"], c["v"], hmax, vmax)
        planes.append(full[:height, :width])
    ids = tuple(c["id"] for c in comps)
    if len(comps) == 1:
        return "L", np.ascontiguousarray(planes[0]), None
    if len(comps) == 3:
        # jdapimin.c: JFIF means YCbCr; else an Adobe marker's transform 0
        # means RGB; else component ids 'R', 'G', 'B' do
        rgb = not jfif and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
        if rgb:
            return "RGB", np.stack(planes, axis=2), None
        return "RGB", _banded(planes, _ycc_rgb, 3), None
    if adobe is not None and adobe != 0:
        return "RGB", _banded(planes, _ycck_rgb, 3), None
    return "RGB", _banded(planes, _cmyk_rgb, 3), None
