"""Frozen copy of rene_tpu_torch/scene/assets/images.py at commit ed2dcef.

Image loading: PFM (own parser), EXR (own minimal reader), LDR via PIL.

Parity with the reference (rene/src/scene/intermediate_scene.rs:631-677
and pfm_parser.rs): PFM binary Portable FloatMap with byte order from the
scale sign and bottom-up row order; EXR first RGBA layer; anything else is
decoded as LDR and inverse-gamma-corrected (sRGB piecewise curve) to linear,
alpha kept linear.

All loaders return an `Image`: float32 RGBA array of shape (H, W, 4), row 0 at
the *top* (matching the reference's in-memory layout where data[y*w+x] with
y=0 the first decoded row; PFM rows are flipped to top-down here exactly like
the reference writes `data[(y*width+x)]` iterating y from height-1 down).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


class Image:
    def __init__(self, data: np.ndarray):
        data = np.asarray(data, dtype=np.float32)
        assert data.ndim == 3 and data.shape[2] == 4
        self.data = data

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]


def inverse_gamma_correct(v: np.ndarray) -> np.ndarray:
    """sRGB decode, reference intermediate_scene.rs:616-622."""
    v = np.asarray(v, dtype=np.float32)
    return np.where(v <= 0.04045, v / 12.92,
                    ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def gamma_correct(v: np.ndarray) -> np.ndarray:
    """sRGB encode (pbrt gamma 2.2 curve), reference main.rs:1766-1774."""
    v = np.asarray(v, dtype=np.float32)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.maximum(v, 1e-12) ** (1.0 / 2.4) - 0.055
                    ).astype(np.float32)


# ---------------------------------------------------------------------------
# PFM
# ---------------------------------------------------------------------------

def load_pfm(path: str) -> Image:
    with open(path, "rb") as f:
        raw = f.read()
    # header: "PF\n<w> <h>\n<scale>\n" (reference pfm_parser.rs:10-17)
    if not raw.startswith(b"PF"):
        raise ValueError("not a color PFM")
    parts = raw.split(b"\n", 3)
    if len(parts) < 4:
        raise ValueError("truncated PFM header")
    dims = parts[1].split()
    w, h = int(dims[0]), int(dims[1])
    scale = float(parts[2])
    body = parts[3]
    dtype = ">f4" if scale > 0 else "<f4"
    rgb = np.frombuffer(body, dtype=dtype, count=w * h * 3).reshape(h, w, 3)
    # PFM stores rows bottom-up; flip to top-down.
    rgb = rgb[::-1].astype(np.float32)
    rgba = np.concatenate([rgb, np.ones((h, w, 1), np.float32)], axis=-1)
    return Image(rgba)


def save_pfm(path: str, rgb: np.ndarray) -> str:
    """Write a color PFM (little-endian, rows bottom-up — the format
    load_pfm reads back). `rgb` is (H, W, 3) float, top-down."""
    rgb = np.asarray(rgb, dtype="<f4")
    assert rgb.ndim == 3 and rgb.shape[2] == 3
    h, w = rgb.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n%d %d\n-1.0\n" % (w, h))
        f.write(rgb[::-1].tobytes())
    return path


# ---------------------------------------------------------------------------
# Minimal EXR reader (scanline, NONE/ZIP/ZIPS, half/float/uint channels)
# ---------------------------------------------------------------------------

def _read_cstr(buf, off):
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("ascii"), end + 1


def _exr_unzip(data: bytes, uncompressed_size: int) -> bytes:
    raw = zlib.decompress(data)
    if len(raw) != uncompressed_size:
        raise ValueError("bad EXR zip block size")
    # undo delta predictor then de-interleave two halves
    d = np.frombuffer(raw, dtype=np.uint8).astype(np.int64)
    d = ((np.cumsum(d - 128) + 128) % 256).astype(np.uint8)
    n = len(d)
    out = np.zeros(n, dtype=np.uint8)
    half = (n + 1) // 2
    out[0::2] = d[:half]
    out[1::2] = d[half:]
    return out.tobytes()


# -- PIZ (wavelet + Huffman) ------------------------------------------------
# Decoder for EXR compression type 4, the codec of the shipped
# TungstenRender.exr goldens. Follows the documented OpenEXR data format
# (ImfPizCompressor/ImfHuf/ImfWav): per 32-scanline block — used-value
# bitmap -> reverse LUT, canonical Huffman stream (MSB-first, 6-bit code
# lengths with zero-run packing, RLE symbol = iM), then a 2D integer
# wavelet inverse per channel, vectorized here per level with numpy
# strided views.

_HUF_DECBITS = 14


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
        return (self.c >> self.lc) & ((1 << n) - 1)


def _huf_unpack_lengths(br: _BitReader, im: int, iM: int) -> np.ndarray:
    """Code lengths for symbols im..iM (6-bit entries, zero-run packed)."""
    lens = np.zeros(iM + 1, np.int64)
    i = im
    while i <= iM:
        l = br.bits(6)
        if l == 63:                       # LONG_ZEROCODE_RUN
            run = br.bits(8) + 6          # SHORTEST_LONG_RUN
            i += run
        elif l >= 59:                     # SHORT_ZEROCODE_RUN
            i += l - 59 + 2
        else:
            lens[i] = l
            i += 1
    br.c = 0
    br.lc = 0                             # table is byte-aligned (flushed)
    return lens


def _huf_decode(data: bytes, n_out: int) -> np.ndarray:
    from ...ops.native import native_huf_decode
    out = native_huf_decode(data, n_out)
    if out is not None:
        return out
    im, iM, _table_len, n_bits, _room = struct.unpack("<5I", data[:20])
    br = _BitReader(data, 20)
    lens = _huf_unpack_lengths(br, im, iM)

    # canonical codes (ImfHuf hufCanonicalCodeTable)
    cnt = np.bincount(lens, minlength=59).astype(np.int64)
    c = 0
    first = np.zeros(59, np.int64)
    for li in range(58, 0, -1):
        first[li] = c
        c = (c + cnt[li]) >> 1
    codes = np.zeros(iM + 1, np.int64)
    nxt = first.copy()
    sym_idx = np.nonzero(lens)[0]
    for s in sym_idx:
        codes[s] = nxt[lens[s]]
        nxt[lens[s]] += 1

    # fast table for len<=14, dict for longer codes
    fast = np.full(1 << _HUF_DECBITS, -1, np.int64)
    flen = np.zeros(1 << _HUF_DECBITS, np.int64)
    long_codes = {}
    for s in sym_idx:
        l = int(lens[s])
        cd = int(codes[s])
        if l <= _HUF_DECBITS:
            lo = cd << (_HUF_DECBITS - l)
            fast[lo:lo + (1 << (_HUF_DECBITS - l))] = s
            flen[lo:lo + (1 << (_HUF_DECBITS - l))] = l
        else:
            long_codes[(l, cd)] = s

    out = np.zeros(n_out, np.uint16)
    oi = 0
    acc = 0
    nacc = 0
    pos = br.pos
    dat = data
    end_bits = n_bits
    used = 0
    last = 0
    while oi < n_out and used < end_bits:
        while nacc < 30 and pos < len(dat):
            acc = (acc << 8) | dat[pos]
            pos += 1
            nacc += 8
        peek = (acc >> (nacc - _HUF_DECBITS)) & ((1 << _HUF_DECBITS) - 1) \
            if nacc >= _HUF_DECBITS else \
            (acc << (_HUF_DECBITS - nacc)) & ((1 << _HUF_DECBITS) - 1)
        s = fast[peek]
        if s >= 0:
            l = int(flen[peek])
        else:
            l = _HUF_DECBITS + 1
            while l <= 58:
                if nacc < l:
                    if pos < len(dat):
                        acc = (acc << 8) | dat[pos]
                        pos += 1
                        nacc += 8
                        continue
                    break
                cd = (acc >> (nacc - l)) & ((1 << l) - 1)
                hit = long_codes.get((l, cd))
                if hit is not None:
                    s = hit
                    break
                l += 1
            if s < 0:
                raise ValueError("bad PIZ huffman stream")
        nacc -= l
        used += l
        if s == iM:                        # RLE: repeat previous symbol
            if nacc < 8:
                acc = (acc << 8) | dat[pos]
                pos += 1
                nacc += 8
            run = (acc >> (nacc - 8)) & 0xFF
            nacc -= 8
            used += 8
            out[oi:oi + run] = last
            oi += run
        else:
            last = np.uint16(s)
            out[oi] = last
            oi += 1
    if oi != n_out:
        raise ValueError(f"PIZ huffman decoded {oi} of {n_out} symbols")
    return out


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    return (ai.astype(np.int16).astype(np.uint16),
            (ai - hs).astype(np.int16).astype(np.uint16))


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & 0xFFFF
    aa = (d + bb - 0x8000) & 0xFFFF
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(a: np.ndarray, nx: int, ny: int, mx: int):
    """In-place inverse of OpenEXR's 2D integer wavelet (ImfWav wav2Decode)
    on an (ny, nx) uint16 view; each level vectorized over the sub-grid."""
    dec = _wdec14 if mx < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2)
        xs = np.arange(0, nx - p2 + 1, p2)
        if len(ys) and len(xs):
            i00, i10 = dec(a[np.ix_(ys, xs)], a[np.ix_(ys + p, xs)])
            i01, i11 = dec(a[np.ix_(ys, xs + p)], a[np.ix_(ys + p, xs + p)])
            i00, i01 = dec(i00, i01)
            i10, i11 = dec(i10, i11)
            a[np.ix_(ys, xs)] = i00
            a[np.ix_(ys, xs + p)] = i01
            a[np.ix_(ys + p, xs)] = i10
            a[np.ix_(ys + p, xs + p)] = i11
        if nx & p:                         # odd remainder column
            x = xs[-1] + p2 if len(xs) else 0
            if x < nx and len(ys):
                i00, b = dec(a[ys, x], a[ys + p, x])
                a[ys, x] = i00
                a[ys + p, x] = b
        if ny & p:                         # odd remainder row
            y = ys[-1] + p2 if len(ys) else 0
            if y < ny and len(xs):
                i00, b = dec(a[y, xs], a[y, xs + p])
                a[y, xs] = i00
                a[y, xs + p] = b
        p2 = p
        p >>= 1


def _exr_unpiz(data: bytes, chans, w: int, nlines: int,
               psize: dict) -> bytes:
    """One PIZ block -> the standard per-line channel-interleaved layout."""
    min_nz, max_nz = struct.unpack("<2H", data[:4])
    off = 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        nb = max_nz - min_nz + 1
        bitmap[min_nz:max_nz + 1] = np.frombuffer(data[off:off + nb],
                                                  np.uint8)
        off += nb
    mask = np.unpackbits(bitmap, bitorder="little").astype(bool)
    mask[0] = True
    rev = np.nonzero(mask)[0].astype(np.uint16)
    max_value = len(rev) - 1

    (hlen,) = struct.unpack("<i", data[off:off + 4])
    off += 4
    sizes = [psize[pt] // 2 for _, pt in chans]   # u16s per pixel
    n_out = sum(w * nlines * s for s in sizes)
    tmp = _huf_decode(data[off:off + hlen], n_out)

    start = 0
    planes = []
    for (cname, pt), size in zip(chans, sizes):
        cn = w * nlines * size
        view = tmp[start:start + cn].reshape(nlines, w * size)
        for j in range(size):
            _wav2_decode(view[:, j::size], w, nlines, max_value)
        planes.append(view)
        start += cn

    out = bytearray()
    for y in range(nlines):
        for view in planes:                       # reverse LUT at output
            out += rev[view[y]].tobytes()
    return bytes(out)


def load_exr(path: str) -> Image:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    version = struct.unpack("<I", buf[4:8])[0]
    if version & 0x200:
        raise ValueError("tiled/multipart EXR unsupported")
    off = 8
    attrs = {}
    while buf[off] != 0:
        name, off = _read_cstr(buf, off)
        ty, off = _read_cstr(buf, off)
        size = struct.unpack("<I", buf[off:off + 4])[0]
        off += 4
        attrs[name] = (ty, buf[off:off + size])
        off += size
    off += 1  # header terminator

    # channels
    chans = []  # (name, pixel_type) pixel_type: 0=uint,1=half,2=float
    cdata = attrs["channels"][1]
    coff = 0
    while cdata[coff] != 0:
        cname, coff = _read_cstr(cdata, coff)
        ptype = struct.unpack("<i", cdata[coff:coff + 4])[0]
        coff += 16  # pixel type + pLinear+pad + xSampling + ySampling
        chans.append((cname, ptype))
    comp = attrs["compression"][1][0]
    dw = struct.unpack("<4i", attrs["dataWindow"][1])
    xmin, ymin, xmax, ymax = dw
    w, h = xmax - xmin + 1, ymax - ymin + 1
    if comp == 0:
        lines_per_block = 1
    elif comp in (2, 3):  # ZIPS, ZIP
        lines_per_block = 1 if comp == 2 else 16
    elif comp == 4:       # PIZ
        lines_per_block = 32
    else:
        raise ValueError(
            f"EXR compression {comp} unsupported (NONE/ZIP/PIZ only)")

    nblocks = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack(f"<{nblocks}Q", buf[off:off + 8 * nblocks])

    psize = {0: 4, 1: 2, 2: 4}
    dtypes = {0: "<u4", 1: "<f2", 2: "<f4"}
    bytes_per_line = sum(psize[pt] for _, pt in chans) * w

    planes = {name: np.zeros((h, w), np.float32) for name, _ in chans}
    for bi, boff in enumerate(offsets):
        y0 = struct.unpack("<i", buf[boff:boff + 4])[0] - ymin
        dsize = struct.unpack("<I", buf[boff + 4:boff + 8])[0]
        data = buf[boff + 8:boff + 8 + dsize]
        nlines = min(lines_per_block, h - y0)
        want = bytes_per_line * nlines
        # OpenEXR stores a block raw when compression does not shrink it
        # (dsize == uncompressed size) — for ZIP and PIZ alike
        if comp == 4 and dsize < want:
            data = _exr_unpiz(data, chans, w, nlines, psize)
        elif comp in (2, 3) and dsize < want:
            data = _exr_unzip(data, want)
        line_off = 0
        for ly in range(nlines):
            for cname, pt in chans:  # channels stored alphabetically per line
                cnt = w
                seg = data[line_off:line_off + psize[pt] * cnt]
                arr = np.frombuffer(seg, dtype=dtypes[pt]).astype(np.float32)
                planes[cname][y0 + ly] = arr
                line_off += psize[pt] * cnt

    def plane(n, default):
        return planes.get(n, np.full((h, w), default, np.float32))

    rgba = np.stack([plane("R", 0), plane("G", 0), plane("B", 0),
                     plane("A", 1)], axis=-1)
    return Image(rgba)


# ---------------------------------------------------------------------------
# Dispatch (reference load_image, intermediate_scene.rs:631-677)
# ---------------------------------------------------------------------------

def load_image(path: str) -> Image:
    lower = str(path).lower()
    if lower.endswith(".pfm"):
        return load_pfm(path)
    if lower.endswith(".exr"):
        return load_exr(path)
    from PIL import Image as PILImage
    img = PILImage.open(path).convert("RGBA")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    rgba = np.concatenate(
        [inverse_gamma_correct(arr[..., :3]), arr[..., 3:4]], axis=-1)
    return Image(rgba)
