"""Multi-page TIFF stack I/O, implemented from scratch on NumPy.

Capability parity with the reference's libtiff-based I/O
(reference:src/apifunc.cpp:116-326): ``gettifinfo`` (width/height/slices/
bit-depth), ``readtifstack`` (16-bit unsigned widened to float32, or native
32-bit float), ``readtifstack_16to16`` (native uint16), ``writetifstack``
(16-bit via C-style float->u16 truncation, or 32-bit IEEE float), and
``writetifstack_16to16``.

Array convention: stacks are returned/accepted as C-order ``(z, y, x)``
NumPy arrays — z is the page index, y the row, x the column. Size tuples
exposed to callers follow the reference's TIFF-facing ``(x, y, z)`` order
(reference:src/apifunc.cpp:120-123 reads width into ``tifSize[0]``).

Supported on read: classic (little- or big-endian) and BigTIFF,
uncompressed, striped, 1 sample/pixel, 8/16/32-bit unsigned or 32-bit
float. The writer emits classic little-endian TIFF, one strip per page,
matching the reference writer's layout (ROWSPERSTRIP = height,
COMPRESSION_NONE, PLANARCONFIG_SEPARATE, reference:src/apifunc.cpp:258-276).
"""

from __future__ import annotations

import mmap
import os
import struct

import numpy as np

# TIFF tag ids used here
_T_WIDTH = 256
_T_LENGTH = 257
_T_BITSPERSAMPLE = 258
_T_COMPRESSION = 259
_T_PHOTOMETRIC = 262
_T_DESCRIPTION = 270
_T_STRIPOFFSETS = 273
_T_ORIENTATION = 274
_T_SAMPLESPERPIXEL = 277
_T_ROWSPERSTRIP = 278
_T_STRIPBYTECOUNTS = 279
_T_PLANARCONFIG = 284
_T_SAMPLEFORMAT = 339

# TIFF datatype sizes (type code -> byte size)
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8, 16: 8, 17: 8, 18: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}


class TiffError(RuntimeError):
    pass


def _read_ifd_entries(mm, off, bo, big):
    """Parse one IFD; return (tags dict, next IFD offset).

    tags maps tag id -> list of values (first `count` values, inline or
    pointed-to)."""
    tags = {}
    if big:
        (count,) = struct.unpack_from(bo + "Q", mm, off)
        off += 8
        entry_sz, value_sz, cnt_fmt = 20, 8, "Q"
    else:
        (count,) = struct.unpack_from(bo + "H", mm, off)
        off += 2
        entry_sz, value_sz, cnt_fmt = 12, 4, "I"
    for i in range(count):
        e = off + i * entry_sz
        tag, typ = struct.unpack_from(bo + "HH", mm, e)
        (n,) = struct.unpack_from(bo + cnt_fmt, mm, e + 4)
        voff_pos = e + 4 + struct.calcsize(cnt_fmt)
        tsize = _TYPE_SIZE.get(typ, 1)
        total = tsize * n
        if total <= value_sz:
            vpos = voff_pos
        else:
            (vpos,) = struct.unpack_from(bo + ("Q" if big else "I"), mm, voff_pos)
        if typ == 2:  # ASCII — keep ImageDescription for ImageJ stacks
            if tag == _T_DESCRIPTION:
                tags[tag] = bytes(mm[vpos : vpos + n]).rstrip(b"\x00").decode("latin1", "replace")
            continue
        fmt = _TYPE_FMT.get(typ)
        if fmt is None:
            continue  # ignore rationals etc. — not needed
        vals = list(struct.unpack_from(bo + str(n) + fmt, mm, vpos))
        tags[tag] = vals
    next_off_pos = off + count * entry_sz
    (nxt,) = struct.unpack_from(bo + ("Q" if big else "I"), mm, next_off_pos)
    return tags, nxt


def _open_tiff(path):
    """mmap the file and return (mm, byteorder_char, bigtiff, first_ifd_offset)."""
    if not os.path.isfile(path):
        raise TiffError(f"*** File does not exist: {path}")
    f = open(path, "rb")
    try:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    finally:
        f.close()
    magic = mm[:2]
    if magic == b"II":
        bo = "<"
    elif magic == b"MM":
        bo = ">"
    else:
        mm.close()
        raise TiffError(f"Not a TIFF file: {path}")
    (version,) = struct.unpack_from(bo + "H", mm, 2)
    if version == 42:
        (first,) = struct.unpack_from(bo + "I", mm, 4)
        return mm, bo, False, first
    if version == 43:
        (first,) = struct.unpack_from(bo + "Q", mm, 8)
        return mm, bo, True, first
    mm.close()
    raise TiffError(f"Unsupported TIFF version {version}: {path}")


def _iter_ifds(mm, bo, big, first):
    off = first
    seen = set()
    while off != 0 and off not in seen:
        seen.add(off)
        tags, off_next = _read_ifd_entries(mm, off, bo, big)
        yield tags
        off = off_next


def _imagej_n_images(tags):
    """ImageJ writes large stacks with ONE IFD and a contiguous pixel block,
    recording the true slice count as 'images=N' in ImageDescription."""
    desc = tags.get(_T_DESCRIPTION)
    if not isinstance(desc, str) or not desc.startswith("ImageJ"):
        return None
    import re

    m = re.search(r"images=(\d+)", desc)
    if m:
        n = int(m.group(1))
        if n > 1:
            return n
    return None


def gettifinfo(path):
    """Return ``(size, bit_per_sample)`` with size = (width, height, n_slices).

    Mirrors reference:src/apifunc.cpp:116-136 (gettifinfo). ImageJ
    contiguous hyperstacks (one IFD + images=N) report their true depth."""
    mm, bo, big, first = _open_tiff(path)
    try:
        width = height = bits = None
        n = 0
        first_tags = None
        for tags in _iter_ifds(mm, bo, big, first):
            if n == 0:
                first_tags = tags
                width = tags[_T_WIDTH][0]
                height = tags[_T_LENGTH][0]
                bits = tags.get(_T_BITSPERSAMPLE, [1])[0]
            n += 1
        if n == 0:
            raise TiffError(f"No images found in TIFF: {path}")
        if n == 1:
            ij = _imagej_n_images(first_tags)
            if ij:
                n = ij
        return (int(width), int(height), n), int(bits)
    finally:
        mm.close()


def _page_array(mm, bo, tags, path):
    """Decode one IFD's pixel data as a (height, width) array."""
    width = tags[_T_WIDTH][0]
    height = tags[_T_LENGTH][0]
    bits = tags.get(_T_BITSPERSAMPLE, [1])[0]
    comp = tags.get(_T_COMPRESSION, [1])[0]
    spp = tags.get(_T_SAMPLESPERPIXEL, [1])[0]
    sfmt = tags.get(_T_SAMPLEFORMAT, [1])[0]
    if comp != 1:
        raise TiffError(f"Only uncompressed TIFF supported (compression={comp}): {path}")
    if spp != 1:
        raise TiffError(f"Only 1 sample/pixel supported (got {spp}): {path}")
    if bits == 8:
        dt = np.dtype(bo + "u1")
    elif bits == 16:
        dt = np.dtype(bo + ("i2" if sfmt == 2 else "u2"))
    elif bits == 32:
        dt = np.dtype(bo + ("f4" if sfmt == 3 else ("i4" if sfmt == 2 else "u4")))
    else:
        raise TiffError(f"Unsupported bit depth {bits}: {path}")
    offsets = tags[_T_STRIPOFFSETS]
    counts = tags.get(_T_STRIPBYTECOUNTS)
    if counts is None:
        counts = [width * height * dt.itemsize]
    nbytes_needed = width * height * dt.itemsize
    if len(offsets) == 1:
        buf = np.frombuffer(mm, dtype=dt, count=width * height, offset=offsets[0])
    else:
        parts = [np.frombuffer(mm, dtype=np.uint8, count=c, offset=o) for o, c in zip(offsets, counts)]
        raw = np.concatenate(parts)[:nbytes_needed]
        buf = raw.view(dt)
    # copy so the returned array does not pin the mmap open
    return buf.reshape(height, width).copy()


def readtifstack(path, dtype=np.float32):
    """Read a TIFF stack into a ``(z, y, x)`` array of ``dtype`` (default float32).

    16-bit unsigned input is widened to float; 32-bit float read natively
    (reference:src/apifunc.cpp:140-196). Returns ``(stack, size_xyz)``."""
    mm, bo, big, first = _open_tiff(path)
    try:
        all_tags = list(_iter_ifds(mm, bo, big, first))
        if not all_tags:
            raise TiffError(f"No images found in TIFF: {path}")
        if len(all_tags) == 1:
            ij_n = _imagej_n_images(all_tags[0])
            if ij_n:
                return _read_imagej_contiguous(mm, bo, all_tags[0], ij_n, dtype, path)
        pages = [_page_array(mm, bo, tags, path) for tags in all_tags]
        stack = np.stack([np.asarray(p, dtype=dtype) for p in pages], axis=0)
        h, w = pages[0].shape
        return stack, (w, h, len(pages))
    finally:
        mm.close()


def _read_imagej_contiguous(mm, bo, tags, n_images, dtype, path):
    """Read an ImageJ contiguous stack: pixel data for all slices follows
    the first slice's strip with no further IFDs."""
    width = tags[_T_WIDTH][0]
    height = tags[_T_LENGTH][0]
    bits = tags.get(_T_BITSPERSAMPLE, [1])[0]
    comp = tags.get(_T_COMPRESSION, [1])[0]
    sfmt = tags.get(_T_SAMPLEFORMAT, [1])[0]
    if comp != 1:
        raise TiffError(f"Only uncompressed TIFF supported (compression={comp}): {path}")
    if bits == 16:
        dt = np.dtype(bo + "u2")
    elif bits == 32:
        dt = np.dtype(bo + ("f4" if sfmt == 3 else "u4"))
    elif bits == 8:
        dt = np.dtype(bo + "u1")
    else:
        raise TiffError(f"Unsupported bit depth {bits}: {path}")
    offset = tags[_T_STRIPOFFSETS][0]
    count = width * height * n_images
    buf = np.frombuffer(mm, dtype=dt, count=count, offset=offset)
    stack = np.asarray(buf.reshape(n_images, height, width), dtype=dtype).copy()
    return stack, (int(width), int(height), int(n_images))


def readtifstack_16to16(path):
    """Read a 16-bit TIFF stack natively as uint16 ``(z, y, x)``.

    Mirrors reference:src/apifunc.cpp:198-239."""
    mm, bo, big, first = _open_tiff(path)
    try:
        pages = []
        for tags in _iter_ifds(mm, bo, big, first):
            bits = tags.get(_T_BITSPERSAMPLE, [1])[0]
            if bits != 16:
                raise TiffError("Image bit per sample is not supported, please set input image as 16 bit")
            pages.append(_page_array(mm, bo, tags, path))
        stack = np.stack([np.asarray(p, dtype=np.uint16) for p in pages], axis=0)
        h, w = pages[0].shape
        return stack, (w, h, len(pages))
    finally:
        mm.close()


def _float_to_u16_c_cast(a):
    """Replicate C's ``(uint16)float`` conversion: truncate toward zero,
    wrap modulo 2^16 (reference:src/apifunc.cpp:253 casts each float)."""
    with np.errstate(invalid="ignore"):
        t = np.trunc(np.asarray(a, dtype=np.float64))
        t = np.nan_to_num(t, nan=0.0, posinf=0.0, neginf=0.0)
        t = np.clip(t, -9.2e18, 9.2e18)
    return t.astype(np.int64).astype(np.uint16)


def _build_classic_tiff_pages(pages_bytes, width, height, bits, samplefmt):
    """Assemble a classic little-endian multi-page TIFF with one strip per
    page. Returns the file contents as bytes."""
    n_pages = len(pages_bytes)
    total = sum(len(p) for p in pages_bytes) + 8 + n_pages * 200
    if total >= 2**32:
        raise TiffError(
            "Stack exceeds the 4 GB classic-TIFF offset limit; split the "
            "stack or write 16-bit")
    # Per-page layout: [pixel data][IFD]; header first.
    header = struct.pack("<2sHI", b"II", 42, 0)  # IFD offset patched later
    chunks = [bytearray(header)]
    pos = len(header)
    ifd_offsets = []
    data_offsets = []
    for pb in pages_bytes:
        if pos % 2:
            chunks.append(b"\x00")
            pos += 1
        data_offsets.append(pos)
        chunks.append(pb)
        pos += len(pb)
        if pos % 2:
            chunks.append(b"\x00")
            pos += 1
        ifd_offsets.append(pos)
        # entries: width, length, bps, compression, photometric, stripoffsets,
        # orientation, samplesperpixel, rowsperstrip, stripbytecounts,
        # planarconfig [, sampleformat]
        entries = [
            (_T_WIDTH, 3, 1, width),
            (_T_LENGTH, 3, 1, height),
            (_T_BITSPERSAMPLE, 3, 1, bits),
            (_T_COMPRESSION, 3, 1, 1),
            (_T_PHOTOMETRIC, 3, 1, 1),  # min-is-black
            (_T_STRIPOFFSETS, 4, 1, data_offsets[-1]),
            (_T_ORIENTATION, 3, 1, 1),  # top-left
            (_T_SAMPLESPERPIXEL, 3, 1, 1),
            (_T_ROWSPERSTRIP, 3, 1, height),
            (_T_STRIPBYTECOUNTS, 4, 1, len(pb)),
            (_T_PLANARCONFIG, 3, 1, 2),  # separate, as the reference writes
        ]
        if samplefmt != 1:
            entries.append((_T_SAMPLEFORMAT, 3, 1, samplefmt))
        entries.sort(key=lambda e: e[0])
        ifd = bytearray(struct.pack("<H", len(entries)))
        for tag, typ, cnt, val in entries:
            if typ == 3:
                vbytes = struct.pack("<HH", val, 0)
            else:
                vbytes = struct.pack("<I", val)
            ifd += struct.pack("<HHI", tag, typ, cnt) + vbytes
        ifd += struct.pack("<I", 0)  # next-IFD, patched for all but last
        chunks.append(bytes(ifd))
        pos += len(ifd)
    out = bytearray(b"".join(bytes(c) for c in chunks))
    # patch IFD chain
    struct.pack_into("<I", out, 4, ifd_offsets[0])
    for i in range(n_pages - 1):
        # next-IFD pointer sits at the end of IFD i
        n_entries = struct.unpack_from("<H", out, ifd_offsets[i])[0]
        ptr_pos = ifd_offsets[i] + 2 + n_entries * 12
        struct.pack_into("<I", out, ptr_pos, ifd_offsets[i + 1])
    return bytes(out)


def writetifstack(path, stack, bit_per_sample=16):
    """Write a ``(z, y, x)`` float stack as multi-page TIFF.

    ``bit_per_sample`` 16 casts float->u16 C-style; 32 writes IEEE float —
    matching reference:src/apifunc.cpp:242-326."""
    stack = np.asarray(stack)
    if stack.ndim == 2:
        stack = stack[None]
    z, h, w = stack.shape
    if bit_per_sample == 16:
        data = _float_to_u16_c_cast(stack)
        pages = [np.ascontiguousarray(data[i]).astype("<u2").tobytes() for i in range(z)]
        blob = _build_classic_tiff_pages(pages, w, h, 16, 1)
    elif bit_per_sample == 32:
        data = np.asarray(stack, dtype="<f4")
        pages = [np.ascontiguousarray(data[i]).tobytes() for i in range(z)]
        blob = _build_classic_tiff_pages(pages, w, h, 32, 3)
    else:
        raise TiffError("Image bit per sample is not supported, please set bitPerSample to 16 or 32")
    with open(path, "wb") as f:
        f.write(blob)


def writetifstack_16to16(path, stack):
    """Write a uint16 ``(z, y, x)`` stack as 16-bit multi-page TIFF
    (reference:src/apifunc.cpp:300-326)."""
    stack = np.asarray(stack, dtype=np.uint16)
    if stack.ndim == 2:
        stack = stack[None]
    z, h, w = stack.shape
    pages = [np.ascontiguousarray(stack[i]).astype("<u2").tobytes() for i in range(z)]
    blob = _build_classic_tiff_pages(pages, w, h, 16, 1)
    with open(path, "wb") as f:
        f.write(blob)
