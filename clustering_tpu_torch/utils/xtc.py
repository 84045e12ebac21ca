"""GROMACS .xtc trajectory codec (XDR + 3dfcoord compression).

Format-compatible re-implementation of the xdrfile library the reference
vendors (src/coords_file/xdrfile/xdrfile.c:743-1254, xdrfile_xtc.c:22-70):
big-endian XDR framing (magic 1995, natoms, step, time, 3x3 box) and the
Frans van Hoesel 3dfcoord lossy coordinate compression -- fixed-point
quantization at a given precision, run-length encoded inter-atom deltas with
an adaptive "small" magnitude index, and mixed-radix packing of integer
triples into a bit stream.

This module is the pure-Python implementation (exact, byte-compatible);
:mod:`clustering_tpu_torch.utils.xtc_native` provides the C++ fast path used when
available (filter mode streams large trajectories through this codec).
"""

import struct

import numpy as np

MAGIC = 1995

# adaptive magnitude table of the 3dfcoord scheme
MAGICINTS = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003,
    16384, 20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031,
    131072, 165140, 208063, 262144, 330280, 416127, 524287, 660561,
    832255, 1048576, 1321122, 1664510, 2097152, 2642245, 3329021,
    4194304, 5284491, 6658042, 8388607, 10568983, 13316085, 16777216,
)
FIRSTIDX = 9
LASTIDX = len(MAGICINTS)


def _bits_for(size: int) -> int:
    """Smallest bit count representing any value below the next power of
    two at or above ``size`` (reference sizeofint semantics)."""
    return int(size).bit_length()


def _bits_for_triple(sizes) -> int:
    """Bit budget for a mixed-radix packed triple (reference sizeofints
    semantics: byte count of the size product plus leading-byte bits)."""
    prod = 1
    for s in sizes:
        prod *= int(s)
    n_bytes = (prod.bit_length() + 7) // 8 if prod > 0 else 1
    top = prod >> ((n_bytes - 1) * 8)
    return (n_bytes - 1) * 8 + top.bit_length()


class BitWriter:
    """MSB-first bit stream."""

    def __init__(self):
        self._out = bytearray()
        self._acc = 0
        self._nacc = 0

    def put(self, value: int, nbits: int):
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nacc += nbits
        while self._nacc >= 8:
            self._nacc -= 8
            self._out.append((self._acc >> self._nacc) & 0xFF)
        self._acc &= (1 << self._nacc) - 1

    def put_triple(self, nums, sizes, nbits):
        """Mixed-radix pack: combined = ((n0*s1)+n1)*s2+n2, emitted as
        little-endian bytes within the fixed ``nbits`` budget
        (reference encodeints layout)."""
        combined = int(nums[0])
        for v, s in zip(nums[1:], sizes[1:]):
            combined = combined * int(s) + int(v)
        n_bytes = max(1, (combined.bit_length() + 7) // 8)
        le = combined.to_bytes(n_bytes, "little")
        if nbits >= n_bytes * 8:
            for b in le:
                self.put(b, 8)
            self.put(0, nbits - n_bytes * 8)
        else:
            for b in le[:-1]:
                self.put(b, 8)
            self.put(le[-1], nbits - (n_bytes - 1) * 8)

    def getvalue(self) -> bytes:
        out = bytes(self._out)
        if self._nacc > 0:
            out += bytes([(self._acc << (8 - self._nacc)) & 0xFF])
        return out


class BitReader:
    """MSB-first bit stream reader."""

    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0  # bit position

    def get(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        end = self._pos + nbits
        first = self._pos // 8
        last = (end + 7) // 8
        chunk = int.from_bytes(self._data[first:last], "big")
        chunk >>= (last * 8 - end)
        self._pos = end
        return chunk & ((1 << nbits) - 1)

    def get_triple(self, sizes, nbits):
        """Inverse of put_triple."""
        n_bytes = 0
        le = bytearray()
        while nbits > 8:
            le.append(self.get(8))
            nbits -= 8
            n_bytes += 1
        if nbits > 0:
            le.append(self.get(nbits))
            n_bytes += 1
        combined = int.from_bytes(bytes(le), "little")
        n2 = combined % int(sizes[2])
        combined //= int(sizes[2])
        n1 = combined % int(sizes[1])
        n0 = combined // int(sizes[1])
        return (n0, n1, n2)


def _quantize(coords_flat, precision):
    """Fixed-point quantization with the reference's float arithmetic:
    lf = x * precision +- 0.5 in fp32, truncated toward zero."""
    x = np.asarray(coords_flat, dtype=np.float32)
    p = np.float32(precision)
    lf = np.where(x >= 0.0, x * p + np.float32(0.5), x * p - np.float32(0.5))
    return np.trunc(lf).astype(np.int64)


def compress_frame(coords, precision) -> bytes:
    """3dfcoord-compress an (natoms, 3) array; returns the XDR payload that
    follows the box in an xtc frame (lsize + precision + bounds + stream).

    Dispatches to the native C++ codec when available; the pure-Python
    implementation below is the byte-compatible reference.
    Mirrors reference xdrfile_compress_coord_float (xdrfile.c:963-1254).
    """
    from . import xtc_native
    if xtc_native.available():
        return xtc_native.compress_frame(coords, precision)
    return _compress_frame_py(coords, precision)


def _compress_frame_py(coords, precision) -> bytes:
    coords = np.asarray(coords, dtype=np.float32).reshape(-1, 3)
    natoms = coords.shape[0]
    out = bytearray(struct.pack(">i", natoms))
    if natoms <= 9:
        out += coords.astype(">f4").tobytes()
        return bytes(out)
    precision = float(precision) if precision > 0 else 1000.0
    ints = _quantize(coords.reshape(-1), precision).reshape(-1, 3)
    minint = ints.min(axis=0)
    maxint = ints.max(axis=0)
    diffs = np.abs(np.diff(ints, axis=0)).sum(axis=1)
    mindiff = int(diffs.min()) if len(diffs) else np.iinfo(np.int32).max
    sizeint = [int(maxint[k] - minint[k] + 1) for k in range(3)]
    if (sizeint[0] | sizeint[1] | sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_bits_for(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _bits_for_triple(sizeint)
    smallidx = FIRSTIDX
    while smallidx < LASTIDX and MAGICINTS[smallidx] < mindiff:
        smallidx += 1
    out += struct.pack(">f", precision)
    out += struct.pack(">3i", *[int(v) for v in minint])
    out += struct.pack(">3i", *[int(v) for v in maxint])
    out += struct.pack(">i", smallidx)

    maxidx = min(LASTIDX, smallidx + 8)
    minidx = maxidx - 8
    smaller = MAGICINTS[max(FIRSTIDX, smallidx - 1)] // 2
    smallnum = MAGICINTS[smallidx] // 2
    sizesmall = [MAGICINTS[smallidx]] * 3
    larger = MAGICINTS[maxidx] // 2

    bw = BitWriter()
    ints_list = ints.tolist()
    prevrun = -1
    prevcoord = [0, 0, 0]
    i = 0
    while i < natoms:
        is_small = False
        this = list(ints_list[i])
        if (smallidx < maxidx and i >= 1
                and abs(this[0] - prevcoord[0]) < larger
                and abs(this[1] - prevcoord[1]) < larger
                and abs(this[2] - prevcoord[2]) < larger):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        else:
            is_smaller = 0
        if i + 1 < natoms:
            nxt = ints_list[i + 1]
            if (abs(this[0] - nxt[0]) < smallnum
                    and abs(this[1] - nxt[1]) < smallnum
                    and abs(this[2] - nxt[2]) < smallnum):
                # swap with the next atom (water-molecule optimization)
                ints_list[i + 1] = this
                this = list(nxt)
                is_small = True
        first = [this[k] - int(minint[k]) for k in range(3)]
        if bitsize == 0:
            for k in range(3):
                bw.put(first[k], bitsizeint[k])
        else:
            bw.put_triple(first, sizeint, bitsize)
        prevcoord = this
        i += 1

        run_vals = []
        if not is_small and is_smaller == -1:
            is_smaller = 0
        while is_small and len(run_vals) < 8 * 3:
            this = list(ints_list[i])
            if is_smaller == -1:
                dsum = sum((this[k] - prevcoord[k]) ** 2 for k in range(3))
                if dsum >= smaller * smaller:
                    is_smaller = 0
            for k in range(3):
                run_vals.append(this[k] - prevcoord[k] + smallnum)
            prevcoord = this
            i += 1
            is_small = (
                i < natoms
                and abs(ints_list[i][0] - prevcoord[0]) < smallnum
                and abs(ints_list[i][1] - prevcoord[1]) < smallnum
                and abs(ints_list[i][2] - prevcoord[2]) < smallnum)
        run = len(run_vals)
        if run != prevrun or is_smaller != 0:
            prevrun = run
            bw.put(1, 1)
            bw.put(run + is_smaller + 1, 5)
        else:
            bw.put(0, 1)
        for k in range(0, run, 3):
            bw.put_triple(run_vals[k:k + 3], sizesmall, smallidx)
        if is_smaller != 0:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = MAGICINTS[smallidx - 1] // 2
            else:
                smaller = smallnum
                smallnum = MAGICINTS[smallidx] // 2
            sizesmall = [MAGICINTS[smallidx]] * 3

    payload = bw.getvalue()
    out += struct.pack(">i", len(payload))
    out += payload
    out += b"\x00" * ((4 - len(payload) % 4) % 4)  # XDR opaque padding
    return bytes(out)


def decompress_frame(data: bytes, offset: int):
    """Inverse of compress_frame; returns (coords (natoms,3) float32,
    precision, next_offset). Mirrors reference
    xdrfile_decompress_coord_float (xdrfile.c:761-961)."""
    from . import xtc_native
    if xtc_native.available():
        return xtc_native.decompress_frame(data, offset)
    return _decompress_frame_py(data, offset)


def _decompress_frame_py(data: bytes, offset: int):
    (natoms,) = struct.unpack_from(">i", data, offset)
    offset += 4
    if natoms < 0:
        raise ValueError("corrupt xtc 3dfcoord stream: negative natoms")
    if natoms <= 9:
        coords = np.frombuffer(data, dtype=">f4", count=natoms * 3,
                               offset=offset).astype(np.float32)
        return coords.reshape(-1, 3), 0.0, offset + natoms * 12
    (precision,) = struct.unpack_from(">f", data, offset)
    offset += 4
    minint = struct.unpack_from(">3i", data, offset)
    offset += 12
    maxint = struct.unpack_from(">3i", data, offset)
    offset += 12
    sizeint = [maxint[k] - minint[k] + 1 for k in range(3)]
    if (sizeint[0] | sizeint[1] | sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_bits_for(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _bits_for_triple(sizeint)
    (smallidx,) = struct.unpack_from(">i", data, offset)
    offset += 4
    if not FIRSTIDX <= smallidx < LASTIDX:
        raise ValueError("corrupt xtc 3dfcoord stream: smallidx out of "
                         "range")
    smaller = MAGICINTS[max(FIRSTIDX, smallidx - 1)] // 2
    smallnum = MAGICINTS[smallidx] // 2
    sizesmall = [MAGICINTS[smallidx]] * 3
    (nbytes,) = struct.unpack_from(">i", data, offset)
    offset += 4
    if nbytes < 0:
        raise ValueError("corrupt xtc 3dfcoord stream: negative length")
    br = BitReader(data[offset:offset + nbytes])
    offset += nbytes + ((4 - nbytes % 4) % 4)

    inv_precision = np.float32(1.0 / precision)
    out = np.empty((natoms, 3), dtype=np.float32)
    i = 0       # atoms emitted
    run = 0     # persists across atoms when the run-length flag is 0
    while i < natoms:
        if bitsize == 0:
            this = [br.get(bitsizeint[k]) for k in range(3)]
        else:
            this = list(br.get_triple(sizeint, bitsize))
        a = [this[k] + minint[k] for k in range(3)]
        prevcoord = list(a)
        flag = br.get(1)
        is_smaller = 0
        if flag == 1:
            run = br.get(5)
            is_smaller = run % 3
            run -= is_smaller
            is_smaller -= 1
        if run > 0:
            for k in range(0, run, 3):
                if i + (2 if k == 0 else 1) > natoms:
                    raise ValueError("corrupt xtc 3dfcoord stream: run "
                                     "exceeds natoms")
                vals = br.get_triple(sizesmall, smallidx)
                x = [vals[m] + prevcoord[m] - smallnum for m in range(3)]
                if k == 0:
                    # the encoder swapped this pair: emit delta-target
                    # first, absolute second
                    out[i] = [np.float32(v) * inv_precision for v in x]
                    out[i + 1] = [np.float32(v) * inv_precision for v in a]
                    i += 2
                else:
                    out[i] = [np.float32(v) * inv_precision for v in x]
                    i += 1
                prevcoord = x
        else:
            out[i] = [np.float32(v) * inv_precision for v in a]
            i += 1
        smallidx += is_smaller
        if not FIRSTIDX <= smallidx < LASTIDX:
            raise ValueError("corrupt xtc 3dfcoord stream: smallidx "
                             "drifted out of range")
        if is_smaller < 0:
            smallnum = smaller
            smaller = MAGICINTS[smallidx - 1] // 2 \
                if smallidx > FIRSTIDX else 0
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = MAGICINTS[smallidx] // 2
        sizesmall = [MAGICINTS[smallidx]] * 3
    return out, precision, offset


class XtcFrame:
    __slots__ = ("natoms", "step", "time", "box", "coords", "precision")

    def __init__(self, natoms, step, time, box, coords, precision):
        self.natoms = natoms
        self.step = step
        self.time = time
        self.box = box
        self.coords = coords
        self.precision = precision


class XtcReader:
    def __init__(self, path):
        self._fh = open(path, "rb")
        self._data = self._fh.read()
        self._offset = 0

    def read_frame(self):
        data, off = self._data, self._offset
        if off + 16 > len(data):
            return None
        magic, natoms, step = struct.unpack_from(">3i", data, off)
        if magic != MAGIC:
            raise ValueError(f"bad xtc magic: {magic}")
        (time,) = struct.unpack_from(">f", data, off + 12)
        off += 16
        box = np.frombuffer(data, dtype=">f4", count=9,
                            offset=off).astype(np.float32).reshape(3, 3)
        off += 36
        coords, precision, off = decompress_frame(data, off)
        self._offset = off
        return XtcFrame(natoms, step, time, box, coords, precision)

    def close(self):
        self._fh.close()


class XtcWriter:
    def __init__(self, path):
        self._fh = open(path, "wb")

    def write_frame(self, coords, step=0, time=0.0, box=None,
                    precision=1000.0):
        coords = np.asarray(coords, dtype=np.float32).reshape(-1, 3)
        natoms = coords.shape[0]
        if box is None:
            box = np.zeros((3, 3), dtype=np.float32)
        self._fh.write(struct.pack(">3i", MAGIC, natoms, int(step)))
        self._fh.write(struct.pack(">f", float(time)))
        self._fh.write(np.asarray(box, dtype=">f4").tobytes())
        self._fh.write(compress_frame(coords, precision))

    def close(self):
        self._fh.close()


def read_xtc_natoms(path) -> int:
    with open(path, "rb") as fh:
        head = fh.read(8)
    magic, natoms = struct.unpack(">2i", head)
    if magic != MAGIC:
        raise ValueError(f"bad xtc magic: {magic}")
    return natoms
