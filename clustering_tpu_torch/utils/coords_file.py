"""Unified coordinate-file streaming (ASCII / GROMACS .xtc).

Mirrors the reference handler layer (src/coords_file/coords_file.{hpp,cpp}):
an abstract row-stream with ``next()/write()/eof()`` and an
extension-sniffing ``open_coords_file`` factory.
"""


class CoordsHandler:
    def next(self):
        raise NotImplementedError

    def write(self, row):
        raise NotImplementedError

    def eof(self):
        raise NotImplementedError

    def close(self):
        pass


class AsciiHandler(CoordsHandler):
    """Whitespace-separated ASCII rows (reference: coords_file.cpp:46-90)."""

    def __init__(self, fname, mode):
        self._eof = False
        self._mode = mode
        if mode == "r":
            self._fh = open(fname, "r")
        elif mode == "w":
            self._fh = open(fname, "w")
        else:
            raise ValueError(f"unknown mode: {mode}")

    def next(self):
        if self._mode == "r":
            import numpy as np
            for line in self._fh:
                if line.strip() == "":
                    continue  # skip empty lines
                # the reference streams into float (fp32); precision at
                # write-out depends on it
                return [np.float32(t) for t in line.split()]
        self._eof = True
        return []

    def write(self, row):
        import numpy as np
        # reference writes " <v1> <v2> ..." with default ostream formatting
        # of float values
        self._fh.write("".join(" %g" % float(np.float32(v))
                               for v in row) + "\n")

    def eof(self):
        return self._eof

    def close(self):
        self._fh.close()


class XtcHandler(CoordsHandler):
    """GROMACS .xtc compressed trajectories (reference:
    coords_file.cpp:95-155). Each row is the flattened (natoms*3,)
    coordinate vector of one frame."""

    def __init__(self, fname, mode):
        from . import xtc
        self._eof = False
        self._mode = mode
        self._nrow = 0
        if mode == "r":
            self._reader = xtc.XtcReader(fname)
            self._writer = None
        elif mode == "w":
            self._writer = xtc.XtcWriter(fname)
            self._reader = None
        else:
            raise ValueError(f"unknown mode: {mode}")

    def next(self):
        if self._mode == "r":
            frame = self._reader.read_frame()
            if frame is not None:
                return frame.coords.reshape(-1)
        self._eof = True
        return []

    def write(self, row):
        if self._mode == "w":
            import numpy as np
            coords = np.asarray(row, dtype=np.float32).reshape(-1, 3)
            # fake box, step counter as time (reference: coords_file.cpp:136-149)
            self._writer.write_frame(coords, step=self._nrow,
                                     time=float(self._nrow), precision=1000.0)
            self._nrow += 1

    def eof(self):
        return self._eof

    def close(self):
        if self._reader is not None:
            self._reader.close()
        if self._writer is not None:
            self._writer.close()


def open_coords_file(fname, mode) -> CoordsHandler:
    """Extension-sniffing factory (reference: coords_file.cpp:160-168)."""
    if fname.endswith(".xtc"):
        return XtcHandler(fname, mode)
    return AsciiHandler(fname, mode)
