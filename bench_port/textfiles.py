"""Reading the CLI's output files: numeric columns, parsed in bulk.

The CLI writes a ``#`` comment header (with the time the file was made)
and then whitespace-separated decimal numbers: integers, ``%e`` and
``%g`` floats. ``read_table`` parses every token of the body with numpy
array operations (a token's digits, point and exponent found by position),
since a loop over 10^7 lines in Python, or ``np.loadtxt``, would take
longer than the jobs it checks. ``body_digest`` fingerprints the body
alone, so that two runs' files compare equal whatever time they were
written.
"""

import hashlib

import numpy as np
import torch

_SEP = b" \n\t\r"
_TOKEN = b"0123456789.-+eE"
# powers of ten that float64 holds exactly
_EXACT_POW10 = 22
_MAX_WIDTH = 32


def body(raw):
    """The bytes of ``raw`` after its leading ``#`` comment lines."""
    pos = 0
    while raw.startswith(b"#", pos):
        nl = raw.find(b"\n", pos)
        if nl < 0:
            return b""
        pos = nl + 1
    return raw[pos:]


def body_digest(path):
    """blake2b of the body of the file at ``path``."""
    with open(path, "rb") as fh:
        return hashlib.blake2b(body(fh.read()), digest_size=16).hexdigest()


def _lut(chars, device):
    lut = torch.zeros(256, dtype=torch.bool, device=device)
    lut[list(chars)] = True
    return lut


def _parse_tokens(chars, lengths):
    """float64 values of the tokens in ``chars`` ((W, T) uint8: column t
    holds token t, left-aligned and zero-padded), each correctly rounded:
    an integer mantissa of at most 15 digits times a power of ten, in one
    rounding."""
    w, t = chars.shape
    dev = chars.device
    ok = _lut(_TOKEN + b"\0", dev)[chars.long()]
    if not bool(ok.all()):
        raise ValueError("a token is not a decimal number")
    is_e = (chars == ord("e")) | (chars == ord("E"))
    epos = torch.where(is_e.any(dim=0), is_e.byte().argmax(dim=0), lengths)
    row = torch.arange(w, device=dev)[:, None]
    is_dot = (chars == ord(".")) & (row < epos)
    dpos = torch.where(is_dot.any(dim=0), is_dot.byte().argmax(dim=0), epos)
    digit = (chars >= ord("0")) & (chars <= ord("9"))
    in_mant = digit & (row < epos)
    in_exp = digit & (row > epos)
    if bool((in_mant.sum(dim=0) > 15).any()):
        raise ValueError("a token has more than 15 digits")
    mant = torch.zeros(t, dtype=torch.int64, device=dev)
    expo = torch.zeros(t, dtype=torch.int64, device=dev)
    for k in range(w):
        val = chars[k].long() - ord("0")
        mant = torch.where(in_mant[k], mant * 10 + val, mant)
        expo = torch.where(in_exp[k], expo * 10 + val, expo)
    cols = torch.arange(t, device=dev)
    exp_neg = chars[torch.clamp(epos + 1, max=w - 1), cols] == ord("-")
    expo = torch.where(exp_neg & (epos < lengths), -expo, expo)
    scale = expo - torch.clamp(epos - dpos - 1, min=0)
    far = scale.abs() > _EXACT_POW10
    scale = torch.where(far, 0, scale)
    ten = torch.tensor(10.0, dtype=torch.float64, device=dev)
    m = mant.double()
    mag = torch.where(scale >= 0, m * ten ** scale.clamp(min=0),
                      m / ten ** (-scale).clamp(min=0))
    out = torch.where(chars[0] == ord("-"), -mag, mag).cpu().numpy()
    if bool(far.any()):
        host, lens = chars.cpu().numpy(), lengths.cpu().numpy()
        for k in np.flatnonzero(far.cpu().numpy()):
            out[k] = float(host[:lens[k], k].tobytes())
    return out


def parse_numbers(text, device="cpu", chunk=1 << 22):
    """float64 array of every whitespace-separated number in ``text``,
    parsed with torch on ``device``."""
    if not text:
        return np.zeros(0)
    a = torch.frombuffer(bytearray(text), dtype=torch.uint8).to(device)
    sep = _lut(_SEP, device)[a.long()]
    one = sep.new_ones(1)
    starts = torch.nonzero(~sep & torch.cat((one, sep[:-1])))[:, 0]
    ends = torch.nonzero(~sep & torch.cat((sep[1:], one)))[:, 0] + 1
    del sep
    out = np.empty(len(starts), dtype=np.float64)
    padded = torch.cat((a, a.new_zeros(_MAX_WIDTH)))
    for lo in range(0, len(starts), chunk):
        s = starts[lo:lo + chunk]
        lengths = ends[lo:lo + chunk] - s
        width = int(lengths.max())
        if width > _MAX_WIDTH:
            raise ValueError("a token is longer than 32 characters")
        row = torch.arange(width, device=a.device)[:, None]
        chars = padded[s[None, :] + row]
        chars[row >= lengths[None, :]] = 0
        out[lo:lo + chunk] = _parse_tokens(chars, lengths)
    return out


def read_table(path, n_cols, device="cpu"):
    """(rows, n_cols) float64 table of the body of the file at
    ``path``."""
    with open(path, "rb") as fh:
        values = parse_numbers(body(fh.read()), device)
    if values.size % n_cols:
        raise ValueError(f"{path}: {values.size} numbers do not make rows"
                         f" of {n_cols}")
    return values.reshape(-1, n_cols)
