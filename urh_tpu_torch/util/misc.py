"""Small shared helpers: vectorized bit-plane -> text views, external
command execution, HTML log snippets.

Array-first counterparts of urh/util/util.py:114-175 (bit/hex/ascii/
decimal/BCD views), urh/util/HTMLFormatter.py (simulator log markup) and
cythonext/util.pyx:20-36,63-73 (minmax / arr_to_number).  Unlike the
reference — which renders through per-character Python loops over a
"0101" string — every view here is a NumPy group reduction over the
uint8 bit plane (the same weights-dot idiom as protocol/message.py),
so rendering a megabit message is a handful of array ops.
"""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess

import numpy as np

PROJECT_PATH = None

VIEW_BIT, VIEW_HEX, VIEW_ASCII, VIEW_DECIMAL, VIEW_BCD = range(5)

_HEX_DIGITS = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def _grouped_values(plane: np.ndarray, width: int) -> np.ndarray:
    """MSB-first ``width``-bit symbol values over the plane.

    A trailing partial group is interpreted right-aligned as its own
    small number (matching ``int(bits[i:i+width], 2)`` on a short
    slice in util.py:150-158) — NOT zero-padded; callers that want
    nibble/byte padding pad the plane first.
    """
    full = len(plane) - len(plane) % width
    weights = 1 << np.arange(width - 1, -1, -1, dtype=np.int64)
    values = plane[:full].astype(np.int64).reshape(-1, width) @ weights
    tail = plane[full:]
    if tail.size:
        tail_weights = 1 << np.arange(tail.size - 1, -1, -1, dtype=np.int64)
        values = np.concatenate([values, [tail.astype(np.int64) @ tail_weights]])
    return values


def _plane_to_int(plane: np.ndarray) -> int:
    """Arbitrary-precision integer from an MSB-first bit plane."""
    pad = (-len(plane)) % 8
    return int.from_bytes(np.packbits(plane).tobytes(), "big") >> pad


def convert_bits_to_string(bits, output_view_type: int, pad_zeros=False, lsb=False,
                           lsd=False, endianness="big"):
    """Render a bit plane as bit/hex/ascii/decimal/BCD text
    (urh/util/util.py:114-175 semantics, vectorized)."""
    plane = np.asarray(bits, dtype=np.uint8).reshape(-1)

    if output_view_type == VIEW_BCD:
        pad_zeros = True  # BCD is defined on whole nibbles

    if pad_zeros and output_view_type in (VIEW_HEX, VIEW_ASCII, VIEW_BCD):
        width = 8 if output_view_type == VIEW_ASCII else 4
        plane = np.concatenate(
            [plane, np.zeros((-len(plane)) % width, dtype=np.uint8)])

    if lsb:
        plane = plane[::-1]

    if endianness == "little":
        # regroup in 8-bit chunks anchored at the END of the plane and
        # reverse the chunk order; the short head chunk renders last
        head = len(plane) % 8
        swapped = plane[head:].reshape(-1, 8)[::-1].reshape(-1)
        plane = np.concatenate([swapped, plane[:head]])

    if output_view_type == VIEW_BIT:
        result = (plane + ord("0")).astype(np.uint8).tobytes().decode("ascii")
    elif output_view_type == VIEW_HEX:
        result = _HEX_DIGITS[_grouped_values(plane, 4)].tobytes().decode("ascii")
    elif output_view_type == VIEW_ASCII:
        # latin-1 maps byte value n to chr(n) for the whole 0..255 range
        result = _grouped_values(plane, 8).astype(np.uint8).tobytes().decode("latin-1")
    elif output_view_type == VIEW_DECIMAL:
        if plane.size == 0:
            return None
        result = str(_plane_to_int(plane))
    elif output_view_type == VIEW_BCD:
        nibbles = _grouped_values(plane, 4)
        chars = np.where(nibbles < 10, nibbles + ord("0"), ord("?")).astype(np.uint8)
        result = chars.tobytes().decode("ascii")
    else:
        raise ValueError(f"unknown view type {output_view_type}")

    return result[::-1] if lsd else result


# -- external program execution (simulator triggers / codecs) ---------------

def parse_command(command: str):
    """Split a shell-ish command line; resolve the executable relative to
    the open project directory when it exists there (util.py:77-96)."""
    try:
        parts = shlex.split(command, posix=True)
    except ValueError:
        parts = []
    if not parts:
        return "", []
    cmd, args = parts[0], parts[1:]
    if PROJECT_PATH is not None and not os.path.isabs(cmd):
        candidate = os.path.join(PROJECT_PATH, cmd)
        if os.path.exists(candidate):
            cmd = candidate
    return cmd, args


def validate_command(command: str) -> bool:
    if not isinstance(command, str):
        return False
    return shutil.which(parse_command(command)[0]) is not None


def run_command(command, param: str = None, use_stdin=False, detailed_output=False,
                return_rc=False):
    cmd, args = parse_command(command)
    if shutil.which(cmd) is None:
        return ("", 1) if return_rc else ""

    argv = [cmd, *args] + ([param] if param is not None and not use_stdin else [])
    try:
        proc = subprocess.run(argv, input=param if use_stdin else None,
                              capture_output=True, text=True, timeout=60)
        rc = proc.returncode
        if detailed_output:
            out = "{} exited with {} ({})".format(
                os.path.basename(cmd), rc, (proc.stdout + proc.stderr).strip())
        else:
            out = proc.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out, rc = str(e), 1

    return (out, rc) if return_rc else out


# -- simulator HTML log snippets --------------------------------------------
# Compositional markup builder instead of literal template strings; diff
# highlighting wraps whole mismatch RUNS in one element (computed from a
# boolean mismatch mask) rather than emitting one tag per character.

INDENT_WIDTH_PX = 20


def _tag(name: str, content: str, **attrs) -> str:
    rendered = "".join(f' {key}="{value}"' for key, value in attrs.items())
    return f"<{name}{rendered}>{content}</{name}>"


def monospace(string: str) -> str:
    return _tag("samp", string)


def indent_string(string: str, depth: int = 1) -> str:
    return _tag("div", string,
                style=f"margin-left: {depth * INDENT_WIDTH_PX}px;")


def _codepoints(text: str) -> np.ndarray:
    return np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)


def mark_differences(value: str, compare_against: str) -> str:
    """Highlight the characters of ``value`` that differ from
    ``compare_against``; overhang past the comparison string stays
    unmarked (HTMLFormatter.mark_differences semantics)."""
    n = min(len(value), len(compare_against))
    mismatch = _codepoints(value)[:n] != _codepoints(compare_against)[:n]
    bounded = np.concatenate([[False], mismatch, [False]])
    run_starts = np.flatnonzero(bounded[1:] & ~bounded[:-1])
    run_ends = np.flatnonzero(~bounded[1:] & bounded[:-1])

    pieces, cursor = [], 0
    for start, end in zip(run_starts.tolist(), run_ends.tolist()):
        pieces.append(value[cursor:start])
        pieces.append(_tag("font", value[start:end], color="red"))
        cursor = end
    pieces.append(value[cursor:])
    return "".join(pieces)


def align_expected_and_got_value(expected: str, got: str, align_depth=1) -> str:
    rows = (
        _tag("tr", _tag("td", "Expected: ") + _tag("td", monospace(expected)))
        + _tag("tr", _tag("td", "Got: ")
               + _tag("td", monospace(mark_differences(got, expected))))
    )
    return _tag("table", rows, border=0,
                style=f"margin-left: {align_depth * INDENT_WIDTH_PX}px;")


# -- small numeric helpers ---------------------------------------------------

def convert_numbers_to_hex_string(arr) -> str:
    """[0, 1, 10, 2] -> "01a2"; out-of-range entries render spaced
    (util.py:310-318)."""
    return "".join(format(x, "x") if 0 <= x < 16 else f" {x} " for x in arr)


def minmax(arr):
    """(min, max) of a numeric array; (0, 0) for empty input
    (cythonext/util.pyx:20-36)."""
    arr = np.asarray(arr)
    if arr.size == 0:
        return 0, 0
    return arr.min(), arr.max()


def arr_to_number(inpt, reverse: bool = False, start: int = 0) -> int:
    """Bit array -> arbitrary-precision integer; MSB-first unless
    ``reverse`` (cythonext/util.pyx:63-73), via packbits instead of the
    reference's per-bit shift loop."""
    bits = np.asarray(inpt, dtype=np.uint8).reshape(-1)[start:]
    if bits.size == 0:
        return 0
    msb_first = bits[::-1] if reverse else bits
    return _plane_to_int(msb_first)
