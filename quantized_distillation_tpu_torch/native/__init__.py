"""The port's host codec: ``csrc/qdt_native.cpp`` bound with ctypes.

A canonical-Huffman codec over quantization levels (what the ``.qdt``
artifact of :mod:`..utils.artifact` stores), sub-byte packing in the layout
of :mod:`..ops.packing`, and padded-batch assembly, each the JAX package's
``native`` function of the same name over the same C++ source, so both
packages write the same bytes. The library is compiled with ``g++`` at
first use (:func:`..kernels._build.load_host`); the public functions raise
if it does not build. Nothing falls back to Python: at full width a pure
Python encoder takes hours.

The ``*_plain`` functions are the same codec in NumPy and pure Python,
kept for the tests that hold the library to them. Huffman code lengths can
differ between the two where frequencies tie (another tree of the same
total length): the library follows the C++ tie order, which is the JAX
package's.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import numpy as np

from ..kernels import _build
from ..ops.huffman import code_lengths

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_SIGNATURES = {
    "qdt_huffman_lengths": (ctypes.c_int, [_u64p, ctypes.c_int32, _u8p]),
    "qdt_huffman_encode": (ctypes.c_int64, [_i32p, ctypes.c_int64, _u8p, ctypes.c_int32,
                                            _u8p, ctypes.c_int64]),
    "qdt_huffman_decode": (ctypes.c_int64, [_u8p, ctypes.c_int64, _u8p, ctypes.c_int32,
                                            _i32p, ctypes.c_int64]),
    "qdt_pack": (ctypes.c_int64, [_i32p, ctypes.c_int64, ctypes.c_int32, _u8p]),
    "qdt_unpack": (ctypes.c_int64, [_u8p, ctypes.c_int64, ctypes.c_int32, _i32p]),
    "qdt_pad_batch": (ctypes.c_int, [_i32p, _i64p, ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_int32, _i32p, _i32p]),
}


def _fn(symbol: str):
    """C entry point ``symbol`` of the codec library (built at first use)."""
    fn = getattr(_build.load_host("qdt_native"), symbol)
    fn.restype, fn.argtypes = _SIGNATURES[symbol]
    return fn


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _stream(indices) -> np.ndarray:
    return np.ascontiguousarray(indices, np.int32).reshape(-1)


# ---------------------------------------------------------------------------
# Huffman codec
# ---------------------------------------------------------------------------

def huffman_lengths(freqs: np.ndarray) -> np.ndarray:
    """Code length per symbol (uint8; 0 = absent) from a frequency array."""
    f = np.ascontiguousarray(freqs, np.uint64)
    out = np.zeros(f.size, np.uint8)
    if _fn("qdt_huffman_lengths")(_ptr(f, ctypes.c_uint64), f.size, _ptr(out, ctypes.c_uint8)):
        raise ValueError(f"huffman_lengths: invalid alphabet of {f.size}")
    return out


def _encode_setup(indices, alphabet: int, lengths) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    idx = _stream(indices)
    if idx.size and (idx.min() < 0 or idx.max() >= alphabet):
        raise ValueError(f"huffman_encode: symbol outside [0, {alphabet})")
    freqs = np.bincount(idx, minlength=alphabet).astype(np.uint64)
    lens = lengths(freqs)
    cap = max((int((freqs * lens).sum()) + 7) // 8, 1)
    return idx, lens, np.zeros(cap, np.uint8)


def huffman_encode(indices: np.ndarray, alphabet: int) -> Tuple[bytes, np.ndarray, int]:
    """Canonical-Huffman encode an index stream → (payload bytes, code
    length per symbol [alphabet] uint8, bit count). The length table is all
    the side information: the decoder rebuilds the canonical code from it."""
    idx, lens, out = _encode_setup(indices, alphabet, huffman_lengths)
    nbits = _fn("qdt_huffman_encode")(
        _ptr(idx, ctypes.c_int32), idx.size, _ptr(lens, ctypes.c_uint8), alphabet,
        _ptr(out, ctypes.c_uint8), out.size)
    if nbits < 0:
        raise ValueError("huffman_encode: invalid stream")
    return out.tobytes(), lens, int(nbits)


def huffman_decode(payload: bytes, n_bits: int, lens: np.ndarray, n_symbols: int) -> np.ndarray:
    """Inverse of :func:`huffman_encode` → int32 index stream [n_symbols]."""
    lens = np.ascontiguousarray(lens, np.uint8)
    data = np.frombuffer(payload, np.uint8)
    if n_bits > data.size * 8:
        raise ValueError("huffman_decode: n_bits exceeds the payload")
    out = np.zeros(n_symbols, np.int32)
    got = _fn("qdt_huffman_decode")(
        _ptr(data, ctypes.c_uint8), n_bits, _ptr(lens, ctypes.c_uint8), lens.size,
        _ptr(out, ctypes.c_int32), n_symbols)
    if got != n_symbols:
        raise ValueError("huffman_decode: malformed stream")
    return out


def canonical_codes(lens: np.ndarray) -> np.ndarray:
    """Canonical code values ordered by (length, symbol), as the C++ builds
    them."""
    lens = np.asarray(lens, np.uint8)
    max_len = int(lens.max()) if lens.size else 0
    codes = np.zeros(lens.size, np.uint32)
    if max_len == 0:
        return codes
    count = np.bincount(lens, minlength=max_len + 1)
    count[0] = 0
    nxt = np.zeros(max_len + 1, np.uint32)
    code = 0
    for length in range(1, max_len + 1):
        code = (code + int(count[length - 1])) << 1
        nxt[length] = code
    for s in range(lens.size):
        if lens[s]:
            codes[s] = nxt[lens[s]]
            nxt[lens[s]] += 1
    return codes


def huffman_lengths_plain(freqs: np.ndarray) -> np.ndarray:
    """:func:`huffman_lengths` by :func:`..ops.huffman.code_lengths`."""
    freqs = np.asarray(freqs, np.uint64)
    out = np.zeros(freqs.size, np.uint8)
    for s, length in code_lengths({i: int(f) for i, f in enumerate(freqs)}).items():
        out[s] = length
    return out


def huffman_encode_plain(indices: np.ndarray, alphabet: int) -> Tuple[bytes, np.ndarray, int]:
    """:func:`huffman_encode` in pure Python (one symbol at a time)."""
    idx, lens, out = _encode_setup(indices, alphabet, huffman_lengths_plain)
    codes = canonical_codes(lens)
    bitpos = 0
    for s in idx:
        c = int(codes[s])
        for b in range(int(lens[s]) - 1, -1, -1):
            if (c >> b) & 1:
                out[bitpos >> 3] |= 0x80 >> (bitpos & 7)
            bitpos += 1
    return out.tobytes(), lens, bitpos


def huffman_decode_plain(payload: bytes, n_bits: int, lens: np.ndarray,
                         n_symbols: int) -> np.ndarray:
    """:func:`huffman_decode` in pure Python (one bit at a time)."""
    lens = np.asarray(lens, np.uint8)
    data = np.frombuffer(payload, np.uint8)
    codes = canonical_codes(lens)
    lookup = {(int(lens[s]), int(codes[s])): s for s in range(lens.size) if lens[s]}
    out = np.zeros(n_symbols, np.int32)
    bitpos = 0
    for i in range(n_symbols):
        code = length = 0
        while (length, code) not in lookup:
            if bitpos >= n_bits:
                raise ValueError("huffman_decode: truncated stream")
            code = (code << 1) | int((data[bitpos >> 3] >> (7 - (bitpos & 7))) & 1)
            bitpos += 1
            length += 1
        out[i] = lookup[(length, code)]
    return out


# ---------------------------------------------------------------------------
# Sub-byte packing (the host twin of ops/packing.py)
# ---------------------------------------------------------------------------

def _levels(levels, bits: int) -> np.ndarray:
    lv = _stream(levels)
    f = 8 // bits
    if bits not in (2, 4, 8) or lv.size % f:
        raise ValueError(f"{bits}-bit packing of a stream of {lv.size}")
    return lv


def pack_stream(levels: np.ndarray, bits: int) -> np.ndarray:
    """Pack a flat level stream into uint8 (the :mod:`..ops.packing` layout)."""
    lv = _levels(levels, bits)
    out = np.zeros(lv.size // (8 // bits), np.uint8)
    if _fn("qdt_pack")(_ptr(lv, ctypes.c_int32), lv.size, bits, _ptr(out, ctypes.c_uint8)) < 0:
        raise ValueError("pack_stream: level out of range")
    return out


def unpack_stream(packed: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of :func:`pack_stream` → int32 levels."""
    pk = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8; got {bits}")
    out = np.zeros(pk.size * (8 // bits), np.int32)
    _fn("qdt_unpack")(_ptr(pk, ctypes.c_uint8), pk.size, bits, _ptr(out, ctypes.c_int32))
    return out


def pack_stream_plain(levels: np.ndarray, bits: int) -> np.ndarray:
    lv = _levels(levels, bits)
    f = 8 // bits
    v = lv.reshape(-1, f).astype(np.uint32)
    if (v >> bits).any():
        raise ValueError("pack_stream: level out of range")
    out = np.zeros(lv.size // f, np.uint8)
    for k in range(f):
        out |= (v[:, k] << (k * bits)).astype(np.uint8)
    return out


def unpack_stream_plain(packed: np.ndarray, bits: int) -> np.ndarray:
    pk = np.ascontiguousarray(packed, np.uint8).reshape(-1)
    f = 8 // bits
    out = np.zeros(pk.size * f, np.int32)
    for k in range(f):
        out[k::f] = (pk >> (k * bits)) & ((1 << bits) - 1)
    return out


# ---------------------------------------------------------------------------
# Batch assembly
# ---------------------------------------------------------------------------

def pad_batch(sentences: Sequence[Sequence[int]], max_len: int,
              pad: int) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged token lists → (padded [B, max_len] int32, lengths [B] int32)."""
    b = len(sentences)
    out = np.zeros((b, max_len), np.int32)
    lens = np.zeros(b, np.int32)
    if b == 0:
        return out, lens
    flat = np.concatenate([np.asarray(s, np.int32).reshape(-1) for s in sentences] + [
        np.zeros(1, np.int32)])  # one spare element: never a null pointer
    offsets = np.zeros(b + 1, np.int64)
    np.cumsum([len(s) for s in sentences], out=offsets[1:])
    err = _fn("qdt_pad_batch")(_ptr(flat, ctypes.c_int32), _ptr(offsets, ctypes.c_int64), b,
                               max_len, pad, _ptr(out, ctypes.c_int32),
                               _ptr(lens, ctypes.c_int32))
    if err:
        raise ValueError(f"pad_batch: invalid arguments (max_len {max_len})")
    return out, lens


def pad_batch_plain(sentences: Sequence[Sequence[int]], max_len: int,
                    pad: int) -> Tuple[np.ndarray, np.ndarray]:
    out = np.full((len(sentences), max_len), pad, np.int32)
    lens = np.zeros(len(sentences), np.int32)
    for i, s in enumerate(sentences):
        n = min(len(s), max_len)
        out[i, :n] = np.asarray(s[:n], np.int32)
        lens[i] = n
    return out, lens
