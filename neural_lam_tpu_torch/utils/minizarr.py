"""Minimal pure-python zarr v2 reader (no zarr/numcodecs dependency).

Reads the on-disk zarr stores produced by xarray/mllam-data-prep
(reference: neural_lam/datastore/mdp.py:87 ``xr.open_zarr``): v2
directory stores with ``.zgroup``/``.zarray``/``.zattrs`` (or
consolidated ``.zmetadata``), C-order chunks and the common compressors:

- ``null`` (raw), ``zlib``, ``gzip``, ``zstd``,
- ``blosc`` containers with zstd/zlib/lz4 inner codecs and byte-shuffle
  (lz4 block decoding is implemented in pure python — slow but correct,
  used only when the fast codecs are unavailable for a chunk).

Also implements the xarray conventions needed here: dimension names from
``_ARRAY_DIMENSIONS``, CF time decoding ("<unit> since <epoch>"), and
``_FillValue``/``fill_value`` masking for floats.

The port's own copy of ``neural_lam_tpu/utils/minizarr.py``, with one
change: :meth:`ZarrArray.read` returns a read-only array. The MDP
datastore caches what it reads and hands out views of the cache to every
split, so a consumer that wrote into one would change the others.
"""

from __future__ import annotations

import json
import re
import struct
import zlib
from pathlib import Path
from typing import Optional

import numpy as np


# -- codecs -----------------------------------------------------------------
def _lz4_decompress_block(src: bytes, dst_size: int) -> bytes:
    """LZ4 block decoder: native C extension when built, else python."""
    from ..native import get_fastcodec

    mod = get_fastcodec()
    if mod is not None:
        return mod.lz4_decompress(src, dst_size)
    return _lz4_decompress_block_py(src, dst_size)


def _lz4_decompress_block_py(src: bytes, dst_size: int) -> bytes:
    """Pure-python LZ4 block decoder (no frame header)."""
    dst = bytearray()
    i = 0
    n = len(src)
    while i < n and len(dst) < dst_size:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        dst += src[i : i + lit_len]
        i += lit_len
        if i >= n:
            break  # last literals-only sequence
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        match_len = token & 0xF
        if match_len == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        match_len += 4
        start = len(dst) - offset
        for k in range(match_len):  # may overlap; byte-by-byte copy
            dst.append(dst[start + k])
    return bytes(dst)


def _decompress_codec(cname: str, data: bytes, dst_size: int) -> bytes:
    if cname in ("zlib",):
        return zlib.decompress(data)
    if cname == "gzip":
        import gzip as _gzip

        return _gzip.decompress(data)
    if cname == "zstd":
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            data, max_output_size=dst_size
        )
    if cname in ("lz4", "lz4hc"):
        try:
            import lz4.block  # type: ignore

            return lz4.block.decompress(data, uncompressed_size=dst_size)
        except ImportError:
            return _lz4_decompress_block(data, dst_size)
    raise NotImplementedError(f"Unsupported inner codec {cname!r}")


_BLOSC_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}


def _blosc_decompress(data: bytes) -> bytes:
    """Decode a blosc1 frame (header + block table + compressed blocks)."""
    version, _versionlz, flags, typesize = data[0], data[1], data[2], data[3]
    nbytes, blocksize, cbytes = struct.unpack_from("<III", data, 4)
    byte_shuffle = bool(flags & 0x1)
    memcpyed = bool(flags & 0x2)
    bit_shuffle = bool(flags & 0x4)
    codec = _BLOSC_CODECS.get((flags >> 5) & 0x7, "blosclz")
    if bit_shuffle:
        raise NotImplementedError("blosc bit-shuffle not supported")

    if memcpyed:
        out = data[16 : 16 + nbytes]
    else:
        nblocks = -(-nbytes // blocksize) if blocksize else 1
        bstarts = struct.unpack_from(f"<{nblocks}i", data, 16)
        out_parts = []
        remaining = nbytes
        for b in range(nblocks):
            bsize = min(blocksize, remaining)
            start = bstarts[b]
            # Blocks may be "split" into typesize sub-streams, each
            # prefixed by an int32 compressed size. Non-split blocks are
            # one codec stream. Detect split by attempting the prefixed
            # format used by blosc for shuffled lz4/blosclz blocks.
            block = _decompress_blosc_block(
                data, start, bsize, codec, typesize, byte_shuffle
            )
            if byte_shuffle and typesize > 1:
                # The shuffle filter operates block-by-block in c-blosc
                # (shuffle.c): each block's typesize byte planes are
                # interleaved independently, with any tail bytes not
                # filling a whole element copied through unshuffled.
                block = _byte_unshuffle(block, typesize)
            out_parts.append(block)
            remaining -= bsize
        out = b"".join(out_parts)
    return out


def _byte_unshuffle(block: bytes, typesize: int) -> bytes:
    """Invert c-blosc's per-block byte shuffle.

    The shuffled region covers ``(len // typesize) * typesize`` bytes
    laid out plane-major (all first bytes, then all second bytes, ...);
    leftover tail bytes are stored verbatim after the planes.
    """
    n_elem = len(block) // typesize
    body = n_elem * typesize
    tail = block[body:]
    from ..native import get_fastcodec

    mod = get_fastcodec()
    if mod is not None:
        return mod.byte_unshuffle(block[:body], typesize) + tail
    arr = np.frombuffer(block, dtype=np.uint8, count=body)
    return arr.reshape(typesize, n_elem).T.tobytes() + tail


def _decompress_blosc_block(
    data: bytes,
    start: int,
    dst_size: int,
    codec: str,
    typesize: int,
    shuffled: bool,
) -> bytes:
    """One blosc block: try split sub-streams, else a single stream."""
    # Split format: typesize sub-streams each prefixed with int32 csize.
    # Blosc splits blocks for fast codecs (blosclz/lz4) when shuffling.
    if shuffled and codec in ("blosclz", "lz4", "lz4hc") and typesize > 1:
        try:
            parts = []
            pos = start
            sub_size = dst_size // typesize
            for _ in range(typesize):
                (csize,) = struct.unpack_from("<i", data, pos)
                pos += 4
                raw = data[pos : pos + abs(csize)]
                # c-blosc1 stores incompressible sub-streams RAW with
                # csize == neblock (blosc.c blosc_d memcpy branch), not
                # only with a negative marker — feeding those bytes to
                # the codec corrupts or fails the decode
                if csize < 0 or csize == sub_size:
                    parts.append(raw)
                else:
                    parts.append(
                        _decompress_codec(codec, raw, sub_size)
                    )
                pos += abs(csize)
            if all(len(p) == sub_size for p in parts):
                return b"".join(parts)
        except Exception:
            pass
    # Single stream with int32 csize prefix (blosc >= 1.x block layout)
    try:
        (csize,) = struct.unpack_from("<i", data, start)
        raw = data[start + 4 : start + 4 + abs(csize)]
        if csize < 0 or csize == dst_size:  # raw block (see above)
            return raw[:dst_size]
        out = _decompress_codec(codec, raw, dst_size)
        if len(out) == dst_size:
            return out
    except Exception:
        pass
    # Fallback: stream starting directly at offset
    return _decompress_codec(codec, data[start:], dst_size)


# -- arrays -----------------------------------------------------------------
class ZarrArray:
    """A single zarr v2 array backed by lazy chunk reads."""

    def __init__(self, path: Path, meta: dict, attrs: dict) -> None:
        self.path = Path(path)
        self.meta = meta
        self.attrs = attrs
        self.shape = tuple(meta["shape"])
        self.chunks = tuple(meta["chunks"])
        self.dtype = np.dtype(meta["dtype"])
        self.fill_value = meta.get("fill_value")
        self._sep = meta.get("dimension_separator", ".")
        if meta.get("order", "C") != "C":
            raise NotImplementedError("Only C-order zarr arrays supported")
        if meta.get("filters"):
            raise NotImplementedError("zarr filters not supported")

    @property
    def dims(self) -> Optional[tuple[str, ...]]:
        d = self.attrs.get("_ARRAY_DIMENSIONS")
        return tuple(d) if d is not None else None

    def _chunk(self, idx: tuple[int, ...]) -> np.ndarray:
        key = self._sep.join(str(i) for i in idx) if idx else "0"
        fp = self.path / key
        n_items = int(np.prod(self.chunks)) if self.chunks else 1
        if not fp.exists():
            fill = self.fill_value
            if fill is None:
                fill = 0
            return np.full(self.chunks, fill, dtype=self.dtype)
        data = fp.read_bytes()
        comp = self.meta.get("compressor")
        if comp is None:
            raw = data
        elif comp["id"] == "blosc":
            raw = _blosc_decompress(data)
        elif comp["id"] in ("zlib", "gzip", "zstd"):
            raw = _decompress_codec(
                comp["id"], data, n_items * self.dtype.itemsize
            )
        else:
            raise NotImplementedError(
                f"Unsupported zarr compressor {comp['id']!r}"
            )
        arr = np.frombuffer(raw, dtype=self.dtype, count=n_items)
        return arr.reshape(self.chunks)

    def read(self) -> np.ndarray:
        """Materialise the full array, read-only."""
        if not self.shape:
            # 0-d arrays (scalar reference times, fill scalars) get the
            # same CF/fill decoding as everything else
            out = self._decode(self._chunk(()).reshape(()))
            out.setflags(write=False)
            return out
        out = np.empty(self.shape, dtype=self.dtype)
        n_chunks = [
            -(-s // c) for s, c in zip(self.shape, self.chunks)
        ]
        for idx in np.ndindex(*n_chunks):
            chunk = self._chunk(idx)
            slices = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, self.chunks, self.shape)
            )
            trim = tuple(
                slice(0, sl.stop - sl.start) for sl in slices
            )
            out[slices] = chunk[trim]
        out = self._decode(out)
        out.setflags(write=False)
        return out

    def _decode(self, out: np.ndarray) -> np.ndarray:
        """Apply CF time decoding and fill-value masking (xarray conv.)."""
        units = self.attrs.get("units", "")
        # Mask float fill values to NaN BEFORE CF time decoding so a
        # fill-valued time decodes to NaT, not a garbage timestamp.
        fill = self.attrs.get("_FillValue", self.fill_value)
        is_time = isinstance(units, str) and " since " in units
        if (
            fill is not None
            and np.issubdtype(out.dtype, np.floating)
            and not (isinstance(fill, float) and np.isnan(fill))
        ):
            out = np.where(out == fill, np.nan, out)
        if is_time:
            decoded = _decode_cf_time(out, units)
            if (
                fill is not None
                and np.issubdtype(out.dtype, np.integer)
                and np.issubdtype(decoded.dtype, np.datetime64)
            ):
                # int-encoded CF times (xarray's default) cannot carry
                # NaN; mask AFTER decoding so a fill-valued time is
                # NaT, not a wrapped garbage timestamp
                decoded = np.where(
                    out == fill, np.datetime64("NaT"), decoded
                )
            return decoded
        return out


_CF_UNITS = {
    "seconds": "s",
    "second": "s",
    "minutes": "m",
    "minute": "m",
    "hours": "h",
    "hour": "h",
    "days": "D",
    "day": "D",
}


def _decode_cf_time(values: np.ndarray, units: str) -> np.ndarray:
    unit_name, _, epoch = units.partition(" since ")
    np_unit = _CF_UNITS.get(unit_name.strip().lower())
    if np_unit is None:
        return values
    epoch_s = epoch.strip()
    # CF-legal timezone suffixes: '... 00:00:00 UTC', '...Z', '+00:00'
    tz_shift = np.timedelta64(0, "m")
    parts = epoch_s.split()
    if parts and parts[-1].upper() in ("UTC", "GMT", "Z"):
        parts = parts[:-1]
    elif parts and re.fullmatch(r"[+-]\d{1,2}:?\d{2}", parts[-1]):
        tz = parts[-1].replace(":", "")
        sign = -1 if tz[0] == "+" else 1  # epoch in +hh:mm is EARLIER
        tz_shift = sign * np.timedelta64(
            int(tz[1:-2] or 0) * 60 + int(tz[-2:]), "m"
        )
        parts = parts[:-1]
    epoch_s = " ".join(parts)
    if epoch_s.endswith("Z"):
        epoch_s = epoch_s[:-1]
    epoch64 = (
        np.datetime64(epoch_s.replace(" ", "T"), "ns") + tz_shift
    )
    step_ns = np.timedelta64(1, np_unit).astype("timedelta64[ns]")
    values = np.asarray(values)
    if np.issubdtype(values.dtype, np.floating):
        # CF allows fractional offsets (xarray writes float64 for
        # non-integral steps): split integer and fractional parts so
        # large offsets keep exact ns precision; NaN (masked fill)
        # decodes to NaT rather than a garbage timestamp.
        nan = np.isnan(values)
        safe = np.where(nan, 0.0, values)
        whole = np.floor(safe)
        frac = safe - whole
        step_count = step_ns.astype("int64")
        offs_ns = whole.astype("int64") * step_count + np.round(
            frac * step_count
        ).astype("int64")
        out = epoch64 + offs_ns.astype("timedelta64[ns]")
        return np.where(nan, np.datetime64("NaT"), out)
    return epoch64 + (values.astype("int64") * step_ns)


# -- groups -----------------------------------------------------------------
class ZarrGroup:
    """A zarr v2 group directory; arrays accessed by name."""

    def __init__(self, path: str | Path) -> None:
        self.path = Path(path)
        if not self.path.exists():
            raise FileNotFoundError(f"No zarr store at {self.path}")
        self._consolidated: Optional[dict] = None
        zmeta = self.path / ".zmetadata"
        if zmeta.exists():
            self._consolidated = json.loads(
                zmeta.read_text(encoding="utf-8")
            )["metadata"]

    def _meta(self, key: str) -> Optional[dict]:
        if self._consolidated is not None:
            return self._consolidated.get(key)
        fp = self.path / key
        if fp.exists():
            return json.loads(fp.read_text(encoding="utf-8"))
        return None

    @property
    def attrs(self) -> dict:
        return self._meta(".zattrs") or {}

    def array_names(self) -> list[str]:
        names = set()
        if self._consolidated is not None:
            for key in self._consolidated:
                if key.endswith("/.zarray"):
                    names.add(key[: -len("/.zarray")])
        else:
            for child in self.path.iterdir():
                if (child / ".zarray").exists():
                    names.add(child.name)
        return sorted(names)

    def __contains__(self, name: str) -> bool:
        return self._meta(f"{name}/.zarray") is not None

    def __getitem__(self, name: str) -> ZarrArray:
        meta = self._meta(f"{name}/.zarray")
        if meta is None:
            raise KeyError(f"No array {name!r} in {self.path}")
        attrs = self._meta(f"{name}/.zattrs") or {}
        return ZarrArray(self.path / name, meta, attrs)
