"""Native (C) runtime components, with pure-python fallbacks.

The port's own copy of ``neural_lam_tpu/native``.

Currently: ``_fastcodec`` — LZ4 block decoding and blosc byte-unshuffle
for the zarr reader. Build in place with::

    python -m neural_lam_tpu_torch.native.build

``get_fastcodec()`` returns the compiled module or ``None``; callers
keep their python fallbacks.
"""

from __future__ import annotations

from typing import Optional

_cached_mod = None
_tried = False


def get_fastcodec() -> Optional[object]:
    global _cached_mod, _tried
    if not _tried:
        _tried = True
        try:
            import importlib

            _cached_mod = importlib.import_module(
                f"{__name__}._fastcodec"
            )
        except ImportError:
            _cached_mod = None
    return _cached_mod
