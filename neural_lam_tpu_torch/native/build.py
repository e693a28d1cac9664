"""Build the native codec extension in place.

Usage: ``python -m neural_lam_tpu_torch.native.build``. Compiles
``fastcodec.c`` into ``neural_lam_tpu_torch/native/_fastcodec*.so`` with the
current interpreter's config; no setuptools invocation needed.
"""

from __future__ import annotations

import subprocess
import sys
import sysconfig
from pathlib import Path


def build() -> Path:
    here = Path(__file__).parent
    src = here / "fastcodec.c"
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    out = here / f"_fastcodec{suffix}"
    include = sysconfig.get_paths()["include"]
    cc = sysconfig.get_config_var("CC") or "cc"
    cmd = [
        *cc.split(),
        "-O3",
        "-shared",
        "-fPIC",
        f"-I{include}",
        str(src),
        "-o",
        str(out),
    ]
    subprocess.run(cmd, check=True)
    return out


if __name__ == "__main__":
    path = build()
    print(f"Built {path}")
    sys.path.insert(0, str(path.parent.parent.parent))
    from neural_lam_tpu_torch.native import get_fastcodec

    mod = get_fastcodec()
    assert mod is not None, "extension built but not importable"
    assert mod.lz4_decompress(b"\x50hello", 5) == b"hello"
    print("self-test OK")
