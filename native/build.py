"""Build the _zf_native C++ host runtime:

    python native/build.py

Compiles native/zf_native.cpp with the system C++ compiler into
``_zf_native<EXT_SUFFIX>`` at the repository root, where it imports beside
``zigflac_tpu/`` (``*.so`` is git-ignored). Needs only a C++17 compiler and
the Python headers that ``sysconfig`` names: no setuptools, and no
``-march=native``, so the library runs on any x86-64 host, not only the one
that built it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sysconfig
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
SOURCE = os.path.join(HERE, "zf_native.cpp")


def output_path() -> str:
    return os.path.join(
        ROOT, "_zf_native" + sysconfig.get_config_var("EXT_SUFFIX")
    )


def build() -> str:
    """Compile the extension and return its path. The library is written
    to a temporary file and renamed into place, so a concurrent importer
    never sees a half-written file."""
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (c++ or g++) on PATH")
    out = output_path()
    fd, tmp = tempfile.mkstemp(prefix="_zf_native_build", suffix=".so",
                               dir=ROOT)
    os.close(fd)
    try:
        subprocess.run(
            [cxx, "-O3", "-std=c++17", "-pthread", "-shared", "-fPIC",
             "-I" + sysconfig.get_paths()["include"], SOURCE, "-o", tmp],
            check=True,
        )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


if __name__ == "__main__":
    print(build())
