#!/usr/bin/env python3
"""Compare the compiled kernels of two checkouts instruction for instruction.

    python3 sass_compare.py BASE [CHECKOUT]

Builds targetdiff_tpu_torch/csrc of BASE and of CHECKOUT (this checkout by
default) with each checkout's own build.py, disassembles both libraries with
cuobjdump -sass, and looks for each of BASE's functions a function of
CHECKOUT with the same instructions and encodings (names differ where a
kernel became a template). Prints one JSON line: BASE's function count, how
many have an identical body in CHECKOUT, and those that have none; exits 1
if any has none. Needs the CUDA toolkit (nvcc, cuobjdump), not a GPU.
"""

from __future__ import annotations

import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

CUOBJDUMP = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
BUILD = ("import sys; sys.path.insert(0, '.'); from targetdiff_tpu_torch.ops.kernels import build; "
         "build.load_library(); print(build.build_dir() / 'libtdkernels.so')")


def library(checkout: Path) -> str:
    """The checkout's kernel library, built if it is not yet."""
    out = subprocess.run([sys.executable, "-c", BUILD], cwd=checkout, capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def bodies(lib: str) -> dict:
    """Function name -> its SASS lines (address comments, instructions and
    encodings, whitespace collapsed)."""
    sass = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True, text=True,
                          check=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/", line):
            # cuobjdump pads the columns to the widest instruction of the
            # object file: compare the words, not the padding
            funcs[name].append(" ".join(line.split()))
    return {n: "\n".join(lines) for n, lines in funcs.items()}


def main(argv) -> int:
    if not 1 <= len(argv) <= 2:
        raise SystemExit("usage: sass_compare.py BASE [CHECKOUT]")
    base = bodies(library(Path(argv[0]).resolve()))
    other = bodies(library(Path(argv[1] if len(argv) > 1 else ".").resolve()))
    digests = {hashlib.sha256(b.encode()).hexdigest() for b in other.values()}
    missing = [n for n, b in base.items() if hashlib.sha256(b.encode()).hexdigest() not in digests]
    print(json.dumps({"base_functions": len(base), "identical": len(base) - len(missing),
                      "checkout_functions": len(other), "missing": missing}))
    return 1 if missing else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
