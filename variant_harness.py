"""What the kernel-variant tools share (edge_bwd_variants.py,
weight_grad_variants.py, node_ew_variants.py): each variant is a temporary
copy of the targetdiff_tpu_torch package whose CUDA sources a tool changes;
the copies are built in parallel and measured one after the other, each in a
process of its own (`SCRIPT --measure COPY VARIANT [ARG ...]`), the
unchanged kernel ("kernel") first and last, after the card's name and power
limit. A tool keeps only its variants and its measure function.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
PACKAGE = "targetdiff_tpu_torch"
CSRC = Path(PACKAGE) / "csrc"


def patch(text: str, old: str, new: str) -> str:
    """`text` with `old`, which it must hold exactly once, replaced by `new`."""
    if text.count(old) != 1:
        raise ValueError(f"the source no longer holds, once:\n{old}")
    return text.replace(old, new)


def rewrite(path: Path, fn) -> None:
    """Replace the file's text by fn(text)."""
    path.write_text(fn(path.read_text()))


def make_copy(base: Path, root: Path, label: str, edit=None) -> Path:
    """A copy of the package of checkout `base` in root / label, its csrc
    directory handed to edit(csrc) if given."""
    dst = root / label
    shutil.copytree(base / PACKAGE, dst / PACKAGE,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    if edit is not None:
        edit(dst / CSRC)
    return dst


def ptxas(entries: dict) -> dict:
    """The `-Xptxas -v` registers and spill lines of the loaded build's
    kernels: entries maps a key to (source file stem, a piece of the
    kernel's mangled name); None where the build has no such kernel."""
    from targetdiff_tpu_torch.ops.kernels import build

    log = (build.build_dir() / "build.log").read_text().splitlines()
    out = {}
    for key, (src, piece) in entries.items():
        entry = next((i for i, ln in enumerate(log)
                      if "Compiling entry" in ln and src in ln and piece in ln), None)
        out[key] = None if entry is None else "; ".join(
            ln.strip() for ln in log[entry + 1:entry + 4] if "registers" in ln or "spill" in ln)
    return out


def main(script: str, argv, variants, copy, measure, *, parent=None, header=None,
         finish=None) -> int:
    """The tool's entry. With `--measure COPY VARIANT [ARG ...]`, print
    measure(Path(COPY), VARIANT, *ARGS) as one JSON line. Otherwise run the
    variants named in argv (all by default): copy(root, name) makes each;
    parent, if given, is (label, copy(root) -> Path) measured first of all;
    every measure process gets root / f"{label}.pt" as its last argument, a
    file it may write; finish(root, order), if given, runs on those files
    before the copies are removed. header: more of the first line."""
    if argv[:1] == ["--measure"]:
        print(json.dumps(measure(Path(argv[1]), argv[2], *argv[3:])), flush=True)
        return 0
    import torch

    name = Path(script).stem
    if not torch.cuda.is_available():
        raise RuntimeError(f"{name} needs a CUDA device")
    names = argv or list(variants)
    if any(n not in variants for n in names):
        raise SystemExit(f"variants: {', '.join(variants)}")
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs

    print(cs.card_name(), *([json.dumps(header)] if header else []), flush=True)
    root = Path(tempfile.mkdtemp(prefix=f"{name}_"))
    try:
        order = ["kernel", *[n for n in names if n != "kernel"], "kernel"]
        copies = {n: copy(root, n) for n in dict.fromkeys(order)}
        if parent is not None:
            copies[parent[0]] = parent[1](root)
            order = [parent[0], *order]
        builds = [subprocess.Popen(
            [sys.executable, "-c", "from targetdiff_tpu_torch.ops.kernels import build; "
             "build.load_library()"], cwd=c) for c in copies.values()]
        if any(b.wait() for b in builds):
            raise RuntimeError("a variant failed to build")
        for n in order:
            subprocess.run([sys.executable, str(Path(script).resolve()), "--measure",
                            str(copies[n]), n, str(root / f"{n}.pt")], check=True)
        if finish is not None:
            finish(root, order)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return 0
