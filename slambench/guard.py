"""What the benchmark may not load: JAX, or the JAX package the program was
ported from; and for the reference, also nothing of the program. Module
names are compared by their top-level name, whole: `rgbdslam_tpu_torch` is
the program, `rgbdslam_tpu` the JAX package."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rgbdslam_tpu"})
PROGRAM = "rgbdslam_tpu_torch"


def top(name: str) -> str:
    return name.split(".")[0]


def loaded_forbidden(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = sys.modules if modules is None else modules
    return sorted({top(m) for m in names} & FORBIDDEN)


def imported_names(path: Path) -> set:
    """Top-level names of every module a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(Path(path).read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(top(a.name) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(top(node.module))
    return names


def reference_imports_forbidden(reference_dir: Path) -> dict:
    """{file: forbidden names} of the reference's sources that import the
    program, JAX or the JAX package."""
    bad = {}
    for path in sorted(Path(reference_dir).glob("*.py")):
        hit = imported_names(path) & (FORBIDDEN | {PROGRAM})
        if hit:
            bad[path.name] = sorted(hit)
    return bad
