"""Wavefront OBJ loader.

Parity with the reference loader (src/load_obj.cpp): v/vn/vt/f records,
polygon fan-triangulation, negative (relative) indices; materials are
ignored. Two paths:

- a numpy Python parser (always available), and
- a C++ fast path (hagrid/native/objloader.cpp via ctypes) used
  automatically when the shared library has been built — San-Miguel-scale
  OBJ files are hundreds of MB and the Python parser is the bottleneck.
"""

from __future__ import annotations

import numpy as np

from ..native import objloader_native


def load_obj(path: str):
    """Parse an OBJ file -> (vertices f32[V,3], faces i32[T,3]).

    Faces with >3 vertices are fan-triangulated. Negative indices are
    resolved relative to the current vertex count, per the OBJ spec.
    """
    native = objloader_native.try_load(path)
    if native is not None:
        return native

    verts: list = []
    faces: list = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    # f v, f v/vt, f v//vn, f v/vt/vn — vertex id is field 0.
                    s = tok.split("/")[0]
                    if not s:
                        continue
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append((idx[0], idx[k], idx[k + 1]))
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def save_obj(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Minimal OBJ writer (debugging / golden-scene fixtures)."""
    with open(path, "w") as fh:
        for v in np.asarray(vertices):
            fh.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for f in np.asarray(faces):
            fh.write(f"f {f[0] + 1} {f[1] + 1} {f[2] + 1}\n")
