"""PLY mesh loader (port of mitsuba_tpu/io/ply.py): ascii + binary
little/big-endian (ref: src/shapes/ply).

Supports vertex properties x/y/z, nx/ny/nz, u/v (or s/t), red/green/blue,
and face vertex_indices lists (triangulated by fan).
"""
from __future__ import annotations

import struct

import numpy as np

from ..scene.shapes import Mesh

_TYPES = {
    "char": ("b", 1), "int8": ("b", 1),
    "uchar": ("B", 1), "uint8": ("B", 1),
    "short": ("h", 2), "int16": ("h", 2),
    "ushort": ("H", 2), "uint16": ("H", 2),
    "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4),
    "float": ("f", 4), "float32": ("f", 4),
    "double": ("d", 8), "float64": ("d", 8),
}


def load_ply(path: str) -> Mesh:
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", "not a PLY file"
        fmt = None
        elements = []  # (name, count, [(prop_name, type) or ('list', ct, t, name)])
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1]
            elif parts[0] == "element":
                elements.append((parts[1], int(parts[2]), []))
            elif parts[0] == "property":
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3],
                                            parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif parts[0] == "end_header":
                break
        data = f.read()

    endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
    verts = norms = uvs = colors = None
    faces = []
    pos = 0

    for (name, count, props) in elements:
        if fmt == "ascii":
            rows = []
            text = data.decode("ascii", "replace").split("\n")
            for i in range(count):
                rows.append(text[i].split())
            text_rest = "\n".join(text[count:])
            data = text_rest.encode()
            if name == "vertex":
                cols = {p[0]: j for j, p in enumerate(props)}
                arr = np.array([[float(x) for x in r] for r in rows])
                verts, norms, uvs, colors = _extract_vertex(
                    arr, cols, props)
            elif name == "face":
                for r in rows:
                    k = int(r[0])
                    idx = [int(x) for x in r[1:1 + k]]
                    for j in range(1, k - 1):
                        faces.append([idx[0], idx[j], idx[j + 1]])
        else:
            if name == "vertex" and all(p[0] != "list" for p in props):
                # vectorized read through a structured dtype — the
                # per-vertex struct.unpack loop was the host-side hot
                # path for scanned meshes (ref keeps this native:
                # src/shapes/ply/ vendored C parser)
                dt = np.dtype([(f"c{j}", endian + _TYPES[p[1]][0])
                               for j, p in enumerate(props)])
                rec = np.frombuffer(data, dtype=dt, count=count,
                                    offset=pos)
                arr = np.column_stack(
                    [rec[f].astype(np.float64) for f in rec.dtype.names])
                pos += count * dt.itemsize
                cols = {p[0]: j for j, p in enumerate(props)}
                verts, norms, uvs, colors = _extract_vertex(
                    arr, cols, props)
            elif (name == "face" and len(props) == 1
                  and props[0][0] == "list"):
                tris, used = _parse_face_lists(
                    data[pos:], count, _TYPES[props[0][1]][1],
                    _TYPES[props[0][2]], endian == ">")
                faces.extend(tris)
                pos += used
            elif name == "face":
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            cf, cs = _TYPES[p[1]]
                            vf, vs = _TYPES[p[2]]
                            (k,) = struct.unpack_from(endian + cf, data, pos)
                            pos += cs
                            idx = struct.unpack_from(endian + vf * k, data,
                                                     pos)
                            pos += vs * k
                            for j in range(1, k - 1):
                                faces.append([idx[0], idx[j], idx[j + 1]])
                        else:
                            pos += _TYPES[p[1]][1]
            else:
                # skip unknown fixed-size element
                row = sum(_TYPES[p[1]][1] for p in props if p[0] != "list")
                pos += count * row

    return Mesh(vertices=np.asarray(verts),
                faces=np.asarray(faces, np.int64),
                normals=norms, uvs=uvs, colors=colors)


def _parse_face_lists(data, count, count_size, idx_spec, big):
    """Triangulate `count` binary index lists → (faces [F,3] array-like,
    bytes consumed). Two tiers: uniform-count vectorized numpy (the
    all-triangles / all-quads common case), then a pure-Python loop (the
    JAX module tries its native C++ parser between the two; both give the
    same faces)."""
    vf, vs = idx_spec
    e = ">" if big else "<"
    # tier 1: probe the first face count; if every face shares it, the
    # whole element is one fixed-stride record array
    if count > 0 and len(data) >= count_size:
        (k0,) = struct.unpack_from(
            e + _TYPES_BY_SIZE_UINT[count_size], data, 0)
        stride = count_size + k0 * vs
        if 3 <= k0 <= 255 and len(data) >= count * stride:
            cdt = np.dtype([("n", e + _TYPES_BY_SIZE_UINT[count_size]),
                            ("idx", e + vf, (k0,))])
            rec = np.frombuffer(data, dtype=cdt, count=count)
            if (rec["n"] == k0).all():
                idx = rec["idx"].astype(np.int64)
                tris = np.concatenate(
                    [np.stack([idx[:, 0], idx[:, j], idx[:, j + 1]], -1)
                     for j in range(1, k0 - 1)])
                return tris, count * stride
    # tier 2: python loop
    faces = []
    pos = 0
    cf = _TYPES_BY_SIZE_UINT[count_size]
    for _ in range(count):
        (k,) = struct.unpack_from(e + cf, data, pos)
        pos += count_size
        idx = struct.unpack_from(e + vf * k, data, pos)
        pos += vs * k
        for j in range(1, k - 1):
            faces.append([idx[0], idx[j], idx[j + 1]])
    return faces, pos


_TYPES_BY_SIZE_UINT = {1: "B", 2: "H", 4: "I"}


def _extract_vertex(arr, cols, props):
    verts = arr[:, [cols["x"], cols["y"], cols["z"]]]
    norms = None
    uvs = None
    colors = None
    if all(k in cols for k in ("nx", "ny", "nz")):
        norms = arr[:, [cols["nx"], cols["ny"], cols["nz"]]]
    for (a, b) in (("u", "v"), ("s", "t")):
        if a in cols and b in cols:
            uvs = arr[:, [cols[a], cols[b]]]
            break
    if all(k in cols for k in ("red", "green", "blue")):
        colors = arr[:, [cols["red"], cols["green"], cols["blue"]]]
        # integer color channels are 0..255 (ply.cpp normalizes uchar)
        ptypes = {p[0]: p[1] for p in props if p[0] != "list"}
        if ptypes.get("red", "float") not in ("float", "float32",
                                              "double", "float64"):
            colors = colors / 255.0
    return verts, norms, uvs, colors
