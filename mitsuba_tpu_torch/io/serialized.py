"""Mitsuba `.serialized` mesh format: reader + writer (port of
mitsuba_tpu/io/serialized.py).

Format per the reference (ref: src/librender/trimesh.cpp serialization +
src/shapes/serialized.cpp): per-mesh header 0x041C + version, followed by a
zlib deflate stream of [flags u32, (v4: name cstring), vertex count u64,
triangle count u64, positions, normals?, texcoords?, colors?, indices];
a u64 offset table + u32 mesh count trail the file.

Flags: 0x0001 normals, 0x0002 texcoords, 0x0008 colors, 0x1000 f32,
0x2000 f64.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from ..scene.shapes import Mesh

MTS_FILEFORMAT_HEADER = 0x041C
VERSION_V3 = 0x0003
VERSION_V4 = 0x0004

F_HAS_NORMALS = 0x0001
F_HAS_TEXCOORDS = 0x0002
F_HAS_COLORS = 0x0008
F_SINGLE = 0x1000
F_DOUBLE = 0x2000


def load_serialized(path: str, shape_index: int = 0) -> Mesh:
    with open(path, "rb") as f:
        data = f.read()
    (count,) = struct.unpack_from("<I", data, len(data) - 4)
    if count > 1:
        table_pos = len(data) - 4 - 8 * count
        offsets = struct.unpack_from(f"<{count}Q", data, table_pos)
        start = offsets[shape_index]
    else:
        start = 0
    header, version = struct.unpack_from("<HH", data, start)
    assert header == MTS_FILEFORMAT_HEADER, "not a .serialized mesh"
    stream = zlib.decompress(data[start + 4:])

    pos = 0
    (flags,) = struct.unpack_from("<I", stream, pos)
    pos += 4
    if version >= VERSION_V4:
        end = stream.index(b"\x00", pos)
        pos = end + 1
    n_verts, n_tris = struct.unpack_from("<QQ", stream, pos)
    pos += 16
    dt = np.float64 if flags & F_DOUBLE else np.float32
    isize = np.dtype(dt).itemsize

    def take(n_items, width, dtype):
        nonlocal pos
        arr = np.frombuffer(stream, dtype, n_items * width, pos)
        pos += n_items * width * np.dtype(dtype).itemsize
        return arr.reshape(n_items, width).astype(np.float64)

    verts = take(n_verts, 3, dt)
    norms = take(n_verts, 3, dt) if flags & F_HAS_NORMALS else None
    uvs = take(n_verts, 2, dt) if flags & F_HAS_TEXCOORDS else None
    if flags & F_HAS_COLORS:
        take(n_verts, 3, dt)
    faces = np.frombuffer(stream, np.uint32, n_tris * 3, pos).reshape(
        n_tris, 3).astype(np.int64)
    return Mesh(vertices=verts, faces=faces, normals=norms, uvs=uvs)


def save_serialized(path: str, mesh: Mesh):
    flags = F_SINGLE
    if mesh.normals is not None:
        flags |= F_HAS_NORMALS
    if mesh.uvs is not None:
        flags |= F_HAS_TEXCOORDS
    body = struct.pack("<I", flags)
    body += b"mesh\x00"
    body += struct.pack("<QQ", len(mesh.vertices), len(mesh.faces))
    body += np.asarray(mesh.vertices, np.float32).tobytes()
    if mesh.normals is not None:
        body += np.asarray(mesh.normals, np.float32).tobytes()
    if mesh.uvs is not None:
        body += np.asarray(mesh.uvs, np.float32).tobytes()
    body += np.asarray(mesh.faces, np.uint32).tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<HH", MTS_FILEFORMAT_HEADER, VERSION_V4))
        f.write(zlib.compress(body))
        f.write(struct.pack("<Q", 0))
        f.write(struct.pack("<I", 1))
