"""Wavefront OBJ loader (port of mitsuba_tpu/io/obj.py; ref:
src/shapes/obj.cpp + MTL handling).

Supports v/vn/vt/f (triangles + convex-polygon fan triangulation), usemtl
grouping, and a minimal .mtl parser mapping Kd/Ks/Ns/d to Material configs.
Indices may be negative (relative) per the OBJ spec. Produces one Mesh per
material group so the scene builder can attach different BSDFs. The JAX
module parses through a native C++ helper where one builds; the port has
its pure-Python parse, which gives the same meshes.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..scene.shapes import Mesh


@dataclass
class ObjGroup:
    mesh: Mesh
    material_name: str | None = None


def load_obj(path: str, split_groups: bool = True):
    """Returns (groups: list[ObjGroup], materials: dict[str, dict]).

    materials maps mtl names to {'kd': rgb, 'ks': rgb, 'ns': float,
    'map_kd': path or None} — the caller translates to Material configs.
    """
    positions, normals, uvs = [], [], []
    # per-group face lists: (pos_idx, uv_idx, n_idx) triples
    groups: dict[str, list] = {}
    current = "default"
    mtl_files = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                uvs.append([float(x) for x in parts[1:3]])
            elif tag == "f":
                verts = []
                for vp in parts[1:]:
                    comps = vp.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    ni = int(comps[2]) if len(comps) > 2 and comps[2] else 0
                    verts.append((vi, ti, ni))
                key = current if split_groups else "default"
                lst = groups.setdefault(key, [])
                for k in range(1, len(verts) - 1):   # fan triangulation
                    lst.append((verts[0], verts[k], verts[k + 1]))
            elif tag == "usemtl" and len(parts) > 1:
                current = parts[1]
            elif tag == "mtllib" and len(parts) > 1:
                mtl_files.append(parts[1])

    positions = np.asarray(positions, np.float64)
    normals = np.asarray(normals, np.float64) if normals else None
    uvs = np.asarray(uvs, np.float64) if uvs else None

    def resolve(idx, n):
        return idx - 1 if idx > 0 else n + idx

    out = []
    for name, faces in groups.items():
        # re-index: unique (v, t, n) combos per group
        combo_map: dict[tuple, int] = {}
        v_out, n_out, t_out, f_out = [], [], [], []
        for tri in faces:
            ids = []
            for (vi, ti, ni) in tri:
                key = (vi, ti, ni)
                if key not in combo_map:
                    combo_map[key] = len(v_out)
                    v_out.append(positions[resolve(vi, len(positions))])
                    if normals is not None and ni:
                        n_out.append(normals[resolve(ni, len(normals))])
                    if uvs is not None and ti:
                        t_out.append(uvs[resolve(ti, len(uvs))])
                ids.append(combo_map[key])
            f_out.append(ids)
        mesh = Mesh(
            vertices=np.asarray(v_out),
            faces=np.asarray(f_out, np.int64),
            normals=(np.asarray(n_out)
                     if n_out and len(n_out) == len(v_out) else None),
            uvs=(np.asarray(t_out)
                 if t_out and len(t_out) == len(v_out) else None))
        out.append(ObjGroup(mesh, None if name == "default" else name))

    materials = {}
    base = os.path.dirname(path)
    for mf in mtl_files:
        mp = os.path.join(base, mf)
        if os.path.exists(mp):
            materials.update(_load_mtl(mp))
    return out, materials


def _load_mtl(path: str):
    mats, cur = {}, None
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            tag = parts[0].lower()
            if tag == "newmtl":
                cur = parts[1]
                mats[cur] = {"kd": (0.5, 0.5, 0.5), "ks": (0.0, 0.0, 0.0),
                             "ns": 1.0, "map_kd": None, "d": 1.0}
            elif cur is None:
                continue
            elif tag == "kd":
                mats[cur]["kd"] = tuple(float(x) for x in parts[1:4])
            elif tag == "ks":
                mats[cur]["ks"] = tuple(float(x) for x in parts[1:4])
            elif tag == "ns":
                mats[cur]["ns"] = float(parts[1])
            elif tag == "d":
                mats[cur]["d"] = float(parts[1])
            elif tag == "map_kd":
                mats[cur]["map_kd"] = parts[-1]
    return mats
