"""Symmetric mesh reordering (host-side, numpy; `symmetrize` is torch).

Re-implementation (vectorized, not translated) of the reference's
monocular/utils/mesh.py:20-158 (make_symmetric / make_faces_symmetric):
given a mesh exactly mirror-symmetric about x=0, reorder vertices as
[center (x==0), right (x>0), left (x<0)] with left[i] the mirror of
right[i], and faces as [independent, right, left] with left face i being
the mirror of right face i in identical vertex order.

A symmetric model then learns only the first (num_indept + num_sym)
vertices; `symmetrize` reconstructs the full vertex set.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class SymmetricMesh:
    verts: np.ndarray        # (V, 3) reordered full vertex set
    faces: np.ndarray        # (F, 3) reordered faces
    num_indept: int          # #center verts (x == 0)
    num_sym: int             # #right verts (== #left)
    num_indept_faces: int
    num_sym_faces: int

    @property
    def num_learnable(self) -> int:
        return self.num_indept + self.num_sym


def _mirror_index(verts: np.ndarray) -> np.ndarray:
    """For each vertex, index of its exact mirror (-x, y, z) partner."""
    mirrored = verts * np.array([-1.0, 1.0, 1.0])
    # Lexicographic matching of exact float coordinates.
    order_a = np.lexsort(verts.T)
    order_b = np.lexsort(mirrored.T)
    if not np.array_equal(verts[order_a], mirrored[order_b]):
        raise ValueError("mesh is not exactly mirror-symmetric about x=0")
    mirror = np.empty(len(verts), dtype=np.int64)
    mirror[order_b] = order_a
    return mirror


def make_symmetric(verts: np.ndarray, faces: np.ndarray) -> SymmetricMesh:
    """Reorder an exactly-symmetric mesh into [center, right, left] layout."""
    x = verts[:, 0]
    center_inds = np.where(x == 0)[0]
    right_inds = np.where(x > 0)[0]
    mirror = _mirror_index(verts)
    left_of_right = mirror[right_inds]

    num_indept = len(center_inds)
    num_sym = len(right_inds)
    new_order = np.concatenate([center_inds, right_inds, left_of_right])
    # old index -> new index
    perm = np.empty(len(verts), dtype=np.int64)
    perm[new_order] = np.arange(len(verts))

    new_verts = verts[new_order]
    new_faces = perm[faces]

    # Classify faces. In the new index space, the mirror of vertex v is:
    #   v < num_indept: v itself
    #   num_indept <= v < num_indept+num_sym (right): v + num_sym
    #   else (left): v - num_sym
    def vmirror(v: np.ndarray) -> np.ndarray:
        out = v.copy()
        right = (v >= num_indept) & (v < num_indept + num_sym)
        left = v >= num_indept + num_sym
        out[right] += num_sym
        out[left] -= num_sym
        return out

    face_mirror_verts = vmirror(new_faces)  # per-face mirrored vertex triple
    sorted_faces = np.sort(new_faces, axis=1)
    sorted_mirror = np.sort(face_mirror_verts, axis=1)

    indept_mask = np.all(sorted_faces == sorted_mirror, axis=1)

    # Map sorted vertex triple -> face id for pairing mirrored faces.
    triple_to_fid = {tuple(t): i for i, t in enumerate(sorted_faces)}

    indept_faces, right_faces, left_faces = [], [], []
    done = np.zeros(len(new_faces), dtype=bool)
    for fid in range(len(new_faces)):
        if done[fid]:
            continue
        if indept_mask[fid]:
            indept_faces.append(new_faces[fid])
            done[fid] = True
            continue
        sym_fid = triple_to_fid[tuple(sorted_mirror[fid])]
        face_here = new_faces[fid]
        sym_face_here = face_mirror_verts[fid]  # same winding order as face_here
        # Decide left/right using the x coordinate of the non-shared verts.
        unique = new_faces[fid] != face_mirror_verts[fid]
        if np.all(new_verts[face_here][unique, 0] < new_verts[sym_face_here][unique, 0]):
            left_faces.append(face_here)
            right_faces.append(sym_face_here)
        else:
            left_faces.append(sym_face_here)
            right_faces.append(face_here)
        done[fid] = True
        done[sym_fid] = True

    num_indept_faces = len(indept_faces)
    num_sym_faces = len(right_faces)
    all_faces = np.vstack(
        [np.asarray(g).reshape(-1, 3) for g in (indept_faces, right_faces, left_faces) if len(g)]
    )
    return SymmetricMesh(
        verts=new_verts,
        faces=all_faces.astype(np.int64),
        num_indept=num_indept,
        num_sym=num_sym,
        num_indept_faces=num_indept_faces,
        num_sym_faces=num_sym_faces,
    )


def symmetrize(v_half, num_sym: int):
    """Expand learnable [center+right] verts to the full vertex set.

    v_half: (..., num_indept + num_sym, 3) -> (..., num_indept + 2*num_sym, 3)
    by appending x-mirrored copies of the last num_sym (right) verts.
    Matches reference multiframe/nnutils/mesh_net.py:573-591.
    """
    right = v_half[..., -num_sym:, :]
    # x negated by indexing, not by a (-1, 1, 1) factor uploaded per call
    v_left = torch.cat([-right[..., :1], right[..., 1:]], dim=-1)
    return torch.cat([v_half, v_left], dim=-2)
