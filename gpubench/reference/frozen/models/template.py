"""Category template: mesh topology + all derived static arrays + param init.

Built once on the host at model-construction time (the reference does this
in MeshNet.__init__: monocular/nnutils/mesh_net.py:294-457). Everything
data-dependent-but-static lives here so the train step stays purely
functional over (params, template).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..geometry import geodesic, icosphere, mesh_ops, symmetry


@dataclasses.dataclass(frozen=True)
class Template:
    """Static per-category template data (host numpy; moved to device once)."""

    verts: np.ndarray            # (V, 3) full initial vertex set
    faces: np.ndarray            # (F, 3) int32
    num_learnable: int           # verts actually parameterized (V or half)
    num_sym: int                 # 0 if not symmetric
    num_sym_faces: int           # -1 if texture not symmetric
    num_tex_faces: int           # faces the texture net predicts (F' <= F)
    uniform_L: np.ndarray        # (V, V) uniform Laplacian
    edges: np.ndarray            # (E, 2)
    edges2verts: np.ndarray      # (E', 4)
    uv_sampler: np.ndarray       # (F', T, T, 2)
    lbs_logits: np.ndarray       # (V, K) init
    handle_idx: np.ndarray       # (K,)
    vert2kp_logits: Optional[np.ndarray]  # (num_kps, V) init or None

    @property
    def num_verts(self) -> int:
        return self.verts.shape[0]

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_lbs(self) -> int:
        return self.lbs_logits.shape[1]

    @property
    def symmetric(self) -> bool:
        return self.num_sym > 0

    @property
    def mean_v_init(self) -> np.ndarray:
        """Initial value of the learnable mean shape (half mesh if symmetric)."""
        return self.verts[: self.num_learnable].astype(np.float32)


def build_template(
    verts: np.ndarray | None = None,
    faces: np.ndarray | None = None,
    *,
    subdivide: int = 3,
    num_lbs: int = 16,
    tex_size: int = 6,
    symmetric: bool = False,
    symmetric_texture: bool = False,
    num_kps: int = 0,
    kp_vertex_ids: Optional[list] = None,
    sfm_kp_points: Optional[np.ndarray] = None,
    scale_mesh: bool = False,
) -> Template:
    """Build a category template from a mesh (or an icosphere by default).

    Mirrors the reference init paths: template OBJ (multiframe horse/tiger,
    monocular bird: mesh_net.py:305-345) or symmetric icosphere; vert2kp
    init from a kp dictionary (kp_vertex_ids) or SfM kp locations
    (sfm_kp_points); geodesic-FPS LBS handles.
    """
    if verts is None:
        verts, faces = icosphere.icosphere(subdivide)
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)

    if scale_mesh:
        # 2 / max pairwise distance, centered (multiframe/main.py:161-164).
        from scipy.spatial.distance import pdist

        verts = verts * (2.0 / pdist(verts).max())
        verts = verts - verts.mean(0)

    num_sym = 0
    num_learnable = verts.shape[0]
    num_sym_faces = -1
    if symmetric:
        sym = symmetry.make_symmetric(verts, faces)
        verts, faces = sym.verts, sym.faces
        num_sym = sym.num_sym
        num_learnable = sym.num_learnable
        if symmetric_texture:
            num_sym_faces = sym.num_sym_faces
            num_tex_faces = sym.num_indept_faces + sym.num_sym_faces
        else:
            num_tex_faces = faces.shape[0]
    else:
        num_tex_faces = faces.shape[0]
    if not symmetric_texture:
        num_sym_faces = -1
        num_tex_faces = faces.shape[0]

    V = verts.shape[0]
    uniform_L = mesh_ops.uniform_laplacian(faces, V)
    edges = mesh_ops.compute_edges(faces)
    e2v = mesh_ops.compute_edges2verts(faces)
    uv_sampler = mesh_ops.compute_uvsampler(verts, faces[:num_tex_faces], tex_size)
    lbs_logits, handle_idx = geodesic.init_lbs_logits(verts, faces, num_lbs)

    vert2kp = None
    if kp_vertex_ids is not None:
        vert2kp = geodesic.init_vert2kp_logits_from_dict(verts, kp_vertex_ids)
    elif sfm_kp_points is not None and num_kps:
        vert2kp = geodesic.init_vert2kp_logits_from_points(verts, sfm_kp_points)
    elif num_kps:
        # fall back: nearest-surface anchors from FPS picks
        anchors = verts[handle_idx[:num_kps] if len(handle_idx) >= num_kps else handle_idx]
        vert2kp = geodesic.init_vert2kp_logits_from_points(verts, anchors[:num_kps])

    return Template(
        verts=verts.astype(np.float32),
        faces=faces.astype(np.int32),
        num_learnable=num_learnable,
        num_sym=num_sym,
        num_sym_faces=num_sym_faces,
        num_tex_faces=num_tex_faces,
        uniform_L=uniform_L.astype(np.float32),
        edges=edges.astype(np.int32),
        edges2verts=e2v.astype(np.int32),
        uv_sampler=uv_sampler.astype(np.float32),
        lbs_logits=lbs_logits,
        handle_idx=handle_idx,
        vert2kp_logits=vert2kp,
    )
