"""Samplers and Darcy solver on unstructured simplicial meshes.

Port of parelagmc_tpu/unstructured.py: the SPDE Matern sampler and the
mixed Darcy forward model on triangles/tets and on agglomerated levels, on
top of fem/simplicial.py's operator bundles (host numpy, the port's copy)
and batched device work in plain PyTorch (ELL gathers, PCG, MINRES). The
hierarchies come from nested uniform refinement
(fem/simplicial_hierarchy.py) or from agglomeration of a given fine mesh
(fem/agglomeration.py); both plug in through the same duck type, and a
single SimplicialLevel is a one-level hierarchy.

The sampler's noise draw is K2 (ops/prng.sample_normals) on a CUDA device;
everything else here is gathers, elementwise work and Krylov loops, which
the reference leaves to XLA and this port to PyTorch. Every tensor lives on
the `device` given to the constructor (None: cuda:0).

The matching-mesh embedded sampler selects the original cells of a field
solved on an enlarged mesh; the projection sampler maps it through a
mortar coupling that the native geometry kernels (native/, g++) assemble
on the host at setup. The Darcy solver's "hybrid-cg" condenses each level
onto its face multipliers (physics/hybrid.py) and runs PCG there.
"""

from __future__ import annotations

import math
from typing import List, Optional, Union

import numpy as np
import scipy.sparse as sp
import torch

from parelagmc_tpu_torch.config import ProblemConfig
from parelagmc_tpu_torch.device import resolve_device
from parelagmc_tpu_torch.fem.agglomeration import (
    _cell_adjacency,
    _level_cell_centers,
    agglomerate_level,
    partition_cells,
)
from parelagmc_tpu_torch.fem.simplicial import SimplicialLevel, build_simplicial_level
from parelagmc_tpu_torch.fem.simplicial_hierarchy import (
    SimplicialHierarchy,
    build_simplicial_hierarchy,
)
from parelagmc_tpu_torch.mesh.mfem_io import GeneralMesh
from parelagmc_tpu_torch.mesh.structured import _mfem_bdr_attr
from parelagmc_tpu_torch.native import mortar_p0_couple
from parelagmc_tpu_torch.ops import coef_multigrid as cmg
from parelagmc_tpu_torch.ops import multigrid as mgops
from parelagmc_tpu_torch.ops.ell import (
    coef_diag_structure,
    coef_ell_apply,
    ell_apply,
    pack_coef_ell,
    pack_csr_to_ell,
)
from parelagmc_tpu_torch.ops.prng import Key, sample_normals
from parelagmc_tpu_torch.ops.solvers import minres, pcg
from parelagmc_tpu_torch.physics.hybrid import (
    build_hybrid_level,
    build_hybrid_level_algebraic,
    hybrid_solve,
)
from parelagmc_tpu_torch.samplers.base import MLSampler
from parelagmc_tpu_torch.transfer_integrators import mortar_p1_p0_couple, mortar_rt0_couple
from parelagmc_tpu_torch.utils.special import matern_spde_scaling


def label_box_boundaries_gm(gm: GeneralMesh, tol: float = 1e-8) -> bool:
    """Relabel a GeneralMesh's boundary attributes with the MFEM box-side
    convention (by face-centroid position on the bounding box; 3D: z=0 -> 1,
    y=0 -> 2, x=max -> 3, y=max -> 4, x=0 -> 5, z=max -> 6; 2D: 1..4), so
    box-domain tet/tri meshes take the same BC/QoI configs as the
    structured path. Apply to the base mesh BEFORE building a hierarchy;
    refinement preserves attributes. A curved domain (some boundary face
    off the bounding box) is left untouched (returns False)."""
    d = gm.dim
    lo = gm.vertices.min(axis=0)
    hi = gm.vertices.max(axis=0)
    new_attr = np.array(gm.boundary_attributes, copy=True)
    for k, bf in enumerate(gm.boundary):
        c = gm.vertices[bf].mean(axis=0)
        on_box = False
        for a in range(d):
            if abs(c[a] - lo[a]) < tol:
                new_attr[k] = _mfem_bdr_attr(d, a, 0)
                on_box = True
            elif abs(c[a] - hi[a]) < tol:
                new_attr[k] = _mfem_bdr_attr(d, a, 1)
                on_box = True
        if not on_box:
            return False  # curved domain: keep native attributes
    gm.boundary_attributes[:] = new_attr
    return True


def label_box_boundaries(level: SimplicialLevel, tol: float = 1e-8) -> None:
    """Level-local variant of label_box_boundaries_gm (rewrites the level's
    bdr_attr array in place)."""
    gm = level.mesh
    d = gm.dim
    lo = gm.vertices.min(axis=0)
    hi = gm.vertices.max(axis=0)
    on_bdr = np.nonzero(level.bdr_attr > 0)[0]
    conn = np.stack(gm.elements)
    nloc = conn.shape[1]
    local_faces = [[j for j in range(nloc) if j != i] for i in range(nloc)]
    face_verts = np.zeros((level.n_u, d), dtype=np.int64)
    for i, lf in enumerate(local_faces):
        face_verts[level.cell_faces[:, i]] = conn[:, lf]
    for f in on_bdr:
        c = gm.vertices[face_verts[f]].mean(axis=0)
        for a in range(d):
            if abs(c[a] - lo[a]) < tol:
                level.bdr_attr[f] = _mfem_bdr_attr(d, a, 0)
            elif abs(c[a] - hi[a]) < tol:
                level.bdr_attr[f] = _mfem_bdr_attr(d, a, 1)


def _as_hierarchy(h) -> SimplicialHierarchy:
    if isinstance(h, SimplicialHierarchy):
        return h
    return SimplicialHierarchy(levels=[h], parent=[], P_rt=[])


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx] for an index table of any shape."""
    return torch.index_select(x, -1, idx.reshape(-1)).reshape(x.shape[:-1] + idx.shape)


def _bt_gather(face_cells: torch.Tensor, face_signs: torch.Tensor, p: torch.Tensor):
    """B^T p on faces: sum over a face's two cells of sign * p[cell]."""
    return torch.sum(_take(p, face_cells) * face_signs, dim=-1)


def _b_gather(cell_faces: torch.Tensor, cell_signs: torch.Tensor, u: torch.Tensor):
    """B u on cells: sum over a cell's faces of sign * u[face]."""
    return torch.sum(_take(u, cell_faces) * cell_signs, dim=-1)


def _eliminate(A: sp.spmatrix, ess: np.ndarray) -> sp.csr_matrix:
    """A with the rows and columns of `ess` zeroed and a unit diagonal on
    them, no explicit zeros stored: the matrix of the reference's LIL
    assignments A[idx, :] = 0, A[:, idx] = 0, A[idx, idx] = 1, which cost
    len(idx) x n there (minutes at 10^5 faces)."""
    keep = sp.diags((~ess).astype(np.float64))
    out = (keep @ A @ keep).tocsr()
    out.eliminate_zeros()
    out = (out + sp.diags(ess.astype(np.float64))).tocsr()
    out.sort_indices()
    return out


def _galerkin_mg(fine: sp.csr_matrix, prolongators, dtype, cycles_cfg, device):
    """Multigrid on Galerkin RAP coarse operators of `fine` (eliminated
    coarse dofs re-pinned), damped by 1/lambda_max per level."""
    mats = [fine]
    for P in prolongators:
        Ac = (P.T @ mats[-1] @ P).tocsr()
        dz = np.asarray(Ac.diagonal()) == 0.0
        if dz.any():
            Ac = Ac + sp.diags(dz.astype(np.float64))
        mats.append(Ac)
    return mgops.build_mg_hierarchy(mats, prolongators, dtype, omega="spectral",
                                    coarse_sweeps=cycles_cfg.mg_coarse_sweeps, device=device)


class UnstructuredSPDESampler(MLSampler):
    """SPDE Matern sampler on simplicial meshes: the reduced SPD system
    A_u = M + (1/alpha) B^T W^-1 B (u.n = 0 everywhere, essential rows
    eliminated to the identity) solved with batched Jacobi-PCG, or under
    sampler_solver.name == "cg-mg" with a V-cycle over the hierarchy's own
    RT prolongators on Galerkin coarse operators. MLMC coupling: the
    white-noise load is restricted to coarser levels through P_l2^T."""

    def __init__(self, hierarchy: Union[SimplicialHierarchy, SimplicialLevel],
                 config: ProblemConfig, dtype: torch.dtype = torch.float32, device=None):
        self.hierarchy = _as_hierarchy(hierarchy)
        self.config = config
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        d = self.hierarchy.levels[0].dim
        self.corlen = float(config.correlation_length)
        self.alpha = 1.0 / self.corlen ** 2
        self.g = matern_spde_scaling(self.corlen, d)
        self.sigma = math.sqrt(float(config.variance))
        self.lognormal = bool(config.lognormal)
        self.solver_cfg = config.sampler_solver
        vec = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)

        self._lv = []
        A_csr: List[sp.csr_matrix] = []
        ess_list: List[np.ndarray] = []
        for lvl in self.hierarchy.levels:
            ess = lvl.bdr_attr > 0
            M = lvl.mass_csr()
            B = lvl.b_csr()
            Winv = sp.diags(1.0 / lvl.W)
            A = _eliminate(M + (1.0 / self.alpha) * (B.T @ Winv @ B), ess)
            A_csr.append(A)
            ess_list.append(ess)
            fs = lvl.face_signs.copy()
            fs[ess, :] = 0.0
            self._lv.append(dict(
                A=pack_csr_to_ell(A, dtype, device=dev),
                dinv=vec(1.0 / np.maximum(A.diagonal(), 1e-300)),
                w_sqrt=vec(lvl.w_sqrt),
                winv=vec(1.0 / lvl.W),
                cell_faces=vec(lvl.cell_faces, torch.int64),
                cell_signs=vec(np.where(ess[lvl.cell_faces], 0.0, lvl.cell_signs)),
                face_cells=vec(lvl.face_cells, torch.int64),
                face_signs=vec(fs),
            ))
        # Geometric MG over the hierarchy's exact RT prolongators, essential
        # rows/cols masked out of the transfers; Galerkin coarse operators,
        # since the assembled coarse systems are not variationally
        # consistent with these transfers on agglomerated hierarchies.
        self._mg = [None] * self.hierarchy.nlevels
        if self.solver_cfg.name == "cg-mg" and self.hierarchy.nlevels > 1:
            P_masked = []
            for l, P in enumerate(self.hierarchy.P_rt):
                Zf = sp.diags((~ess_list[l]).astype(np.float64))
                Zc = sp.diags((~ess_list[l + 1]).astype(np.float64))
                P_masked.append((Zf @ P @ Zc).tocsr())
            for l in range(self.hierarchy.nlevels - 1):
                self._mg[l] = _galerkin_mg(A_csr[l], P_masked[l:], dtype, self.solver_cfg, dev)
        # P_l2^T restrictions (coarse rows <- fine entries) and the RT
        # prolongations (fine faces <- coarse faces) of the warm-started
        # coupled pair.
        self._restrict = [
            pack_csr_to_ell(self.hierarchy.p_l2(l).T.tocsr(), dtype, device=dev)
            for l in range(self.hierarchy.nlevels - 1)
        ]
        self._prolong_rt = [pack_csr_to_ell(P.tocsr(), dtype, device=dev)
                            for P in self.hierarchy.P_rt]

    # -- MLSampler API -----------------------------------------------------------
    def sample_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def field_size(self, level: int) -> int:
        return self.hierarchy.levels[level].n_s

    def sample(self, level: int, key: Key, nsamples: int) -> torch.Tensor:
        return self.sigma * sample_normals(key, (nsamples, self.sample_size(level)),
                                           self.dtype, self.device)

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        s = self._eval_gaussian(level, xi, xi_level)
        return torch.exp(s) if self.lognormal else s

    def _noise_load(self, level: int, xi: torch.Tensor, xi_level: int):
        """White-noise load b = g W^{1/2} xi at xi_level, restricted to level."""
        b = self.g * self._lv[xi_level]["w_sqrt"] * xi
        for l in range(xi_level, level):
            b = ell_apply(self._restrict[l], b)
        return b

    def _solve_u(self, level: int, b: torch.Tensor, x0=None):
        L = self._lv[level]
        rhs_u = -(1.0 / self.alpha) * _bt_gather(L["face_cells"], L["face_signs"],
                                                 L["winv"] * b)
        mg = self._mg[level]
        if mg is not None:
            prec = lambda r: mgops.v_cycle(mg, r)
        else:
            prec = lambda r: r * L["dinv"]
        cfg = self.solver_cfg
        u, _ = pcg(lambda v: ell_apply(L["A"], v), rhs_u, prec=prec, x0=x0,
                   max_iters=cfg.max_iterations, rtol=cfg.relative_tolerance,
                   atol=cfg.absolute_tolerance, restart_every=cfg.restart_every)
        return u

    def _field_from(self, level: int, u: torch.Tensor, b: torch.Tensor):
        L = self._lv[level]
        Bu = _b_gather(L["cell_faces"], L["cell_signs"], u)
        return (1.0 / self.alpha) * (L["winv"] * (Bu + b))

    def _eval_gaussian(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        if xi_level is None:
            xi_level = level
        assert xi_level <= level
        b = self._noise_load(level, xi, xi_level)
        return self._field_from(level, self._solve_u(level, b), b)

    def _eval_gaussian_pair(self, level: int, xi: torch.Tensor):
        """Coupled (fine, coarse) Gaussian fields with shared noise: the
        coarse system is solved first and its velocity, prolongated with
        the essential rows zeroed, starts the fine PCG."""
        b_f = self._noise_load(level, xi, level)
        b_c = ell_apply(self._restrict[level], b_f)
        u_c = self._solve_u(level + 1, b_c)
        u0 = ell_apply(self._prolong_rt[level], u_c)
        ess = self._lv[level]["face_signs"][:, 0] == 0.0  # eliminated rows
        u0 = torch.where(ess, torch.zeros_like(u0), u0)
        u_f = self._solve_u(level, b_f, x0=u0)
        return self._field_from(level, u_f, b_f), self._field_from(level + 1, u_c, b_c)

    def eval_pair(self, level: int, xi: torch.Tensor):
        s_f, s_c = self._eval_gaussian_pair(level, xi)
        if self.lognormal:
            return torch.exp(s_f), torch.exp(s_c)
        return s_f, s_c

    def nnz(self, level: int = 0) -> int:
        return int((self._lv[level]["A"].vals != 0).sum())


class UnstructuredEmbeddedSPDESampler(UnstructuredSPDESampler):
    """Matching-mesh embedded SPDE sampler on unstructured meshes: the SPDE
    is solved on the enlarged mesh (noise drawn there, K2 on a CUDA
    device) and the field restricted to the original domain by the
    per-level material-1 selection (the reference's EmbeddedPDESampler:
    embedded cells with attribute 1 correspond 1:1, in element order, to
    the original mesh). `selection[l]` maps original cell -> embedded cell
    at level l (build_embedded_simplicial_hierarchies)."""

    def __init__(self, orig_hierarchy: Union[SimplicialHierarchy, SimplicialLevel],
                 embed_hierarchy: Union[SimplicialHierarchy, SimplicialLevel],
                 selection: List[np.ndarray], config: ProblemConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(embed_hierarchy, config, dtype, device)
        self.orig_hierarchy = _as_hierarchy(orig_hierarchy)
        assert self.orig_hierarchy.nlevels == self.hierarchy.nlevels == len(selection)
        self.selection = [torch.as_tensor(np.asarray(s), dtype=torch.int64, device=self.device)
                          for s in selection]

    def field_size(self, level: int) -> int:
        return self.orig_hierarchy.levels[level].n_s

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        s = torch.index_select(self._eval_gaussian(level, xi, xi_level), -1,
                               self.selection[level])
        return torch.exp(s) if self.lognormal else s

    def embed_eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        s = self._eval_gaussian(level, xi, xi_level)
        return torch.exp(s) if self.lognormal else s

    def eval_pair(self, level: int, xi: torch.Tensor):
        s_f, s_c = self._eval_gaussian_pair(level, xi)
        s_f = torch.index_select(s_f, -1, self.selection[level])
        s_c = torch.index_select(s_c, -1, self.selection[level + 1])
        if self.lognormal:
            return torch.exp(s_f), torch.exp(s_c)
        return s_f, s_c


def match_embedded_cells(orig: GeneralMesh, embed: GeneralMesh, tol=1e-10) -> np.ndarray:
    """Original cell -> embedded cell map via materialId 1 (the reference's
    in-element-order correspondence), verified geometrically by centroid
    agreement."""
    sel = np.nonzero(embed.attributes == 1)[0]
    if sel.size != len(orig.elements):
        raise ValueError(
            f"embedded mesh has {sel.size} material-1 cells, original has "
            f"{len(orig.elements)}: not a matching embedding"
        )
    oc = orig.vertices[np.stack(orig.elements)].mean(axis=1)
    ec = embed.vertices[np.stack(embed.elements)].mean(axis=1)
    err = float(np.abs(ec[sel] - oc).max())
    if err > tol:
        raise ValueError(
            f"material-1 cells do not match the original mesh in element "
            f"order (max centroid error {err:.2e})"
        )
    return sel


def build_embedded_simplicial_hierarchies(
    orig_gm: GeneralMesh,
    embed_gm: GeneralMesh,
    nlevels: int,
    unstructured_coarsening: bool = False,
    coarsening_factor: int = 8,
):
    """Aligned (orig, embed) hierarchies + per-level selection maps.

    * Refinement mode: both meshes refine in lockstep; children enumerate
      parent-major, so the fine selection is sel_f[o*nc + k] = sel_c[o]*nc + k.
    * Agglomeration mode (the reference's EmbeddedBuildTopology with
      material-interface-preserving LogicalPartitioner): partition the
      embedded fine mesh with material-crossing edges removed, so every
      agglomerate is purely inside or outside; the original hierarchy
      inherits the induced partition of its twin cells and the coarse
      selection maps original agglomerate -> embedded agglomerate.
    """
    sel0 = match_embedded_cells(orig_gm, embed_gm)

    if not unstructured_coarsening:
        orig_h = build_simplicial_hierarchy(orig_gm, nlevels)
        embed_h = build_simplicial_hierarchy(embed_gm, nlevels)
        d = orig_gm.dim
        nc = 4 if d == 2 else 8
        selection = [sel0]
        for _ in range(nlevels - 1):
            prev = selection[-1]
            selection.append(
                (prev[:, None] * nc + np.arange(nc)[None, :]).reshape(-1)
            )
        selection = selection[::-1]  # finest first (level 0)
        return orig_h, embed_h, selection

    # --- agglomeration mode ---------------------------------------------------
    orig_levels = [build_simplicial_level(orig_gm)]
    embed_levels = [build_simplicial_level(embed_gm)]
    orig_P, embed_P = [], []
    orig_parents, embed_parents = [], []
    selection = [sel0]
    material = np.asarray(embed_gm.attributes) == 1
    for _ in range(nlevels - 1):
        el = embed_levels[-1]
        adj = _cell_adjacency(el).tocoo()
        keep = material[adj.row] == material[adj.col]
        adj_cut = sp.csr_matrix(
            (adj.data[keep], (adj.row[keep], adj.col[keep])), shape=adj.shape
        )
        e_labels = partition_cells(adj_cut, _level_cell_centers(el), coarsening_factor)
        # Sanity: agglomerates never straddle the material interface.
        assert (
            np.intersect1d(
                np.unique(e_labels[material]), np.unique(e_labels[~material])
            ).size
            == 0
        ), "agglomerate straddles the material interface"
        e_coarse, e_P = agglomerate_level(el, e_labels)
        # Induced original partition via the twin cells.
        sel = selection[-1]
        o_labels_raw = e_labels[sel]
        uniq, o_labels = np.unique(o_labels_raw, return_inverse=True)
        o_coarse, o_P = agglomerate_level(orig_levels[-1], o_labels)
        embed_levels.append(e_coarse)
        orig_levels.append(o_coarse)
        embed_P.append(e_P)
        orig_P.append(o_P)
        embed_parents.append(e_labels)
        orig_parents.append(o_labels)
        selection.append(uniq)  # original agg i -> embedded agg uniq[i]
        material = np.zeros(e_coarse.n_s, dtype=bool)
        material[uniq] = True
    orig_h = SimplicialHierarchy(levels=orig_levels, parent=orig_parents, P_rt=orig_P)
    embed_h = SimplicialHierarchy(
        levels=embed_levels, parent=embed_parents, P_rt=embed_P
    )
    return orig_h, embed_h, selection


class UnstructuredProjectionSPDESampler(UnstructuredSPDESampler):
    """Non-matching-mesh embedded SPDE sampler on simplicial meshes (the
    reference's L2ProjectionPDESampler): the field is solved on an
    independently meshed enlarged domain and projected to the original
    mesh by the mortar coupling, assembled per level on the host by the
    native intersection kernels (native/geometry.cc) at setup and applied
    on the device as an ELL. projection_order 0: s = W_orig^{-1} G s_embed
    with G the P0 coupling; 1: the L2 projection onto the original mesh's
    P1 vertex space (the mixed P1-P0 coupling over the lumped P1 mass, so
    constants transfer exactly), reduced to one value per cell by the mean
    of its d+1 vertex values."""

    def __init__(self, orig_hierarchy: Union[SimplicialHierarchy, SimplicialLevel],
                 embed_hierarchy: Union[SimplicialHierarchy, SimplicialLevel],
                 config: ProblemConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__(embed_hierarchy, config, dtype, device)
        dev = self.device
        vec = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)
        self.orig_hierarchy = _as_hierarchy(orig_hierarchy)
        assert self.orig_hierarchy.nlevels == self.hierarchy.nlevels
        self.projection_order = int(config.projection_order)
        self.G = []
        self.winv_orig = []
        self._cell_verts = []  # order 1: (nc, d+1) vertex gather per level
        for l in range(self.orig_hierarchy.nlevels):
            om = self.orig_hierarchy.levels[l]
            em = self.hierarchy.levels[l]
            if self.projection_order == 1:
                G, lump = mortar_p1_p0_couple(om.mesh, em.mesh)
                weights = lump
                self._cell_verts.append(vec(np.stack(om.mesh.elements), torch.int64))
            else:
                G = mortar_p0_couple(om.mesh, em.mesh)
                weights = om.W
                self._cell_verts.append(None)
            covered = np.asarray(G.sum(axis=1)).ravel()
            if not np.allclose(covered, weights, rtol=1e-8):
                raise ValueError("No intersection, no transfer! (level %d)" % l)
            self.G.append(pack_csr_to_ell(G, dtype, device=dev))
            self.winv_orig.append(vec(1.0 / weights))
        self._vel_ops = {}

    def field_size(self, level: int) -> int:
        return self.orig_hierarchy.levels[level].n_s

    def transfer_velocity(self, level: int, u_embed: torch.Tensor, rtol: float = 1e-8,
                          max_iterations: int = 60):
        """Mortar L2 projection of an RT0 velocity field from the embedded
        mesh to the original one, v = M_orig^{-1} B_rt u_embed (the
        reference's ParMortarAssembler::Transfer for vector spaces): B_rt is
        the exact RT0-RT0 mortar coupling (transfer_integrators.
        mortar_rt0_couple), assembled on the host at first use for the
        level, and the original RT0 mass is inverted by Jacobi-PCG.
        `u_embed` is (n_u_embed,) or (batch, n_u_embed) in the embedded
        level's face numbering; returns (v, SolveInfo) in the original
        level's."""
        if level not in self._vel_ops:
            ol = self.orig_hierarchy.levels[level]
            el = self.hierarchy.levels[level]
            B = mortar_rt0_couple(ol, el).tocsr()
            M = ol.mass_csr().tocsr()
            self._vel_ops[level] = (
                pack_csr_to_ell(B, self.dtype, device=self.device),
                pack_csr_to_ell(M, self.dtype, device=self.device),
                torch.as_tensor(1.0 / M.diagonal(), dtype=self.dtype, device=self.device),
            )
        B_ell, M_ell, dinv = self._vel_ops[level]
        rhs = ell_apply(B_ell, u_embed)
        return pcg(lambda x: ell_apply(M_ell, x), rhs, prec=lambda r: dinv * r,
                   max_iters=max_iterations, rtol=rtol)

    def project(self, level: int, s_embed: torch.Tensor) -> torch.Tensor:
        s_v = self.winv_orig[level] * ell_apply(self.G[level], s_embed)
        if self.projection_order == 1:
            return _take(s_v, self._cell_verts[level]).mean(dim=-1)
        return s_v

    transfer = project  # reference: L2ProjectionPDESampler::Transfer

    def eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        # exp after the projection, as the reference does.
        s = self.project(level, self._eval_gaussian(level, xi, xi_level))
        return torch.exp(s) if self.lognormal else s

    def embed_eval(self, level: int, xi: torch.Tensor, xi_level: Optional[int] = None):
        s = self._eval_gaussian(level, xi, xi_level)
        return torch.exp(s) if self.lognormal else s

    def eval_pair(self, level: int, xi: torch.Tensor):
        s_f, s_c = self._eval_gaussian_pair(level, xi)
        s_f = self.project(level, s_f)
        s_c = self.project(level + 1, s_c)
        if self.lognormal:
            return torch.exp(s_f), torch.exp(s_c)
        return s_f, s_c


class UnstructuredDarcySolver:
    """Mixed Darcy forward model on simplicial and agglomerated meshes:
    batched MINRES on the saddle system [[M(w), B^T], [B, 0]] (velocity mass
    as a coefficient ELL, essential rows eliminated) with a block-diagonal
    preconditioner: diag(M(w))^-1 on the velocity and, on the pressure,
    the diagonal of B diag(M(w))^-1 B^T (minres-bj), a static Schur V-cycle
    scaled by the sample's geometric-mean coefficient (minres-mg), or the
    per-sample Galerkin coefficient MG (minres-coefmg). Under hybrid-cg
    each level that hybridizes solves its SPD face-multiplier system by PCG
    instead, with the coefficient MG as the auxiliary-space half of the
    preconditioner. QoI functionals and forcing are assembled on the
    finest level and restricted through the exact block prolongator
    transposes."""

    def __init__(self, hierarchy: Union[SimplicialHierarchy, SimplicialLevel],
                 config: ProblemConfig, dtype: torch.dtype = torch.float32, device=None):
        self.hierarchy = _as_hierarchy(hierarchy)
        self.config = config
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        vec = lambda x, dt=dtype: torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)
        levels = self.hierarchy.levels
        d = levels[0].dim
        nb = max(int(max(l.bdr_attr.max() for l in levels)), 1)

        def attr_vec(v):
            out = np.zeros(nb, dtype=np.int64)
            out[: min(len(v), nb)] = np.asarray(v[:nb], dtype=np.int64)
            return out

        ess_attr = attr_vec(config.ess_attr)
        obs_attr = attr_vec(config.obs_attr)
        inflow_attr = attr_vec(config.inflow_attr)

        # Finest-level rhs and QoI functionals.
        fine = levels[0]
        on = fine.bdr_attr > 0
        attr0 = np.maximum(fine.bdr_attr - 1, 0)
        rhs_u0 = np.zeros(fine.n_u)
        rhs_u0[on & (inflow_attr[attr0] == 1)] = -1.0  # weak p_bar = 1 inflow
        obs0 = np.zeros(fine.n_u + fine.n_s)
        if config.qoi == "eff_perm":
            obs0[: fine.n_u][on & (obs_attr[attr0] == 1)] = 1.0
        elif config.qoi == "p_int":
            obs0[fine.n_u:] = -fine.W
        elif config.qoi == "local_avg_p":
            conn = np.stack(fine.mesh.elements)
            centers = fine.mesh.vertices[conn].mean(axis=1)
            mask = (np.abs(centers - np.asarray(config.qoi_point)[None, :d]).max(axis=1)
                    <= config.qoi_eps)
            obs0[fine.n_u:] = np.where(mask, -fine.W, 0.0)
        else:
            raise ValueError(f"unknown QoI '{config.qoi}'")

        rhs_np = [np.concatenate([rhs_u0, np.zeros(fine.n_s)])]
        obs_np = [obs0]
        for l in range(self.hierarchy.nlevels - 1):
            P_rt = self.hierarchy.P_rt[l]
            P_l2 = self.hierarchy.p_l2(l)
            for vecs in (rhs_np, obs_np):
                vu = P_rt.T @ vecs[l][: levels[l].n_u]
                vp = P_l2.T @ vecs[l][levels[l].n_u:]
                vecs.append(np.concatenate([vu, vp]))

        self.solver_cfg = config.darcy_solver
        self._lv = []
        sbar_csr: List[sp.csr_matrix] = []
        self._coef_mg = [None] * self.hierarchy.nlevels
        for l, lvl in enumerate(levels):
            ess = lvl.ess_faces(ess_attr)
            if self.solver_cfg.name in ("minres-coefmg", "hybrid-cg"):
                # Per-sample Galerkin Schur MG below this MLMC level from the
                # face incidence alone (agglomerated parents): any simplicial,
                # agglomerated or curved mesh. hybrid-cg takes it as the
                # auxiliary-space half of its preconditioner.
                fs_m = lvl.face_signs.copy()
                fs_m[ess, :] = 0.0
                self._coef_mg[l] = cmg.build_coef_mg_graph(
                    lvl.face_cells, fs_m, _level_cell_centers(lvl), dtype=dtype,
                    cutoff=self.solver_cfg.coarse_dense_cutoff,
                    coarse_sweeps=max(1, self.solver_cfg.mg_coarse_sweeps), device=dev)
            m_vals = lvl.m_vals.copy()
            m_vals[ess, :] = 0.0
            m_vals = np.where(ess[lvl.m_cols], 0.0, m_vals)
            fs = lvl.face_signs.copy()
            fs[ess, :] = 0.0
            r = rhs_np[l].copy()
            r[: lvl.n_u][ess] = 0.0
            # Static approximate pressure Schur S_bar = B diag(M)^{-1} B^T
            # (unit coefficient) for the MG pressure-block preconditioner.
            diag_rows = np.where(lvl.m_cols == np.arange(lvl.n_u)[:, None], m_vals, 0.0)
            dM1 = np.maximum(diag_rows.sum(axis=1), 0.0)
            dinv1 = np.where(ess | (dM1 <= 0), 0.0, 1.0 / np.maximum(dM1, 1e-300))
            Bm = sp.csr_matrix(
                (np.where(ess[lvl.cell_faces], 0.0, lvl.cell_signs).ravel(),
                 (np.repeat(np.arange(lvl.n_s), lvl.cell_faces.shape[1]),
                  lvl.cell_faces.ravel())),
                shape=(lvl.n_s, lvl.n_u),
            )
            sbar_csr.append((Bm @ sp.diags(dinv1) @ Bm.T).tocsr())
            self._lv.append(dict(
                n_u=lvl.n_u,
                n_s=lvl.n_s,
                ess=vec(ess, torch.bool),
                m_op=pack_coef_ell(lvl.m_cols, m_vals, lvl.m_cells, dtype, device=dev),
                m_diag=coef_diag_structure(lvl.m_cols, m_vals, lvl.m_cells, dtype, device=dev),
                cell_faces=vec(lvl.cell_faces, torch.int64),
                cell_signs=vec(np.where(ess[lvl.cell_faces], 0.0, lvl.cell_signs)),
                face_cells=vec(lvl.face_cells, torch.int64),
                face_signs=vec(fs),
                rhs=vec(r),
                obs=vec(obs_np[l]),
            ))
        # Mean-field warm starts (config.meanfield_x0): per-level cached
        # w == 1 solution - the saddle vector on MINRES levels, the trace
        # multiplier on hybridized ones.
        self._mf_cache = {}
        self._mf_building: set = set()
        # Hybridized SPD path (hybrid-cg, physics/hybrid.py): the geometric
        # tables on simplicial levels, the algebraic ones from the
        # per-agglomerate Galerkin mass blocks on agglomerated levels; a
        # level where both return None keeps MINRES.
        self._hybrid = [None] * self.hierarchy.nlevels
        if self.solver_cfg.name == "hybrid-cg":
            for l, lvl in enumerate(levels):
                ess = lvl.ess_faces(ess_attr)
                h = build_hybrid_level(lvl, ess, rhs_np[l], obs_np[l], dtype, dev)
                if h is None:
                    h = build_hybrid_level_algebraic(lvl, ess, rhs_np[l], obs_np[l], dtype, dev)
                self._hybrid[l] = h
        # Block prolongations for warm-started pair solves.
        self._prolong_rt = [pack_csr_to_ell(P.tocsr(), dtype, device=dev)
                            for P in self.hierarchy.P_rt]
        self._parent_dev = [vec(p, torch.int64) for p in self.hierarchy.parent]
        # Static pressure-Schur MG over the hierarchy's P0 prolongators
        # (minres-mg), on Galerkin RAP coarse operators.
        self._schur_mg = [None] * self.hierarchy.nlevels
        if self.solver_cfg.name == "minres-mg" and self.hierarchy.nlevels > 1:
            p_l2 = [self.hierarchy.p_l2(l).tocsr() for l in range(self.hierarchy.nlevels - 1)]
            for l in range(self.hierarchy.nlevels - 1):
                self._schur_mg[l] = _galerkin_mg(sbar_csr[l], p_l2[l:], dtype,
                                                 self.solver_cfg, dev)

    def num_dofs(self, level: int = 0) -> int:
        L = self._lv[level]
        return int(L["n_u"] + L["n_s"])

    def nnz(self, level: int = 0) -> int:
        L = self._lv[level]
        return int((L["m_op"].mvals != 0).sum()) + 2 * int((L["cell_signs"] != 0).sum())

    def solve_fwd_pair(self, level: int, w_f: torch.Tensor, w_c: torch.Tensor,
                       max_iters: Optional[int] = None):
        """Coupled (fine, coarse) solves with the fine MINRES warm-started
        from the block-prolongated coarse solution [P_rt u_c; p_c[parent]].
        A hybridized fine level recovers (u, p~) element-locally and has no
        saddle iterate to start from, so its pair runs as two independent
        cold solves. Returns (q, qc, info_f, info_c)."""
        if self._hybrid[level] is not None:
            qc, _, info_c = self.solve_fwd(level + 1, w_c, max_iters=max_iters)
            q, _, info_f = self.solve_fwd(level, w_f, max_iters=max_iters)
            return q, qc, info_f, info_c
        qc, _, info_c, x_c = self.solve_fwd(level + 1, w_c, return_solution=True,
                                            max_iters=max_iters)
        n_uc = int(self._lv[level + 1]["n_u"])
        u0 = ell_apply(self._prolong_rt[level], x_c[..., :n_uc])
        u0 = torch.where(self._lv[level]["ess"], torch.zeros_like(u0), u0)
        p0 = torch.index_select(x_c[..., n_uc:], -1, self._parent_dev[level])
        x0 = torch.cat([u0, p0], dim=-1)
        q, _, info_f = self.solve_fwd(level, w_f, x0=x0, max_iters=max_iters)
        return q, qc, info_f, info_c

    def _coefmg_cycle(self, level: int, w: torch.Tensor):
        """Per-sample Galerkin coefficient-MG V-cycle r -> z for this
        sample's masked mass diagonal, or None when the level has none."""
        mg = self._coef_mg[level]
        if mg is None:
            return None
        L = self._lv[level]
        diag_w = L["m_diag"](w)
        ok = (diag_w > 0) & ~L["ess"]
        dinv0 = torch.where(ok, 1.0 / torch.where(diag_w == 0, torch.ones_like(diag_w), diag_w),
                            torch.zeros_like(diag_w))
        dinvs = cmg.coef_mg_dinvs(mg, dinv0)
        idiags = cmg.coef_mg_idiags(mg, dinvs)
        return lambda r: cmg.coef_v_cycle(mg, dinvs, r, idiags=idiags)

    def _prec(self, level: int, w: torch.Tensor, inv_dM: torch.Tensor):
        L = self._lv[level]
        n_u = int(L["n_u"])
        coefmg_cycle = self._coefmg_cycle(level, w)
        if coefmg_cycle is not None:
            block_p = coefmg_cycle
        elif self._schur_mg[level] is not None:
            mg = self._schur_mg[level]
            # Per-sample geometric-mean coefficient scale on the static
            # unit-coefficient Schur V-cycle.
            w_bar = torch.exp(torch.mean(torch.log(w), dim=-1, keepdim=True))
            block_p = lambda rp: w_bar * mgops.v_cycle(mg, rp)
        else:
            dS = torch.sum(_take(inv_dM, L["cell_faces"]) * L["cell_signs"] ** 2, dim=-1)
            inv_dS = 1.0 / torch.clamp(dS, min=1e-30)
            block_p = lambda rp: rp * inv_dS
        return lambda r: torch.cat([r[..., :n_u] * inv_dM, block_p(r[..., n_u:])], dim=-1)

    def solve_fwd(self, level: int, w: torch.Tensor, return_pressure: bool = False,
                  x0: Optional[torch.Tensor] = None, return_solution: bool = False,
                  max_iters: Optional[int] = None):
        """Q per sample of the batch of coefficient fields w (batch, n_s):
        (Q, cost, info), with the pressure -x_p appended under
        `return_pressure` and the saddle solution x under
        `return_solution`. `x0` starts MINRES (else the mean-field vector
        under meanfield_x0, else zero); `max_iters` overrides
        config.max_iterations for this solve. A hybridized level solves
        the multiplier system instead (hybrid_solve), unless x0 or the
        saddle solution is asked for."""
        mf = self.solver_cfg.meanfield_x0 and level not in self._mf_building
        cfg = self.solver_cfg
        budget = cfg.max_iterations if max_iters is None else int(max_iters)
        if self._hybrid[level] is not None and x0 is None and not return_solution:
            lam0 = None
            if mf:
                lam_ref = self._meanfield_start(level)
                lam0 = lam_ref.expand(w.shape[:-1] + lam_ref.shape[-1:])
            Q, info, pe = hybrid_solve(
                self._hybrid[level], w, max_iters=budget, rtol=cfg.relative_tolerance,
                atol=cfg.absolute_tolerance, restart_every=cfg.restart_every,
                aux_cycle=self._coefmg_cycle(level, w), lam0=lam0)
            cost = float(self.num_dofs(level))
            if return_pressure:
                return Q, cost, info, -pe
            return Q, cost, info
        L = self._lv[level]
        n_u = int(L["n_u"])
        ess = L["ess"]

        def apply_A(x):
            u, p = x[..., :n_u], x[..., n_u:]
            Mu = coef_ell_apply(L["m_op"], w, u)
            Btp = _bt_gather(L["face_cells"], L["face_signs"], p)
            yu = torch.where(ess, u, Mu + Btp)
            Bu = _b_gather(L["cell_faces"], L["cell_signs"], u)
            return torch.cat([yu, Bu], dim=-1)

        dM = L["m_diag"](w)
        inv_dM = 1.0 / torch.where(ess, torch.ones_like(dM), dM)
        prec = self._prec(level, w, inv_dM)
        if x0 is None and mf:
            x_ref = self._meanfield_start(level)
            x0 = x_ref.expand(w.shape[:-1] + x_ref.shape[-1:])
        b = L["rhs"].expand(w.shape[:-1] + L["rhs"].shape)
        x, info = minres(apply_A, b, prec=prec, x0=x0, max_iters=budget,
                         rtol=cfg.relative_tolerance, atol=cfg.absolute_tolerance)
        Q = torch.sum(x * L["obs"], dim=-1)
        cost = float(self.num_dofs(level))
        if return_solution:
            return Q, cost, info, x
        if return_pressure:
            return Q, cost, info, -x[..., n_u:]
        return Q, cost, info

    def _meanfield_start(self, level: int) -> torch.Tensor:
        """Mean-field initial iterate (config.meanfield_x0): one reference
        solve with w == 1 on this level (up to 8 restarts until converged),
        cached - the saddle vector on a MINRES level, the trace multiplier
        (hybrid_solve's lam0) on a hybridized one. The reference measured
        it to slow the unstructured MINRES down, so it stays off by
        default; the `_mf_building` guard keeps the setup solve from
        starting itself."""
        if level in self._mf_cache:
            return self._mf_cache[level]
        self._mf_building.add(level)
        try:
            ones = torch.ones((1, self._lv[level]["n_s"]), dtype=self.dtype, device=self.device)
            H = self._hybrid[level]
            cfg = self.solver_cfg
            x = None
            for _ in range(8):
                if H is not None:
                    _, info, _, x = hybrid_solve(
                        H, ones, max_iters=cfg.max_iterations, rtol=cfg.relative_tolerance,
                        atol=cfg.absolute_tolerance, restart_every=cfg.restart_every,
                        aux_cycle=self._coefmg_cycle(level, ones), lam0=x, return_lam=True)
                else:
                    _, _, info, x = self.solve_fwd(level, ones, x0=x, return_solution=True)
                if bool(info.converged.all()):
                    break
        finally:
            self._mf_building.discard(level)
        self._mf_cache[level] = x[0]
        return x[0]
