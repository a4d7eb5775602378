"""Mesh-tier exact collision verification.

Counterpart of the reference's FCL-backed mesh checking: the optimizer
geometry modes `collisionMode: box/convex/full` with per-link
`fullMeshLinks` overrides (reference excitation/optimizer.py:571-634),
the FCL distance queries (identification/collision.py:19-267) and the
dense re-verification of best trials (optimizer.py:1099-1132).

Device/host split (SURVEY §7 hard-parts): capsules remain the
DIFFERENTIABLE on-device optimizer mode; this module provides the
EXACT convex-hull distance pass that densely verifies the winning
candidate before it is declared feasible — the reference's own
sparse-then-dense pattern, without the C++ FCL dependency.

Distance algorithm: instead of host-side GJK (data-dependent loops,
one pair at a time), the distance between two convex vertex sets is
the simplex-constrained least squares

    min_{lam in S_a, mu in S_b}  || A^T lam - B^T mu ||

solved by a FIXED-iteration accelerated projected-gradient method —
pure tensor ops, vmappable over (pairs x trajectory samples) in one
jitted call. Coordinates are centered per problem, so the gradient
Lipschitz constant (exact from the 3x3 Gram) stays at link scale and
~300 iterations give sub-millimetre accuracy.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .models.geometry import (
    load_mesh_triangles,
    load_mesh_vertices,
    resolve_mesh_path,
)
from .models.urdf import RobotTree
from .models.urdf import rpy_to_matrix as _rpy_to_matrix


# ----------------------------------------------------------------------
# vertex clouds per link
# ----------------------------------------------------------------------
_SPHERE_DIRS = None


def _sphere_dirs():
    """42 near-uniform directions (subdivided icosahedron vertices)."""
    global _SPHERE_DIRS
    if _SPHERE_DIRS is None:
        phi = (1 + np.sqrt(5)) / 2
        v = []
        for a in (-1, 1):
            for b in (-phi, phi):
                v += [(0, a, b), (a, b, 0), (b, 0, a)]
        v = np.asarray(v, dtype=float)
        v = v / np.linalg.norm(v, axis=1, keepdims=True)
        mids = []
        for i in range(len(v)):
            for j in range(i + 1, len(v)):
                # adjacent icosahedron vertices have dot 1/sqrt(5) ~ 0.447
                if np.dot(v[i], v[j]) > 0.3:
                    m = v[i] + v[j]
                    mids.append(m / np.linalg.norm(m))
        _SPHERE_DIRS = np.concatenate([v, np.asarray(mids)]) if mids else v
    return _SPHERE_DIRS


def link_vertices(
    tree: RobotTree,
    link_name: str,
    mode: str = "convex",
    full: bool = False,
    mesh_base_dir: str = "meshes",
    max_vertices: int = 256,
) -> np.ndarray | None:
    """Link-frame vertex cloud for one link's geometry.

    mode 'box': 8 AABB corners (reference optimizer.py 'box');
    mode 'convex'/'full': mesh vertices reduced to their convex hull
    ('full' keeps the raw vertex set up to max_vertices — reference
    fullMeshLinks semantics, still evaluated as its hull here).
    Primitives contribute exact corner/ring/sphere-direction points.
    Returns None when the link has no geometry."""
    li = tree.link_index[link_name]
    link = tree.links[li]
    elems = link.collisions if link.collisions else link.visuals
    pts = []
    for el in elems:
        g = el.geometry
        if g is None:
            continue
        R = _rpy_to_matrix(el.origin_rpy)
        p0 = np.asarray(el.origin_xyz, dtype=float)
        if g.kind == "box":
            h = np.asarray(g.size) / 2.0
            corners = np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            ) * h
            pts.append(corners @ R.T + p0)
        elif g.kind in ("cylinder", "capsule"):
            r = float(g.radius or 0.0)
            h = float(g.length or 0.0) / 2.0
            ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
            ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
            for z in (-h, h):
                cap = np.concatenate([ring, np.full((len(ring), 1), z)], axis=1)
                pts.append(cap @ R.T + p0)
            if g.kind == "capsule":
                for z in (-(h + r), h + r):
                    pts.append((np.array([[0.0, 0.0, z]]) @ R.T + p0))
        elif g.kind == "sphere":
            r = float(g.radius or 0.0)
            pts.append(_sphere_dirs() * r @ R.T + p0)
        elif g.kind == "mesh":
            path = resolve_mesh_path(g.filename, tree.source_path, mesh_base_dir)
            if path is None:
                continue
            try:
                v = load_mesh_vertices(path)
            except (ValueError, OSError):
                continue
            if g.scale is not None:
                v = v * np.asarray(g.scale)
            pts.append(np.asarray(v) @ R.T + p0)
    if not pts:
        return None
    allp = np.concatenate(pts, axis=0)
    if mode == "box":
        lo, hi = allp.min(axis=0), allp.max(axis=0)
        return np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
        )
    if not full and len(allp) > 8:
        try:
            from scipy.spatial import ConvexHull

            allp = allp[np.unique(ConvexHull(allp).vertices)]
        except Exception:
            pass  # degenerate (coplanar etc.): keep raw points
    if len(allp) > max_vertices:
        # farthest-point downsample keeps the extremal shape
        keep = [int(np.argmax(np.linalg.norm(allp - allp.mean(0), axis=1)))]
        d = np.linalg.norm(allp - allp[keep[0]], axis=1)
        for _ in range(max_vertices - 1):
            k = int(np.argmax(d))
            keep.append(k)
            d = np.minimum(d, np.linalg.norm(allp - allp[k], axis=1))
        allp = allp[keep]
    return allp


def link_triangles(
    tree: RobotTree,
    link_name: str,
    mesh_base_dir: str = "meshes",
) -> tuple[np.ndarray, np.ndarray] | None:
    """(vertices, triangles) of a link's exact geometry in the link
    frame, for the native BVH narrowphase. Mesh geometries contribute
    their raw (non-convex) triangle soup; primitives are convex, so
    their hull triangulation is exact."""
    li = tree.link_index[link_name]
    link = tree.links[li]
    elems = link.collisions if link.collisions else link.visuals
    all_v, all_t = [], []
    off = 0
    for el in elems:
        g = el.geometry
        if g is None:
            continue
        R = _rpy_to_matrix(el.origin_rpy)
        p0 = np.asarray(el.origin_xyz, dtype=float)
        v = t = None
        if g.kind == "mesh":
            path = resolve_mesh_path(g.filename, tree.source_path, mesh_base_dir)
            if path is None:
                continue
            try:
                v, t = load_mesh_triangles(path)
            except (ValueError, OSError):
                continue
            if g.scale is not None:
                v = v * np.asarray(g.scale)
        else:
            # primitive: exact convex triangulation of its point set
            v = _element_points(g)
            if v is None:
                continue
            try:
                from scipy.spatial import ConvexHull

                h = ConvexHull(v)
                v, t = v, np.asarray(h.simplices, dtype=np.int32)
            except Exception:
                continue
        all_v.append(v @ R.T + p0)
        all_t.append(np.asarray(t, dtype=np.int32) + off)
        off += len(v)
    if not all_v:
        return None
    return np.concatenate(all_v, axis=0), np.concatenate(all_t, axis=0)


def _element_points(g) -> np.ndarray | None:
    """Point set of one primitive geometry element (element frame)."""
    if g.kind == "box":
        h = np.asarray(g.size) / 2.0
        return np.array(
            [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
        ) * h
    if g.kind in ("cylinder", "capsule"):
        r = float(g.radius or 0.0)
        h = float(g.length or 0.0) / 2.0
        ang = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        ring = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        pts = [np.concatenate([ring, np.full((len(ring), 1), z)], axis=1)
               for z in (-h, h)]
        if g.kind == "capsule":
            pts.append(np.array([[0.0, 0.0, -(h + r)], [0.0, 0.0, h + r]]))
        return np.concatenate(pts, axis=0)
    if g.kind == "sphere":
        return _sphere_dirs() * float(g.radius or 0.0)
    return None


def box_triangles(center, half, R) -> tuple[np.ndarray, np.ndarray]:
    """12-triangle world box (for world-pair narrowphase)."""
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
    ) * np.asarray(half)
    v = corners @ np.asarray(R).T + np.asarray(center)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1),
             (2, 3, 7, 6), (0, 2, 6, 4), (1, 5, 7, 3)]
    t = []
    for a, b, c, d in quads:
        t += [(a, b, c), (a, c, d)]
    return v, np.asarray(t, dtype=np.int32)


# ----------------------------------------------------------------------
# batched convex distance
# ----------------------------------------------------------------------
def _simplex_proj(v):
    """Euclidean projection onto the probability simplex."""
    u = jnp.sort(v)[::-1]
    css = jnp.cumsum(u) - 1.0
    ind = jnp.arange(1, v.shape[0] + 1, dtype=v.dtype)
    rho = jnp.sum(u - css / ind > 0)
    theta = css[rho - 1] / rho.astype(v.dtype)
    return jnp.maximum(v - theta, 0.0)


def polytope_distance(A, B, iters: int = 300):
    """Distance between conv(A) and conv(B); A (Va,3), B (Vb,3).
    Accelerated projected gradient on the product of simplices —
    fixed iteration count, so vmap/jit-friendly. Returns 0 when the
    hulls intersect (up to solver tolerance)."""
    dtype = A.dtype
    # center per problem: keeps the Lipschitz constant at link scale
    c = 0.5 * (jnp.mean(A, axis=0) + jnp.mean(B, axis=0))
    A = A - c
    B = B - c
    M = jnp.concatenate([A, -B], axis=0)  # (Va+Vb, 3)
    # exact smax^2 from the 3x3 Gram
    L = 2.0 * jnp.max(jnp.linalg.eigvalsh(M.T @ M)) + 1e-12
    Va = A.shape[0]
    lam0 = jnp.full((Va,), 1.0 / Va, dtype)
    mu0 = jnp.full((B.shape[0],), 1.0 / B.shape[0], dtype)

    def step(carry, k):
        lam, mu, lam_p, mu_p = carry
        beta = (k - 1.0) / (k + 2.0)
        yl = lam + beta * (lam - lam_p)
        ym = mu + beta * (mu - mu_p)
        d = A.T @ yl - B.T @ ym
        gl = 2.0 * (A @ d)
        gm = -2.0 * (B @ d)
        lam_n = _simplex_proj(yl - gl / L)
        mu_n = _simplex_proj(ym - gm / L)
        return (lam_n, mu_n, lam, mu), None

    ks = jnp.arange(1, iters + 1, dtype=dtype)
    (lam, mu, _, _), _ = jax.lax.scan(step, (lam0, mu0, lam0, mu0), ks)
    return jnp.linalg.norm(A.T @ lam - B.T @ mu)


class MeshCollisionVerifier:
    """Dense exact-geometry verification of a trajectory candidate.

    Pairs/margins are taken from an existing (capsule) CollisionModel so
    both tiers check the SAME pair set; only the geometry is upgraded
    to convex vertex hulls."""

    def __init__(self, tree, engine, config, capsule_model, world_tree=None):
        self.tree = tree
        self.engine = engine
        self.config = config
        mode = str(config.get("collisionMode", "convex"))
        full_links = set(config.get("fullMeshLinks", []) or [])
        mesh_dir = str(config.get("meshBaseDir", "meshes"))

        verts: dict[str, np.ndarray] = {}
        for name in tree.link_names:
            v = link_vertices(
                tree, name,
                mode=("box" if mode == "box" else "convex"),
                full=(name in full_links or mode == "full"),
                mesh_base_dir=mesh_dir,
            )
            if v is not None:
                verts[name] = v

        self.self_pairs = [
            (a, b) for (a, b) in capsule_model.self_pairs if a in verts and b in verts
        ]
        self.world_pairs = [
            (rl, wl) for (rl, wl) in capsule_model.world_pairs if rl in verts
        ]
        self.pair_names = self.self_pairs + self.world_pairs
        wmargins = dict(zip(capsule_model.world_pairs, capsule_model.world_margins))
        self.margins = np.concatenate([
            np.zeros(len(self.self_pairs)),
            np.asarray([wmargins[p] for p in self.world_pairs], dtype=float),
        ]) if self.pair_names else np.zeros(0)

        # attributes verify()/min_clearances() read unconditionally must
        # exist even for a verifier with zero pairs (advisor r2 finding)
        self._native: dict[int, tuple] = {}
        self._full_links: set[str] = set()
        if not self.pair_names:
            return

        # pad every cloud to one V for stacking
        Vmax = max(len(verts[n]) for pair in self.self_pairs for n in pair) if self.self_pairs else 8
        for rl, _ in self.world_pairs:
            Vmax = max(Vmax, len(verts[rl]))

        def pad(v):
            if len(v) < Vmax:
                v = np.concatenate([v, np.repeat(v[:1], Vmax - len(v), axis=0)])
            return v

        self._li_a = np.asarray([tree.link_index[a] for a, _ in self.self_pairs], int)
        self._li_b = np.asarray([tree.link_index[b] for _, b in self.self_pairs], int)
        self._Va = np.stack([pad(verts[a]) for a, _ in self.self_pairs]) if self.self_pairs else np.zeros((0, Vmax, 3))
        self._Vb = np.stack([pad(verts[b]) for _, b in self.self_pairs]) if self.self_pairs else np.zeros((0, Vmax, 3))

        # world boxes -> 8 world-frame corners
        self._wl = np.asarray([tree.link_index[rl] for rl, _ in self.world_pairs], int)
        self._Vw_r = np.stack([pad(verts[rl]) for rl, _ in self.world_pairs]) if self.world_pairs else np.zeros((0, Vmax, 3))
        wb = []
        for _, wl in self.world_pairs:
            cen, half, R = capsule_model.world_boxes[wl]
            corners = np.array(
                [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)]
            ) * half
            wb.append(corners @ R.T + cen)
        self._Vw_box = np.asarray(wb).reshape(-1, 8, 3)

        self._build()

        # triangle-exact native narrowphase for non-convex ("full") links:
        # the hull tier over-approximates them, so a near-contact hull
        # verdict is refined against the raw triangle BVH (the role FCL's
        # full-mesh mode plays in the reference, optimizer.py:571-634)
        self._full_links = {
            n for n in tree.link_names if n in full_links or mode == "full"
        }
        if self._full_links:
            from . import native_meshdist as _nm

            if _nm.available():
                tri_cache: dict[str, object] = {}

                def nat(name):
                    if name not in tri_cache:
                        vt = link_triangles(tree, name, mesh_base_dir=mesh_dir)
                        tri_cache[name] = (
                            _nm.NativeMesh(*vt) if vt is not None else None
                        )
                    return tri_cache[name]

                for i, (a, b) in enumerate(self.self_pairs):
                    if a in self._full_links or b in self._full_links:
                        ma, mb = nat(a), nat(b)
                        if ma is not None and mb is not None:
                            self._native[i] = (ma, mb)
                for j, (rl, wl) in enumerate(self.world_pairs):
                    if rl in self._full_links:
                        mr = nat(rl)
                        if mr is not None:
                            cen, half, R = capsule_model.world_boxes[wl]
                            vw, tw = box_triangles(cen, half, R)
                            self._native[len(self.self_pairs) + j] = (
                                mr, _nm.NativeMesh(vw, tw)
                            )
            else:
                print(
                    "collision: native meshdist unavailable — full-mesh "
                    "links fall back to the (conservative) convex tier"
                )

    @property
    def num_pairs(self):
        return len(self.pair_names)

    def _build(self):
        eng = self.engine
        li_a, li_b = jnp.asarray(self._li_a), jnp.asarray(self._li_b)
        Va, Vb = jnp.asarray(self._Va, jnp.float32), jnp.asarray(self._Vb, jnp.float32)
        wl = jnp.asarray(self._wl)
        Vw_r = jnp.asarray(self._Vw_r, jnp.float32)
        Vw_box = jnp.asarray(self._Vw_box, jnp.float32)
        n_self = len(self.self_pairs)
        n_world = len(self.world_pairs)

        def clearances(q, base_rot, base_pos):
            Rb, pb = eng.fk(q)
            Rw = base_rot @ Rb if base_rot is not None else Rb
            pw = (
                jnp.einsum("ij,lj->li", base_rot, pb) if base_rot is not None else pb
            )
            if base_pos is not None:
                pw = pw + base_pos
            Rw = Rw.astype(jnp.float32)
            pw = pw.astype(jnp.float32)
            parts = []
            if n_self:
                Aw = jnp.einsum("pij,pvj->pvi", Rw[li_a], Va) + pw[li_a][:, None, :]
                Bw = jnp.einsum("pij,pvj->pvi", Rw[li_b], Vb) + pw[li_b][:, None, :]
                parts.append(jax.vmap(polytope_distance)(Aw, Bw))
            if n_world:
                Aw = jnp.einsum("pij,pvj->pvi", Rw[wl], Vw_r) + pw[wl][:, None, :]
                parts.append(jax.vmap(polytope_distance)(Aw, Vw_box))
            return jnp.concatenate(parts) - jnp.asarray(self.margins, jnp.float32)

        self._clear_batch = jax.jit(
            jax.vmap(clearances, in_axes=(0, 0, 0))
        )
        self._clear_batch_fixed = jax.jit(
            jax.vmap(lambda q: clearances(q, None, None))
        )

    def min_clearances(self, Q, base_rot=None, base_pos=None, step=1,
                       chunk=256, per_sample=False):
        """(n_pairs,) minimum exact clearance over the trajectory, or the
        full (n_samples, n_pairs) clearance matrix with per_sample."""
        if self.num_pairs == 0:
            return np.zeros((0, 0)) if per_sample else np.zeros(0)
        Q = np.asarray(Q)[::step]
        BR = None if base_rot is None else np.asarray(base_rot)[::step]
        BP = None if base_pos is None else np.asarray(base_pos)[::step]
        out = []
        mins = np.full(self.num_pairs, np.inf)
        for s in range(0, len(Q), chunk):
            qs = jnp.asarray(Q[s:s + chunk])
            if BR is not None:
                D = self._clear_batch(
                    qs, jnp.asarray(BR[s:s + chunk]),
                    jnp.zeros((len(qs), 3)) if BP is None else jnp.asarray(BP[s:s + chunk]),
                )
            else:
                D = self._clear_batch_fixed(qs)
            D = np.asarray(D)
            if per_sample:
                out.append(D)
            mins = np.minimum(mins, D.min(axis=0))
        if per_sample:
            return np.concatenate(out, axis=0)
        return mins

    def _native_clearance(self, i, samples, Q, BR, BP) -> float:
        """Triangle-exact minimum clearance of pair i over `samples`
        (indices into the subsampled trajectory) via the native BVH."""
        from . import native_meshdist as _nm

        ma, mb = self._native[i]
        tree = self.tree
        if i < len(self.self_pairs):
            a, b = self.self_pairs[i]
            la, lb = tree.link_index[a], tree.link_index[b]
        else:
            rl, _ = self.world_pairs[i - len(self.self_pairs)]
            la, lb = tree.link_index[rl], None
        if not hasattr(self, "_fk_batch"):
            eng = self.engine
            self._fk_batch = jax.jit(jax.vmap(eng.fk))
        Rl, pl = self._fk_batch(jnp.asarray(Q[samples]))
        Rl = np.asarray(Rl, dtype=float)
        pl = np.asarray(pl, dtype=float)
        if BR is not None:
            Rw = np.einsum("nij,nljk->nlik", BR[samples], Rl)
            pw = np.einsum("nij,nlj->nli", BR[samples], pl)
            if BP is not None:
                pw = pw + BP[samples][:, None, :]
        else:
            Rw, pw = Rl, pl
        best = np.inf
        margin = float(self.margins[i])
        for s in range(len(samples)):
            Ta = _nm.mesh_from_transform(Rw[s, la], pw[s, la])
            Tb = (
                np.eye(4) if lb is None
                else _nm.mesh_from_transform(Rw[s, lb], pw[s, lb])
            )
            d = _nm.distance(ma, Ta, mb, Tb)
            if d > 0 and _nm.contained(ma, Ta, mb, Tb):
                # surface distance cannot see one body fully inside the
                # other (no surface crossing) — containment IS contact
                d = 0.0
            best = min(best, d - margin)
            if best <= 0:
                break
        return best

    def verify(self, Q, base_rot=None, base_pos=None, step=1, tol=1e-3):
        """(ok, violations): violations = [(pair, clearance), ...].

        A convex DISTANCE saturates at 0 under penetration, so contact
        is flagged at clearance < +tol (the reference separately
        confirms 0-distance BVH results with a collide() call,
        collision.py:19-267 — here the positive threshold plays that
        role). Pairs involving "full"-mode links re-check their
        near-contact samples against the raw-triangle BVH: the hull
        distance lower-bounds the mesh distance, so samples the hull
        already clears need no refinement (the reference's broad/narrow
        split, with hulls as the broadphase)."""
        want_refine = bool(self._native)
        D = self.min_clearances(
            Q, base_rot=base_rot, base_pos=base_pos, step=step,
            per_sample=want_refine,
        )
        mins = D.min(axis=0) if want_refine else D
        Qs = np.asarray(Q)[::step]
        BRs = None if base_rot is None else np.asarray(base_rot)[::step]
        BPs = None if base_pos is None else np.asarray(base_pos)[::step]
        bad = []
        for i in range(self.num_pairs):
            if mins[i] >= tol:
                continue
            if want_refine and i in self._native:
                samples = np.where(D[:, i] < tol)[0]
                refined = self._native_clearance(i, samples, Qs, BRs, BPs)
                if refined >= tol:
                    continue
                bad.append((self.pair_names[i], float(refined)))
            else:
                bad.append((self.pair_names[i], float(mins[i])))
        return (len(bad) == 0), bad
