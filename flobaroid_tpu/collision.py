"""Collision model: capsule primitives with differentiable distances.

Counterpart of the reference's excitation/capsule.py (capsule fitting
from URDF cylinder/sphere/box/mesh geometry :30-275, closed-form
segment-segment distance :283-349, analytic distance gradients
:427-505) and identification/collision.py (CollisionChecker with
margins, robot-self and robot-world queries).

Device-first: the reference keeps C++ FCL for mesh-accurate checks and
capsules for gradients; here capsules are the primary representation —
the segment-segment distance is a small closed-form jnp expression, so
whole trajectories x all collision pairs evaluate as one vmapped call
and jax.grad provides the collision gradients the reference computed
analytically by hand (capsule.py:427-505, ~93x faster than FD per its
CHANGELOG). Mesh AABBs (own STL reader) seed the capsule fitting.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .models.geometry import link_bounding_box, load_mesh_vertices, resolve_mesh_path
from .models.urdf import RobotTree, rpy_to_matrix


@dataclass
class Capsule:
    p0: np.ndarray  # segment start (link frame)
    p1: np.ndarray  # segment end
    radius: float


def fit_capsule(
    tree: RobotTree,
    link_name: str,
    use_collision: bool = True,
    scale: float = 1.0,
    mesh_base_dir: str = "meshes",
) -> Capsule | None:
    """Fit one capsule covering all of a link's geometry
    (reference capsule.py:30-275: per-primitive capsules merged with an
    inward radius pull). Strategy: collect primitive-aligned segments +
    radii, then merge along the dominant extent of their union."""
    li = tree.link_index[link_name]
    link = tree.links[li]
    elems = link.collisions if use_collision and link.collisions else link.visuals
    segs: list[tuple[np.ndarray, np.ndarray, float]] = []
    for el in elems:
        g = el.geometry
        if g is None:
            continue
        R = rpy_to_matrix(el.origin_rpy)
        p = el.origin_xyz
        if g.kind == "cylinder" or g.kind == "capsule":
            h = (g.length or 0.0) / 2.0
            a = p + R @ np.array([0, 0, -h])
            b = p + R @ np.array([0, 0, h])
            segs.append((a, b, float(g.radius or 0.0)))
        elif g.kind == "sphere":
            segs.append((p, p.copy(), float(g.radius or 0.0)))
        elif g.kind == "box":
            size = np.asarray(g.size)
            ax = int(np.argmax(size))
            h = size[ax] / 2.0
            d = np.zeros(3)
            d[ax] = 1.0
            others = np.delete(size, ax)
            r = float(np.linalg.norm(others) / 2.0) * 0.9  # inward pull
            segs.append((p + R @ (-h * d), p + R @ (h * d), r))
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
            v = v @ R.T + p
            lo, hi = v.min(axis=0), v.max(axis=0)
            size = hi - lo
            c = (lo + hi) / 2.0
            ax = int(np.argmax(size))
            h = size[ax] / 2.0
            d = np.zeros(3)
            d[ax] = 1.0
            others = np.delete(size, ax)
            r = float(np.linalg.norm(others) / 2.0) * 0.85
            segs.append((c - h * d, c + h * d, r))
    if not segs:
        return None
    if len(segs) == 1:
        a, b, r = segs[0]
        return Capsule(a * scale, b * scale, r * scale)
    # merge: endpoints = farthest pair among all segment endpoints;
    # radius covers every primitive's axis w.r.t. the merged axis
    pts = np.array([q for s in segs for q in (s[0], s[1])])
    d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=-1)
    i, j = np.unravel_index(np.argmax(d2), d2.shape)
    a, b = pts[i], pts[j]
    ab = b - a
    denom = max(float(ab @ ab), 1e-12)
    r_need = 0.0
    for s0, s1, r in segs:
        for q in (s0, s1):
            t = np.clip((q - a) @ ab / denom, 0, 1)
            dist = np.linalg.norm(q - (a + t * ab))
            r_need = max(r_need, dist * 0.8 + r)  # inward pull on offset
    return Capsule(a * scale, b * scale, r_need * scale)


def point_box_distance(p, center, half, R=None):
    """Signed distance from a point to an oriented box (negative inside).
    R: box orientation (world_R_box), half: half extents."""
    d = p - center
    if R is not None:
        d = R.T @ d
    q = jnp.abs(d) - half
    outside = jnp.sqrt(jnp.sum(jnp.maximum(q, 0.0) ** 2) + 1e-12)
    inside = jnp.minimum(jnp.max(q), 0.0)
    return outside + inside


def segment_box_distance(p0, p1, center, half, R=None, n_samples: int = 9):
    """Min distance from a segment to an oriented box, via point samples
    along the segment (differentiable; exact for boxes much larger than
    the sample spacing — the world-geometry case)."""
    ts = jnp.linspace(0.0, 1.0, n_samples)
    pts = p0[None, :] + ts[:, None] * (p1 - p0)[None, :]
    ds = jax.vmap(lambda p: point_box_distance(p, center, half, R))(pts)
    return jnp.min(ds)


def segment_segment_distance(p1, q1, p2, q2, eps=1e-12):
    """Closed-form minimum distance between segments [p1,q1] and [p2,q2]
    (Ericson, Real-Time Collision Detection; reference capsule.py:283-349).
    Branchless jnp formulation, safe under jit/grad/vmap."""
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = jnp.dot(d1, d1)
    e = jnp.dot(d2, d2)
    f = jnp.dot(d2, r)
    c = jnp.dot(d1, r)
    b = jnp.dot(d1, d2)
    denom = a * e - b * b

    # general case (clamped afterwards); guard degenerate segments
    s_num = jnp.where(denom > eps, (b * f - c * e), 0.0)
    s = jnp.clip(s_num / jnp.maximum(denom, eps), 0.0, 1.0)
    t = jnp.where(e > eps, (b * s + f) / jnp.maximum(e, eps), 0.0)
    # re-clamp s for clamped t
    t_cl = jnp.clip(t, 0.0, 1.0)
    s = jnp.where(
        t != t_cl,
        jnp.clip((t_cl * b - c) / jnp.maximum(a, eps), 0.0, 1.0),
        s,
    )
    t = t_cl
    # degenerate: point-segment / point-point. When segment 2 is a
    # point (zero-length capsule from a sphere geometry), the closest
    # point on segment 1 is s = clamp(-c/a) (Ericson 5.1.9) — the
    # general-case formula collapses to s = 0 there (denom = 0) and
    # overestimated the distance by up to the segment length
    s = jnp.where((e <= eps) & (a > eps),
                  jnp.clip(-c / jnp.maximum(a, eps), 0.0, 1.0), s)
    s = jnp.where(a <= eps, 0.0, s)
    t = jnp.where(e <= eps, 0.0, t)
    c1 = p1 + s * d1
    c2 = p2 + t * d2
    return jnp.sqrt(jnp.sum((c1 - c2) ** 2) + eps)


class CollisionModel:
    """Capsule collision pairs with batched differentiable distances.

    Pair construction mirrors the reference
    (trajectoryOptimizer._buildCollisionPairs :630-707): all link pairs
    with geometry, minus ignore lists/pairs, minus kinematic-tree
    neighbors (fixed-joint chains count as one body), minus pairs
    within `maxKinematicDistance` joints, plus robot-world pairs with
    per-pair margins."""

    def __init__(
        self,
        tree: RobotTree,
        engine,
        config: dict,
        world_tree: RobotTree | None = None,
    ):
        self.tree = tree
        self.engine = engine
        self.config = config
        scale = float(config.get("scaleCollisionHull", 1.0))

        ignore_links = set(config.get("ignoreLinksForCollision", []) or [])
        ignore_pairs = {
            tuple(sorted(p)) for p in (config.get("ignoreLinkPairsForCollision", []) or [])
        }
        # group-level ignores (reference trajectoryOptimizer.py:664-667):
        # every (a in groupA, b in groupB) pair is skipped
        for group_pair in config.get("ignoreCollisionBetweenGroups", []) or []:
            if len(group_pair) == 2:
                for ga in group_pair[0]:
                    for gb in group_pair[1]:
                        ignore_pairs.add(tuple(sorted((ga, gb))))

        # reference key scaleCapsuleRadius (capsule-mode radius scale,
        # excitation/optimizer.py:538): applied to the fitted radius
        rscale = float(config.get("scaleCapsuleRadius", 1.0))
        self.capsules: dict[str, Capsule] = {}
        for name in tree.link_names:
            if name in ignore_links:
                continue
            cap = fit_capsule(tree, name, scale=scale, mesh_base_dir=str(config.get("meshBaseDir", "meshes")))
            if cap is not None:
                if rscale != 1.0:
                    cap = Capsule(cap.p0, cap.p1, cap.radius * rscale)
                self.capsules[name] = cap

        # world geometry: oriented boxes fixed in world (capsules are a poor
        # fit for large flat obstacles like floors/tables), poses from the
        # world tree's FK at q=0
        self.world_boxes: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        if world_tree is not None:
            from .dynamics.engine import DynamicsEngine

            weng = DynamicsEngine(world_tree)
            Rw, pw = weng.fk(jnp.zeros(world_tree.num_dofs))
            Rw, pw = np.asarray(Rw), np.asarray(pw)
            for name in world_tree.link_names:
                if name in ignore_links:
                    continue
                link = world_tree.links[world_tree.link_index[name]]
                if not (link.visuals or link.collisions):
                    continue
                lo, hi = link_bounding_box(world_tree, name)
                li = world_tree.link_index[name]
                center_l = (lo + hi) / 2.0
                half = (hi - lo) / 2.0
                center_w = Rw[li] @ center_l + pw[li]
                self.world_boxes[name] = (center_w, half, Rw[li])

        # kinematic distance between links (fixed joints = distance 0)
        L = tree.num_links
        self._kin_dist = self._kinematic_distances()
        # reference key collisionMaxKinematicDistance
        # (trajectoryOptimizer.py:646); maxKinematicDistance is this
        # repo's earlier spelling, kept as a fallback
        ckd = config.get("collisionMaxKinematicDistance", None)
        max_kd = int(
            (ckd if ckd is not None else config.get("maxKinematicDistance", 0)) or 0
        )

        names = [n for n in tree.link_names if n in self.capsules]
        pairs = []
        for i in range(len(names)):
            for j in range(i + 1, len(names)):
                a, b = names[i], names[j]
                if tuple(sorted((a, b))) in ignore_pairs:
                    continue
                ia, ib = tree.link_index[a], tree.link_index[b]
                kd = self._kin_dist[ia, ib]
                if kd <= max(1, max_kd):
                    continue  # adjacent (or within the cap): never separates
                pairs.append((a, b))
        self.self_pairs = pairs

        margins_cfg = config.get("worldCollisionMargins", {}) or {}
        default_margin = float(config.get("worldCollisionDefaultMargin", 0.0))
        self.world_pairs = []
        self.world_margins = []
        for rl in names:
            for wl in self.world_boxes:
                if tuple(sorted((rl, wl))) in ignore_pairs:
                    continue
                self.world_pairs.append((rl, wl))
                self.world_margins.append(float(margins_cfg.get(wl, default_margin)))

        self.pair_names = self.self_pairs + self.world_pairs
        self.margins = np.concatenate(
            [np.zeros(len(self.self_pairs)), np.asarray(self.world_margins, dtype=float)]
        ) if self.pair_names else np.zeros(0)
        self._build_arrays()

    @property
    def num_pairs(self):
        return len(self.pair_names)

    def _kinematic_distances(self):
        """Joint-count distances between links; fixed joints contribute 0
        (fixed-joint-merged neighbors, reference helpers.py:762-798)."""
        tree = self.tree
        L = tree.num_links
        dist = np.full((L, L), 1000, dtype=int)
        import collections

        adj: dict[int, list[tuple[int, int]]] = collections.defaultdict(list)
        for i in range(L):
            pa = int(tree.parent_link[i])
            if pa < 0:
                continue
            j = tree.joints[tree.parent_joint[i]]
            w = 0 if j.jtype == "fixed" else 1
            adj[i].append((pa, w))
            adj[pa].append((i, w))
        for s in range(L):
            dq = collections.deque([(s, 0)])
            dist[s, s] = 0
            seen = {s}
            while dq:
                u, d = dq.popleft()
                for v, w in adj[u]:
                    if v not in seen or d + w < dist[s, v]:
                        seen.add(v)
                        if d + w < dist[s, v]:
                            dist[s, v] = d + w
                            dq.append((v, d + w))
        return dist

    def _build_arrays(self):
        tree = self.tree
        # robot-robot capsule pairs
        li_a, li_b = [], []
        p0a, p1a, ra = [], [], []
        p0b, p1b, rb = [], [], []
        for a, b in self.self_pairs:
            ca, cb = self.capsules[a], self.capsules[b]
            li_a.append(tree.link_index[a])
            li_b.append(tree.link_index[b])
            p0a.append(ca.p0); p1a.append(ca.p1); ra.append(ca.radius)
            p0b.append(cb.p0); p1b.append(cb.p1); rb.append(cb.radius)
        self._li_a = np.asarray(li_a, dtype=int)
        self._li_b = np.asarray(li_b, dtype=int)
        self._p0a = np.asarray(p0a).reshape(-1, 3); self._p1a = np.asarray(p1a).reshape(-1, 3)
        self._ra = np.asarray(ra)
        self._p0b = np.asarray(p0b).reshape(-1, 3); self._p1b = np.asarray(p1b).reshape(-1, 3)
        self._rb = np.asarray(rb)
        # robot-world capsule-box pairs
        wi, wp0, wp1, wr = [], [], [], []
        wc, wh, wR = [], [], []
        for rl, wl in self.world_pairs:
            ca = self.capsules[rl]
            c, h, R = self.world_boxes[wl]
            wi.append(tree.link_index[rl])
            wp0.append(ca.p0); wp1.append(ca.p1); wr.append(ca.radius)
            wc.append(c); wh.append(h); wR.append(R)
        self._wl = np.asarray(wi, dtype=int)
        self._wp0 = np.asarray(wp0).reshape(-1, 3); self._wp1 = np.asarray(wp1).reshape(-1, 3)
        self._wr = np.asarray(wr)
        self._wc = np.asarray(wc).reshape(-1, 3); self._wh = np.asarray(wh).reshape(-1, 3)
        self._wR = np.asarray(wR).reshape(-1, 3, 3)

    # ------------------------------------------------------------------
    def distances(self, q, base_rot=None, base_pos=None):
        """Per-pair clearance (distance - radii - margin) at one pose.
        Differentiable; vmap over trajectories."""
        if self.num_pairs == 0:
            return jnp.zeros(0)
        eng = self.engine
        dtype = q.dtype
        Rb, pb = eng.fk(q)
        if base_rot is not None:
            Rw = base_rot @ Rb
            pw = jnp.einsum("ij,lj->li", base_rot, pb)
        else:
            Rw, pw = Rb, pb
        if base_pos is not None:
            pw = pw + base_pos

        parts = []
        n_self = len(self.self_pairs)
        if n_self:
            def pair_dist(la, lb, P0a, P1a, Ra, P0b, P1b, Rb_):
                a0 = Rw[la] @ P0a + pw[la]
                a1 = Rw[la] @ P1a + pw[la]
                b0 = Rw[lb] @ P0b + pw[lb]
                b1 = Rw[lb] @ P1b + pw[lb]
                return segment_segment_distance(a0, a1, b0, b1) - Ra - Rb_

            parts.append(
                jax.vmap(pair_dist)(
                    jnp.asarray(self._li_a), jnp.asarray(self._li_b),
                    jnp.asarray(self._p0a, dtype), jnp.asarray(self._p1a, dtype),
                    jnp.asarray(self._ra, dtype),
                    jnp.asarray(self._p0b, dtype), jnp.asarray(self._p1b, dtype),
                    jnp.asarray(self._rb, dtype),
                )
            )
        if len(self.world_pairs):
            def wpair(la, P0, P1, Ra, c, h, Rbox):
                a0 = Rw[la] @ P0 + pw[la]
                a1 = Rw[la] @ P1 + pw[la]
                return segment_box_distance(a0, a1, c, h, Rbox) - Ra

            parts.append(
                jax.vmap(wpair)(
                    jnp.asarray(self._wl),
                    jnp.asarray(self._wp0, dtype), jnp.asarray(self._wp1, dtype),
                    jnp.asarray(self._wr, dtype),
                    jnp.asarray(self._wc, dtype), jnp.asarray(self._wh, dtype),
                    jnp.asarray(self._wR, dtype),
                )
            )
        return jnp.concatenate(parts) - jnp.asarray(self.margins, dtype)

    def min_distances_over_trajectory(self, Q, base_rot=None, base_pos=None, step=1):
        """(n_pairs,) minimum clearance over the trajectory; feeds the
        optimizer constraint g = -clearance <= 0."""
        Qs = Q[::step]
        if base_rot is not None:
            D = jax.vmap(self.distances)(Qs, base_rot[::step],
                                         None if base_pos is None else base_pos[::step])
        else:
            D = jax.vmap(lambda q: self.distances(q))(Qs)
        return jnp.min(D, axis=0)

    def constraint_fn(self, step: int = 3):
        """Returns extra_constraints_fn(Q) for TrajectoryObjective:
        g = -(min clearance per pair)."""

        def fn(Q):
            return -self.min_distances_over_trajectory(Q, step=step)

        return fn

    def trajectory_constraint_fn(
        self, step: int = 3, n_transition: int = 10, n_poses: int = 6
    ):
        """Full reference-parity collision constraint (reference
        trajectoryOptimizer.py:340-437): periodic samples are checked
        against their own (swung) base pose, and the minimum-jerk
        transition ramps from/to the zero posture are checked against
        representative base poses sampled from the periodic motion plus
        the extreme-swing pose (the suspension decays much slower than
        the ramp, so the base keeps swinging during transitions).

        Returns fn(Q, base_rot=None, base_pos=None) -> g (n_pairs,)
        with g = -(min clearance); fully traced and differentiable."""

        def fn(Q, base_rot=None, base_pos=None):
            Qs = Q[::step]
            if base_rot is not None:
                BRs = base_rot[::step]
                BPs = (
                    base_pos[::step]
                    if base_pos is not None
                    else jnp.zeros((Qs.shape[0], 3), Q.dtype)
                )
                D = jax.vmap(self.distances)(Qs, BRs, BPs)
            else:
                D = jax.vmap(lambda q: self.distances(q))(Qs)
            dmin = jnp.min(D, axis=0)

            if n_transition > 0:
                # quintic min-jerk time scaling: with a zero start
                # posture the ramp configurations are s_k * q_boundary
                taus = (jnp.arange(1, n_transition + 1, dtype=Q.dtype)) / (
                    n_transition + 1
                )
                s = 10.0 * taus**3 - 15.0 * taus**4 + 6.0 * taus**5
                Qt = jnp.concatenate(
                    [s[:, None] * Q[0][None, :], s[:, None] * Q[-1][None, :]]
                )
                if base_rot is not None:
                    N = base_rot.shape[0]
                    idx = np.linspace(0, N - 1, n_poses).astype(int)
                    # extreme swing = largest rotation angle from identity
                    # (traced argmax; the reference uses max |rpy| sum)
                    ang = jnp.arccos(
                        jnp.clip(
                            (jnp.trace(base_rot, axis1=1, axis2=2) - 1.0) / 2.0,
                            -1.0,
                            1.0,
                        )
                    )
                    ext = jnp.argmax(ang)
                    PR = jnp.concatenate([base_rot[idx], base_rot[ext][None]])
                    bp = (
                        base_pos
                        if base_pos is not None
                        else jnp.zeros((N, 3), Q.dtype)
                    )
                    PP = jnp.concatenate([bp[idx], bp[ext][None]])
                    Dt = jax.vmap(
                        lambda q: jax.vmap(lambda r, p: self.distances(q, r, p))(
                            PR, PP
                        )
                    )(Qt)
                    dmin = jnp.minimum(dmin, jnp.min(Dt, axis=(0, 1)))
                else:
                    Dt = jax.vmap(lambda q: self.distances(q))(Qt)
                    dmin = jnp.minimum(dmin, jnp.min(Dt, axis=0))
            return -dmin

        return fn

    # ------------------------------------------------------------------
    # CollisionChecker parity (reference identification/collision.py:19)
    # ------------------------------------------------------------------
    def check(self, q, base_rot=None, base_pos=None, margin=0.0):
        """Returns (ok, violations): pairs with clearance < margin."""
        d = np.asarray(self.distances(jnp.asarray(q, jnp.float64),
                                      None if base_rot is None else jnp.asarray(base_rot),
                                      None if base_pos is None else jnp.asarray(base_pos)))
        viol = [
            (self.pair_names[i], float(d[i]))
            for i in range(self.num_pairs)
            if d[i] < margin
        ]
        return len(viol) == 0, viol

    def find_colliding_at_zero(self):
        """Warn about pairs already overlapping at q=0 (reference
        capsule.find_colliding_links_capsule :508-579)."""
        nd = self.tree.num_dofs
        ok, viol = self.check(np.zeros(nd))
        return viol
