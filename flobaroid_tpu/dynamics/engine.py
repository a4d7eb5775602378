"""Pure-JAX rigid-body dynamics engine.

Replaces the reference's iDynTree C++ backend (KinDynComputations:
setRobotState / inverseDynamics / inverseDynamicsInertialParametersRegressor /
getFreeFloatingMassMatrix / getFrameFreeFloatingJacobian; consumed at
reference identification/model.py:239-555) with one traceable function
family that vmaps over trajectory samples on the accelerator.

Design notes:
  * All link spatial velocities/accelerations are expressed in WORLD
    coordinates about the WORLD origin (Plücker coordinates). Because
    the identification problem is translation invariant, the base link
    always sits at the world origin (the reference also always passes a
    zero base position, identification/model.py:268-275), so the mixed
    base velocity/acceleration coincide with world-origin spatial
    quantities up to the classical-vs-spatial linear correction.
  * Only forward kinematics is sequential (a short unrolled loop over
    the static tree). Velocities, accelerations, per-link regressor
    blocks and the row assembly are masked batched einsums — XLA maps
    them onto batched matrix units once vmapped over samples; there is no
    per-sample Python, no backward recursion.
  * The standard regressor Y(q, dq, ddq) with Y @ pi == inverse
    dynamics [base wrench; joint torques] uses the reference's column
    layout: 10 params per link, [m, m*c, Ixx, Ixy, Ixz, Iyy, Iyz, Izz]
    about the link frame, links in URDF document order
    (reference: identification/model.py:190-195, 446-453).

Interface conventions (matching iDynTree's MIXED representation):
  * base velocity 'twist' = [linear(3); angular(3)] in world coords,
    linear = d/dt of base-origin position,
  * base acceleration = [d/dt linear; d/dt angular] (classical, mixed),
  * base wrench output rows = [force(3); torque(3)] at the base origin
    in world orientation,
  * gravity acts along `gravity` (default (0,0,-9.81)) in world coords.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..models.urdf import RobotTree
from . import spatial as sp


def _full_precision(fn):
    """Force true-f32 matmuls for all dots traced inside.

    On a GPU, XLA may run f32 matmuls in TF32 (about 3 decimal digits)
    unless told otherwise, which would show as ~1e-3 relative error on
    the regressor-RNEA identity instead of the ~1e-6 f32 floor. These
    contractions are tiny (3x3 / 6x10), so full precision costs little
    next to memory traffic.
    """

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapped


class DynamicsEngine:
    """Static robot structure + traceable dynamics functions.

    The constructor precomputes numpy constants (topology, joint frames,
    masks); every method is pure in its traced arguments and safe to
    jit/vmap/grad. Methods follow the dtype of their inputs.
    """

    def __init__(self, tree: RobotTree, gravity=(0.0, 0.0, -9.81)):
        self.tree = tree
        L = tree.num_links
        n = tree.num_dofs
        self.num_links = L
        self.num_dofs = n
        self.gravity = np.asarray(gravity, dtype=float)

        # per-link joint data (joint connecting link to its parent)
        R0 = np.tile(np.eye(3), (L, 1, 1))
        p0 = np.zeros((L, 3))
        axis = np.zeros((L, 3))
        jtype = np.zeros(L, dtype=int)  # 0 fixed/root, 1 revolute, 2 prismatic
        dof_of_link = np.full(L, -1, dtype=int)
        # per-link generalized-coordinate map q_link = scale*q[dof]+offset
        # (identity except for mimic joints)
        q_scale = np.ones(L)
        q_offset = np.zeros(L)
        for i in range(L):
            ji = tree.parent_joint[i]
            if ji < 0:
                continue
            j = tree.joints[ji]
            from ..models.urdf import rpy_to_matrix

            R0[i] = rpy_to_matrix(j.origin_rpy)
            p0[i] = j.origin_xyz
            axis[i] = j.axis
            if j.jtype in ("revolute", "continuous"):
                jtype[i] = 1
            elif j.jtype == "prismatic":
                jtype[i] = 2
        for dj, ji in enumerate(tree.dof_joint_ids):
            dof_of_link[tree.link_index[tree.joints[ji].child]] = dj

        # mjoints: every MOVABLE joint = the n DOF joints (in dof order)
        # followed by mimic joints (q_m = mult*q[src_dof] + offset; URDF
        # <mimic>, reference semantics via iDynTree ModelLoader). For a
        # mimic-free model these arrays are the identity map over dofs
        # and every formula below reduces to the pre-mimic code exactly.
        mimic = list(getattr(tree, "mimic_map", []))
        mj_link = list(np.asarray(tree.dof_link))
        mj_dof = list(range(n))
        mj_scale = [1.0] * n
        for (ji, src_dof, mult, off) in mimic:
            ci = tree.link_index[tree.joints[ji].child]
            mj_link.append(ci)
            mj_dof.append(src_dof)
            mj_scale.append(mult)
            dof_of_link[ci] = src_dof
            q_scale[ci] = mult
            q_offset[ci] = off
        self.has_mimic = bool(mimic)
        self.mjoint_link = np.asarray(mj_link, dtype=int)  # (m,)
        self.mjoint_dof = np.asarray(mj_dof, dtype=int)  # (m,)
        self.mjoint_scale = np.asarray(mj_scale, dtype=float)  # (m,)
        m = len(mj_link)
        # dof projection P[d, mj] = scale: velocities of mjoints from
        # dqs (dq_m = P.T row gather) and generalized torques back onto
        # dofs (tau = P @ tau_m)
        P = np.zeros((n, m))
        P[self.mjoint_dof, np.arange(m)] = self.mjoint_scale
        self.dof_project = P

        self.R0, self.p0, self.axis = R0, p0, axis
        self.jtype, self.dof_of_link = jtype, dof_of_link
        self.q_scale_of_link, self.q_offset_of_link = q_scale, q_offset
        self.topo = tree.topo_order()
        self.parent = np.asarray(tree.parent_link)
        self.dof_link = np.asarray(tree.dof_link)  # child link of each dof

        # mask[i, j] = 1 iff mjoint j lies on the path root -> link i
        # ((L, n) for mimic-free models — the historical ancestor_mask)
        mj_of_link = np.full(L, -1, dtype=int)
        mj_of_link[self.mjoint_link] = np.arange(m)
        mask = np.zeros((L, m))
        for i in range(L):
            chain = tree.ancestors(i) + [i]
            for li in chain:
                dj = mj_of_link[li]
                if dj >= 0:
                    mask[i, dj] = 1.0
        self.ancestor_mask = mask

        # subtree membership: sub[s, l] = 1 iff link l is in the subtree
        # rooted at link s (an F/T sensor mounted above link s measures
        # the wrench generated by exactly these links)
        sub = np.zeros((L, L))
        for l in range(L):
            for a in tree.ancestors(l) + [l]:
                sub[a, l] = 1.0
        self.subtree_mask = sub

        # depth levels for the level-synchronous FK: all links at one
        # tree depth transform in a single vectorized step, so the traced
        # graph scales with tree DEPTH, not link count (compile-time
        # matters: a 34-link humanoid has depth ~9)
        depth = np.zeros(L, dtype=int)
        for i in self.topo:
            pa = int(self.parent[i])
            depth[i] = 0 if pa < 0 else depth[pa] + 1
        self.levels = [
            np.where(depth == d)[0] for d in range(int(depth.max()) + 1)
        ]

    # ------------------------------------------------------------------
    # kinematics
    # ------------------------------------------------------------------
    @_full_precision
    def fk(self, q):
        """Forward kinematics in base coordinates.

        q: (n,). Returns (R, p): (L,3,3) link orientations and (L,3)
        link origins relative to the base link frame.

        Level-synchronous formulation: all links at one tree depth are
        transformed in a single batched step (gathered parents), so the
        traced graph scales with tree depth rather than link count."""
        dtype = q.dtype
        L = self.num_links
        R = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (L, 3, 3))
        p = jnp.zeros((L, 3), dtype=dtype)
        for idx in self.levels[1:]:
            par = self.parent[idx]
            R0 = jnp.asarray(self.R0[idx], dtype=dtype)  # (k,3,3)
            p0 = jnp.asarray(self.p0[idx], dtype=dtype)  # (k,3)
            ax = jnp.asarray(self.axis[idx], dtype=dtype)
            jt = self.jtype[idx]
            dj = np.maximum(self.dof_of_link[idx], 0)
            has_dof = (self.dof_of_link[idx] >= 0).astype(float)
            # q_link = scale*q[dof] + offset (identity unless mimic)
            qj = (
                q[jnp.asarray(dj)] * jnp.asarray(
                    self.q_scale_of_link[idx], dtype=dtype)
                + jnp.asarray(self.q_offset_of_link[idx], dtype=dtype)
            ) * jnp.asarray(has_dof, dtype=dtype)
            is_rev = jnp.asarray((jt == 1).astype(float), dtype=dtype)[:, None, None]
            is_pri = jnp.asarray((jt == 2).astype(float), dtype=dtype)[:, None]
            Rrot = sp.axis_angle_rot(ax, qj)  # (k,3,3)
            Rj = jnp.einsum("kij,kjl->kil", R0, Rrot)
            Rj = is_rev * Rj + (1.0 - is_rev) * R0
            pj = p0 + is_pri * jnp.einsum("kij,kj->ki", R0, ax * qj[:, None])
            Rpar = R[jnp.asarray(par)]
            ppar = p[jnp.asarray(par)]
            Rnew = jnp.einsum("kij,kjl->kil", Rpar, Rj)
            pnew = ppar + jnp.einsum("kij,kj->ki", Rpar, pj)
            R = R.at[jnp.asarray(idx)].set(Rnew)
            p = p.at[jnp.asarray(idx)].set(pnew)
        return R, p

    def _world_kinematics(self, q, dq, ddq, base_rot, base_vel, base_acc):
        """Shared kinematics: world-frame link poses, per-dof motion
        subspaces s_j (about the world origin), and link spatial
        velocities/accelerations V, A (world coords, gravity folded in).

        base_rot: (3,3) world_R_base; base_vel/base_acc: mixed 6-vectors
        [linear; angular].
        """
        dtype = q.dtype
        Rb, pb = self.fk(q)
        Rw = base_rot @ Rb  # (L,3,3) broadcasted matmul
        pw = (base_rot @ pb[..., None])[..., 0]

        dl = self.mjoint_link
        ax_w = jnp.einsum("dij,dj->di", Rw[dl], jnp.asarray(self.axis[dl], dtype=dtype))
        is_rev = jnp.asarray(self.jtype[dl] == 1, dtype=dtype)[:, None]
        s_ang = is_rev * ax_w
        s_lin = is_rev * jnp.cross(pw[dl], ax_w) + (1.0 - is_rev) * ax_w
        s = jnp.concatenate([s_ang, s_lin], axis=-1)  # (m,6)

        # per-mjoint coordinate rates (identity gather for mimic-free
        # models; mimic joints move at scale * their source dof's rate)
        if self.has_mimic:
            scl = jnp.asarray(self.mjoint_scale, dtype=dtype)
            dqm = dq[jnp.asarray(self.mjoint_dof)] * scl
            ddqm = ddq[jnp.asarray(self.mjoint_dof)] * scl
        else:
            dqm, ddqm = dq, ddq

        # base spatial velocity/acceleration about the world origin
        vlin, w = base_vel[:3], base_vel[3:]
        alin, wdot = base_acc[:3], base_acc[3:]
        g = jnp.asarray(self.gravity, dtype=dtype)
        v0 = jnp.concatenate([w, vlin])
        # classical mixed -> spatial: a_O = p_dd - w x p_d; gravity trick
        a0 = jnp.concatenate([wdot, alin - jnp.cross(w, vlin) - g])

        mask = jnp.asarray(self.ancestor_mask, dtype=dtype)  # (L,m)
        V = v0 + mask @ (s * dqm[:, None])  # (L,6)
        # d/dt s_j = v_{child(j)} x s_j (the axis is fixed in the child link)
        u = s * ddqm[:, None] + sp.crm(V[dl], s) * dqm[:, None]
        A = a0 + mask @ u  # (L,6)
        return Rw, pw, s, V, A, mask

    def _body_frame_va(self, Rw, pw, V, A):
        """Rotate world-origin spatial vectors into link frames.

        Returns per-link body coords (w, vl, alpha, al)."""
        RwT = jnp.swapaxes(Rw, -1, -2)
        w = jnp.einsum("lij,lj->li", RwT, V[:, :3])
        vl = jnp.einsum("lij,lj->li", RwT, V[:, 3:] + jnp.cross(V[:, :3], pw))
        alpha = jnp.einsum("lij,lj->li", RwT, A[:, :3])
        al = jnp.einsum("lij,lj->li", RwT, A[:, 3:] + jnp.cross(A[:, :3], pw))
        return w, vl, alpha, al

    # ------------------------------------------------------------------
    # regressor and inverse dynamics
    # ------------------------------------------------------------------
    @staticmethod
    def _link_regressor_blocks(w, vl, alpha, al):
        """Per-link 6x10 body-frame regressor block A with
        A @ [m, h, Ivec] = net spatial wrench [moment; force].

        Net wrench of one rigid body: f = I a + v x* (I v); written as a
        linear function of the 10 inertial parameters.
        """
        dtype = w.dtype
        L = w.shape[0]
        zero31 = jnp.zeros((L, 3, 1), dtype=dtype)
        zero36 = jnp.zeros((L, 3, 6), dtype=dtype)
        wxv = jnp.cross(w, vl)
        # moment rows
        n_m = zero31
        n_h = -sp.skew(al + wxv)
        n_I = sp.L_of(alpha) + sp.skew(w) @ sp.L_of(w)
        # force rows
        f_m = (al + wxv)[..., None]
        f_h = sp.skew(alpha) + sp.skew(w) @ sp.skew(w)
        f_I = zero36
        top = jnp.concatenate([n_m, n_h, n_I], axis=-1)
        bot = jnp.concatenate([f_m, f_h, f_I], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)  # (L,6,10)

    @staticmethod
    def _force_to_world(Rw, pw, blk):
        """Transform per-link force-space columns from link frame to world
        origin coords. blk: (L,6,C) with rows [moment; force]."""
        n_l, f_l = blk[:, :3, :], blk[:, 3:, :]
        f_w = jnp.einsum("lij,ljc->lic", Rw, f_l)
        n_w = jnp.einsum("lij,ljc->lic", Rw, n_l) + jnp.cross(
            pw[:, :, None], f_w, axis=1
        )
        return jnp.concatenate([n_w, f_w], axis=1)

    def _assemble_rows(self, s, mask, Fw, floating: bool):
        """Project per-link world wrench columns into output rows.

        Fw: (L,6,C). Returns (rows, L, C) keeping the per-link column
        blocks separate (the regressor needs them; inverse dynamics sums
        over L afterwards). Row order: [f; n] base wrench (iDynTree
        wrench serialization is force-then-torque), then joint torques.
        """
        Yj = jnp.einsum("jd,ldc,lj->jlc", s, Fw, mask)
        if self.has_mimic:
            # generalized force on dof d sums every mjoint it drives,
            # weighted by the mimic multiplier: tau = P @ tau_mjoint
            # (principle of virtual work for q_m = mult*q_d + off)
            Yj = jnp.einsum(
                "nm,mlc->nlc",
                jnp.asarray(self.dof_project, dtype=Yj.dtype), Yj,
            )
        if not floating:
            return Yj
        # base wrench rows: swap [moment; force] -> [force; moment]
        Yb = jnp.concatenate([Fw[:, 3:, :], Fw[:, :3, :]], axis=1)
        Yb = jnp.swapaxes(Yb, 0, 1)  # (6, L, C)
        return jnp.concatenate([Yb, Yj], axis=0)

    @_full_precision
    def regressor(self, q, dq, ddq, base_rot=None, base_vel=None, base_acc=None):
        """Standard inertial-parameter regressor for one sample.

        Returns ((6+n) x 10L) for floating base (base args given) or
        (n x 10L) for fixed base, such that `regressor @ pi` equals
        inverse dynamics [base wrench; joint torques]
        (reference parity: tests mirror tests/test_regressors.py:16-60).
        """
        floating = base_rot is not None
        base_rot, base_vel, base_acc = self._default_base(
            q.dtype, base_rot, base_vel, base_acc
        )
        Rw, pw, s, V, A, mask = self._world_kinematics(
            q, dq, ddq, base_rot, base_vel, base_acc
        )
        w, vl, alpha, al = self._body_frame_va(Rw, pw, V, A)
        blk = self._link_regressor_blocks(w, vl, alpha, al)
        Fw = self._force_to_world(Rw, pw, blk)  # (L,6,10)
        Y = self._assemble_rows(s, mask, Fw, floating)  # (rows, L, 10)
        # (rows, L*10): link-major column order == reference layout
        return Y.reshape(Y.shape[0], self.num_links * 10)

    @_full_precision
    def sensor_wrench_regressor(
        self, sensor_links, q, dq, ddq,
        base_rot=None, base_vel=None, base_acc=None,
    ):
        """Regressor rows of the wrench a 6-axis F/T sensor above each
        given link would measure: for sensor link s, the world-frame
        wrench (about the world origin, [force; moment] like the
        floating-base rows) generated by the links in subtree(s). A
        sensor on the root link of a floating-base model reproduces the
        base-wrench rows exactly.

        Frame choice does not matter for identifiability analysis — the
        sensor-local wrench differs by an invertible 6x6 transform, which
        preserves the row space. Used by the sensor-placement study
        (the reference documents the analogous analysis in
        documentation/design_notes.md:104-110: each added F/T recovers
        ~3 null directions on the walkman).

        sensor_links: static tuple/list of link indices.
        Returns (6*S, 10L)."""
        floating = base_rot is not None
        base_rot, base_vel, base_acc = self._default_base(
            q.dtype, base_rot, base_vel, base_acc
        )
        Rw, pw, s, V, A, mask = self._world_kinematics(
            q, dq, ddq, base_rot, base_vel, base_acc
        )
        w, vl, alpha, al = self._body_frame_va(Rw, pw, V, A)
        blk = self._link_regressor_blocks(w, vl, alpha, al)
        Fw = self._force_to_world(Rw, pw, blk)  # (L,6,10), [moment; force]
        Fw_fm = jnp.concatenate([Fw[:, 3:, :], Fw[:, :3, :]], axis=1)
        sub = jnp.asarray(
            self.subtree_mask[np.asarray(sensor_links, dtype=int)], dtype=q.dtype
        )  # (S, L)
        out = jnp.einsum("sl,ldc->sdlc", sub, Fw_fm)  # (S,6,L,10)
        return out.reshape(len(sensor_links) * 6, self.num_links * 10)

    def _default_base(self, dtype, base_rot, base_vel, base_acc):
        if base_rot is None:
            base_rot = jnp.eye(3, dtype=dtype)
        if base_vel is None:
            base_vel = jnp.zeros(6, dtype=dtype)
        if base_acc is None:
            base_acc = jnp.zeros(6, dtype=dtype)
        return base_rot, base_vel, base_acc

    @_full_precision
    def inverse_dynamics(
        self,
        pi,
        q,
        dq,
        ddq,
        base_rot=None,
        base_vel=None,
        base_acc=None,
        floating: bool | None = None,
    ):
        """RNEA joint torques (+ base wrench when floating).

        pi: (10L,) standard parameters. Computed from explicit spatial
        inertias (I a + v x* I v), NOT via the regressor, so the
        `regressor @ pi == inverse_dynamics` identity is a real
        cross-check between two formulations.
        """
        if floating is None:
            floating = base_rot is not None
        base_rot, base_vel, base_acc = self._default_base(
            q.dtype, base_rot, base_vel, base_acc
        )
        Rw, pw, s, V, A, mask = self._world_kinematics(
            q, dq, ddq, base_rot, base_vel, base_acc
        )
        w, vl, alpha, al = self._body_frame_va(Rw, pw, V, A)
        p10 = pi.reshape(self.num_links, 10)
        I6 = sp.inertia_matrix_from_params(p10)  # (L,6,6)
        vb = jnp.concatenate([w, vl], axis=-1)
        ab = jnp.concatenate([alpha, al], axis=-1)
        f = jnp.einsum("lij,lj->li", I6, ab) + sp.crf(
            vb, jnp.einsum("lij,lj->li", I6, vb)
        )
        Fw = self._force_to_world(Rw, pw, f[..., None])  # (L,6,1)
        out = self._assemble_rows(s, mask, Fw, floating)  # (rows, L, 1)
        return jnp.sum(out[..., 0], axis=1)

    def __hash__(self):  # allow use as a static arg / closure in jit
        return id(self)

    def __eq__(self, other):
        return self is other

    # ------------------------------------------------------------------
    # batched APIs (vmap over the sample axis)
    # ------------------------------------------------------------------
    def regressor_batch(self, Q, DQ, DDQ, base_rot=None, base_vel=None, base_acc=None):
        """Batched regressor. Q/DQ/DDQ: (N,n); base args (N,...) or None.

        Returns (N, rows, 10L)."""
        if base_rot is None:
            return jax.vmap(lambda q, dq, ddq: self.regressor(q, dq, ddq))(Q, DQ, DDQ)
        return jax.vmap(self.regressor)(Q, DQ, DDQ, base_rot, base_vel, base_acc)

    def inverse_dynamics_batch(
        self, pi, Q, DQ, DDQ, base_rot=None, base_vel=None, base_acc=None
    ):
        if base_rot is None:
            return jax.vmap(lambda q, dq, ddq: self.inverse_dynamics(pi, q, dq, ddq))(
                Q, DQ, DDQ
            )
        return jax.vmap(
            lambda q, dq, ddq, br, bv, ba: self.inverse_dynamics(
                pi, q, dq, ddq, br, bv, ba
            )
        )(Q, DQ, DDQ, base_rot, base_vel, base_acc)

    # ------------------------------------------------------------------
    # derived quantities
    # ------------------------------------------------------------------
    @_full_precision
    def mass_matrix(self, pi, q, base_rot=None, floating: bool = False):
        """Joint-space (n x n) or free-floating mixed ((6+n) x (6+n))
        mass matrix via vmapped unit-acceleration inverse dynamics
        (replaces iDynTree getFreeFloatingMassMatrix, used by the
        reference's suspended-base simulation, suspendedDynamics.py:130)."""
        dtype = q.dtype
        n = self.num_dofs
        zero_g = DynamicsEngine.__new__(DynamicsEngine)
        zero_g.__dict__ = {**self.__dict__, "gravity": np.zeros(3)}
        if floating:
            base_rot = jnp.eye(3, dtype=dtype) if base_rot is None else base_rot
            dim = 6 + n

            def col(k):
                ba = (jnp.arange(6) == k).astype(dtype)
                dd = (jnp.arange(n) == (k - 6)).astype(dtype)
                return zero_g.inverse_dynamics(
                    pi,
                    q,
                    jnp.zeros(n, dtype=dtype),
                    dd,
                    base_rot,
                    jnp.zeros(6, dtype=dtype),
                    ba,
                )

            return jax.vmap(col)(jnp.arange(dim)).T
        else:

            def col(k):
                dd = jnp.zeros(n, dtype=dtype).at[k].set(1.0)
                return zero_g.inverse_dynamics(
                    pi, q, jnp.zeros(n, dtype=dtype), dd, floating=False
                )

            return jax.vmap(col)(jnp.arange(n)).T

    @_full_precision
    def bias_forces(self, pi, q, dq, base_rot=None, base_vel=None, floating=False):
        """Coriolis + gravity generalized forces (zero-acceleration ID)."""
        dtype = q.dtype
        if floating:
            return self.inverse_dynamics(
                pi,
                q,
                dq,
                jnp.zeros(self.num_dofs, dtype=dtype),
                base_rot,
                base_vel,
                jnp.zeros(6, dtype=dtype),
            )
        return self.inverse_dynamics(
            pi, q, dq, jnp.zeros(self.num_dofs, dtype=dtype), floating=False
        )

    @_full_precision
    def frame_jacobian(self, link_index: int, q, base_rot=None):
        """Mixed free-floating frame Jacobian (6 x (6+n)): rows
        [linear; angular] in world coords at the frame origin, columns
        [mixed base velocity; joint velocities]. Replaces iDynTree
        getFrameFreeFloatingJacobian (reference model.py:535-545)."""
        dtype = q.dtype
        base_rot = jnp.eye(3, dtype=dtype) if base_rot is None else base_rot
        Rb, pb = self.fk(q)
        Rw = base_rot @ Rb
        pw = (base_rot @ pb[..., None])[..., 0]
        pf = pw[link_index]
        dl = self.mjoint_link
        ax_w = jnp.einsum("dij,dj->di", Rw[dl], jnp.asarray(self.axis[dl], dtype=dtype))
        is_rev = jnp.asarray(self.jtype[dl] == 1, dtype=dtype)[:, None]
        mask = jnp.asarray(self.ancestor_mask[link_index], dtype=dtype)[:, None]
        lin = mask * (is_rev * jnp.cross(ax_w, pf - pw[dl]) + (1.0 - is_rev) * ax_w)
        ang = mask * (is_rev * ax_w)
        Jq = jnp.concatenate([lin.T, ang.T], axis=0)  # (6,m)
        if self.has_mimic:
            # chain rule through q_m = mult*q[src]: columns of mimic
            # joints fold into their source dof's column
            Jq = Jq @ jnp.asarray(self.dof_project, dtype=dtype).T
        eye = jnp.eye(3, dtype=dtype)
        zero = jnp.zeros((3, 3), dtype=dtype)
        Jb = jnp.concatenate(
            [
                jnp.concatenate([eye, -sp.skew(pf)], axis=1),
                jnp.concatenate([zero, eye], axis=1),
            ],
            axis=0,
        )
        return jnp.concatenate([Jb, Jq], axis=1)

    @_full_precision
    def frame_velocity(self, link_index: int, q, dq, base_rot, base_vel):
        """Mixed frame velocity [linear; angular] in world coords."""
        J = self.frame_jacobian(link_index, q, base_rot)
        nu = jnp.concatenate([base_vel, dq])
        return J @ nu

    def total_mass(self, pi):
        return jnp.sum(pi.reshape(self.num_links, 10)[:, 0])

    @_full_precision
    def com_world(self, pi, q, base_rot=None):
        """Overall center of mass in world coords."""
        dtype = q.dtype
        base_rot = jnp.eye(3, dtype=dtype) if base_rot is None else base_rot
        Rb, pb = self.fk(q)
        Rw = base_rot @ Rb
        pw = (base_rot @ pb[..., None])[..., 0]
        p10 = pi.reshape(self.num_links, 10)
        h_w = jnp.einsum("lij,lj->li", Rw, p10[:, 1:4]) + p10[:, 0:1] * pw
        return jnp.sum(h_w, axis=0) / jnp.maximum(jnp.sum(p10[:, 0]), 1e-12)


def rpy_to_base_rot(rpy):
    """npz `base_rpy` to world_R_base, matching the reference's storage
    convention `Transform(RPY(rpy), 0).inverse() == world_T_base`
    (reference: identification/model.py:268-275,
    excitation/suspendedDynamics.py:176-182): world_R_base = RPY(rpy)^T."""
    return jnp.swapaxes(sp.rpy_to_rot(rpy), -1, -2)


def rpy_to_base_rot_np(rpy):
    """Host (numpy) variant of rpy_to_base_rot — the staging path calls
    this on host arrays; the jnp version would cost a device dispatch +
    fetch round-trip per dataset. Shares the
    ONE convention definition in spatial._rpy_to_rot_impl."""
    rpy = np.asarray(rpy, dtype=float)
    return np.swapaxes(sp._rpy_to_rot_impl(rpy, np), -1, -2)
