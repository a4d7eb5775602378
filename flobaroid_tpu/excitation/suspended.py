"""Suspended-base (crane ball-joint) dynamics.

Counterpart of the reference's excitation/suspendedDynamics.py:21-293:
a robot hangs from a ball joint at `attachment_frame` (free rotation,
pinned translation); per time step the attachment's angular
acceleration is solved from the Newton-Euler moment balance about the
attachment point with implicit viscous damping, integrated by
semi-implicit Euler with a soft +-25 deg swing clamp, and the
identification base link's pose/velocity series is derived by forward
kinematics.

Device-first: instead of re-rooting the model (iDynTree setFloatingBase),
the moment balance is formed directly in world-origin Plücker
coordinates from the root-based engine:

    moment about attachment  n_a(alpha) = A alpha + n0

with n0 from one inverse-dynamics pass (alpha = 0; includes gravity,
joint accelerations, velocity products) and A from three vmapped
unit-alpha passes. The whole trajectory integrates in one lax.scan,
and everything is differentiable.

Conventions (matching the reference):
  * att_rpy parametrizes world_R_attachment = RPY(att_rpy) directly
    (suspendedDynamics.py:136-140 uses Transform WITHOUT inverse),
  * the returned base_rpy series uses the npz storage convention
    world_R_base = RPY(rpy)^T (suspendedDynamics.py:176-182),
  * base_velocity is the mixed twist [linear; angular] of the base
    link frame, base_acceleration its central-difference derivative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..dynamics import spatial as sp
from ..dynamics.engine import DynamicsEngine
from ..models.urdf import RobotTree


def euler_map_direct(rpy):
    """E with omega_world = E @ rpy_dot for R = RPY(rpy) (no transpose)."""

    def omega(rd):
        _, Rd = jax.jvp(sp.rpy_to_rot, (rpy,), (rd,))
        W = Rd @ sp.rpy_to_rot(rpy).T
        return sp.unskew(0.5 * (W - W.T))

    return jax.jacobian(omega)(jnp.zeros_like(rpy))


def angular_velocity_to_rpy_rates(rpy, omega):
    return jnp.linalg.solve(euler_map_direct(rpy), omega)


class SuspendedSimulator:
    def __init__(
        self,
        tree: RobotTree,
        attachment_frame: str,
        base_link: str | None = None,
        damping: float = 500.0,
        pi: np.ndarray | None = None,
        max_swing_deg: float = 25.0,
    ):
        self.engine = DynamicsEngine(tree)
        if self.engine.has_mimic:
            # this integrator indexes motion subspaces per DOF; folding
            # mimic columns here is untested — fail loudly, never wrong
            raise NotImplementedError(
                "suspended-base simulation does not support mimic joints"
            )
        if attachment_frame not in tree.link_index:
            raise ValueError(f"attachment frame '{attachment_frame}' not in model links")
        self.att = tree.link_index[attachment_frame]
        self.bl = tree.link_index[base_link] if base_link else tree.root
        self.damping = float(damping)
        self.pi = jnp.asarray(pi if pi is not None else tree.std_params())
        self.max_swing = float(np.deg2rad(max_swing_deg))

    # ------------------------------------------------------------------
    def _root_state(self, q, att_rpy, att_omega, dq):
        """Root-link pose/velocity consistent with the attachment state."""
        eng = self.engine
        R_wa = sp.rpy_to_rot(att_rpy)
        Rb, pb = eng.fk(q)
        R_wr = R_wa @ Rb[self.att].T
        pw = jnp.einsum("ij,lj->li", R_wr, pb)
        p_a = pw[self.att]
        # motion subspaces in world-origin coords (root pinned at origin)
        dl = eng.dof_link
        Rw = R_wr @ Rb
        ax_w = jnp.einsum("dij,dj->di", Rw[dl], jnp.asarray(eng.axis[dl], q.dtype))
        is_rev = jnp.asarray(eng.jtype[dl] == 1, q.dtype)[:, None]
        s = jnp.concatenate(
            [is_rev * ax_w, is_rev * jnp.cross(pw[dl], ax_w) + (1 - is_rev) * ax_w],
            axis=-1,
        )
        mask = jnp.asarray(eng.ancestor_mask, q.dtype)
        # attachment spatial velocity (world origin): [omega_a; -omega_a x p_a]
        v_a = jnp.concatenate([att_omega, -jnp.cross(att_omega, p_a)])
        v_r = v_a - (mask[self.att] * dq) @ s
        return R_wr, pw, p_a, s, mask, v_r

    def _moment_about_attachment(self, q, dq, ddq, R_wr, v_r, p_a, alpha, s, mask):
        """Inverse dynamics with attachment angular acceleration `alpha`;
        returns the moment of the required wrench about the attachment."""
        eng = self.engine
        # attachment spatial acceleration: [alpha; -alpha x p_a]
        a_a = jnp.concatenate([alpha, -jnp.cross(alpha, p_a)])
        # subtract joint contributions along the path to get root spatial acc
        # a_r = a_a - sum_j (s_j ddq_j + (v_{child(j)} x s_j) dq_j)
        dl = eng.dof_link
        V = v_r + mask @ (s * dq[:, None])
        u = s * ddq[:, None] + sp.crm(V[dl], s) * dq[:, None]
        a_r = a_a - (mask[self.att][:, None] * u).sum(0)
        # convert spatial root vel/acc to the engine's mixed interface
        w_r = v_r[:3]
        vlin_mixed = v_r[3:]  # root at origin: v(0) == spatial linear
        a_lin_mixed = a_r[3:] + jnp.cross(w_r, vlin_mixed)
        base_vel = jnp.concatenate([vlin_mixed, w_r])
        base_acc = jnp.concatenate([a_lin_mixed, a_r[:3]])
        out = eng.inverse_dynamics(
            self.pi.astype(q.dtype), q, dq, ddq, R_wr, base_vel, base_acc
        )
        f, n_O = out[:3], out[3:6]
        return n_O - jnp.cross(p_a, f)

    def _locked_attachment_inertia(self, q, R_wr, pw, p_a):
        """Closed-form alpha-response matrix A: the moment about the
        attachment is AFFINE in the attachment angular acceleration
        (n(alpha) = n0 + A alpha with q, dq, ddq held fixed — a unit
        alpha rigidly accelerates the WHOLE mechanism about the
        attachment point), so A is the composite rigid-body angular
        inertia about the attachment:
            A = I_tot(O) + p h^T + h p^T - 2 (h.p) E - m_tot (p p^T - |p|^2 E)
        with (m_tot, h, I_tot) the total mass / first moment / rotational
        inertia at the WORLD ORIGIN and p = p_a. Replaces three full
        unit-alpha RNEA sweeps per integration step (the AL refinement
        backprops through every step; the RNEA tape was ~3/4 of the
        integrator's cost). Parity with the RNEA construction is
        asserted in tests/test_suspended.py."""
        eng = self.engine
        dt_ = q.dtype
        P = self.pi.astype(dt_).reshape(-1, 10)
        m = P[:, 0]
        h_l = P[:, 1:4]
        ixx, ixy, ixz, iyy, iyz, izz = (P[:, 4 + k] for k in range(6))
        I_l = jnp.stack([
            jnp.stack([ixx, ixy, ixz], -1),
            jnp.stack([ixy, iyy, iyz], -1),
            jnp.stack([ixz, iyz, izz], -1),
        ], -2)  # (L, 3, 3) about the link frame
        Rb, _ = eng.fk(q)
        Rw = jnp.einsum("ij,ljk->lik", R_wr, Rb)
        Iw = jnp.einsum("lab,lbc,ldc->lad", Rw, I_l, Rw)
        hw = jnp.einsum("lab,lb->la", Rw, h_l)  # first moment about o_l
        o = pw
        E = jnp.eye(3, dtype=dt_)
        # translate each link's rotational inertia from its origin o_l
        # to the world origin: I_O = I_o + (h.d + d.h) E - d h^T - h d^T
        # + m (|d|^2 E - d d^T), d = o_l  (S(a)S(b)^T = (a.b)E - b a^T)
        hd = jnp.einsum("la,la->l", hw, o)
        dd = jnp.einsum("la,la->l", o, o)
        I_O = (
            Iw
            + (2.0 * hd + m * dd)[:, None, None] * E
            - jnp.einsum("la,lb->lab", o, hw)
            - jnp.einsum("la,lb->lab", hw, o)
            - m[:, None, None] * jnp.einsum("la,lb->lab", o, o)
        )
        I_tot = jnp.sum(I_O, axis=0)
        h_tot = jnp.sum(hw + m[:, None] * o, axis=0)
        m_tot = jnp.sum(m)
        p = p_a
        hp = h_tot @ p
        return (
            I_tot
            + jnp.outer(p, h_tot) + jnp.outer(h_tot, p) - 2.0 * hp * E
            - m_tot * (jnp.outer(p, p) - (p @ p) * E)
        )

    def _step_dynamics(self, q, dq, ddq, att_rpy, att_omega, dt):
        """Solve (A + c*dt*I) alpha = -n0 - c*omega (implicit damping)."""
        R_wr, pw, p_a, s, mask, v_r = self._root_state(q, att_rpy, att_omega, dq)
        n0 = self._moment_about_attachment(
            q, dq, ddq, R_wr, v_r, p_a, jnp.zeros(3, q.dtype), s, mask
        )
        eye = jnp.eye(3, dtype=q.dtype)
        A = self._locked_attachment_inertia(q, R_wr, pw, p_a)
        c = self.damping
        alpha = jnp.linalg.solve(A + c * dt * eye, -n0 - c * att_omega)
        return alpha, R_wr, pw, p_a, s, mask, v_r

    def simulate_core(self, positions, velocities, accelerations, att_rpy0, dt):
        """Traced ball-joint integration (jit/grad/vmap-safe).

        Returns (base_rpy (N,3), base_position (N,3), base_velocity (N,6))
        as traced arrays; acceleration differentiation and the
        equilibrium search live in the host wrapper `simulate`."""
        eng = self.engine
        bl = self.bl

        def body(carry, xs):
            att_rpy, att_omega = carry
            q, dq, ddq = xs
            alpha, R_wr, pw, p_a, s, mask, v_r = self._step_dynamics(
                q, dq, ddq, att_rpy, att_omega, dt
            )
            # base link outputs (before integrating, like the reference)
            Rb, pb = eng.fk(q)
            R_w_bl = R_wr @ Rb[bl]
            rpy_bl = sp.rot_to_rpy(R_w_bl.T)  # storage convention: inverse
            pos_bl = pw[bl] - p_a  # attachment pinned at world origin
            v_bl = v_r + (mask[bl][:, None] * (s * dq[:, None])).sum(0)
            lin = v_bl[3:] + jnp.cross(v_bl[:3], pw[bl])
            vel_bl = jnp.concatenate([lin, v_bl[:3]])

            # semi-implicit Euler + soft swing clamp with elastic bounce
            att_omega = att_omega + alpha * dt
            rpy_dot = angular_velocity_to_rpy_rates(att_rpy, att_omega)
            att_rpy = att_rpy + rpy_dot * dt
            over = att_rpy > self.max_swing
            under = att_rpy < -self.max_swing
            # outward motion is judged in rpy-rate space (rpy_dot), not
            # world angular velocity: with nonzero yaw the E(rpy) map is
            # non-diagonal, and an att_omega-sign test could keep pushing
            # outward without ever triggering the bounce (pose stuck at
            # the clamp)
            att_omega = jnp.where(over & (rpy_dot > 0), -0.3 * att_omega, att_omega)
            att_omega = jnp.where(under & (rpy_dot < 0), -0.3 * att_omega, att_omega)
            att_rpy = jnp.clip(att_rpy, -self.max_swing, self.max_swing)
            return (att_rpy, att_omega), (rpy_bl, pos_bl, vel_bl)

        (_, _), (rpy_s, pos_s, vel_s) = jax.lax.scan(
            body,
            (jnp.asarray(att_rpy0, positions.dtype), jnp.zeros(3, positions.dtype)),
            (positions, velocities, accelerations),
        )
        return rpy_s, pos_s, vel_s

    @staticmethod
    def acceleration_from_velocity(vel_s, dt):
        """Central-difference base acceleration (traced-friendly)."""
        v = vel_s
        inner = (v[2:] - v[:-2]) / (2 * dt)
        first = (v[1:2] - v[0:1]) / dt
        last = (v[-1:] - v[-2:-1]) / dt
        return jnp.concatenate([first, inner, last], axis=0)

    def simulate(self, positions, velocities, accelerations, times, initial_rpy=None):
        """Run the ball-joint integration over the whole trajectory.

        Returns (base_rpy (N,3), base_velocity (N,6), base_acceleration
        (N,6), base_position (N,3)) — same contract as the reference
        (suspendedDynamics.py:21-232). initial_rpy overrides the static
        equilibrium start (used by tests)."""
        positions = jnp.asarray(positions)
        velocities = jnp.asarray(velocities)
        accelerations = jnp.asarray(accelerations)
        times = np.asarray(times)
        N = positions.shape[0]
        dt = float(times[1] - times[0]) if N > 1 else 1.0 / 200.0

        if initial_rpy is None:
            att_rpy0 = self.find_equilibrium_rpy(np.asarray(positions[0]))
        else:
            att_rpy0 = np.asarray(initial_rpy, dtype=float)

        if getattr(self, "_sim_core_jit", None) is None:
            # cached jit: the eager path dispatches the pre-scan ops
            # one-by-one through the (possibly remote) default device
            self._sim_core_jit = jax.jit(self.simulate_core)
        rpy_s, pos_s, vel_s = self._sim_core_jit(
            positions, velocities, accelerations, jnp.asarray(att_rpy0, positions.dtype), dt
        )
        base_velocity = np.asarray(vel_s)
        base_acceleration = np.asarray(self.acceleration_from_velocity(vel_s, dt))
        return np.asarray(rpy_s), base_velocity, base_acceleration, np.asarray(pos_s)

    # ------------------------------------------------------------------
    def _equilibrium_descend(self):
        """Jitted equilibrium descent, built once per simulator (a fresh
        jit closure per call would recompile every call; q0 and the
        tolerances are traced arguments)."""
        if getattr(self, "_descend_fn", None) is None:
            nd = self.engine.num_dofs
            step = 1.0 / 700.0
            lim = np.deg2rad(30)

            def moment(q0, att_rpy):
                zero = jnp.zeros(nd, dtype=q0.dtype)
                R_wr, pw, p_a, s, mask, v_r = self._root_state(
                    q0, att_rpy, jnp.zeros(3, q0.dtype), zero
                )
                return self._moment_about_attachment(
                    q0, zero, zero, R_wr, v_r, p_a, jnp.zeros(3, q0.dtype), s, mask
                )

            def descend(q0, rpy0, max_iterations, tol):
                # whole descent in ONE dispatch (a host loop pays a
                # device round-trip per iteration)
                def cond(carry):
                    rpy, it, nrm = carry
                    return (it < max_iterations) & (nrm >= tol)

                def body(carry):
                    rpy, it, _ = carry
                    n = moment(q0, rpy)
                    nrm = jnp.linalg.norm(n)
                    rpy = jnp.clip(rpy - step * n, -lim, lim)
                    return (rpy, it + 1, nrm)

                n0 = jnp.linalg.norm(moment(q0, rpy0))
                rpy, _, _ = jax.lax.while_loop(cond, body, (rpy0, 0, n0))
                return rpy

            self._descend_fn = jax.jit(descend)
        return self._descend_fn

    def find_equilibrium_rpy(self, q0, max_iterations=200, tol=0.01):
        """Static equilibrium attachment orientation: descend the gravity
        moment about the attachment (reference suspendedDynamics.py:235-293)."""
        q0 = jnp.asarray(q0, jnp.result_type(float))
        return np.asarray(
            self._equilibrium_descend()(
                q0, jnp.zeros(3, q0.dtype), max_iterations, float(tol)
            )
        )


def simulate_suspended_base_motion(
    urdf_file_or_tree,
    positions,
    velocities,
    accelerations,
    times,
    attachment_frame: str = "crane_ft",
    base_link: str | None = None,
    damping: float = 500.0,
):
    """Functional wrapper matching the reference's signature
    (suspendedDynamics.py:21)."""
    from ..models.urdf import load_urdf

    tree = (
        urdf_file_or_tree
        if isinstance(urdf_file_or_tree, RobotTree)
        else load_urdf(urdf_file_or_tree)
    )
    sim = SuspendedSimulator(tree, attachment_frame, base_link, damping)
    return sim.simulate(positions, velocities, accelerations, times)
