"""Differentiable excitation-trajectory objective.

Counterpart of the reference's TrajectoryOptimizer.objectiveFunc
(excitation/trajectoryOptimizer.py:220-554): regularized D-optimality
of the base regressor Gram, soft quality costs (torque-utilization
balance and magnitude, position-range use, per-joint peak-velocity
target, x10 each) and hard limit constraints (position with
ovrPosLimit overrides, |velocity|, |torque|, optional minimum velocity
and torque-utilization), plus a hook for collision-distance
constraints.

Device-first: the whole chain Fourier params -> (q, dq, ddq) -> batched
regressor -> Gram -> eigvalsh -> objective/constraints is ONE jitted
differentiable function. jax.grad through it replaces the reference's
1032-line finite-difference gradient machinery
(excitation/analyticalGradient.py) and its multiprocessing pool; vmap
over candidate vectors replaces the Optuna worker processes
(excitation/optimizer.py:52-147).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from ..model import Model
from .trajectory import FourierSpec, fourier_traj


class TrajectoryObjective:
    def __init__(
        self,
        model: Model,
        config: dict,
        spec: FourierSpec,
        duration: float | None = None,
        yty_prior: np.ndarray | None = None,
        extra_constraints_fn: Callable | None = None,
        n_extra_constraints: int | None = None,
        dtype=jnp.float32,
    ):
        self.model = model
        self.config = config
        self.spec = spec
        self.dtype = dtype
        eng = model.engine
        nd = model.num_dofs
        freq = float(config["excitationFrequency"])
        # sample one period of the slowest allowed pulsation unless fixed
        if duration is None:
            duration = 2 * np.pi / float(config.get("trajectoryPulseMin", 0.3))
        self.num_samples = max(int(duration * freq), 16)
        self.times = np.arange(self.num_samples) / freq

        jn = model.jointNames
        lims = model.limits
        ovr = config.get("ovrPosLimit", {}) or {}
        lo, hi = [], []
        for name in jn:
            pair = ovr.get(name)
            if pair:
                lo.append(np.deg2rad(pair[0]))
                hi.append(np.deg2rad(pair[1]))
            else:
                lo.append(lims[name]["lower"])
                hi.append(lims[name]["upper"])
        self.pos_lo = np.asarray(lo)
        self.pos_hi = np.asarray(hi)
        self.vel_lim = np.asarray([lims[n]["velocity"] for n in jn])
        self.tau_lim = np.asarray([lims[n]["torque"] for n in jn])

        self.Pb = np.asarray(model.B if config["useBasisProjection"] else model.Pb)
        self.pi_urdf = np.asarray(model.xStdModel[: model.num_model_params])
        self.yty_prior = yty_prior
        self.extra_constraints_fn = extra_constraints_fn
        # constraint-shift knob: a traced ARGUMENT added to the extra
        # (collision) constraint values, so margin inflation during
        # mesh-backoff recovery re-dispatches the SAME compiled chain
        # instead of retracing the whole D-opt pipeline (a multi-minute
        # compile at 30 DOF). Shape is fixed up front
        # (n_extra_constraints, or a broadcastable scalar) so later
        # set_extra_shift calls never change the traced shape.
        self._extra_shift = (
            np.zeros(n_extra_constraints, dtype=np.float64)
            if n_extra_constraints
            else np.float64(0.0)
        )
        self.fb = model.fb
        self.floating = bool(config["floatingBase"])

        # suspended base inside the objective (walkman_full scenario,
        # reference trajectoryGenerator.py:172-187): the ball-joint scan
        # runs traced as part of the differentiable chain; the
        # equilibrium start orientation is computed once at build time
        # (the reference re-searches per candidate on the host)
        self.suspended = None
        self._att_rpy0 = None
        if self.floating and config.get("floatingBaseAttachment") == "suspended":
            from .suspended import SuspendedSimulator

            self.suspended = SuspendedSimulator(
                model.tree,
                config.get("floatingBaseAttachmentFrame", "crane_ft"),
                damping=float(config.get("suspendedDamping", 2000.0)),
            )
            self._att_rpy0 = self.suspended.find_equilibrium_rpy(
                np.zeros(model.num_dofs)
            )
        # reference key: minTorqueUtilization (trajectoryOptimizer.py:135,
        # hard constraint, default 0.02 in the reference configs); the
        # minTorqueConstraint/minTorquePercentage pair is this repo's
        # explicit-gate spelling and still works
        mtu = config.get("minTorqueUtilization", None)
        if mtu is not None:
            self.min_torque_util = float(mtu)
        else:
            self.min_torque_util = (
                float(config.get("minTorquePercentage", 0.1))
                if config.get("minTorqueConstraint", 0)
                else 0.0
            )
        # minVelocityPercentage accepts a dict {jointName: fraction} for
        # per-joint HARD velocity floors (beyond the reference's scalar,
        # trajectoryOptimizer.py:318-323) — the reliable lever for
        # weakly-excited joints' friction identifiability
        mv = (
            config.get("minVelocityPercentage", 0.1)
            if config.get("minVelocityConstraint", 0)
            else 0.0
        )
        if isinstance(mv, dict):
            self.min_vel = np.array(
                [float(mv.get(j, 0.0)) for j in model.jointNames]
            )
        else:
            self.min_vel = float(mv)
        self._dopt_scale = None
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        eng = self.model.engine
        nd = self.model.num_dofs
        dt = self.dtype
        times = jnp.asarray(self.times, dtype=dt)
        Pb = jnp.asarray(self.Pb, dtype=dt)
        pi = jnp.asarray(self.pi_urdf, dtype=dt)
        pos_lo = jnp.asarray(self.pos_lo, dt)
        pos_hi = jnp.asarray(self.pos_hi, dt)
        vel_lim = jnp.asarray(self.vel_lim, dt)
        tau_lim = jnp.asarray(self.tau_lim, dt)
        delta_frac = jnp.asarray(float(self.config.get("doptRegularization", 1e-4)), dt)
        # per-joint excitation targets (VERDICT r2 #4/#5; beyond the
        # reference, whose targets are scalars,
        # trajectoryOptimizer.py:445-482): a dict {jointName: value}
        # drives weakly-excited joints individually — the lever for the
        # 30-DOF friction-recovery error on barely-moving joints
        names = list(self.model.jointNames)
        tu_cfg = self.config.get("trajectoryTargetTorqueUtil", 0.25)
        vt_cfg = self.config.get("trajectoryTargetVelocity", 0.0)
        per_joint_util = isinstance(tu_cfg, dict)
        if per_joint_util:
            target_util = jnp.asarray(
                [float(tu_cfg.get(j, 0.25)) for j in names], dt
            )
        else:
            target_util = float(tu_cfg)
        per_joint_vel = isinstance(vt_cfg, dict)
        if per_joint_vel:
            vel_target = jnp.asarray(
                [float(vt_cfg.get(j, 0.0)) for j in names], dt
            )
            vel_target_on = bool(np.any(np.asarray(vel_target) > 0))
        else:
            vel_target = float(vt_cfg)
            vel_target_on = vel_target > 0
        fric = bool(self.config["identifyFrictionSimultaneously"])
        sign_thresh = float(self.config.get("frictionSignThreshold", 0.02))
        sym = bool(self.config["identifySymmetricVelFriction"])
        grav_only = bool(self.config["identifyGravityParamsOnly"])
        stribeck_v = float(self.config.get("stribeckVelocity", 0) or 0)
        keep_grav = (
            jnp.asarray([p for p in range(10 * self.model.num_links) if p % 10 < 4])
            if grav_only else None
        )
        yty_prior = (
            jnp.asarray(self.yty_prior, dt) if self.yty_prior is not None else None
        )
        floating = self.floating
        fbr = 6 if floating else 0
        extra_fn = self.extra_constraints_fn
        extra_takes_base = False
        if extra_fn is not None:
            import inspect

            try:
                extra_takes_base = (
                    len(inspect.signature(extra_fn).parameters) >= 3
                )
            except (TypeError, ValueError):
                extra_takes_base = False

        suspended = self.suspended
        att_rpy0 = (
            jnp.asarray(self._att_rpy0, dt) if self._att_rpy0 is not None else None
        )
        dt_samp = float(self.times[1] - self.times[0])

        def raw(x, extra_shift):
            # the whole chain (base projection Yf @ Pb, Gram power
            # iteration, suspended-base integrator) must trace with
            # true-f32 matmuls: reduced-precision matmul inputs (TF32 on
            # GPUs, ~3 decimal digits) bury the Gram's small eigenvalues
            # in noise, corrupting -logdet and its gradient (engine dots
            # are guarded by dynamics.engine._full_precision, these are
            # not)
            with jax.default_matmul_precision("highest"):
                return _raw_inner(x, extra_shift)

        def _raw_inner(x, extra_shift):
            Q, V, A = fourier_traj(self.spec, x.astype(dt), times)
            if floating:
                N = Q.shape[0]
                if suspended is not None:
                    rpy_s, pos_s, vel_s = suspended.simulate_core(Q, V, A, att_rpy0, dt_samp)
                    acc_s = suspended.acceleration_from_velocity(vel_s, dt_samp)
                    # storage convention: world_R_base = RPY(rpy)^T
                    from ..dynamics import spatial as sp

                    BR = jnp.swapaxes(sp.rpy_to_rot(rpy_s), -1, -2)
                    BV = vel_s
                    BA = acc_s
                else:
                    BR = jnp.broadcast_to(jnp.eye(3, dtype=dt), (N, 3, 3))
                    BV = jnp.zeros((N, 6), dt)
                    BA = jnp.zeros((N, 6), dt)
                Y = eng.regressor_batch(Q, V, A, BR, BV, BA)
            else:
                Y = eng.regressor_batch(Q, V, A)
            # torques from the FULL inertial block (before any
            # gravity-only column subsetting)
            tau = jnp.einsum(
                "nrp,p->nr", Y[:, :, : pi.shape[0]], pi,
                precision=jax.lax.Precision.HIGHEST,
            )
            if grav_only:
                Y = Y[:, :, keep_grav]
            if fric:
                # smooth (differentiable) mirror of the model's
                # identified-column layout (model._friction_block_names):
                # Fc [, Fv(|±), off [, Fs]] — gravity-only keeps Fc only.
                # Column COUNT must match Pb's rows exactly
                sgn = jnp.tanh(V / sign_thresh)
                eye = jnp.eye(nd, dtype=dt)
                blocks = [sgn[:, None, :] * eye]
                if not grav_only:
                    if sym:
                        blocks.append(V[:, None, :] * eye)
                    else:
                        blocks.append(jnp.where(V > 0, V, 0)[:, None, :] * eye)
                        blocks.append(jnp.where(V < 0, V, 0)[:, None, :] * eye)
                    blocks.append(
                        jnp.broadcast_to(eye, V.shape[:1] + (nd, nd))
                    )
                    if stribeck_v > 0:
                        blocks.append(
                            (jnp.exp(-jnp.abs(V) / stribeck_v) * sgn)[:, None, :] * eye
                        )
                F = jnp.concatenate(blocks, axis=2)
                if fbr:
                    F = jnp.concatenate([jnp.zeros((F.shape[0], fbr, F.shape[2]), dt), F], axis=1)
                Y = jnp.concatenate([Y, F], axis=2)
            P = Y.shape[-1]
            Yf = Y.reshape(-1, P)
            YB = Yf @ Pb
            G = jnp.einsum("mp,mq->pq", YB, YB, precision=jax.lax.Precision.HIGHEST)
            if yty_prior is not None:
                G = G + yty_prior
            # regularized -logdet via Cholesky. eigvalsh (and especially its
            # gradient) is slow on accelerators; logdet(G + delta I) =
            # 2 sum log diag chol. lambda_max from a few power iterations
            # (stop_gradient: delta is a regularization scale, its parameter
            # sensitivity is negligible — the reference also treats the
            # gradient of delta as zero, CHANGELOG ~3-4 digit accuracy).
            nb = G.shape[0]
            v = jnp.ones((nb,), G.dtype) / jnp.sqrt(nb)

            def pw(v, _):
                w = G @ v
                return w / jnp.maximum(jnp.linalg.norm(w), 1e-30), None

            v, _ = jax.lax.scan(pw, v, None, length=16)
            # differentiable Rayleigh quotient (backprop through the short
            # power iteration is cheap and keeps the FD-gradient match)
            lam_max = jnp.maximum(v @ (G @ v), 1e-30)
            deltav = delta_frac * lam_max
            L = jnp.linalg.cholesky(G + deltav * jnp.eye(nb, dtype=G.dtype))
            neg_logdet = -2.0 * jnp.sum(jnp.log(jnp.maximum(jnp.diagonal(L), 1e-300)))
            n_observable = jnp.sum(jnp.diagonal(L) ** 2 > deltav)  # cheap proxy

            pos_min = jnp.min(Q, axis=0)
            pos_max = jnp.max(Q, axis=0)
            vel_absmax = jnp.max(jnp.abs(V), axis=0)
            tau_absmax = jnp.max(jnp.abs(tau[:, fbr:]), axis=0)

            g = [
                pos_lo - pos_min,
                pos_max - pos_hi,
                vel_absmax - vel_lim,
                tau_absmax - tau_lim,
            ]
            if np.any(np.asarray(self.min_vel) > 0):
                mv_arr = jnp.asarray(self.min_vel, vel_absmax.dtype)
                g.append(vel_lim * mv_arr - vel_absmax)
            if self.min_torque_util > 0:
                g.append(tau_lim * self.min_torque_util - tau_absmax)
            if extra_fn is not None:
                if extra_takes_base:
                    # pass the simulated (swung) base poses so collision
                    # constraints see the real world-frame link poses
                    # (reference trajectoryOptimizer.py:356-359)
                    if floating and suspended is not None:
                        ge = extra_fn(Q, BR, pos_s)
                    else:
                        ge = extra_fn(Q, None, None)
                else:
                    ge = extra_fn(Q)
                # traced shift (mesh-backoff margin inflation rides the
                # same compiled chain)
                g.append(ge + extra_shift.astype(ge.dtype))
            g = jnp.concatenate(g)

            # soft costs (reference trajectoryOptimizer.py:445-499)
            util = tau_absmax / tau_lim
            um = jnp.mean(util)
            f1 = jnp.where(um > 0, jnp.std(util) / jnp.maximum(um, 1e-9), 1.0)
            if per_joint_util:
                # each joint must individually reach its target
                f3 = jnp.mean(
                    jnp.maximum(0.0, 1.0 - util / jnp.maximum(target_util, 1e-9))
                )
            else:
                f3 = jnp.maximum(0.0, 1.0 - um / target_util)
            pos_util = (pos_max - pos_min) / (pos_hi - pos_lo)
            f2 = 1.0 - jnp.mean(pos_util)
            f4 = 0.0
            if vel_target_on:
                if per_joint_vel:
                    short = jnp.maximum(
                        0.0, 1.0 - vel_absmax / jnp.maximum(vel_target, 1e-9)
                    )
                    f4 = jnp.mean(jnp.where(vel_target > 0, short, 0.0))
                else:
                    f4 = jnp.mean(
                        jnp.maximum(0.0, 1.0 - vel_absmax / vel_target)
                    )
            return neg_logdet, f1, f2, f3, f4, g, n_observable

        # _raw MUST be jitted wherever it is actually called: evaluating
        # the traced chain eagerly dispatches every op separately, which
        # takes minutes for one calibrate_scale call at 30 DOF.
        self._raw = raw
        self._raw_jit = jax.jit(raw)

        def evaluate(x, dopt_scale, extra_shift):
            neg_logdet, f1, f2, f3, f4, g, n_obs = raw(x, extra_shift)
            f = neg_logdet * dopt_scale + 10.0 * (f1 + f3 + f4) + 10.0 * f2
            f = jnp.where(jnp.isfinite(f), f, 1e4)
            # preserve the SIGN of infinite constraint values: a joint
            # without a URDF limit yields vel_absmax - inf = -inf, an
            # infinitely-SATISFIED constraint — mapping it to +10 marked
            # every candidate infeasible for limit-less robots
            g = jnp.where(jnp.isnan(g), 10.0, jnp.clip(g, -1e6, 1e6))
            return f, g, n_obs

        self._evaluate = jax.jit(evaluate)
        # the whole population in one full-width vmap; under
        # shardCandidates the same function sees a sharded leading axis
        self._evaluate_batch = jax.jit(
            jax.vmap(evaluate, in_axes=(0, None, None))
        )

        def penalized(x, dopt_scale, weight, extra_shift):
            f, g, _ = evaluate(x, dopt_scale, extra_shift)
            return f + weight * jnp.sum(jnp.maximum(g, 0.0) ** 2) + weight * 0.1 * jnp.sum(
                jnp.maximum(g, 0.0)
            )

        self._penalized = jax.jit(penalized)
        self._penalized_grad = jax.jit(jax.value_and_grad(penalized))

        # whole Adam refinement as ONE jitted scan (a Python step loop
        # would pay a device round-trip per iteration)
        import optax

        def adam_run(x, lo, hi, dopt_scale, weight, extra_shift, lr, n_steps):
            opt = optax.adam(learning_rate=lr)
            state = opt.init(x)

            def step(carry, _):
                x, state = carry
                v, g = jax.value_and_grad(penalized)(
                    x, dopt_scale, weight, extra_shift
                )
                g = jnp.where(jnp.isfinite(g), g, 0.0)
                updates, state = opt.update(g, state)
                x = jnp.clip(x + updates, lo, hi)
                return (x, state), v

            (x, _), vals = jax.lax.scan(step, (x, state), None, length=n_steps)
            return x, vals[-1]

        self._adam_run = jax.jit(adam_run, static_argnames=("lr", "n_steps"))

        # augmented Lagrangian (Rockafellar form for inequalities):
        #   L(x; lam, rho) = f + 1/(2 rho) * sum( max(0, lam + rho g)^2 - lam^2 )
        # multiplier update (host side): lam <- max(0, lam + rho g(x)).
        # Unlike the quadratic penalty, active constraints get exact
        # multipliers, so feasibility does not require rho -> inf
        # (replaces IPOPT's interior feasibility guarantee,
        # reference excitation/optimizer.py:1138-1250)
        def al_value(x, dopt_scale, lam, rho, extra_shift):
            f, g, _ = evaluate(x, dopt_scale, extra_shift)
            t = jnp.maximum(0.0, lam + rho * g)
            return f + (0.5 / rho) * jnp.sum(t**2 - lam**2)

        def al_run(x, lo, hi, dopt_scale, lam, rho, extra_shift, lr, n_steps):
            opt = optax.adam(learning_rate=lr)
            state = opt.init(x)

            def step(carry, _):
                x, state = carry
                v, g = jax.value_and_grad(al_value)(
                    x, dopt_scale, lam, rho, extra_shift
                )
                g = jnp.where(jnp.isfinite(g), g, 0.0)
                updates, state = opt.update(g, state)
                x = jnp.clip(x + updates, lo, hi)
                return (x, state), v

            (x, _), vals = jax.lax.scan(step, (x, state), None, length=n_steps)
            return x, vals[-1]

        self._al_run = jax.jit(al_run, static_argnames=("lr", "n_steps"))

        # batched AL stage: K independent restarts advance as ONE
        # dispatch (vmapped over candidate, per-candidate multipliers
        # lam and penalty rho); sharded like evaluate_batch
        def al_run_batch(X, lo, hi, dopt_scale, LAM, RHO, extra_shift,
                         lr, n_steps):
            return jax.vmap(
                lambda x, lam, rho: al_run(
                    x, lo, hi, dopt_scale, lam, rho, extra_shift, lr, n_steps
                )[0]
            )(X, LAM, RHO)

        self._al_run_batch = jax.jit(
            al_run_batch, static_argnames=("lr", "n_steps")
        )

    # ------------------------------------------------------------------
    def set_extra_shift(self, shift) -> None:
        """Update the additive shift on the extra (collision)
        constraints — the mesh-backoff margin-inflation knob. Must keep
        the shape chosen at construction (n_extra_constraints) or every
        jitted chain retraces."""
        shift = np.asarray(shift, dtype=np.float64)
        prev = np.asarray(self._extra_shift)
        if shift.shape != prev.shape:
            print(
                f"extra_shift shape {shift.shape} != constructed shape "
                f"{prev.shape}: every jitted chain will retrace once "
                f"(pass n_extra_constraints at build time to avoid this)"
            )
        self._extra_shift = shift

    @property
    def _shift_j(self):
        return jnp.asarray(self._extra_shift, self.dtype)

    def dopt(self, x):
        """Pure regularized D-optimality (-sum log eig) of a candidate —
        without soft costs or scaling (for quality reporting, e.g. the
        mesh-backoff D-opt before/after)."""
        return float(self._raw_jit(jnp.asarray(x, self.dtype), self._shift_j)[0])

    # ------------------------------------------------------------------
    def calibrate_scale(self, x0: np.ndarray):
        """Set the D-optimality scaling so the initial value is ~10
        (reference trajectoryOptimizer.py:288-293)."""
        neg_logdet, *_ = self._raw_jit(jnp.asarray(x0, self.dtype), self._shift_j)
        v = abs(float(neg_logdet))
        self._dopt_scale = 10.0 / max(v, 1.0)
        return self._dopt_scale

    @property
    def dopt_scale(self):
        if self._dopt_scale is None:
            raise RuntimeError("call calibrate_scale(x0) first")
        return self._dopt_scale

    def evaluate(self, x):
        f, g, n_obs = self._evaluate(
            jnp.asarray(x, self.dtype), self.dopt_scale, self._shift_j
        )
        return float(f), np.asarray(g), int(n_obs)

    def _candidate_mesh(self):
        """The candidate-axis mesh when shardCandidates > 1, else None."""
        shards = int(self.config.get("shardCandidates", 0) or 0)
        if shards <= 1:
            return None
        mesh = getattr(self, "_cand_mesh", None)
        if mesh is None or mesh.size != shards:
            from ..parallel.mesh import make_mesh

            mesh = self._cand_mesh = make_mesh(shards, axis="candidates")
        return mesh

    def _shard_candidates(self, mesh, *arrays):
        """Pad each array's leading axis to a multiple of the mesh size
        and place it sharded over the mesh."""
        from ..parallel.mesh import pad_to_multiple, shard_batch

        padded = [pad_to_multiple(np.asarray(a), mesh.size)[0] for a in arrays]
        return shard_batch(
            mesh, *(jnp.asarray(a, self.dtype) for a in padded),
            axis="candidates",
        )

    def evaluate_batch(self, X):
        X = jnp.asarray(X, self.dtype)
        n = X.shape[0]
        mesh = self._candidate_mesh()
        if mesh is not None:
            # candidate-axis SPMD (SURVEY §2.9: the reference's Optuna
            # worker processes become device-sharded candidate batches):
            # the vmapped objective is embarrassingly parallel across
            # candidates, so sharding the leading axis makes GSPMD place
            # one slice per device — no collectives
            (X,) = self._shard_candidates(mesh, X)
        f, g, n_obs = self._evaluate_batch(X, self.dopt_scale, self._shift_j)
        return np.asarray(f)[:n], np.asarray(g)[:n], np.asarray(n_obs)[:n]

    def penalized_value_and_grad(self, x, weight):
        v, g = self._penalized_grad(
            jnp.asarray(x, self.dtype), self.dopt_scale,
            jnp.asarray(weight, self.dtype), self._shift_j
        )
        return float(v), np.asarray(g)

    def adam_refine(self, x, lo, hi, weight, lr=0.01, n_steps=200):
        """One fused Adam run on device (single dispatch)."""
        xj, v = self._adam_run(
            jnp.asarray(x, self.dtype),
            jnp.asarray(lo, self.dtype),
            jnp.asarray(hi, self.dtype),
            self.dopt_scale,
            jnp.asarray(weight, self.dtype),
            self._shift_j,
            lr,
            n_steps,
        )
        return np.asarray(xj), float(v)

    def al_refine(self, x, lo, hi, lam, rho, lr=0.01, n_steps=200):
        """One fused augmented-Lagrangian Adam stage on device."""
        xj, v = self._al_run(
            jnp.asarray(x, self.dtype),
            jnp.asarray(lo, self.dtype),
            jnp.asarray(hi, self.dtype),
            self.dopt_scale,
            jnp.asarray(lam, self.dtype),
            jnp.asarray(rho, self.dtype),
            self._shift_j,
            lr,
            n_steps,
        )
        return np.asarray(xj), float(v)

    def al_refine_batch(self, X, lo, hi, LAM, RHO, lr=0.01, n_steps=200):
        """One augmented-Lagrangian Adam stage for K independent
        restarts in a single dispatch (SURVEY §2.9: the reference runs
        IPOPT restarts as sequential processes; here they are one
        vmapped batch, device-sharded over the candidate mesh axis when
        shardCandidates > 1)."""
        n = np.shape(X)[0]
        X, LAM, RHO = (jnp.asarray(a, self.dtype) for a in (X, LAM, RHO))
        mesh = self._candidate_mesh()
        if mesh is not None:
            X, LAM, RHO = self._shard_candidates(mesh, X, LAM, RHO)
        Xo = self._al_run_batch(
            X, jnp.asarray(lo, self.dtype), jnp.asarray(hi, self.dtype),
            self.dopt_scale, LAM, RHO, self._shift_j,
            lr=lr, n_steps=n_steps,
        )
        return np.asarray(Xo)[:n]

    def kinematics(self, x):
        """Sampled (Q, base_rot, base_pos) of a candidate — the same
        chain the objective traces, exposed for the dense mesh-tier
        collision verification (reference optimizer.py:1099-1132)."""
        Q, V, A = fourier_traj(self.spec, jnp.asarray(x, self.dtype), jnp.asarray(self.times, self.dtype))
        if self.suspended is not None:
            dt_samp = float(self.times[1] - self.times[0])
            rpy_s, pos_s, _ = self.suspended.simulate_core(
                Q, V, A, jnp.asarray(self._att_rpy0, self.dtype), dt_samp
            )
            from ..dynamics import spatial as sp

            BR = jnp.swapaxes(sp.rpy_to_rot(rpy_s), -1, -2)
            return np.asarray(Q), np.asarray(BR), np.asarray(pos_s)
        return np.asarray(Q), None, None

    def feasible(self, g, tol=None):
        """Constraint feasibility with the reference's minTolConstr
        tolerance (tanh rounding causes tiny angle violations,
        reference trajectoryOptimizer.py:573)."""
        if tol is None:
            tol = float(self.config.get("minTolConstr", 0.0) or 0.0)
        return bool(np.all(np.asarray(g) <= tol))
